"""Fused inference render query (counterpart of hold_tpu/ops/fused_render.py).

The render path shades each node's samples with no gradient, in two CUDA
kernels a call (``csrc/fused_render.cu``): the warp step, one thread a point,
to canonical space (the hand's KNN blend and inverse skinning, with the
nearest-vertex distance; the object's rigid inverse) with the inverse
skinning Jacobian; then the shade on the tensor cores (``wgmma``): the
embedding, the 8x256 softplus100 trunk with its SDF and feature heads, a
reverse pass through the scalar head for dSDF/dx_c and the normal, and the
'pose'-mode colour MLP, its weights the packs' forward stream
(``ops/weight_pack.py`` ``tile_shade_fwd``).

The numbers are the TPU kernel's (``_shade_common``): bf16 operands and f32
sums in every product, each layer's sigmoid(100 a) kept in bf16 for the
reverse pass, the reverse pass's gradient rounded to bf16 before each
product, layer 7 and the SDF head in f32, the feature head's output rounded
to bf16 for the colour net, the colour sigmoid in f32, and the normal divided
by max(|n|, 1e-6).  ``render_shade_plain`` is that computation in plain
PyTorch; ``hand_render_warp_plain`` and ``object_render_warp_plain`` are the
warps, and ``hand_render_plain`` and ``object_render_plain`` the two in turn.

Two wrappers with the JAX names, arguments and outputs (sdf (B, N), rgb
(B, N, 3), normal (B, N, 3), nearest distance (B, N), x_c (B, N, 3)); the
embedding plan is its window alone, as in ``ops/fused_query.py``.
``shade_plain`` is the shade that the training shade's forward
(``ops/fused_shade.py``) shares, with its own normal denominator.  Given CPU
tensors a wrapper runs the plain version.  Given CUDA tensors it launches
the kernels or raises; it never falls back.  Each call adds one to
``LAUNCHES[name]``.
"""

from __future__ import annotations

import torch

from . import _cuda
from .fused_query import (
    TRUNK_FLOPS_PER_POINT,
    TRUNK_MACS,
    check_hand,
    check_pack,
    rigid_inverse_plain,
)
from .knn import blend_plain, check_order, jacobian_inverse_plain, skinning, stats_ptr
from .weight_pack import (
    C0A,
    C_TOTAL,
    CB_TOTAL,
    EMB_PAD,
    H,
    SLAB,
    T_TOTAL,
    TRANSPOSED_LAYOUT,
    tile_shade_fwd,
    window_multires,
)
from ..models.embedders import fourier_embed
from ..models.mlp import softplus100

TILE = 128  # points a tile of the shade kernel (csrc/cta_gemm.cuh TILE_M)
# the kernel's FLOPs a point (zero pads included), for the rate it reaches:
# trunk forward and SDF head, reverse pass, feature head, colour MLP
RENDER_FLOPS_PER_POINT = TRUNK_FLOPS_PER_POINT + 2.0 * (
    sum(r * c for n, r, c in TRANSPOSED_LAYOUT if n != "feat_w") + H * H + C_TOTAL)
# the MACs a point the function needs (no pads), for its bound: the trunk and
# head, the reverse pass (the same seven 256x256 products transposed), the
# feature head, and the colour MLP (6 + 256 inputs, three 256x256 layers, 3
# outputs)
RENDER_MACS = TRUNK_MACS + 7 * H * H + H * H + (6 + H) * H + 3 * H * H + 3 * H

LAUNCHES = {"fused_hand_render": 0, "fused_object_render": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def frame_bias0(resolved: dict, pose_embed: torch.Tensor,
                time_code: torch.Tensor | None = None) -> torch.Tensor:
    """Per-frame colour layer-0 bias b0 + W0[:, 6:14] pe (+ W0[:, 270:] tc):
    pose_embed (B, 8) (zeros for the object), time_code (B, 32) or None ->
    (B, 256) f32."""
    w0 = resolved["layers"][0]["w"].float()
    fb = resolved["layers"][0]["b"].float()[None, :] + pose_embed.float() @ w0[:, 6:14].T
    if time_code is not None:
        fb = fb + time_code.float() @ w0[:, 14 + H:].T
    return fb.float().contiguous()


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # bf16 operands, f32 sums
    return a.to(torch.bfloat16).float() @ b.float()


@torch.no_grad()
def render_shade_plain(xc, jinv, window, pack, tpack_t, cpack, fb0):
    """Trunk, heads, normal and colour at canonical points: xc (B, N, 3),
    jinv (B, N, 9) row-major, fb0 (B, 256) -> (sdf (B, N), rgb (B, N, 3),
    normal (B, N, 3))."""
    return shade_plain(xc, jinv, window, pack, tpack_t, cpack, fb0, eps=0.0)


def shade_plain(xc, jinv, window, pack, tpack_t, cpack, fb0, eps: float):
    """The shade of the render and of the training shade's forward, with the
    normal divided by max(sqrt(|n|^2 + eps), 1e-6); differentiable."""
    B, N = xc.shape[:2]
    x = xc.reshape(-1, 3).float()
    L = window_multires(window)
    E = window.shape[0]
    emb = fourier_embed(x, L) * window
    emb = torch.nn.functional.pad(emb, (0, EMB_PAD - E)).to(torch.bfloat16)
    bias = pack["bias"]

    sig = []

    def layer(h, a):
        sig.append(torch.sigmoid(100.0 * a).to(torch.bfloat16))
        return softplus100(a)

    h = emb
    for l in range(4):
        h = layer(h, _mm(h, pack[f"W{l}"].T) + bias[l]).to(torch.bfloat16)
    h = layer(h, _mm(h, pack["W4h"].T) + bias[4] + _mm(emb, pack["W4e"].T)).to(torch.bfloat16)
    for l in (5, 6):
        h = layer(h, _mm(h, pack[f"W{l}"].T) + bias[l]).to(torch.bfloat16)
    h7 = layer(h, _mm(h, pack["W7"].T) + bias[7])
    sdf = h7 @ pack["head_w"] + pack["head_b"]
    cb = cpack["cbias"]
    feat = _mm(h7, tpack_t["feat_w"].T) + cb[0]

    # reverse pass through the scalar head: da_{l-1} = (bf16(da_l) . W_l) * s_{l-1}
    da = pack["head_w"] * sig[7].float()
    for l in (7, 6, 5):
        da = _mm(da, tpack_t[f"W{l}T"].T) * sig[l - 1].float()
    demb = _mm(da, tpack_t["W4eT"].T)
    da = _mm(da, tpack_t["W4hT"].T) * sig[3].float()
    for l in (3, 2, 1):
        da = _mm(da, tpack_t[f"W{l}T"].T) * sig[l - 1].float()
    demb = (demb + _mm(da, tpack_t["W0T"].T))[:, :E]

    # d emb -> dSDF/dx_c: column c is x_d, or sin / cos of 2^k x_d
    dims = torch.tensor([0, 1, 2] + [0, 1, 2] * (2 * L), device=x.device)
    freq = torch.tensor([1.0] * 3 + [2.0 ** k for k in range(L) for _ in range(6)],
                        device=x.device)
    kind = torch.tensor([0] * 3 + [1, 1, 1, 2, 2, 2] * L, device=x.device)
    arg = x[:, dims] * freq
    trig = torch.where(kind == 1, torch.cos(arg), torch.where(kind == 2, -torch.sin(arg),
                                                              torch.ones_like(arg)))
    contrib = freq * ((demb * trig) * window)
    g = torch.zeros_like(x).index_add_(1, dims, contrib)

    j9 = jinv.reshape(-1, 9).float()
    n = torch.stack([sum(g[:, i] * j9[:, 3 * i + j] for i in range(3)) for j in range(3)], -1)
    n = n / torch.clamp(torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + eps), min=1e-6)

    inp = torch.cat([x, n, torch.zeros_like(x[:, :1]).expand(-1, C0A - 6)], dim=-1)
    fb_pp = fb0.float()[:, None, :].expand(B, N, H).reshape(-1, H)
    hc = _mm(inp, cpack["C0a"].T) + _mm(feat, cpack["C0f"].T) + fb_pp
    hc = torch.relu(hc).to(torch.bfloat16)
    for l in (1, 2, 3):
        hc = torch.relu(_mm(hc, cpack[f"C{l}"].T) + cb[l]).to(torch.bfloat16)
    rgb = torch.sigmoid(_mm(hc, cpack["C4"].T)[:, :3] + cb[4, :3])
    return sdf.reshape(B, N), rgb.reshape(B, N, 3), n.reshape(B, N, 3)


@torch.no_grad()
def hand_render_warp_plain(pts, verts_posed, verts_c, skin_weights, tfs, K: int = 15):
    """Plain version of the hand's warp step: the KNN warp vs the posed
    vertices, J^-1 vs the canonical vertices at x_c, the nearest distance ->
    (x_c (B, N, 3), J^-1 (B, N, 9) row-major, distance (B, N))."""
    w, dmin = blend_plain(pts, verts_posed, skin_weights, K)
    xc = skinning(pts, w, tfs, inverse=True)
    jinv = jacobian_inverse_plain(xc, verts_c, skin_weights, tfs, K)
    return xc, jinv, torch.sqrt(torch.clamp(dmin, max=4.0))


@torch.no_grad()
def object_render_warp_plain(pts, tf_inv12):
    """Plain version of the object's warp step: x_c = Rinv (x - t),
    J^-1 = Rinv, a zero distance."""
    B, N = pts.shape[:2]
    xc = rigid_inverse_plain(pts, tf_inv12)
    return xc, tf_inv12[:, None, :9].expand(B, N, 9), torch.zeros_like(xc[..., 0])


@torch.no_grad()
def hand_render_plain(pts, verts_posed, verts_c, skin_weights, tfs, window, pack, tpack_t,
                      cpack, fb0, K: int = 15):
    """Plain version of the hand's kernels: the warp step, then the shade."""
    xc, jinv, dist = hand_render_warp_plain(pts, verts_posed, verts_c, skin_weights, tfs, K)
    sdf, rgb, nrm = render_shade_plain(xc, jinv, window, pack, tpack_t, cpack, fb0)
    return sdf, rgb, nrm, dist, xc


@torch.no_grad()
def object_render_plain(pts, tf_inv12, window, pack, tpack_t, cpack, fb0):
    """Plain version of the object's kernels: the warp step, then the shade."""
    xc, jinv, dist = object_render_warp_plain(pts, tf_inv12)
    sdf, rgb, nrm = render_shade_plain(xc, jinv, window, pack, tpack_t, cpack, fb0)
    return sdf, rgb, nrm, dist, xc


# --------------------------------------------------------------------------
# CUDA launches (csrc/fused_render.cu)
# --------------------------------------------------------------------------

def check_render(window, pack, tpack_t, cpack, fb0, B) -> int:
    """Raise unless the window, the packs and the frame bias are the shade
    kernel's CUDA buffers; the embedding's frequencies."""
    multires = check_pack(window, pack)
    _cuda.check(tpack_t["bf16"], "tpack_t['bf16']", (T_TOTAL,), torch.bfloat16)
    _cuda.check(cpack["bf16"], "cpack['bf16']", (C_TOTAL,), torch.bfloat16)
    _cuda.check(cpack["f32"], "cpack['f32']", (CB_TOTAL,))
    _cuda.check(fb0, "fb0", (B, H))
    return multires


def check_stream(slabs: torch.Tensor) -> None:
    """Raise unless ``slabs`` holds at least the forward's stages."""
    if not slabs.is_cuda or slabs.dtype != torch.bfloat16 or not slabs.is_contiguous():
        raise ValueError("the weight stream must be a contiguous bf16 CUDA tensor")
    if slabs.numel() < _cuda.lib().hold_fused_shade_fwd_slabs() * SLAB:
        raise RuntimeError("the weight stream is shorter than the shade kernel's")


def shade_scratch(total: int, dev) -> tuple:
    """The shade kernel's scratch and grid for ``total`` points: one CTA an
    SM at most, each looping over tiles of 128 points."""
    ctas = max(1, min(-(-total // TILE), torch.cuda.get_device_properties(dev).multi_processor_count))
    words = _cuda.lib().hold_fused_render_scratch_words()
    return torch.empty(ctas * words, dtype=torch.int32, device=dev), ctas


def _shade_stream(pack, tpack_t, cpack) -> torch.Tensor:
    """The forward weight stream the render packs carry (``cpack['stream']``,
    made with them once a frame by ``models/nodes.py`` node_render_packs), or
    one made here."""
    slabs = cpack.get("stream")
    if slabs is None:
        slabs = tile_shade_fwd(pack, tpack_t, cpack)
    check_stream(slabs)
    return slabs


def _launch_render(name: str, B: int, N: int, dev, ptrs_in: list, ints: tuple, pack, tpack_t,
                   cpack, fb0, window, tail: tuple = ()) -> tuple:
    """Both kernels of one render call: the outputs, J^-1's buffer, the
    scratch; ``tail``: the entry point's last arguments."""
    multires = check_render(window, pack, tpack_t, cpack, fb0, B)
    slabs = _shade_stream(pack, tpack_t, cpack)
    outs = tuple(torch.empty(s, dtype=torch.float32, device=dev)
                 for s in ((B, N), (B, N, 3), (B, N, 3), (B, N), (B, N, 3)))
    jinv = torch.empty((B, N, 9), dtype=torch.float32, device=dev)
    scratch, ctas = shade_scratch(B * N, dev)
    _cuda.launch(name, *ptrs_in, *_cuda.ptrs(window, slabs, pack["f32"], cpack["f32"], fb0, jinv,
                                             scratch, *outs), B, N, *ints, multires, ctas, *tail)
    return outs


@torch.no_grad()
def fused_hand_render(pts, verts_posed, verts_c, skin_weights, tfs, window, pack, tpack_t,
                      cpack, fb0, K: int = 15, *, order):
    """Hand: world points (B, N, 3), the frame's posed and canonical vertices
    (B, V, 3), skinning weights (B, V, J), bone transforms (B, J, 4, 4), the
    packs and the frame bias (B, 256) -> (sdf, rgb, normal, nearest distance,
    x_c).  ``order``: the vertices' ``knn.tile_order``, which the warp
    kernel's search reads them in (the plain version does not read it)."""
    B, N = pts.shape[:2]
    if pts.is_cuda:
        _cuda.check(pts, "pts", (B, N, 3))
        V, J = check_hand(verts_posed, skin_weights, tfs, B, K)
        _cuda.check(verts_c, "verts_c", (B, V, 3))
        outs = _launch_render("hold_fused_hand_render", B, N, pts.device,
                              [*_cuda.ptrs(pts, verts_posed, verts_c, skin_weights, tfs),
                               check_order(order, V)], (V, J, K),
                              pack, tpack_t, cpack, fb0, window, (stats_ptr(),))
        LAUNCHES["fused_hand_render"] += 1
        return outs
    _cuda.require_cpu(pts)
    return hand_render_plain(pts, verts_posed, verts_c, skin_weights, tfs, window, pack, tpack_t,
                             cpack, fb0, K)


@torch.no_grad()
def fused_object_render(pts, tf_inv12, window, pack, tpack_t, cpack, fb0):
    """Object: world points (B, N, 3), per-frame inverse affine (B, 12: Rinv
    row-major | t) -> the hand's outputs, with a zero distance."""
    B, N = pts.shape[:2]
    if pts.is_cuda:
        _cuda.check(pts, "pts", (B, N, 3))
        _cuda.check(tf_inv12, "tf_inv12", (B, 12))
        outs = _launch_render("hold_fused_object_render", B, N, pts.device,
                              _cuda.ptrs(pts, tf_inv12), (), pack, tpack_t, cpack, fb0, window)
        LAUNCHES["fused_object_render"] += 1
        return outs
    _cuda.require_cpu(pts)
    return object_render_plain(pts, tf_inv12, window, pack, tpack_t, cpack, fb0)
