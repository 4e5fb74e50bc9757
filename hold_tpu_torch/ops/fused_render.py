"""Fused inference render query (counterpart of hold_tpu/ops/fused_render.py).

The render path shades each node's samples with no gradient, in two CUDA
kernels a call (``csrc/fused_render.cu``): the warp step, one thread a point,
to canonical space (the hand's KNN blend and inverse skinning, with the
nearest-vertex distance; the object's rigid inverse) with the inverse
skinning Jacobian; then the shade on the tensor cores (``wgmma``): the
embedding, the 8x256 softplus100 trunk with its SDF and feature heads, a
reverse pass through the scalar head for dSDF/dx_c and the normal, and the
'pose'-mode colour MLP, its weights streamed in the shared-memory layout of
``tile_shade_fwd``.

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
embedding plan is its window alone, as in ``ops/fused_query.py``.  Given CPU
tensors a wrapper runs the plain version.  Given CUDA tensors it launches
the kernels or raises; it never falls back.  Each call adds one to
``LAUNCHES[name]``.
"""

from __future__ import annotations

import torch

from . import _cuda
from .fused_query import (
    _LAYOUT,
    EMB_PAD,
    H,
    SLAB,
    SLAB_K,
    TRUNK_FLOPS_PER_POINT,
    TRUNK_MACS,
    _check_hand,
    _check_pack,
    _multires,
    _pad,
    _ptr,
    _require_cpu,
    pack_trunk_weights,
    rigid_inverse_plain,
    supports_fused_query,
)
from .knn import _blend_plain, check_order, jacobian_inverse_plain, skinning, stats_ptr
from ..models.embedders import fourier_embed
from ..models.mlp import softplus100

C0A = 16  # colour layer-0 columns the kernel multiplies for [x_c | normal | 0 ...]
TILE = 128  # points a tile of the shade kernel (csrc/cta_gemm.cuh TILE_M)

# the transposed trunk and the feature head, in csrc/fused_render.cu's order:
# (name, rows, cols); W*T are (in, out), feat_w is (out, in)
_T_LAYOUT = (
    ("W0T", EMB_PAD, H), ("W1T", H, H), ("W2T", H, H), ("W3T", H, H), ("W4hT", H, H),
    ("W4eT", EMB_PAD, H), ("W5T", H, H), ("W6T", H, H), ("W7T", H, H), ("feat_w", H, H),
)
_C_LAYOUT = (("C0a", H, C0A), ("C0f", H, H), ("C1", H, H), ("C2", H, H), ("C3", H, H),
             ("C4", 8, H))
T_TOTAL = sum(r * c for _, r, c in _T_LAYOUT)
C_TOTAL = sum(r * c for _, r, c in _C_LAYOUT)
CB_TOTAL = 5 * H  # f32 biases: feature head | colour layers 1, 2, 3 | layer 4 (3 used)
# the kernel's FLOPs a point (zero pads included), for the rate it reaches:
# trunk forward and SDF head, reverse pass, feature head, colour MLP
RENDER_FLOPS_PER_POINT = TRUNK_FLOPS_PER_POINT + 2.0 * (
    sum(r * c for n, r, c in _T_LAYOUT if n != "feat_w") + H * H + C_TOTAL)
# the MACs a point the function needs (no pads), for its bound: the trunk and
# head, the reverse pass (the same seven 256x256 products transposed), the
# feature head, and the colour MLP (6 + 256 inputs, three 256x256 layers, 3
# outputs)
RENDER_MACS = TRUNK_MACS + 7 * H * H + H * H + (6 + H) * H + 3 * H * H + 3 * H

# The forward shade's weight stream (csrc/shade_common.cuh): every product's
# weights as the 32 KB stages its shared-memory ring takes, in the order a CTA
# consumes them.  A name alone is a (256, K) matrix cut along k into slabs of
# 64 columns, one a stage (K = 48 or 16: one slab, zero-padded); a name with N
# is an (N, 256) matrix whose four k-slabs share one stage.  The training
# shade's backward stream (ops/fused_shade.py) begins with these stages.
_TRUNK_UP = ("W0", "W1", "W2", "W3", "W4h", "W4e", "W5", "W6", "W7")
_TRUNK_DOWN = ("W7T", "W6T", "W5T", ("W4eT", 48), "W4hT", "W3T", "W2T", "W1T", ("W0T", 48))
FWD_STREAM = (
    *_TRUNK_UP, "feat_w",                                   # trunk, feature head
    *_TRUNK_DOWN,                                           # the reverse pass
    "C0a", "C0f", "C1", "C2", "C3", ("C4", 8),              # colour MLP
)


def _stages(entry) -> int:
    """Stages an entry of a weight stream takes: one for a narrow matrix or
    one of at most 64 columns, else a stage a slab."""
    return 1 if not isinstance(entry, str) or entry in ("W0", "W4e", "C0a", "C4T") else H // SLAB_K


N_FWD_SLABS = sum(map(_stages, FWD_STREAM))

LAUNCHES = {"fused_hand_render": 0, "fused_object_render": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supports_fused_render(implicit_plan: dict, rendering_plan: dict) -> bool:
    """True when both nets match the kernel's static pattern (the JAX
    package's rule)."""
    dims = rendering_plan["dims"]
    return (
        supports_fused_query(implicit_plan)
        and rendering_plan["mode"] == "pose"
        and rendering_plan.get("multires_view", -1) <= 0
        and len(dims) == 6
        and all(d == H for d in dims[1:5])
        and dims[5] == 3
        and dims[0] >= 14 + H
    )


# --------------------------------------------------------------------------
# Packing
# --------------------------------------------------------------------------

def _flat(mats: dict, layout: tuple, dtype) -> dict:
    flat = torch.cat([mats[n].reshape(-1) for n, _, _ in layout]).to(dtype)
    pack = {"bf16": flat}
    off = 0
    for name, r, c in layout:
        pack[name] = flat[off:off + r * c].view(r, c)
        off += r * c
    return pack


def pack_trunk_transposed(resolved: dict, plan: dict, fwd: dict | None = None) -> dict:
    """Transposed bf16 trunk for the reverse pass, plus the feature head.

    The transposes of ``pack_trunk_weights``'s matrices (``fwd``, built here
    when not given), so forward and reverse see identical effective weights
    (the skip split and its /sqrt(2) included); ``feat_w`` is rows 1: of the
    output layer, (out, in).  Grad mode as for ``pack_trunk_weights``."""
    if fwd is None:
        fwd = pack_trunk_weights(resolved, plan)
    mats = {f"{n}T": fwd[n].t() for n in ("W0", "W1", "W2", "W3", "W4h", "W4e", "W5", "W6", "W7")}
    mats["feat_w"] = resolved["layers"][8]["w"].float()[1:]
    return _flat(mats, _T_LAYOUT, torch.bfloat16)


def pack_color_weights(resolved: dict, implicit_resolved: dict) -> dict:
    """Resolved rendering layers -> the kernel's bf16 weights and f32 biases.

    Layer 0 is split by input segment: ``C0a`` covers [x_c, normal] (columns
    0:6, padded to 16), ``C0f`` the 256 feature columns (14:270).  The pose
    embedding (6:14) and time code (270:) columns are constant over a frame:
    they and b0 enter as ``frame_bias0``.  ``"f32"`` holds the feature head's
    bias (rows 1: of the implicit output layer), then the biases of layers
    1, 2, 3 and 4 (3 used), 256 each.  Grad mode as for
    ``pack_trunk_weights``."""
    layers = [{k: v.float() for k, v in l.items()} for l in resolved["layers"]]
    w0 = layers[0]["w"]
    mats = {
        "C0a": _pad(w0[:, 0:6], H, C0A),
        "C0f": w0[:, 14:14 + H],
        "C1": layers[1]["w"], "C2": layers[2]["w"], "C3": layers[3]["w"],
        "C4": _pad(layers[4]["w"], 8, H),
    }
    pack = _flat(mats, _C_LAYOUT, torch.bfloat16)
    featb = implicit_resolved["layers"][8]["b"].float()[1:]
    cb = torch.cat([featb, layers[1]["b"], layers[2]["b"], layers[3]["b"],
                    _pad(layers[4]["b"][None], 1, H)[0]])
    pack["f32"] = cb
    pack["cbias"] = cb.view(5, H)
    return pack


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


def _swizzled_slabs(m: torch.Tensor) -> torch.Tensor:
    """(N, K) -> (K / 64 slabs, N * 64): each slab's N rows of 64 values (128
    bytes) with the row's 16-byte groups XOR-ed with the row number mod 8
    (``ops/fused_query.py`` ``slab_offset``); K zero-padded to a multiple of 64."""
    N, K = m.shape
    pad = -K % SLAB_K
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    groups = m.reshape(N, -1, 8, 8)  # row, slab, 16-byte group, value
    rows = torch.arange(N, device=m.device)
    src = torch.arange(8, device=m.device)[None, :] ^ (rows[:, None] % 8)
    src = src[:, None, :, None].expand(N, groups.shape[1], 8, 8)
    return torch.gather(groups, 2, src).permute(1, 0, 2, 3).reshape(-1, N * SLAB_K)


def stream_matrices(pack: dict, tpack_t: dict, cpack: dict) -> dict:
    """The three packs' matrices by name, as a weight stream names them."""
    return {**{k: pack[k] for k, _, _ in _LAYOUT}, **{k: tpack_t[k] for k, _, _ in _T_LAYOUT},
            **{k: cpack[k] for k, _, _ in _C_LAYOUT}}


@torch.no_grad()
def weight_stream(mats: dict, entries: tuple) -> torch.Tensor:
    """The stages of ``entries`` (a weight stream), from the matrices by name:
    a flat bf16 buffer of 32 KB stages.  Copies of the packs' entries, no
    rounding; no gradient flows through it."""
    images = {}
    for entry in dict.fromkeys(entries):
        name, narrow = (entry, 0) if isinstance(entry, str) else entry
        slabs = _swizzled_slabs(mats[name][:narrow] if narrow else mats[name])
        if narrow:  # the four k-slabs of narrow rows, one after the other, in one stage
            slabs = slabs.reshape(1, -1)
        images[entry] = torch.nn.functional.pad(slabs, (0, SLAB - slabs.shape[1])).reshape(-1)
    return torch.cat([images[e] for e in entries])


def tile_shade_fwd(pack: dict, tpack_t: dict, cpack: dict) -> torch.Tensor:
    """The shade kernel's weight stream (``FWD_STREAM``, ``N_FWD_SLABS``
    stages): the first stages of the training shade's backward stream."""
    return weight_stream(stream_matrices(pack, tpack_t, cpack), FWD_STREAM)


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
    return _shade_plain(xc, jinv, window, pack, tpack_t, cpack, fb0, eps=0.0)


def _shade_plain(xc, jinv, window, pack, tpack_t, cpack, fb0, eps: float):
    """The shade of the render and of the training shade's forward, with the
    normal divided by max(sqrt(|n|^2 + eps), 1e-6); differentiable."""
    B, N = xc.shape[:2]
    x = xc.reshape(-1, 3).float()
    L = _multires(window)
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
    w, dmin = _blend_plain(pts, verts_posed, skin_weights, K)
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

def _check_render(window, pack, tpack_t, cpack, fb0, B) -> int:
    multires = _check_pack(window, pack)
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
    multires = _check_render(window, pack, tpack_t, cpack, fb0, B)
    slabs = _shade_stream(pack, tpack_t, cpack)
    outs = tuple(torch.empty(s, dtype=torch.float32, device=dev)
                 for s in ((B, N), (B, N, 3), (B, N, 3), (B, N), (B, N, 3)))
    jinv = torch.empty((B, N, 9), dtype=torch.float32, device=dev)
    scratch, ctas = shade_scratch(B * N, dev)
    _cuda.launch(name, *ptrs_in, *_ptr(window, slabs, pack["f32"], cpack["f32"], fb0, jinv,
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
        V, J = _check_hand(verts_posed, skin_weights, tfs, B, K)
        _cuda.check(verts_c, "verts_c", (B, V, 3))
        outs = _launch_render("hold_fused_hand_render", B, N, pts.device,
                              [*_ptr(pts, verts_posed, verts_c, skin_weights, tfs),
                               check_order(order, V)], (V, J, K),
                              pack, tpack_t, cpack, fb0, window, (stats_ptr(),))
        LAUNCHES["fused_hand_render"] += 1
        return outs
    _require_cpu(pts)
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
        outs = _launch_render("hold_fused_object_render", B, N, pts.device, _ptr(pts, tf_inv12),
                              (), pack, tpack_t, cpack, fb0, window)
        LAUNCHES["fused_object_render"] += 1
        return outs
    _require_cpu(pts)
    return object_render_plain(pts, tf_inv12, window, pack, tpack_t, cpack, fb0)
