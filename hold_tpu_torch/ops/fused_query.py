"""Fused sampler SDF query (counterpart of hold_tpu/ops/fused_query.py).

The error-bound sampler evaluates each node's canonical SDF at every point of
every refinement round, with no gradient.  ``csrc/fused_query.cu`` does the
whole query in two kernels a call: the world point (``cam + z*dir`` from the
z table, or a point buffer) -> canonical space (the hand's KNN blend and
inverse skinning, the object's rigid inverse) -> the Fourier/BARF embedding,
96 bytes a point handed on through a scratch buffer; then the 8x256
softplus100 trunk -> the SDF head on the tensor cores (``wgmma``), its weights
in the shared-memory layout of ``tile_for_kernel``.

The numbers are the TPU kernel's (``_emb_mlp_head``), not the port's
layer-by-layer bf16 trunk: the embedding and every hidden activation are
rounded to bf16, every product is summed in f32 (a bf16 ``torch.matmul``
would round its output to bf16), softplus100 runs in f32, and layer 7 stays
f32 into the f32 head.  ``sampler_sdf_plain`` is that computation in plain
PyTorch.

Four wrappers, with the JAX names and argument order; ``pack_rays8`` is
dropped (the z forms take ``ray_dirs`` and ``cam_loc`` (B*P, 3) directly)
and the embedding plan is its window alone:

- ``fused_hand_sampler_sdf_z`` / ``fused_object_sampler_sdf_z``: the
  sampler's z table (B, P, S) -> sdf (B, P, S);
- ``fused_hand_sampler_sdf`` / ``fused_object_sampler_sdf``: a point buffer
  (B, N, 3) -> sdf (B, N).

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel or raises; it never falls back.  Each launch adds one to
``LAUNCHES[name]``.
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from .knn import JMAX, KMAX, inverse_warp_plain
from ..models.embedders import barf_alpha, barf_window, fourier_embed
from ..models.mlp import softplus100

H = 256  # trunk width
EMB_PAD = 48  # embedding columns the kernel multiplies (three MMA k-steps)
TILE = 128  # points a CTA owns (csrc/cta_gemm.cuh TILE_M)
EMB_TILE_BYTES = TILE * 128  # a tile's embedding rows as the trunk kernel reads them
# hand vertices (16 B each) that fit a CTA's shared memory (227 KB) beside the
# warp step's bone transforms (1 KB)
VMAX = (232_448 - 1024) // 16

# the packed bf16 trunk, in csrc/fused_query.cu's order: (name, rows, cols),
# every matrix (out, in) row-major
_LAYOUT = (
    ("W0", H, EMB_PAD), ("W1", H, H), ("W2", H, H), ("W3", H, H), ("W4h", H, H),
    ("W4e", H, EMB_PAD), ("W5", H, H), ("W6", H, H), ("W7", H, H),
)
W_TOTAL = sum(r * c for _, r, c in _LAYOUT)
# the kernel's layout (csrc/cta_gemm.cuh): every matrix cut along k into slabs
# of 64 columns (a 48-column matrix is one slab, its last 16 columns zero),
# the slabs in the order the layers consume them (``_LAYOUT``'s)
SLAB_K = 64
SLAB = H * SLAB_K  # bf16 values a slab holds (32 KB)
N_SLABS = sum(-(-c // SLAB_K) for _, _, c in _LAYOUT)
F_TOTAL = 8 * H + H + 1  # bias (8, 256) | head row (256) | head bias
# the trunk's FLOPs a point as the kernel multiplies it (zero pads included),
# for the rate it reaches
TRUNK_FLOPS_PER_POINT = 2.0 * (W_TOTAL + H)
# the MACs a point the function needs (no pads), for its bound: layer 0 takes
# E inputs and layer 3 gives 256 - E outputs, which layer 4 takes beside the
# E embedding columns, so E cancels: seven 256x256 products and the head row
TRUNK_MACS = 7 * H * H + H

LAUNCHES = {
    "fused_hand_sampler_sdf_z": 0,
    "fused_object_sampler_sdf_z": 0,
    "fused_hand_sampler_sdf": 0,
    "fused_object_sampler_sdf": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Packing
# --------------------------------------------------------------------------

def _emb_width(multires: int) -> int:
    return 3 * (2 * multires + 1)


def supports_fused_query(plan: dict) -> bool:
    """True when the implicit-net plan matches the kernel's static pattern
    (the JAX package's rule)."""
    dims = plan["dims"]
    return (
        plan["raw_in"] == 3
        and plan["multires"] > 0
        and _emb_width(plan["multires"]) <= EMB_PAD
        and tuple(plan["skip_in"]) == (4,)
        and len(dims) == 10
        and all(d == H for d in dims[1:9])
        and dims[9] >= 1
        and (plan["cond"] == "none" or plan["cond_dim"] in (0, 45))
    )


def _pad(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = torch.zeros((rows, cols), dtype=torch.float32, device=w.device)
    out[: w.shape[0], : w.shape[1]] = w
    return out


def pack_trunk_weights(resolved: dict, plan: dict) -> dict:
    """Resolved ``{'w', 'b'}`` layers -> the kernel's two flat buffers.

    ``"bf16"`` holds the nine matrices of ``_LAYOUT`` and ``"f32"`` the
    biases and the head; the other keys are views into them by name.  What
    changes numbers is kept from the JAX pack: layer 0 keeps only its first E
    (39) input columns (the 45-d pose condition is zero); the skip layer is
    split as W4h = W4[:, :256-E] / sqrt(2) and W4e = W4[:, 256-E:] / sqrt(2),
    divided BEFORE the bf16 round; biases and the head stay f32.  Layer 3's
    256-E outputs are padded to 256 rows of zeros (its pad activations are
    softplus100(0) = log(2)/100, not 0), so the matching W4h columns are
    zero.  Built under grad mode (the fused training shade), the buffers
    keep the autograd graph back to ``resolved``; the sampler and the render
    build them under ``torch.no_grad``."""
    if not supports_fused_query(plan):
        raise ValueError("unsupported trunk plan for the fused sampler query")
    layers = [{k: v.float() for k, v in l.items()} for l in resolved["layers"]]
    E = _emb_width(plan["multires"])
    H3 = H - E
    s2 = float(math.sqrt(2.0))
    w4 = layers[4]["w"]
    mats = {
        "W0": _pad(layers[0]["w"][:, :E], H, EMB_PAD),
        "W3": _pad(layers[3]["w"], H, H),
        "W4h": _pad(w4[:, :H3] / s2, H, H),
        "W4e": _pad(w4[:, H3:H3 + E] / s2, H, EMB_PAD),
    }
    for l in (1, 2, 5, 6, 7):
        mats[f"W{l}"] = layers[l]["w"]
    wflat = torch.cat([mats[n].reshape(-1) for n, _, _ in _LAYOUT]).to(torch.bfloat16)
    bias = torch.stack([_pad(layers[l]["b"][None], 1, H)[0] for l in range(8)])
    fflat = torch.cat([bias.reshape(-1), layers[8]["w"][0], layers[8]["b"][:1]])
    pack = {"bf16": wflat, "f32": fflat}
    off = 0
    for name, r, c in _LAYOUT:
        pack[name] = wflat[off:off + r * c].view(r, c)
        off += r * c
    pack["bias"] = fflat[: 8 * H].view(8, H)
    pack["head_w"] = fflat[8 * H: 9 * H]
    pack["head_b"] = fflat[9 * H]
    return pack


def slab_offset(slab: int, n, k):
    """Where element (n, k) of a slab sits, in bf16 values from the start of
    the tiled buffer: rows of 64 values (128 bytes) whose 16-byte groups are
    XOR-ed with the row's number mod 8, the 128-byte swizzle wgmma reads."""
    return slab * SLAB + n * SLAB_K + (((k // 8) ^ (n % 8)) * 8) + k % 8


_TILE_INDEX: dict = {}


def _tile_index(device) -> tuple:
    """(gather, scatter): ``tiled = cat(pack, [0])[gather]`` and
    ``pack = tiled[scatter]``, built once per device."""
    key = str(device)
    if key not in _TILE_INDEX:
        gather = torch.full((N_SLABS * SLAB,), W_TOTAL, dtype=torch.long)
        scatter = torch.empty((W_TOTAL,), dtype=torch.long)
        off, slab = 0, 0
        for _, r, c in _LAYOUT:
            n = torch.arange(r)[:, None].expand(r, c)
            k = torch.arange(c)[None, :].expand(r, c)
            dst = slab_offset(slab + k // SLAB_K, n, k % SLAB_K).reshape(-1)
            src = torch.arange(off, off + r * c)
            gather[dst] = src
            scatter[src] = dst
            off += r * c
            slab += -(-c // SLAB_K)
        _TILE_INDEX[key] = (gather.to(device), scatter.to(device))
    return _TILE_INDEX[key]


def tile_for_kernel(pack: dict) -> torch.Tensor:
    """The packed trunk in the kernel's layout: ``N_SLABS`` slabs of 32 KB, each
    the shared-memory image one pipeline stage needs, so that one bulk copy
    fills a stage.  A permutation of ``pack["bf16"]`` with zeros in the 48-column
    matrices' last 16 columns (``untile_from_kernel`` gives the pack back bit
    for bit); under grad mode it keeps the graph to the pack."""
    flat = pack["bf16"]
    gather, _ = _tile_index(flat.device)
    return torch.cat([flat, flat.new_zeros(1)])[gather]


def untile_from_kernel(tiled: torch.Tensor) -> torch.Tensor:
    """``tile_for_kernel``'s inverse: the flat bf16 pack."""
    return tiled[_tile_index(tiled.device)[1]]


def _kernel_weights(pack: dict) -> torch.Tensor:
    """``tile_for_kernel(pack)``, made once per pack and kept in it."""
    if "tiled" not in pack:
        pack["tiled"] = tile_for_kernel(pack)
    return pack["tiled"]


def embed_window(plan: dict, step, barf_cfg, device=None) -> torch.Tensor:
    """(E,) f32 embedding window: ones, or the BARF window at ``step`` for a
    ``barf`` node (the JAX package's ``_fused_embed_plan`` column 3)."""
    L = plan["multires"]
    if plan["embedding"] == "barf" and step is not None:
        win = barf_window(barf_alpha(step, L, *barf_cfg), L)
    else:
        win = torch.ones(_emb_width(L))
    return win.to(device=device, dtype=torch.float32)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _multires(window: torch.Tensor) -> int:
    E = window.shape[0]
    if E % 6 != 3 or E > EMB_PAD:
        raise ValueError(f"embedding window of width {E}")
    return (E // 3 - 1) // 2


def _lin(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # bf16 operands, f32 sums: the kernel's preferred_element_type=f32
    return h.float() @ w.float().T + b


def sampler_sdf_plain(xc: torch.Tensor, window: torch.Tensor, pack: dict) -> torch.Tensor:
    """Embedding + bf16 trunk + f32 head at canonical points: (N, 3) -> (N,)."""
    emb = fourier_embed(xc.float(), _multires(window)) * window
    emb = torch.nn.functional.pad(emb, (0, EMB_PAD - emb.shape[1])).to(torch.bfloat16)
    bias = pack["bias"]
    h = emb
    for l in range(4):
        h = softplus100(_lin(h, pack[f"W{l}"], bias[l])).to(torch.bfloat16)
    h4 = _lin(h, pack["W4h"], bias[4]) + emb.float() @ pack["W4e"].float().T
    h = softplus100(h4).to(torch.bfloat16)
    for l in (5, 6):
        h = softplus100(_lin(h, pack[f"W{l}"], bias[l])).to(torch.bfloat16)
    h = softplus100(_lin(h, pack["W7"], bias[7]))
    return h @ pack["head_w"] + pack["head_b"]


def points_from_rays_z(ray_dirs, cam_loc, z) -> torch.Tensor:
    """(B*P, 3), (B*P, 3), (B, P, S) -> world points (B, P*S, 3): cam + z*dir."""
    B, P, S = z.shape
    pts = cam_loc[:, None, :] + z.reshape(B * P, S)[:, :, None] * ray_dirs[:, None, :]
    return pts.reshape(B, P * S, 3)


def rigid_inverse_plain(pts: torch.Tensor, tf_inv12: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, 12) [Rinv row-major | t] -> Rinv (x - t), (B, N, 3)."""
    R = tf_inv12[:, None, :9]
    d = pts - tf_inv12[:, None, 9:12]
    return torch.stack(
        [sum(R[..., 3 * i + m] * d[..., m] for m in range(3)) for i in range(3)], dim=-1
    )


@torch.no_grad()
def hand_query_plain(pts, verts, skin_weights, tfs, window, pack, K: int = 15):
    """Plain version of the hand kernel: pts (B, N, 3) -> sdf (B, N)."""
    xc, _ = inverse_warp_plain(pts, verts, skin_weights, tfs, K=K)
    return sampler_sdf_plain(xc.reshape(-1, 3), window, pack).reshape(pts.shape[:2])


@torch.no_grad()
def object_query_plain(pts, tf_inv12, window, pack):
    """Plain version of the object kernel: pts (B, N, 3) -> sdf (B, N)."""
    xc = rigid_inverse_plain(pts, tf_inv12)
    return sampler_sdf_plain(xc.reshape(-1, 3), window, pack).reshape(pts.shape[:2])


# --------------------------------------------------------------------------
# CUDA launches (csrc/fused_query.cu)
# --------------------------------------------------------------------------

def _require_cpu(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for device {t.device}")


def _check_trunk(window, pack) -> int:
    multires = _multires(window)
    _cuda.check(window, "window", (window.shape[0],))
    _cuda.check(pack["bf16"], "pack['bf16']", (W_TOTAL,), torch.bfloat16)
    _cuda.check(pack["f32"], "pack['f32']", (F_TOTAL,))
    _cuda.check(_kernel_weights(pack), "pack['tiled']", (N_SLABS * SLAB,), torch.bfloat16)
    return multires


def _check_hand(verts, skin_weights, tfs, B, K) -> tuple:
    V, J = verts.shape[1], skin_weights.shape[2]
    if not 1 <= K <= KMAX:
        raise ValueError(f"K={K} outside the kernel's 1..{KMAX}")
    if not 1 <= J <= JMAX or not 1 <= V <= VMAX:
        raise ValueError(f"unsupported J={J} / V={V} for the fused hand query")
    _cuda.check(verts, "verts", (B, V, 3))
    _cuda.check(skin_weights, "skin_weights", (B, V, J))
    _cuda.check(tfs, "tfs", (B, J, 4, 4))
    return V, J


def _check_rays(ray_dirs, cam_loc, z) -> None:
    B, P, S = z.shape
    _cuda.check(z, "z", (B, P, S))
    _cuda.check(ray_dirs, "ray_dirs", (B * P, 3))
    _cuda.check(cam_loc, "cam_loc", (B * P, 3))


def _ptr(*ts) -> list:
    return [t.data_ptr() for t in ts]


def _emb_scratch(B: int, n: int, device) -> torch.Tensor:
    """The embedding tiles the warp step hands to the trunk kernel: 16 KB a
    128-point tile of a frame."""
    return torch.empty((B * -(-n // TILE) * EMB_TILE_BYTES,), dtype=torch.uint8, device=device)


# --------------------------------------------------------------------------
# Public wrappers (stop-gradient by contract)
# --------------------------------------------------------------------------

@torch.no_grad()
def fused_hand_sampler_sdf_z(ray_dirs, cam_loc, z, verts, skin_weights, tfs, window, pack,
                             K: int = 15):
    """Hand: rays (B*P, 3) x z (B, P, S), MANO frame (verts (B,V,3), skin
    (B,V,J), tfs (B,J,4,4)) -> sdf (B, P, S) f32."""
    B, P, S = z.shape
    if z.is_cuda:
        _check_rays(ray_dirs, cam_loc, z)
        V, J = _check_hand(verts, skin_weights, tfs, B, K)
        multires = _check_trunk(window, pack)
        out = torch.empty((B, P, S), dtype=torch.float32, device=z.device)
        _cuda.launch("hold_fused_hand_sdf_z",
                     *_ptr(ray_dirs, cam_loc, z, verts, skin_weights, tfs, window,
                           pack["tiled"], pack["f32"], _emb_scratch(B, P * S, z.device), out),
                     B, P, S, V, J, K, multires)
        LAUNCHES["fused_hand_sampler_sdf_z"] += 1
        return out
    _require_cpu(z)
    return hand_query_plain(points_from_rays_z(ray_dirs, cam_loc, z), verts, skin_weights, tfs,
                            window, pack, K).reshape(B, P, S)


@torch.no_grad()
def fused_object_sampler_sdf_z(ray_dirs, cam_loc, z, tf_inv12, window, pack):
    """Object: rays (B*P, 3) x z (B, P, S), per-frame inverse affine
    (B, 12: Rinv row-major | t) -> sdf (B, P, S) f32."""
    B, P, S = z.shape
    if z.is_cuda:
        _check_rays(ray_dirs, cam_loc, z)
        _cuda.check(tf_inv12, "tf_inv12", (B, 12))
        multires = _check_trunk(window, pack)
        out = torch.empty((B, P, S), dtype=torch.float32, device=z.device)
        _cuda.launch("hold_fused_object_sdf_z",
                     *_ptr(ray_dirs, cam_loc, z, tf_inv12, window, pack["tiled"], pack["f32"],
                           _emb_scratch(B, P * S, z.device), out), B, P, S, multires)
        LAUNCHES["fused_object_sampler_sdf_z"] += 1
        return out
    _require_cpu(z)
    return object_query_plain(points_from_rays_z(ray_dirs, cam_loc, z), tf_inv12, window,
                              pack).reshape(B, P, S)


@torch.no_grad()
def fused_hand_sampler_sdf(pts, verts, skin_weights, tfs, window, pack, K: int = 15):
    """Hand from a point buffer: pts (B, N, 3) -> sdf (B, N) f32."""
    B, N = pts.shape[:2]
    if pts.is_cuda:
        _cuda.check(pts, "pts", (B, N, 3))
        V, J = _check_hand(verts, skin_weights, tfs, B, K)
        multires = _check_trunk(window, pack)
        out = torch.empty((B, N), dtype=torch.float32, device=pts.device)
        _cuda.launch("hold_fused_hand_sdf",
                     *_ptr(pts, verts, skin_weights, tfs, window, pack["tiled"], pack["f32"],
                           _emb_scratch(B, N, pts.device), out), B, N, V, J, K, multires)
        LAUNCHES["fused_hand_sampler_sdf"] += 1
        return out
    _require_cpu(pts)
    return hand_query_plain(pts, verts, skin_weights, tfs, window, pack, K)


@torch.no_grad()
def fused_object_sampler_sdf(pts, tf_inv12, window, pack):
    """Object from a point buffer: pts (B, N, 3), tf_inv12 (B, 12) -> sdf
    (B, N) f32."""
    B, N = pts.shape[:2]
    if pts.is_cuda:
        _cuda.check(pts, "pts", (B, N, 3))
        _cuda.check(tf_inv12, "tf_inv12", (B, 12))
        multires = _check_trunk(window, pack)
        out = torch.empty((B, N), dtype=torch.float32, device=pts.device)
        _cuda.launch("hold_fused_object_sdf",
                     *_ptr(pts, tf_inv12, window, pack["tiled"], pack["f32"],
                           _emb_scratch(B, N, pts.device), out), B, N, multires)
        LAUNCHES["fused_object_sampler_sdf"] += 1
        return out
    _require_cpu(pts)
    return object_query_plain(pts, tf_inv12, window, pack)


# --------------------------------------------------------------------------
# Analytic cost model
# --------------------------------------------------------------------------

def sampler_query_flops_per_step(scene, n_rays: int) -> float:
    """FLOPs per training step of the fused sampler queries (all nodes).

    Every refinement round queries N_samples_eval fresh points per ray.  Per
    point: the trunk products as the kernel multiplies them, zero pads
    included, and the head row (483,584 MACs; the TPU pack's 224-row layer 3
    makes 467,200, and the JAX cost model's 532,736 counts one 256x256
    product twice); the hand adds two distance sweeps over its vertices, the
    blends and the affine solve, the object its rigid inverse."""
    cfg = scene.sampler_cfg
    pts_per_ray = cfg.N_samples_eval * cfg.max_total_iters
    total = 0.0
    for nid in scene.node_ids:
        plans = scene.plans[nid]
        if not plans.fused_query:
            continue
        f = TRUNK_FLOPS_PER_POINT
        if nid == "object":
            f += 2.0 * 9 + 6
        else:
            V = scene.servers[nid].verts_c.shape[1]
            J = scene.servers[nid].skin_weights_c.shape[2]
            f += 2 * 8.0 * V + 2.0 * plans.knn_k * J + 2.0 * 12 * J + 120
        total += f * pts_per_ray * n_rays
    return total
