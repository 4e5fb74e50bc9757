"""Fused sampler SDF query (counterpart of hold_tpu/ops/fused_query.py).

The error-bound sampler evaluates each node's canonical SDF at every point of
every refinement round, with no gradient.  ``csrc/fused_query.cu`` does the
whole query in two kernels a call: the world point (``cam + z*dir`` from the
z table, or a point buffer) -> canonical space (the hand's KNN blend and
inverse skinning, the object's rigid inverse) -> the Fourier/BARF embedding,
96 bytes a point handed on through a scratch buffer; then the 8x256
softplus100 trunk -> the SDF head on the tensor cores (``wgmma``), its weights
the trunk pack's stream (``ops/weight_pack.py`` ``tile_trunk``).

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

Each takes ``relu`` (the JAX package's ``relu=``, ``HOLD_SAMPLER_RELU``):
the seven hidden layers take relu in place of softplus100, the layer into
the head keeps softplus100; the kernel's ``query_trunk_kernel<true>``.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel or raises; it never falls back.  Each launch adds one to
``LAUNCHES[name]``, a relu launch to ``LAUNCHES[name + ".relu"]``.
"""

from __future__ import annotations

import torch

from . import _cuda
from .knn import (
    JMAX,
    KMAX,
    VMAX,
    check_order,
    check_order_length,
    inverse_warp_plain,
    stats_ptr,
)
from .weight_pack import (
    EMB_PAD,
    H,
    N_SLABS,
    SLAB,
    F_TOTAL,
    W_TOTAL,
    tile_trunk,
    window_multires,
)
from ..models.embedders import fourier_embed
from ..models.mlp import softplus100

TILE = 128  # points a CTA owns (csrc/cta_gemm.cuh TILE_M)
EMB_TILE_BYTES = TILE * 128  # a tile's embedding rows as the trunk kernel reads them
# the trunk's FLOPs a point as the kernel multiplies it (zero pads included),
# for the rate it reaches
TRUNK_FLOPS_PER_POINT = 2.0 * (W_TOTAL + H)
# the MACs a point the function needs (no pads), for its bound: layer 0 takes
# E inputs and layer 3 gives 256 - E outputs, which layer 4 takes beside the
# E embedding columns, so E cancels: seven 256x256 products and the head row
TRUNK_MACS = 7 * H * H + H

WRAPPERS = ("fused_hand_sampler_sdf_z", "fused_object_sampler_sdf_z", "fused_hand_sampler_sdf",
            "fused_object_sampler_sdf")
LAUNCHES = {f"{w}{form}": 0 for w in WRAPPERS for form in ("", ".relu")}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _lin(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # bf16 operands, f32 sums: the kernel's preferred_element_type=f32
    return h.float() @ w.float().T + b


def sampler_sdf_plain(xc: torch.Tensor, window: torch.Tensor, pack: dict,
                      relu: bool = False) -> torch.Tensor:
    """Embedding + bf16 trunk + f32 head at canonical points: (N, 3) -> (N,).
    ``relu``: relu on the seven hidden layers, softplus100 into the head."""
    emb = fourier_embed(xc.float(), window_multires(window)) * window
    emb = torch.nn.functional.pad(emb, (0, EMB_PAD - emb.shape[1])).to(torch.bfloat16)
    act = torch.relu if relu else softplus100
    bias = pack["bias"]
    h = emb
    for l in range(4):
        h = act(_lin(h, pack[f"W{l}"], bias[l])).to(torch.bfloat16)
    h4 = _lin(h, pack["W4h"], bias[4]) + emb.float() @ pack["W4e"].float().T
    h = act(h4).to(torch.bfloat16)
    for l in (5, 6):
        h = act(_lin(h, pack[f"W{l}"], bias[l])).to(torch.bfloat16)
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
def hand_query_plain(pts, verts, skin_weights, tfs, window, pack, K: int = 15,
                     relu: bool = False):
    """Plain version of the hand kernel: pts (B, N, 3) -> sdf (B, N)."""
    xc, _ = inverse_warp_plain(pts, verts, skin_weights, tfs, K=K)
    return sampler_sdf_plain(xc.reshape(-1, 3), window, pack, relu).reshape(pts.shape[:2])


@torch.no_grad()
def object_query_plain(pts, tf_inv12, window, pack, relu: bool = False):
    """Plain version of the object kernel: pts (B, N, 3) -> sdf (B, N)."""
    xc = rigid_inverse_plain(pts, tf_inv12)
    return sampler_sdf_plain(xc.reshape(-1, 3), window, pack, relu).reshape(pts.shape[:2])


# --------------------------------------------------------------------------
# CUDA launches (csrc/fused_query.cu)
# --------------------------------------------------------------------------

def _kernel_weights(pack: dict) -> torch.Tensor:
    """The trunk's stream (``weight_pack.tile_trunk``), made once per pack
    and kept in it."""
    if "tiled" not in pack:
        pack["tiled"] = tile_trunk(pack)
    return pack["tiled"]


def check_pack(window, pack) -> int:
    """Raise unless the window and the trunk pack are the kernels' CUDA
    buffers; the embedding's frequencies."""
    multires = window_multires(window)
    _cuda.check(window, "window", (window.shape[0],))
    _cuda.check(pack["bf16"], "pack['bf16']", (W_TOTAL,), torch.bfloat16)
    _cuda.check(pack["f32"], "pack['f32']", (F_TOTAL,))
    return multires


def _check_trunk(window, pack) -> int:
    multires = check_pack(window, pack)
    _cuda.check(_kernel_weights(pack), "pack['tiled']", (N_SLABS * SLAB,), torch.bfloat16)
    return multires


def check_hand(verts, skin_weights, tfs, B, K) -> tuple:
    """Raise unless a hand's MANO frame is the kernels' CUDA buffers and
    within their search's limits; (V, J)."""
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


def _count(name: str, relu: bool) -> None:
    LAUNCHES[name + (".relu" if relu else "")] += 1


def _emb_scratch(B: int, n: int, device) -> torch.Tensor:
    """The embedding tiles the warp step hands to the trunk kernel: 16 KB a
    128-point tile of a frame."""
    return torch.empty((B * -(-n // TILE) * EMB_TILE_BYTES,), dtype=torch.uint8, device=device)


# --------------------------------------------------------------------------
# Public wrappers (stop-gradient by contract)
# --------------------------------------------------------------------------

@torch.no_grad()
def fused_hand_sampler_sdf_z(ray_dirs, cam_loc, z, verts, skin_weights, tfs, window, pack,
                             K: int = 15, relu: bool = False, *, order):
    """Hand: rays (B*P, 3) x z (B, P, S), MANO frame (verts (B,V,3), skin
    (B,V,J), tfs (B,J,4,4)) -> sdf (B, P, S) f32.  ``order``: the vertices'
    ``knn.tile_order``, which the kernel's search reads them in (the plain
    version does not read it)."""
    B, P, S = z.shape
    if z.is_cuda:
        _check_rays(ray_dirs, cam_loc, z)
        V, J = check_hand(verts, skin_weights, tfs, B, K)
        multires = _check_trunk(window, pack)
        out = torch.empty((B, P, S), dtype=torch.float32, device=z.device)
        _cuda.launch("hold_fused_hand_sdf_z",
                     *_cuda.ptrs(ray_dirs, cam_loc, z, verts, skin_weights, tfs),
                     check_order(order, V),
                     *_cuda.ptrs(window, pack["tiled"], pack["f32"],
                                 _emb_scratch(B, P * S, z.device), out),
                     B, P, S, V, J, K, multires, int(relu), stats_ptr())
        _count("fused_hand_sampler_sdf_z", relu)
        return out
    _cuda.require_cpu(z)
    check_order_length(order, verts.shape[1])
    return hand_query_plain(points_from_rays_z(ray_dirs, cam_loc, z), verts, skin_weights, tfs,
                            window, pack, K, relu).reshape(B, P, S)


@torch.no_grad()
def fused_object_sampler_sdf_z(ray_dirs, cam_loc, z, tf_inv12, window, pack,
                               relu: bool = False):
    """Object: rays (B*P, 3) x z (B, P, S), per-frame inverse affine
    (B, 12: Rinv row-major | t) -> sdf (B, P, S) f32."""
    B, P, S = z.shape
    if z.is_cuda:
        _check_rays(ray_dirs, cam_loc, z)
        _cuda.check(tf_inv12, "tf_inv12", (B, 12))
        multires = _check_trunk(window, pack)
        out = torch.empty((B, P, S), dtype=torch.float32, device=z.device)
        _cuda.launch("hold_fused_object_sdf_z",
                     *_cuda.ptrs(ray_dirs, cam_loc, z, tf_inv12, window, pack["tiled"],
                                 pack["f32"], _emb_scratch(B, P * S, z.device), out),
                     B, P, S, multires, int(relu))
        _count("fused_object_sampler_sdf_z", relu)
        return out
    _cuda.require_cpu(z)
    return object_query_plain(points_from_rays_z(ray_dirs, cam_loc, z), tf_inv12, window,
                              pack, relu).reshape(B, P, S)


@torch.no_grad()
def fused_hand_sampler_sdf(pts, verts, skin_weights, tfs, window, pack, K: int = 15,
                           relu: bool = False, *, order):
    """Hand from a point buffer: pts (B, N, 3) -> sdf (B, N) f32."""
    B, N = pts.shape[:2]
    if pts.is_cuda:
        _cuda.check(pts, "pts", (B, N, 3))
        V, J = check_hand(verts, skin_weights, tfs, B, K)
        multires = _check_trunk(window, pack)
        out = torch.empty((B, N), dtype=torch.float32, device=pts.device)
        _cuda.launch("hold_fused_hand_sdf",
                     *_cuda.ptrs(pts, verts, skin_weights, tfs), check_order(order, V),
                     *_cuda.ptrs(window, pack["tiled"], pack["f32"],
                                 _emb_scratch(B, N, pts.device), out),
                     B, N, V, J, K, multires, int(relu), stats_ptr())
        _count("fused_hand_sampler_sdf", relu)
        return out
    _cuda.require_cpu(pts)
    check_order_length(order, verts.shape[1])
    return hand_query_plain(pts, verts, skin_weights, tfs, window, pack, K, relu)


@torch.no_grad()
def fused_object_sampler_sdf(pts, tf_inv12, window, pack, relu: bool = False):
    """Object from a point buffer: pts (B, N, 3), tf_inv12 (B, 12) -> sdf
    (B, N) f32."""
    B, N = pts.shape[:2]
    if pts.is_cuda:
        _cuda.check(pts, "pts", (B, N, 3))
        _cuda.check(tf_inv12, "tf_inv12", (B, 12))
        multires = _check_trunk(window, pack)
        out = torch.empty((B, N), dtype=torch.float32, device=pts.device)
        _cuda.launch("hold_fused_object_sdf",
                     *_cuda.ptrs(pts, tf_inv12, window, pack["tiled"], pack["f32"],
                                 _emb_scratch(B, N, pts.device), out), B, N, multires, int(relu))
        _count("fused_object_sampler_sdf", relu)
        return out
    _cuda.require_cpu(pts)
    return object_query_plain(pts, tf_inv12, window, pack, relu)

