"""Plain KNN skinning-weight blend and LBS warps (a frozen copy of the
port's plain versions, ``hold_tpu_torch/ops/knn.py``, which follow the JAX
package's TPU kernels).

For each point the vertices whose squared distance is at most the K-th
smallest distinct one are blended with confidences ``exp(-min(d2, 4))``
normalised over the set; the blend is detached.  Points go through in
blocks so that the (block, V) distance matrix stays bounded.
"""

from __future__ import annotations

import torch

from .transforms import inverse_affine4, inverse_mat3

_CLAMP = 4.0
_BIG = 1e9
BLOCK_ELEMS = 1 << 27  # distances a block


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def kth_smallest(d2: torch.Tensor, K: int, dim: int) -> torch.Tensor:
    """K-th smallest DISTINCT value along ``dim`` (keepdim), by K-1 masked-min
    passes; 1e9 when fewer than K distinct values exist."""
    big = torch.full_like(d2, _BIG)
    kth = torch.amin(d2, dim=dim, keepdim=True)
    for _ in range(K - 1):
        kth = torch.amin(torch.where(d2 > kth, d2, big), dim=dim, keepdim=True)
    return kth


def sqnorm3(x: torch.Tensor) -> torch.Tensor:
    """(x0*x0 + x1*x1) + x2*x2 over the last dim, in the kernels' order."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]


def _pairwise_sqdist(pts: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """(B,P,3),(B,V,3) -> (B,P,V) max((|v|^2 + |p|^2) - 2 p.v, 0).

    Every product and sum is its own rounded fp32 operation, in the same
    order as csrc/knn.cu, so that plain and kernel see bit-identical
    distances: the K-th distinct distance often falls inside a cluster of
    distances that differ only by rounding (a ring of vertices seen from
    afar), and the neighbour set must not depend on the implementation."""
    p, v = pts[:, :, None, :], verts[:, None, :, :]
    cross = (p[..., 0] * v[..., 0] + p[..., 1] * v[..., 1]) + p[..., 2] * v[..., 2]
    d2 = (sqnorm3(verts)[:, None, :] + sqnorm3(pts)[:, :, None]) - 2.0 * cross
    return torch.clamp(d2, min=0.0)


def _blend_block(pts, verts, skin_weights, K):
    d2 = _pairwise_sqdist(pts, verts)
    kth = kth_smallest(d2, K, dim=-1)
    conf = torch.where(
        d2 <= kth, torch.exp(-torch.clamp(d2, max=_CLAMP)),
        torch.zeros_like(d2),
    )
    conf = conf / torch.sum(conf, dim=-1, keepdim=True)
    w = torch.einsum("bpv,bvj->bpj", conf, skin_weights)
    return w, torch.amin(d2, dim=-1)


def _blend_plain(pts, verts, skin_weights, K):
    """Threshold-form KNN blend: (weights (B,P,J), min d2 (B,P)), detached,
    in blocks of points."""
    B, P = pts.shape[:2]
    step = max(1, BLOCK_ELEMS // max(B * verts.shape[1], 1))
    with torch.no_grad():
        parts = [_blend_block(pts[:, s:s + step].detach(), verts.detach(), skin_weights, K)
                 for s in range(0, P, step)]
    return torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1)


def _outlier(dmin: torch.Tensor, max_dist: float) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dmin, max=_CLAMP)) > max_dist


def blend_weights_plain(pts, verts, skin_weights, K=15, max_dist=0.1):
    """Plain version of the blend kernel: (weights (B,P,J), outlier (B,P))."""
    w, dmin = _blend_plain(pts, verts, skin_weights, K)
    return w, _outlier(dmin, max_dist)


def skinning(x: torch.Tensor, w: torch.Tensor, tfs: torch.Tensor,
             inverse: bool = False) -> torch.Tensor:
    """Blend-skin points. x (B,P,3), w (B,P,J), tfs (B,J,4,4)."""
    w_tf = torch.einsum("bpj,bjmn->bpmn", w, tfs)
    if inverse:
        w_tf = inverse_affine4(w_tf)
    return torch.einsum("bpmn,bpn->bpm", w_tf[..., :3, :3], x) + w_tf[..., :3, 3]


def skinning_jacobian(w: torch.Tensor, tfs: torch.Tensor) -> torch.Tensor:
    """J = sum_j w_j R_j: (B,P,J),(B,J,4,4) -> (B,P,3,3)."""
    return torch.einsum("bpj,bjmn->bpmn", w, tfs[..., :3, :3])


def inverse_warp_plain(pts, verts, skin_weights, tfs, K=15, max_dist=0.1):
    """Plain version of kernels 1 and 2: (x_c (B,P,3), outlier (B,P)).
    Differentiable w.r.t. ``pts`` and ``tfs`` (the blend is detached)."""
    w, dmin = _blend_plain(pts, verts, skin_weights, K)
    return skinning(pts, w, tfs, inverse=True), _outlier(dmin, max_dist)


def jacobian_inverse_plain(pts_c, verts_c, skin_weights, tfs, K=15):
    """Plain version of kernel 3: (B,P,9) row-major J^-1, differentiable
    w.r.t. ``tfs`` only."""
    B, P = pts_c.shape[:2]
    w, _ = _blend_plain(pts_c, verts_c, skin_weights, K)
    return inverse_mat3(skinning_jacobian(w, tfs)).reshape(B, P, 9)


