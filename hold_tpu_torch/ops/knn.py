"""KNN skinning-weight query and LBS warps (counterpart of hold_tpu/ops/knn.py).

For each query point the K nearest MANO vertices are found by squared
distance, their skinning weights are blended with confidences
``exp(-min(d2, 4))`` normalised over the set, the blend is detached (no
gradient to vertices or weights, as in the reference deformer), and points
whose nearest vertex lies farther than ``max_dist`` are flagged as outliers.

Which vertices are "the K nearest" follows the TPU kernels of the JAX
package, not its jnp fallback.  The fallback (``knn_blend_weights_xla``) takes
``lax.top_k`` of the distances CLAMPED at 4; the Pallas kernels keep every
vertex whose UNCLAMPED squared distance is <= the K-th smallest distinct
value (``kth_smallest``, ties included).  The two disagree for any point whose
K-th nearest vertex lies more than 2 units away, which many sampler points
inside the scene sphere are.  The TPU main path computes the threshold form,
so the port's plain versions and its CUDA kernels both do.

Four kernels, each with a plain PyTorch version in this module:

- ``knn_blend_weights`` / ``knn_blend_weights_t``: the blended weights
  alone, (B,P,J) or points-minor (B,J,P), stop-gradient (one kernel with two
  output layouts; no path of either package calls them);
- ``knn_inverse_warp``: sampler warp, stop-gradient.
- ``knn_inverse_warp_diff``: the grad stage's warp; closed-form backward
  (a kernel too) for ``pts`` and ``tfs``.
- ``knn_jacobian_inverse``: inverse skinning Jacobian at canonical points;
  closed-form backward (a kernel) for the bone rotations only.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel from ``csrc/knn.cu`` or raises; it never falls back.
Each launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import torch

from . import _cuda
from ..utils.transforms import inverse_affine4, inverse_mat3

_CLAMP = 4.0
_BIG = 1e9
KMAX = 16  # register top-list length in csrc/knn.cu
JMAX = 16
VMAX = 14000  # vertices that fit the kernels' shared memory (16 B each)

LAUNCHES = {
    "knn_blend_weights": 0,
    "knn_blend_weights_t": 0,
    "knn_inverse_warp": 0,
    "knn_inverse_warp_diff.fwd": 0,
    "knn_inverse_warp_diff.bwd": 0,
    "knn_jacobian_inverse.fwd": 0,
    "knn_jacobian_inverse.bwd": 0,
}


def _require_cpu(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for device {t.device}")


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


def _blend_plain(pts, verts, skin_weights, K):
    """Threshold-form KNN blend: (weights (B,P,J), min d2 (B,P)), detached."""
    with torch.no_grad():
        d2 = _pairwise_sqdist(pts, verts)
        kth = kth_smallest(d2, K, dim=-1)
        conf = torch.where(
            d2 <= kth, torch.exp(-torch.clamp(d2, max=_CLAMP)),
            torch.zeros_like(d2),
        )
        conf = conf / torch.sum(conf, dim=-1, keepdim=True)
        w = torch.einsum("bpv,bvj->bpj", conf, skin_weights)
        return w, torch.amin(d2, dim=-1)


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


# --------------------------------------------------------------------------
# CUDA launches (csrc/knn.cu)
# --------------------------------------------------------------------------

def _check_blend(pts, verts, skin_weights, K):
    B, P = pts.shape[:2]
    V, J = verts.shape[1], skin_weights.shape[2]
    if not 1 <= K <= KMAX:
        raise ValueError(f"K={K} outside the kernel's 1..{KMAX}")
    if not 1 <= J <= JMAX or V > VMAX or V < 1:
        raise ValueError(f"unsupported J={J} / V={V} for the KNN kernels")
    _cuda.check(pts, "pts", (B, P, 3))
    _cuda.check(verts, "verts", (B, V, 3))
    _cuda.check(skin_weights, "skin_weights", (B, V, J))
    return B, P, V, J


def _check_knn(pts, verts, skin_weights, tfs, K):
    B, P, V, J = _check_blend(pts, verts, skin_weights, K)
    _cuda.check(tfs, "tfs", (B, J, 4, 4))
    return B, P, V, J


def _blend_cuda(pts, verts, skin_weights, K, max_dist, transposed):
    B, P, V, J = _check_blend(pts, verts, skin_weights, K)
    shape = (B, J, P) if transposed else (B, P, J)
    w = torch.empty(shape, dtype=torch.float32, device=pts.device)
    outlier = torch.empty((B, P), dtype=torch.bool, device=pts.device)
    _cuda.launch("hold_knn_blend", pts.data_ptr(), verts.data_ptr(), skin_weights.data_ptr(),
                 w.data_ptr(), outlier.data_ptr(), B, P, V, J, K, float(max_dist),
                 int(transposed))
    LAUNCHES["knn_blend_weights_t" if transposed else "knn_blend_weights"] += 1
    return w, outlier


def _warp_fwd_cuda(pts, verts, skin_weights, tfs, K, max_dist, resid, name):
    B, P, V, J = _check_knn(pts, verts, skin_weights, tfs, K)
    dev = pts.device
    xc = torch.empty((B, P, 3), dtype=torch.float32, device=dev)
    outlier = torch.empty((B, P), dtype=torch.bool, device=dev)
    inv = wb = None
    if resid:
        inv = torch.empty((B, P, 9), dtype=torch.float32, device=dev)
        wb = torch.empty((B, P, J), dtype=torch.float32, device=dev)
    _cuda.launch(
        "hold_knn_warp_fwd", pts.data_ptr(), verts.data_ptr(),
        skin_weights.data_ptr(), tfs.data_ptr(), xc.data_ptr(),
        outlier.data_ptr(), None if inv is None else inv.data_ptr(),
        None if wb is None else wb.data_ptr(), B, P, V, J, K, float(max_dist),
    )
    LAUNCHES[name] += 1
    return xc, outlier, inv, wb


def _warp_bwd_cuda(g, inv, xc, wb):
    """Kernel 2 backward: (dpts (B,P,3), dtfs (B,J,4,4))."""
    B, P, J = wb.shape
    g = g.contiguous()
    _cuda.check(g, "g_xc", (B, P, 3))
    dpts = torch.empty_like(g)
    dtfs = torch.empty((B, J, 4, 4), dtype=torch.float32, device=g.device)
    _cuda.launch(
        "hold_knn_warp_bwd", g.data_ptr(), inv.data_ptr(), xc.data_ptr(),
        wb.data_ptr(), dpts.data_ptr(), dtfs.data_ptr(), B, P, J,
    )
    LAUNCHES["knn_inverse_warp_diff.bwd"] += 1
    return dpts, dtfs


def _jinv_fwd_cuda(pts_c, verts_c, skin_weights, tfs, K):
    """Kernel 3 forward: (J^-1 (B,P,9), blended weights (B,P,J))."""
    B, P, V, J = _check_knn(pts_c, verts_c, skin_weights, tfs, K)
    inv = torch.empty((B, P, 9), dtype=torch.float32, device=pts_c.device)
    wb = torch.empty((B, P, J), dtype=torch.float32, device=pts_c.device)
    _cuda.launch(
        "hold_knn_jinv_fwd", pts_c.data_ptr(), verts_c.data_ptr(),
        skin_weights.data_ptr(), tfs.data_ptr(), inv.data_ptr(), wb.data_ptr(),
        B, P, V, J, K,
    )
    LAUNCHES["knn_jacobian_inverse.fwd"] += 1
    return inv, wb


def _jinv_bwd_cuda(g, inv, wb):
    """Kernel 3 backward: dtfs (B,J,4,4), rotation block only."""
    B, P, J = wb.shape
    g = g.contiguous()
    _cuda.check(g, "g_jinv", (B, P, 9))
    dtfs = torch.empty((B, J, 4, 4), dtype=torch.float32, device=g.device)
    _cuda.launch(
        "hold_knn_jinv_bwd", g.data_ptr(), inv.data_ptr(), wb.data_ptr(),
        dtfs.data_ptr(), B, P, J,
    )
    LAUNCHES["knn_jacobian_inverse.bwd"] += 1
    return dtfs


class _InverseWarpDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, verts, skin_weights, tfs, K, max_dist):
        xc, outlier, inv, wb = _warp_fwd_cuda(
            pts, verts, skin_weights, tfs, K, max_dist, True,
            "knn_inverse_warp_diff.fwd",
        )
        ctx.save_for_backward(inv, xc, wb)
        ctx.mark_non_differentiable(outlier)
        return xc, outlier

    @staticmethod
    def backward(ctx, g_xc, _g_outlier):
        dpts, dtfs = _warp_bwd_cuda(g_xc, *ctx.saved_tensors)
        return dpts, None, None, dtfs, None, None


class _JacobianInverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts_c, verts_c, skin_weights, tfs, K):
        inv, wb = _jinv_fwd_cuda(pts_c, verts_c, skin_weights, tfs, K)
        ctx.save_for_backward(inv, wb)
        return inv

    @staticmethod
    def backward(ctx, g):
        return None, None, None, _jinv_bwd_cuda(g, *ctx.saved_tensors), None


# --------------------------------------------------------------------------
# Public wrappers
# --------------------------------------------------------------------------

def knn_blend_weights(pts, verts, skin_weights, K: int = 15, max_dist: float = 0.1):
    """KNN blend (stop-gradient): pts (B,P,3), verts (B,V,3), skin_weights
    (B,V,J) -> (weights (B,P,J), outlier (B,P))."""
    args = [t.detach() for t in (pts, verts, skin_weights)]
    if pts.is_cuda:
        return _blend_cuda(*args, K, max_dist, False)
    _require_cpu(pts)
    return blend_weights_plain(*args, K, max_dist)


def knn_blend_weights_t(pts, verts, skin_weights, K: int = 15, max_dist: float = 0.1):
    """Points-minor KNN blend (stop-gradient): -> (weights (B,J,P), outlier (B,P))."""
    args = [t.detach() for t in (pts, verts, skin_weights)]
    if pts.is_cuda:
        return _blend_cuda(*args, K, max_dist, True)
    _require_cpu(pts)
    w, outlier = blend_weights_plain(*args, K, max_dist)
    return w.transpose(1, 2).contiguous(), outlier


def knn_inverse_warp(pts, verts, skin_weights, tfs, K: int = 15,
                     max_dist: float = 0.1):
    """Sampler warp (stop-gradient): pts (B,P,3), verts (B,V,3),
    skin_weights (B,V,J), tfs (B,J,4,4) -> (x_c (B,P,3), outlier (B,P))."""
    args = [t.detach() for t in (pts, verts, skin_weights, tfs)]
    if pts.is_cuda:
        xc, outlier, _, _ = _warp_fwd_cuda(
            *args, K, max_dist, False, "knn_inverse_warp"
        )
        return xc, outlier
    _require_cpu(pts)
    with torch.no_grad():
        return inverse_warp_plain(*args, K=K, max_dist=max_dist)


def knn_inverse_warp_diff(pts, verts, skin_weights, tfs, K: int = 15,
                          max_dist: float = 0.1):
    """Differentiable warp of the grad stage: gradients reach ``pts`` and
    ``tfs``; ``verts`` and ``skin_weights`` are detached by contract."""
    verts, skin_weights = verts.detach(), skin_weights.detach()
    if pts.is_cuda:
        return _InverseWarpDiff.apply(pts, verts, skin_weights, tfs, K, max_dist)
    _require_cpu(pts)
    return inverse_warp_plain(pts, verts, skin_weights, tfs, K, max_dist)


def knn_jacobian_inverse(pts_c, verts_c, skin_weights, tfs, K: int = 15):
    """(B,P,3),(B,V,3),(B,V,J),(B,J,4,4) -> (B,P,9) row-major J^-1 at
    canonical points; gradient reaches the rotations of ``tfs`` only."""
    pts_c, verts_c = pts_c.detach(), verts_c.detach()
    skin_weights = skin_weights.detach()
    if pts_c.is_cuda:
        return _JacobianInverse.apply(pts_c, verts_c, skin_weights, tfs, K)
    _require_cpu(pts_c)
    return jacobian_inverse_plain(pts_c, verts_c, skin_weights, tfs, K)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
