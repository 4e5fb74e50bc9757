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

The two backward kernels sum over a frame's points in a fixed order, the
same from call to call; ``warp_bwd_fixed_order`` and
``jinv_bwd_fixed_order`` repeat that order in PyTorch.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel from ``csrc/knn.cu`` or raises; it never falls back.
Each launch adds one to ``LAUNCHES[name]``.

The kernels search the vertices in tiles of 32 that lie close in space
(``csrc/knn_common.cuh``): ``tile_order`` makes that order once per vertex
set, and every wrapper requires it as ``order`` (the scene keeps the hand's
as ``NodePlans.tile_order``; the plain versions' results do not depend on
it).  ``count_search`` gathers the search's counts while it is open.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import _cuda
from ..utils.transforms import inverse_affine4, inverse_mat3

_CLAMP = 4.0
_BIG = 1e9
KMAX = 16  # register list length of the search (csrc/knn_common.cuh)
JMAX = 16
TILE_V = 32  # vertices a tile of the search
# a 128-thread CTA's candidate queues: 16 entries (d2, slot) of 8 bytes a lane
QUEUE_BYTES = 4 * 16 * 32 * 8
# rows 2-3 backward (csrc/knn.cu knn_tfs_bwd_kernel): a CTA sums a range of
# BWD_RANGE points of one frame, staged BWD_TILE at a time, over
# BWD_THREADS // J groups of threads
BWD_THREADS, BWD_TILE, BWD_RANGE = 256, 128, 256


def search_vmax() -> int:
    """Most vertices V whose staged set (16 bytes a vertex and two 16-byte
    boxes a tile of 32) fits beside a 128-thread CTA's candidate queues in
    its shared memory (227 KB less the 1 KB of bone transforms)."""
    room = (232_448 - 1024 - QUEUE_BYTES) // 16
    V = room * TILE_V // (TILE_V + 2)
    while V + 2 * -(-V // TILE_V) > room:
        V -= 1
    return V


VMAX = search_vmax()

LAUNCHES = {
    "knn_blend_weights": 0,
    "knn_blend_weights_t": 0,
    "knn_inverse_warp": 0,
    "knn_inverse_warp_diff.fwd": 0,
    "knn_inverse_warp_diff.bwd": 0,
    "knn_jacobian_inverse.fwd": 0,
    "knn_jacobian_inverse.bwd": 0,
}


def tile_order(verts: torch.Tensor) -> torch.Tensor:
    """The kernels' vertex order for a vertex set (V, 3): tiles of TILE_V
    consecutive vertices that lie close in space, by recursive median
    splits along the longest extent, each a multiple of TILE_V vertices
    (only the last tile is partial).  int32 (V,) on ``verts``' device, made
    once per vertex set on the host."""
    v = verts.detach().reshape(-1, 3).cpu().double().numpy()

    def split(idx):
        if len(idx) <= TILE_V:
            return [idx]
        pts = v[idx]
        axis = int(np.argmax(pts.max(0) - pts.min(0)))
        idx = idx[np.argsort(pts[:, axis], kind="stable")]
        tiles = -(-len(idx) // TILE_V)
        left = TILE_V * -(-tiles // 2)  # the partial tile, if any, stays rightmost
        return split(idx[:left]) + split(idx[left:])

    order = np.concatenate(split(np.arange(len(v)))) if len(v) else np.zeros(0, np.int64)
    return torch.as_tensor(order.astype(np.int32), device=verts.device)


# the search's counts while count_search is open (SEARCH_COUNTS)
_STATS: list = []
SEARCH_COUNTS = ("lanes", "tie_lanes", "tiles_visited", "tiles_culled", "insert_rounds",
                 "inserts")


@contextlib.contextmanager
def count_search(device):
    """While open, every kernel that searches vertices (the KNN kernels, the
    fused query's and render's hand warp steps, min_vertex_dist) adds its
    counts to the yielded int64 tensor (6,) on ``device``, in the order of
    ``SEARCH_COUNTS``: lanes searched, lanes that took the tie sweep, tiles a
    warp visited, tiles a warp culled, the insertion rounds warps ran (each
    lane inserts once a round), the candidates lanes inserted into their
    lists (min_vertex_dist counts the lanes and tiles only)."""
    counts = torch.zeros(len(SEARCH_COUNTS), dtype=torch.int64, device=device)
    _STATS.append(counts)
    try:
        yield counts
    finally:
        _STATS.remove(counts)


def stats_ptr():
    """The open counters' address for a kernel, or None."""
    return _STATS[-1].data_ptr() if _STATS else None


def check_order(order, V: int):
    """The order's address for a kernel; raises unless it is a contiguous
    int32 CUDA tensor (V,)."""
    if order is None:
        raise ValueError("the kernel searches the vertices in tile order: pass "
                         "order=knn.tile_order(verts)")
    _cuda.check(order, "order", (V,), torch.int32)
    return order.data_ptr()


def check_order_length(order, V: int) -> None:
    """Raise when an order is given for another vertex set than the V
    vertices searched (a strided set ``verts[:, ::n]`` needs its own
    ``tile_order``).  The plain versions read no order: None passes."""
    if order is not None and order.shape != (V,):
        raise ValueError(f"order holds {tuple(order.shape)} entries for {V} vertices: make "
                         "the order of the vertex set searched (tile_order)")


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


def blend_plain(pts, verts, skin_weights, K):
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
    w, dmin = blend_plain(pts, verts, skin_weights, K)
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
    w, dmin = blend_plain(pts, verts, skin_weights, K)
    return skinning(pts, w, tfs, inverse=True), _outlier(dmin, max_dist)


def jacobian_inverse_plain(pts_c, verts_c, skin_weights, tfs, K=15):
    """Plain version of kernel 3: (B,P,9) row-major J^-1, differentiable
    w.r.t. ``tfs`` only."""
    B, P = pts_c.shape[:2]
    w, _ = blend_plain(pts_c, verts_c, skin_weights, K)
    return inverse_mat3(skinning_jacobian(w, tfs)).reshape(B, P, 9)


def bwd_ranges(P: int) -> int:
    """Point ranges a frame of the backward kernels: one CTA each."""
    return -(-P // BWD_RANGE)


def _range_sums(terms: torch.Tensor) -> torch.Tensor:
    """(B, P, 3, J, NC) per-point terms -> (B, ranges, 3, J, NC): each
    range's sum in the kernels' order.  Thread group g of a range's CTA adds
    the points g, g + NG, ... of each tile (NG = BWD_THREADS // J), tile
    after tile, each addition rounded; the groups' sums are added in group
    order.  Zeros pad the ranges and tiles (adding one changes no sum)."""
    B, P, _, J = terms.shape[:4]
    rest = terms.shape[2:]
    ng = BWD_THREADS // J
    tiles, steps = BWD_RANGE // BWD_TILE, -(-BWD_TILE // ng)
    n = bwd_ranges(P)
    x = terms.new_zeros((B, n * BWD_RANGE) + rest)
    x[:, :P] = terms
    x = x.reshape((B, n, tiles, BWD_TILE) + rest)
    x = torch.cat([x, x.new_zeros((B, n, tiles, steps * ng - BWD_TILE) + rest)], dim=3)
    x = x.reshape((B, n, tiles, steps, ng) + rest)  # tile point s * ng + g
    acc = x.new_zeros((B, n, ng) + rest)
    for k in range(tiles):
        for step in range(steps):
            acc = acc + x[:, :, k, step]
    part = acc[:, :, 0]
    for k in range(1, ng):
        part = part + acc[:, :, k]
    return part


def _sum_ranges(part: torch.Tensor) -> torch.Tensor:
    """(B, ranges, ...) -> (B, ...): the ranges' partials added in order, as
    the final kernel adds them."""
    out = part.new_zeros(part.shape[:1] + part.shape[2:])
    for k in range(part.shape[1]):
        out = out + part[:, k]
    return out


def warp_bwd_fixed_order(g, inv, xc, wb):
    """Row 2's backward in csrc/knn.cu's order of operations: u = A^-T g,
    dpts = u, dtfs[b, j, r] = -sum_p (wb[p, j] u_r) (x_c, 1) over each
    range, then over the ranges.  g (B,P,3), inv (B,P,9), xc (B,P,3), wb
    (B,P,J) -> (dpts (B,P,3), dtfs (B,J,4,4)).  Every operation is one
    rounded f32 operation, as in the kernel, so on the card the two agree
    bit for bit; the autograd of ``inverse_warp_plain`` sums in another
    order."""
    B, P, J = wb.shape
    m = inv.reshape(B, P, 3, 3)
    u = (m[..., 0, :] * g[..., 0:1] + m[..., 1, :] * g[..., 1:2]) + m[..., 2, :] * g[..., 2:3]
    wu = wb[:, :, None, :] * u[:, :, :, None]  # (B,P,3,J)
    terms = torch.cat([wu[..., None] * xc[:, :, None, None, :], wu[..., None]], dim=-1)
    dtfs = wb.new_zeros((B, J, 4, 4))
    dtfs[:, :, :3, :] = _sum_ranges(-_range_sums(terms)).permute(0, 2, 1, 3)
    return u, dtfs


def jinv_bwd_fixed_order(g, inv, wb):
    """Row 3's backward in csrc/knn.cu's order of operations: dA = -A^-T G
    A^-T a point, dtfs[b, j, :3, :3] = sum_p wb[p, j] dA over each range,
    then over the ranges.  g (B,P,9), inv (B,P,9), wb (B,P,J) -> dtfs
    (B,J,4,4), the rotation block only (see ``warp_bwd_fixed_order``)."""
    B, P, J = wb.shape
    m, G = inv.reshape(B, P, 3, 3), g.reshape(B, P, 3, 3)
    # pk[r, c] = sum_s m[s, r] G[s, c];  dA[r, c] = -sum_s pk[r, s] m[c, s]
    pk = ((m[..., 0, :, None] * G[..., 0, None, :] + m[..., 1, :, None] * G[..., 1, None, :])
          + m[..., 2, :, None] * G[..., 2, None, :])
    dA = -((pk[..., :, None, 0] * m[..., None, :, 0] + pk[..., :, None, 1] * m[..., None, :, 1])
           + pk[..., :, None, 2] * m[..., None, :, 2])
    terms = wb[:, :, None, :, None] * dA[:, :, :, None, :]  # (B,P,3,J,3)
    dtfs = wb.new_zeros((B, J, 4, 4))
    dtfs[:, :, :3, :3] = _sum_ranges(_range_sums(terms)).permute(0, 2, 1, 3)
    return dtfs


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


def _blend_cuda(pts, verts, skin_weights, K, max_dist, transposed, order):
    B, P, V, J = _check_blend(pts, verts, skin_weights, K)
    shape = (B, J, P) if transposed else (B, P, J)
    w = torch.empty(shape, dtype=torch.float32, device=pts.device)
    outlier = torch.empty((B, P), dtype=torch.bool, device=pts.device)
    _cuda.launch("hold_knn_blend", pts.data_ptr(), verts.data_ptr(), skin_weights.data_ptr(),
                 check_order(order, V), w.data_ptr(), outlier.data_ptr(), B, P, V, J, K,
                 float(max_dist), int(transposed), stats_ptr())
    LAUNCHES["knn_blend_weights_t" if transposed else "knn_blend_weights"] += 1
    return w, outlier


def _warp_fwd_cuda(pts, verts, skin_weights, tfs, K, max_dist, resid, name, order):
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
        skin_weights.data_ptr(), tfs.data_ptr(), check_order(order, V), xc.data_ptr(),
        outlier.data_ptr(), None if inv is None else inv.data_ptr(),
        None if wb is None else wb.data_ptr(), B, P, V, J, K, float(max_dist), stats_ptr(),
    )
    LAUNCHES[name] += 1
    return xc, outlier, inv, wb


def _warp_bwd_cuda(g, inv, xc, wb):
    """Kernel 2 backward: (dpts (B,P,3), dtfs (B,J,4,4)), summed in the
    order of ``warp_bwd_fixed_order``."""
    B, P, J = wb.shape
    g = g.contiguous()
    _cuda.check(g, "g_xc", (B, P, 3))
    dpts = torch.empty_like(g)
    part = torch.empty((B, bwd_ranges(P), J, 12), dtype=torch.float32, device=g.device)
    dtfs = torch.empty((B, J, 4, 4), dtype=torch.float32, device=g.device)
    _cuda.launch(
        "hold_knn_warp_bwd", g.data_ptr(), inv.data_ptr(), xc.data_ptr(),
        wb.data_ptr(), dpts.data_ptr(), part.data_ptr(), dtfs.data_ptr(), B, P, J,
    )
    LAUNCHES["knn_inverse_warp_diff.bwd"] += 1
    return dpts, dtfs


def _jinv_fwd_cuda(pts_c, verts_c, skin_weights, tfs, K, order):
    """Kernel 3 forward: (J^-1 (B,P,9), blended weights (B,P,J))."""
    B, P, V, J = _check_knn(pts_c, verts_c, skin_weights, tfs, K)
    inv = torch.empty((B, P, 9), dtype=torch.float32, device=pts_c.device)
    wb = torch.empty((B, P, J), dtype=torch.float32, device=pts_c.device)
    _cuda.launch(
        "hold_knn_jinv_fwd", pts_c.data_ptr(), verts_c.data_ptr(),
        skin_weights.data_ptr(), tfs.data_ptr(), check_order(order, V), inv.data_ptr(),
        wb.data_ptr(), B, P, V, J, K, stats_ptr(),
    )
    LAUNCHES["knn_jacobian_inverse.fwd"] += 1
    return inv, wb


def _jinv_bwd_cuda(g, inv, wb):
    """Kernel 3 backward: dtfs (B,J,4,4), rotation block only, summed in the
    order of ``jinv_bwd_fixed_order``."""
    B, P, J = wb.shape
    g = g.contiguous()
    _cuda.check(g, "g_jinv", (B, P, 9))
    part = torch.empty((B, bwd_ranges(P), J, 9), dtype=torch.float32, device=g.device)
    dtfs = torch.empty((B, J, 4, 4), dtype=torch.float32, device=g.device)
    _cuda.launch(
        "hold_knn_jinv_bwd", g.data_ptr(), inv.data_ptr(), wb.data_ptr(), part.data_ptr(),
        dtfs.data_ptr(), B, P, J,
    )
    LAUNCHES["knn_jacobian_inverse.bwd"] += 1
    return dtfs


class _InverseWarpDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, verts, skin_weights, tfs, K, max_dist, order):
        xc, outlier, inv, wb = _warp_fwd_cuda(
            pts, verts, skin_weights, tfs, K, max_dist, True,
            "knn_inverse_warp_diff.fwd", order,
        )
        ctx.save_for_backward(inv, xc, wb)
        ctx.mark_non_differentiable(outlier)
        return xc, outlier

    @staticmethod
    def backward(ctx, g_xc, _g_outlier):
        dpts, dtfs = _warp_bwd_cuda(g_xc, *ctx.saved_tensors)
        return dpts, None, None, dtfs, None, None, None


class _JacobianInverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts_c, verts_c, skin_weights, tfs, K, order):
        inv, wb = _jinv_fwd_cuda(pts_c, verts_c, skin_weights, tfs, K, order)
        ctx.save_for_backward(inv, wb)
        return inv

    @staticmethod
    def backward(ctx, g):
        return None, None, None, _jinv_bwd_cuda(g, *ctx.saved_tensors), None, None


# --------------------------------------------------------------------------
# Public wrappers
# --------------------------------------------------------------------------

def knn_blend_weights(pts, verts, skin_weights, K: int = 15, max_dist: float = 0.1, *,
                      order):
    """KNN blend (stop-gradient): pts (B,P,3), verts (B,V,3), skin_weights
    (B,V,J) -> (weights (B,P,J), outlier (B,P)).  ``order``, in every
    wrapper here: the vertices' ``tile_order``, which the kernel searches
    in (the plain version does not read it)."""
    args = [t.detach() for t in (pts, verts, skin_weights)]
    if pts.is_cuda:
        return _blend_cuda(*args, K, max_dist, False, order)
    _cuda.require_cpu(pts)
    return blend_weights_plain(*args, K, max_dist)


def knn_blend_weights_t(pts, verts, skin_weights, K: int = 15, max_dist: float = 0.1, *,
                        order):
    """Points-minor KNN blend (stop-gradient): -> (weights (B,J,P), outlier (B,P))."""
    args = [t.detach() for t in (pts, verts, skin_weights)]
    if pts.is_cuda:
        return _blend_cuda(*args, K, max_dist, True, order)
    _cuda.require_cpu(pts)
    w, outlier = blend_weights_plain(*args, K, max_dist)
    return w.transpose(1, 2).contiguous(), outlier


def knn_inverse_warp(pts, verts, skin_weights, tfs, K: int = 15,
                     max_dist: float = 0.1, *, order):
    """Sampler warp (stop-gradient): pts (B,P,3), verts (B,V,3),
    skin_weights (B,V,J), tfs (B,J,4,4) -> (x_c (B,P,3), outlier (B,P))."""
    args = [t.detach() for t in (pts, verts, skin_weights, tfs)]
    if pts.is_cuda:
        xc, outlier, _, _ = _warp_fwd_cuda(
            *args, K, max_dist, False, "knn_inverse_warp", order
        )
        return xc, outlier
    _cuda.require_cpu(pts)
    check_order_length(order, verts.shape[1])
    with torch.no_grad():
        return inverse_warp_plain(*args, K=K, max_dist=max_dist)


def knn_inverse_warp_diff(pts, verts, skin_weights, tfs, K: int = 15,
                          max_dist: float = 0.1, *, order):
    """Differentiable warp of the grad stage: gradients reach ``pts`` and
    ``tfs``; ``verts`` and ``skin_weights`` are detached by contract."""
    verts, skin_weights = verts.detach(), skin_weights.detach()
    if pts.is_cuda:
        return _InverseWarpDiff.apply(pts, verts, skin_weights, tfs, K, max_dist, order)
    _cuda.require_cpu(pts)
    return inverse_warp_plain(pts, verts, skin_weights, tfs, K, max_dist)


def knn_jacobian_inverse(pts_c, verts_c, skin_weights, tfs, K: int = 15, *, order):
    """(B,P,3),(B,V,3),(B,V,J),(B,J,4,4) -> (B,P,9) row-major J^-1 at
    canonical points; gradient reaches the rotations of ``tfs`` only."""
    pts_c, verts_c = pts_c.detach(), verts_c.detach()
    skin_weights = skin_weights.detach()
    if pts_c.is_cuda:
        return _JacobianInverse.apply(pts_c, verts_c, skin_weights, tfs, K, order)
    _cuda.require_cpu(pts_c)
    return jacobian_inverse_plain(pts_c, verts_c, skin_weights, tfs, K)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
