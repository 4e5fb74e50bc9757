"""The vertex searches of the port's CUDA kernels, modelled in plain PyTorch.

``csrc/knn_common.cuh`` finds a point's K nearest vertices in one sweep over
tiles of 32 vertices, culling tiles warp by warp, with a per-lane candidate
queue merged into a sorted (value, slot) list and a tie flag that sends a
lane through a second, exact sweep.  ``csrc/point_mesh.cu`` culls the same
tiles against each point's running minimum.  A CUDA kernel cannot run here,
so this file holds a model of each design, step for step and vectorised over
the points (lanes grouped 32 to a warp), against the plain versions the
wrappers run on CPU tensors (``ops/knn.py::blend_plain``,
``ops/point_mesh.py::min_vertex_dist``): the same neighbour sets and minima
bit for bit, the same blended weights within 1e-6, on seeded inputs built to
break the search: duplicated vertices (ties at the K-th value), a ring seen
from afar (distances equal up to rounding), points far outside the hand, V
not a multiple of the tile and V < K, K = 1 and K = 16, the object's
far-padded buffer and an all-padding one.  A control with the rounding
margin set to 0 must disagree on a case built for it.
"""

import functools

import numpy as np
import pytest
import torch

from hold_tpu_torch.ops import knn, point_mesh

TILE = knn.TILE_V
KMAX, QLEN, QSTEP = 16, 16, 4  # csrc/knn_common.cuh
MARGIN = 2.0 ** -18
BIG = 1e9
PPT, CHUNK = 4, 2048  # csrc/point_mesh.cu


@pytest.fixture(autouse=True)
def _one_thread():
    """The models run thousands of small tensor operations, which threads
    only slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sqdist_raw(v4, q, psq):
    """The kernels' d2 before its clamp: (|v|^2 + |p|^2) - (2p).v, each
    operation rounded on its own; v4 (..., 4) holds |v|^2 last, q = 2p."""
    cross2 = (v4[..., 0] * q[..., 0] + v4[..., 1] * q[..., 1]) + v4[..., 2] * q[..., 2]
    return (v4[..., 3] + psq) - cross2


def _stage(verts, order):
    """The staged set: (V, 4) vertices in tile order with |v|^2, each tile's
    box lo, hi (nt, 3) and max |v|^2 (nt,); the last tile's empty lanes
    repeat its last vertex, as the kernel's box reduction does."""
    v = verts[order]
    staged = torch.cat([v, knn.sqnorm3(v)[:, None]], dim=1)
    nt = -(-len(order) // TILE)
    pad = staged[torch.clamp(torch.arange(nt * TILE), max=len(order) - 1)].view(nt, TILE, 4)
    return staged, pad[..., :3].amin(1), pad[..., :3].amax(1), pad[..., 3].amax(1)


def _box_sqgap(lo, hi, p):
    g = torch.clamp(torch.maximum(lo - p, p - hi), min=0.0)
    return g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]


def _tile_far(lo, hi, vmax, p, psq, thr, margin):
    """knn_common.cuh tile_far."""
    return _box_sqgap(lo, hi, p) > thr + margin * ((vmax + psq) + thr)


def _lanes(pts, per_warp):
    """Points padded to whole warps with copies of the last one, as the
    kernels clamp a lane's index."""
    n = -(-pts.shape[0] // per_warp) * per_warp
    return pts[torch.clamp(torch.arange(n), max=pts.shape[0] - 1)]


def search_model(pts, verts, w, K, order=None, margin=MARGIN):
    """Design A (knn_common.cuh knn_blend) for one frame: pts (P, 3), verts
    (V, 3), w (V, J) -> (wb (P, J), dmin (P,), support (P, V) bool, counts:
    lanes that took the tie sweep, tiles visited, tiles culled).  The queue
    keeps each candidate's slot and its d2 (here evaluated again: the same
    rounded operations give the same bits)."""
    P, V = pts.shape[0], verts.shape[0]
    order = torch.arange(V) if order is None else order.long()
    staged, lo, hi, vmax = _stage(verts, order)
    nt = lo.shape[0]
    p = _lanes(pts, 32).view(-1, 32, 3)
    W = p.shape[0]
    psq, q = knn.sqnorm3(p), 2.0 * p
    rows = torch.arange(W)[:, None].expand(W, 32)
    lanes = torch.arange(32)[None].expand(W, 32)

    # visiting order: nearest tile first to the centre of the warp's box
    c = 0.5 * (p.amin(1) + p.amax(1))
    key = _box_sqgap(lo[None], hi[None], c[:, None])
    if nt <= 32:
        visit = torch.sort(key, dim=1, stable=True).indices
    else:
        first = key.argmin(1)
        rest = torch.arange(nt)[None].expand(W, nt)
        rest = rest[rest != first[:, None]].view(W, nt - 1)
        visit = torch.cat([first[:, None], rest], dim=1)

    top = torch.full((W, 32, KMAX), BIG)
    slot = torch.zeros((W, 32, KMAX), dtype=torch.long)
    tie = torch.zeros((W, 32), dtype=torch.bool)
    thr = torch.full((W, 32), BIG)
    cnt = torch.zeros((W, 32), dtype=torch.long)
    queue = torch.zeros((W, 32, QLEN + 1), dtype=torch.long)  # the last slot takes no push
    k_idx = torch.arange(KMAX)

    def insert(x, s, valid):
        nonlocal top, slot, tie
        dup = (top == x[..., None]).any(-1) & valid
        tie = tie | dup
        x = torch.where(dup | ~valid, torch.full_like(x, float("inf")), x)
        pos = (top < x[..., None]).sum(-1, keepdim=True)
        src = torch.where(k_idx > pos, k_idx - 1, k_idx)
        top = torch.where(k_idx == pos, x[..., None], top.gather(-1, src))
        slot = torch.where(k_idx == pos, s[..., None], slot.gather(-1, src))

    def merge(warps):
        nonlocal cnt, thr
        for e in range(QLEN):
            valid = warps[:, None] & (e < cnt)
            if not bool(valid.any()):
                break
            s = queue[..., e]
            insert(torch.clamp(_sqdist_raw(staged[s], q, psq), min=0.0), s, valid)
        cnt = torch.where(warps[:, None], torch.zeros_like(cnt), cnt)
        thr = torch.where(warps[:, None], top[..., K - 1], thr)

    # each lane's own nearest tile straight into its list, every vertex a
    # candidate
    mine = _box_sqgap(lo, hi, p[..., None, :]).argmin(-1)
    s0, n = TILE * mine, torch.clamp(V - TILE * mine, max=TILE)
    for j in range(TILE):
        s = s0 + torch.clamp(n - 1, max=j)
        insert(torch.clamp(_sqdist_raw(staged[s], q, psq), min=0.0), s, j < n)
    thr = top[..., K - 1]
    visited = torch.zeros(W, dtype=torch.long)
    for i in range(nt):
        t = visit[:, i]
        go = ~(_tile_far(lo[t][:, None], hi[t][:, None], vmax[t][:, None], p, psq, thr, margin)
               | (t[:, None] == mine)).all(1)
        visited += go.long()
        if not bool(go.any()):
            continue
        s0, n = TILE * t, torch.clamp(V - TILE * t, max=TILE)
        for c0 in range(0, TILE, QSTEP):
            need = go & (cnt > QLEN - QSTEP).any(1)
            if bool(need.any()):
                merge(need)
            # QSTEP vertices against one threshold: the pushes in order
            j = c0 + torch.arange(QSTEP)
            live = go[:, None] & (j[None] < n[:, None])
            s = torch.clamp(s0[:, None] + j[None], max=V - 1)
            d2 = torch.clamp(_sqdist_raw(staged[s][:, None], q[:, :, None], psq[..., None]),
                             min=0.0)
            push = live[:, None] & (t[:, None, None] != mine[..., None]) & (d2 <= thr[..., None])
            at = cnt[..., None] + torch.cumsum(push, -1) - push.long()
            queue.scatter_(-1, torch.where(push, at, QLEN), s[:, None].expand(W, 32, QSTEP))
            cnt = cnt + push.sum(-1)
    merge(torch.ones(W, dtype=torch.bool))
    tie = tie | ~(thr < BIG)

    # the blend: the list's K vertices, or the tie sweep over the tiles
    d2_all = torch.clamp(_sqdist_raw(staged[None, None], q[:, :, None], psq[..., None]), min=0.0)
    in_set = torch.zeros((W, 32, V), dtype=torch.bool)
    in_set[rows[..., None].expand(W, 32, K), lanes[..., None].expand(W, 32, K),
           slot[..., :K]] = True
    in_set &= ~tie[..., None]
    swept = torch.zeros((W, V), dtype=torch.bool)
    for t in range(nt):
        far = (~tie | _tile_far(lo[t], hi[t], vmax[t], p, psq, thr, margin)).all(1)
        swept[~far, TILE * t:TILE * (t + 1)] = True
    in_set |= tie[..., None] & swept[:, None] & (d2_all <= thr[..., None])
    conf = torch.where(in_set, torch.exp(-torch.clamp(d2_all, max=4.0)), torch.zeros(()))
    wb = (conf @ w[order]) * (1.0 / conf.sum(-1, keepdim=True))
    support = torch.zeros_like(in_set)
    support[..., order] = in_set
    counts = {"tie lanes": int(tie.reshape(-1)[:P].sum()), "visited": int(visited.sum()),
              "culled": int(W * nt - visited.sum())}
    return (wb.reshape(-1, w.shape[1])[:P], top[..., 0].reshape(-1)[:P],
            support.reshape(-1, V)[:P], counts)


def min_dist_model(pts, verts, order=None, margin=MARGIN):
    """Design B (point_mesh.cu min_vertex_dist_kernel): pts (P, 3), verts
    (V, 3) -> (min distance (P,), counts: tiles visited, tiles culled)."""
    P, V = pts.shape[0], verts.shape[0]
    order = torch.arange(V) if order is None else order.long()
    # warp w's points: 128 w + lane + 32 i, i < PPT -> p[w, i, lane]
    p = _lanes(pts, 32 * PPT).view(-1, PPT, 32, 3)
    W = p.shape[0]
    psq, q = knn.sqnorm3(p), 2.0 * p
    dmin = torch.full((W, PPT, 32), float("inf"))
    wlo, whi = p.amin((1, 2)), p.amax((1, 2))
    c, psq_max = 0.5 * (wlo + whi), psq.amax((1, 2))
    visited = torch.zeros(W, dtype=torch.long)
    culled = torch.zeros(W, dtype=torch.long)
    for c0 in range(0, V, CHUNK):
        n = min(CHUNK, V - c0)
        staged, lo, hi, vmax = _stage(verts, order[c0:c0 + n])
        nt = lo.shape[0]
        first = _box_sqgap(lo[None], hi[None], c[:, None]).argmin(1)

        def visit(t, warps):
            nonlocal dmin, visited, culled
            far = _tile_far(lo[t][:, None, None], hi[t][:, None, None],
                            vmax[t][:, None, None], p, psq, torch.clamp(dmin, min=0.0),
                            margin).all(1).all(1)
            go = warps & ~far
            culled += (warps & far).long()
            visited += go.long()
            one = (lo[t] == hi[t]).all(-1)
            nv = torch.where(one, torch.ones_like(t), torch.clamp(n - TILE * t, max=TILE))
            j = torch.arange(TILE)
            live = go[:, None] & (j[None] < nv[:, None])
            v4 = staged[torch.clamp(TILE * t[:, None] + j[None], max=n - 1)][:, None, None]
            d = _sqdist_raw(v4, q[..., None, :], psq[..., None])
            d = torch.where(live[:, None, None], d, torch.full_like(d, float("inf")))
            dmin = torch.minimum(dmin, d.amin(-1))

        visit(first, torch.ones(W, dtype=torch.bool))
        for g in range(0, nt, TILE):
            thr = torch.clamp(dmin, min=0.0).amax((1, 2))[:, None]
            t = torch.arange(g, min(g + TILE, nt))
            gap = torch.clamp(torch.maximum(lo[t][None] - whi[:, None],
                                            wlo[:, None] - hi[t][None]), min=0.0)
            L = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] + gap[..., 2] * gap[..., 2]
            near = ~(L > thr + margin * ((vmax[t][None] + psq_max[:, None]) + thr))
            near &= t[None] != first[:, None]
            culled += (t[None] != first[:, None]).sum(1) - near.sum(1)
            for j in range(len(t)):
                if bool(near[:, j].any()):
                    visit(t[j].expand(W), near[:, j])
    out = torch.sqrt(torch.clamp(dmin, min=0.0)).reshape(-1)[:P]
    return out, {"visited": int(visited.sum()), "culled": int(culled.sum())}


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _mano():
    from hold_tpu_torch.mano.model_data import load_mano

    md = load_mano(True)
    return (torch.as_tensor(md.v_template, dtype=torch.float32),
            torch.as_tensor(md.lbs_weights, dtype=torch.float32))


def _rays(rng, n_rays, n_samples, centre, spread, length):
    """Consecutive samples of rays through a region, as the sampler and the
    grad stage hand points to the kernels."""
    o = centre + rng.randn(n_rays, 3) * spread - length / 2 * np.array([0.0, 0.0, 1.0])
    d = np.array([0.0, 0.0, 1.0]) + rng.randn(n_rays, 3) * 0.2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.rand(n_rays, n_samples), axis=1) * length
    return torch.as_tensor((o[:, None] + z[..., None] * d[:, None]).reshape(-1, 3),
                           dtype=torch.float32)


def _weights(rng, V, J=16):
    w = rng.rand(V, J) * (rng.rand(V, J) < 0.3)
    w[np.arange(V), rng.randint(0, J, V)] += 0.5
    return torch.as_tensor(w / w.sum(1, keepdims=True), dtype=torch.float32)


def case_mano(rng):
    v, w = _mano()
    pts = torch.cat([_rays(rng, 6, 64, np.array([0.0, 0.09, 0.0]), 0.04, 0.4),
                     v[rng.randint(0, 778, 128)] + torch.as_tensor(rng.randn(128, 3) * 0.01,
                                                                    dtype=torch.float32)])
    return pts, v, w


def case_duplicates(rng):
    pts, v, w = case_mano(rng)
    v = v.clone()
    v[300:364] = v[100:164]  # a block duplicated: ties at and under the K-th value
    return pts, v, w


def case_ring(rng):
    ang = np.arange(96) * 2 * np.pi / 96
    v = np.stack([0.05 * np.cos(ang), 0.05 * np.sin(ang), np.zeros(96)], 1)
    v = np.concatenate([v, rng.randn(40, 3) * 0.05 + [0.0, 0.0, 0.3]])
    # points on the ring's axis, far away: the ring's distances equal up to
    # rounding
    pts = np.stack([rng.randn(96) * 1e-4, rng.randn(96) * 1e-4, -2.0 - rng.rand(96)], 1)
    return (torch.as_tensor(pts, dtype=torch.float32), torch.as_tensor(v, dtype=torch.float32),
            _weights(rng, len(v)))


def case_outliers(rng):
    _, v, w = case_mano(rng)
    pts = _rays(rng, 4, 64, np.array([2.0, -1.5, 1.0]), 0.5, 2.0)
    return pts, v, w


def case_small(rng, V):
    v = torch.as_tensor(rng.randn(V, 3) * 0.1, dtype=torch.float32)
    pts = _rays(rng, 4, 40, np.zeros(3), 0.1, 0.6)
    return pts, v, _weights(rng, V)


# (inputs, K, whether lanes must take the tie sweep)
KNN_CASES = [
    pytest.param(case_mano, 15, False, id="mano_K15"),
    pytest.param(case_mano, 1, False, id="mano_K1"),
    pytest.param(case_mano, 16, False, id="mano_K16"),
    pytest.param(case_duplicates, 15, True, id="duplicated_block"),
    pytest.param(case_ring, 15, None, id="ring_from_afar"),
    pytest.param(case_outliers, 15, None, id="outliers"),
    pytest.param(lambda rng: case_small(rng, 77), 15, None, id="V77"),
    pytest.param(lambda rng: case_small(rng, 9), 15, True, id="V9_under_K"),
    pytest.param(lambda rng: case_small(rng, 1100), 15, None, id="V1100_over_32_tiles"),
]


@pytest.mark.parametrize("make,K,ties", KNN_CASES)
def test_search_model_matches_plain_blend(make, K, ties):
    pts, v, w = make(np.random.RandomState(K))
    wb, dmin, support, counts = search_model(pts, v, w, K, knn.tile_order(v))
    d2 = knn._pairwise_sqdist(pts[None], v[None])[0]
    ref_support = d2 <= knn.kth_smallest(d2, K, dim=-1)
    ref_w, ref_dmin = knn.blend_plain(pts[None], v[None], w[None], K)
    assert torch.equal(support, ref_support)
    assert torch.equal(wb > 0, ref_w[0] > 0)
    assert torch.equal(dmin, ref_dmin[0])
    torch.testing.assert_close(wb, ref_w[0], atol=1e-6, rtol=0.0)
    if ties is not None:
        assert (counts["tie lanes"] > 0) == ties


def test_search_model_culls_and_ties_where_expected():
    """On ray samples near the hand most tiles go unvisited, and a
    duplicated block sends the lanes whose sets reach it through the tie
    sweep, while the plain hand sends none."""
    rng = np.random.RandomState(0)
    _, _, _, plain = search_model(*case_mano(rng), 15, knn.tile_order(_mano()[0]))
    assert plain["culled"] > plain["visited"]
    assert plain["tie lanes"] == 0
    pts, v, w = case_duplicates(np.random.RandomState(0))
    _, _, _, dup = search_model(pts, v, w, 15, knn.tile_order(v))
    assert dup["tie lanes"] > 0


def _object_buffer(rng, real):
    v = torch.full((8192, 3), 1e4)
    if real:
        mano, _ = _mano()
        v[:778] = mano * 2.0
    return v


MIN_CASES = [
    pytest.param(lambda rng: (_rays(rng, 5, 98, np.array([0.0, 0.1, 0.0]), 0.05, 0.5),
                              _mano()[0], True), id="hand_tiled"),
    pytest.param(lambda rng: (_rays(rng, 5, 98, np.array([0.0, 0.2, 0.0]), 0.05, 0.5),
                              _object_buffer(rng, True), False), id="object_778_real"),
    pytest.param(lambda rng: (_rays(rng, 3, 98, np.zeros(3), 0.05, 0.5),
                              _object_buffer(rng, False), False), id="object_all_padding"),
    pytest.param(lambda rng: (_rays(rng, 3, 50, np.zeros(3), 0.2, 1.0),
                              torch.as_tensor(rng.randn(2500, 3) * 0.2, dtype=torch.float32),
                              True), id="cloud_V2500"),
    pytest.param(lambda rng: (_rays(rng, 2, 37, np.array([3.0, 0.0, 0.0]), 0.1, 1.0),
                              torch.as_tensor(rng.randn(45, 3) * 0.1, dtype=torch.float32),
                              False), id="far_points_V45"),
]


@pytest.mark.parametrize("make", MIN_CASES)
def test_min_dist_model_matches_plain(make):
    pts, v, tiled = make(np.random.RandomState(3))
    got, counts = min_dist_model(pts, v, knn.tile_order(v) if tiled else None)
    assert torch.equal(got, point_mesh.min_vertex_dist(pts, v))
    if v.shape[0] == 8192:  # the padding tiles go once the real ones set the minima
        assert counts["culled"] > 0 if bool((v < 1e4).any()) else counts["culled"] == 0


def _margin_case(seed=656):
    """One point p (coordinates 1-8) and two tiles: A, an arc of vertices at
    distance h from p whose box lies nearer than h (visited first), and B, a
    grid on the plane h above p with a vertex b at p's foot: p lies on the
    normal of B's box face, b on that face, so B's box bound is h^2 itself.
    Under the seed, rounding computes b's d2 strictly under every one of A's
    (true distances equal), and A's smallest under the computed h^2: without
    the margin, B's box bound exceeds the K-th value (K = 1) and the running
    minimum, B is culled, and b is lost."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(1.0, 8.0, 3).astype(np.float32)
    h = np.float32(rng.uniform(0.02, 0.1))
    th = np.linspace(0.0, 1.2, TILE)
    a = np.stack([p[0] + h * np.cos(th), p[1] + h * np.sin(th), np.full(TILE, p[2])], 1)
    g = np.stack(np.meshgrid(np.arange(8), np.arange(4)), -1).reshape(-1, 2) * 0.02
    b = np.stack([p[0] + g[:, 0], p[1] + g[:, 1], np.full(TILE, p[2] + h)], 1)
    return (torch.as_tensor(p[None], dtype=torch.float32),
            torch.as_tensor(np.concatenate([a, b]), dtype=torch.float32),
            torch.full((2 * TILE, 16), 1.0 / 16))


def test_margin_zero_control_disagrees():
    """The rounding margin is needed: with it both models agree with the
    plain versions on the case built for it; without it, both lose the
    vertex that rounding puts under the box bound."""
    pts, v, w = _margin_case()
    order = torch.arange(2 * TILE, dtype=torch.int32)  # tile A, then tile B
    d2 = knn._pairwise_sqdist(pts[None], v[None])[0]
    assert float(d2[0, TILE]) < float(d2[0, :TILE].min())  # b wins by rounding alone
    ref_support = d2 <= knn.kth_smallest(d2, 1, dim=-1)
    assert torch.equal(search_model(pts, v, w, 1, order)[2], ref_support)
    assert not torch.equal(search_model(pts, v, w, 1, order, margin=0.0)[2], ref_support)
    ref = point_mesh.min_vertex_dist(pts, v)
    assert torch.equal(min_dist_model(pts, v, order)[0], ref)
    assert not torch.equal(min_dist_model(pts, v, order, margin=0.0)[0], ref)


def test_tile_order_is_a_permutation_of_compact_tiles():
    v, _ = _mano()
    order = knn.tile_order(v)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(778, dtype=torch.int32))

    def mean_extent(o):
        _, lo, hi, _ = _stage(v, o.long())
        return float((hi - lo).norm(dim=1).mean())

    shuffled = torch.as_tensor(np.random.RandomState(0).permutation(778))
    assert mean_extent(order) < min(mean_extent(torch.arange(778)),
                                    0.5 * mean_extent(shuffled))


def test_search_vmax_fits_the_shared_memory():
    V = knn.search_vmax()
    need = lambda n: knn.QUEUE_BYTES + 16 * (n + 2 * -(-n // TILE))  # noqa: E731
    assert need(V) <= 232_448 - 1024 < need(V + 1)
