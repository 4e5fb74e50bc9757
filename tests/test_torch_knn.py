"""hold_tpu_torch.ops.knn against the JAX package's Pallas kernels.

The port's plain versions (what its wrappers run on CPU tensors) are held
against ``hold_tpu.ops.knn`` in interpret mode, forward and gradients, on the
same inputs made with numpy from a seed: at the JAX tests' sizes and once at
MANO's size (V=778, K=15).  The CUDA kernels are held against the plain
versions on the card (marked ``gpu``; skipped without one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from hold_tpu.ops import knn as jknn
from hold_tpu_torch.ops import knn as tknn

# forward: fp32 rounding of the 3x3 adjugate inverse on points whose
# blended transform is well conditioned
FWD_ATOL = 2e-5
# gradients: closed-form VJP (JAX) vs autograd through the same algebra
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4


def _scene(seed, B=2, P=60, V=50, J=16, spread=0.1):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(B, P, 3) * spread).astype(np.float32)
    verts = (rng.randn(B, V, 3) * 0.1).astype(np.float32)
    w = rng.rand(B, V, J).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    tfs = np.zeros((B, J, 4, 4), np.float32)
    tfs[..., :3, :3] = Rotation.from_rotvec(rng.randn(B * J, 3) * 0.3).as_matrix().reshape(B, J, 3, 3)
    tfs[..., :3, 3] = rng.randn(B, J, 3) * 0.1
    tfs[..., 3, 3] = 1.0
    g = rng.randn(B, P, 3).astype(np.float32)
    g9 = rng.randn(B, P, 9).astype(np.float32)
    return pts, verts, w, tfs, g, g9


def _order(verts):
    """The port's tile order of a frame's vertices (B, V, 3) numpy."""
    return tknn.tile_order(torch.tensor(verts[0]))


def _mano_scene(seed, P=512):
    """MANO-sized: the synthetic template's 778 vertices and 16-joint skin
    weights, with sampler-like points spread over a 2-unit box."""
    from hold_tpu.mano.model_data import build_synthetic_mano

    md = build_synthetic_mano(True)
    pts, _, _, tfs, g, g9 = _scene(seed, B=1, P=P, V=8, J=16, spread=0.5)
    rng = np.random.RandomState(seed + 1)
    pts[0, : P // 2] = md.v_template[rng.randint(0, 778, P // 2)] + rng.randn(P // 2, 3) * 0.02
    return pts, md.v_template[None].copy(), md.lbs_weights[None].copy(), tfs, g, g9


CASES = [
    pytest.param(lambda: _scene(4), 7, 0.08, id="jax_test_size"),
    pytest.param(lambda: _scene(9, P=70, V=60), 7, 0.08, id="jax_test_size_b"),
    pytest.param(lambda: _mano_scene(3), 15, 0.1, id="mano_V778_K15_P512"),
]


@pytest.mark.parametrize("make,K,max_dist", CASES)
def test_inverse_warp_matches_pallas(make, K, max_dist):
    pts, verts, w, tfs, _, _ = make()
    xj, oj = jknn.knn_inverse_warp(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(w),
                                   jnp.asarray(tfs), K=K, max_dist=max_dist, interpret=True)
    xt, ot = tknn.knn_inverse_warp(*map(torch.tensor, (pts, verts, w, tfs)), K=K,
                                   max_dist=max_dist, order=_order(verts))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=FWD_ATOL)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


@pytest.mark.parametrize("make,K,max_dist", CASES)
def test_inverse_warp_diff_forward_and_grads_match_pallas(make, K, max_dist):
    pts, verts, w, tfs, g, _ = make()

    def jloss(p, tf):
        x, _ = jknn.knn_inverse_warp_diff(p, jnp.asarray(verts), jnp.asarray(w), tf, K=K,
                                          max_dist=max_dist, interpret=True)
        return jnp.sum(x * g), x

    (_, xj), (gpj, gtj) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pts), jnp.asarray(tfs))
    p_t = torch.tensor(pts, requires_grad=True)
    tf_t = torch.tensor(tfs, requires_grad=True)
    xt, _ = tknn.knn_inverse_warp_diff(p_t, torch.tensor(verts), torch.tensor(w), tf_t, K=K,
                                       max_dist=max_dist, order=_order(verts))
    (xt * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj), atol=FWD_ATOL)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(gpj), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the JAX VJP leaves the bottom row of each 4x4 at zero; so does autograd
    scale = np.abs(np.asarray(gtj)).max()
    np.testing.assert_allclose(tf_t.grad.numpy(), np.asarray(gtj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * max(scale, 1.0))


@pytest.mark.parametrize("make,K,max_dist", CASES)
def test_jacobian_inverse_forward_and_grads_match_pallas(make, K, max_dist):
    pts, verts, w, tfs, _, g9 = make()

    def jloss(tf):
        j = jknn.knn_jacobian_inverse(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(w), tf,
                                      K=K, interpret=True)
        return jnp.sum(j * g9), j

    (_, jj), gtj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(tfs))
    tf_t = torch.tensor(tfs, requires_grad=True)
    p_t = torch.tensor(pts, requires_grad=True)
    jt = tknn.knn_jacobian_inverse(p_t, torch.tensor(verts), torch.tensor(w), tf_t, K=K,
                                   order=_order(verts))
    (jt * torch.tensor(g9)).sum().backward()
    np.testing.assert_allclose(jt.detach().numpy(), np.asarray(jj), atol=5e-5, rtol=1e-5)
    scale = np.abs(np.asarray(gtj)).max()
    np.testing.assert_allclose(tf_t.grad.numpy(), np.asarray(gtj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * max(scale, 1.0))
    assert p_t.grad is None  # query points are detached by contract


@pytest.mark.parametrize("B,P,J", [(2, 1100, 16), (1, 77, 5)], ids=["5_ranges_J16", "J5"])
def test_fixed_order_backward_matches_autograd_of_plain(B, P, J):
    """Rows 2-3's backward in the kernels' summation order (ranges of 256
    points, thread groups over each tile, then the ranges in order;
    warp_bwd_fixed_order / jinv_bwd_fixed_order) against autograd of the
    plain versions, which sum in another order: over five ranges with a
    partial last tile, and at J = 5 (51 thread groups)."""
    pts, verts, w, tfs, g, g9 = _scene(11, B=B, P=P, V=40, J=J, spread=0.1)
    pts, verts, w, tfs, g, g9 = map(torch.tensor, (pts, verts, w, tfs, g, g9))
    wb, _ = tknn.blend_plain(pts, verts, w, 15)
    inv = tknn.inverse_mat3(tknn.skinning_jacobian(wb, tfs)).reshape(B, P, 9).contiguous()
    p_t, t_t = pts.clone().requires_grad_(True), tfs.clone().requires_grad_(True)
    x, _ = tknn.inverse_warp_plain(p_t, verts, w, t_t)
    ref_p, ref_t = torch.autograd.grad(x, (p_t, t_t), g)
    dpts, dtfs = tknn.warp_bwd_fixed_order(g, inv, x.detach(), wb)
    torch.testing.assert_close(dpts, ref_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dtfs, ref_t, atol=1e-4 * float(ref_t.abs().max()), rtol=1e-4)
    assert bool((dtfs[:, :, 3] == 0).all())

    t_t = tfs.clone().requires_grad_(True)
    ref = torch.autograd.grad(tknn.jacobian_inverse_plain(pts, verts, w, t_t), t_t, g9)[0]
    dtfs = tknn.jinv_bwd_fixed_order(g9, inv, wb)
    torch.testing.assert_close(dtfs, ref, atol=1e-4 * float(ref.abs().max()), rtol=1e-4)
    assert bool((dtfs[:, :, 3] == 0).all()) and bool((dtfs[:, :, :, 3] == 0).all())


def test_kth_smallest_counts_distinct_values_like_pallas():
    d2 = np.array([[0.5, 0.1, 0.1, 0.3, 0.3, 0.3, 0.9, 0.2]], np.float32)
    for K in (1, 2, 3, 4, 5, 6):
        got = tknn.kth_smallest(torch.tensor(d2), K, dim=-1)
        ref = jknn.kth_smallest(jnp.asarray(d2), K, axis=-1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_threshold_semantics_differ_from_clamped_top_k_far_from_the_mesh():
    """Far points (K-th vertex beyond 2 units): the Pallas threshold form and
    the jnp fallback's clamped top-k pick different blends; the port follows
    the Pallas form."""
    pts, verts, w, tfs, _, _ = _scene(11, B=1, P=40, V=50)
    pts = pts + np.float32(3.0)
    wj_pallas, _ = jknn.knn_blend_weights_pallas(jnp.asarray(pts), jnp.asarray(verts),
                                                 jnp.asarray(w), K=7, interpret=True)
    wj_topk, _ = jknn.knn_blend_weights_xla(jnp.asarray(pts), jnp.asarray(verts),
                                            jnp.asarray(w), K=7)
    wt, _ = tknn.knn_blend_weights(torch.tensor(pts), torch.tensor(verts), torch.tensor(w), K=7,
                                   order=_order(verts))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj_pallas), atol=1e-6)
    assert np.abs(np.asarray(wj_pallas) - np.asarray(wj_topk)).max() > 1e-3


def test_skinning_and_jacobian_match_jax():
    pts, _, _, tfs, _, _ = _scene(5)
    wp = np.random.RandomState(6).rand(*pts.shape[:2], 16).astype(np.float32)
    wp /= wp.sum(-1, keepdims=True)
    np.testing.assert_allclose(
        tknn.skinning(torch.tensor(pts), torch.tensor(wp), torch.tensor(tfs), inverse=True).numpy(),
        np.asarray(jknn.skinning(jnp.asarray(pts), jnp.asarray(wp), jnp.asarray(tfs), inverse=True)),
        atol=1e-5)
    np.testing.assert_allclose(
        tknn.skinning_jacobian(torch.tensor(wp), torch.tensor(tfs)).numpy(),
        np.asarray(jknn.skinning_jacobian(jnp.asarray(wp), jnp.asarray(tfs))), atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the KNN kernels are CUDA only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain(cuda):
    pts, verts, w, tfs, g, g9 = _mano_scene(7, P=4096)
    args = [torch.tensor(a, device=cuda) for a in (pts, verts, w, tfs)]
    order = tknn.tile_order(args[1][0])
    xk, ok = tknn.knn_inverse_warp(*args, order=order)
    xr, orf = tknn.inverse_warp_plain(*args)
    torch.testing.assert_close(xk, xr, atol=1e-5, rtol=1e-5)
    assert torch.equal(ok, orf)
    p_k = args[0].clone().requires_grad_(True)
    t_k = args[3].clone().requires_grad_(True)
    xk, _ = tknn.knn_inverse_warp_diff(p_k, args[1], args[2], t_k, order=order)
    dk = torch.autograd.grad(xk, (p_k, t_k), torch.tensor(g, device=cuda))
    dr = torch.autograd.grad(tknn.inverse_warp_plain(p_k, args[1], args[2], t_k)[0],
                             (p_k, t_k), torch.tensor(g, device=cuda))
    for a, b in zip(dk, dr):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    t_k = args[3].clone().requires_grad_(True)
    jk = tknn.knn_jacobian_inverse(args[0], args[1], args[2], t_k, order=order)
    jr = tknn.jacobian_inverse_plain(args[0], args[1], args[2], t_k)
    torch.testing.assert_close(jk, jr, atol=1e-5, rtol=1e-5)
    gk = torch.autograd.grad(jk, t_k, torch.tensor(g9, device=cuda))[0]
    gr = torch.autograd.grad(jr, t_k, torch.tensor(g9, device=cuda))[0]
    torch.testing.assert_close(gk, gr, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("duplicated", [False, True], ids=["tiled", "duplicated_block"])
def test_cuda_search_keeps_the_plain_neighbour_sets(cuda, duplicated):
    """The kernels' search in the vertices' tile order: the same neighbour
    sets as the plain version exactly (the blended weights' support), with a
    block of vertices duplicated too, which must send lanes through the tie
    sweep; every kernel that searches."""
    pts, verts, w, tfs, _, _ = _mano_scene(7, P=4096)
    if duplicated:
        verts[:, 300:364] = verts[:, 100:164]
    args = [torch.tensor(a, device=cuda) for a in (pts, verts, w, tfs)]
    order = tknn.tile_order(args[1][0])
    ref_w, ref_dmin = tknn.blend_plain(args[0], args[1], args[2], 15)
    with tknn.count_search(cuda) as counts:
        xk, ok, _, wb = tknn._warp_fwd_cuda(*args, 15, 0.1, True, "knn_inverse_warp_diff.fwd",
                                            order)
        torch.cuda.synchronize()
    assert torch.equal(wb > 0, ref_w > 0)
    torch.testing.assert_close(wb, ref_w, atol=1e-6, rtol=0.0)
    assert torch.equal(ok, tknn._outlier(ref_dmin, 0.1))
    torch.testing.assert_close(xk, tknn.inverse_warp_plain(*args)[0], atol=1e-5, rtol=1e-5)
    if duplicated:
        assert int(counts[1]) > 0
    _, wj = tknn._jinv_fwd_cuda(*args, 15, order)
    assert torch.equal(wj > 0, ref_w > 0)
    for fn in (tknn.knn_blend_weights, tknn.knn_blend_weights_t):
        wk, okb = fn(*args[:3], order=order)
        wk = wk.transpose(1, 2) if fn is tknn.knn_blend_weights_t else wk
        assert torch.equal(wk > 0, ref_w > 0)
        assert torch.equal(okb, ok)


@pytest.mark.gpu
def test_cuda_backward_sums_in_the_fixed_order(cuda):
    """Rows 2-3's backward kernels equal warp_bwd_fixed_order /
    jinv_bwd_fixed_order bit for bit, and the same call after call (a
    partial last range of 77 points)."""
    pts, verts, w, tfs, g, g9 = _mano_scene(7, P=4096 + 77)
    args = [torch.tensor(a, device=cuda) for a in (pts, verts, w, tfs)]
    g, g9 = torch.tensor(g, device=cuda), torch.tensor(g9, device=cuda)
    order = tknn.tile_order(args[1][0])
    xc, _, inv, wb = tknn._warp_fwd_cuda(*args, 15, 0.1, True, "knn_inverse_warp_diff.fwd", order)
    first = tknn._warp_bwd_cuda(g, inv, xc, wb)
    again = tknn._warp_bwd_cuda(g, inv, xc, wb)
    for a, b, c in zip(first, again, tknn.warp_bwd_fixed_order(g, inv, xc, wb)):
        assert torch.equal(a, b) and torch.equal(a, c)
    inv, wb = tknn._jinv_fwd_cuda(*args, 15, order)
    first = tknn._jinv_bwd_cuda(g9, inv, wb)
    assert torch.equal(first, tknn._jinv_bwd_cuda(g9, inv, wb))
    assert torch.equal(first, tknn.jinv_bwd_fixed_order(g9, inv, wb))
