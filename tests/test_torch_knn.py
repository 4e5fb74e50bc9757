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
                                   max_dist=max_dist)
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
                                       max_dist=max_dist)
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
    jt = tknn.knn_jacobian_inverse(p_t, torch.tensor(verts), torch.tensor(w), tf_t, K=K)
    (jt * torch.tensor(g9)).sum().backward()
    np.testing.assert_allclose(jt.detach().numpy(), np.asarray(jj), atol=5e-5, rtol=1e-5)
    scale = np.abs(np.asarray(gtj)).max()
    np.testing.assert_allclose(tf_t.grad.numpy(), np.asarray(gtj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * max(scale, 1.0))
    assert p_t.grad is None  # query points are detached by contract


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
    wt, _ = tknn.knn_blend_weights(torch.tensor(pts), torch.tensor(verts), torch.tensor(w), K=7)
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
    xk, ok = tknn.knn_inverse_warp(*args)
    xr, orf = tknn.inverse_warp_plain(*args)
    torch.testing.assert_close(xk, xr, atol=1e-5, rtol=1e-5)
    assert torch.equal(ok, orf)
    p_k = args[0].clone().requires_grad_(True)
    t_k = args[3].clone().requires_grad_(True)
    xk, _ = tknn.knn_inverse_warp_diff(p_k, args[1], args[2], t_k)
    dk = torch.autograd.grad(xk, (p_k, t_k), torch.tensor(g, device=cuda))
    dr = torch.autograd.grad(tknn.inverse_warp_plain(p_k, args[1], args[2], t_k)[0],
                             (p_k, t_k), torch.tensor(g, device=cuda))
    for a, b in zip(dk, dr):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    t_k = args[3].clone().requires_grad_(True)
    jk = tknn.knn_jacobian_inverse(args[0], args[1], args[2], t_k)
    jr = tknn.jacobian_inverse_plain(args[0], args[1], args[2], t_k)
    torch.testing.assert_close(jk, jr, atol=1e-5, rtol=1e-5)
    gk = torch.autograd.grad(jk, t_k, torch.tensor(g9, device=cuda))[0]
    gr = torch.autograd.grad(jr, t_k, torch.tensor(g9, device=cuda))[0]
    torch.testing.assert_close(gk, gr, atol=1e-4, rtol=1e-4)
