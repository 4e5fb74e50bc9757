"""hold_tpu_torch.render.ray_sampler against hold_tpu.render.ray_sampler.

Both samplers run on an analytic SDF (two spheres) in float32 on the same
rays, deterministically (JAX with ``rng=None``, the port with ``gen=None``),
in both bisection modes; the pieces with random draws get the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hold_tpu.render import ray_sampler as jrs
from hold_tpu_torch.render import ray_sampler as trs

CFG = dict(N_samples=16, N_samples_eval=32, N_samples_extra=6, beta_iters=6,
           max_total_iters=3, scene_bounding_sphere=3.0)


def _rays(seed, R=24):
    rng = np.random.RandomState(seed)
    cam = np.tile(np.array([[0.0, 0.0, -1.5]], np.float32), (R, 1))
    tgt = (rng.randn(R, 3) * 0.3).astype(np.float32)
    d = tgt - cam
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32), cam


def _sdf(xp, pts):
    a = xp.sqrt(((pts - 0.15) ** 2).sum(-1)) - 0.3
    b = xp.sqrt(((pts + 0.25) ** 2).sum(-1)) - 0.2
    return xp.minimum(a, b)


@pytest.mark.parametrize("conv_check", ["current", "beta0"])
@pytest.mark.parametrize("beta0", [0.1, 0.01])
def test_error_bound_z_vals_match_jax(conv_check, beta0):
    dirs, cam = _rays(0)
    jcfg = jrs.SamplerConfig(conv_check=conv_check, **CFG)
    tcfg = trs.SamplerConfig(conv_check=conv_check, **CFG)
    ref = jax.jit(lambda d, c: jrs.error_bound_z_vals(
        None, lambda p: _sdf(jnp, p), d, c, beta0, jcfg, True))(dirs, cam)
    got = trs.error_bound_z_vals(None, lambda p: _sdf(torch, p), torch.tensor(dirs),
                                 torch.tensor(cam), beta0, tcfg)
    assert got.shape == ref.shape == (24, 16 + 2 + 6)
    err = np.abs(got.numpy() - np.asarray(ref))
    if beta0 >= 0.1:
        # same fp32 algebra; every searchsorted bin and sort agrees
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    else:
        # at beta0 = 0.01 the pdf is so peaked that rounding in the
        # cumulative sums (XLA and PyTorch add in other orders) moves a few
        # samples in the flat tail across a bin: 95% agree to 1e-5, none
        # moves by more than two intervals of the initial grid
        spacing = 4.5 / (CFG["N_samples_eval"] - 1)
        assert np.mean(err <= 1e-5) >= 0.95 and err.max() <= 2 * spacing, err.max()


def test_sample_pdf_and_stratified_draws_match_jax():
    rng = np.random.RandomState(1)
    R, M, N = 10, 20, 15
    bins = np.sort(rng.rand(R, M) * 3, axis=1).astype(np.float32)
    pdf = rng.rand(R, M - 1).astype(np.float32) + 1e-3
    cdf = np.cumsum(pdf / pdf.sum(1, keepdims=True), axis=1).astype(np.float32)
    u = rng.rand(R, N).astype(np.float32)
    np.testing.assert_allclose(
        trs.sample_pdf(torch.tensor(bins), torch.tensor(cdf), torch.tensor(u)).numpy(),
        np.asarray(jax.jit(jrs.sample_pdf)(bins, cdf, u)), rtol=1e-6, atol=1e-6)

    key = jax.random.PRNGKey(2)
    draws = np.asarray(jax.random.uniform(key, (R, 32)))
    ref = jrs.inverse_sphere_z_vals(key, R, 32, True)
    got = trs.inverse_sphere_z_vals(torch.tensor(draws), R, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7)
    np.testing.assert_allclose(trs.inverse_sphere_z_vals(None, R, 32).numpy(),
                               np.asarray(jrs.inverse_sphere_z_vals(None, R, 32, True)),
                               atol=1e-7)

    dirs, cam = _rays(3, R)
    near, far = np.zeros((R, 1), np.float32), np.full((R, 1), 2.5, np.float32)
    np.testing.assert_allclose(
        trs.uniform_z_vals(None, torch.tensor(dirs), torch.tensor(cam), torch.tensor(near),
                           torch.tensor(far), 32).numpy(),
        np.asarray(jrs.uniform_z_vals(None, dirs, cam, near, far, 32, True)), atol=1e-6)
