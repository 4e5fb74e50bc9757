"""The error-bound sampler's kernels (``ops/error_bound.py``,
``csrc/error_bound.cu``) against ``render/ray_sampler.py``'s plain steps.

On the CPU: CPU tensors run the plain steps and launch nothing, the
wrappers refuse CPU tensors, and every draw is made as before the kernels
(the generator ends in the state the same draws leave it in).  The plain
steps are held to the JAX package by ``tests/test_torch_sampler*.py`` and
``tests/test_sampler_parity.py``.

On the card (marked ``gpu``; skipped without one): the kernel path of
``error_bound_z_vals`` against its plain path on the same CUDA inputs, at the
render chunk (4,096 and 3,072 rays, no generator) and at 10,240 rays with a
seeded generator, in both bisection modes, with node-bound intervals that
leave some rays empty, and a round on a table with ties.  The final z
tables' 99th percentile of |dz| stays within 1e-3 scene radii; fed the plain
path's own inputs, each round merges bit for bit, and at most 0.5 % of the
rays end their bisection on another beta (a test within rounding of eps,
the sums taken in another order).
"""

import numpy as np
import pytest
import torch

from hold_tpu_torch.ops import error_bound as eb
from hold_tpu_torch.render import ray_sampler as trs

SCENE_R = 3.0
CFG = dict(N_samples=16, N_samples_eval=32, N_samples_extra=6, beta_iters=6, max_total_iters=3,
           scene_bounding_sphere=SCENE_R)
# HOLD's sampler (general.yaml): what every node's call runs on the card
FULL = dict(N_samples=64, N_samples_eval=128, N_samples_extra=32, beta_iters=10,
            max_total_iters=5, scene_bounding_sphere=SCENE_R)


def _rays(seed, R, device="cpu"):
    rng = np.random.RandomState(seed)
    cam = np.tile(np.array([[0.0, 0.0, -1.5]], np.float32), (R, 1))
    cam += (rng.randn(R, 3) * 0.05).astype(np.float32)
    d = (rng.randn(R, 3) * 0.3).astype(np.float32) - cam
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.tensor(d, device=device), torch.tensor(cam, device=device)


def _query(dirs, cam):
    """Two spheres, seen through a z table (R, S) -> sdf (R, S)."""
    def query(z):
        pts = cam[:, None] + z[..., None] * dirs[:, None]
        a = torch.linalg.norm(pts - 0.15, dim=-1) - 0.3
        b = torch.linalg.norm(pts + 0.25, dim=-1) - 0.2
        return torch.minimum(a, b)
    return query


def _spy(monkeypatch, counts: dict):
    """Count the plain steps' calls through ``error_bound_z_vals``."""
    for name in ("error_bound_round_plain", "error_bound_final_plain"):
        real = getattr(trs, name)

        def spied(*a, _real=real, _name=name):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a)
        monkeypatch.setattr(trs, name, spied)


@pytest.mark.parametrize("seeded", [False, True], ids=["grid", "generator"])
@pytest.mark.parametrize("conv_check", ["current", "beta0"])
def test_cpu_tensors_take_the_plain_steps(monkeypatch, seeded, conv_check):
    dirs, cam = _rays(0, 24)
    cfg = trs.SamplerConfig(conv_check=conv_check, **CFG)
    counts = {}
    _spy(monkeypatch, counts)
    eb.reset_launch_counts()
    gen = torch.Generator().manual_seed(3) if seeded else None
    z = trs.error_bound_z_vals(gen, None, dirs, cam, 0.01, cfg, query_z_fn=_query(dirs, cam))
    assert counts == {"error_bound_round_plain": 2, "error_bound_final_plain": 1}
    assert eb.LAUNCHES == {"eb_round": 0, "eb_final": 0}
    assert z.shape == (24, 16 + 2 + 6)
    assert bool(torch.isfinite(z).all()) and bool((torch.diff(z, dim=1) >= 0).all())


def test_wrappers_refuse_cpu_tensors():
    R, S = 4, 8
    z = torch.linspace(0.0, 1.0, S).expand(R, S).contiguous()
    cfg = trs.SamplerConfig(**CFG)
    with pytest.raises(ValueError, match="CUDA"):
        eb.eb_round(z, z.clone(), None, None, torch.ones(R), torch.tensor(0.01),
                    torch.linspace(0.0, 1.0, 4), cfg)
    with pytest.raises(ValueError, match="CUDA"):
        eb.eb_final(z, z.clone(), None, None, torch.ones(R), torch.tensor(0.01),
                    torch.linspace(0.0, 1.0, 4), None, z[:, :1], z[:, 1:2], cfg)
    assert eb.LAUNCHES == {"eb_round": 0, "eb_final": 0}


def test_draws_are_made_in_order_on_the_host():
    """The generator's state after a call is what the stratification draw,
    the final draw and the extras' permutation leave it in, made in that
    order outside the sampler."""
    R = 24
    dirs, cam = _rays(1, R)
    cfg = trs.SamplerConfig(**CFG)
    gen = torch.Generator().manual_seed(11)
    trs.error_bound_z_vals(gen, None, dirs, cam, 0.01, cfg, query_z_fn=_query(dirs, cam))
    ref = torch.Generator().manual_seed(11)
    torch.rand((R, CFG["N_samples_eval"]), generator=ref)
    torch.rand((R, CFG["N_samples"]), generator=ref)
    torch.randperm(CFG["N_samples_eval"] * CFG["max_total_iters"], generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the error-bound kernels are CUDA only")
    return torch.device("cuda")


def _plain_recorded(monkeypatch):
    """Route the steps to the plain versions, and record each round's
    inputs and outputs."""
    calls = []

    def round_(*a):
        out = trs.error_bound_round_plain(*a)
        calls.append((a, out))
        return out
    monkeypatch.setattr(trs, "error_bound_round", round_)
    monkeypatch.setattr(trs, "error_bound_final", trs.error_bound_final_plain)
    return calls


def _both_paths(monkeypatch, dirs, cam, cfg, seed, near=None, far=None):
    """(kernel z, plain z, the plain path's round calls) on one set of
    inputs; a seeded run gives both paths the same draws."""
    query = _query(dirs, cam)
    dev = dirs.device

    def run():
        gen = None if seed is None else torch.Generator(dev).manual_seed(seed)
        return trs.error_bound_z_vals(gen, None, dirs, cam, 0.01, cfg, query_z_fn=query,
                                      near=near, far=far)

    eb.reset_launch_counts()
    got = run()
    assert eb.LAUNCHES == {"eb_round": cfg.max_total_iters - 1, "eb_final": 1}
    with monkeypatch.context() as m:
        calls = _plain_recorded(m)
        ref = run()
    return got, ref, calls


def _hold(got, ref, calls, cfg):
    dz = (got - ref).abs().flatten()
    p99 = float(torch.quantile(dz.double().cpu(), 0.99))
    assert bool(torch.isfinite(got).all()) and bool((torch.diff(got, dim=1) >= 0).all())
    assert p99 <= 1e-3 * SCENE_R, f"p99 |dz| {p99:.3e}"
    flipped = torch.zeros(got.shape[0], dtype=torch.bool, device=got.device)
    for args, (z_ref, sdf_ref, beta_ref, _) in calls:
        z_k, sdf_k, beta_k, samples_k = eb.eb_round(*args)
        assert torch.equal(z_k, z_ref) and torch.equal(sdf_k, sdf_ref), "the merge differs"
        assert bool(torch.isfinite(samples_k).all())
        flipped |= (beta_k - beta_ref).abs() > 1e-5 * beta_ref.abs()
    share = float(flipped.float().mean())
    assert share <= 5e-3, f"{share:.4%} of the rays bisected to another beta"


@pytest.mark.gpu
@pytest.mark.parametrize("conv_check", ["current", "beta0"])
@pytest.mark.parametrize("R,seed", [(4096, None), (3072, None), (10240, 5)],
                         ids=["chunk", "last_chunk", "train_seeded"])
def test_kernel_matches_plain_steps(cuda, monkeypatch, R, seed, conv_check):
    dirs, cam = _rays(R, R, cuda)
    cfg = trs.SamplerConfig(conv_check=conv_check, **FULL)
    _hold(*_both_paths(monkeypatch, dirs, cam, cfg, seed), cfg)


@pytest.mark.gpu
def test_kernel_matches_plain_steps_on_node_bounds(cuda, monkeypatch):
    """Per-ray intervals from a node's sphere; the rays that miss it get
    the empty interval at the scene exit (near == far)."""
    R = 4096
    dirs, cam = _rays(7, R, cuda)
    cfg = trs.SamplerConfig(**FULL)
    center = torch.tensor([[0.15, 0.15, 0.15]], device=cuda).expand(R, 3)
    near, far = trs.node_ray_interval(cam, dirs, center, 0.4, cfg)
    empty = float((near == far).float().mean())
    assert 0.05 < empty < 0.95, f"{empty:.2%} of the rays on the empty interval"
    got, ref, calls = _both_paths(monkeypatch, dirs, cam, cfg, 2, near, far)
    _hold(got, ref, calls, cfg)
    assert torch.equal(got[(near == far)[:, 0]], ref[(near == far)[:, 0]])


@pytest.mark.gpu
def test_round_merges_ties_stably(cuda):
    """A table and new samples on a coarse grid of z values: the merge is
    torch.sort(stable=True)'s (old entries first on a tie) with the sdf
    gathered along, bit for bit, the new samples given out of order too."""
    R, S, Ne = 512, 256, 128
    g = torch.Generator(cuda).manual_seed(0)
    z = torch.sort(torch.round(torch.rand(R, S, generator=g, device=cuda) * 16) / 8, dim=1)[0]
    new = torch.sort(torch.round(torch.rand(R, Ne, generator=g, device=cuda) * 16) / 8,
                     dim=1)[0]
    sdf = torch.rand(R, S, generator=g, device=cuda) - 0.3
    new_sdf = torch.rand(R, Ne, generator=g, device=cuda) - 0.3
    beta = torch.rand(R, generator=g, device=cuda) * 0.3 + 0.05
    beta0 = torch.tensor(0.01, device=cuda)
    grid = torch.linspace(0.0, 1.0, Ne, device=cuda)
    cfg = trs.SamplerConfig(**FULL)
    for order in (torch.arange(Ne, device=cuda), torch.randperm(Ne, device=cuda)):
        got = eb.eb_round(z, sdf, new[:, order], new_sdf, beta, beta0, grid, cfg)
        ref = trs.error_bound_round_plain(z, sdf, new[:, order], new_sdf, beta, beta0, grid, cfg)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        flipped = (got[2] - ref[2]).abs() > 1e-5 * ref[2].abs()
        assert float(flipped.float().mean()) <= 5e-3
