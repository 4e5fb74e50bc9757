"""Ray samplers: stratified uniform + VolSDF error-bound upsampling
(counterpart of hold_tpu/render/ray_sampler.py).

The refinement loop runs ``max_total_iters`` rounds for every ray (per-ray
convergence collapses beta to beta0; no global early exit), exactly as the
JAX package does.  Random draws come from a ``torch.Generator``; with
``gen=None`` every draw is replaced by the deterministic grid, which is what
the JAX functions do with ``rng=None``.  A ``parallel.sharding.RankDraws``
in its place makes each per-ray draw for the rays of every rank and keeps
this rank's, so that a ray's samples are those it gets in one process.
Every draw is made here; between the queries, the rounds' math runs on
CUDA tensors as ``csrc/error_bound.cu``'s kernels (``ops/error_bound.py``)
and on the CPU as the plain steps, ``error_bound_round_plain`` and
``error_bound_final_plain``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..ops import error_bound
from ..parallel.sharding import generator_of, ray_rand
from .volsdf import get_sphere_intersections


class SamplerConfig(NamedTuple):
    near: float = 0.0
    N_samples: int = 64
    N_samples_eval: int = 128
    N_samples_extra: int = 32
    eps: float = 0.1
    beta_iters: int = 10
    max_total_iters: int = 5
    add_tiny: float = 1e-6
    scene_bounding_sphere: float = 3.0
    inverse_sphere_bg: bool = True
    N_samples_inverse_sphere: int = 32
    # "current" (training default): bisection convergence tested at the
    # ray's current beta; "beta0": at beta0 (reference parity)
    conv_check: str = "current"


def _exp64(x: torch.Tensor) -> torch.Tensor:
    """exp(x) computed in float64 and rounded back to x's dtype.  The error
    bound's and the transmittance's exponentials go through it: in float32
    the card's and the CPU's last bits differ, which flips the bisection's
    ``<= eps`` tests and, through the inverse-CDF search, moves whole
    samples; rounded from float64 both devices agree."""
    return torch.exp(x.double()).to(x.dtype)


def _stratify(z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], dim=-1)
    lower = torch.cat([z[:, :1], mids], dim=-1)
    return lower + (upper - lower) * u


def uniform_z_vals(gen, ray_dirs, cam_loc, near, far, N: int):
    """Stratified (with a generator) or even samples in [near, far];
    near/far are (R, 1) tensors.  (R, N)."""
    R = ray_dirs.shape[0]
    t = torch.linspace(0.0, 1.0, N, device=ray_dirs.device)
    near = near.reshape(-1, 1).expand(R, 1)
    far = far.reshape(-1, 1).expand(R, 1)
    z = near * (1.0 - t)[None] + far * t[None]
    if gen is not None:
        z = _stratify(z, ray_rand(gen, z.shape, z.device))
    return z


def _laplace_density_beta(sdf, beta):
    return (1.0 / beta) * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) / beta))


def _error_bound(beta, sdf, dists, d_star):
    """Per-ray max opacity error bound.  beta (R,1); sdf (R,S); dists and
    d_star (R,S-1)."""
    density = _laplace_density_beta(sdf, beta)
    err_per_sec = _exp64(-d_star / beta) * (dists ** 2) / (4.0 * beta ** 2)
    shifted = torch.cat([torch.zeros_like(dists[:, :1]), dists * density[:, :-1]], dim=-1)
    integral = torch.cumsum(shifted, dim=-1)
    err_int = torch.cumsum(err_per_sec, dim=-1)
    bound = (torch.clamp(_exp64(err_int), max=1e6) - 1.0) * _exp64(-integral[:, :-1])
    return torch.amax(bound, dim=-1)


def _d_star(z_vals, sdf):
    """Lower bound on distance-to-surface inside each interval."""
    a = z_vals[:, 1:] - z_vals[:, :-1]
    b, c = torch.abs(sdf[:, :-1]), torch.abs(sdf[:, 1:])
    first = a ** 2 + b ** 2 <= c ** 2
    second = a ** 2 + c ** 2 <= b ** 2
    s = (a + b + c) / 2.0
    area = torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0)
    h = 2.0 * torch.sqrt(area) / torch.clamp(a, min=1e-12)
    mid = ~first & ~second & (b + c - a > 0)
    zero = torch.zeros_like(a)
    d = torch.where(first, b, torch.where(second, c, torch.where(mid, h, zero)))
    same_side = torch.sign(sdf[:, 1:]) * torch.sign(sdf[:, :-1]) == 1.0
    return torch.where(same_side, d, zero)


def sample_pdf(bins, cdf, u):
    """Inverse-transform sampling.  bins (R,M), cdf (R,M-1) without the
    leading zero, u (R,N) -> (R,N); the bin index is
    searchsorted(cdf0, u, side='right') clamped to M-1."""
    cdf0 = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    W = cdf0.shape[-1]
    above = torch.clamp(torch.searchsorted(cdf0, u.contiguous(), right=True), max=W - 1)
    below = torch.clamp(above - 1, min=0)
    bins_c = bins[:, :W]
    cdf_g1 = torch.gather(cdf0, 1, above)
    cdf_g0 = torch.gather(cdf0, 1, below)
    bins_g1 = torch.gather(bins_c, 1, above)
    bins_g0 = torch.gather(bins_c, 1, below)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)


def _bisect(beta, beta0, sdf, dists, d_star, cfg: SamplerConfig):
    R = sdf.shape[0]
    conv_beta = beta0.expand(R, 1) if cfg.conv_check == "beta0" else beta[:, None]
    conv_err = _error_bound(conv_beta, sdf, dists, d_star)
    beta = torch.where(conv_err <= cfg.eps, beta0, beta)
    beta_min, beta_max = beta0.expand(R).clone(), beta
    for _ in range(cfg.beta_iters):
        beta_mid = 0.5 * (beta_min + beta_max)
        ok = _error_bound(beta_mid[:, None], sdf, dists, d_star) <= cfg.eps
        beta_min = torch.where(ok, beta_min, beta_mid)
        beta_max = torch.where(ok, beta_mid, beta_max)
    return beta_max


def _transmittance_and_free(z_vals, sdf, beta):
    R, dev = z_vals.shape[0], z_vals.device
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists_inf = torch.cat([dists, torch.full((R, 1), 1e10, device=dev)], dim=-1)
    free_energy = dists_inf * _laplace_density_beta(sdf, beta[:, None])
    shifted = torch.cat([torch.zeros((R, 1), device=dev), free_energy[:, :-1]], dim=-1)
    return _exp64(-torch.cumsum(shifted, dim=-1)), free_energy, dists_inf


def _merge_and_bisect(z_vals, sdf, new, new_sdf, beta, beta0, cfg: SamplerConfig):
    """What a round and the last step begin with: the previous round's
    samples ``new`` (R, Ne) and their sdf merged into the sorted table
    (stably: an old entry first on a tie; None: nothing to merge), d_star,
    and beta bisected on the table.  -> (z_vals, sdf, d_star, beta)."""
    if new is not None:
        z_vals, order = torch.sort(torch.cat([z_vals, new], dim=-1), dim=-1, stable=True)
        sdf = torch.gather(torch.cat([sdf, new_sdf], dim=-1), 1, order)
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    d_star = _d_star(z_vals, sdf)
    return z_vals, sdf, d_star, _bisect(beta, beta0, sdf, dists, d_star, cfg)


def error_bound_round_plain(z_vals, sdf, new, new_sdf, beta, beta0, u, cfg: SamplerConfig):
    """One refinement round: the previous round's samples ``new`` (R, Ne)
    and their sdf merged into the sorted table (None: none), beta bisected
    on it, and the next samples drawn from the bounded opacity at the grid
    ``u`` (Ne,).  -> (table z, table sdf, beta (R,), samples (R, Ne))."""
    z_vals, sdf, d_star, beta = _merge_and_bisect(z_vals, sdf, new, new_sdf, beta, beta0, cfg)
    transmittance, _, dists_inf = _transmittance_and_free(z_vals, sdf, beta)
    err_per_sec = (
        _exp64(-d_star / beta[:, None]) * (dists_inf[:, :-1] ** 2)
        / (4.0 * beta[:, None] ** 2)
    )
    err_int = torch.cumsum(err_per_sec, dim=-1)
    bound_opacity = (torch.clamp(_exp64(err_int), max=1e6) - 1.0) * transmittance[:, :-1]
    pdf = bound_opacity + cfg.add_tiny
    pdf = pdf / torch.clamp(torch.sum(pdf, dim=-1, keepdim=True), min=1e-30)
    cdf = torch.cumsum(pdf, dim=-1)
    return z_vals, sdf, beta, sample_pdf(z_vals, cdf, u[None].expand(z_vals.shape[0], -1))


def error_bound_final_plain(z_vals, sdf, new, new_sdf, beta, beta0, u, idx, near, far,
                            cfg: SamplerConfig):
    """The last step: the merge and the bisection of a round, then the final
    samples drawn from the weights at ``u`` ((R, N) draws or the (N,) grid)
    with near, far ((R, 1)) and the table's entries at ``idx`` (None: no
    extras), sorted.  (R, N + 2 + N_samples_extra)."""
    z_vals, sdf, _, beta = _merge_and_bisect(z_vals, sdf, new, new_sdf, beta, beta0, cfg)
    transmittance, free_energy, _ = _transmittance_and_free(z_vals, sdf, beta)
    weights = (1.0 - _exp64(-free_energy)) * transmittance

    pdf = weights[:, :-1] + 1e-5
    pdf = pdf / torch.sum(pdf, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    R = z_vals.shape[0]
    z_samples = sample_pdf(z_vals, cdf, u.expand(R, -1))
    if idx is not None:
        z_extra = torch.cat([near, far, z_vals[:, idx]], dim=-1)
    else:
        z_extra = torch.cat([near, far], dim=-1)
    return torch.sort(torch.cat([z_samples, z_extra], dim=-1), dim=-1)[0]


def error_bound_round(z_vals, sdf, new, new_sdf, beta, beta0, u, cfg: SamplerConfig):
    """``error_bound_round_plain``: on CUDA tensors one launch of
    ``csrc/error_bound.cu``'s round kernel, on the CPU the plain steps."""
    if z_vals.is_cuda:
        return error_bound.eb_round(z_vals, sdf, new, new_sdf, beta, beta0, u, cfg)
    return error_bound_round_plain(z_vals, sdf, new, new_sdf, beta, beta0, u, cfg)


def error_bound_final(z_vals, sdf, new, new_sdf, beta, beta0, u, idx, near, far,
                      cfg: SamplerConfig):
    """``error_bound_final_plain``: on CUDA tensors one launch of the final
    kernel, on the CPU the plain steps."""
    if z_vals.is_cuda:
        return error_bound.eb_final(z_vals, sdf, new, new_sdf, beta, beta0, u, idx, near, far,
                                    cfg)
    return error_bound_final_plain(z_vals, sdf, new, new_sdf, beta, beta0, u, idx, near, far,
                                   cfg)


@torch.no_grad()
def error_bound_z_vals(
    gen: torch.Generator | None,
    sdf_fn: Callable[[torch.Tensor], torch.Tensor] | None,  # (R,S,3) -> (R,S)
    ray_dirs: torch.Tensor,
    cam_loc: torch.Tensor,
    beta0,
    cfg: SamplerConfig,
    query_z_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,  # (R,S) -> (R,S)
    near: torch.Tensor | None = None,  # (R, 1) per-ray near override
    far: torch.Tensor | None = None,  # (R, 1) per-ray far override
) -> torch.Tensor:
    """Final z values per ray: (R, N_samples + 2 + N_samples_extra).

    With ``query_z_fn`` every round's query gets the (R, S) z table itself
    (the fused sampler kernels expand ``cam + z*dir`` inside), and the
    (R, S, 3) point tensor is never built; ``sdf_fn`` is then unused.
    ``near`` / ``far`` replace the scene's interval ray by ray
    (``node_ray_interval``); by default every ray spans ``cfg.near`` to its
    exit from the scene sphere.  Between the queries, each round and the
    last step are ``error_bound_round`` and ``error_bound_final``; every
    draw is made here, in the same order on every device."""
    R = ray_dirs.shape[0]
    dev = ray_dirs.device
    if far is None:
        far = _scene_far(cam_loc, ray_dirs, cfg)
    if near is None:
        near = torch.full((R, 1), cfg.near, device=dev)
    near = near.reshape(-1, 1).expand(R, 1)

    z0 = uniform_z_vals(gen, ray_dirs, cam_loc, near, far, cfg.N_samples_eval)

    def query(z):
        if query_z_fn is not None:
            return query_z_fn(z)
        pts = cam_loc[:, None, :] + z[:, :, None] * ray_dirs[:, None, :]
        return sdf_fn(pts)

    z_vals = z0
    sdf = query(z0)

    dists0 = z0[:, 1:] - z0[:, :-1]
    bound = (1.0 / (4.0 * math.log(cfg.eps + 1.0))) * torch.sum(dists0 ** 2, dim=-1)
    beta = torch.sqrt(bound)
    beta0 = torch.as_tensor(beta0, dtype=torch.float32, device=dev).reshape(())

    grid = torch.linspace(0.0, 1.0, cfg.N_samples_eval, device=dev)
    new = new_sdf = None
    for _ in range(cfg.max_total_iters - 1):
        z_vals, sdf, beta, new = error_bound_round(z_vals, sdf, new, new_sdf, beta, beta0, grid,
                                                   cfg)
        new_sdf = query(new)

    # the final set's draws
    N = cfg.N_samples
    if gen is not None:
        u = ray_rand(gen, (R, N), dev)
    else:
        u = torch.linspace(0.0, 1.0, N, device=dev)
    idx = None
    if cfg.N_samples_extra > 0:
        M = z_vals.shape[1] + (0 if new is None else new.shape[1])
        if gen is not None:
            idx = torch.randperm(M, generator=generator_of(gen), device=dev)[: cfg.N_samples_extra]
        else:
            idx = torch.linspace(0, M - 1, cfg.N_samples_extra, device=dev).long()
    return error_bound_final(z_vals, sdf, new, new_sdf, beta, beta0, u, idx, near, far, cfg)


def _scene_far(cam_loc, ray_dirs, cfg: SamplerConfig) -> torch.Tensor:
    """(R, 1): each ray's exit from the scene sphere, or twice its radius."""
    if cfg.inverse_sphere_bg:
        return get_sphere_intersections(cam_loc, ray_dirs, r=cfg.scene_bounding_sphere)[:, 1:]
    return torch.full((cam_loc.shape[0], 1), 2.0 * cfg.scene_bounding_sphere,
                      device=cam_loc.device)


def node_ray_interval(cam_loc, ray_dirs, center, radius, cfg: SamplerConfig) -> tuple:
    """Per-ray (near, far), each (R, 1): the ray's segment inside the node's
    bounding sphere (``center`` (R, 3), ``radius`` (R,) or a scalar), clipped
    to [cfg.near, the scene exit].  A ray that misses the sphere gets the
    empty interval at the scene exit: its samples lie far from the node and
    add no density.  No counterpart in the reference, which samples every
    node over the whole scene."""
    scene_far = _scene_far(cam_loc, ray_dirs, cfg)
    oc = cam_loc - center
    b = torch.sum(oc * ray_dirs, dim=-1, keepdim=True)
    r = torch.as_tensor(radius, dtype=cam_loc.dtype, device=cam_loc.device).reshape(-1, 1)
    disc = b * b - (torch.sum(oc * oc, dim=-1, keepdim=True) - r ** 2)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = torch.minimum(torch.clamp(-b - sq, min=cfg.near), scene_far)
    t1 = torch.minimum(torch.clamp(-b + sq, min=cfg.near), scene_far)
    hit = (disc > 0.0) & (t1 > t0)
    return torch.where(hit, t0, scene_far), torch.where(hit, t1, scene_far)


def inverse_sphere_z_vals(u: torch.Tensor | None, num_rays: int, N: int,
                          device=None) -> torch.Tensor:
    """Background inverse-depth samples in (0, 1]: (R, N).  ``u`` (R, N) are
    the stratification draws; None gives the even grid."""
    t = torch.linspace(0.0, 1.0, N, device=device)
    z = t[None].expand(num_rays, N)
    if u is not None:
        z = _stratify(z, u)
    return z
