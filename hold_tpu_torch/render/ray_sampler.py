"""Ray samplers: stratified uniform + VolSDF error-bound upsampling
(counterpart of hold_tpu/render/ray_sampler.py).

The refinement loop runs ``max_total_iters`` rounds for every ray (per-ray
convergence collapses beta to beta0; no global early exit), exactly as the
JAX package does.  Random draws come from a ``torch.Generator``; with
``gen=None`` every draw is replaced by the deterministic grid, which is what
the JAX functions do with ``rng=None``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

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


def _rand(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


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
        z = _stratify(z, _rand(gen, z.shape, z.device))
    return z


def _laplace_density_beta(sdf, beta):
    return (1.0 / beta) * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) / beta))


def _error_bound(beta, sdf, dists, d_star):
    """Per-ray max opacity error bound.  beta (R,1); sdf (R,S); dists and
    d_star (R,S-1)."""
    density = _laplace_density_beta(sdf, beta)
    err_per_sec = torch.exp(-d_star / beta) * (dists ** 2) / (4.0 * beta ** 2)
    shifted = torch.cat([torch.zeros_like(dists[:, :1]), dists * density[:, :-1]], dim=-1)
    integral = torch.cumsum(shifted, dim=-1)
    err_int = torch.cumsum(err_per_sec, dim=-1)
    bound = (torch.clamp(torch.exp(err_int), max=1e6) - 1.0) * torch.exp(-integral[:, :-1])
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


@torch.no_grad()
def error_bound_z_vals(
    gen: torch.Generator | None,
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],  # (R,S,3) -> (R,S)
    ray_dirs: torch.Tensor,
    cam_loc: torch.Tensor,
    beta0,
    cfg: SamplerConfig,
) -> torch.Tensor:
    """Final z values per ray: (R, N_samples + 2 + N_samples_extra)."""
    R = ray_dirs.shape[0]
    dev = ray_dirs.device
    if cfg.inverse_sphere_bg:
        far = get_sphere_intersections(cam_loc, ray_dirs, r=cfg.scene_bounding_sphere)[:, 1:]
    else:
        far = torch.full((R, 1), 2.0 * cfg.scene_bounding_sphere, device=dev)
    near = torch.full((R, 1), cfg.near, device=dev)

    z0 = uniform_z_vals(gen, ray_dirs, cam_loc, near, far, cfg.N_samples_eval)

    def query(z):
        pts = cam_loc[:, None, :] + z[:, :, None] * ray_dirs[:, None, :]
        return sdf_fn(pts)

    Ne = cfg.N_samples_eval
    z_vals = z0
    sdf = query(z0)

    dists0 = z0[:, 1:] - z0[:, :-1]
    bound = (1.0 / (4.0 * math.log(cfg.eps + 1.0))) * torch.sum(dists0 ** 2, dim=-1)
    beta = torch.sqrt(bound)
    beta0 = torch.as_tensor(beta0, dtype=torch.float32, device=dev).reshape(())

    def bisect(beta, sdf, dists, d_star):
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

    def transmittance_and_free(z_vals, sdf, beta):
        dists = z_vals[:, 1:] - z_vals[:, :-1]
        dists_inf = torch.cat([dists, torch.full((R, 1), 1e10, device=dev)], dim=-1)
        free_energy = dists_inf * _laplace_density_beta(sdf, beta[:, None])
        shifted = torch.cat([torch.zeros((R, 1), device=dev), free_energy[:, :-1]], dim=-1)
        return torch.exp(-torch.cumsum(shifted, dim=-1)), free_energy, dists_inf

    for _ in range(cfg.max_total_iters - 1):
        dists = z_vals[:, 1:] - z_vals[:, :-1]
        d_star = _d_star(z_vals, sdf)
        beta = bisect(beta, sdf, dists, d_star)

        transmittance, _, dists_inf = transmittance_and_free(z_vals, sdf, beta)
        err_per_sec = (
            torch.exp(-d_star / beta[:, None]) * (dists_inf[:, :-1] ** 2)
            / (4.0 * beta[:, None] ** 2)
        )
        err_int = torch.cumsum(err_per_sec, dim=-1)
        bound_opacity = (torch.clamp(torch.exp(err_int), max=1e6) - 1.0) * transmittance[:, :-1]
        pdf = bound_opacity + cfg.add_tiny
        pdf = pdf / torch.clamp(torch.sum(pdf, dim=-1, keepdim=True), min=1e-30)
        cdf = torch.cumsum(pdf, dim=-1)

        u = torch.linspace(0.0, 1.0, Ne, device=dev)[None].expand(R, Ne)
        new_samples = sample_pdf(z_vals, cdf, u)
        new_sdf = query(new_samples)

        z_vals, order = torch.sort(torch.cat([z_vals, new_samples], dim=-1), dim=-1, stable=True)
        sdf = torch.gather(torch.cat([sdf, new_sdf], dim=-1), 1, order)

    # last round: bisect only, then draw the final set from the weights
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    d_star = _d_star(z_vals, sdf)
    beta = bisect(beta, sdf, dists, d_star)
    transmittance, free_energy, _ = transmittance_and_free(z_vals, sdf, beta)
    weights = (1.0 - torch.exp(-free_energy)) * transmittance

    pdf = weights[:, :-1] + 1e-5
    pdf = pdf / torch.sum(pdf, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    N = cfg.N_samples
    if gen is not None:
        u = _rand(gen, (R, N), dev)
    else:
        u = torch.linspace(0.0, 1.0, N, device=dev)[None].expand(R, N)
    z_samples = sample_pdf(z_vals, cdf, u)

    if cfg.N_samples_extra > 0:
        M = z_vals.shape[1]
        if gen is not None:
            idx = torch.randperm(M, generator=gen, device=dev)[: cfg.N_samples_extra]
        else:
            idx = torch.linspace(0, M - 1, cfg.N_samples_extra, device=dev).long()
        z_extra = torch.cat([near, far, z_vals[:, idx]], dim=-1)
    else:
        z_extra = torch.cat([near, far], dim=-1)
    return torch.sort(torch.cat([z_samples, z_extra], dim=-1), dim=-1)[0]


def inverse_sphere_z_vals(u: torch.Tensor | None, num_rays: int, N: int,
                          device=None) -> torch.Tensor:
    """Background inverse-depth samples in (0, 1]: (R, N).  ``u`` (R, N) are
    the stratification draws; None gives the even grid."""
    t = torch.linspace(0.0, 1.0, N, device=device)
    z = t[None].expand(num_rays, N)
    if u is not None:
        z = _stratify(z, u)
    return z
