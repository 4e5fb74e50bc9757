"""SDF -> density transforms (counterpart of hold_tpu/models/density.py)."""

from __future__ import annotations

import torch


def init_laplace_density(params_init: dict, beta_min: float = 1e-4, device=None) -> dict:
    return {"beta": torch.tensor(float(params_init.get("beta", 0.1)),
                                 dtype=torch.float32, device=device)}


def laplace_beta(params: dict, beta_min: float = 1e-4) -> torch.Tensor:
    return torch.abs(params["beta"]) + beta_min


def laplace_density(params: dict, sdf: torch.Tensor, beta=None,
                    beta_min: float = 1e-4) -> torch.Tensor:
    """alpha * Laplace(0, beta).cdf(-sdf) with alpha = 1/beta."""
    if beta is None:
        beta = laplace_beta(params, beta_min)
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) / beta))


def abs_density(sdf: torch.Tensor) -> torch.Tensor:
    return torch.abs(sdf)
