"""Train-time metrics (counterpart of hold_tpu/utils/metrics.py)."""

from __future__ import annotations

import torch


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
