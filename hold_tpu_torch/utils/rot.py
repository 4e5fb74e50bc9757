"""Rotation conversions (counterpart of hold_tpu/utils/rot.py, the part the
training path uses)."""

from __future__ import annotations

import torch

_EPS = 1e-8


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula. aa: (..., 3) -> (..., 3, 3)."""
    angle = torch.linalg.norm(aa + _EPS, dim=-1, keepdim=True)
    axis = aa / angle
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(aa.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + s * K + (1.0 - c) * (K @ K)
