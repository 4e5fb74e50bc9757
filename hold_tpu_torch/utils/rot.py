"""Rotation conversions (counterpart of hold_tpu/utils/rot.py, the part the
training path and the generator's SLERP infill use)."""

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


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) wxyz."""
    angle = torch.linalg.norm(aa + _EPS, dim=-1, keepdim=True)
    axis = aa / angle
    half = angle * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3), the rotation angle in [0, pi]."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    xyz = q[..., 1:]
    n = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(n, w)
    x_axis = torch.zeros_like(xyz)
    x_axis[..., 0] = 1.0
    axis = torch.where(n < _EPS, x_axis, xyz / torch.clamp(n, min=_EPS))
    return axis * angle


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions (wxyz)."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(d.abs(), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_t = torch.sin(theta)
    near = sin_t < 1e-5
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / torch.clamp(sin_t, min=_EPS))
    w1 = torch.where(near, torch.full_like(theta, t),
                     torch.sin(t * theta) / torch.clamp(sin_t, min=_EPS))
    q = w0 * q0 + w1 * q1
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
