"""Homogeneous and rigid transform math (PyTorch counterpart of
hold_tpu/utils/transforms.py, the parts the training path uses)."""

from __future__ import annotations

import torch


def safe_norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """sqrt(sum(v^2) + eps): finite gradient at v = 0."""
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim) + eps)


def rt_to_mat4(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def inverse_mat3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of batched 3x3 matrices, with the JAX
    package's determinant clamp."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, torch.sign(det) * 1e-12 + 1e-20, det)
    adj = torch.stack(
        [
            A, -(b * i - c * h), (b * f - c * e),
            B, (a * i - c * g), -(a * f - c * d),
            C, -(a * h - b * g), (a * e - b * d),
        ],
        dim=-1,
    ).reshape(M.shape)
    return adj * (1.0 / det)[..., None, None]


def inverse_affine4(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a batched affine 4x4 whose last row is (0, 0, 0, 1)."""
    Ainv = inverse_mat3(T[..., :3, :3])
    t = T[..., :3, 3]
    return rt_to_mat4(Ainv, -torch.einsum("...ij,...j->...i", Ainv, t))
