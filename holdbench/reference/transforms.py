"""Homogeneous and rigid transform math (a frozen copy of
the port's hold_tpu_torch/utils/transforms.py)."""

from __future__ import annotations

import numpy as np
import torch


def safe_norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """sqrt(sum(v^2) + eps): finite gradient at v = 0."""
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim) + eps)


def to_homo(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) with 1 appended."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def transform_points(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    y = torch.einsum("...ij,...nj->...ni", T, to_homo(x))
    return y[..., :3] / y[..., 3:4]


def rt_to_mat4(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def inverse_rigid(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid (no-shear) 4x4."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_mat4(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


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


def project2d(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Perspective projection. K (..., 3, 3), pts (..., N, 3) -> (..., N, 2)."""
    uvw = torch.einsum("...ij,...nj->...ni", K, pts_cam)
    return uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=1e-8)


def solve_rigid_tf_np(src: np.ndarray, dst: np.ndarray):
    """Kabsch: R, t minimising ||R src + t - dst|| (numpy, host-side)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ S @ U.T
    t = mu_d - R @ mu_s
    return R.astype(np.float32), t.astype(np.float32)


def cv2gl_mano(global_orient_aa: np.ndarray, transl: np.ndarray, pivot: np.ndarray):
    """Flip a MANO root pose between the OpenCV and OpenGL camera conventions
    (y and z negated about ``pivot``, the rest root joint), host-side numpy.
    Its own inverse.  Returns (axis-angle (F, 3), translation (F, 3)),
    float32."""
    import cv2

    flip = np.diag([1.0, -1.0, -1.0])
    R = np.stack([cv2.Rodrigues(a)[0] for a in np.asarray(global_orient_aa)])
    R_new = flip[None] @ R
    aa_new = np.stack([cv2.Rodrigues(r)[0][:, 0] for r in R_new])
    t_new = (flip[None] @ (np.asarray(transl) + pivot)[..., None])[..., 0] - pivot @ flip.T
    return aa_new.astype(np.float32), t_new.astype(np.float32)
