"""Rotation-representation conversions (a frozen copy of the port's hold_tpu_torch/utils/rot.py):
axis-angle, matrix, quaternion (wxyz), 6d and euler angles, batched over
leading dims, with no data-dependent control flow."""

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


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz, w >= 0: of the four candidates (one per
    dominant diagonal term) the one with the largest score, normalised."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cand = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1),
    ], dim=-2)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cand, idx[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(R))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=_EPS)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3), Gram-Schmidt on the two rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _unit(a1)
    b2 = _unit(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-2)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    return torch.cat([R[..., 0, :], R[..., 1, :]], dim=-1)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Non-negative real part."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, wxyz."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Composition with a standardized output."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a versor."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate 3D points by versors."""
    p = torch.cat([torch.zeros_like(point[..., :1]), point], dim=-1)
    return quaternion_raw_multiply(quaternion_raw_multiply(q, p), quaternion_invert(q))[..., 1:]


def euler_to_quaternion(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) euler xyz -> (..., 4) wxyz (R = Rx Ry Rz)."""
    x, y, z = r[..., 0] / 2.0, r[..., 1] / 2.0, r[..., 2] / 2.0
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    return torch.stack([cx * cy * cz - sx * sy * sz, cx * sy * sz + cy * cz * sx,
                        cx * cz * sy - sx * cy * sz, cx * cy * sz + sx * cz * sy], dim=-1)


def euler_to_matrix(r: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(euler_to_quaternion(r))


def matrix_to_euler(R: torch.Tensor) -> torch.Tensor:
    """The principal euler solution of R = Rz(z) Ry(y) Rx(x), with z = 0 at
    gimbal lock.  It decomposes the ZYX product while ``euler_to_matrix``
    composes XYZ: the two are not inverses, as in the JAX package."""
    r20 = torch.clamp(R[..., 2, 0], -1.0, 1.0)
    y = -torch.arcsin(r20)
    cy = torch.cos(y)
    safe = cy.abs() > 1e-6
    cy_s = torch.where(safe, cy, torch.ones_like(cy))
    x = torch.atan2(R[..., 2, 1] / cy_s, R[..., 2, 2] / cy_s)
    z = torch.atan2(R[..., 1, 0] / cy_s, R[..., 0, 0] / cy_s)
    x_lock = torch.where(r20 < 0, torch.atan2(R[..., 0, 1], R[..., 0, 2]),
                         -torch.atan2(-R[..., 0, 1], R[..., 0, 2]))
    return torch.stack([torch.where(safe, x, x_lock), y,
                        torch.where(safe, z, torch.zeros_like(z))], dim=-1)


def compute_geodesic_distance(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Angular distance between rotation matrices, in [0, pi]."""
    m = m1 @ m2.transpose(-1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def rot_aa(aa: torch.Tensor, rot_deg) -> torch.Tensor:
    """A global orientation (axis-angle) turned by ``rot_deg`` degrees about +z."""
    t = torch.deg2rad(torch.tensor(-float(rot_deg), dtype=torch.float32, device=aa.device))
    c, s = torch.cos(t), torch.sin(t)
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    Rz = torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]),
                      torch.stack([zero, zero, one])])
    return matrix_to_axis_angle(Rz.to(aa.dtype) @ axis_angle_to_matrix(aa))


def rot6d_to_rotmat_ref(x: torch.Tensor) -> torch.Tensor:
    """The column-convention 6d -> matrix of data written by the reference
    (not ``rotation_6d_to_matrix``'s row convention)."""
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = x[..., 0], x[..., 1]
    b1 = _unit(a1)
    b2 = _unit(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def rotmat_to_rot6d_ref(R: torch.Tensor) -> torch.Tensor:
    """Column-convention matrix -> 6d."""
    return R[..., :, :2].reshape(R.shape[:-2] + (6,))
