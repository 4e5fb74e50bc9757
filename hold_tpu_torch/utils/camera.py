"""Camera math: weak-perspective conversions, translation fitting, orbits
(counterpart of hold_tpu/utils/camera.py).

Role parity with common/camera.py (the reference's grab-bag of camera
helpers used by the generator's hand-pose init and the viewers).  The tensor
functions take and return torch tensors on the device of their input (numpy
inputs become tensors on ``device``, the CPU by default);
``estimate_translation_k`` solves every frame's closed-form 3x3 normal
equations at once.  The orbit and viewer helpers are numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x, device=None) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(dtype=torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# Weak perspective <-> perspective (camera.py:32-73)
# --------------------------------------------------------------------------

def perspective_to_weak_perspective(cam_t, focal_length, img_res, device=None):
    """(..., 3) translation [tx, ty, tz] -> [s, tx, ty]."""
    cam_t = _t(cam_t, device)
    s = 2.0 * focal_length / (img_res * cam_t[..., 2] + 1e-9)
    return torch.stack([s, cam_t[..., 0], cam_t[..., 1]], dim=-1)


def weak_perspective_to_perspective(weak_cam, focal_length, img_res, device=None):
    """(..., 3) weak camera [s, tx, ty] -> translation [tx, ty, tz]."""
    weak_cam = _t(weak_cam, device)
    tz = 2.0 * focal_length / (img_res * weak_cam[..., 0] + 1e-9)
    return torch.stack([weak_cam[..., 1], weak_cam[..., 2], tz], dim=-1)


def default_cam_t(focal_length, img_res, device=None):
    """The reference's default [5, 0, 0] weak camera as a translation."""
    return weak_perspective_to_perspective(
        [[5.0, 0.0, 0.0]], focal_length, img_res, device
    )


# --------------------------------------------------------------------------
# Translation estimation (camera.py:361-455)
# --------------------------------------------------------------------------

def estimate_translation_k(S, joints_2d, joints_conf, K, device=None):
    """Weighted least-squares camera translation from 2D-3D correspondences.

    S (..., N, 3) 3D joints in camera-rotation space; joints_2d (..., N, 2);
    joints_conf (..., N) weights; K (..., 3, 3).  Returns (..., 3).

    Solves min_t sum_j w_j || f * (S_j + t)_{xy} + (c - u_j) (S_jz + t_z) ||^2
    — the same normal equations the reference builds row-by-row
    (camera.py:361-406), assembled as one closed-form 3x3 system per frame.
    """
    S = _t(S, device)
    dev = S.device
    uv = _t(joints_2d, dev)
    w = _t(joints_conf, dev)
    K = _t(K, dev)

    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]

    # residual rows: [f_k, 0/0/f_k, (c_k - u_k)] . t = (u_k - c_k) Z - f_k XY
    du = cx - uv[..., 0]  # (.., N)
    dv = cy - uv[..., 1]
    Z = S[..., 2]
    cx_rows = torch.stack([fx * torch.ones_like(du), torch.zeros_like(du), du], -1)
    cy_rows = torch.stack([torch.zeros_like(dv), fy * torch.ones_like(dv), dv], -1)
    bx = (uv[..., 0] - cx) * Z - fx[..., 0:1] * S[..., 0]
    by = (uv[..., 1] - cy) * Z - fy[..., 0:1] * S[..., 1]

    rows = torch.cat([cx_rows, cy_rows], dim=-2)  # (.., 2N, 3)
    rhs = torch.cat([bx, by], dim=-1)  # (.., 2N)
    ww = torch.cat([w, w], dim=-1)  # sqrt(conf) applied twice == conf

    A = torch.einsum("...ni,...n,...nj->...ij", rows, ww, rows)
    b = torch.einsum("...ni,...n,...n->...i", rows, ww, rhs)
    return torch.linalg.solve(
        A + 1e-8 * torch.eye(3, dtype=torch.float32, device=dev), b[..., None]
    )[..., 0]


def estimate_translation(S, joints_2d, joints_conf, focal_length, img_size, device=None):
    """Focal/center variant (camera.py:79-125): principal point = img/2."""
    S = _t(S, device)
    n = S.shape[:-2]
    f = torch.broadcast_to(_t(focal_length, S.device), n + (1,))[..., 0]
    c = _t(img_size, S.device) / 2.0
    K = torch.zeros(n + (3, 3), dtype=torch.float32, device=S.device)
    K[..., 0, 0] = f
    K[..., 1, 1] = f
    K[..., 0, 2] = c
    K[..., 1, 2] = c
    K[..., 2, 2] = 1.0
    return estimate_translation_k(S, joints_2d, joints_conf, K)


# --------------------------------------------------------------------------
# Orbit / viewer cameras (camera.py:292-348), numpy on the host
# --------------------------------------------------------------------------

def look_at(eye, at=None, up=None, eps=1e-5):
    """Camera-to-world rotation matrix (columns right/up/forward).

    Convention parity with camera.py:292-316: z = normalize(at - eye)."""
    eye = np.asarray(eye, np.float64).reshape(-1, 3)
    at = np.zeros(3) if at is None else np.asarray(at, np.float64)
    up = np.array([0.0, 0.0, 1.0]) if up is None else np.asarray(up, np.float64)
    z = at[None] - eye
    z = z / np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), eps)
    up_b = np.broadcast_to(up, z.shape)
    x = np.cross(up_b, z)
    x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), eps)
    y = np.cross(z, x)
    y = y / np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), eps)
    return np.stack([x, y, z], axis=-1).astype(np.float32)  # (B, 3, 3)


def to_sphere(u, v):
    """Unit sphere point from uniforms (camera.py:317-326)."""
    theta = 2.0 * np.pi * np.asarray(u)
    phi = np.arccos(1.0 - 2.0 * np.asarray(v))
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
         np.cos(phi)],
        axis=-1,
    ).astype(np.float32)


def sample_on_sphere(rng: np.random.RandomState, range_u=(0.0, 1.0), range_v=(0.0, 1.0)):
    """A uniform point of the unit sphere, drawn from ``rng``."""
    return to_sphere(
        rng.uniform(*range_u), rng.uniform(*range_v)
    )


def sample_pose_on_sphere(rng: np.random.RandomState, range_u=(0.0, 1.0),
                          range_v=(0.0, 1.0), radius=1.0, up=(0.0, 1.0, 0.0)):
    """Random camera-to-world 4x4 looking at the origin from a sphere."""
    loc = sample_on_sphere(rng, range_u, range_v) * radius
    R = look_at(loc, up=np.asarray(up))[0]
    RT = np.eye(4, dtype=np.float32)
    RT[:3, :3] = R
    RT[:3, 3] = loc
    return RT


def rectify_pose(camera_r, body_aa):
    """Rotate a global-orient axis-angle into the camera frame
    (camera.py:349-360)."""
    import cv2

    camera_r = np.asarray(camera_r, np.float64)
    body_aa = np.asarray(body_aa, np.float64)
    Rb = cv2.Rodrigues(body_aa)[0]
    out = cv2.Rodrigues(camera_r @ Rb)[0].reshape(3)
    return out.astype(np.float32)


def get_coord_maps(size=56):
    """Normalized (x, y) coordinate maps, (1, 2, size, size)
    (camera.py:260-291)."""
    r = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    xx = np.broadcast_to(r[None, :], (size, size))
    yy = np.broadcast_to(r[:, None], (size, size))
    return np.stack([xx, yy])[None]
