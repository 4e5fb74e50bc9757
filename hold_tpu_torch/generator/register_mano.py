"""Per-frame MANO registration: fit pose/shape to predicted hand meshes
(counterpart of hold_tpu/generator/register_mano.py).

The generator's registration stage (generator/scripts/register_mano.py:28-153
+ generator/src/hand_pose/registration.py:40-357 of the reference): given
per-frame vertex predictions from an external hand estimator (HAMER/METRO
v3d.npy), fit MANO parameters in two stages — coarse (global orient +
translation) then fine (pose + shape), each with fresh Adam state — with
vertex, edge-length and fingertip losses.  Frames whose fit error is an
outlier are marked for the SLERP infill (slerp.py role).

All frames fit at once on the device (the reference loops frames one at a
time).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fitting.fit import detached, trainable_copy
from ..mano.lbs import lbs_forward, mano_full_pose
from ..mano.model_data import TIP_VERTEX_IDS
from ..mano.server import build_mano_server


def edge_lengths(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    v0 = verts[:, faces[:, 0]]
    v1 = verts[:, faces[:, 1]]
    v2 = verts[:, faces[:, 2]]
    return torch.stack(
        [
            torch.linalg.norm(v1 - v0, dim=-1),
            torch.linalg.norm(v2 - v1, dim=-1),
            torch.linalg.norm(v0 - v2, dim=-1),
        ],
        dim=-1,
    )


def fit_mano_to_verts(
    target_verts: np.ndarray,  # (F, 778, 3) predicted hand meshes
    is_rhand: bool = True,
    coarse_iters: int = 400,
    fine_iters: int = 400,
    lr: float = 1e-2,
    w_edge: float = 10.0,
    w_tip: float = 5.0,
    w_beta: float = 1e-3,
    model_dir: str | None = None,
    device=None,
):
    """Returns dict(poses (F,48), betas (10,), transl (F,3), vert_err (F,)),
    numpy on the host; the fit runs on ``device``."""
    server = build_mano_server(is_rhand, np.zeros(10), model_dir, device=device)
    consts = server.consts
    F = target_verts.shape[0]
    target = torch.as_tensor(np.asarray(target_verts), dtype=torch.float32, device=device)
    faces = torch.as_tensor(np.asarray(consts.faces), dtype=torch.int64, device=device)
    tips = torch.as_tensor(TIP_VERTEX_IDS, device=device)
    target_edges = edge_lengths(target, faces)

    def forward(p):
        full_pose = mano_full_pose(consts, p["global_orient"], p["pose"])
        out = lbs_forward(consts, p["betas"].expand(F, 10), full_pose)
        return out.vertices + p["transl"][:, None]

    def losses(p, fine: bool):
        v = forward(p)
        l_vert = torch.mean(torch.sum((v - target) ** 2, -1))
        l_edge = torch.mean((edge_lengths(v, faces) - target_edges) ** 2)
        l_tip = torch.mean(torch.sum((v[:, tips] - target[:, tips]) ** 2, -1))
        l_beta = torch.sum(p["betas"] ** 2)
        loss = l_vert + w_tip * l_tip
        if fine:
            loss = loss + w_edge * l_edge + w_beta * l_beta
        return loss

    def run(p, trainable: set, fine: bool, iters: int):
        p, free = trainable_copy(p, {k: ("free" if k in trainable else "frozen") for k in p})
        opt = torch.optim.Adam(free, lr=lr)
        loss = torch.tensor(float("nan"))
        for _ in range(iters):
            opt.zero_grad()
            loss = losses(p, fine)
            loss.backward()
            opt.step()
        return detached(p), float(loss.detach())

    # init: translation from centroids, identity orientation
    centroid_t = target.mean(dim=1) - server.verts_c.mean(dim=1)
    params = {
        "global_orient": torch.zeros((F, 3), device=device),
        "pose": torch.zeros((F, 45), device=device),
        "transl": centroid_t,
        "betas": torch.zeros((10,), device=device),
    }

    params, _ = run(params, {"global_orient", "transl"}, False, coarse_iters)
    params, final_loss = run(params, {"global_orient", "transl", "pose", "betas"}, True,
                             fine_iters)

    with torch.no_grad():
        v_fit = forward(params).cpu().numpy()
    vert_err = np.linalg.norm(v_fit - np.asarray(target_verts, np.float32), axis=-1).mean(axis=1)

    host = {k: v.cpu().numpy() for k, v in params.items()}
    poses = np.concatenate([host["global_orient"], host["pose"]], axis=1)
    return {
        "poses": poses.astype(np.float32),
        "betas": host["betas"].astype(np.float32),
        "transl": host["transl"].astype(np.float32),
        "vert_err": vert_err.astype(np.float32),
    }


def mark_outliers(vert_err: np.ndarray, k: float = 3.0) -> np.ndarray:
    """Median-MAD outlier flags (validate_metro/slerp role: bad frames get
    infilled by interpolation)."""
    med = np.median(vert_err)
    mad = np.median(np.abs(vert_err - med)) + 1e-9
    return np.abs(vert_err - med) > k * 1.4826 * mad


def slerp_infill(poses: np.ndarray, transl: np.ndarray,
                 bad: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quaternion SLERP + translation lerp across invalid frames
    (generator/src/hand_pose/slerp.py:8-185 role), applied jointwise, on the
    host."""
    from ..utils.rot import (
        axis_angle_to_quaternion,
        quat_slerp,
        quaternion_to_axis_angle,
    )

    F = poses.shape[0]
    good = np.where(~bad)[0]
    if good.size == 0 or good.size == F:
        return poses, transl
    poses = poses.copy()
    transl = transl.copy()
    J = poses.shape[1] // 3
    quat = axis_angle_to_quaternion(
        torch.as_tensor(poses.reshape(F * J, 3))).reshape(F, J, 4)
    for i in np.where(bad)[0]:
        prev_c = good[good < i]
        nxt_c = good[good > i]
        if prev_c.size and nxt_c.size:
            a, b = prev_c[-1], nxt_c[0]
            t = float((i - a) / (b - a))
            q = quat_slerp(quat[a], quat[b], t)
            transl[i] = (1 - t) * transl[a] + t * transl[b]
        else:
            a = prev_c[-1] if prev_c.size else nxt_c[0]
            q = quat[a]
            transl[i] = transl[a]
        poses[i] = quaternion_to_axis_angle(q).numpy().reshape(-1)
    return poses, transl
