"""Linear blend skinning for MANO (counterpart of hold_tpu/mano/lbs.py).

Blend shapes, Rodrigues, the 16-joint kinematic chain and weighted skinning
as batched tensor ops.  The model data comes from ``mano/model_data.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .model_data import TIP_VERTEX_IDS, ManoModelData


class ManoConstants(NamedTuple):
    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, 10)
    posedirs: torch.Tensor  # (135, V*3)
    J_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    hands_mean: torch.Tensor  # (45,)
    parents: tuple  # (J,) python ints
    faces: np.ndarray  # host-side (F, 3)
    is_rhand: bool


def constants_from_model(md: ManoModelData, device=None) -> ManoConstants:
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    return ManoConstants(
        v_template=t(md.v_template),
        shapedirs=t(md.shapedirs),
        posedirs=t(md.posedirs),
        J_regressor=t(md.J_regressor),
        lbs_weights=t(md.lbs_weights),
        hands_mean=t(md.hands_mean),
        parents=tuple(int(p) for p in md.parents),
        faces=md.faces,
        is_rhand=md.is_rhand,
    )


def rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Batched axis-angle -> rotation matrix, (..., 3) -> (..., 3, 3)."""
    angle = torch.linalg.norm(rot_vecs + eps, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1)
    K = K.reshape(rot_vecs.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return eye + sin * K + (1.0 - cos) * (K @ K)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents):
    """Kinematic chain: posed joints (B,J,3) and skinning transforms
    A (B,J,4,4), A_j = [R_chain_j | t_chain_j - R_chain_j j_rest_j]."""
    B, J = joints.shape[:2]
    parent_idx = list(parents[1:])
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parent_idx]], dim=1)
    top = torch.cat([rot_mats, rel[..., None]], dim=-1)  # (B,J,3,4)
    bottom = torch.zeros((B, J, 1, 4), dtype=joints.dtype, device=joints.device)
    bottom[..., 0, 3] = 1.0
    T_local = torch.cat([top, bottom], dim=-2)

    chain = [T_local[:, 0]]
    for j in range(1, J):
        chain.append(chain[parents[j]] @ T_local[:, j])
    T_world = torch.stack(chain, dim=1)

    posed_joints = T_world[:, :, :3, 3]
    corr = torch.einsum("bjmn,bjn->bjm", T_world[:, :, :3, :3], joints)
    A = torch.cat(
        [
            torch.cat([T_world[:, :, :3, :3], (T_world[:, :, :3, 3] - corr)[..., None]], -1),
            T_world[:, :, 3:],
        ],
        dim=-2,
    )
    return posed_joints, A


class LbsOutput(NamedTuple):
    vertices: torch.Tensor  # (B, V, 3)
    joints: torch.Tensor  # (B, 21, 3)
    A: torch.Tensor  # (B, J, 4, 4)
    weights: torch.Tensor  # (B, V, J)
    v_posed: torch.Tensor  # (B, V, 3)


def lbs_forward(consts: ManoConstants, betas: torch.Tensor,
                full_pose: torch.Tensor, pose_blend: bool = True) -> LbsOutput:
    B = full_pose.shape[0]
    J = len(consts.parents)
    v_shaped = consts.v_template[None] + torch.einsum(
        "bl,mkl->bmk", betas, consts.shapedirs
    )
    joints_rest = torch.einsum("bik,ji->bjk", v_shaped, consts.J_regressor)

    rot_mats = rodrigues(full_pose.reshape(B, J, 3))
    eye = torch.eye(3, dtype=full_pose.dtype, device=full_pose.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)
    if pose_blend:
        v_posed = v_shaped + (pose_feature @ consts.posedirs).reshape(B, -1, 3)
    else:
        v_posed = v_shaped

    posed_joints, A = batch_rigid_transform(rot_mats, joints_rest, consts.parents)
    W = consts.lbs_weights[None].expand((B,) + consts.lbs_weights.shape)
    T = torch.einsum("bvj,bjmn->bvmn", W, A)
    verts = torch.einsum("bvmn,bvn->bvm", T[:, :, :3, :3], v_posed) + T[:, :, :3, 3]
    tips = verts[:, torch.as_tensor(TIP_VERTEX_IDS, device=verts.device)]
    joints21 = torch.cat([posed_joints, tips], dim=1)
    return LbsOutput(verts, joints21, A, W, v_posed)


def mano_full_pose(consts: ManoConstants, global_orient: torch.Tensor,
                   hand_pose: torch.Tensor) -> torch.Tensor:
    """[global_orient, hand_pose + hands_mean] (flat_hand_mean=False)."""
    return torch.cat([global_orient, hand_pose + consts.hands_mean[None]], dim=-1)
