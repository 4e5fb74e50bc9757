"""Rigid object model + server (counterpart of hold_tpu/models/object_model.py)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device_constants import constant
from ..utils.rot import axis_angle_to_matrix
from ..utils.transforms import inverse_affine4


class ObjectServerState(NamedTuple):
    v3d_cano: torch.Tensor  # (N, 3) canonical (normalized) SfM points
    obj_scale: torch.Tensor  # ()
    denorm_mat: torch.Tensor  # (4, 4) inverse normalization matrix


def build_object_server(pts_cano, obj_scale: float, norm_mat,
                        device=None) -> ObjectServerState:
    return ObjectServerState(
        v3d_cano=torch.as_tensor(np.asarray(pts_cano), dtype=torch.float32, device=device),
        obj_scale=torch.tensor(float(obj_scale), dtype=torch.float32, device=device),
        denorm_mat=torch.as_tensor(
            np.linalg.inv(np.asarray(norm_mat)), dtype=torch.float32, device=device
        ),
    )


class ObjectServerOutput(NamedTuple):
    verts: torch.Tensor  # (B, N, 3)
    obj_tfs: torch.Tensor  # (B, 4, 4) cano -> scene


def object_server_forward(state: ObjectServerState, scene_scale,
                          transl: torch.Tensor, rot_aa: torch.Tensor,
                          obj_scale: torch.Tensor | None = None) -> ObjectServerOutput:
    """T = scale(s) @ [R|t] @ scale(obj) @ denorm, applied to the cano cloud."""
    B = rot_aa.shape[0]
    dev = rot_aa.device
    s = torch.as_tensor(scene_scale, dtype=torch.float32, device=dev).reshape(-1).expand(B)
    o_scale = state.obj_scale if obj_scale is None else obj_scale

    R = axis_angle_to_matrix(rot_aa)
    bottom = constant((0.0, 0.0, 0.0, 1.0), torch.get_default_dtype(), dev).expand(B, 1, 4)
    rigid = torch.cat([torch.cat([R, transl.reshape(B, 3, 1)], dim=-1), bottom], dim=-2)
    ones = torch.ones((B,), device=dev)
    scale_mat = torch.diag_embed(torch.stack([s, s, s, ones], dim=-1))
    o = o_scale.reshape(())
    obj_scale_mat = torch.diag_embed(torch.stack([o, o, o, torch.ones_like(o)]))
    T = scale_mat @ rigid @ obj_scale_mat @ state.denorm_mat[None]

    vh = torch.cat([state.v3d_cano, torch.ones_like(state.v3d_cano[:, :1])], dim=-1)
    out = torch.einsum("bij,nj->bni", T, vh)
    return ObjectServerOutput(verts=out[..., :3] / out[..., 3:4], obj_tfs=T)


def object_deform(x: torch.Tensor, tfs: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Rigid warp (B,N,3),(B,4,4) -> (B,N,3); inverse maps deformed -> canonical."""
    T = inverse_affine4(tfs) if inverse else tfs
    return torch.einsum("bij,bnj->bni", T[:, :3, :3], x) + T[:, None, :3, 3]
