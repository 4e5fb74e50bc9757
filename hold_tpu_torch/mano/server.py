"""MANO server: canonical-space state + posed forward (counterpart of
hold_tpu/mano/server.py).  The canonical pose is minus the hand mean, which
the MANO layer's +hands_mean offset turns into an exactly flat pose."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .model_data import load_mano

from .lbs import ManoConstants, constants_from_model, lbs_forward, mano_full_pose


class ManoServerState(NamedTuple):
    consts: ManoConstants
    betas: torch.Tensor  # (10,)
    verts_c: torch.Tensor  # (1, V, 3)
    joints_c: torch.Tensor  # (1, 21, 3)
    tfs_c_inv: torch.Tensor  # (J, 4, 4)
    skin_weights_c: torch.Tensor  # (1, V, J)


def build_mano_server(is_rhand: bool, betas, model_dir: str | None = None,
                      device=None) -> ManoServerState:
    consts = constants_from_model(load_mano(is_rhand, model_dir), device)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=device).reshape(1, -1)
    zeros = torch.zeros((1, 3), dtype=torch.float32, device=device)
    full_pose = mano_full_pose(consts, zeros, -consts.hands_mean[None])
    with torch.no_grad():
        out = lbs_forward(consts, betas, full_pose)
    tfs_c = out.A[0]
    R = tfs_c[:, :3, :3]
    t = tfs_c[:, :3, 3]
    Rt = R.transpose(-1, -2)
    tfs_c_inv = torch.zeros_like(tfs_c)
    tfs_c_inv[:, :3, :3] = Rt
    tfs_c_inv[:, :3, 3] = -torch.einsum("jmn,jn->jm", Rt, t)
    tfs_c_inv[:, 3, 3] = 1.0
    return ManoServerState(
        consts=consts,
        betas=betas[0],
        verts_c=out.vertices,
        joints_c=out.joints,
        tfs_c_inv=tfs_c_inv,
        skin_weights_c=out.weights,
    )


class ManoServerOutput(NamedTuple):
    verts: torch.Tensor  # (B, V, 3) scene-scaled, translated
    jnts: torch.Tensor  # (B, 21, 3)
    tfs: torch.Tensor  # (B, J, 4, 4) bone tfs relative to canonical
    v_posed: torch.Tensor  # (B, V, 3)


def mano_server_forward(state: ManoServerState, scene_scale, transl: torch.Tensor,
                        thetas: torch.Tensor, betas: torch.Tensor,
                        absolute: bool = False) -> ManoServerOutput:
    """Posed MANO forward in scene coordinates: scaled by the scene scale,
    shifted by scale*transl, bone tfs made relative to the canonical pose."""
    full_pose = mano_full_pose(state.consts, thetas[:, :3], thetas[:, 3:])
    out = lbs_forward(state.consts, betas, full_pose)
    B = thetas.shape[0]
    s = torch.as_tensor(scene_scale, dtype=torch.float32, device=thetas.device)
    s = s.reshape(-1, 1, 1).expand(B, 1, 1)
    t = transl.reshape(-1, 1, 3)
    verts = out.vertices * s + t * s
    jnts = out.joints * s + t * s

    A = out.A
    top = A[:, :, :3, :] * s[..., None]
    top = torch.cat([top[..., :3], (top[..., 3] + t * s)[..., None]], dim=-1)
    tfs = torch.cat([top, A[:, :, 3:]], dim=-2)
    if not absolute:
        tfs = torch.einsum("bnij,njk->bnik", tfs, state.tfs_c_inv)
    return ManoServerOutput(verts=verts, jnts=jnts, tfs=tfs, v_posed=out.v_posed)
