"""HO3D v3 ground truth in eval space (counterpart of hold_tpu/eval/gt_ho3d.py,
the reference's code/src/utils/io/gt.py).

Reads the processed archive (``data/process_ho3d.py``), keeps the frames the
build's ``corres.txt`` names, turns the MANO root pose from OpenGL to OpenCV
about the rest root joint (gt.py:64-82), poses the hand through the port's
MANO layer on the caller's device, poses the scanned object model, and
derives the root-relative quantities the prediction loader derives.
"""

from __future__ import annotations

import os.path as op

import numpy as np
import torch

from ..mano.lbs import lbs_forward, mano_full_pose
from ..mano.server import build_mano_server
from ..utils.databus import DataBus
from ..utils.mesh import load_obj
from ..utils.transforms import cv2gl_mano
from .metrics import bbox_centers


def hand_root_pivot(server, betas: np.ndarray) -> np.ndarray:
    """The rest root joint for shape ``betas`` (smplx's get_T_hip role)."""
    c = server.consts
    v_shaped = c.v_template.cpu().numpy() + np.einsum(
        "l,mkl->mk", np.asarray(betas), c.shapedirs.cpu().numpy())
    return c.J_regressor.cpu().numpy()[0] @ v_shaped


def select_frames(corres_p: str) -> np.ndarray | None:
    """The frame numbers a build's ``corres.txt`` names (sorted), or None
    when there is none."""
    if not op.exists(corres_p):
        return None
    with open(corres_p) as f:
        sel = sorted(line.strip() for line in f if line.strip())
    return np.array([int(op.basename(s).split(".")[0]) for s in sel])


@torch.no_grad()
def load_data(full_seq_name: str, data_root: str = "./data",
              ho3d_root: str = "./generator/assets/ho3d_v3", device=None) -> DataBus:
    """The ground truth of ``full_seq_name`` (``hold_<seq>_ho3d`` or ``<seq>``):
    camera-space hand vertices and joints, the posed object, their roots and
    root-relative forms, the faces and ``is_valid``.  The MANO layer runs on
    ``device`` (the CPU when None)."""
    seq_name = full_seq_name.split("_")[1] if "_" in full_seq_name else full_seq_name
    d = np.load(op.join(ho3d_root, "processed", f"{seq_name}.npz"), allow_pickle=True)
    fields = {k: np.asarray(d[k], np.float32) for k in
              ("hand_pose", "hand_beta", "hand_transl", "obj_rot", "obj_trans", "is_valid")}
    obj_name = str(d["obj_name"])

    fids = select_frames(op.join(data_root, full_seq_name, "build", "corres.txt"))
    if fids is not None:
        fields = {k: v[fids] for k, v in fields.items()}
    hand_pose, hand_beta = fields["hand_pose"], fields["hand_beta"]
    n = hand_pose.shape[0]
    server = build_mano_server(True, hand_beta[0], device=device)

    # GL -> CV for the root, about the rest root-joint pivot
    pivot = hand_root_pivot(server, hand_beta[0])
    rot_cv, transl_cv = cv2gl_mano(hand_pose[:, :3], fields["hand_transl"], pivot)

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    full_pose = mano_full_pose(server.consts, dev(rot_cv), dev(hand_pose[:, 3:]))
    out_lbs = lbs_forward(server.consts, dev(hand_beta), full_pose)
    v3d_h = out_lbs.vertices.cpu().numpy() + transl_cv[:, None]
    j3d_h = out_lbs.joints.cpu().numpy() + transl_cv[:, None]

    # the scanned object posed by its (y/z-flipped) rigid transform
    obj_mesh = load_obj(op.join(ho3d_root, "models", obj_name, "textured_simple.obj"))
    Rt = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    Rt[:, :3, :3] = fields["obj_rot"]
    Rt[:, :3, 3] = fields["obj_trans"]
    Rt[:, 1:3] *= -1  # GL -> CV (gt.py:108-111)
    v3d_o = np.einsum("fij,nj->fni", Rt[:, :3, :3], obj_mesh.vertices) + Rt[:, None, :3, 3]

    out = DataBus()
    out["v3d_c.right"] = v3d_h
    out["j3d_c.right"] = j3d_h
    out["v3d_c.object"] = v3d_o
    out["root.right"] = j3d_h[:, 0]
    out["j3d_ra.right"] = j3d_h - j3d_h[:, :1]
    out["root.object"] = bbox_centers(v3d_o)
    out["v3d_ra.object"] = v3d_o - out["root.object"][:, None, :]
    out["v3d_right.object"] = v3d_o - out["root.right"][:, None, :]
    out["faces"] = {"right": np.asarray(server.consts.faces), "object": obj_mesh.faces}
    out["is_valid"] = fields["is_valid"]
    return out
