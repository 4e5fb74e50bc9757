"""ARCTIC ground truth in eval space: the articulated object and the loader
(counterpart of hold_tpu/eval/gt_arctic.py; the reference's
common/object_tensors.py:34-293, a two-part object articulated about z, and
code/src/utils/io/gt_arctic.py:22-60).

Reads the npz that ``data/process_arctic.py`` writes: {obj_verts_top,
obj_verts_bottom, obj_arti (F,), obj_rot (F,3), obj_trans (F,3), each
hand's MANO parameters, world2cam (F,4,4), K, ioi_offset, is_valid}.
"""

from __future__ import annotations

import os.path as op

import numpy as np
import torch

from ..mano.lbs import lbs_forward, mano_full_pose
from ..mano.server import build_mano_server
from ..utils.databus import DataBus
from ..utils.rot import axis_angle_to_matrix
from .metrics import bbox_centers


def arctic_object_forward(
    verts_top: np.ndarray,  # (Vt, 3) canonical top part
    verts_bottom: np.ndarray,  # (Vb, 3)
    arti: np.ndarray,  # (F,) articulation angle about +z
    rot_aa: np.ndarray,  # (F, 3) global orientation
    trans: np.ndarray,  # (F, 3)
) -> np.ndarray:
    """(F, Vt+Vb, 3): the top part rotated by -arti about z, then the whole
    object by its rigid pose (ObjectTensors.forward)."""
    F = arti.shape[0]
    ca, sa = np.cos(-arti), np.sin(-arti)
    Rz = np.zeros((F, 3, 3))
    Rz[:, 0, 0], Rz[:, 0, 1] = ca, -sa
    Rz[:, 1, 0], Rz[:, 1, 1] = sa, ca
    Rz[:, 2, 2] = 1.0
    top = np.einsum("fij,vj->fvi", Rz, verts_top)
    bottom = np.broadcast_to(verts_bottom[None], (F,) + verts_bottom.shape)
    full = np.concatenate([top, bottom], axis=1)
    R = axis_angle_to_matrix(torch.as_tensor(np.asarray(rot_aa, np.float32))).numpy()
    return np.einsum("fij,fvj->fvi", R, full) + trans[:, None]


def _to_camera(w2c: np.ndarray, x: np.ndarray) -> np.ndarray:
    return np.einsum("fij,fvj->fvi", w2c[:, :3, :3], x) + w2c[:, None, :3, 3]


@torch.no_grad()
def load_data(full_seq_name: str, arctic_root: str = "./generator/assets/arctic",
              device=None) -> DataBus:
    """Both hands' (where present) and the object's camera-space vertices,
    joints, roots and root-relative forms, the faces and ``is_valid``.  The
    MANO layer runs on ``device`` (the CPU when None)."""
    proc = np.load(op.join(arctic_root, "processed", f"{full_seq_name}.npz"),
                   allow_pickle=True)
    n = int(proc["obj_arti"].shape[0])
    w2c = np.asarray(proc["world2cam"], np.float32)
    out = DataBus()
    faces = {}

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    for side in ("right", "left"):
        if f"{side}_pose" not in proc:
            continue
        poses = np.asarray(proc[f"{side}_pose"], np.float32)  # (F, 48)
        betas = np.asarray(proc[f"{side}_shape"], np.float32)
        transl = np.asarray(proc[f"{side}_transl"], np.float32)
        srv = build_mano_server(side == "right", betas[0] if betas.ndim > 1 else betas,
                                device=device)
        full = mano_full_pose(srv.consts, dev(poses[:, :3]), dev(poses[:, 3:]))
        o = lbs_forward(srv.consts, dev(betas if betas.ndim > 1 else np.tile(betas, (n, 1))),
                        full)
        v = _to_camera(w2c, o.vertices.cpu().numpy() + transl[:, None])
        j = _to_camera(w2c, o.joints.cpu().numpy() + transl[:, None])
        out[f"v3d_c.{side}"] = v
        out[f"j3d_c.{side}"] = j
        out[f"root.{side}"] = j[:, 0]
        out[f"j3d_ra.{side}"] = j - j[:, :1]
        faces[side] = np.asarray(srv.consts.faces)

    v_o = _to_camera(w2c, arctic_object_forward(
        *(np.asarray(proc[k], np.float32) for k in
          ("obj_verts_top", "obj_verts_bottom", "obj_arti", "obj_rot", "obj_trans"))))
    out["v3d_c.object"] = v_o
    out["root.object"] = bbox_centers(v_o)
    out["v3d_ra.object"] = v_o - out["root.object"][:, None, :]
    for side in ("right", "left"):
        if f"root.{side}" in out:
            out[f"v3d_{side}.object"] = v_o - out[f"root.{side}"][:, None, :]
    faces["object"] = np.asarray(
        proc["obj_faces"] if "obj_faces" in proc else np.zeros((0, 3), np.int64))
    out["faces"] = faces
    out["is_valid"] = np.asarray(proc["is_valid"] if "is_valid" in proc else np.ones(n),
                                 np.float32)
    return out
