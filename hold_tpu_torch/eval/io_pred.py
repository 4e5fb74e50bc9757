"""Prediction IO: checkpoint -> per-frame meshes/joints in evaluation space
(counterpart of hold_tpu/eval/io_pred.py).

Rebuilds a trained experiment's scene from the model config its checkpoint
holds, runs its MANO and object servers over every frame's pose-table
entries on the device (plain PyTorch), and maps the deform-space outputs to
the evaluation camera space on the host (y/z axis flip, inverse scene scale,
normalize_shift with negated x — the reference's io/ours.py:15-29).
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
import torch

from ..eval.metrics import bbox_centers
from ..mano.server import build_mano_server, mano_server_forward
from ..models.object_model import build_object_server, object_server_forward
from ..utils.checkpoint import load_experiment as load_checkpointed_scene
from ..utils.databus import DataBus

CONVERSION = np.diag([1.0, -1.0, -1.0])


def map_deform2eval(verts: np.ndarray, inv_scale: float,
                    normalize_shift: np.ndarray) -> np.ndarray:
    shift = np.asarray(normalize_shift, np.float64).copy()
    shift[0] *= -1.0
    return np.asarray(verts, np.float64) @ CONVERSION * inv_scale + shift


def load_experiment(exp_dir: str, seq, device, ckpt: str | None = None):
    """Returns (params, misc, scene) for a checkpoint of an experiment on
    ``device``.  ``ckpt`` defaults to the newest checkpoint.  The misc
    sidecar (canonical meshes etc.) is the one at or before the checkpoint's
    step, so that an earlier checkpoint is evaluated with the meshes that
    existed then; the newest one when none is that old."""
    params, scene, step = load_checkpointed_scene(exp_dir, seq, device, ckpt=ckpt)
    misc_ps = sorted(glob(os.path.join(exp_dir, "misc", "*.npy")))
    eligible = [p for p in misc_ps if int(os.path.splitext(os.path.basename(p))[0]) <= step]
    pick = (eligible or misc_ps)[-1:]
    misc = np.load(pick[0], allow_pickle=True).item() if pick else {}
    return params, misc, scene


def _eval_space(seq):
    return 1.0 / seq.scale, np.asarray(seq.data.get("normalize_shift", np.zeros(3)), np.float64)


def _add_derived(out: DataBus) -> None:
    """Root-relative joints and object vertices, the roots, the object's
    bbox centre, from the ``v3d_c.*`` / ``j3d_c.*`` entries."""
    for key in list(out.search("j3d_c.").keys()):
        nid = key.split(".")[1]
        out[f"root.{nid}"] = out[key][:, 0]
        out[f"j3d_ra.{nid}"] = out[key] - out[key][:, :1]
    out["root.object"] = bbox_centers(out["v3d_c.object"])
    out["v3d_ra.object"] = out["v3d_c.object"] - out["root.object"][:, None, :]


@torch.no_grad()
def load_data(exp_dir: str, seq, device, ckpt: str | None = None) -> DataBus:
    """All-frame predictions in eval space (the reference's
    io/ours.py:load_data)."""
    params, misc, scene = load_experiment(exp_dir, seq, device, ckpt=ckpt)
    n = seq.n_frames
    inv_scale, normalize_shift = _eval_space(seq)
    scale = torch.full((n,), seq.scale, device=device)

    out = DataBus()
    faces = {}
    for nid in scene.node_ids:
        tables = params[nid]["tables"]
        if nid in ("right", "left"):
            srv = scene.servers[nid]
            thetas = torch.cat([tables["global_orient"], tables["pose"]], dim=-1)
            o = mano_server_forward(srv, scale, tables["transl"], thetas,
                                    tables["betas"].expand(n, 10))
            out[f"verts.{nid}"] = o.verts.cpu().numpy()
            out[f"jnts.{nid}"] = o.jnts.cpu().numpy()
            faces[nid] = np.asarray(srv.consts.faces)
        else:
            # the canonical mesh from meshing is the object's template when
            # there is one (io/ours.py:44,74-78)
            mesh_cano = misc.get("meshes_cano", {}).get("object")
            if mesh_cano is not None:
                srv = build_object_server(mesh_cano["vertices"],
                                          float(params[nid]["obj_scale"]), np.eye(4), device)
                faces[nid] = np.asarray(mesh_cano["faces"])
            else:
                srv = scene.servers[nid]
                faces[nid] = np.zeros((0, 3), np.int64)
            o = object_server_forward(srv, scale, tables["transl"], tables["global_orient"])
            out[f"verts.{nid}"] = o.verts.cpu().numpy()

    for key in list(out.search("verts.").keys()):
        out[f"v3d_c.{key.split('.')[1]}"] = np.stack(
            [map_deform2eval(v, inv_scale, normalize_shift) for v in out[key]])
    for key in list(out.search("jnts.").keys()):
        out[f"j3d_c.{key.split('.')[1]}"] = np.stack(
            [map_deform2eval(v, inv_scale, normalize_shift) for v in out[key]])
    _add_derived(out)
    for h in ("right", "left"):
        if f"root.{h}" in out:
            out[f"v3d_{h}.object"] = out["v3d_c.object"] - out[f"root.{h}"][:, None, :]
    out["faces"] = faces
    out["full_seq_name"] = seq.case
    out["fnames"] = seq.img_paths
    return out


@torch.no_grad()
def gt_from_sequence(seq, device) -> DataBus:
    """Ground truth in eval space from the build parameters: exact for
    synthetic sequences, whose data.npy is the truth.  A noised-init
    sequence (``data/synthetic.py`` ``pose_noise``) keeps the true poses as
    ``entities_gt`` while ``entities`` holds the perturbed init; the truth
    is used.  Real captures take the dataset-specific loaders
    (``eval/gt_ho3d.py``, ``eval/gt_arctic.py``)."""
    entities = seq.data.get("entities_gt", seq.entities)
    n = seq.n_frames
    inv_scale, normalize_shift = _eval_space(seq)
    scale = torch.full((n,), seq.scale, device=device)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    out = DataBus()
    faces = {}
    for nid in ("right", "left"):
        if nid not in entities:
            continue
        e = entities[nid]
        srv = build_mano_server(nid == "right", e["mean_shape"], device=device)
        o = mano_server_forward(srv, scale, f32(e["hand_trans"]), f32(e["hand_poses"]),
                                f32(e["mean_shape"])[None].expand(n, 10))
        out[f"v3d_c.{nid}"] = np.stack([map_deform2eval(v, inv_scale, normalize_shift)
                                        for v in o.verts.cpu().numpy()])
        out[f"j3d_c.{nid}"] = np.stack([map_deform2eval(v, inv_scale, normalize_shift)
                                        for v in o.jnts.cpu().numpy()])
        faces[nid] = np.asarray(srv.consts.faces)

    e = entities["object"]
    srv = build_object_server(e["pts.cano"], float(e["obj_scale"]), e["norm_mat"], device)
    o = object_server_forward(srv, scale, f32(e["object_poses"][:, 3:]),
                              f32(e["object_poses"][:, :3]))
    out["v3d_c.object"] = np.stack([map_deform2eval(v, inv_scale, normalize_shift)
                                    for v in o.verts.cpu().numpy()])
    faces["object"] = e.get("faces", np.zeros((0, 3), np.int64))

    _add_derived(out)
    if "root.right" in out:
        out["v3d_right.object"] = out["v3d_c.object"] - out["root.right"][:, None, :]
    out["faces"] = faces
    out["is_valid"] = np.ones(n, np.float32)
    return out
