"""ARCTIC raw annotations -> the packed ground-truth archive (counterpart of
hold_tpu/data/process_arctic.py, the reference's
code/src/arctic/processing.py:408-497 and preprocess_dataset.py).

From a raw ARCTIC sequence (the ``<seq>.mano.npy`` / ``<seq>.object.npy``
dicts: per-frame MANO parameters of both hands, the object's articulation,
rotation and translation, each view's static world-to-camera and
intrinsics, ``ioi_offset``), writes the npz that ``eval/gt_arctic.py``
reads.  Cameras are per view and static; frames are offset by ``ioi_offset``
into the capture (io/gt_arctic.py:22-60).

    python -m hold_tpu_torch.data.process_arctic --mano <seq>.mano.npy \\
        --object <seq>.object.npy --meta <subject_meta.npy> --view 1 \\
        --obj_template mesh_top.obj,mesh_bottom.obj --out ./generator/assets/arctic
"""

from __future__ import annotations

import argparse
import os
import os.path as op

import numpy as np


def process_sequence(
    mano_data: dict,
    object_data: np.ndarray,
    world2cam: np.ndarray,  # (V, 4, 4) static per-view extrinsics
    intris_mat: np.ndarray,  # (V, 3, 3)
    view: int,
    obj_top_verts: np.ndarray,
    obj_bottom_verts: np.ndarray,
    obj_faces: np.ndarray,
    ioi_offset: int = 0,
    out_dir: str = "./generator/assets/arctic",
    seq_name: str = "seq",
) -> str:
    """mano_data: {'right'/'left': {'rot' (F,3), 'pose' (F,45), 'trans'
    (F,3), 'shape' (10,) or (F,10)}}; object_data: (F, 7+) rows [arti,
    rot(3), trans(3) in mm], the ARCTIC raw convention.  Object lengths
    go to metres.  Returns the npz's path."""
    F = object_data.shape[0]
    pack: dict = {
        "obj_arti": np.asarray(object_data[:, 0], np.float32),
        "obj_rot": np.asarray(object_data[:, 1:4], np.float32),
        "obj_trans": np.asarray(object_data[:, 4:7], np.float32) / 1000.0,
        "obj_verts_top": np.asarray(obj_top_verts, np.float32) / 1000.0,
        "obj_verts_bottom": np.asarray(obj_bottom_verts, np.float32) / 1000.0,
        "obj_faces": np.asarray(obj_faces, np.int64),
        "world2cam": np.tile(np.asarray(world2cam[view], np.float32)[None], (F, 1, 1)),
        "K": np.asarray(intris_mat[view], np.float32),
        "ioi_offset": np.int64(ioi_offset),
        "is_valid": np.ones(F, np.float32),
    }
    for side in ("right", "left"):
        if side not in mano_data:
            continue
        d = mano_data[side]
        shape = np.asarray(d["shape"], np.float32)
        if shape.ndim == 1:
            shape = np.tile(shape[None], (F, 1))
        pack[f"{side}_pose"] = np.concatenate(
            [np.asarray(d["rot"], np.float32), np.asarray(d["pose"], np.float32)], axis=-1)
        pack[f"{side}_shape"] = shape
        pack[f"{side}_transl"] = np.asarray(d["trans"], np.float32)

    os.makedirs(op.join(out_dir, "processed"), exist_ok=True)
    out_p = op.join(out_dir, "processed", f"{seq_name}.npz")
    np.savez(out_p, **pack)
    return out_p


def main(argv=None):
    from ..utils.mesh import load_obj

    ap = argparse.ArgumentParser()
    ap.add_argument("--mano", required=True, help="<seq>.mano.npy")
    ap.add_argument("--object", required=True, help="<seq>.object.npy")
    ap.add_argument("--meta", required=True,
                    help="subject meta npy with world2cam/intris_mat/ioi_offset")
    ap.add_argument("--view", type=int, default=1)
    ap.add_argument("--obj_template", required=True, help="mesh_top.obj,mesh_bottom.obj")
    ap.add_argument("--out", default="./generator/assets/arctic")
    ap.add_argument("--seq_name", default="")
    args = ap.parse_args(argv)

    mano_data = np.load(args.mano, allow_pickle=True).item()
    object_data = np.load(args.object, allow_pickle=True)
    meta = np.load(args.meta, allow_pickle=True).item()
    top_p, bottom_p = args.obj_template.split(",")
    top, bottom = load_obj(top_p), load_obj(bottom_p)
    faces = np.concatenate([top.faces, bottom.faces + top.vertices.shape[0]], axis=0)
    seq = args.seq_name or op.basename(args.mano).split(".")[0]
    p = process_sequence(
        mano_data, object_data, np.asarray(meta["world2cam"]), np.asarray(meta["intris_mat"]),
        args.view, top.vertices, bottom.vertices, faces, int(meta.get("ioi_offset", 0)),
        args.out, seq,
    )
    print(f"wrote {p}")
    return p


if __name__ == "__main__":
    main()
