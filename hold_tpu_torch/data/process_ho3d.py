"""HO3D v3 annotation preprocessing: a raw sequence's per-frame meta pkl ->
one npz (counterpart of hold_tpu/data/process_ho3d.py, the reference's
scripts/process_ho3d.py:25-179).

Walks a sequence's ``rgb/`` folder, reads each frame's ``meta/<frame>.pkl``,
collects the MANO pose (hand mean removed), shape and translation, the
camera K and the object's rigid pose (its rotation as a matrix), fills each
invalid frame (one whose annotations are None) from its nearest valid one,
and writes ``<out>/processed/<seq>.npz``, which ``eval/gt_ho3d.py`` reads.

    python -m hold_tpu_torch.data.process_ho3d --ho3d_root <HO3D_v3/train> --seq ABF10 \\
        --out ./generator/assets/ho3d_v3
"""

from __future__ import annotations

import argparse
import os
import os.path as op
import pickle

import numpy as np
import torch

from ..utils.rot import axis_angle_to_matrix

_KEYS = ("hand_pose", "hand_beta", "hand_transl", "obj_rot", "obj_trans", "K")
_SHAPES = {"hand_pose": (48,), "hand_beta": (10,), "hand_transl": (3,), "obj_rot": (3, 3),
           "obj_trans": (3,), "K": (3, 3)}


def infill_nearest_valid(arr: np.ndarray, valid_idx: np.ndarray) -> np.ndarray:
    """Each row that holds a non-finite value replaced by the nearest valid
    row (the earlier one on a tie)."""
    arr = arr.copy()
    for i in range(arr.shape[0]):
        if not np.isfinite(arr[i]).all():
            arr[i] = arr[valid_idx[np.argmin(np.abs(valid_idx - i))]]
    return arr


def process_sequence(seq_dir: str, out_dir: str, seq_name: str,
                     hands_mean: np.ndarray) -> str:
    """Write ``<out_dir>/processed/<seq_name>.npz`` from ``seq_dir``'s
    ``rgb/`` and ``meta/``; returns its path."""
    meta_dir = op.join(seq_dir, "meta")
    rgb_dir = op.join(seq_dir, "rgb")
    frames = sorted(os.listdir(rgb_dir))

    recs: dict = {k: [] for k in _KEYS}
    is_valid, fnames = [], []
    obj_name = None
    for fname in frames:
        with open(op.join(meta_dir, op.splitext(fname)[0] + ".pkl"), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        obj_name = d.get("objName", obj_name)
        valid = all(d.get(k) is not None for k in ("handPose", "objTrans", "handBeta"))
        is_valid.append(1.0 if valid else 0.0)
        fnames.append(op.join(rgb_dir, fname))
        if not valid:
            for k in _KEYS:
                recs[k].append(np.full(_SHAPES[k], np.nan, np.float32))
            continue
        pose = np.asarray(d["handPose"], np.float32).reshape(-1)
        pose[3:] -= hands_mean  # stored mean-removed, as the reference does
        recs["hand_pose"].append(pose)
        recs["hand_beta"].append(np.asarray(d["handBeta"], np.float32).reshape(-1))
        recs["hand_transl"].append(np.asarray(d["handTrans"], np.float32).reshape(-1))
        aa = torch.as_tensor(np.asarray(d["objRot"], np.float32).reshape(1, 3))
        recs["obj_rot"].append(axis_angle_to_matrix(aa)[0].numpy())
        recs["obj_trans"].append(np.asarray(d["objTrans"], np.float32).reshape(-1))
        recs["K"].append(np.asarray(d["camMat"], np.float32))

    # nearest-valid infill (the reference's SLERP role, held to the nearest
    # frame for the ground truth; invalid frames stay out of every metric
    # through is_valid)
    valid_idx = np.where(np.asarray(is_valid) > 0)[0]
    assert valid_idx.size, f"no valid frames in {seq_dir}"
    packed = {k: infill_nearest_valid(np.stack(recs[k]), valid_idx) for k in _KEYS}

    os.makedirs(op.join(out_dir, "processed"), exist_ok=True)
    out_p = op.join(out_dir, "processed", f"{seq_name}.npz")
    np.savez(out_p, **packed, is_valid=np.asarray(is_valid, np.float32),
             obj_name=obj_name or "", fnames=np.asarray(fnames))
    return out_p


def main(argv=None):
    from ..mano.model_data import load_mano

    ap = argparse.ArgumentParser()
    ap.add_argument("--ho3d_root", required=True, help="HO3D_v3/train dir")
    ap.add_argument("--seq", required=True)
    ap.add_argument("--out", default="./generator/assets/ho3d_v3")
    args = ap.parse_args(argv)

    hands_mean = load_mano(True).hands_mean
    p = process_sequence(op.join(args.ho3d_root, args.seq), args.out, args.seq, hands_mean)
    print(f"wrote {p}")
    return p


if __name__ == "__main__":
    main()
