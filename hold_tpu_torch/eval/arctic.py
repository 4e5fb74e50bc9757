"""ARCTIC tooling: the leaderboard's prediction archive and the two-hand
evaluation (counterpart of hold_tpu/eval/arctic.py).

- ``extract_preds`` (the reference's code/scripts_arctic/extract_preds.py:13-30,
  keys from code/src/arctic/extraction/keys.py:1-21): packs the 19-key
  16-bit prediction archive and zips it.
- ``evaluate_arctic`` (code/scripts_arctic/evaluate_on_arctic.py:25-161): the
  metric registry over the left and right hands and both, CD in cm.
"""

from __future__ import annotations

import json
import os
import os.path as op
import zipfile
from datetime import datetime

import numpy as np

from .icp import compute_icp_metrics
from .metrics import mpjpe_ra, per_frame_chamfer_f

EXTRACTION_KEYS = [
    "fnames",
    "v_posed.left",
    "verts.right",
    "verts.object",
    "v3d_c.left",
    "v3d_c.right",
    "v3d_c.object",
    "j3d_c.left",
    "j3d_c.right",
    "root.left",
    "j3d_ra.left",
    "root.right",
    "j3d_ra.right",
    "root.object",
    "v3d_ra.object",
    "v3d_right.object",
    "v3d_left.object",
    "faces",
    "full_seq_name",
]


def to_16_bits(arr):
    a = np.asarray(arr)
    if a.dtype in (np.float64, np.float32):
        return a.astype(np.float16)
    if a.dtype == np.int64:
        return a.astype(np.int16)
    return a


def extract_preds(pred: dict, out_dir: str) -> str:
    """Write ``<out_dir>/<seq>.npy`` (the keys of EXTRACTION_KEYS that
    ``pred`` has, floats as float16 and int64 as int16) and the zip holding
    it; returns the zip's path."""
    os.makedirs(out_dir, exist_ok=True)
    seq = pred["full_seq_name"]
    packed = {}
    for k in EXTRACTION_KEYS:
        if k not in pred:
            continue
        v = pred[k]
        if isinstance(v, dict):
            packed[k] = {kk: to_16_bits(vv) for kk, vv in v.items()}
        elif isinstance(v, (list, str)):
            packed[k] = v
        else:
            packed[k] = to_16_bits(v)
    npy_p = op.join(out_dir, f"{seq}.npy")
    np.save(npy_p, packed)
    zip_p = op.join(out_dir, f"{seq}.zip")
    with zipfile.ZipFile(zip_p, "w", zipfile.ZIP_DEFLATED) as z:
        z.write(npy_p, op.basename(npy_p))
    return zip_p


# ---- the two-hand registry (eval_modules_arctic.py:265-403) ---------------

def eval_mpjpe_side(pred, gt, md, side: str):
    md[f"mpjpe_ra_{side[0]}"] = mpjpe_ra(pred[f"j3d_ra.{side}"], gt[f"j3d_ra.{side}"],
                                         gt["is_valid"])
    return md


def eval_mpjpe_hand(pred, gt, md):
    errs = [mpjpe_ra(pred[f"j3d_ra.{s}"], gt[f"j3d_ra.{s}"], gt["is_valid"])
            for s in ("right", "left") if f"j3d_ra.{s}" in pred and f"j3d_ra.{s}" in gt]
    md["mpjpe_ra_h"] = np.nanmean(np.stack(errs), axis=0)
    return md


def eval_cd_f_side(pred, gt, md, side: str):
    """The object's chamfer relative to one hand's root.  ARCTIC reports CD
    in cm (evaluate_on_arctic.py:74): the square root of the cm^2 chamfer."""
    cd, f5, f10 = per_frame_chamfer_f(pred[f"v3d_{side}.object"], gt[f"v3d_{side}.object"],
                                      gt["is_valid"])
    md[f"cd_{side[0]}"] = np.sqrt(cd)
    md[f"f5_{side[0]}"] = f5
    md[f"f10_{side[0]}"] = f10
    return md


def eval_cd_hand(pred, gt, md):
    cds = []
    for s in (s for s in ("right", "left") if f"v3d_{s}.object" in pred):
        cd, _, _ = per_frame_chamfer_f(pred[f"v3d_{s}.object"], gt[f"v3d_{s}.object"],
                                       gt["is_valid"])
        cds.append(np.sqrt(cd))
    md["cd_h"] = np.nanmean(np.stack(cds), axis=0)
    return md


def eval_icp_arctic(pred, gt, md, num_iters=600):
    cd, f5, f10 = compute_icp_metrics(
        gt["v3d_ra.object"][0], gt["faces"]["object"],
        pred["v3d_ra.object"][0], pred["faces"]["object"], num_iters=num_iters,
    )
    md["cd_icp"] = np.sqrt(cd)
    md["f5_icp"] = f5 * 100.0
    md["f10_icp"] = f10 * 100.0
    return md


def evaluate_arctic(pred, gt, output_dir: str, icp_iters: int = 600) -> dict:
    """Every metric of the registry that ``pred`` has inputs for; writes
    ``<output_dir>/<seq>.metric.json`` (the means) and ``.metric_all.npy``
    (per frame) and returns the means."""
    md: dict = {}
    for side in ("right", "left"):
        if f"j3d_ra.{side}" in pred:
            md = eval_mpjpe_side(pred, gt, md, side)
            md = eval_cd_f_side(pred, gt, md, side)
    md = eval_mpjpe_hand(pred, gt, md)
    md = eval_cd_hand(pred, gt, md)
    if pred["faces"]["object"].shape[0] and gt["faces"]["object"].shape[0]:
        md = eval_icp_arctic(pred, gt, md, icp_iters)

    mean_metrics = {k: float(np.nanmean(v)) for k, v in sorted(md.items())}
    seq = pred["full_seq_name"]
    os.makedirs(output_dir, exist_ok=True)
    mean_metrics["timestamp"] = datetime.now().strftime("%m-%d %H:%M")
    mean_metrics["seq_name"] = seq
    with open(op.join(output_dir, f"{seq}.metric.json"), "w") as f:
        json.dump(mean_metrics, f, indent=4)
    np.save(op.join(output_dir, f"{seq}.metric_all.npy"), md)
    print("Units: CD (cm), F-score (percentage), MPJPE (mm)")
    return mean_metrics
