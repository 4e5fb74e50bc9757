"""Evaluation metrics: chamfer / F-score / MPJPE / MRRPE / IoU (host-side; a
copy of hold_tpu/eval/metrics.py, so that the port imports nothing of the
JAX package).

Numerics parity with the reference's evaluation
(code/src/utils/eval_modules.py:148-359, common/metrics.py:7-50):
- chamfer in cm^2 (squared KD-tree distances, both directions summed)
- F-score at 5mm/10mm thresholds in percent
- MPJPE/MRRPE in mm
Implemented on scipy cKDTree + numpy; no torch/pytorch3d dependency.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def chamfer_f_scores(src: np.ndarray, tgt: np.ndarray):
    """(N,3), (M,3) in meters -> (cd cm^2, f5 %, f10 %) — semantics of
    calculate_chamfer_f_scores (eval_modules.py:148-170)."""
    src = np.asarray(src, np.float64) * 100.0
    tgt = np.asarray(tgt, np.float64) * 100.0
    d_t2s, _ = cKDTree(src).query(tgt)
    d_s2t, _ = cKDTree(tgt).query(src)
    cd = np.mean(d_t2s**2) + np.mean(d_s2t**2)

    def fscore(th):
        p1 = np.mean(d_t2s < th)
        p2 = np.mean(d_s2t < th)
        return 2 * p1 * p2 / (p1 + p2 + 1e-7)

    return cd, fscore(0.5) * 100.0, fscore(1.0) * 100.0


def subsample(pts: np.ndarray, n: int, rng: np.random.RandomState):
    if pts.shape[0] <= n:
        return pts
    return pts[rng.permutation(pts.shape[0])[:n]]


def per_frame_chamfer_f(
    v_pred: list | np.ndarray, v_gt: list | np.ndarray,
    is_valid: np.ndarray | None = None, n_points: int = 3000, seed: int = 1,
):
    """Per-frame (cd, f5, f10) arrays with NaN for invalid frames
    (eval_cd_f_ra / eval_cd_f_right semantics)."""
    rng = np.random.RandomState(seed)
    n_frames = len(v_pred)
    cd = np.full(n_frames, np.nan)
    f5 = np.full(n_frames, np.nan)
    f10 = np.full(n_frames, np.nan)
    for i in range(n_frames):
        if is_valid is not None and not is_valid[i]:
            continue
        vp = np.asarray(v_pred[i])
        vg = np.asarray(v_gt[i])
        if not np.isfinite(vp).all():
            continue
        cd[i], f5[i], f10[i] = chamfer_f_scores(
            subsample(vp, n_points, rng), subsample(vg, n_points, rng)
        )
    return cd, f5, f10


def mpjpe_ra(j_pred: np.ndarray, j_gt: np.ndarray,
             is_valid: np.ndarray | None = None) -> np.ndarray:
    """Root-aligned mean per-joint error in mm, (F,) with NaN invalid
    (eval_mpjpe_right + common/metrics.compute_joint3d_error)."""
    jp = j_pred - j_pred[:, :1]
    jg = j_gt - j_gt[:, :1]
    err = np.linalg.norm(jp - jg, axis=-1).mean(axis=1) * 1000.0
    if is_valid is not None:
        err = np.where(np.asarray(is_valid, bool), err, np.nan)
    return err


def mrrpe(root_h_gt, root_o_gt, root_h_pred, root_o_pred,
          is_valid=None) -> np.ndarray:
    """Hand<->object relative root position error in mm (common/metrics.py:
    compute_mrrpe semantics: || (o-h)_pred - (o-h)_gt ||)."""
    rel_pred = np.asarray(root_o_pred) - np.asarray(root_h_pred)
    rel_gt = np.asarray(root_o_gt) - np.asarray(root_h_gt)
    err = np.linalg.norm(rel_pred - rel_gt, axis=-1) * 1000.0
    if is_valid is not None:
        err = np.where(np.asarray(is_valid, bool), err, np.nan)
    return err


def iou_per_frame(pred_maps: np.ndarray, gt_maps: np.ndarray,
                  classes=(0, 100, 200)) -> np.ndarray:
    """Mean IoU over classes per frame (eval_modules.py:172-190)."""
    out = []
    for i in range(pred_maps.shape[0]):
        ious = []
        for c in classes:
            p = pred_maps[i] == c
            g = gt_maps[i] == c
            union = np.logical_or(p, g).sum()
            ious.append(np.logical_and(p, g).sum() / union if union else 0.0)
        out.append(np.mean(ious))
    return np.array(out)


def bbox_centers(vertices) -> np.ndarray:
    """Tight-bbox centers per frame (eval_modules.py:12-36)."""
    if isinstance(vertices, list):
        return np.stack(
            [(v.min(0) + v.max(0)) / 2 for v in vertices], axis=0
        )
    return (vertices.min(axis=1) + vertices.max(axis=1)) / 2
