"""Visual diagnostics for the fitting/alignment stages (counterpart of
hold_tpu/fitting/diagnostics.py).

The reference emits fitting GIFs during pose refinement
(code/src/fitting/model.py:186-206) and alignment preview renders
(generator/scripts/visualize_fits.py); without them a diverging fit is
invisible until evaluation.  Per-iteration silhouette panels are stitched
into an animated GIF, and keypoint-projection previews are drawn for the
alignment problem.  The panels are made on the device of the problem and
drawn and written on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _colorize(mask: np.ndarray, color: tuple) -> np.ndarray:
    """(H, W) in [0,1] -> (H, W, 3) tinted."""
    return mask[..., None] * np.asarray(color, np.float32)[None, None]


@torch.no_grad()
def fit_preview(problem, params: dict, frame: int = 0) -> np.ndarray:
    """One fitting-state panel: [target | rendered | abs diff], entities
    color-coded (right=orange, left=blue, object=green). Values in [0,1]."""
    colors = {"right": (1.0, 0.6, 0.3), "left": (0.3, 0.6, 1.0),
              "object": (0.4, 1.0, 0.4)}
    out = problem.forward(params)
    H, W = problem.imsize
    target = np.zeros((H, W, 3), np.float32)
    render = np.zeros((H, W, 3), np.float32)
    diff = np.zeros((H, W), np.float32)
    for nid in problem.node_ids:
        t = problem.targets[nid][frame].cpu().numpy()
        r = out[f"{nid}.mask"][frame].cpu().numpy()
        target += _colorize(t, colors[nid])
        render += _colorize(r, colors[nid])
        diff = np.maximum(diff, np.abs(r - t))
    panel = np.concatenate(
        [target, render, _colorize(diff, (1.0, 0.3, 0.3))], axis=1
    )
    return np.clip(panel, 0.0, 1.0)


def save_gif(frames: list[np.ndarray], path: str, fps: int = 4) -> str:
    """Stitch float [0,1] HxWx3 panels into an animated GIF (PIL)."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ims = [
        Image.fromarray((np.clip(f, 0, 1) * 255).astype(np.uint8))
        for f in frames
    ]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(1000 / max(fps, 1)), loop=0)
    return path


class FitRecorder:
    """Collects fit_preview snapshots during run_fit; writes one GIF.

    Usage:
        rec = FitRecorder(problem, every=50)
        params, hist, improved, guard = run_fit(..., callback=rec)
        rec.save(os.path.join(exp_dir, "fit_stage2.gif"))
    """

    def __init__(self, problem, every: int = 50, frame: int = 0):
        self.problem = problem
        self.every = max(1, every)
        self.frame = frame
        self.frames: list[np.ndarray] = []

    def __call__(self, it: int, params: dict, loss: float) -> None:
        if it % self.every == 0:
            self.frames.append(fit_preview(self.problem, params, self.frame))

    def save(self, path: str, fps: int = 4) -> str | None:
        """Writes the GIF and returns its path; None when no snapshot was
        taken.  A failed write raises."""
        if not self.frames:
            return None
        return save_gif(self.frames, path, fps=fps)


@torch.no_grad()
def alignment_preview(
    prob, params: dict,
    images: list[np.ndarray] | None = None,
    max_frames: int = 8,
) -> np.ndarray:
    """Projection preview for generator.align.AlignmentProblem: target hand
    keypoints (dots) vs fitted projections (crosses) + object points, tiled
    over frames. Returns one (H, W*n, 3) float image."""
    import cv2

    from ..generator.align import project

    K = prob.K.cpu().numpy()
    H = int(K[1, 2] * 2) if images is None else images[0].shape[0]
    W = int(K[0, 2] * 2) if images is None else images[0].shape[1]
    F = params[prob.hands[0]]["transl"].shape[0]
    sel = list(range(0, F, max(1, -(-F // max_frames))))
    fit2d = {h: project(prob.K, prob.hand_joints(params, h)).cpu().numpy() for h in prob.hands}
    o2d = (project(prob.K, prob.object_pts(params)).cpu().numpy()
           if prob.obj_pts_cano is not None else None)

    tiles = []
    for i in sel:
        img = (
            np.full((H, W, 3), 0.15, np.float32) if images is None
            else np.asarray(images[i], np.float32) / (
                255.0 if images[i].dtype == np.uint8 else 1.0)
        ).copy()
        for h in prob.hands:
            tgt = prob.j2d_target[h][i].cpu().numpy()
            for u, v in tgt:
                cv2.circle(img, (int(u), int(v)), 2, (0.2, 0.9, 0.2), -1)
            for u, v in fit2d[h][i]:
                cv2.drawMarker(img, (int(u), int(v)), (1.0, 0.5, 0.2),
                               cv2.MARKER_CROSS, 5, 1)
        if o2d is not None:
            for u, v in o2d[i][::max(1, len(o2d[i]) // 64)]:
                cv2.circle(img, (int(u), int(v)), 1, (0.4, 0.6, 1.0), -1)
        tiles.append(np.clip(img, 0, 1))
    return np.concatenate(tiles, axis=1)
