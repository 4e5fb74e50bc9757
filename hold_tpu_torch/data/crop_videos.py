"""Batch video cropping (counterpart of hold_tpu/data/crop_videos.py; the
reference's generator/scripts_arctic/crop_arctic_videos.py, an interactive
box picker).

Crops every frame of a video to a fixed box, or to the union of the
non-zero pixels of a folder of masks grown by ``margin``, and writes the
result (mp4v).

    python -m hold_tpu_torch.data.crop_videos --video in.mp4 --out out.mp4 \\
        --box x0 y0 x1 y1
"""

from __future__ import annotations

import argparse


def mask_union_box(mask_dir: str, margin: int = 20) -> tuple:
    """(x0, y0, x1, y1): the box around every non-zero pixel of the PNG
    masks in ``mask_dir``, grown by ``margin``."""
    import glob
    import os

    import cv2
    import numpy as np

    lo = hi = None
    for p in sorted(glob.glob(os.path.join(mask_dir, "*.png"))):
        ys, xs = np.where(cv2.imread(p, cv2.IMREAD_GRAYSCALE) > 0)
        if ys.size == 0:
            continue
        l, h = np.array([xs.min(), ys.min()]), np.array([xs.max(), ys.max()])
        lo = l if lo is None else np.minimum(lo, l)
        hi = h if hi is None else np.maximum(hi, h)
    return (int(lo[0]) - margin, int(lo[1]) - margin, int(hi[0]) + margin,
            int(hi[1]) + margin)


def crop_video(video: str, out: str, box=None, mask_dir: str | None = None,
               margin: int = 20) -> tuple:
    """Crop ``video`` to ``box`` (or ``mask_union_box(mask_dir, margin)``),
    the box clipped to each frame; returns (box, frames written)."""
    import cv2

    cap = cv2.VideoCapture(video)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30
    if box is None and mask_dir:
        box = mask_union_box(mask_dir, margin)
    assert box is not None, "need --box or --mask_dir"
    x0, y0, x1, y1 = box

    writer = None
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        H, W = frame.shape[:2]
        crop = frame[max(y0, 0):min(y1, H), max(x0, 0):min(x1, W)]
        if writer is None:
            writer = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                     (crop.shape[1], crop.shape[0]))
        writer.write(crop)
        n += 1
    cap.release()
    if writer:
        writer.release()
    return box, n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--box", type=int, nargs=4, default=None)
    ap.add_argument("--mask_dir", default=None)
    ap.add_argument("--margin", type=int, default=20)
    args = ap.parse_args(argv)
    box, n = crop_video(args.video, args.out, args.box, args.mask_dir, args.margin)
    print(f"cropped {n} frames to box {box} -> {args.out}")
    return box, n


if __name__ == "__main__":
    main()
