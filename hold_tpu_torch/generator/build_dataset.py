"""Dataset builder: fitted parameters and frames -> the ``data/<seq>/build``
layout that ``data/dataset.py::SequenceData`` reads (counterpart of
hold_tpu/generator/build_dataset.py; the reference's
generator/scripts/build_dataset.py:139-315 and
generator/src/building/build_utils.py:36-67).

Copies the frames and masks, packs ``data.npy`` (each frame's camera and
the scale matrix that puts every camera centre inside the bounding sphere,
the entities, the scene's bounding sphere, ``normalize_shift``) and writes
``corres.txt``.

    python -m hold_tpu_torch.generator.build_dataset --video in.mp4 --out data/<seq> \\
        --fits fits.npz [--mask_dir masks/] [--skip_every 1] [--max_frames 0]

(the library entry is ``build_from_arrays``).
"""

from __future__ import annotations

import argparse
import os
import os.path as op
import shutil
from glob import glob

import numpy as np


def camera_normalization(w2c_all: np.ndarray, target_radius: float = 3.0):
    """The scale matrix that puts every camera centre inside the bounding
    sphere (build_utils.py:36-67), and its scale."""
    centers = np.stack([-w2c[:3, :3].T @ w2c[:3, 3] for w2c in w2c_all])
    max_r = float(np.linalg.norm(centers, axis=1).max())
    s = target_radius * 0.9 / max(max_r, 1e-9)
    scale_mat = np.eye(4)
    scale_mat[:3, :3] /= s
    return scale_mat, s


def build_from_arrays(
    out_dir: str,
    image_paths: list[str],
    mask_paths: list[str] | None,
    K: np.ndarray,  # (3, 3) shared intrinsics
    w2c_all: np.ndarray,  # (F, 4, 4)
    entities: dict,  # the data.npy entities (entities_from_fits)
    normalize_shift: np.ndarray | None = None,
    scene_bounding_sphere: float = 3.0,
) -> str:
    """Write ``<out_dir>/build``; returns its path."""
    build = op.join(out_dir, "build")
    os.makedirs(op.join(build, "image"), exist_ok=True)
    os.makedirs(op.join(build, "mask"), exist_ok=True)

    K4 = np.eye(4)
    K4[:3, :3] = K
    scale_mat, _ = camera_normalization(w2c_all, scene_bounding_sphere)
    cameras = {}
    for i in range(len(image_paths)):
        cameras[f"world_mat_{i}"] = (K4 @ w2c_all[i]).astype(np.float64)
        cameras[f"scale_mat_{i}"] = scale_mat.astype(np.float64)

    names = []
    for i, p in enumerate(image_paths):
        name = f"{i:04d}.png"
        names.append(name)
        shutil.copy(p, op.join(build, "image", name))
        if mask_paths and mask_paths[i]:
            shutil.copy(mask_paths[i], op.join(build, "mask", name))

    data = {
        "cameras": cameras,
        "entities": entities,
        "scene_bounding_sphere": float(scene_bounding_sphere),
        "normalize_shift": (np.zeros(3, np.float32) if normalize_shift is None
                            else np.asarray(normalize_shift, np.float32)),
    }
    np.save(op.join(build, "data.npy"), data)
    with open(op.join(build, "corres.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return build


def entities_from_fits(
    hand_fits: dict[str, dict],  # hand -> {poses (F,48), betas (10,), transl (F,3)}
    obj_poses: np.ndarray,  # (F, 6) rot_aa + transl
    pts_cano: np.ndarray,
    obj_scale: float,
    norm_mat: np.ndarray | None = None,
) -> dict:
    """The data.npy entities from the generator's fits."""
    entities = {}
    for h, fit in hand_fits.items():
        entities[h] = {
            "mean_shape": np.asarray(fit["betas"], np.float32),
            "hand_poses": np.asarray(fit["poses"], np.float32),
            "hand_trans": np.asarray(fit["transl"], np.float32),
        }
    entities["object"] = {
        "object_poses": np.asarray(obj_poses, np.float32),
        "pts.cano": np.asarray(pts_cano, np.float32),
        "obj_scale": np.float32(obj_scale),
        "norm_mat": (np.eye(4, dtype=np.float32) if norm_mat is None
                     else np.asarray(norm_mat, np.float32)),
    }
    return entities


def init_dataset_from_video(video_path: str, out_dir: str, skip_every: int = 1,
                            max_frames: int = 0) -> list[str]:
    """A video's frames (every ``skip_every``-th, at most ``max_frames`` when
    > 0) as ``<out_dir>/NNNN.png`` (generator/scripts/init_dataset.py)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    paths = []
    i = kept = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % max(skip_every, 1) == 0:
            p = op.join(out_dir, f"{kept:04d}.png")
            cv2.imwrite(p, frame)
            paths.append(p)
            kept += 1
            if max_frames and kept >= max_frames:
                break
        i += 1
    cap.release()
    return paths


def merge_entity_masks(mask_dirs: dict[str, str], out_dir: str) -> list[str]:
    """Per-entity binary masks merged into one mask coded by SEGM_IDS
    ({0, 50, 150, 250}; generator/scripts/validate_masks.py:13-100), the
    later entity winning where two overlap.  The first entity's folder
    names the frames."""
    import cv2

    from ..models.specs import SEGM_IDS

    os.makedirs(out_dir, exist_ok=True)
    out_paths = []
    for p in sorted(glob(op.join(next(iter(mask_dirs.values())), "*.png"))):
        name = op.basename(p)
        merged = None
        for nid, d in mask_dirs.items():
            m = cv2.imread(op.join(d, name), cv2.IMREAD_GRAYSCALE)
            if m is None:
                continue
            if merged is None:
                merged = np.zeros_like(m)
            merged[m > 127] = SEGM_IDS[nid]
        out_p = op.join(out_dir, name)
        cv2.imwrite(out_p, merged)
        out_paths.append(out_p)
    return out_paths


def main(argv=None):
    """Video + fits -> build: the frames from ``--video``, masks merged from
    ``--mask_dir`` (one folder per entity: ``<mask_dir>/<right|left|object>``)
    when given, the fits from an npz (K (3,3), w2c (F,4,4), obj_poses (F,6),
    pts_cano (N,3), obj_scale, and for each hand ``<hand>_poses`` (F,48),
    ``<hand>_betas`` (10,), ``<hand>_transl`` (F,3))."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", required=True)
    ap.add_argument("--out", required=True, help="data/<seq>")
    ap.add_argument("--fits", required=True, help="npz of the fitted parameters")
    ap.add_argument("--mask_dir", default=None)
    ap.add_argument("--skip_every", type=int, default=1)
    ap.add_argument("--max_frames", type=int, default=0)
    args = ap.parse_args(argv)

    frames = init_dataset_from_video(args.video, op.join(args.out, "frames"),
                                     args.skip_every, args.max_frames)
    masks = None
    if args.mask_dir:
        dirs = {nid: op.join(args.mask_dir, nid) for nid in ("right", "left", "object")
                if op.isdir(op.join(args.mask_dir, nid))}
        masks = merge_entity_masks(dirs, op.join(args.out, "masks"))
    fits = np.load(args.fits, allow_pickle=True)
    hands = {h: {"poses": fits[f"{h}_poses"], "betas": fits[f"{h}_betas"],
                 "transl": fits[f"{h}_transl"]}
             for h in ("right", "left") if f"{h}_poses" in fits}
    entities = entities_from_fits(hands, fits["obj_poses"], fits["pts_cano"],
                                  float(fits["obj_scale"]))
    build = build_from_arrays(args.out, frames, masks, fits["K"], fits["w2c"], entities)
    print(f"wrote {build} ({len(frames)} frames)")
    return build


if __name__ == "__main__":
    main()
