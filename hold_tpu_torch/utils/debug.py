"""Debug dumps: canonical/deformed sample exports, 2D reprojection overlays,
a dataset-info snapshot and a profiler trace (counterpart of
hold_tpu/utils/debug.py).

Role parity with code/src/utils/debug.py:17-177 (--debug gated): per-node
point-set OBJ exports and world->pixel overlays for sanity-checking poses and
cameras.  All of it is written on the host; ``capture_profile`` traces the
device with ``torch.profiler`` (a Chrome trace).
"""

from __future__ import annotations

import os

import numpy as np


def _host(x) -> np.ndarray:
    import torch

    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def debug_world2pix(out_dir: str, verts_world: np.ndarray, img: np.ndarray,
                    K: np.ndarray, w2c: np.ndarray, name: str, idx: int):
    """Project entity verts into the frame and save an overlay PNG."""
    import cv2

    verts_world = _host(verts_world)
    v_cam = verts_world @ w2c[:3, :3].T + w2c[:3, 3]
    z = np.maximum(v_cam[:, 2], 1e-6)
    u = (v_cam[:, 0] * K[0, 0] / z + K[0, 2]).astype(np.int32)
    v = (v_cam[:, 1] * K[1, 1] / z + K[1, 2]).astype(np.int32)
    canvas = (np.clip(img, 0, 1) * 255).astype(np.uint8).copy()
    H, W = canvas.shape[:2]
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    canvas[v[ok], u[ok]] = (255, 0, 0)
    os.makedirs(out_dir, exist_ok=True)
    out_p = os.path.join(out_dir, f"reproj_{name}_{idx:04d}.png")
    cv2.imwrite(out_p, canvas[:, :, ::-1])
    return out_p


def debug_deformer(out_dir: str, scene, params, sample_dicts: dict, step: int):
    """Export per-node deformed + canonical sample clouds as OBJ point sets
    (debug.py:debug_deformer role)."""
    from .mesh import save_obj

    os.makedirs(out_dir, exist_ok=True)
    for nid, sd in sample_dicts.items():
        cano = _host(sd["canonical_pts"]).reshape(-1, 3)
        sub = cano[:: max(len(cano) // 5000, 1)]
        save_obj(
            os.path.join(out_dir, f"cano_pts_{nid}_{step}.obj"),
            sub, np.zeros((0, 3), np.int64),
        )
        if "verts_posed" in sd:
            v = _host(sd["verts_posed"])[0]
            save_obj(
                os.path.join(out_dir, f"posed_verts_{nid}_{step}.obj"),
                v, np.zeros((0, 3), np.int64),
            )


def dump_dataset_info(out_dir: str, seq) -> str:
    """Dataset-info snapshot (image_dataset.py:40-56 role)."""
    os.makedirs(out_dir, exist_ok=True)
    out_p = os.path.join(out_dir, "dataset_info.npy")
    np.save(out_p, {
        "intrinsics_all": seq.intrinsics_all,
        "extrinsics_all": seq.extrinsics_all,
        "img_paths": seq.img_paths,
        "mask_paths": seq.mask_paths,
        "img_size": seq.img_size,
        "n_frames": seq.n_frames,
        "scale": seq.scale,
    })
    return out_p


def capture_profile(log_dir: str, fn, *args, steps: int = 3):
    """A ``torch.profiler`` trace (CPU and, when there is one, the card)
    around ``steps`` calls of ``fn``, written as a Chrome trace to
    ``<log_dir>/profile/trace.json``; returns the trace dir."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(log_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(steps):
            fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return trace_dir
