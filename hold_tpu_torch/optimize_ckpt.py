"""Pose-refinement entry point:

    python -m hold_tpu_torch.optimize_ckpt --exp <logs/key> --case <seq> [--device cuda|cpu]

Counterpart of hold_tpu/optimize_ckpt.py, with its flags (the reference's
code/optimize_ckpt.py:10-140):
- stage 1: optimise object scale + hand betas on a linspace frame subsample
- stage 2: per-batch refinement of all frames (translations + object
  orientation; scale/shape frozen)
- writes the refined tables into a new checkpoint at step 999,000,000, which
  sorts after the training checkpoints (``last.pt`` points at it).  It
  carries the source checkpoint's model config, so that ``evaluate`` and
  ``visualize_ckpt`` rebuild the scene from it, and no optimizer state.

The fits run on the card unless ``--device cpu`` is given; the masks are
scaled and the fit-visualisation GIFs written on the host.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .fitting.diagnostics import FitRecorder
from .fitting.fit import (
    FittingProblem,
    build_fit_params,
    load_contact_idx,
    run_fit,
)
from .utils.checkpoint import latest_checkpoint, read_checkpoint, save_checkpoint
from .utils.convert import flatten_params
from .utils.mesh import decimate_mesh

STEP_TAG = 999_000_000  # pose_ref marker, sorts after training checkpoints


def to_host(tree):
    """Nested dicts of tensors -> the same of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def scale_masks_K(masks: np.ndarray, K: np.ndarray, target_dim: int = 300):
    """Downscale masks to ~target_dim on the longer side + rescale K
    (fitting/utils.py scaling_masks_K role)."""
    import cv2

    H, W = masks.shape[1:]
    s = target_dim / max(H, W)
    newsize = (max(int(W * s), 1), max(int(H * s), 1))
    out = np.stack(
        [
            cv2.resize(m.astype(np.uint8), newsize, interpolation=cv2.INTER_NEAREST)
            for m in masks
        ]
    )
    K2 = np.asarray(K, np.float64).copy()
    K2[0] *= newsize[0] / W
    K2[1] *= newsize[1] / H
    return out, K2[:3, :3], (newsize[1], newsize[0])


def entity_masks(raw_masks: np.ndarray, node_ids) -> dict:
    from .models.specs import SEGM_IDS

    out = {}
    for nid in node_ids:
        sid = SEGM_IDS[nid]
        out[nid] = (np.abs(raw_masks.astype(np.int32) - sid) < 25).astype(
            np.float32
        )
    return out


def load_fitting_inputs(exp_dir: str, seq, device, target_faces=5000,
                        ckpt: str | None = None):
    """Checkpoint + misc -> servers, faces, tables (io/optim.py role, incl.
    decimating the canonical object mesh for the silhouette render,
    io/optim.py:92-109).  ``ckpt`` pins a checkpoint (the reference's
    explicit --ckpt_p); the default is the experiment's newest, so a rerun
    after a refinement (whose step_999000000 sorts last) must pass it."""
    from .eval.io_pred import load_experiment
    from .models.object_model import build_object_server

    params, misc, scene = load_experiment(exp_dir, seq, device, ckpt=ckpt)
    tables = {nid: to_host(params[nid]["tables"]) for nid in scene.node_ids}
    obj_scale = float(params["object"]["obj_scale"])

    servers = {}
    faces = {}
    for nid in scene.node_ids:
        if nid in ("right", "left"):
            servers[nid] = scene.servers[nid]
            faces[nid] = np.asarray(scene.servers[nid].consts.faces)
        else:
            mesh_cano = misc.get("meshes_cano", {}).get("object")
            if mesh_cano is not None:
                m = decimate_mesh(
                    mesh_cano["vertices"], mesh_cano["faces"], target_faces
                )
                servers[nid] = build_object_server(m.vertices, obj_scale, np.eye(4), device)
                faces[nid] = m.faces
            else:
                servers[nid] = scene.servers[nid]
                # point cloud only: render as tiny degenerate triangles
                v = scene.servers[nid].v3d_cano
                faces[nid] = np.tile(
                    np.arange(min(len(v), 2000))[:, None], (1, 3)
                )
    return params, tables, servers, faces, obj_scale, scene


def refine(args):
    """Stages 1 and 2, then the refined checkpoint; returns its path."""
    from .data.dataset import SequenceData
    from .utils.config import resolve_device

    device = resolve_device(getattr(args, "device", None))
    seq = SequenceData.from_build_dir(args.case, args.data_root)
    src_ckpt = args.ckpt or latest_checkpoint(args.exp)
    params, tables, servers, faces, obj_scale, scene = load_fitting_inputs(
        args.exp, seq, device, ckpt=src_ckpt
    )
    n_frames = seq.n_frames
    contact_idx = load_contact_idx()

    # per-frame w2c from the decomposed cameras (extrinsics = c2w)
    w2c_all = np.stack(
        [np.linalg.inv(e) for e in seq.extrinsics_all]
    ).astype(np.float32)

    raw_masks = np.stack([seq.load_frame(i)[1] for i in range(n_frames)])
    masks_scaled, K_scaled, imsize = scale_masks_K(
        raw_masks, seq.intrinsics_all[0][:3, :3], args.target_dim
    )
    targets_all = entity_masks(masks_scaled, scene.node_ids)

    def make_problem(frame_idx):
        return FittingProblem(
            servers, faces,
            {k: v[frame_idx] for k, v in targets_all.items()},
            w2c_all[frame_idx], K_scaled, seq.scale, imsize, contact_idx,
            contact_thres=args.contact_thres,
        )

    # ---- stage 1: scale + shape on a linspace subsample -------------------
    vis_dir = os.path.join(args.exp, "fit_vis")
    no_vis = bool(getattr(args, "no_vis", False))
    if args.freeze_scale and args.freeze_shape:
        # Stage 1 exists to fix bad SfM scale / shape inits.  On a
        # well-registered init its only signal is proxy-model error (the
        # decimated render under-fills the target mask, so the fit inflates
        # obj_scale along the scale<->depth valley with a genuinely
        # improving loss, which the guard cannot see).  With both frozen
        # the stage is a no-op.
        print("Stage [1/2]: SKIPPED (--freeze_scale --freeze_shape)")
        final_obj_scale = float(obj_scale)
        betas_new = {}
    else:
        print("Stage [1/2]: optimizing object scale and hand shape")
        sub = np.linspace(
            0, n_frames - 1, min(args.batch_size, n_frames)
        ).astype(int)
        prob1 = make_problem(sub)
        rec1 = None if no_vis else FitRecorder(
            prob1, every=max(args.iters // 12, 1)
        )
        p = build_fit_params(tables, scene.node_ids, obj_scale, sub, device)
        p, hist, improved, guard = run_fit(
            prob1, p, freeze_scale=args.freeze_scale,
            freeze_shape=args.freeze_shape,
            num_iterations=args.iters, verbose=True, callback=rec1,
        )
        if not improved:
            print("Stage [1/2]: hard-IoU did not improve "
                  f"({guard['iou_init']:.4f} -> {guard['iou_final']:.4f}) — "
                  "keeping input scale/shape (do-no-harm)")
        if rec1 is not None and rec1.save(os.path.join(vis_dir, "stage1.gif")):
            print(f"stage-1 fitting diagnostics -> {vis_dir}/stage1.gif")
        final_obj_scale = float(p["obj_scale"])
        print(f"Stage [1/2] done: obj_scale {obj_scale:.4f} -> "
              f"{final_obj_scale:.4f}")
        betas_new = {
            nid: p[nid]["betas"].cpu().numpy() for nid in scene.node_ids
            if nid in ("right", "left")
        }

    # ---- stage 2: per-batch refinement of every frame ---------------------
    print("Stage [2/2]: refining all frames")
    new_tables = {nid: {k: np.array(v) for k, v in t.items()}
                  for nid, t in tables.items()}
    for nid, b in betas_new.items():
        new_tables[nid]["betas"] = b
    for start in range(0, n_frames, args.batch_size):
        idx = np.arange(start, min(start + args.batch_size, n_frames))
        prob2 = make_problem(idx)
        rec2 = None if no_vis else FitRecorder(
            prob2, every=max(args.iters // 6, 1)
        )

        def heartbeat(i, fit_p, loss_v, _rec=rec2, _n=args.iters):
            # liveness: one line per 50 iterations (a batch's summary alone
            # can come after many minutes)
            if i % 50 == 0:
                print(f"  fit iter {i}/{_n}: loss {loss_v:.4f}")
            if _rec is not None:
                _rec(i, fit_p, loss_v)

        p = build_fit_params(new_tables, scene.node_ids, final_obj_scale, idx, device)
        p, hist, improved, guard = run_fit(
            prob2, p, freeze_scale=True, freeze_shape=True,
            num_iterations=args.iters, callback=heartbeat,
        )
        if rec2 is not None:
            rec2.save(os.path.join(vis_dir, f"stage2_{idx[0]:04d}.gif"))
        if improved:
            for nid in scene.node_ids:
                for k in ("transl", "global_orient"):
                    if k in p[nid]:
                        if nid in ("right", "left") and k == "global_orient":
                            continue  # frozen for hands
                        new_tables[nid][k][idx] = p[nid][k].cpu().numpy()
        print(f"  frames {idx[0]}-{idx[-1]}: loss {hist[0]:.4f} -> "
              f"{hist[-1]:.4f}, IoU {guard['iou_init']:.4f} -> "
              f"{guard['iou_final']:.4f} "
              f"({'kept' if improved else 'REJECTED, do-no-harm'})")

    # ---- write back -------------------------------------------------------
    src = read_checkpoint(src_ckpt)
    out_params = {k: v.detach().cpu() for k, v in flatten_params(params).items()}
    for nid in scene.node_ids:
        for k, v in new_tables[nid].items():
            out_params[f"{nid}/tables/{k}"] = torch.as_tensor(np.asarray(v, np.float32))
    out_params["object/obj_scale"] = torch.tensor(final_obj_scale, dtype=torch.float32)
    path = save_checkpoint(args.exp, STEP_TAG, {
        "params": out_params, "optimizer": None, "step": STEP_TAG, "model": src["model"]})
    print(f"saved refined checkpoint to {path}")
    return path


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", required=True)
    ap.add_argument("--case", required=True)
    ap.add_argument("--data_root", default="./data")
    ap.add_argument("--batch_size", type=int, default=10)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--target_dim", type=int, default=300)
    ap.add_argument("--inspect_idx", type=int, default=None)
    ap.add_argument("--freeze_scale", action="store_true",
                    help="keep obj_scale at its input value in stage 1 "
                         "(use when the SfM scale is already trusted)")
    ap.add_argument("--freeze_shape", action="store_true",
                    help="keep hand betas at their input values in stage 1")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint to refine (default: newest under "
                         "--exp; pass the last TRAINING step to rerun "
                         "refinement after a previous step_999000000)")
    ap.add_argument("--contact_thres", type=float, default=0.0,
                    help="deadzone (scene units) for the single-hand contact"
                         " pull; 0 = reference parity (fitting/loss.py:92)")
    ap.add_argument("--no_vis", action="store_true",
                    help="skip fitting-diagnostic GIFs (fit_vis/)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    import sys

    # progress must reach a log in real time: block-buffered stdout looks
    # like a hang to whatever watches the log
    if hasattr(sys.stdout, "reconfigure"):
        sys.stdout.reconfigure(line_buffering=True)
    return refine(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
