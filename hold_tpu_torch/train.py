"""Training entry point: python -m hold_tpu_torch.train --case <seq> --no_meshing --no_vis

Counterpart of hold_tpu/train.py on PyTorch: each step runs the error-bound
sampler under ``torch.no_grad()`` (its queries through the fused query
kernel; ``--no_fused_sampler`` queries the trunk layer by layer), then the
render + loss + backward grad stage (each node's shade through the fused
training shade's kernels; ``--no_fused_train`` runs the chunked shade with
its double backward instead, each chunk recomputed in the backward unless
``--no_remat``) and one Adam step.  Adam has the
reference's two learning-rate groups (pose tables at 0.1x lr); the object
scale stays fixed.  Scalars go to
``<log_root>/<exp_key>/metrics.jsonl`` (``utils/logger.py``), and the final
state and model config to ``checkpoints/last.pt``, which
``utils/checkpoint.load_experiment`` reads back for rendering.  Canonical meshing, validation
renders, resume, --load_pose and --shape_init are not ported yet.  It runs on
the card unless asked for the CPU (``--device cpu``, ``device="cpu"``).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .data.dataset import SequenceData
from .models.holdnet import (
    build_scene,
    empty_object_mesh_state,
    holdnet_forward,
    init_scene_params,
    sample_all_z,
    sample_step_draws,
)
from .models.losses import compute_losses
from .utils.config import parse_args, resolve_device
from .utils.convert import flatten_params
from .utils.logger import StepTimer, Tracker
from .utils.metrics import psnr


def optimizer_for(args, params) -> torch.optim.Adam:
    """Adam: pose tables at 0.1x lr (left out with --freeze_pose), every
    other trainable tensor at lr; obj_scale is not trainable."""
    main, pose = [], []
    for path, t in flatten_params(params).items():
        if not t.requires_grad:
            continue
        if "/tables/" in f"/{path}/":
            if not args.get("freeze_pose", False):
                pose.append(t)
        else:
            main.append(t)
    lr = float(args.lr)
    return torch.optim.Adam(
        [{"params": main, "lr": lr}, {"params": pose, "lr": lr * 0.1}], eps=1e-8
    )


def batch_to_device(batch_np: dict, device) -> dict:
    out = {}
    for k, v in batch_np.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device, torch.long if k == "frame_idx" else torch.float32)
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(scene, optimizer, timer: StepTimer | None = None):
    """train_step(params, batch, mesh_state, gen, step, epoch) -> aux dict of
    detached scalars.  ``timer`` (optional) records the 'sampler' and 'grad'
    phases, synchronising the device at their ends."""

    def phase(name, start):
        if timer is not None:
            _sync(scene.device)
            (timer.start if start else timer.stop)(name)

    def train_step(params, batch, mesh_state, gen, step: int, epoch: int) -> dict:
        B, P = batch["uv"].shape[:2]
        phase("sampler", True)
        z_vals = sample_all_z(params, scene, batch, gen, step, epoch)
        phase("sampler", False)
        phase("grad", True)
        draws = sample_step_draws(scene, B, P, gen)
        optimizer.zero_grad(set_to_none=True)
        out = holdnet_forward(params, scene, batch, mesh_state, draws, step, epoch,
                              z_vals_dict=z_vals)
        losses = compute_losses(batch, out, scene.node_ids, step)
        losses["loss"].backward()
        optimizer.step()
        phase("grad", False)
        aux = {k: v.detach() for k, v in losses.items()}
        aux["psnr"] = psnr(out["rgb"].detach(), batch["gt_rgb"])
        return aux

    return train_step


def run_training(args, cfg, seq: SequenceData | None = None, max_steps: int | None = None,
                 device=None):
    """Train for ``max_steps`` (default args.total_step) steps on ``device``
    (default ``args.device``, else the card).  Returns (params, scene,
    mesh_state, tracker, timer)."""
    for flag in ("load_ckpt", "load_pose", "shape_init"):
        if args.get(flag):
            raise NotImplementedError(f"--{flag} is not ported yet")
    if not args.get("no_meshing") or not args.get("no_vis"):
        raise NotImplementedError(
            "canonical meshing and validation renders are not ported yet: "
            "pass --no_meshing --no_vis"
        )
    device = resolve_device(device or args.get("device"))
    if seq is None:
        seq = SequenceData.from_build_dir(args.case, args.data_root, num_sample=args.num_sample)
    opt_model = dict(cfg["model"])
    opt_model["scene_bounding_sphere"] = seq.scene_bounding_sphere
    seed = int(args.get("seed", 0))
    scene = build_scene(opt_model, dict(args), seq.scene_data(), device,
                        fused_sampler=not args.get("no_fused_sampler", False),
                        fused_train=not args.get("no_fused_train", False),
                        remat=not args.get("no_remat", False))
    params = init_scene_params(torch.Generator().manual_seed(seed), scene, seq.scene_data())
    mesh_state = empty_object_mesh_state(device)

    tracker = Tracker(args.log_root, args.get("exp_key", ""), args=args, mute=args.get("mute"))
    log = tracker.logger
    fused = [nid for nid in scene.node_ids if scene.plans[nid].fused_query]
    shade = [nid for nid in scene.node_ids if scene.plans[nid].fused_train]
    log.info(f"experiment {tracker.exp_key}: case={args.case} nodes={scene.node_ids} "
             f"frames={seq.n_frames} device={device} fused sampler={fused} "
             f"fused shade={shade}")

    optimizer = optimizer_for(args, params)
    timer = StepTimer()
    train_step = make_train_step(scene, optimizer, timer)
    batch_size = cfg["dataset"]["train"]["batch_size"]
    steps_per_epoch = max(args.tempo_len // batch_size, 1)
    total_steps = max_steps or args.total_step
    np_rng = np.random.RandomState(seed)
    gen = torch.Generator(device).manual_seed(1234)
    log_every = max(int(args.get("log_every", 1)), 1)

    t_start = time.time()
    for step in range(total_steps):
        epoch = step // steps_per_epoch
        timer.start("data")
        batch_np = seq.sample_tempo_batch(np_rng, batch_size, offset=args.offset,
                                          num_sample=args.num_sample)
        batch = batch_to_device(batch_np, device)
        timer.stop("data")
        aux = train_step(params, batch, mesh_state, gen, step, epoch)
        if step == 0 and total_steps > 1:
            # phase averages leave out the warm-up step
            timer.totals.clear()
            timer.counts.clear()
        if step % log_every == 0 or step == total_steps - 1:
            aux = {k: float(v) for k, v in aux.items()}
            tracker.log_dict(aux, step=step, epoch=epoch)
            log.info(f"step {step} epoch {epoch} loss {aux['loss']:.4f} psnr {aux['psnr']:.2f}")

    ckpt_dir = os.path.join(tracker.log_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save(
        {"params": {k: v.detach().cpu() for k, v in flatten_params(params).items()},
         "optimizer": optimizer.state_dict(), "step": total_steps,
         "model": json.loads(json.dumps(opt_model))},
        os.path.join(ckpt_dir, "last.pt"),
    )
    log.info(f"done: {total_steps} steps in {time.time() - t_start:.1f}s; "
             f"phases: {timer.summary()}")
    return params, scene, mesh_state, tracker, timer


def main():
    args, cfg = parse_args()
    run_training(args, cfg)


if __name__ == "__main__":
    main()
