"""Training entry point: python -m hold_tpu_torch.train --case <seq> --no_vis

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
``utils/checkpoint.load_experiment`` reads back for rendering.  Every third
epoch (unless ``--no_meshing``) the nodes' canonical meshes are extracted on
a worker thread from a copy of the parameters, written to
``mesh_cano/mesh_cano_<node>_step_<step>.obj`` and ``misc/<step>.npy``, and
the object's mesh state (its sparse and eikonal terms) is adopted at the
next step boundary.  Validation renders, resume, --load_pose and
--shape_init are not ported yet.  It runs on the card unless asked for the
CPU (``--device cpu``, ``device="cpu"``).
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .data.dataset import SequenceData
from .meshing.cano import mesh_all_cano
from .models.holdnet import (
    build_scene,
    empty_object_mesh_state,
    holdnet_forward,
    init_scene_params,
    object_mesh_state_from_mesh,
    sample_all_z,
    sample_step_draws,
)
from .models.losses import compute_losses
from .utils.checkpoint import save_misc
from .utils.config import parse_args, resolve_device
from .utils.convert import detached_copy, flatten_params
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


def meshing_snapshot(params, scene) -> dict:
    """What canonical meshing reads, copied: each node's implicit net and the
    object's scale.  Adam updates the live tensors in place, so a meshing
    that runs beside training must read a copy made at a step boundary."""
    snap = {nid: {"implicit": detached_copy(params[nid]["implicit"])} for nid in scene.node_ids}
    if "object" in snap:
        snap["object"]["obj_scale"] = params["object"]["obj_scale"].detach().clone()
    return snap


def run_meshing(snapshot, scene, seq, log_dir: str, step: int, res_scale: int = 1) -> dict:
    """Mesh every node of ``snapshot`` (``meshing_snapshot``) and write the
    meshes (``mesh_cano/mesh_cano_<node>_step_<step>.obj``) and the misc
    sidecar (``misc/<step>.npy``: camera, scale, image paths, the object's
    scale, the meshes).  Returns {node: Mesh}."""
    meshes = mesh_all_cano(snapshot, scene, res_scale=res_scale)
    for nid, m in meshes.items():
        out_p = os.path.join(log_dir, "mesh_cano", f"mesh_cano_{nid}_step_{step}.obj")
        os.makedirs(os.path.dirname(out_p), exist_ok=True)
        m.export(out_p)
    save_misc(log_dir, step, {
        "K": seq.intrinsics_all[0],
        "w2c": np.linalg.inv(seq.extrinsics_all[0]),
        "scale": seq.scale,
        "img_paths": seq.img_paths,
        "object.obj_scale": (float(snapshot["object"]["obj_scale"]) if "object" in snapshot
                             else 1.0),
        "meshes_cano": {nid: {"vertices": m.vertices, "faces": m.faces}
                        for nid, m in meshes.items()},
    })
    return meshes


def run_training(args, cfg, seq: SequenceData | None = None, max_steps: int | None = None,
                 device=None):
    """Train for ``max_steps`` (default args.total_step) steps on ``device``
    (default ``args.device``, else the card).  Returns (params, scene,
    mesh_state, tracker, timer).

    Meshing (unless ``args.no_meshing``) runs at every third epoch boundary
    on one worker thread; the object's new mesh state is adopted at the
    first step boundary after it ends.  A boundary reached while a meshing
    runs queues its snapshot, replacing an older queued one; at the end the
    running meshing and then the queued one are waited for and adopted.
    ``args.fast_dev_run`` meshes at every epoch boundary, at once, at a
    quarter of the resolutions.  A meshing that fails is logged and leaves
    the state as it was, as in the reference: it never ends training."""
    for flag in ("load_ckpt", "load_pose", "shape_init"):
        if args.get(flag):
            raise NotImplementedError(f"--{flag} is not ported yet")
    if not args.get("no_vis"):
        raise NotImplementedError("validation renders are not ported yet: pass --no_vis")
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

    meshing = not args.get("no_meshing", False)
    sync_meshing = bool(args.get("fast_dev_run", False))
    res_scale = 4 if sync_meshing else 1
    mesher = ThreadPoolExecutor(max_workers=1)
    mesh_future, pending = None, None

    def adopt(get_meshes, state):
        try:
            m = get_meshes().get("object")
            if m is not None:
                state = object_mesh_state_from_mesh(m.vertices, m.faces, device)
                log.info(f"object mesh state from {m.vertices.shape[0]} verts, "
                         f"{m.faces.shape[0]} faces: valid {float(state['valid']):.0f}")
        except Exception as e:  # meshing must never kill training (hold_tpu/train.py:362)
            log.warning(f"meshing failed: {e}")
        return state

    def mesh_at(snap):
        snapshot, at_step = snap
        return run_meshing(snapshot, scene, seq, tracker.log_dir, at_step, res_scale)

    t_start = time.time()
    try:
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
                log.info(f"step {step} epoch {epoch} loss {aux['loss']:.4f} "
                         f"psnr {aux['psnr']:.2f}")

            done = step + 1
            if mesh_future is not None and mesh_future.done():
                timer.start("meshing")
                mesh_state = adopt(mesh_future.result, mesh_state)
                mesh_future = None
                if pending is not None:
                    mesh_future, pending = mesher.submit(mesh_at, pending), None
                timer.stop("meshing")
            ep = done // steps_per_epoch
            if meshing and done % steps_per_epoch == 0 and (ep % 3 == 0 or sync_meshing):
                timer.start("meshing")
                snap = (meshing_snapshot(params, scene), done)
                if sync_meshing:
                    mesh_state = adopt(lambda: mesh_at(snap), mesh_state)
                elif mesh_future is None:
                    mesh_future = mesher.submit(mesh_at, snap)
                else:
                    pending = snap
                    log.warning(f"meshing still running at epoch {ep}; queued the snapshot of "
                                f"step {done} in place of any queued before")
                timer.stop("meshing")
        # at the end: the meshing in flight, then the snapshot queued behind it
        if mesh_future is not None:
            mesh_state = adopt(mesh_future.result, mesh_state)
        if pending is not None:
            mesh_state = adopt(lambda: mesh_at(pending), mesh_state)
    finally:
        mesher.shutdown(wait=True)

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
