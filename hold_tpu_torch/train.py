"""Training entry point: python -m hold_tpu_torch.train --case <seq> [flags]

Counterpart of hold_tpu/train.py on PyTorch: each step runs the error-bound
sampler under ``torch.no_grad()`` (its queries through the fused query
kernel), then the render + loss + backward grad stage (each node's shade
through the fused training shade's kernels) and one Adam step; a node whose
nets the kernels do not take queries its trunk layer by layer and shades
chunk by chunk (``models/holdnet.py build_scene``).  Adam has the reference's two
learning-rate groups (pose tables at 0.1x lr) and, for the proposal nets, a
third at ``model.proposal.lr``; the object scale stays fixed.  The proposal
nets (on unless ``--no_proposal``) learn the trunk's sdf from the first step
(``loss/proposal``), and from step ``model.proposal.warmup`` the sampler
queries them in place of the trunk.  ``--node_bounds``,
``--sampler_knn_stride N`` and ``--sampler_relu`` are the sampler's knobs
(``models/holdnet.py build_scene``).  The next batch is drawn on a worker
thread while a step runs.  Scalars go to
``<log_root>/<exp_key>/metrics.jsonl`` (``utils/logger.py``).  Every
``--eval_every_epoch``-th epoch and at the end the parameters, Adam's state,
the step and the model config go to ``checkpoints/step_<step>.pt`` with
``last.pt`` pointing at it (``utils/checkpoint.py``), and, unless
``--no_vis``, one frame is rendered (``val/psnr``,
``visuals/val_<frame>_<step>.png``).  A run whose experiment already holds a
checkpoint resumes from it; ``--load_ckpt`` starts from another run's
parameters at step 0, ``--load_pose`` takes its pose tables and
``--shape_init`` the hands' implicit nets of the newest checkpoint of
``<log_root>/<shape_init>``.  Every third epoch (unless ``--no_meshing``)
the nodes' canonical meshes are extracted on a worker thread from a copy of
the parameters, written to ``mesh_cano/mesh_cano_<node>_step_<step>.obj``
and ``misc/<step>.npy``, and the object's mesh state (its sparse and eikonal
terms) is adopted at the next step boundary.  ``-f`` shortens the sampler
(16 / 32 / 8 samples, 2 rounds) and meshes at once.  It runs on the card
unless asked for the CPU (``--device cpu``, ``device="cpu"``).

Over several processes (``--num_devices N``: N local processes, one a card,
NCCL; with ``--device cpu`` N gloo processes on the CPU; or
``--coordinator host:port --num_processes N --process_id R`` for one
process of a run over several hosts) the run is the same run as in one
process: every rank starts from the same parameters and Adam state (rank
0's, broadcast), draws the same global batch and keeps its slice of each
frame's rays (``parallel/sharding.py``), and the gradients are averaged
over the ranks before Adam's step.  Only rank 0 writes checkpoints, logs,
validation images and meshes; it meshes, and its object mesh state is
broadcast to every rank at the step boundary where rank 0 adopts it.  A
validation frame's render chunks are split over the ranks.
"""

from __future__ import annotations

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
from .parallel.sharding import (
    RankDraws,
    average_gradients,
    current_split,
    init_distributed,
    launch,
    local_device,
    local_process_count,
    rank_devices,
    shard_batch,
    split_chunk_renderer,
)
from .render.renderer import make_chunk_renderer, outputs_to_panel, render_frame
from .utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    load_optimizer_state,
    load_params_subset,
    save_checkpoint,
    save_misc,
    training_state,
)
from .utils.config import parse_args, resolve_device, sampler_flags
from .utils.convert import detached_copy, flatten_params
from .utils.logger import Tracker, make_exp_key
from .utils.metrics import psnr, psnr_from_mse
from .utils.tracing import StepTimer, span, stage


# ``-f`` (fast dev run): the sampler's samples a ray and rounds
FAST_SAMPLER = {"N_samples": 16, "N_samples_eval": 32, "N_samples_extra": 8,
                "max_total_iters": 2}


def pose_subset(path: tuple) -> bool:
    """``--load_pose``: the pose tables and the object's scale."""
    return "tables" in path or path[-1:] == ("obj_scale",)


def hand_shape_subset(path: tuple) -> bool:
    """``--shape_init``: the hands' implicit nets."""
    return len(path) >= 2 and path[0] in ("right", "left") and path[1] == "implicit"


def prefetch_batches(seq, rng: np.random.RandomState, batch_size: int, offset: int,
                     num_sample: int):
    """``seq.sample_tempo_batch(rng, ...)`` batches in the order of the
    draws, each drawn on a worker thread while the caller works on the one
    before (numpy only: the thread touches no device).  The thread owns
    ``rng`` until the generator is closed."""
    def draw():
        return seq.sample_tempo_batch(rng, batch_size, offset=offset, num_sample=num_sample)

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(draw)
        while True:
            batch = pending.result()
            pending = pool.submit(draw)
            yield batch


def optimizer_for(args, params, proposal_lr: float = 1e-3) -> torch.optim.Adam:
    """Adam: pose tables at 0.1x lr (left out with --freeze_pose), every
    other trainable tensor at lr; obj_scale is not trainable.  The proposal
    nets, when the scene has them, are a third group at ``proposal_lr``
    (``model.proposal.lr``), trained under --freeze_pose too."""
    main, pose, proposal = [], [], []
    for path, t in flatten_params(params).items():
        if not t.requires_grad:
            continue
        keys = path.split("/")
        if "proposal" in keys:
            proposal.append(t)
        elif "tables" in keys:
            if not args.get("freeze_pose", False):
                pose.append(t)
        else:
            main.append(t)
    lr = float(args.lr)
    groups = [{"params": main, "lr": lr}, {"params": pose, "lr": lr * 0.1}]
    if proposal:
        groups.append({"params": proposal, "lr": float(proposal_lr)})
    return torch.optim.Adam(groups, eps=1e-8)


def proposal_schedule(scene) -> int | None:
    """The step from which the sampler queries the proposal nets
    (``model.proposal.warmup``), or None when the scene has none."""
    if not any(scene.plans[nid].proposal is not None for nid in scene.node_ids):
        return None
    return int(scene.opt_model.get("proposal", {}).get("warmup", 1000))


def batch_to_device(batch_np: dict, device) -> dict:
    out = {}
    for k, v in batch_np.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device, torch.long if k == "frame_idx" else torch.float32)
    return out


def make_train_step(scene, optimizer, timer: StepTimer | None = None, split=None):
    """train_step(params, batch, mesh_state, gen, step, epoch) -> aux dict of
    detached scalars.  Its stages are the spans ``hold.sampler`` and
    ``hold.grad`` (``utils/tracing.py``); ``timer`` (optional) records them
    as the phases 'sampler' and 'grad', by events on the device's stream.
    With ``split`` (a ``parallel.sharding.RaySplit``) ``batch`` is this
    rank's slice, the per-ray draws are sliced from every rank's, the
    gradients are averaged over the ranks before Adam's step and the scalars
    are the ranks' mean (the psnr that of the mean squared error).  From the
    proposal's warmup step on (``proposal_schedule``) the sampler runs in
    proposal mode."""
    trained = [p for group in optimizer.param_groups for p in group["params"]]
    warmup = proposal_schedule(scene)

    def train_step(params, batch, mesh_state, gen, step: int, epoch: int) -> dict:
        B, P = batch["uv"].shape[:2]
        if split is not None:
            gen = RankDraws(gen, split.rank, split.world, B)
        with stage("sampler", timer, scene.device):
            z_vals = sample_all_z(params, scene, batch, gen, step, epoch,
                                  proposal_mode=warmup is not None and step >= warmup)
        with stage("grad", timer, scene.device):
            draws = sample_step_draws(scene, B, P, gen)
            optimizer.zero_grad(set_to_none=True)
            out = holdnet_forward(params, scene, batch, mesh_state, draws, step, epoch,
                                  z_vals_dict=z_vals)
            with span("hold.losses"):
                losses = compute_losses(batch, out, scene.node_ids, step, split)
            with span("hold.backward"):
                losses["loss"].backward()
            if split is not None:
                average_gradients(trained, split)
            with span("hold.adam"):
                optimizer.step()
        aux = {k: v.detach() for k, v in losses.items()}
        if split is None:
            aux["psnr"] = psnr(out["rgb"].detach(), batch["gt_rgb"])
            return aux
        aux["mse"] = torch.mean((out["rgb"].detach() - batch["gt_rgb"]) ** 2)
        aux = split.mean_of(aux)
        aux["psnr"] = psnr_from_mse(aux.pop("mse"))
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
    """Train until step ``max_steps`` (default args.total_step) on ``device``
    (default ``args.device``, else the card).  Returns (params, scene,
    mesh_state, tracker, timer, optimizer).

    A run whose experiment (``<log_root>/<exp_key>``) holds a checkpoint
    resumes from it: the parameters, Adam's state when the checkpoint has
    one that fits (else the parameters alone) and the step; the batch and
    sampler streams start afresh, as in the reference.  Checkpoints and
    validation renders (unless ``args.no_vis``) come at every
    ``eval_every_epoch``-th epoch boundary and the last one; a final
    checkpoint at the end unless that step was just saved.  A validation
    that fails is logged and training goes on, as in the reference.

    Meshing (unless ``args.no_meshing``) runs at every third epoch boundary
    on one worker thread; the object's new mesh state is adopted at the
    first step boundary after it ends.  A boundary reached while a meshing
    runs queues its snapshot, replacing an older queued one; at the end the
    running meshing and then the queued one are waited for and adopted.
    ``args.fast_dev_run`` meshes at every epoch boundary, at once, at a
    quarter of the resolutions.  A meshing that fails is logged and leaves
    the state as it was, as in the reference: it never ends training.

    In a process group (``parallel.sharding``) every rank calls it alike
    and trains its share of the rays; rank 0 alone writes, meshes and logs
    (the module's docstring)."""
    device = resolve_device(device or args.get("device"))
    split = current_split(device)
    rank0 = split is None or split.rank == 0
    if seq is None:
        seq = SequenceData.from_build_dir(args.case, args.data_root, num_sample=args.num_sample)
    opt_model = dict(cfg["model"])
    opt_model["scene_bounding_sphere"] = seq.scene_bounding_sphere
    fast = bool(args.get("fast_dev_run", False))
    if fast:
        opt_model["ray_sampler"] = dict(opt_model["ray_sampler"], **FAST_SAMPLER)
    seed = int(args.get("seed", 0))
    scene = build_scene(opt_model, dict(args), seq.scene_data(), device, **sampler_flags(args))
    params = init_scene_params(torch.Generator().manual_seed(seed), scene, seq.scene_data())
    mesh_state = empty_object_mesh_state(device)

    exp_key = args.get("exp_key", "")
    if split is not None and not exp_key:  # one experiment: rank 0's key
        exp_key = split.broadcast_object(make_exp_key())
    tracker = Tracker(args.log_root, exp_key, args=args, mute=args.get("mute"), active=rank0)
    log = tracker.logger
    fused = [nid for nid in scene.node_ids if scene.plans[nid].fused_query]
    shade = [nid for nid in scene.node_ids if scene.plans[nid].fused_shade]
    warmup = proposal_schedule(scene)
    log.info(f"experiment {tracker.exp_key}: case={args.case} nodes={scene.node_ids} "
             f"frames={seq.n_frames} device={device} fused sampler={fused} "
             f"fused shade={shade} proposal="
             + ("off" if warmup is None else f"from step {warmup}")
             + (f" ranks={split.world} ({torch.distributed.get_backend()})"
                if split is not None else ""))

    start_step, opt_state, resumed = 0, None, False
    if args.get("load_ckpt"):
        params = load_checkpoint(args.load_ckpt, {"params": params})["params"]
        log.info(f"loaded weights from {args.load_ckpt}")
    else:
        last = latest_checkpoint(tracker.log_dir)
        if last:
            state = load_checkpoint(last, {"params": params, "optimizer": None, "step": 0})
            params, opt_state, start_step = state["params"], state["optimizer"], state["step"]
            resumed = True
            log.info(f"resuming from {last} at step {start_step}")
    if args.get("load_pose") and start_step == 0:
        params = load_params_subset(args.load_pose, params, pose_subset)
        log.info(f"loaded pose tables from {args.load_pose}")
    elif args.get("load_pose"):
        # the resumed tables already hold the pose init and its training
        log.info(f"resume at step {start_step}: NOT re-applying --load_pose")
    if args.get("shape_init"):
        src = latest_checkpoint(os.path.join(args.log_root, args.shape_init))
        if src:
            params = load_params_subset(src, params, hand_shape_subset)
            log.info(f"hand shape init from {src}")
        else:
            log.warning(f"--shape_init {args.shape_init}: no checkpoint found")

    optimizer = optimizer_for(args, params,
                              float(opt_model.get("proposal", {}).get("lr", 1e-3)))
    if opt_state is not None:
        try:
            # a checkpoint without the proposal's group leaves it fresh
            load_optimizer_state(optimizer, opt_state)
        except ValueError as e:  # another parameter set: the parameters alone
            log.warning(f"optimizer state not restored ({e}); resuming the parameters only")
    if split is not None:  # every rank loaded the same files; rank 0's state is the run's
        split.broadcast_tensors_(replicated_state(params, optimizer))
    timer = StepTimer()
    train_step = make_train_step(scene, optimizer, timer, split)
    batch_size = cfg["dataset"]["train"]["batch_size"]
    steps_per_epoch = max(args.tempo_len // batch_size, 1)
    total_steps = max_steps or args.total_step
    gen = torch.Generator(device).manual_seed(1234)
    log_every = max(int(args.get("log_every", 1)), 1)
    eval_every = max(int(args.get("eval_every_epoch", 6)), 1)
    vis = not args.get("no_vis", False)
    val_rng = np.random.RandomState(seed + 7919)  # the batches' stream is the thread's
    val_chunk_fn = None
    saved_at = start_step if resumed else None

    def checkpoint(at_step):
        if not rank0:
            return
        timer.start("checkpoint")
        path = save_checkpoint(tracker.log_dir, at_step,
                               training_state(params, optimizer, at_step, opt_model))
        timer.stop("checkpoint")
        log.info(f"checkpoint {path}")

    @torch.no_grad()
    def validate(at_step, ep):
        """Render one random frame (the reference's validation step)."""
        nonlocal val_chunk_fn
        timer.start("val_render")
        try:
            if val_chunk_fn is None:
                val_chunk_fn = make_chunk_renderer(scene)
                if split is not None:
                    val_chunk_fn = split_chunk_renderer(val_chunk_fn, split)
            vidx = int(val_rng.randint(seq.n_frames))
            fb = seq.full_frame_batch(vidx, downsample=int(args.get("render_downsample", 2)))
            res = render_frame(params, scene, fb, pixel_per_batch=4096, chunk_fn=val_chunk_fn)
            gt = fb["gt_rgb"].reshape(*fb["img_hw"], 3)
            mse = float(np.mean((res["rgb"] - gt) ** 2))
            val_psnr = -10.0 * np.log10(max(mse, 1e-12))
            tracker.log_dict({"val/psnr": val_psnr}, step=at_step, epoch=ep)
            tracker.log_image(f"val_{vidx:04d}", outputs_to_panel(res, gt_rgb=gt), at_step)
            log.info(f"val render frame {vidx}: psnr {val_psnr:.2f}")
        except Exception:  # validation must never end training (hold_tpu/train.py:443)
            log.warning("val render failed", exc_info=True)
        timer.stop("val_render")

    meshing = not args.get("no_meshing", False)
    res_scale = 4 if fast else 1
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

    def share(state):
        """Rank 0's mesh state on every rank (one process: as it is)."""
        if split is not None:
            split.broadcast_tensors_([state[k] for k in sorted(state)])
        return state

    batches = prefetch_batches(seq, np.random.RandomState(seed), batch_size, args.offset,
                               args.num_sample)
    t_start = time.time()
    try:
        for step in range(start_step, total_steps):
            epoch = step // steps_per_epoch
            timer.start("data")
            batch_np = next(batches)
            if split is not None:
                batch_np = shard_batch(batch_np, split.rank, split.world)
            batch = batch_to_device(batch_np, device)
            timer.stop("data")
            aux = train_step(params, batch, mesh_state, gen, step, epoch)
            if step == start_step and total_steps - start_step > 1:
                # phase averages leave out the warm-up step
                timer.totals.clear()
                timer.counts.clear()
            if step % log_every == 0 or step == total_steps - 1:
                aux = {k: float(v) for k, v in aux.items()}
                tracker.log_dict(aux, step=step, epoch=epoch)
                log.info(f"step {step} epoch {epoch} loss {aux['loss']:.4f} "
                         f"psnr {aux['psnr']:.2f}")

            done = step + 1
            meshed = mesh_future is not None and mesh_future.done()
            if split is not None and meshing:  # every rank adopts at rank 0's step
                meshed = split.agree(meshed)
            if meshed:
                timer.start("meshing")
                if rank0:
                    mesh_state = adopt(mesh_future.result, mesh_state)
                    mesh_future = None
                    if pending is not None:
                        mesh_future, pending = mesher.submit(mesh_at, pending), None
                mesh_state = share(mesh_state)
                timer.stop("meshing")
            if done % steps_per_epoch:
                continue
            ep = done // steps_per_epoch
            if meshing and (ep % 3 == 0 or fast):
                timer.start("meshing")
                snap = (meshing_snapshot(params, scene), done) if rank0 else None
                if fast:
                    if rank0:
                        mesh_state = adopt(lambda: mesh_at(snap), mesh_state)
                    mesh_state = share(mesh_state)
                elif rank0 and mesh_future is None:
                    mesh_future = mesher.submit(mesh_at, snap)
                elif rank0:
                    pending = snap
                    log.warning(f"meshing still running at epoch {ep}; queued the snapshot of "
                                f"step {done} in place of any queued before")
                timer.stop("meshing")
            if ep % eval_every == 0 or done >= total_steps:
                checkpoint(done)
                saved_at = done
                if vis:
                    validate(done, ep)
        # at the end: the meshing in flight, then the snapshot queued behind it
        if mesh_future is not None:
            mesh_state = adopt(mesh_future.result, mesh_state)
        if pending is not None:
            mesh_state = adopt(lambda: mesh_at(pending), mesh_state)
        if meshing:
            mesh_state = share(mesh_state)
    finally:
        batches.close()
        mesher.shutdown(wait=True)

    final = max(total_steps, start_step)
    if saved_at != final:
        checkpoint(final)
    log.info(f"done: steps {start_step}..{final} in {time.time() - t_start:.1f}s; "
             f"phases: {timer.summary()}")
    return params, scene, mesh_state, tracker, timer, optimizer


def replicated_state(params, optimizer) -> list:
    """The tensors every rank must hold alike at the start: the parameters
    and Adam's moment estimates (its step counts live on the host and come
    from the same checkpoint on every rank)."""
    out = list(flatten_params(params).values())
    for st in optimizer.state.values():
        out += [t for t in st.values() if torch.is_tensor(t) and t.dim() > 0]
    return out


def train_worker(rank: int, world: int, device, args, cfg) -> None:
    """One rank of a local run (``parallel.sharding.launch``)."""
    run_training(args, cfg, device=device)


def main(argv=None):
    """Parse the flags and train: in this process, in ``--num_devices``
    local processes, or as rank ``--process_id`` of a ``--coordinator``
    run.  A process group made here is destroyed on exit and on error."""
    args, cfg = parse_args(argv)
    device = resolve_device(args.device)
    if args.coordinator:
        dev = local_device(args.process_id, device.type)
        init_distributed(args.coordinator, args.num_processes, args.process_id, dev)
        try:
            run_training(args, cfg, device=dev)
        finally:
            torch.distributed.destroy_process_group()
        return
    n = local_process_count(int(args.num_devices), device.type)
    if n == 1:
        run_training(args, cfg, device=device)
        return
    launch(train_worker, n, rank_devices(n, device.type), (args, cfg))


if __name__ == "__main__":
    main()
