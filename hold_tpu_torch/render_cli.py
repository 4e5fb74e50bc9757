"""Full-sequence rendering:

    python -m hold_tpu_torch.render_cli --exp <log dir> --case <seq> [--render_downsample 2]
        [--pixel_per_batch 4096] [--agent_id 0 --num_agents 1] [--out DIR]
        [--export_root exports] [--device cuda|cpu]

Counterpart of hold_tpu/render_cli.py.  Loads a run that
``hold_tpu_torch.train`` wrote (``utils/checkpoint.load_experiment``),
renders this agent's share of the sequence's frames and writes, per frame,
the panel ``<out>/<idx>.png`` (default ``<exp>/renders``: gt | rgb |
foreground | normal | instances) and the fp16 normal map
``<export_root>/<exp name>/normal/<idx>.npy``.  It runs on the card unless
asked for the CPU.  Canonical meshes are not ported: the render path does
not need them.

Like the JAX CLI, which shards each chunk's pixels over every local device
(``make_mesh(0)``), it renders over every local card: one process a card
(``parallel.sharding.launch``), each chunk's pixels split over the ranks and
gathered (``split_chunk_renderer``), ``--pixel_per_batch`` rounded up to a
multiple of the card count, rank 0 alone writing the files.  With one card,
or on the CPU, it renders in this process.  ``render_on`` takes the devices
and the backend (e.g. two gloo ranks on one card, or on the CPU).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .data.dataset import SequenceData, test_frame_split
from .parallel.sharding import (
    current_split,
    launch,
    local_process_count,
    rank_devices,
    split_chunk_renderer,
)
from .render.renderer import make_chunk_renderer, outputs_to_panel, render_frame
from .utils.checkpoint import load_experiment
from .utils.config import resolve_device
from .utils.tracing import StepTimer

# each rank's deadline over several processes: set-up, then a frame at most
# this long (an H100 renders a 120x160 frame in about half a second)
RANK_SETUP_S, RANK_FRAME_S = 300.0, 60.0


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", required=True)
    ap.add_argument("--case", required=True)
    ap.add_argument("--data_root", default="./data")
    ap.add_argument("--render_downsample", type=int, default=2)
    ap.add_argument("--agent_id", type=int, default=0)
    ap.add_argument("--num_agents", type=int, default=1)
    ap.add_argument("--pixel_per_batch", type=int, default=4096)
    ap.add_argument("--out", default="")
    ap.add_argument("--export_root", default="exports")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def chunk_pixels(pixel_per_batch: int, world: int) -> int:
    """``--pixel_per_batch`` rounded up to a multiple of the ranks, so that
    every rank gets pixels of a full chunk (the JAX CLI's rule)."""
    return pixel_per_batch + (-pixel_per_batch) % world


def render_frames(args, device, split=None) -> list[dict]:
    """Render and write this agent's frames on ``device``; returns one record
    a frame: idx, the maps, seconds, and the timer's sampler/shade totals.
    With ``split`` (a ``parallel.sharding.RaySplit``) each chunk's pixels
    are split over its ranks and gathered, and only rank 0 writes."""
    import cv2

    world = 1 if split is None else split.world
    writes = split is None or split.rank == 0
    seq = SequenceData.from_build_dir(args.case, args.data_root)
    params, scene, _ = load_experiment(args.exp, seq, device)
    out_dir = args.out or os.path.join(args.exp, "renders")
    norm_dir = os.path.join(args.export_root, os.path.basename(args.exp.rstrip("/")), "normal")
    if writes:
        os.makedirs(out_dir, exist_ok=True)
        os.makedirs(norm_dir, exist_ok=True)
    ppb = chunk_pixels(args.pixel_per_batch, world)

    records = []
    for idx in test_frame_split(seq.n_frames, args.num_agents, args.agent_id):
        fb = seq.full_frame_batch(idx, downsample=args.render_downsample)
        timer = StepTimer()
        chunk_fn = make_chunk_renderer(scene, timer)
        if split is not None:
            chunk_fn = split_chunk_renderer(chunk_fn, split)
        t0 = time.perf_counter()
        res = render_frame(params, scene, fb, pixel_per_batch=ppb, chunk_fn=chunk_fn)
        seconds = time.perf_counter() - t0
        H, W = fb["img_hw"]
        if writes:
            panel = outputs_to_panel(res, gt_rgb=fb["gt_rgb"].reshape(H, W, 3))
            cv2.imwrite(os.path.join(out_dir, f"{idx:04d}.png"),
                        (np.clip(panel, 0, 1) * 255).astype(np.uint8)[:, :, ::-1])
            np.save(os.path.join(norm_dir, f"{idx:04d}.npy"), res["normal"].astype(np.float16))
            print(f"rendered frame {idx} ({H}x{W}) in {seconds:.3f} s -> {out_dir}", flush=True)
        records.append({"idx": idx, "res": res, "seconds": seconds,
                        "phases": {k: timer.totals[k] for k in timer.totals}})
    return records


def render_worker(rank: int, world: int, device, args) -> list[dict]:
    """One rank of a render over several devices (``parallel.sharding.launch``)."""
    return render_frames(args, device, current_split(device))


def render_on(args, devices: list, backend: str | None = None, timeout: float | None = None,
              worker=render_worker) -> list:
    """``render_frames`` over ``devices``: in this process for one device,
    else one process a device (rank r on ``devices[r]``, ``backend`` as
    ``launch`` picks it: NCCL over distinct cards, else gloo), each rank
    ending by ``timeout`` seconds (default: ``RANK_SETUP_S`` and
    ``RANK_FRAME_S`` a frame).  A rank that fails or dies ends every rank
    and raises.  ``worker`` is ``render_worker`` or a function like it.
    Returns each rank's result (its records, with ``render_worker``), in
    rank order."""
    if len(devices) == 1:
        return [render_frames(args, torch.device(devices[0]))]
    if timeout is None:
        n_frames = SequenceData.from_build_dir(args.case, args.data_root).n_frames
        frames = len(test_frame_split(n_frames, args.num_agents, args.agent_id))
        timeout = RANK_SETUP_S + RANK_FRAME_S * frames
    return launch(worker, len(devices), devices, (args,), backend=backend, timeout=timeout)


def main(argv=None) -> list[dict]:
    """Render and write this agent's frames over every local card (or on the
    CPU, ``--device cpu``); returns rank 0's records (``render_frames``)."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    n = local_process_count(0, device.type)
    devices = rank_devices(n, device.type) if n > 1 else [device]
    return render_on(args, devices)[0]


if __name__ == "__main__":
    main()
