"""Full-sequence rendering:

    python -m hold_tpu_torch.render_cli --exp <log dir> --case <seq> [--render_downsample 2]
        [--pixel_per_batch 4096] [--agent_id 0 --num_agents 1] [--out DIR]
        [--export_root exports] [--device cuda|cpu] [--no_fused_render]

Counterpart of hold_tpu/render_cli.py.  Loads a run that
``hold_tpu_torch.train`` wrote (``utils/checkpoint.load_experiment``),
renders this agent's share of the sequence's frames and writes, per frame,
the panel ``<out>/<idx>.png`` (default ``<exp>/renders``: gt | rgb |
foreground | normal | instances) and the fp16 normal map
``<export_root>/<exp name>/normal/<idx>.npy``.  It runs on the card unless
asked for the CPU; ``--no_fused_render`` shades with the chunked grad-stage
shade instead of the fused render kernels (the JAX package's
``HOLD_NO_FUSED_RENDER=1``).  Canonical meshes are not ported: the render
path does not need them.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .data.dataset import SequenceData, test_frame_split
from .render.renderer import make_chunk_renderer, outputs_to_panel, render_frame
from .utils.checkpoint import load_experiment
from .utils.config import resolve_device
from .utils.logger import StepTimer


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
    ap.add_argument("--no_fused_render", action="store_true")
    return ap


def main(argv=None) -> list[dict]:
    """Render and write this agent's frames; returns one record a frame:
    idx, the maps, seconds, and the timer's sampler/shade means."""
    import cv2

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    seq = SequenceData.from_build_dir(args.case, args.data_root)
    params, scene = load_experiment(args.exp, seq, device,
                                    fused_render=not args.no_fused_render)
    out_dir = args.out or os.path.join(args.exp, "renders")
    norm_dir = os.path.join(args.export_root, os.path.basename(args.exp.rstrip("/")), "normal")
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(norm_dir, exist_ok=True)

    records = []
    for idx in test_frame_split(seq.n_frames, args.num_agents, args.agent_id):
        fb = seq.full_frame_batch(idx, downsample=args.render_downsample)
        timer = StepTimer()
        t0 = time.perf_counter()
        res = render_frame(params, scene, fb, pixel_per_batch=args.pixel_per_batch,
                           chunk_fn=make_chunk_renderer(scene, timer))
        seconds = time.perf_counter() - t0
        H, W = fb["img_hw"]
        panel = outputs_to_panel(res, gt_rgb=fb["gt_rgb"].reshape(H, W, 3))
        cv2.imwrite(os.path.join(out_dir, f"{idx:04d}.png"),
                    (np.clip(panel, 0, 1) * 255).astype(np.uint8)[:, :, ::-1])
        np.save(os.path.join(norm_dir, f"{idx:04d}.npy"), res["normal"].astype(np.float16))
        print(f"rendered frame {idx} ({H}x{W}) in {seconds:.3f} s -> {out_dir}", flush=True)
        records.append({"idx": idx, "res": res, "seconds": seconds,
                        "phases": {k: timer.totals[k] for k in timer.totals}})
    return records


if __name__ == "__main__":
    main()
