"""Readings for the limits of a cell's comparison: the program against the
reference over many seeds, and the control (the reference in the next
precision down, in the program's place) against the reference, in one
process.  Not run by the benchmark's runs.

    python3 holdbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control_seeds 1,2,3] [--fault NAME]

Each seed prints one JSON line: the seed, whose readings (``program``,
``control``, or ``fault <name>``: the program with a fault of
``faults.py`` planted), every number compared, and the readings behind
them.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

from holdbench import device, faults  # noqa: E402
from holdbench.run import load_cell, load_json  # noqa: E402


def _detail(got, ref, radius):
    """Every step's loss, every leaf's norms, and each step's and node's z
    gaps in scene radii (mean, quantiles 0.5 / 0.9 / 0.99 / 0.999, max, the
    shares over 1e-3 and 1e-2), on both sides: for choosing and reading the
    numbers compared."""
    from holdbench import compare

    z = []
    for p, r in zip(got["zs"], ref["zs"]):
        row = {}
        for nid, d in compare.z_moved(p, r, radius).items():
            if d is None:
                row[nid] = None
                continue
            q = torch.quantile(d.float(), torch.tensor([0.5, 0.9, 0.99, 0.999], device=d.device))
            row[nid] = [float(d.mean()), *map(float, q), float(d.max()),
                        float((d > 1e-3).double().mean()), float((d > 1e-2).double().mean())]
        z.append(row)
    return {"loss": [got["loss"], ref["loss"]], "grad": [got["grad"], ref["grad"]],
            "change": [got["change"], ref["change"]], "z": z}


def _train(cell, cfg, seeds, control_seeds, dev, fault=None):
    from holdbench.entries import train as T

    inp = T.inputs(cell, cfg)
    radius = inp["opt_model"]["scene_bounding_sphere"]
    of = "program" if fault is None else f"fault {fault}"
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        with faults.planted(fault) if fault else contextlib.nullcontext():
            prog = T.Program(cell, cfg, inp, seed, dev)
            rec = T.first_steps(prog, int(cell["compare_steps"]))
        base = prog.base
        prog.close()
        del prog
        gc.collect()
        device.empty_cache(dev)
        t1 = time.perf_counter()
        ref = T.reference_steps(cfg, inp, base, rec, dev)
        t2 = time.perf_counter()
        if seed in seeds:
            v, w = T.readings(rec, ref, radius)
            print(json.dumps({"seed": seed, "of": of, "values": v, "worst": w,
                              "program_s": t1 - t0, "reference_s": t2 - t1,
                              "detail": _detail(rec, ref, radius)}), flush=True)
        if seed in control_seeds:
            ctl = T.reference_steps(cfg, inp, base, rec, dev, control=True)
            v, w = T.readings(ctl, ref, radius)
            print(json.dumps({"seed": seed, "of": "control", "values": v, "worst": w,
                              "detail": _detail(ctl, ref, radius)}), flush=True)
            del ctl
        del ref, rec
        gc.collect()
        device.empty_cache(dev)


def _render(cell, cfg, seeds, control_seeds, dev, fault=None):
    import numpy as np

    from holdbench import compare
    from holdbench.entries import render as R

    inp = R.inputs(cell, cfg)
    frames = int(cell.get("calibrate_frames", 10))
    of = "program" if fault is None else f"fault {fault}"
    for seed in sorted(set(seeds) | set(control_seeds)):
        with faults.planted(fault) if fault else contextlib.nullcontext():
            prog = R.Program(cell, cfg, inp, seed, dev)
        rng = np.random.RandomState((int(seed) + 2) % 2 ** 32)
        compared, got = [], {}
        for i in range(frames):
            idx = (int(cell["warmup_frames"]) + i) % prog.data.n_frames
            maps = prog.render(idx)
            pix = R.pixel_sample(prog.data, idx, prog.down, int(cell["compare_pixels"]), rng)
            compared.append((prog.data.full_frame_batch(idx, downsample=prog.down), pix))
            for k, v in R.flat(maps, pix).items():
                got.setdefault(k, []).append(v)
        base = prog.base
        del prog
        gc.collect()
        device.empty_cache(dev)
        ref = R.reference_maps(cfg, inp, base, compared, dev)
        ref = {k: np.concatenate([r[k] for r in ref]) for k in ref[0]}
        if seed in seeds:
            gap, worst = compare.map_gap({k: np.concatenate(v) for k, v in got.items()}, ref)
            print(json.dumps({"seed": seed, "of": of, "values": {"maps": gap},
                              "worst": worst}), flush=True)
        if seed in control_seeds:
            ctl = R.reference_maps(cfg, inp, base, compared, dev, control=True)
            ctl = {k: np.concatenate([r[k] for r in ctl]) for k in ctl[0]}
            gap, worst = compare.map_gap(ctl, ref)
            print(json.dumps({"seed": seed, "of": "control", "values": {"maps": gap},
                              "worst": worst}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--fault", default="", choices=("",) + tuple(faults.FAULTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ.pop("MANO_MODEL_DIR", None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(args.workload)
    cfg = load_json("configs", cell["config"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    dev = torch.device(args.device)
    if cell["kind"] == "train":
        _train(cell, cfg, seeds, control_seeds, dev, args.fault or None)
    else:
        _render(cell, cfg, seeds, control_seeds, dev, args.fault or None)


if __name__ == "__main__":
    main()
