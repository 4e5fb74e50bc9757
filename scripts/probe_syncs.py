#!/usr/bin/env python3
"""Every stream sync of one warmed training step or render frame of a
benchmark cell, with its Python stack (one NVIDIA GPU).

    PYTHONPATH=. python3 scripts/probe_syncs.py --workload <cell> --seed <n> [--steps 2]

Builds the cell's program as ``holdbench/run.py`` does, runs ``--steps``
steps (or frames) to warm it up, then one more under
``torch.cuda.set_sync_debug_mode("warn")``: each synchronising CUDA call
(a blocking copy, ``.item()``, ``nonzero``, a stream or device sync) warns,
and the warning's stack is recorded.  A training step runs the harness's
batch copy first, outside the mode; a render frame runs whole
(``render_frame``: its copies at the start and its gather at the end sync
by design).  Syncs inside the backward are replayed by autograd at the end
of ``loss.backward()`` and show there.  Prints one JSON line: the syncs by
stack (the innermost repository frames, innermost first) and their total.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 4


def repo_frames(stack) -> list:
    """The innermost ``FRAMES`` frames of ``stack`` in the repository's
    packages but this script, innermost first, as ``path:line function``;
    where there is none, the innermost ``FRAMES`` frames of any file."""
    out = []
    for f in reversed(stack):
        path = Path(f.filename).resolve()
        if ROOT not in path.parents or path == Path(__file__).resolve():
            continue
        out.append(f"{path.relative_to(ROOT)}:{f.lineno} {f.name}")
        if len(out) == FRAMES:
            return out
    return out or [f"{f.filename}:{f.lineno} {f.name}" for f in reversed(stack)][:FRAMES]


def recorded_syncs(fn) -> dict:
    """``fn()`` under the sync debug mode ``warn``: each sync's stack, counted."""
    import torch

    sites: dict = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        key = " <- ".join(repo_frames(traceback.extract_stack()[:-1]))
        sites[key] = sites.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=2, help="warm-up steps or frames")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from holdbench import run
    from holdbench.entries import train

    cell = run.load_cell(opts.workload)
    cfg = run.load_json("configs", cell["config"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = train.inputs(cell, cfg)
    if cell["kind"] == "train":
        prog = train.Program(cell, cfg, inp, opts.seed, dev)
        for _ in range(opts.steps):
            prog.run_step(prog.next_batch()[1])
        batch = prog.next_batch()[1]
        sites = recorded_syncs(lambda: prog.run_step(batch))
        prog.close()
    else:
        from holdbench.entries import render

        prog = render.Program(cell, cfg, inp, opts.seed, dev)
        for idx in range(opts.steps):
            prog.render(idx % prog.data.n_frames)
        sites = recorded_syncs(lambda: prog.render(opts.steps % prog.data.n_frames))
    for k, v in sorted(sites.items(), key=lambda kv: -kv[1]):
        print(f"{v:5d}  {k}", file=sys.stderr)
    print(json.dumps({"workload": opts.workload, "seed": opts.seed, "kind": cell["kind"],
                      "device": torch.cuda.get_device_name(dev), "total": sum(sites.values()),
                      "syncs": sites}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
