#!/usr/bin/env python3
"""One traced benchmark run split by the port's stages and spans (one
NVIDIA GPU).

    python3 scripts/probe_stages.py --workload <cell> --seed <n> [--seconds 30]

Runs ``holdbench/run.py --trace 1`` in this process, with
``holdbench.trace.summarize`` wrapped so that the traced window is also
split by ``holdbench/stages.py``: by stage (``hold.sampler`` and
``hold.grad`` or ``hold.shade``, and ``none``) and by the innermost span's
own name (each node's span, ``hold.packs``, ``hold.gather``, the
benchmark's ``step``, ``chunk``, ...).  The run's result line comes first,
as ever; then one JSON line: the window's launches, busy and idle ms a step
or frame, each stage's and each span's, the stages' shares of the window's,
the ``hold.*`` spans a step or frame, and the device operations that had no
launch event, by name.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def per(split: dict, n: int) -> dict:
    return {k: {"launches": v["launches"] / n, "busy_ms": v["busy_s"] * 1e3 / n,
                "idle_ms": v["idle_s"] * 1e3 / n} for k, v in split.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from holdbench import run, stages, trace

    cell = run.load_cell(opts.workload)
    kind = cell["kind"]
    n = int(cell["trace_steps"] if kind == "train" else cell["trace_frames"])
    got = {}
    summarize = trace.summarize

    def split_too(tr: dict) -> dict:
        s = summarize(tr)
        ev = [e for e in tr.get("traceEvents", []) if e.get("ph") == "X"]
        hosts = {e["args"]["correlation"] for e in ev
                 if e.get("cat") in stages.HOST_CATS and "correlation" in e.get("args", {})}
        orphans: dict = {}
        for e in ev:
            if (e.get("cat") in trace.DEVICE_CATS
                    and e.get("args", {}).get("correlation") not in hosts):
                orphans[e["name"][:64]] = orphans.get(e["name"][:64], 0) + 1
        by_stage = stages.split(tr, lambda name: stages.stage_of(name, kind))
        inner = [k for k in by_stage if k != stages.NONE]
        got.update({
            "workload": opts.workload, "seed": opts.seed, "kind": kind, "per": n,
            "window_ms": s["window_s"] * 1e3 / n, "busy_ms": s["busy_s"] * 1e3 / n,
            "idle_ms": (s["window_s"] - s["busy_s"]) * 1e3 / n, "launches": s["launches"] / n,
            "stages": per(by_stage, n),
            "shares": {
                "launches": sum(by_stage[k]["launches"] for k in inner) / max(s["launches"], 1),
                "busy": sum(by_stage[k]["busy_s"] for k in inner) / max(s["busy_s"], 1e-12),
                "idle": sum(by_stage[k]["idle_s"] for k in inner)
                / max(s["window_s"] - s["busy_s"], 1e-12)},
            "spans": per(stages.split(tr, lambda name: name), n),
            "hold_spans": sum(1 for e in ev if e.get("cat") == "user_annotation"
                              and e["name"].startswith("hold.")) / n,
            "no_launch_event": orphans})
        return s

    trace.summarize = split_too
    rc = run.main(["--workload", opts.workload, "--seed", str(opts.seed),
                   "--seconds", str(opts.seconds), "--trace", "1"])
    if got:
        print(json.dumps(got), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
