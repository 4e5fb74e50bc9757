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
the ``hold.*`` spans a step or frame, the device operations that had no
launch event, by name, and, a step or frame by span (``syncs``): the host's
``cuda*Synchronize`` runtime calls, the host-to-device copies from pageable
and from pinned memory (by the span open at their launch), and the port's
host-built constants ``copied`` and ``hits``
(``hold_tpu_torch/utils/tracing.py::CONSTANTS_BY_SPAN``; none in a checkout
without it); ``sync_stages`` sums them by stage.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def per(split: dict, n: int) -> dict:
    return {k: {"launches": v["launches"] / n, "busy_ms": v["busy_s"] * 1e3 / n,
                "idle_ms": v["idle_s"] * 1e3 / n} for k, v in split.items()}


def syncs_by_span(tr: dict, constants: dict | None) -> dict:
    """Counts inside the traced window by the innermost span open at their
    host time: ``cuda*Synchronize`` runtime calls, ``HtoD pageable`` and
    ``HtoD pinned`` copies (at their launch), and ``constants`` (the port's
    ``(span, kind)`` counts, if given)."""
    from holdbench import stages

    ev = [e for e in tr.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in ev if e.get("name") == "window"]
    if not windows:
        return {}
    w0 = min(e["ts"] for e in windows)
    w1 = max(e["ts"] + e["dur"] for e in windows)
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                    if e.get("cat") == "user_annotation" and e["name"] != "window"),
                   key=lambda x: (x[0], -x[1]))
    starts = [a for a, _, _ in spans]

    def span_at(t) -> str:
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if t < spans[i][1]:
                return spans[i][2]
        return "no span"

    out: dict = {}

    def add(name: str, kind: str, n=1) -> None:
        k = out.setdefault(name, {})
        k[kind] = k.get(kind, 0) + n

    launched = {e["args"]["correlation"]: e["ts"] for e in ev
                if e.get("cat") in stages.HOST_CATS and "correlation" in e.get("args", {})}
    for e in ev:
        if not w0 <= e["ts"] < w1:
            continue
        if e.get("cat") in stages.HOST_CATS and "Synchronize" in e["name"]:
            add(span_at(e["ts"]), e["name"])
        elif e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]:
            t = launched.get(e.get("args", {}).get("correlation"))
            kind = "HtoD pageable" if "Pageable" in e["name"] else "HtoD pinned"
            add("no launch event" if t is None else span_at(t), kind)
    for (name, kind), n in (constants or {}).items():
        add(name, kind, n)
    return out


def count_syncs(tr: dict, kind: str, n: int) -> dict:
    """``syncs_by_span`` a step or frame, with the port's constant counts
    where the checkout keeps them, and the same summed by stage."""
    from holdbench import stages

    try:
        from hold_tpu_torch.utils import tracing
        CONSTANTS_BY_SPAN = dict(tracing.CONSTANTS_BY_SPAN)  # the traced window's alone
        tracing.reset_constant_counts()
    except (ImportError, AttributeError):  # a checkout from before the counters
        CONSTANTS_BY_SPAN = None
    by_span = syncs_by_span(tr, CONSTANTS_BY_SPAN)
    by_stage: dict = {}
    for name, counts in by_span.items():
        st = by_stage.setdefault(stages.stage_of(name, kind), {})
        for k, v in counts.items():
            st[k] = st.get(k, 0) + v
    return {"syncs": {name: {k: v / n for k, v in c.items()} for name, c in by_span.items()},
            "sync_stages": {name: {k: v / n for k, v in c.items()}
                            for name, c in by_stage.items()},
            "constants_counted": CONSTANTS_BY_SPAN is not None}


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
        got.update(count_syncs(tr, kind, n))
        return s

    trace.summarize = split_too
    rc = run.main(["--workload", opts.workload, "--seed", str(opts.seed),
                   "--seconds", str(opts.seconds), "--trace", "1"])
    if got:
        print(json.dumps(got), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
