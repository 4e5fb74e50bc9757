"""The traced window by the port's stages: each stage span's kernel
launches, device busy time and idle time, from the Chrome trace of
``trace.Traced`` or from ``trace.summarize``'s idle gaps.

A training step's stages are ``hold.sampler`` and ``hold.grad``, a render
chunk's ``hold.sampler`` and ``hold.shade`` (``hold_tpu_torch/utils/
tracing.py``).  A span's stage is read from its name (``stage_of``): the
port's spans nest by construction, so the innermost span open at an
instant names the stage open then.  An operation on the device belongs to
the stage open at the host call that launched it: the launch (a
``cuda_runtime`` or ``cuda_driver`` event) and the operation share
``args.correlation``, and the innermost span is sought on every thread,
since the backward's kernels are launched from autograd's thread while the
main thread sits in ``hold.backward``.  An idle gap belongs to the stage
open at its start, as ``summarize`` names gaps.  Operations with no launch
event, and whatever no stage span holds, go to ``none``.
"""

from __future__ import annotations

import bisect

from holdbench.trace import DEVICE_CATS, _merge

STAGES = {"train": ("hold.sampler", "hold.grad"), "render": ("hold.sampler", "hold.shade")}
NONE = "none"
HOST_CATS = ("cuda_runtime", "cuda_driver")
# the benchmark's own span around sample_all_z, inside hold.sampler (entries/train.py)
SAMPLER_SPANS = ("hold.sampler", "sampler")
# the port's spans of a frame outside its chunks (render/renderer.py::render_frame)
FRAME_SPANS = ("hold.packs", "hold.gather")


def stage_of(name: str, kind: str) -> str:
    """The stage span of an entry of ``kind`` that holds the span ``name``,
    or ``none``."""
    if name in SAMPLER_SPANS or name.startswith("hold.sample_z."):
        return "hold.sampler"
    if name.startswith("hold.") and name not in FRAME_SPANS:
        return STAGES[kind][1]
    if kind == "train" and name.startswith("Optimizer."):  # torch's own, inside hold.grad
        return STAGES[kind][1]
    return NONE


def idle_s(summary: dict | None, kind: str, stage: str) -> float | None:
    """The idle seconds of ``stage`` from ``summarize``'s gaps, named by the
    innermost span open at each gap's start; None where the trace holds no
    such stage span (a program without the port's spans)."""
    if not summary or not any(name == stage for name, _ in summary.get("spans", ())):
        return None
    return sum(v for name, v in summary["idle_by_span"].items() if stage_of(name, kind) == stage)


def split(trace: dict, key) -> dict:
    """``launches``, ``busy_s`` (the union of the device intervals of the
    operations launched) and ``idle_s`` over the ``window`` span of a
    Chrome trace of ``Traced``, by bucket: ``key`` maps the name of the
    innermost span open at a launch or at a gap's start (``no span`` where
    none is) to its bucket, e.g. ``lambda n: stage_of(n, "train")``; an
    operation with no launch event goes to ``none``."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == "window"
               and e.get("cat") in ("user_annotation", "cpu_op", "python_function")]
    if not windows:
        return {}
    w0 = min(e["ts"] for e in windows)
    w1 = max(e["ts"] + e["dur"] for e in windows)
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] != "window"),
                   key=lambda x: (x[0], -x[1]))
    starts = [s for s, _, _ in spans]

    def bucket_at(t) -> str:
        """The bucket of the innermost span open at ``t`` (the last one, in
        the order of ``spans``, that holds it)."""
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if t < spans[i][1]:
                return key(spans[i][2])
        return key("no span")

    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {})}
    out: dict = {}
    intervals: dict = {}

    def bucket(name: str) -> dict:
        intervals.setdefault(name, [])
        return out.setdefault(name, {"launches": 0, "busy_s": 0.0, "idle_s": 0.0})

    for e in events:
        if e.get("cat") not in DEVICE_CATS or not (e["ts"] < w1 and e["ts"] + e["dur"] > w0):
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        b = NONE if t is None else bucket_at(t)
        bucket(b)["launches"] += e["cat"] == "kernel"
        intervals[b].append([max(e["ts"], w0), min(e["ts"] + e["dur"], w1)])
    for b, ivs in intervals.items():
        out[b]["busy_s"] = sum(y - x for x, y in _merge(ivs)) * 1e-6
    busy = _merge([iv for ivs in intervals.values() for iv in ivs])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for x, y in zip(edges[0::2], edges[1::2]):
        if y > x:
            bucket(bucket_at(x))["idle_s"] += (y - x) * 1e-6
    return out
