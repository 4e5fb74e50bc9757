"""The traced window: torch.profiler over a few steps or frames, read back
from its Chrome trace into what the per-layer metrics take.

``Traced`` opens the profiler (host and device activities) and a
``window`` span; the entry marks its own host spans with ``span(name)``.
On close the trace is written under ``$TMPDIR``, read, and deleted.  The
summary holds the device's operations (kernels, copies, sets) with their
intervals, the kernel launches, the union of the device's busy intervals
inside the window, and the host spans, by which each idle gap is named.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own (a no-op outside a trace)."""
    with torch.profiler.record_function(name):
        yield


class Traced:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.summary = None

    def __enter__(self):
        torch.cuda.synchronize() if torch.cuda.is_available() else None
        self.prof.__enter__()
        self._window = torch.profiler.record_function("window")
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize() if torch.cuda.is_available() else None
        self._window.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as fh:
                    self.summary = summarize(json.load(fh))
            finally:
                os.remove(path)
        return False


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(trace: dict) -> dict:
    """The window's device operations, launches, busy time, host spans and
    idle gaps (seconds), from a Chrome trace of ``Traced``."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == "window"
               and e.get("cat") in ("user_annotation", "cpu_op", "python_function")]
    if not windows:
        return {}
    w0 = min(e["ts"] for e in windows)
    w1 = max(e["ts"] + e["dur"] for e in windows)
    inside = [e for e in events
              if e.get("cat") in DEVICE_CATS and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    ops = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in inside]
    launches = sum(1 for e in inside if e["cat"] == "kernel")
    busy = _merge([[max(s, w0), min(e, w1)] for _, s, e in ops])
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] != "window"),
                   key=lambda x: (x[0], -x[1]))
    by_name: dict = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = "no span"
        for s, e, name in spans:  # the innermost span open at the gap's start
            if s <= a < e:
                label = name
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "launches": launches,
        "kernel_s": by_name,
        "spans": [(name, (e - s) * 1e-6) for s, e, name in spans],
        "idle_by_span": gaps,
    }


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time, and the idle time by
    the host span that was open when each gap began."""
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def kernel_seconds(summary: dict, keys: tuple) -> float:
    """Device seconds of the operations whose name holds any of ``keys``."""
    return sum(v for k, v in summary["kernel_s"].items() if any(x in k for x in keys))
