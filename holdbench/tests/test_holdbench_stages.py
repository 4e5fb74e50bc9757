"""holdbench/stages.py on a hand-made Chrome trace of a training step: a
launch on the main thread in ``hold.sampler``, one from a second thread
(autograd's) while the main thread sits in ``hold.backward``, a kernel with
no launch event, idle gaps under nested node spans; the stages' launches,
busy and idle time add up to the window's (``trace.summarize``), and the
idle readers agree with the split."""

import pytest

from holdbench import stages
from holdbench.trace import summarize

SPANS = [  # (name, start, end) in microseconds, on the main thread
    ("window", 0, 1000), ("step", 10, 900),
    ("hold.sampler", 20, 300), ("sampler", 25, 290),
    ("hold.sample_z.right", 30, 150), ("hold.sample_z.object", 160, 280),
    ("hold.grad", 310, 880), ("hold.forward.right", 320, 400),
    ("hold.backward", 500, 800), ("hold.adam", 810, 870),
]
LAUNCHES = [  # (category, name, thread, host time, correlation)
    ("cuda_runtime", "cudaLaunchKernel", 1, 40, 1),
    ("cuda_driver", "cuLaunchKernel", 1, 170, 2),
    ("cuda_runtime", "cudaLaunchKernel", 1, 330, 3),
    ("cuda_runtime", "cudaLaunchKernel", 2, 600, 4),  # autograd's thread
    ("cuda_runtime", "cudaLaunchKernel", 1, 815, 6),
    ("cuda_runtime", "cudaMemcpyAsync", 1, 905, 7),
]
DEVICE = [  # (category, start, end, correlation); correlation 5 has no launch event
    ("kernel", 50, 120, 1), ("kernel", 200, 260, 2), ("kernel", 340, 480, 3),
    ("kernel", 610, 790, 4), ("kernel", 795, 805, 5), ("kernel", 820, 860, 6),
    ("gpu_memcpy", 910, 950, 7),
]


def _trace(spans=SPANS) -> dict:
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s, "dur": e - s, "tid": 1}
          for n, s, e in spans]
    ev += [{"ph": "X", "cat": c, "name": n, "ts": t, "dur": 3, "tid": tid,
            "args": {"correlation": k}} for c, n, tid, t, k in LAUNCHES]
    ev += [{"ph": "X", "cat": c, "name": f"op{k}", "ts": s, "dur": e - s, "tid": 7,
            "args": {"correlation": k}} for c, s, e, k in DEVICE]
    return {"traceEvents": ev}


def test_the_split_by_stage_adds_up_to_the_window():
    trace = _trace()
    got = stages.split(trace, lambda n: stages.stage_of(n, "train"))
    assert {k: v["launches"] for k, v in got.items()} == {
        "hold.sampler": 2, "hold.grad": 3, "none": 1}
    want_busy = {"hold.sampler": 130e-6, "hold.grad": 360e-6, "none": 50e-6}
    # idle: [120, 200] under hold.sample_z.right and [260, 340] under
    # hold.sample_z.object; [480, 610], [790, 795], [805, 820], [860, 910]
    # in the grad stage; [0, 50] and [950, 1000] under no stage
    want_idle = {"hold.sampler": 160e-6, "hold.grad": 200e-6, "none": 100e-6}
    for st in got:
        assert got[st]["busy_s"] == pytest.approx(want_busy[st]), st
        assert got[st]["idle_s"] == pytest.approx(want_idle[st]), st
    s = summarize(trace)
    assert sum(v["launches"] for v in got.values()) == s["launches"] == 6
    assert sum(v["busy_s"] for v in got.values()) == pytest.approx(s["busy_s"])
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    for st in ("hold.sampler", "hold.grad"):
        assert stages.idle_s(s, "train", st) == pytest.approx(got[st]["idle_s"]), st
    by_span = stages.split(trace, lambda n: n)  # the innermost span's own name
    assert by_span["hold.backward"] == {"launches": 1, "busy_s": pytest.approx(180e-6),
                                        "idle_s": pytest.approx(5e-6)}
    assert by_span["hold.sample_z.right"]["idle_s"] == pytest.approx(80e-6)
    assert by_span["none"]["launches"] == 1  # the kernel with no launch event
    assert by_span["no span"]["busy_s"] == pytest.approx(40e-6)  # the copy after "step"


def test_the_readers_find_nothing_without_the_ports_spans():
    s = summarize(_trace([x for x in SPANS if not x[0].startswith("hold.")]))
    assert s["idle_by_span"] and stages.idle_s(s, "train", "hold.sampler") is None
    assert stages.idle_s(None, "train", "hold.grad") is None


def test_a_render_chunks_spans_by_stage():
    of = {n: stages.stage_of(n, "render") for n in (
        "hold.sampler", "hold.sample_z.object", "hold.shade", "hold.render.right",
        "hold.composite", "hold.background", "hold.packs", "hold.gather", "chunk", "frame")}
    assert of == {"hold.sampler": "hold.sampler", "hold.sample_z.object": "hold.sampler",
                  "hold.shade": "hold.shade", "hold.render.right": "hold.shade",
                  "hold.composite": "hold.shade", "hold.background": "hold.shade",
                  "hold.packs": "none", "hold.gather": "none", "chunk": "none",
                  "frame": "none"}
    assert stages.stage_of("Optimizer.step#Adam.step", "train") == "hold.grad"
