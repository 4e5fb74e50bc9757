"""hold_tpu_torch/utils/tracing.py on the CPU at toy widths: outside a
profiler ``span`` is the shared no-op; inside one, a training step and a
rendered frame emit their stage and node spans, nested by interval in the
profiler's Chrome trace; ``StepTimer`` times the stages by the host clock
on the CPU and by stream events, with no synchronisation, on a CUDA device
(its events faked here)."""

import json

import numpy as np
import pytest
import torch
from test_torch_train_step import ARGS, _toy_model

from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models.holdnet import build_scene, empty_object_mesh_state, init_scene_params
from hold_tpu_torch.render.renderer import make_chunk_renderer, render_frame
from hold_tpu_torch.train import batch_to_device, make_train_step, optimizer_for
from hold_tpu_torch.utils import tracing
from hold_tpu_torch.utils.config import Cfg

NODES = ("right", "object")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these toy tensors (as test_torch_train_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    built = generate_sequence(None, n_frames=3, img_hw=(48, 64))
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    model = dict(_toy_model(), scene_bounding_sphere=seq.scene_bounding_sphere)
    scene = build_scene(model, dict(ARGS), seq.scene_data(), torch.device("cpu"))
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    assert tuple(scene.node_ids) == NODES
    return seq, scene, params


def _step_fn(toy, timer=None):
    seq, scene, params = toy
    args = Cfg({**ARGS})
    train_step = make_train_step(scene, optimizer_for(args, params), timer)
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    mesh_state = empty_object_mesh_state("cpu")

    def go(step):
        batch = batch_to_device(seq.sample_tempo_batch(rng, 1, offset=1, num_sample=8), "cpu")
        return train_step(params, batch, mesh_state, gen, step, 0)

    return go


def _hold_spans(prof, tmp_path) -> list:
    """The ``hold.*`` spans of a profile's Chrome trace, (name, start, end)
    in order of start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("hold.")), key=lambda x: x[1])


def _inside(spans, outer: str, inner: str) -> bool:
    """Every ``inner`` span lies within some ``outer`` span."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    ins = [(s, e) for n, s, e in spans if n == inner]
    return bool(ins) and all(any(a <= s and e <= b for a, b in outs) for s, e in ins)


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_span_outside_a_profiler_is_the_shared_noop(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("record_function called outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("hold.sampler"), tracing.span("hold.grad")
    assert a is b
    with a, tracing.stage("sampler"):
        pass


def test_train_step_emits_stage_and_node_spans(toy, tmp_path):
    go = _step_fn(toy)
    spans = _hold_spans(_profiled(lambda: go(0)), tmp_path)
    names = [n for n, _, _ in spans]
    assert names.count("hold.sampler") == names.count("hold.grad") == 1
    sampler, grad = [next(x for x in spans if x[0] == n) for n in ("hold.sampler", "hold.grad")]
    assert sampler[2] <= grad[1]
    for nid in NODES:
        assert _inside(spans, "hold.sampler", f"hold.sample_z.{nid}"), nid
        for inner in (f"hold.forward.{nid}", f"hold.targets.{nid}"):
            assert _inside(spans, "hold.grad", inner), inner
    for inner in ("hold.composite", "hold.background", "hold.losses", "hold.backward",
                  "hold.adam"):
        assert _inside(spans, "hold.grad", inner), inner
    assert set(names) <= {"hold.sampler", "hold.grad", "hold.composite", "hold.background",
                          "hold.losses", "hold.backward", "hold.adam"} | {
        f"hold.{k}.{nid}" for k in ("sample_z", "forward", "targets") for nid in NODES}


def test_render_frame_emits_stage_and_node_spans(toy, tmp_path):
    seq, scene, params = toy
    fb = seq.full_frame_batch(0, downsample=4)  # 12 x 16 pixels: 3 chunks of 64
    spans = _hold_spans(_profiled(
        lambda: render_frame(params, scene, fb, pixel_per_batch=64)), tmp_path)
    names = [n for n, _, _ in spans]
    assert names.count("hold.packs") == names.count("hold.gather") == 1
    assert names.count("hold.sampler") == names.count("hold.shade") == 3
    first = min(s for n, s, _ in spans if n == "hold.sampler")
    last = max(e for n, _, e in spans if n == "hold.shade")
    packs, gather = [next(x for x in spans if x[0] == n) for n in ("hold.packs", "hold.gather")]
    assert packs[2] <= first and last <= gather[1]
    for nid in NODES:
        assert _inside(spans, "hold.sampler", f"hold.sample_z.{nid}"), nid
        assert _inside(spans, "hold.shade", f"hold.render.{nid}"), nid
    for inner in ("hold.composite", "hold.background"):
        assert _inside(spans, "hold.shade", inner), inner


def test_step_timer_times_the_stages_on_the_host(toy):
    timer = tracing.StepTimer()
    go = _step_fn(toy, timer)
    for step in range(2):
        aux = go(step)
    assert torch.isfinite(aux["loss"])
    assert timer.counts == {"sampler": 2, "grad": 2}
    summ = timer.summary()
    assert set(summ) == {"sampler", "grad"} and all(v > 0 for v in summ.values())

    seq, scene, params = toy
    chunk_timer = tracing.StepTimer()
    render_frame(params, scene, seq.full_frame_batch(0, downsample=4), pixel_per_batch=64,
                 chunk_fn=make_chunk_renderer(scene, chunk_timer))
    assert chunk_timer.counts == {"sampler": 3, "shade": 3}
    assert set(chunk_timer.totals) == {"sampler", "shade"}


class _Event:
    """A stand-in for ``torch.cuda.Event``: recorded at a fake stream time,
    reached once the fake device's clock passes it."""

    clock = 0.0  # the device's progress, ms
    issued = 0.0  # the stream time the next mark is recorded at, ms
    syncs = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        self.at = _Event.issued

    def query(self):
        return self.at <= _Event.clock

    def synchronize(self):
        _Event.syncs += 1
        _Event.clock = max(_Event.clock, self.at)

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return end.at - self.at


def test_step_timer_marks_events_and_never_waits_until_read(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(_Event, "clock", 0.0)
    monkeypatch.setattr(_Event, "syncs", 0)
    dev = torch.device("cuda", 0)
    timer = tracing.StepTimer()
    for i, (a, b) in enumerate(((0.0, 4.0), (4.0, 10.0), (10.0, 11.0))):
        _Event.issued = a
        timer.start("grad", dev)
        _Event.issued = b
        timer.stop("grad")
        if i == 1:
            _Event.clock = 5.0  # the device has reached the first stop mark
    assert _Event.syncs == 0 and timer.counts == {"grad": 3}
    assert len(timer._pending) == 2  # the first phase was read back at the last stop
    timer.start("data")  # a host phase
    timer.stop("data")
    assert timer.totals["grad"] == pytest.approx(11.0e-3) and _Event.syncs == 2
    assert timer.summary()["grad"] == pytest.approx(11.0e-3 / 3) and "data" in timer.totals
