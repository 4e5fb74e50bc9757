"""The port's spans and its stage timer.

``span(name)`` is the one span primitive: inside a ``torch.profiler``
session it is a ``record_function`` range, which lands in the profiler's
trace beside the kernels it launched; outside one it is a shared no-op
that costs one check of ``torch.autograd._profiler_enabled()``.  Every
span of the port is named ``hold.<...>``:

- ``hold.sampler``, ``hold.grad`` (a training step's stages,
  ``train.py::make_train_step``), ``hold.sampler``, ``hold.shade`` (a
  render chunk's, ``render/renderer.py::make_chunk_renderer``);
- inside them ``hold.sample_z.<node>``, ``hold.forward.<node>``,
  ``hold.targets.<node>``, ``hold.render.<node>``, ``hold.composite``,
  ``hold.background`` (``models/holdnet.py``) and ``hold.losses``,
  ``hold.backward``, ``hold.adam``;
- a frame's ``hold.packs`` and ``hold.gather`` outside its chunks
  (``render_frame``).

``stage(name, timer, device)`` opens the stage span ``hold.<name>`` and,
given a ``StepTimer``, times the phase ``name``: on a CUDA device by two
events marked on its current stream, read back when the timer is read, so
that timing a stage never waits for the device.

``CONSTANTS`` counts the host-built constants that
``utils/device_constants.py`` puts on a device: ``copied`` for each one
made and sent, ``hits`` for each reuse of one already there.  While a
profiler records, ``CONSTANTS_BY_SPAN[(span, kind)]`` counts them by the
innermost port span open on the thread that opened it (``no span``
outside every one).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_OFF = contextlib.nullcontext()
_OPEN = threading.local()  # .names: the port spans open on this thread, innermost last

CONSTANTS = {"copied": 0, "hits": 0}
CONSTANTS_BY_SPAN: dict = {}


def reset_constant_counts() -> None:
    for k in CONSTANTS:
        CONSTANTS[k] = 0
    CONSTANTS_BY_SPAN.clear()


def count_constant(kind: str) -> None:
    """One more ``kind`` (``copied`` or ``hits``) in ``CONSTANTS``, and in
    ``CONSTANTS_BY_SPAN`` under the innermost open span while a profiler
    records."""
    CONSTANTS[kind] += 1
    if torch.autograd._profiler_enabled():
        names = getattr(_OPEN, "names", None)
        key = (names[-1] if names else "no span", kind)
        CONSTANTS_BY_SPAN[key] = CONSTANTS_BY_SPAN.get(key, 0) + 1


class _Span:
    """A ``record_function`` range that also keeps its name on the thread's
    stack of open spans while it is open."""

    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        names = getattr(_OPEN, "names", None)
        if names is None:
            names = _OPEN.names = []
        names.append(self.name)
        return self

    def __exit__(self, *exc):
        _OPEN.names.pop()
        return self.rf.__exit__(*exc)


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def stage(name: str, timer: StepTimer | None = None, device=None):
    """The stage span ``hold.<name>`` and, with ``timer``, its phase
    ``name`` (``StepTimer.start(name, device)`` ... ``stop(name)``)."""
    with span("hold." + name):
        if timer is None:
            yield
            return
        timer.start(name, device)
        yield
        timer.stop(name)


class StepTimer:
    """Per-phase time.  A phase started with a CUDA device is the stream's
    time between two events marked on that device's current stream at
    ``start`` and ``stop`` (no synchronisation); any other phase is the
    host clock's.  ``totals`` and ``summary()`` read the events back,
    waiting for those not yet reached; ``counts`` counts stopped phases."""

    def __init__(self):
        self._totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._start: dict = {}
        self._pending: list = []  # (phase, start event, stop event)

    def start(self, phase: str, device=None) -> None:
        if device is not None and torch.device(device).type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            self._start[phase] = (ev, device)
        else:
            self._start[phase] = time.perf_counter()

    def stop(self, phase: str) -> None:
        began = self._start.pop(phase)
        self.counts[phase] = self.counts.get(phase, 0) + 1
        if isinstance(began, float):
            self._add(phase, time.perf_counter() - began)
            return
        ev, device = began
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(device))
        self._pending.append((phase, ev, end))
        self._resolve(wait=False)

    def _add(self, phase: str, seconds: float) -> None:
        self._totals[phase] = self._totals.get(phase, 0.0) + seconds

    def _resolve(self, wait: bool) -> None:
        """Add each pending phase whose stop event the device has reached
        (every one with ``wait``)."""
        left = []
        for phase, a, b in self._pending:
            if wait:
                b.synchronize()
            elif not b.query():
                left.append((phase, a, b))
                continue
            self._add(phase, a.elapsed_time(b) * 1e-3)
        self._pending = left

    @property
    def totals(self) -> dict[str, float]:
        """Each phase's seconds so far."""
        self._resolve(wait=True)
        return self._totals

    def summary(self) -> dict[str, float]:
        totals = self.totals
        return {k: totals[k] / max(self.counts[k], 1) for k in sorted(totals)}
