"""Host-built constants on a device without a stream sync.

A CPU tensor in pageable memory sent to a CUDA device with a plain
``.to(device)`` (or ``torch.tensor(..., device=)``, ``torch.as_tensor``) is
a ``cudaMemcpyAsync`` followed by a ``cudaStreamSynchronize``: the host
waits for every kernel already queued, and each short kernel after it then
costs its full host time.  Inside a training step or a render chunk the
port makes no such copy:

- ``constant(values, dtype, device)``: a constant that no step changes (an
  index list, a homogeneous row), made once per device and shared;
- ``cached(key, make)``: any value made by ``make()`` once per ``key`` (the
  key names the device), the ``CAPACITY`` most recently used kept; the BARF
  windows (``models/embedders.py::window_on``) are kept so;
- ``to_device(host, device)``: the copy itself, on a CUDA device from pinned
  memory with ``non_blocking=True`` (PyTorch's caching host allocator keeps
  the pinned block until its copy has run), elsewhere ``.to(device)``.

The values are those of the plain construction, bit for bit; only the way
they reach the device changes.  Callers must not write into what they are
given.  A value is sent on the current stream, and the port runs on each
device's default stream: a caller on another stream would have to wait for
it.  Each value made counts ``tracing.CONSTANTS["copied"]``, each reuse
``tracing.CONSTANTS["hits"]``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from .tracing import count_constant

CAPACITY = 32

_CACHE: OrderedDict = OrderedDict()
_LOCK = threading.Lock()


def device_of(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (the current CUDA
    device for a bare ``cuda``); None is the CPU."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(host: torch.Tensor, device) -> torch.Tensor:
    """The CPU tensor ``host`` on ``device``, with no stream sync on a CUDA
    device."""
    dev = device_of(device)
    if dev.type == "cuda":
        return host.pin_memory().to(dev, non_blocking=True)
    return host.to(dev)


def cached(key: tuple, make) -> torch.Tensor:
    """``make()``, made once per ``key`` and shared while it is among the
    ``CAPACITY`` keys used last."""
    with _LOCK:
        got = _CACHE.get(key)
        if got is not None:
            _CACHE.move_to_end(key)
    if got is not None:
        count_constant("hits")
        return got
    got = make()
    count_constant("copied")
    with _LOCK:
        _CACHE[key] = got
        while len(_CACHE) > CAPACITY:
            _CACHE.popitem(last=False)
    return got


def constant(values, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(values, dtype=dtype, device=device)``, made once
    per values, dtype and device."""
    arr = np.asarray(values)
    dev = device_of(device)
    key = ("constant", arr.tobytes(), arr.shape, arr.dtype.str, dtype, dev)
    return cached(key, lambda: to_device(torch.as_tensor(arr, dtype=dtype), dev))
