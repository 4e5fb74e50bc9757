"""Chunked point-wise mapping (counterpart of hold_tpu/ops/chunk.py).

``map_chunked`` splits a flat point axis into fixed chunks, runs the body on
each and concatenates the outputs.  It bounds the size of each chunk's
intermediate tensors; autograd keeps every chunk's graph (no recomputation).
"""

from __future__ import annotations

import torch

DEFAULT_CHUNK = 32768


def map_chunked(body, args: tuple, n: int, chunk: int = DEFAULT_CHUNK):
    """Apply ``body(*chunk_args) -> tuple of (C, ...)`` over a flat axis of
    length ``n`` shared by every tensor in ``args``."""
    if n <= chunk:
        return body(*args)
    outs = [body(*(a[s:s + chunk] for a in args)) for s in range(0, n, chunk)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
