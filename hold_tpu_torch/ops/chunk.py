"""Chunked point-wise mapping (counterpart of hold_tpu/ops/chunk.py).

``map_chunked`` splits a flat point axis into fixed chunks, runs the body on
each and concatenates the outputs, which bounds the size of each chunk's
intermediate tensors.  With ``remat`` (the default, the JAX package's
``jax.checkpoint`` around the body) autograd keeps only each chunk's inputs
and runs the body again in the backward pass; without it (the JAX package's
``HOLD_NO_REMAT=1``) every chunk's graph stays alive until the backward.
"""

from __future__ import annotations

import torch

DEFAULT_CHUNK = 32768


class _Remat(torch.autograd.Function):
    """``body`` on one chunk, keeping its inputs only.  The backward runs the
    body again under grad mode and differentiates that graph once, towards
    the chunk's arguments and the tensors the body closes over (``closed``),
    so a body that takes ``autograd.grad(create_graph=True)`` inside is
    differentiated through it exactly as without recomputation."""

    @staticmethod
    def forward(ctx, body, n_args, *tensors):
        ctx.body, ctx.n_args = body, n_args
        ctx.save_for_backward(*tensors)
        outs = body(*tensors[:n_args])
        return tuple(o.detach() for o in outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gouts):
        tensors = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = [t.detach().requires_grad_(needs[i]) for i, t in enumerate(tensors[:ctx.n_args])]
            outs = ctx.body(*args)
        live = [(o, g) for o, g in zip(outs, gouts) if g is not None and o.requires_grad]
        wanted = [i for i, need in enumerate(needs) if need]
        targets = [args[i] if i < ctx.n_args else tensors[i] for i in wanted]
        grads = [None] * len(tensors)
        if live and targets:
            got = torch.autograd.grad([o for o, _ in live], targets, [g for _, g in live],
                                      allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = g
        return (None, None, *grads)


def map_chunked(body, args: tuple, n: int, chunk: int = DEFAULT_CHUNK, remat: bool = True,
                closed: tuple = ()):
    """Apply ``body(*chunk_args) -> tuple of (C, ...)`` over a flat axis of
    length ``n`` shared by every tensor in ``args``.

    ``closed`` lists the tensors the body closes over whose gradients the
    caller wants: with ``remat`` they reach them only when named here.  Under
    ``torch.no_grad`` nothing is kept either way and the body runs as is."""
    if remat and torch.is_grad_enabled():
        closed = tuple(c for c in closed if c.requires_grad)

        def run(*a):
            return _Remat.apply(body, len(a), *a, *closed)
    else:
        run = body
    if n <= chunk:
        return run(*args)
    outs = [run(*(a[s:s + chunk] for a in args)) for s in range(0, n, chunk)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
