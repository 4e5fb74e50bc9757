"""``hold_tpu_torch.ops.chunk.map_chunked``: recomputation in the backward.

The chunked grad-stage shade takes ``autograd.grad(create_graph=True)``
inside its body and closes over the node's weights.  Under grad mode each
chunk's body runs again in the backward (the JAX package's
``jax.checkpoint`` around the body).  Checked on the CPU against the body
applied to the whole input, its graph kept:

- outputs equal bit for bit, gradients of the chunk arguments and of the
  closed-over weights equal within 1e-6 relative (the weights' per-chunk sums
  are added in another order), and the body's call count shows the second run;
- under ``torch.no_grad`` the body runs once and nothing is wrapped.
"""

import numpy as np
import pytest
import torch

from hold_tpu_torch.ops.chunk import map_chunked

RTOL = 1e-6  # per-chunk weight-gradient sums are added in another order


def _toy_body():
    rng = np.random.RandomState(0)
    W1 = torch.tensor(rng.randn(16, 3), dtype=torch.float32, requires_grad=True)
    W2 = torch.tensor(rng.randn(1, 16), dtype=torch.float32, requires_grad=True)
    calls = [0]

    def make(w1):
        def body(x, s):
            calls[0] += 1
            with torch.enable_grad():
                if not x.requires_grad:
                    x = x.detach().requires_grad_(True)
                h = torch.nn.functional.softplus(x @ w1.T)
                sdf = (h @ W2.T)[:, 0]
                (g,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf), create_graph=True)
            return sdf, g * s

        return body

    return W1, W2, calls, make


def _run(chunked, n, chunk, x_needs_grad):
    """``map_chunked`` over the toy body, or (``chunked`` False) the body on
    the whole input with its graph kept."""
    W1, W2, calls, make = _toy_body()
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(n, 3), dtype=torch.float32, requires_grad=x_needs_grad)
    s = torch.tensor(rng.rand(n, 1), dtype=torch.float32, requires_grad=True)
    w1 = W1 * 1.5  # closed over as a non-leaf, like a resolved weight norm
    if chunked:
        sdf, g = map_chunked(make(w1), (x, s), n, chunk=chunk, closed=(w1, W2))
    else:
        sdf, g = make(w1)(x, s)
    forward_calls = calls[0]
    loss = (sdf ** 2).sum() + ((g.norm(dim=-1) - 1.0) ** 2).sum()
    loss.backward()
    grads = {"W1": W1.grad, "W2": W2.grad, "s": s.grad}
    if x_needs_grad:
        grads["x"] = x.grad
    return sdf.detach(), g.detach(), grads, forward_calls, calls[0]


@pytest.mark.parametrize("n,chunk", [(10, 4), (12, 4), (7, 32)])
@pytest.mark.parametrize("x_needs_grad", [False, True])
def test_remat_equals_kept_graph_and_runs_the_body_again(n, chunk, x_needs_grad):
    kept = _run(False, n, chunk, x_needs_grad)
    again = _run(True, n, chunk, x_needs_grad)
    assert torch.equal(kept[0], again[0]) and torch.equal(kept[1], again[1])
    assert set(kept[2]) == set(again[2])
    for k, ref in kept[2].items():
        assert ref is not None and ref.abs().max() > 0, k
        np.testing.assert_allclose(again[2][k].numpy(), ref.numpy(), rtol=RTOL,
                                   atol=RTOL * float(ref.abs().max()), err_msg=k)
    n_chunks = -(-n // chunk)
    assert kept[3:] == (1, 1)
    assert again[3:] == (n_chunks, 2 * n_chunks)


def test_no_grad_runs_the_body_once_and_keeps_nothing():
    W1, W2, calls, make = _toy_body()
    x = torch.tensor(np.random.RandomState(2).randn(10, 3), dtype=torch.float32)
    with torch.no_grad():
        a = map_chunked(make(W1), (x, torch.ones(10, 1)), 10, chunk=4, closed=(W1, W2))
        b = map_chunked(make(W1), (x, torch.ones(10, 1)), 10, chunk=4)
    assert calls[0] == 6
    for u, v in zip(a, b):
        assert torch.equal(u, v) and not u.requires_grad and u.grad_fn is None
