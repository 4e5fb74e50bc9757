"""``hold_tpu_torch.ops.chunk.map_chunked``: recomputation in the backward.

The chunked grad-stage shade takes ``autograd.grad(create_graph=True)``
inside its body and closes over the node's weights.  With ``remat`` (the
default, the JAX package's ``jax.checkpoint`` around the body) each chunk's
body runs again in the backward; without it (``HOLD_NO_REMAT=1`` there,
``--no_remat`` / ``build_scene(remat=False)`` here) every chunk's graph is
kept.  Checked on the CPU:

- outputs equal bit for bit, gradients of the chunk arguments and of the
  closed-over weights equal within 1e-6 relative (the weights' per-chunk sums
  are added in another order), and the body's call count shows the second run;
- under ``torch.no_grad`` the body runs once and nothing is wrapped;
- one grad stage of a toy scene with ``fused_train=False``: every parameter
  gradient with ``remat`` on equals the one with it off;
- the command line carries ``--no_remat`` to ``build_scene``.
"""

import copy

import numpy as np
import pytest
import torch

from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.models.losses import compute_losses
from hold_tpu_torch.ops.chunk import map_chunked
from hold_tpu_torch.train import batch_to_device
from hold_tpu_torch.utils.config import DEFAULT_CONFIG, parse_args
from hold_tpu_torch.utils.convert import flatten_params

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


def _run(remat, n, chunk, x_needs_grad):
    W1, W2, calls, make = _toy_body()
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(n, 3), dtype=torch.float32, requires_grad=x_needs_grad)
    s = torch.tensor(rng.rand(n, 1), dtype=torch.float32, requires_grad=True)
    w1 = W1 * 1.5  # closed over as a non-leaf, like a resolved weight norm
    sdf, g = map_chunked(make(w1), (x, s), n, chunk=chunk, remat=remat, closed=(w1, W2))
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
    assert kept[3:] == (n_chunks, n_chunks)
    assert again[3:] == (n_chunks, 2 * n_chunks)


def test_no_grad_runs_the_body_once_and_keeps_nothing():
    W1, W2, calls, make = _toy_body()
    x = torch.tensor(np.random.RandomState(2).randn(10, 3), dtype=torch.float32)
    with torch.no_grad():
        a = map_chunked(make(W1), (x, torch.ones(10, 1)), 10, chunk=4, closed=(W1, W2))
        b = map_chunked(make(W1), (x, torch.ones(10, 1)), 10, chunk=4, remat=False)
    assert calls[0] == 6
    for u, v in zip(a, b):
        assert torch.equal(u, v) and not u.requires_grad and u.grad_fn is None


def _toy_model():
    m = copy.deepcopy(DEFAULT_CONFIG["model"])
    m["proposal"]["enabled"] = False
    for k in ("implicit_network", "rendering_network"):
        m[k]["dims"] = [64] * len(m[k]["dims"])
    m["bg_implicit_network"]["dims"] = [96] * 8
    m["bg_rendering_network"]["dims"] = [32]
    m["ray_sampler"].update(N_samples=8, N_samples_eval=16, N_samples_extra=4,
                            max_total_iters=2, beta_iters=3)
    return m


def test_grad_stage_gradients_equal_with_and_without_remat():
    built = generate_sequence(None, n_frames=4, img_hw=(72, 96))
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    sd, model = seq.scene_data(), _toy_model()
    args = {"barf_s": 0, "barf_e": 1000}
    batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(0), 2, num_sample=8),
                            "cpu")
    B, P = batch["uv"].shape[:2]
    grads = {}
    for remat in (True, False):
        scene = thn.build_scene(model, args, sd, "cpu", fused_train=False, remat=remat)
        assert all(scene.plans[nid].remat is remat and not scene.plans[nid].fused_train
                   for nid in scene.node_ids)
        params = thn.init_scene_params(torch.Generator().manual_seed(0), scene, sd)
        gen = torch.Generator().manual_seed(5)
        z = thn.sample_all_z(params, scene, batch, gen, 300, 25)
        draws = thn.sample_step_draws(scene, B, P, gen)
        out = thn.holdnet_forward(params, scene, batch, thn.empty_object_mesh_state("cpu"),
                                  draws, 300, 25, z_vals_dict=z)
        losses = compute_losses(batch, out, scene.node_ids, 300)
        losses["loss"].backward()
        grads[remat] = (float(losses["loss"].detach()), flatten_params(params))
    assert grads[True][0] == grads[False][0]
    some = 0
    for k, p in grads[False][1].items():
        q = grads[True][1][k]
        assert (p.grad is None) == (q.grad is None), k
        if p.grad is None:
            continue
        some += int(p.grad.abs().max() > 0)
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(), rtol=RTOL,
                                   atol=RTOL * float(p.grad.abs().max()), err_msg=k)
    assert some > 50


def test_no_remat_flag_reaches_the_parser():
    assert parse_args(["--case", "toy", "--no_remat"])[0].no_remat
    assert not parse_args(["--case", "toy"])[0].no_remat
