"""The proposal net of hold_tpu_torch against the JAX package's.

The proposal is a small canonical-SDF surrogate, distilled from the trunk
at each step's samples (``loss/proposal``), that the sampler queries in
place of the trunk from ``model.proposal.warmup`` on.  A narrow toy scene
(widths 64, a short sampler, the proposal on) is built by both packages
from the same synthetic sequence; the port's init is carried into the JAX
tree (``jax_params_of``) or the JAX init into the port's
(``convert.params_from_jax``).  The JAX side's KNN warps run their Pallas
kernels in interpret mode.  Checked, each against ``hold_tpu``:

- ``apply_proposal_net`` on the f32 and the bf16 tree, inside and past the
  BARF window: f32 within 1e-6 (read on the CPU: 1.5e-8), bf16 within 4e-3
  max(1, |sdf|), about one bf16 step at |sdf| = 1 (both round every layer
  to bf16, the port's bias into the same rounding as its product; read:
  7.3e-4 at |sdf| ~ 0.12, two bf16 steps there);
- the proposal trees' paths and shapes, and ``params_from_jax`` carrying
  them;
- the z tables of the sampler in proposal mode, hand and object, at the
  bf16 tolerance of the trunk's sampler (a tenth of the median spacing);
- the grad stage with the proposal at the exact and at the proposal
  sampler's z tables (before and after the warmup): every loss term,
  ``loss/proposal`` included, at 2e-5, the full parameter gradient at
  2e-4 * scale + 2e-4, and one Adam step from the same gradients with the
  proposal's own group and rate against ``optimizer_for`` + optax at 1e-6;
- that ``loss/proposal`` reaches the proposal's tensors alone;
- that ``make_train_step`` samples in proposal mode from the warmup step on.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import (  # noqa: F401  (pallas_knn: a fixture)
    ARGS,
    EPOCH,
    STEP,
    _draws_from_jax_keys,
    _toy_model,
    jax_params_of,
    pallas_knn,
)

from hold_tpu.models import holdnet as jhn
from hold_tpu.models import losses as jloss
from hold_tpu.models import mlp as jmlp
from hold_tpu.models.nodes import _bf16_tree
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.models import mlp as tmlp
from hold_tpu_torch.models.losses import compute_losses
from hold_tpu_torch.train import batch_to_device, make_train_step, optimizer_for
from hold_tpu_torch.utils.config import Cfg
from hold_tpu_torch.utils.convert import flatten_params, params_from_jax
from torch_plans import with_plans

PROP_OPT = {"width": 64, "depth": 3, "multires": 6}
PROPOSAL_LR = 5e-3  # not ARGS' lr: a tensor in the wrong group moves otherwise


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these toy tensors (beside other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    m = _toy_model()
    m["proposal"] = dict(m["proposal"], enabled=True)
    return m


@pytest.mark.parametrize("tree", ["f32", "bf16"])
@pytest.mark.parametrize("step", [300, 5000], ids=["barf_window", "past_barf"])
def test_apply_proposal_net_matches_jax(tree, step):
    plan = jmlp.proposal_net_shapes(PROP_OPT)
    assert tmlp.proposal_net_shapes(PROP_OPT) == plan
    jparams = jmlp.init_proposal_net(jax.random.PRNGKey(3), PROP_OPT)
    tparams = params_from_jax(jax.device_get(jparams))
    if tree == "bf16":
        jparams, tparams = _bf16_tree(jparams), tmlp.cast_tree(tparams, torch.bfloat16)
    x = np.random.RandomState(5).uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    barf = (100, 1000)
    ref = np.asarray(jmlp.apply_proposal_net(jparams, plan, jnp.asarray(x), step=step,
                                             barf_cfg=barf))
    with torch.no_grad():
        got = tmlp.apply_proposal_net(tparams, plan, torch.tensor(x), step=step, barf_cfg=barf)
    assert got.dtype == torch.float32 and got.shape == (512,) and ref.dtype == np.float32
    d = np.abs(got.numpy() - ref)
    if tree == "f32":
        assert d.max() <= 1e-6, d.max()
    else:
        assert (d / np.maximum(1.0, np.abs(ref))).max() <= 4e-3, d.max()
    assert np.abs(ref).std() > 1e-3  # not a constant field


@pytest.fixture(scope="module")
def toy(pallas_knn):
    built = generate_sequence(None, n_frames=4, img_hw=(72, 96))
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    sd = seq.scene_data()
    model = _model()
    jscene = jhn.build_scene(model, ARGS, sd)
    tscene = with_plans(thn.build_scene(model, ARGS, sd, "cpu"), fused_shade=False)
    tparams = thn.init_scene_params(torch.Generator().manual_seed(0), tscene, sd)
    jparams = jax_params_of(tparams, jscene, sd)
    batch_np = seq.sample_tempo_batch(np.random.RandomState(0), 1, num_sample=8)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    sample = jax.jit(lambda p, b, mode: jhn.sample_all_z(p, jscene, b, None, jnp.asarray(STEP),
                                                         jnp.asarray(EPOCH), proposal_mode=mode),
                     static_argnums=2)
    jz = {mode: jax.device_get(sample(jparams, jbatch, mode)) for mode in (False, True)}
    return {"seq": seq, "sd": sd, "jscene": jscene, "tscene": tscene, "jparams": jparams,
            "batch_np": batch_np, "jbatch": jbatch, "jz": jz}


def _tparams(toy):
    return params_from_jax(jax.device_get(toy["jparams"]))


def test_proposal_trees_match_jax(toy):
    tscene, jscene, sd = toy["tscene"], toy["jscene"], toy["sd"]
    tparams = thn.init_scene_params(torch.Generator().manual_seed(0), tscene, sd)
    shapes = jax.eval_shape(lambda k: jhn.init_scene_params(k, jscene, sd), jax.random.PRNGKey(0))
    want = flatten_params(params_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)))
    got = flatten_params(tparams)
    assert set(got) == set(want)
    prop = [k for k in got if "/proposal/" in k]
    assert len(prop) == 8 * len(tscene.node_ids)  # 4 layers of {w, b} a node
    for k in prop:
        assert got[k].shape == want[k].shape and got[k].requires_grad, k
    assert got["right/proposal/layers/0/w"].shape == (64, 39)
    # drawn last: the rest is what the scene without the proposal draws
    off = thn.build_scene(_toy_model(), ARGS, sd, "cpu")
    before = flatten_params(thn.init_scene_params(torch.Generator().manual_seed(0), off, sd))
    assert set(before) == set(got) - set(prop)
    for k, v in before.items():
        assert torch.equal(v, got[k]), k


def test_params_from_jax_carries_the_proposal(toy):
    jparams = jax.device_get(toy["jparams"])
    tparams = params_from_jax(jparams)
    for nid in toy["tscene"].node_ids:
        for i, layer in enumerate(jparams[nid]["proposal"]["layers"]):
            for k in ("w", "b"):
                t = tparams[nid]["proposal"]["layers"][i][k]
                np.testing.assert_array_equal(t.detach().numpy(), np.asarray(layer[k]))
                assert t.requires_grad


@pytest.mark.parametrize("nid", ["right", "object"])
def test_proposal_mode_z_tables_match_jax(toy, nid):
    tparams = _tparams(toy)
    batch = batch_to_device(toy["batch_np"], "cpu")
    tz = thn.sample_all_z(tparams, toy["tscene"], batch, None, STEP, EPOCH, proposal_mode=True)
    ref = np.asarray(toy["jz"][True][nid])
    got = tz[nid].numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.all(np.diff(got, axis=1) >= 0)
    err = np.abs(got - ref).max()
    spacing = float(np.median(np.diff(ref, axis=1)))
    assert err <= 0.1 * spacing, (nid, err, spacing)
    # the control: the trunk's sampler places the samples elsewhere
    exact = np.asarray(toy["jz"][False][nid])
    assert np.abs(exact - ref).max() > 10 * err + 0.1 * spacing


@pytest.fixture(scope="module")
def grad_steps(toy):
    """Loss dicts and gradients of the grad stage from both packages at the
    exact sampler's z tables (before the warmup) and the proposal's (after)."""
    jscene, jbatch = toy["jscene"], toy["jbatch"]
    B, P = toy["batch_np"]["uv"].shape[:2]
    rng = jax.random.PRNGKey(7)
    mesh_state = jhn.empty_object_mesh_state()

    def loss_fn(p, z):
        out = jhn.holdnet_forward(p, jscene, jbatch, mesh_state, rng, jnp.asarray(STEP),
                                  jnp.asarray(EPOCH), training=True, z_vals_dict=z)
        losses = jloss.compute_losses(jbatch, out, jscene.node_ids, jnp.asarray(STEP))
        return losses["loss"], losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    draws = _draws_from_jax_keys(rng, jscene, B, P)
    tbatch = batch_to_device(toy["batch_np"], "cpu")
    out = {}
    for mode, jz in toy["jz"].items():
        (_, jl), jg = grad_fn(toy["jparams"], jz)
        tparams = _tparams(toy)
        res = thn.holdnet_forward(tparams, toy["tscene"], tbatch,
                                  thn.empty_object_mesh_state("cpu"), draws, STEP, EPOCH,
                                  {k: torch.tensor(np.asarray(v)) for k, v in jz.items()})
        tl = compute_losses(tbatch, res, toy["tscene"].node_ids, STEP)
        flat = flatten_params(tparams)
        trained = {k: v for k, v in flat.items() if v.requires_grad}
        prop_g = torch.autograd.grad(tl["loss/proposal"], list(trained.values()),
                                     retain_graph=True, allow_unused=True)
        tl["loss"].backward()
        out[mode] = {"jl": jax.device_get(jl), "jg": jax.device_get(jg), "tl": tl,
                     "tparams": tparams, "prop_g": dict(zip(trained, prop_g))}
    return out


@pytest.mark.parametrize("mode", [False, True], ids=["warmup", "proposal_mode"])
def test_loss_terms_match_jax(grad_steps, mode):
    jl, tl = grad_steps[mode]["jl"], grad_steps[mode]["tl"]
    assert set(jl) == set(tl)
    assert float(jl["loss/proposal"]) > 0
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]), rtol=2e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("mode", [False, True], ids=["warmup", "proposal_mode"])
def test_parameter_gradient_matches_jax(grad_steps, mode):
    ref = flatten_params(params_from_jax(grad_steps[mode]["jg"]))
    got = flatten_params(grad_steps[mode]["tparams"])
    assert set(ref) == set(got)
    bad = []
    for k, r in ref.items():
        r = r.detach().numpy().astype(np.float64)
        if not got[k].requires_grad:
            continue
        g = np.zeros_like(r) if got[k].grad is None else got[k].grad.numpy()
        scale = max(np.abs(r).max(), 1e-8)
        if np.abs(g - r).max() > 2e-4 * scale + 2e-4:
            bad.append((k, float(np.abs(g - r).max()), scale))
    assert not bad, bad
    assert all(float(ref[k].detach().abs().max()) > 0 for k in ref if "/proposal/layers/0/w" in k)


@pytest.mark.parametrize("mode", [False, True], ids=["warmup", "proposal_mode"])
def test_adam_step_with_the_proposal_group_matches_optax(grad_steps, toy, mode):
    import optax

    from hold_tpu.train import optimizer_for as jax_optimizer_for

    args = Cfg(ARGS)
    jparams, jg = toy["jparams"], grad_steps[mode]["jg"]
    tx = jax_optimizer_for(args, jparams, proposal_lr=PROPOSAL_LR)
    new = jax.jit(lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(jparams, jg)
    ref = flatten_params(params_from_jax(jax.device_get(new)))

    tparams = _tparams(toy)
    flat = flatten_params(tparams)
    for k, g in flatten_params(params_from_jax(jg)).items():
        if flat[k].requires_grad:
            flat[k].grad = g.detach().clone()
    opt = optimizer_for(args, tparams, proposal_lr=PROPOSAL_LR)
    assert [g["lr"] for g in opt.param_groups] == [ARGS["lr"], 0.1 * ARGS["lr"], PROPOSAL_LR]
    assert len(opt.param_groups[2]["params"]) == sum("/proposal/" in k for k in flat)
    opt.step()
    for k, r in ref.items():
        np.testing.assert_allclose(flat[k].detach().numpy(), r.detach().numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_proposal_loss_trains_only_the_proposal(grad_steps):
    """The JAX ``test_distillation_trains_only_proposal``: both the points
    and the targets of ``loss/proposal`` are detached."""
    prop_g = grad_steps[True]["prop_g"]
    for k, g in prop_g.items():
        if "/proposal/" in k:
            assert g is not None and float(g.abs().max()) > 0, k
        else:
            assert g is None or not bool(g.any()), k


def test_train_step_samples_in_proposal_mode_from_the_warmup(toy, monkeypatch):
    from hold_tpu_torch import train as ttrain

    model = _model()
    model["proposal"]["warmup"] = 2
    sd, seq = toy["sd"], toy["seq"]
    seen = []
    sample = ttrain.sample_all_z

    def recording(*a, proposal_mode=False, **kw):
        seen.append(proposal_mode)
        return sample(*a, proposal_mode=proposal_mode, **kw)

    monkeypatch.setattr(ttrain, "sample_all_z", recording)
    for proposal, want in ((True, [False, True]), (False, [False, False])):
        scene = with_plans(thn.build_scene(model, ARGS, sd, "cpu", proposal=proposal),
                           fused_shade=False)
        params = thn.init_scene_params(torch.Generator().manual_seed(0), scene, sd)
        opt = optimizer_for(Cfg(ARGS), params)
        assert len(opt.param_groups) == (3 if proposal else 2)
        step_fn = make_train_step(scene, opt)
        seen.clear()
        for step in (1, 2):
            batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(step), 1,
                                                           num_sample=8), "cpu")
            aux = step_fn(params, batch, thn.empty_object_mesh_state("cpu"),
                          torch.Generator().manual_seed(step), step, 0)
            assert all(bool(torch.isfinite(v)) for v in aux.values())
            assert (float(aux["loss/proposal"]) > 0) == proposal
        assert seen == want, (proposal, seen)
