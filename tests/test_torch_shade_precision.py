"""The chunked grad-stage shade's bf16 products.

On its accelerator the JAX package runs the chunked shade's 256-wide trunk
and colour-net products in bf16 (``hold_tpu.models.nodes._shade_params``).
The port does the same on the card (``NodePlans.shade_bf16``, set by
``build_scene`` from the device) and stays in float32 on the CPU, as the
JAX package does off its accelerator.  Checked on the CPU at toy width
(``test_torch_train_step``'s scene, the JAX nodes' KNN warps in interpret
mode): the bf16 shade, its plans replaced (``tests/torch_plans.py``),
against the JAX chunked shade with ``_shade_params`` patched to
``_bf16_tree``: one grad stage's loss terms and every parameter gradient,
at the bounds below; the float32 port against the same bf16 JAX stage must
exceed them somewhere (the bounds see the precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hold_tpu.models import holdnet as jhn
from hold_tpu.models import losses as jloss
from hold_tpu.models import nodes as jnodes
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.models.losses import compute_losses
from hold_tpu_torch.train import batch_to_device
from hold_tpu_torch.utils.convert import flatten_params, params_from_jax
from test_torch_train_step import ARGS, EPOCH, STEP, _draws_from_jax_keys, _toy_model
from test_torch_train_step import pallas_knn  # noqa: F401  (a fixture)
from torch_plans import with_plans

# bf16 against bf16 on two libraries: each rounds its products' outputs and
# elementwise steps to bf16 at its own places.  Read here: the loss terms
# within 7.6e-6 relative, the worst gradient within 0.0244 of its tensor's
# largest element (the object's colour net); the float32 port against the
# same bf16 stage 2.6e-5 (loss/rgb) and 0.060 (the hand's colour net)
BF16_LOSS_RTOL, BF16_LOSS_ATOL = 1e-5, 1e-7
BF16_GRAD_REL = 3e-2  # |d| <= BF16_GRAD_REL * max|ref| + 1e-6, per tensor


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy(pallas_knn):  # noqa: F811
    built = generate_sequence(None, n_frames=4, img_hw=(72, 96))
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    sd = seq.scene_data()
    model = _toy_model()
    jscene = jhn.build_scene(model, ARGS, sd)
    jparams = jhn.init_scene_params(jax.random.PRNGKey(0), jscene, sd)
    batch_np = seq.sample_tempo_batch(np.random.RandomState(0), 1, num_sample=8)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    z = jax.jit(lambda p, b: jhn.sample_all_z(p, jscene, b, None, jnp.asarray(STEP),
                                              jnp.asarray(EPOCH)))(jparams, jbatch)
    return {"seq": seq, "sd": sd, "model": model, "jscene": jscene, "jparams": jparams,
            "batch_np": batch_np, "jbatch": jbatch, "jz": jax.device_get(z)}


def _port_stage(toy, **plans):
    """(loss dict, flat params with .grad) of one port grad stage on the
    toy's batch at JAX's z tables and draws, the chunked shade; ``plans``
    replace the scene's."""
    scene = with_plans(thn.build_scene(toy["model"], ARGS, toy["sd"], "cpu"), fused_shade=False,
                       **plans)
    params = params_from_jax(jax.device_get(toy["jparams"]))
    batch = batch_to_device(toy["batch_np"], "cpu")
    B, P = toy["batch_np"]["uv"].shape[:2]
    draws = _draws_from_jax_keys(jax.random.PRNGKey(7), toy["jscene"], B, P)
    out = thn.holdnet_forward(params, scene, batch, thn.empty_object_mesh_state("cpu"), draws,
                              STEP, EPOCH, {k: torch.tensor(v) for k, v in toy["jz"].items()})
    losses = compute_losses(batch, out, scene.node_ids, STEP)
    losses["loss"].backward()
    return scene, {k: float(v.detach()) for k, v in losses.items()}, flatten_params(params)


@pytest.fixture(scope="module")
def jax_bf16(toy):
    """The JAX grad stage with the chunked shade's trees cast to bf16, as on
    its accelerator: losses and gradients."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnodes, "_shade_params", jnodes._bf16_tree)
    jscene, jbatch, jz = toy["jscene"], toy["jbatch"], toy["jz"]
    mesh_state = jhn.empty_object_mesh_state()

    def loss_fn(p):
        out = jhn.holdnet_forward(p, jscene, jbatch, mesh_state, jax.random.PRNGKey(7),
                                  jnp.asarray(STEP), jnp.asarray(EPOCH), training=True,
                                  z_vals_dict=jz)
        losses = jloss.compute_losses(jbatch, out, jscene.node_ids, jnp.asarray(STEP))
        return losses["loss"], losses

    try:
        (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(toy["jparams"])
        jl, jg = jax.device_get((jl, jg))
    finally:
        mp.undo()
    return {k: float(v) for k, v in jl.items()}, flatten_params(params_from_jax(jg))


def _grad_gaps(ref: dict, got: dict) -> list:
    """(path, max|d|, max|ref|) of each gradient beyond BF16_GRAD_REL."""
    bad = []
    for k, r in ref.items():
        if not got[k].requires_grad:  # obj_scale: fixed during scene training
            continue
        r = r.detach().numpy().astype(np.float64)
        g = np.zeros_like(r) if got[k].grad is None else got[k].grad.numpy()
        scale = max(np.abs(r).max(), 1e-8)
        if np.abs(g - r).max() > BF16_GRAD_REL * scale + 1e-6:
            bad.append((k, float(np.abs(g - r).max()), scale))
    return bad


def test_bf16_chunked_shade_matches_the_jax_bf16_shade(toy, jax_bf16):
    jl, jg = jax_bf16
    scene, tl, flat = _port_stage(toy, shade_bf16=True)
    assert all(p.shade_bf16 for p in scene.plans.values())
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=BF16_LOSS_RTOL, atol=BF16_LOSS_ATOL,
                                   err_msg=k)
    assert not _grad_gaps(jg, flat)
    # control: the float32 shade against the bf16 JAX stage must exceed the
    # bounds somewhere, or they could not tell the precisions apart
    _, tl32, flat32 = _port_stage(toy)
    loss_gaps = [k for k in jl if abs(tl32[k] - jl[k]) > BF16_LOSS_RTOL * abs(jl[k])
                 + BF16_LOSS_ATOL]
    assert loss_gaps or _grad_gaps(jg, flat32)
