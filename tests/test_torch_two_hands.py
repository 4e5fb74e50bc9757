"""Two-hand (ARCTIC-style) scenes in hold_tpu_torch against the JAX package
(the counterpart of tests/test_two_hands.py).

A toy two-hand synthetic sequence (right + left + object, widths 64, a short
sampler), built by the port's generator and read by both packages.  The
port's init, in the JAX package's tree, gives the JAX params, which are
converted back for the port; the JAX nodes' KNN warps run their Pallas
kernels in interpret mode, as in tests/test_torch_train_step.py.  Checked:

- node ids, class and segmentation ids, and the converted two-hand tree;
- the left hand's sealed faces and subdivision operator;
- both hands' pixels in a sampled batch;
- one grad stage (the port's z tables given to both packages, the same
  random draws): the loss dict, and every parameter's gradient at
  2e-4*scale + 2e-4, the tolerance of tests/test_torch_train_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import (  # noqa: F401  (pallas_knn is a fixture)
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
from hold_tpu.models import specs as jspecs
from hold_tpu.utils import mesh as jmesh
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.models import specs as tspecs
from hold_tpu_torch.models.losses import compute_losses
from hold_tpu_torch.train import batch_to_device
from hold_tpu_torch.utils import mesh as tmesh
from hold_tpu_torch.utils.convert import flatten_params, params_from_jax
from torch_plans import with_plans


@pytest.fixture(scope="module")
def two_hand(pallas_knn):
    built = generate_sequence(None, n_frames=4, img_hw=(72, 96), two_hands=True)
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    sd = seq.scene_data()
    model = _toy_model()
    jscene = jhn.build_scene(model, ARGS, sd)
    tscene = with_plans(thn.build_scene(model, ARGS, sd, "cpu"), fused_shade=False)
    jparams = jax_params_of(thn.init_scene_params(torch.Generator().manual_seed(0), tscene, sd),
                            jscene, sd)
    return {"seq": seq, "jscene": jscene, "jparams": jparams, "tscene": tscene}


def test_node_and_mask_ids(two_hand):
    assert two_hand["jscene"].node_ids == two_hand["tscene"].node_ids == ("right", "left",
                                                                          "object")
    assert tspecs.CLASS_IDS == jspecs.CLASS_IDS and tspecs.SEGM_IDS == jspecs.SEGM_IDS
    assert two_hand["seq"].hand_ids == ["right", "left"]
    batch = two_hand["seq"].sample_tempo_batch(np.random.RandomState(0), 1, num_sample=32)
    vals = set(np.round(batch["gt_mask"]).astype(int).tolist())
    assert any(100 <= v < 200 for v in vals)  # right (150)
    assert any(v >= 200 for v in vals)  # left (250)
    # the converted JAX tree is the port's tree, left hand and all
    tparams = thn.init_scene_params(torch.Generator().manual_seed(0), two_hand["tscene"],
                                    two_hand["seq"].scene_data())
    conv = params_from_jax(jax.device_get(two_hand["jparams"]))
    assert {k: v.shape for k, v in flatten_params(conv).items()} == \
        {k: v.shape for k, v in flatten_params(tparams).items()}
    assert any(k.startswith("left/implicit/") for k in flatten_params(conv))


def test_left_hand_mesh_operators_match_jax(two_hand):
    faces = two_hand["tscene"].servers["left"].consts.faces
    np.testing.assert_array_equal(tmesh.seal_mano_faces(faces, False),
                                  jmesh.seal_mano_faces(faces, False))
    M_t, f_t = tmesh.mano_subdivision_operator(faces, False)
    M_j, f_j = jmesh.mano_subdivision_operator(faces, False)
    np.testing.assert_array_equal(np.asarray(f_t), np.asarray(f_j))
    np.testing.assert_allclose(np.asarray(M_t, np.float64), np.asarray(M_j, np.float64),
                               atol=0)


@pytest.fixture(scope="module")
def grad_step(two_hand):
    """Loss dicts and gradients of one two-hand grad stage from both
    packages, at the port's z tables."""
    jscene, tscene = two_hand["jscene"], two_hand["tscene"]
    batch_np = two_hand["seq"].sample_tempo_batch(np.random.RandomState(0), 1, num_sample=8)
    B, P = batch_np["uv"].shape[:2]
    tbatch = batch_to_device(batch_np, "cpu")
    tparams = params_from_jax(jax.device_get(two_hand["jparams"]))
    z = thn.sample_all_z(tparams, tscene, tbatch, None, STEP, EPOCH)
    assert set(z) == {"right", "left", "object"}
    rng = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jz = {k: jnp.asarray(v.numpy()) for k, v in z.items()}
    mesh_state = jhn.empty_object_mesh_state()

    def loss_fn(p):
        out = jhn.holdnet_forward(p, jscene, jbatch, mesh_state, rng, jnp.asarray(STEP),
                                  jnp.asarray(EPOCH), training=True, z_vals_dict=jz)
        losses = jloss.compute_losses(jbatch, out, jscene.node_ids, jnp.asarray(STEP))
        return losses["loss"], losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(two_hand["jparams"])

    draws = _draws_from_jax_keys(rng, jscene, B, P)
    out = thn.holdnet_forward(tparams, tscene, tbatch, thn.empty_object_mesh_state("cpu"),
                              draws, STEP, EPOCH, z)
    tl = compute_losses(tbatch, out, tscene.node_ids, STEP)
    tl["loss"].backward()
    return {"jl": jax.device_get(jl), "jg": jax.device_get(jg), "tl": tl, "tparams": tparams}


def test_two_hand_loss_dict_matches_jax(grad_step):
    jl, tl = grad_step["jl"], grad_step["tl"]
    assert set(jl) == set(tl)
    assert float(jl["loss/mano_cano"]) > 0
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]), rtol=2e-5, atol=1e-6,
                                   err_msg=k)


def test_two_hand_gradients_match_jax(grad_step):
    ref = flatten_params(params_from_jax(grad_step["jg"]))
    got = flatten_params(grad_step["tparams"])
    assert set(ref) == set(got)
    bad = []
    for k, r in ref.items():
        r = r.detach().numpy().astype(np.float64)
        if not got[k].requires_grad:  # obj_scale: fixed during scene training
            continue
        g = np.zeros_like(r) if got[k].grad is None else got[k].grad.numpy()
        scale = max(np.abs(r).max(), 1e-8)
        if np.abs(g - r).max() > 2e-4 * scale + 2e-4:
            bad.append((k, float(np.abs(g - r).max()), scale))
    assert not bad, bad
    # both hands' nets and tables get gradients
    for nid in ("right", "left"):
        for part in ("implicit/layers/0/v", "tables/transl", "rendering/layers/0/v"):
            assert np.abs(ref[f"{nid}/{part}"].detach().numpy()).max() > 0, (nid, part)
