"""One training step of hold_tpu_torch against the JAX package.

A narrow toy scene (widths 64, a short sampler) is built by both packages
from the same synthetic sequence; the JAX params are converted for the port.
The JAX side's three KNN warps in ``hold_tpu.models.nodes`` are patched to
their Pallas kernels in interpret mode for these tests, so both sides use the
Pallas neighbour semantics.  Checked:

- the sampler stage's z tables (bf16 trunk in both) at a bf16 tolerance;
- given JAX's z tables and the same random draws (rebuilt from JAX's key
  tree), the loss dict and the full parameter gradient of
  holdnet_forward + compute_losses, at 2e-4*scale + 2e-4 per tensor;
- one Adam step from the same params and gradients;
- that importing the port's entry points loads no JAX.
"""

import copy
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hold_tpu.models import holdnet as jhn
from hold_tpu.models import losses as jloss
from hold_tpu.models import nodes as jnodes
from hold_tpu.ops import knn as jknn
from hold_tpu.utils.config import DEFAULT_CONFIG
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.models.losses import compute_losses
from hold_tpu_torch.train import batch_to_device, optimizer_for
from hold_tpu_torch.utils.config import Cfg
from hold_tpu_torch.utils.convert import flatten_params, params_from_jax

STEP, EPOCH = 300, 25  # hand loss targets active, pose conditioning on
ARGS = {"barf_s": 0, "barf_e": 1000, "lr": 1e-3, "freeze_pose": False}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture(scope="module")
def pallas_knn():
    """The JAX nodes' KNN warps as Pallas kernels in interpret mode."""
    mp = pytest.MonkeyPatch()
    for name in ("knn_inverse_warp", "knn_inverse_warp_diff", "knn_jacobian_inverse"):
        mp.setattr(jnodes, name, functools.partial(getattr(jknn, name), interpret=True))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def toy(pallas_knn):
    built = generate_sequence(None, n_frames=4, img_hw=(72, 96))
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    sd = seq.scene_data()
    model = _toy_model()
    jscene = jhn.build_scene(model, ARGS, sd)
    jparams = jhn.init_scene_params(jax.random.PRNGKey(0), jscene, sd)
    # the JAX package's CPU default is the chunked shade (its fused one runs on
    # a TPU): compare the port's chunked shade with it
    tscene = thn.build_scene(model, ARGS, sd, "cpu", fused_train=False)
    batch_np = seq.sample_tempo_batch(np.random.RandomState(0), 1, num_sample=8)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    z = jax.jit(lambda p, b: jhn.sample_all_z(p, jscene, b, None, jnp.asarray(STEP),
                                              jnp.asarray(EPOCH)))(jparams, jbatch)
    return {"seq": seq, "jscene": jscene, "jparams": jparams, "tscene": tscene,
            "batch_np": batch_np, "jbatch": jbatch, "jz": jax.device_get(z)}


def _tparams(toy):
    return params_from_jax(jax.device_get(toy["jparams"]))


def _draws_from_jax_keys(rng, scene, B, P):
    """The random numbers holdnet_forward draws from ``rng``, in the port's
    draws layout, by walking JAX's key tree the way holdnet_forward does."""
    n = len(scene.node_ids)
    keys = jax.random.split(rng, n + 3)
    krest = keys[n]
    draws = {}

    def pis(key, N):
        k1, k2 = jax.random.split(key)
        return (jax.random.normal(k1, (B, N, 3)),
                jax.random.uniform(k2, (B, int(N * 0.2), 3)))

    for nid in scene.node_ids:
        krest, k = jax.random.split(krest)
        if nid == "object":
            k3, _ = jax.random.split(k)
            V = 16384
        else:
            k1, k2, k3 = jax.random.split(k, 3)
            kf, ku, kv = jax.random.split(k1, 3)
            F = scene.sub_ops[nid][1].shape[0]
            draws[f"{nid}.bary"] = (jax.random.randint(kf, (B, 256), 0, F),
                                    jax.random.uniform(ku, (B, 256, 1)),
                                    jax.random.uniform(kv, (B, 256, 1)))
            draws[f"{nid}.surf"] = pis(k2, 256)
            V = scene.servers[nid].verts_c.shape[1]
        ke1, ke2 = jax.random.split(k3)
        draws[f"{nid}.eik_idx"] = jax.random.permutation(ke1, V)[:256]
        draws[f"{nid}.eik"] = pis(ke2, min(V, 256))
    draws["bg_u"] = jax.random.uniform(keys[n + 1], (B * P, 32))

    def conv(x):
        a = np.asarray(x)
        return torch.tensor(a.astype(np.int64) if a.dtype.kind == "i" else a)

    return {k: tuple(map(conv, v)) if isinstance(v, tuple) else conv(v) for k, v in draws.items()}


def test_sampler_z_tables_match_jax_at_bf16_tolerance(toy):
    tparams = _tparams(toy)
    tz = thn.sample_all_z(tparams, toy["tscene"], batch_to_device(toy["batch_np"], "cpu"),
                          None, STEP, EPOCH)
    for nid, ref in toy["jz"].items():
        got = tz[nid].numpy()
        assert got.shape == ref.shape
        assert np.all(np.diff(got, axis=1) >= 0)
        # both run the trunk in bf16, rounding at different places: every
        # sample may move by a tenth of the median sample spacing
        err = np.abs(got - np.asarray(ref)).max()
        spacing = float(np.median(np.diff(ref, axis=1)))
        assert err <= 0.1 * spacing, (nid, err, spacing)


@pytest.fixture(scope="module")
def grad_step(toy):
    """Loss dicts and gradients of one grad stage from both packages."""
    jscene, jbatch, jz = toy["jscene"], toy["jbatch"], toy["jz"]
    B, P = toy["batch_np"]["uv"].shape[:2]
    rng = jax.random.PRNGKey(7)
    mesh_state = jhn.empty_object_mesh_state()

    def loss_fn(p):
        out = jhn.holdnet_forward(p, jscene, jbatch, mesh_state, rng, jnp.asarray(STEP),
                                  jnp.asarray(EPOCH), training=True, z_vals_dict=jz)
        losses = jloss.compute_losses(jbatch, out, jscene.node_ids, jnp.asarray(STEP))
        return losses["loss"], losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(toy["jparams"])

    tparams = _tparams(toy)
    tbatch = batch_to_device(toy["batch_np"], "cpu")
    draws = _draws_from_jax_keys(rng, jscene, B, P)
    out = thn.holdnet_forward(tparams, toy["tscene"], tbatch, thn.empty_object_mesh_state("cpu"),
                              draws, STEP, EPOCH, {k: torch.tensor(v) for k, v in jz.items()})
    tl = compute_losses(tbatch, out, toy["tscene"].node_ids, STEP)
    tl["loss"].backward()
    return {"jl": jax.device_get(jl), "jg": jax.device_get(jg), "tl": tl, "tparams": tparams}


def test_loss_dict_matches_jax(grad_step):
    jl, tl = grad_step["jl"], grad_step["tl"]
    assert set(jl) == set(tl)
    assert float(jl["loss/mano_cano"]) > 0 and float(jl["loss/opacity_sparse"]) > 0
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]), rtol=2e-5, atol=1e-6, err_msg=k)


def test_full_parameter_gradient_matches_jax(grad_step):
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
    nonzero = [k for k, r in ref.items() if np.abs(r.detach().numpy()).max() > 0]
    assert any("tables" in k for k in nonzero) and any("background" in k for k in nonzero)


def test_one_adam_step_matches_optax(grad_step, toy):
    import optax

    from hold_tpu.train import optimizer_for as jax_optimizer_for

    args = Cfg(ARGS)
    jparams, jg = toy["jparams"], grad_step["jg"]
    tx = jax_optimizer_for(args, jparams)
    new = jax.jit(lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(jparams, jg)
    ref = flatten_params(params_from_jax(jax.device_get(new)))

    tparams = _tparams(toy)
    flat = flatten_params(tparams)
    for k, g in flatten_params(params_from_jax(jg)).items():
        if flat[k].requires_grad:
            flat[k].grad = g.detach().clone()
    optimizer_for(args, tparams).step()
    for k, r in ref.items():
        np.testing.assert_allclose(flat[k].detach().numpy(), r.detach().numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_port_entry_points_import_no_jax():
    """The port's entry points and modules load neither JAX nor anything of
    the JAX package (hold_tpu)."""
    mods = ("hold_tpu_torch.train", "hold_tpu_torch.render_cli", "hold_tpu_torch.data.synthetic",
            "hold_tpu_torch.ops.fused_render", "hold_tpu_torch.ops.fused_shade",
            "hold_tpu_torch.render.renderer",
            "hold_tpu_torch.utils.checkpoint", "hold_tpu_torch.utils.logger",
            "hold_tpu_torch.utils.mesh", "hold_tpu_torch.models.specs",
            "hold_tpu_torch.mano.model_data", "chip_smoke")
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in ('jax', 'optax', 'orbax') if m in sys.modules]; "
            "assert not bad, bad; "
            "bad = [m for m in sys.modules if m == 'hold_tpu' or m.startswith('hold_tpu.')]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "HOLD_PLATFORM"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_run_training_writes_metrics_and_checkpoint(tmp_path):
    """The port's training loop on the CPU: a few steps of the toy scene,
    finite losses in metrics.jsonl, a torch.save checkpoint; the flags for
    what is not ported yet are refused."""
    import json

    from hold_tpu_torch.train import run_training

    built = generate_sequence(None, n_frames=4, img_hw=(72, 96))
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    cfg = {"model": _toy_model(), "dataset": copy.deepcopy(DEFAULT_CONFIG["dataset"])}
    cfg["dataset"]["train"]["batch_size"] = 1
    args = Cfg({**ARGS, "case": "toy", "num_sample": 8, "tempo_len": 4, "offset": 1,
                "log_every": 1, "no_meshing": True, "no_vis": True, "mute": True,
                "exp_key": "toy", "log_root": str(tmp_path), "seed": 0, "total_step": 3})
    run_training(args, cfg, seq=seq, device="cpu")
    lines = [json.loads(l) for l in open(tmp_path / "toy" / "metrics.jsonl")]
    assert [l["step"] for l in lines] == [0, 1, 2]
    assert all(np.isfinite(l["loss"]) and np.isfinite(l["psnr"]) for l in lines)
    ckpt = torch.load(tmp_path / "toy" / "checkpoints" / "last.pt")
    assert ckpt["step"] == 3 and "right/tables/transl" in ckpt["params"]
    with pytest.raises(NotImplementedError):
        run_training(Cfg({**args, "no_meshing": False}), cfg, seq=seq, device="cpu")
