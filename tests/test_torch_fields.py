"""hold_tpu_torch fields and rendering math against the JAX package.

Networks are initialised by the JAX package at toy widths (64, background
96), converted with ``utils.convert.params_from_jax``, and applied by both
packages to the same numpy inputs: embeddings (with the BARF window), the
implicit net (full, trunk and heads, first and second derivatives), the
rendering net in both modes, the bf16 sampler trunk, the background, the
VolSDF compositing and the losses.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hold_tpu.models import density as jden
from hold_tpu.models import embedders as jemb
from hold_tpu.models import losses as jloss
from hold_tpu.models import mlp as jmlp
from hold_tpu.models.specs import MANO_SPECS, OBJECT_SPECS
from hold_tpu.render import background as jbg
from hold_tpu.render import volsdf as jvs
from hold_tpu.utils.config import DEFAULT_CONFIG
from hold_tpu_torch.models import density as tden
from hold_tpu_torch.models import embedders as temb
from hold_tpu_torch.models import losses as tloss
from hold_tpu_torch.models import mlp as tmlp
from hold_tpu_torch.render import background as tbg
from hold_tpu_torch.render import volsdf as tvs
from hold_tpu_torch.utils.convert import flatten_params, params_from_jax

# fp32 products of width-64 layers: relative ~1e-6, absolute floor for
# values near zero
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _toy_model():
    m = copy.deepcopy(DEFAULT_CONFIG["model"])
    for k in ("implicit_network", "rendering_network"):
        m[k]["dims"] = [64] * len(m[k]["dims"])
    m["bg_implicit_network"]["dims"] = [96] * 8
    m["bg_rendering_network"]["dims"] = [32]
    return m


def _close_tree(got: dict, ref_tree, **tol):
    ref = flatten_params(params_from_jax(jax.device_get(ref_tree)))
    assert set(got) == set(ref)
    for k in ref:
        g = torch.zeros_like(ref[k]) if got[k] is None else got[k]
        np.testing.assert_allclose(g.detach().numpy(), ref[k].detach().numpy(), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("step", [None, 0, 300, 700, 5000])
def test_embedders_match_jax(step):
    x = np.random.RandomState(0).randn(50, 3).astype(np.float32)
    for mode in ("fourier", "barf"):
        ref = jemb.make_embedder(mode, 6, 0, 1000)(jnp.asarray(x),
                                                   None if step is None else jnp.asarray(step))
        got = temb.make_embedder(mode, 6, 0, 1000)(_t(x), step)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


IMPLICIT_CASES = [
    pytest.param("implicit_network", MANO_SPECS, id="hand_pose_cond_zeroed"),
    pytest.param("implicit_network", OBJECT_SPECS, id="object_barf"),
    pytest.param("bg_implicit_network", jbg.BG_SPECS, id="background_frame_cond"),
]


@pytest.mark.parametrize("net,specs", IMPLICIT_CASES)
def test_implicit_net_values_and_derivatives_match_jax(net, specs):
    opt = _toy_model()[net]
    plan = jmlp.implicit_net_shapes(opt, specs)
    jp = jax.jit(lambda k: jmlp.init_implicit_net(k, opt, specs))(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.device_get(jp))
    rng = np.random.RandomState(2)
    x = (rng.randn(40, plan["raw_in"]) * 0.3).astype(np.float32)
    cond = rng.randn(40, plan["cond_dim"]).astype(np.float32)
    step, barf = 400, (0, 1000)

    def jfn(p, x):
        full = jmlp.apply_implicit_net(p, plan, x, cond, step=step, barf_cfg=barf)
        h = jmlp.apply_implicit_trunk(p, plan, x, cond, step=step, barf_cfg=barf)
        sdf = lambda y: jnp.sum(jmlp.implicit_sdf_from_trunk(
            p, jmlp.apply_implicit_trunk(p, plan, y, cond, step=step, barf_cfg=barf)))
        g = jax.grad(sdf)(x)
        eik = jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)
        return full, jmlp.implicit_sdf_from_trunk(p, h), jmlp.implicit_feat_from_trunk(p, h), g, eik

    jfull, jsdf, jfeat, jg, _ = jax.jit(jfn)(jp, x)
    jeik_grad = jax.jit(jax.grad(lambda p: jfn(p, x)[4]))(jp)

    xt = _t(x, grad=True)
    h = tmlp.apply_implicit_trunk(tp, plan, xt, _t(cond), step=step, barf_cfg=barf)
    sdf = tmlp.implicit_sdf_from_trunk(tp, h)
    (g,) = torch.autograd.grad(sdf.sum(), xt, create_graph=True)
    eik = torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
    flat = flatten_params(tp)
    grads = torch.autograd.grad(eik, list(flat.values()), allow_unused=True)
    full = tmlp.apply_implicit_net(tp, plan, _t(x), _t(cond), step=step, barf_cfg=barf)

    np.testing.assert_allclose(full.detach().numpy(), np.asarray(jfull), **FWD)
    np.testing.assert_allclose(sdf.detach().numpy(), np.asarray(jsdf), **FWD)
    np.testing.assert_allclose(tmlp.implicit_feat_from_trunk(tp, h).detach().numpy(),
                               np.asarray(jfeat), **FWD)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg), **GRAD)
    _close_tree(dict(zip(flat, grads)), jeik_grad, rtol=2e-4, atol=1e-5)


def test_bf16_sampler_trunk_matches_jax_at_bf16_tolerance():
    opt = _toy_model()["implicit_network"]
    plan = jmlp.implicit_net_shapes(opt, OBJECT_SPECS)
    jp = jax.jit(lambda k: jmlp.init_implicit_net(k, opt, OBJECT_SPECS))(jax.random.PRNGKey(3))
    x = (np.random.RandomState(4).randn(200, 3) * 0.4).astype(np.float32)

    def jfn(p):
        pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    jmlp.resolve_weight_norm(p))
        h = jmlp.apply_implicit_trunk(pb, plan, x, None, step=300, barf_cfg=(0, 1000))
        return jmlp.implicit_sdf_from_trunk(pb, h).astype(jnp.float32)

    ref = np.asarray(jax.jit(jfn)(jp))
    tp = tmlp.cast_tree(tmlp.resolve_weight_norm(params_from_jax(jax.device_get(jp))),
                        torch.bfloat16)
    h = tmlp.apply_implicit_trunk(tp, plan, _t(x), None, step=300, barf_cfg=(0, 1000))
    got = tmlp.implicit_sdf_from_trunk(tp, h).detach().numpy()
    # bf16 keeps 8 bits of mantissa; XLA and PyTorch round at other places
    # along the 8-layer chain
    np.testing.assert_allclose(got, ref, rtol=3e-2, atol=3e-2 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["pose", "nerf_frame_encoding"])
def test_rendering_net_matches_jax(mode):
    m = _toy_model()
    opt = m["rendering_network"] if mode == "pose" else m["bg_rendering_network"]
    specs = MANO_SPECS if mode == "pose" else jbg.BG_SPECS
    plan = jmlp.rendering_net_shapes(opt, specs)
    jp = jax.jit(lambda k: jmlp.init_rendering_net(k, opt, specs))(jax.random.PRNGKey(5))
    tp = params_from_jax(jax.device_get(jp))
    rng = np.random.RandomState(6)
    N = 30
    pts, nrm, vw = (rng.randn(3, N, 3) * 0.5).astype(np.float32)
    feat = rng.randn(N, opt["feature_vector_size"]).astype(np.float32)
    pose = rng.randn(N, 45).astype(np.float32)
    latent = rng.randn(N, opt.get("dim_frame_encoding", 1)).astype(np.float32)
    if mode == "pose":
        args = (pts, nrm, vw, pose, feat)
        kw = {}
    else:
        args = (None, None, vw, None, feat)
        kw = {"frame_latent_code": latent}

    def jfn(p):
        return jnp.sum(jmlp.apply_rendering_net(p, plan, *args, **kw) ** 2)

    ref = jax.jit(lambda p: jmlp.apply_rendering_net(p, plan, *args, **kw))(jp)
    ref_g = jax.jit(jax.grad(jfn))(jp)
    targs = [None if a is None else _t(a) for a in args]
    tkw = {k: _t(v) for k, v in kw.items()}
    out = tmlp.apply_rendering_net(tp, plan, *targs, **tkw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    flat = flatten_params(tp)
    grads = torch.autograd.grad((out ** 2).sum(), list(flat.values()))
    _close_tree(dict(zip(flat, grads)), ref_g, **GRAD)


def test_volsdf_compositing_matches_jax():
    rng = np.random.RandomState(7)
    B, P, R = 2, 6, 12
    uv = rng.rand(B, P, 2).astype(np.float32) * 100
    K = np.tile(np.array([[120, 0.5, 50, 0], [0, 110, 40, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                         np.float32), (B, 1, 1))
    E = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    E[:, :3, 3] = rng.randn(B, 3) * 0.1
    jd, jc = jvs.get_camera_rays(jnp.asarray(uv), jnp.asarray(E), jnp.asarray(K))
    td, tc = tvs.get_camera_rays(_t(uv), _t(E), _t(K))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **FWD)
    cam = np.repeat(np.asarray(jc), P, axis=0)
    np.testing.assert_allclose(
        tvs.get_sphere_intersections(_t(cam), td.reshape(-1, 3), 3.0).numpy(),
        np.asarray(jvs.get_sphere_intersections(jnp.asarray(cam), jd.reshape(-1, 3), 3.0)),
        **FWD)

    # two nodes whose near/far book-ends tie exactly, as in training
    def node(seed, S):
        r = np.random.RandomState(seed)
        z = np.sort(r.rand(R, S - 2) * 2.5 + 0.1, axis=1)
        z = np.concatenate([np.zeros((R, 1)), z, np.full((R, 1), 2.8)], 1).astype(np.float32)
        return {"z_vals": z, "color": r.rand(R, S, 3).astype(np.float32),
                "normal": r.randn(R, S, 3).astype(np.float32),
                "density": (r.rand(R, S, 1) * 20).astype(np.float32),
                "semantics": r.rand(R, S, 4).astype(np.float32)}

    nodes = [node(8, 10), node(9, 14)]

    def jfn(nodes):
        merged = jvs.merge_factors(nodes)
        out = jvs.volumetric_render(merged, True)
        f = dict(nodes[0])
        f["z_max"] = f["z_vals"][:, -1]
        return out, jvs.volumetric_render(f, True)

    jout, jnode = jax.jit(jfn)([{k: jnp.asarray(v) for k, v in n.items()} for n in nodes])
    tn = [{k: _t(v) for k, v in n.items()} for n in nodes]
    tout = tvs.volumetric_render(tvs.merge_factors(tn))
    f = dict(tn[0])
    f["z_max"] = f["z_vals"][:, -1]
    tnode = tvs.volumetric_render(f)
    for ref, got in ((jout, tout), (jnode, tnode)):
        assert set(ref) == set(got)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **FWD)


def test_background_forward_and_grads_match_jax():
    m = _toy_model()
    plans = jbg.background_plans(m)
    jp = jax.jit(lambda k: jbg.init_background(k, m, 4))(jax.random.PRNGKey(10))
    tp = params_from_jax(jax.device_get(jp))
    rng = np.random.RandomState(11)
    R, S = 16, 8
    dirs = rng.randn(R, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    cam = (rng.randn(R, 3) * 0.2).astype(np.float32)
    z = np.sort(rng.rand(R, S), axis=1).astype(np.float32) / 3.0
    bgw = rng.rand(R).astype(np.float32)
    fidx = rng.randint(0, 4, R)

    def jfn(p):
        out = jbg.background_forward(p, plans, bgw, dirs, cam, z, fidx, 3.0, step=10)
        return jnp.sum(out["bg_rgb"] ** 2), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jp)
    tout = tbg.background_forward(tp, plans, _t(bgw), _t(dirs), _t(cam), _t(z),
                                  torch.tensor(fidx), 3.0, step=10)
    for k in jout:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), err_msg=k,
                                   **FWD)
    flat = flatten_params(tp)
    grads = torch.autograd.grad((tout["bg_rgb"] ** 2).sum(), list(flat.values()),
                                allow_unused=True)
    _close_tree(dict(zip(flat, grads)), jg, **GRAD)


@pytest.mark.parametrize("step", [0, 300, 40000])
def test_losses_match_jax(step):
    rng = np.random.RandomState(step % 97)
    R, Ns = 20, 15
    outputs = {
        "rgb": rng.rand(R, 3), "semantics": rng.rand(R, 4),
        "right.index_off_surface": rng.rand(R) > 0.5, "right.active": np.float32(1.0),
        "right.mask_prob": rng.rand(R, 1), "right.grad_theta": rng.randn(2, Ns, 3),
        "right.pts2mano_sdf_cano": rng.randn(2, Ns) * 0.01, "right.pred_sdf": rng.randn(2, Ns) * 0.01,
        "object.index_off_surface": rng.rand(R) > 0.3, "object.active": np.float32(1.0),
        "object.mask_prob": rng.rand(R, 1), "object.grad_theta": rng.randn(2, Ns, 3) * 30,
    }
    outputs = {k: np.asarray(v, np.float32) if not isinstance(v, np.ndarray) or v.dtype != bool
               else v for k, v in outputs.items()}
    batch = {"gt_rgb": rng.rand(R, 3).astype(np.float32),
             "gt_mask": rng.choice([0, 50, 150, 250], R).astype(np.float32)}
    ref = jax.jit(lambda b, o, s: jloss.compute_losses(b, o, ("right", "object"), s))(
        batch, outputs, jnp.asarray(step))
    got = tloss.compute_losses({k: _t(v) for k, v in batch.items()},
                               {k: _t(v) for k, v in outputs.items()}, ("right", "object"), step)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, atol=1e-7, err_msg=k)


def test_laplace_density_matches_jax():
    sdf = np.linspace(-0.5, 0.5, 101).astype(np.float32)
    ref = jden.laplace_density({"beta": jnp.asarray(0.05, jnp.float32)}, jnp.asarray(sdf))
    got = tden.laplace_density({"beta": torch.tensor(0.05)}, _t(sdf))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
