"""The sampler's knobs of hold_tpu_torch against the JAX package's.

The JAX package switches them with environment variables
(``HOLD_NODE_BOUNDS``, ``HOLD_SAMPLER_KNN_STRIDE``, ``HOLD_SAMPLER_RELU``,
``HOLD_NO_PROPOSAL``), set here by ``monkeypatch`` when its side runs; the
port with ``build_scene`` keywords and the training CLI's flags.  Checked,
each against ``hold_tpu`` on the same numpy inputs:

- ``node_ray_interval`` (the JAX ``tests/test_node_bounds.py`` cases and 64
  random rays) within 1e-5, and the sampler with per-ray near / far within
  1e-5 of the JAX sampler, every sample inside its ray's interval, and the
  default interval unchanged when none is given;
- the toy scene's z tables with the node bounds, and the hand's in proposal
  mode on every 4th MANO vertex (the JAX package strides the proposal's and
  the fused query's searches only), at a tenth of the median sample
  spacing; a search given the full set's tile order for the strided set is
  refused;
- the plain relu query (what a wrapper runs on CPU tensors) against the
  Pallas kernels with ``relu=True`` in interpret mode, within the JAX
  package's fused-query bound (max 2e-2, mean 4e-3; read on the CPU: hand
  1.4e-4 / 4.5e-7, object 1.5e-3 / 4.0e-5); the softplus kernel against
  the relu plain version must exceed it (read: 7.4e-2 / 4.3e-2 and 7.7e-2 /
  2.7e-2);
- a checkpoint written without the proposal resumed with it: every saved
  Adam state restored bit for bit, the proposal's group fresh; the resumed
  run read back by ``load_experiment`` with its proposal nets;
- the flags and what they build.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_query import BARF, STEP as Q_STEP, _jax_window, _net, _rays, _rigid_tfs
from test_torch_train_step import ARGS, EPOCH, STEP, _toy_model, jax_params_of  # noqa: F401
from test_torch_train_step import pallas_knn  # noqa: F401  (a fixture)

from hold_tpu.mano.model_data import build_synthetic_mano
from hold_tpu.models import holdnet as jhn
from hold_tpu.ops import fused_query as jfq
from hold_tpu.render import ray_sampler as jrs
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.models.embedders import embed_window
from hold_tpu_torch.ops import fused_query as tfq
from hold_tpu_torch.ops import knn as tknn
from hold_tpu_torch.ops import weight_pack as wp
from hold_tpu_torch.render import ray_sampler as trs
from hold_tpu_torch.train import batch_to_device, optimizer_for, run_training
from hold_tpu_torch.utils import config as tconfig
from hold_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_experiment,
    load_optimizer_state,
    read_checkpoint,
)
from hold_tpu_torch.utils.config import Cfg
from hold_tpu_torch.utils.convert import flatten_params

MAX_TOL, MEAN_TOL = 2e-2, 4e-3  # the JAX package's fused-query bound


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these toy tensors (beside other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    d = dict(scene_bounding_sphere=3.0, near=0.0, N_samples=16, N_samples_eval=32,
             N_samples_extra=8, eps=0.1, beta_iters=4, max_total_iters=2,
             inverse_sphere_bg=True)
    d.update(kw)
    return jrs.SamplerConfig(**d), trs.SamplerConfig(**d)


def _interval_case(case):
    """(cam, dirs, center, radius) of one node-interval case, numpy."""
    if case == "hit_and_miss":  # sphere at z = 2, r = 0.5: two rays hit [1.5, 2.5], one misses
        cam = np.zeros((3, 3), np.float32)
        dirs = np.array([[0, 0, 1.0], [0, 0, 1.0], [1.0, 0, 0]], np.float32)
        return cam, dirs, np.array([[0, 0, 2.0]] * 3, np.float32), np.full(3, 0.5, np.float32)
    if case == "giant_sphere":  # the interval still ends at the scene's exit
        return (np.zeros((1, 3), np.float32), np.array([[0, 0, 1.0]], np.float32),
                np.zeros((1, 3), np.float32), np.array([50.0], np.float32))
    rng = np.random.RandomState(0)
    cam = (rng.randn(64, 3) * 0.5).astype(np.float32)
    dirs = rng.randn(64, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    center = (cam + dirs * rng.uniform(0.5, 2.0, (64, 1)) + rng.randn(64, 3) * 0.3)
    return cam, dirs, center.astype(np.float32), rng.uniform(0.1, 0.6, 64).astype(np.float32)


@pytest.mark.parametrize("case", ["hit_and_miss", "giant_sphere", "random"])
def test_node_ray_interval_matches_jax(case):
    jcfg, tcfg = _cfg()
    cam, dirs, center, radius = _interval_case(case)
    jn, jf = jrs.node_ray_interval(*map(jnp.asarray, (cam, dirs, center, radius)), jcfg)
    tn, tf = trs.node_ray_interval(*map(torch.tensor, (cam, dirs, center, radius)), tcfg)
    assert tn.shape == tf.shape == (cam.shape[0], 1)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5, rtol=1e-5)
    exit_ = trs.get_sphere_intersections(torch.tensor(cam), torch.tensor(dirs), r=3.0)[:, 1:]
    assert (tn <= tf).all() and (tn >= 0).all() and (tf <= exit_ + 1e-4).all()
    if case == "hit_and_miss":
        np.testing.assert_allclose(tn[:2, 0].numpy(), 1.5, atol=1e-5)
        np.testing.assert_allclose(tf[:2, 0].numpy(), 2.5, atol=1e-5)
        # the miss: an empty interval at the scene's exit, 3 from the origin
        np.testing.assert_allclose([float(tn[2, 0]), float(tf[2, 0])], 3.0, atol=1e-4)


def test_sampler_with_per_ray_near_far_matches_jax():
    jcfg, tcfg = _cfg()
    R = 4
    cam = np.zeros((R, 3), np.float32)
    dirs = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (R, 1))
    near = np.array([[0.5], [1.0], [1.5], [2.0]], np.float32)
    far = near + 0.4

    def plane(cam, dirs, z):  # a plane at z = 2 crosses some of the intervals
        return (cam[:, None] + z[..., None] * dirs[:, None])[..., 2] - 2.0

    ref = np.asarray(jax.jit(lambda d, c, n, f: jrs.error_bound_z_vals(
        None, None, d, c, jnp.asarray(0.05), jcfg, False,
        query_z_fn=lambda z: plane(c, d, z), near=n, far=f))(
            *map(jnp.asarray, (dirs, cam, near, far))))
    tc, td = torch.tensor(cam), torch.tensor(dirs)
    got = trs.error_bound_z_vals(None, None, td, tc, 0.05, tcfg,
                                 query_z_fn=lambda z: plane(tc, td, z),
                                 near=torch.tensor(near), far=torch.tensor(far)).numpy()
    assert got.shape == ref.shape == (R, 16 + 2 + 8)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_less(near[:, 0] - 1e-4, got.min(axis=1))
    np.testing.assert_array_less(got.max(axis=1), far[:, 0] + 1e-4)


def test_default_interval_is_unchanged_without_an_override():
    _, tcfg = _cfg()
    gen = np.random.RandomState(1)
    cam = torch.tensor(gen.randn(6, 3).astype(np.float32) * 0.2)
    dirs = torch.nn.functional.normalize(torch.tensor(gen.randn(6, 3).astype(np.float32)), dim=-1)

    def query(z):
        return torch.linalg.norm(cam[:, None] + z[..., None] * dirs[:, None], dim=-1) - 1.0

    plain = trs.error_bound_z_vals(None, None, dirs, cam, 0.05, tcfg, query_z_fn=query)
    far = trs.get_sphere_intersections(cam, dirs, r=3.0)[:, 1:]
    given = trs.error_bound_z_vals(None, None, dirs, cam, 0.05, tcfg, query_z_fn=query,
                                   near=torch.zeros(6, 1), far=far)
    assert torch.equal(plain, given)


@pytest.fixture(scope="module")
def toy(pallas_knn):
    built = generate_sequence(None, n_frames=4, img_hw=(72, 96))
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    batch_np = seq.sample_tempo_batch(np.random.RandomState(0), 1, num_sample=8)
    return {"seq": seq, "sd": seq.scene_data(), "batch_np": batch_np,
            "jbatch": {k: jnp.asarray(v) for k, v in batch_np.items()}}


def _model():
    model = _toy_model()
    model["proposal"] = dict(model["proposal"], enabled=True)
    return model


def _port_z(toy, proposal_mode: bool, **knobs):
    """The port's scene with the proposal on and ``knobs``, its params and
    z tables."""
    tscene = thn.build_scene(_model(), ARGS, toy["sd"], "cpu", **knobs)
    tparams = thn.init_scene_params(torch.Generator().manual_seed(0), tscene, toy["sd"])
    tz = thn.sample_all_z(tparams, tscene, batch_to_device(toy["batch_np"], "cpu"), None, STEP,
                          EPOCH, proposal_mode=proposal_mode)
    return tparams, tz


def _z_tables(toy, monkeypatch, env: dict, proposal_mode: bool, **knobs):
    """(JAX z tables, port z tables) of the toy scene with the proposal on,
    the JAX knobs set by ``env`` while it traces, the port's by ``knobs``."""
    tparams, tz = _port_z(toy, proposal_mode, **knobs)
    with monkeypatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        jscene = jhn.build_scene(_model(), ARGS, toy["sd"])
        jparams = jax_params_of(tparams, jscene, toy["sd"])
        jz = jax.device_get(jax.jit(lambda p, b: jhn.sample_all_z(
            p, jscene, b, None, jnp.asarray(STEP), jnp.asarray(EPOCH),
            proposal_mode=proposal_mode))(jparams, toy["jbatch"]))
    return jz, tz


def _hold_z(nid, got, ref):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.all(np.diff(got, axis=1) >= 0)
    err = np.abs(got - ref).max()
    spacing = float(np.median(np.diff(ref, axis=1)))
    assert err <= 0.1 * spacing, (nid, err, spacing)


def test_node_bounds_z_tables_match_jax(toy, monkeypatch):
    jz, tz = _z_tables(toy, monkeypatch, {"HOLD_NODE_BOUNDS": "1"}, False, node_bounds=True)
    _, free = _port_z(toy, False)
    for nid in jz:
        _hold_z(nid, tz[nid], jz[nid])
        # the control: the scene's interval samples elsewhere, farther out
        assert float(tz[nid].max()) < float(free[nid].max()) - 0.1, nid


def test_strided_hand_search_matches_jax(toy, monkeypatch):
    jz, tz = _z_tables(toy, monkeypatch, {"HOLD_SAMPLER_KNN_STRIDE": "4"}, True,
                       sampler_knn_stride=4)
    _hold_z("right", tz["right"], jz["right"])
    _, full = _port_z(toy, True)
    assert not torch.equal(full["right"], tz["right"])  # the control: all 778 vertices
    torch.testing.assert_close(full["object"], tz["object"], rtol=0, atol=0)


def test_strided_vertex_set_needs_its_own_order(toy):
    model = _toy_model()
    scene = thn.build_scene(model, ARGS, toy["sd"], "cpu", sampler_knn_stride=4)
    plans, verts = scene.plans["right"], scene.servers["right"].verts_c
    V = verts.shape[1]
    order = plans.stride_tile_order
    assert plans.knn_stride == 4 and order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(len(range(0, V, 4))))
    torch.testing.assert_close(order, tknn.tile_order(verts[0, ::4]), rtol=0, atol=0)
    sv = verts[:, ::4].contiguous()
    skin = scene.servers["right"].skin_weights_c[:, ::4].contiguous()
    tfs = torch.eye(4).expand(1, skin.shape[2], 4, 4).contiguous()
    pts = sv[:, :5] + 0.01
    with pytest.raises(ValueError, match="order"):
        tknn.knn_inverse_warp(pts, sv, skin, tfs, order=plans.tile_order)
    tknn.knn_inverse_warp(pts, sv, skin, tfs, order=order)
    assert thn.build_scene(model, ARGS, toy["sd"], "cpu").plans["right"].stride_tile_order is None


def _relu_case(kind, form, relu_kernel, B=2, P=6, S=64):
    """(JAX Pallas result with relu=``relu_kernel``, the port's plain relu
    result) for one of the four entry points."""
    rng = np.random.RandomState({"hand": 1, "object": 2}[kind])
    plan, jres, tres = _net(kind, seed={"hand": 3, "object": 4}[kind])
    jpack, tpack = jfq.pack_trunk_weights(jres, plan), wp.pack_trunk_weights(tres, plan)
    plan_arr = jfq.embed_plan(6, _jax_window(kind))
    window = embed_window(plan, Q_STEP, BARF)
    T = torch.tensor
    if kind == "hand":
        md = build_synthetic_mano(True)
        verts = (md.v_template[None] + rng.randn(B, 778, 3) * 0.003).astype(np.float32)
        skin = np.repeat(md.lbs_weights[None], B, axis=0).astype(np.float32)
        frame = (verts, skin, _rigid_tfs(rng, B, 16, 0.2, 0.02))
        dirs, cam, z, pts = _rays(rng, B, P, S, md.v_template.mean(0), 0.06)
    else:
        tfs = _rigid_tfs(rng, B, 1, 0.8, 0.1)[:, 0]
        rinv = np.linalg.inv(tfs[:, :3, :3]).reshape(B, 9)
        frame = (np.concatenate([rinv, tfs[:, :3, 3]], axis=-1).astype(np.float32),)
        dirs, cam, z, pts = _rays(rng, B, P, S, np.zeros(3), 0.3)
    jframe, tframe = tuple(map(jnp.asarray, frame)), tuple(map(T, frame))
    order = {"order": tknn.tile_order(tframe[0][0])} if kind == "hand" else {}
    hand = kind == "hand"
    if form == "z":
        rays8 = jfq.pack_rays8(jnp.asarray(dirs), jnp.asarray(cam), B, P, S)
        jfn = jfq.fused_hand_sampler_sdf_z if hand else jfq.fused_object_sampler_sdf_z
        tfn = tfq.fused_hand_sampler_sdf_z if hand else tfq.fused_object_sampler_sdf_z
        ref = jfn(rays8, jnp.asarray(z), *jframe, plan_arr, jpack, interpret=True,
                  relu=relu_kernel)
        got = tfn(T(dirs), T(cam), T(z), *tframe, window, tpack, relu=True, **order)
    else:
        jfn = jfq.fused_hand_sampler_sdf if hand else jfq.fused_object_sampler_sdf
        tfn = tfq.fused_hand_sampler_sdf if hand else tfq.fused_object_sampler_sdf
        ref = jfn(jnp.asarray(pts), *jframe, plan_arr, jpack, interpret=True, relu=relu_kernel)
        got = tfn(T(pts), *tframe, window, tpack, relu=True, **order)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("kind", ["hand", "object"])
@pytest.mark.parametrize("form", ["z", "buffer"])
def test_plain_relu_query_matches_the_relu_kernel(kind, form):
    ref, got = _relu_case(kind, form, relu_kernel=True)
    assert got.shape == ref.shape and got.dtype == np.float32
    d = np.abs(got - ref)
    assert d.max() <= MAX_TOL and d.mean() <= MEAN_TOL, (d.max(), d.mean())
    assert np.abs(ref).max() > 0.05  # not a degenerate field
    if form == "z":  # the control: the softplus kernel lies beyond the bound
        soft, _ = _relu_case(kind, form, relu_kernel=False)
        c = np.abs(got - soft)
        assert c.max() > MAX_TOL or c.mean() > MEAN_TOL, (c.max(), c.mean())


def test_no_proposal_checkpoint_resumes_with_the_proposal(toy, tmp_path):
    """A checkpoint of a run without the proposal (as every run before the
    port had one): resumed with it, each saved tensor's Adam state comes
    back bit for bit and the proposal starts from its init with a fresh
    state; one more step moves every group."""
    model = _model()
    cfg = {"model": model, "dataset": copy.deepcopy(tconfig.DEFAULT_CONFIG["dataset"])}
    cfg["dataset"]["train"]["batch_size"] = 1
    args = Cfg({**ARGS, "case": "toy", "num_sample": 8, "tempo_len": 1, "offset": 1,
                "log_every": 1, "no_meshing": True, "no_vis": True, "mute": True,
                "exp_key": "toy", "log_root": str(tmp_path), "seed": 0, "total_step": 1,
                "no_proposal": True})
    run_training(args, cfg, seq=toy["seq"], device="cpu")
    saved = read_checkpoint(latest_checkpoint(str(tmp_path / "toy")))
    assert not any("/proposal/" in k for k in saved["params"])
    assert len(saved["optimizer"]["param_groups"]) == 2

    scene = thn.build_scene(model, ARGS, toy["sd"], "cpu")
    params = thn.init_scene_params(torch.Generator().manual_seed(0), scene, toy["sd"])
    opt = optimizer_for(args, params)
    load_optimizer_state(opt, saved["optimizer"])
    st = opt.state_dict()
    assert len(st["param_groups"]) == 3
    old = saved["optimizer"]
    n_old = sum(len(g["params"]) for g in old["param_groups"])
    assert len(old["state"]) == n_old
    for i in range(n_old):
        for k, v in old["state"][i].items():
            assert torch.equal(st["state"][i][k], v), (i, k)
    assert not any(i in st["state"] for i in st["param_groups"][2]["params"])
    bad = {**old, "param_groups": old["param_groups"][::-1]}
    with pytest.raises(ValueError):
        load_optimizer_state(optimizer_for(args, params), bad)

    resumed = Cfg({**args, "no_proposal": False, "total_step": 2})
    params, scene, _, _, _, opt = run_training(resumed, cfg, seq=toy["seq"], device="cpu")
    counts = [{int(opt.state[p]["step"]) for p in g["params"]} for g in opt.param_groups]
    assert counts == [{2}, {2}, {1}], counts
    assert all(bool(torch.isfinite(t).all()) for t in flatten_params(params).values())
    # the loaders (render_cli, evaluate, optimize_ckpt, visualize_ckpt) read it back
    loaded, scene, step = load_experiment(str(tmp_path / "toy"), toy["seq"], "cpu")
    assert step == 2 and all(p.proposal is not None for p in scene.plans.values())
    for k, t in flatten_params(loaded).items():
        assert torch.equal(t, flatten_params(params)[k].detach()), k


def test_flags_give_the_scene_its_knobs(toy):
    argv = ["--case", "toy", "--no_proposal", "--node_bounds", "--sampler_knn_stride", "4",
            "--sampler_relu"]
    args, cfg = tconfig.parse_args(argv)
    assert cfg["model"]["proposal"]["enabled"] is True  # the flag, not the config, turns it off
    knobs = tconfig.sampler_flags(args)
    assert knobs == {"proposal": False, "node_bounds": True, "sampler_knn_stride": 4,
                     "sampler_relu": True}
    plans = thn.build_scene(_model(), ARGS, toy["sd"], "cpu", **knobs).plans
    assert all(p.proposal is None and p.node_bounds and p.sampler_relu for p in plans.values())
    assert plans["right"].knn_stride == 4 and plans["object"].stride_tile_order is None
    defaults = tconfig.sampler_flags(tconfig.parse_args(["--case", "toy"])[0])
    assert defaults == {"proposal": True, "node_bounds": False, "sampler_knn_stride": 1,
                        "sampler_relu": False}
    assert tconfig.sampler_flags({}) == defaults  # an older run's args.json


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the relu trunk and the strided search are CUDA only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hand", "object"])
def test_cuda_relu_and_strided_queries_match_plain(cuda, kind):
    """The relu trunk (both nodes) and the hand's search on every 4th
    vertex in its own tile order, kernel on the card against the plain
    version on the CPU, under the fused query's bound; each launch counted
    under its relu counter."""
    rng = np.random.RandomState(5)
    plan, _, tres = _net(kind, seed=6)
    pack = wp.pack_trunk_weights({"layers": [{k: v.to(cuda) for k, v in l.items()}
                                              for l in tres["layers"]]}, plan)
    cpack = {k: v.cpu() for k, v in pack.items()}
    window = embed_window(plan, Q_STEP, BARF, cuda)
    B, P, S = 3, 37, 128
    if kind == "hand":
        md = build_synthetic_mano(True)
        frame = (md.v_template[None].repeat(B, 0)[:, ::4],
                 md.lbs_weights[None].repeat(B, 0)[:, ::4], _rigid_tfs(rng, B, 16, 0.2, 0.02))
        dirs, cam, z, _ = _rays(rng, B, P, S, md.v_template.mean(0), 0.06)
        fz = tfq.fused_hand_sampler_sdf_z
    else:
        tfs = _rigid_tfs(rng, B, 1, 0.8, 0.1)[:, 0]
        frame = (np.concatenate([np.linalg.inv(tfs[:, :3, :3]).reshape(B, 9), tfs[:, :3, 3]],
                                axis=-1),)
        dirs, cam, z, _ = _rays(rng, B, P, S, np.zeros(3), 0.3)
        fz = tfq.fused_object_sampler_sdf_z
    frame = [torch.tensor(np.ascontiguousarray(a, np.float32), device=cuda) for a in frame]
    dirs, cam, z = (torch.tensor(a, device=cuda) for a in (dirs, cam, z))
    order = {"order": tknn.tile_order(frame[0][0])} if kind == "hand" else {}
    tfq.reset_launch_counts()
    got = fz(dirs, cam, z, *frame, window, pack, relu=True, **order)
    torch.cuda.synchronize()
    name = "fused_hand_sampler_sdf_z" if kind == "hand" else "fused_object_sampler_sdf_z"
    assert tfq.LAUNCHES[name + ".relu"] == 1 and tfq.LAUNCHES[name] == 0
    ref = fz(dirs.cpu(), cam.cpu(), z.cpu(), *[t.cpu() for t in frame], window.cpu(), cpack,
             relu=True, **order)
    d = (got.cpu() - ref).abs()
    assert d.max() <= MAX_TOL and d.mean() <= MEAN_TOL, (d.max(), d.mean())
