"""hold_tpu_torch's render path against the JAX package.

At the fused render kernel's full width (implicit net 8x256, rendering net
4x256), everything else small; inputs are made with numpy from a seed and the
JAX Pallas kernels run in interpret mode.  Checked:

- the transposed trunk pack, the colour pack and the frame bias equal the
  JAX package's exactly on every entry the JAX packs hold;
- ``fused_hand_render`` / ``fused_object_render`` on CPU tensors (their
  plain versions) against the Pallas kernels, B=2 x N=600 points, within the
  JAX package's own bounds between its kernel and its XLA path
  (tests/test_fused_render.py): x_c and distance 1e-4, sdf max 2e-2 and mean
  4e-3, rgb 3e-2, normal p99 0.08; the plain versions keep the kernel's
  sums and roundings, so tighter bounds are held too (``TIGHT``);
- ``knn_blend_weights`` / ``knn_blend_weights_t`` against the Pallas
  blend kernels;
- the node render forwards against the JAX nodes at ``training=False``
  under ``HOLD_FUSED_RENDER=interpret``;
- the slice: ``render_frame`` against the JAX ``render_frame`` on a 3-frame
  48x64 sequence at ``render_downsample`` 8, the JAX fused sampler in
  interpret mode;
- ``render_cli`` from a checkpoint that ``run_training`` wrote, on the CPU;
- that the entry points refuse to run without a card unless asked for the CPU.

The CUDA kernels are held against the plain versions on the card (marked
``gpu``; skipped without one).
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hold_tpu.data.dataset import SequenceData as JSequenceData
from hold_tpu.models import holdnet as jhn
from hold_tpu.models import nodes as jnodes
from hold_tpu.models.mlp import _apply_linear as j_apply_linear
from hold_tpu.models.mlp import implicit_net_shapes as j_ishapes
from hold_tpu.models.mlp import init_implicit_net as j_iinit
from hold_tpu.models.mlp import init_rendering_net as j_rinit
from hold_tpu.models.mlp import rendering_net_shapes as j_rshapes
from hold_tpu.models.mlp import resolve_weight_norm as j_resolve
from hold_tpu.models.specs import MANO_SPECS, OBJECT_SPECS
from hold_tpu.ops import fused_query as jfq
from hold_tpu.ops import fused_render as jfr
from hold_tpu.ops import knn as jknn
from hold_tpu.render import renderer as jrenderer
from hold_tpu.utils.config import DEFAULT_CONFIG
from hold_tpu.utils.rot import axis_angle_to_matrix
from hold_tpu.utils.transforms import inverse_mat3 as j_inverse_mat3
from hold_tpu_torch.data import dataset as tds
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.models import nodes as tnodes
from hold_tpu_torch.models.mlp import _apply_linear as t_apply_linear
from hold_tpu_torch.ops import fused_query as tfq
from hold_tpu_torch.ops import fused_render as tfr
from hold_tpu_torch.ops import knn as tknn
from hold_tpu_torch.render import renderer as trenderer
from hold_tpu_torch.train import batch_to_device
from hold_tpu_torch.utils.convert import params_from_jax

NODES = {"hand": (MANO_SPECS, 0), "object": (OBJECT_SPECS, 32)}
# the JAX package's bounds between its fused render kernel and its XLA shade
MAX_XC, MAX_SDF, MEAN_SDF, MAX_RGB, P99_NRM = 1e-4, 2e-2, 4e-3, 3e-2, 0.08
# plain version against the Pallas kernel: both multiply the same bf16
# operands with f32 sums and round at the same places, so they differ only
# where a sum's order moves a value across a bf16 rounding step
TIGHT = {"sdf": 2e-3, "sdf_mean": 2e-5, "rgb": 2e-3, "nrm_p99": 1e-3}


def _nets(kind, seed):
    """(implicit plan, rendering plan, JAX resolved nets, port resolved nets)."""
    specs, extra = NODES[kind]
    opt_i = DEFAULT_CONFIG["model"]["implicit_network"]
    opt_r = dict(DEFAULT_CONFIG["model"]["rendering_network"])
    opt_r["d_in"] += extra
    iplan, rplan = j_ishapes(opt_i, specs), j_rshapes(opt_r, specs)
    jimp = j_resolve(j_iinit(jax.random.PRNGKey(seed), opt_i, specs))
    jrend = j_resolve(j_rinit(jax.random.PRNGKey(seed + 7), opt_r, specs))
    timp, trend = (params_from_jax(jax.device_get(p)) for p in (jimp, jrend))
    return iplan, rplan, (jimp, jrend), (timp, trend)


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_supports_fused_render_gates():
    iplan, rplan, _, _ = _nets("hand", 0)
    assert tfr.supports_fused_render(iplan, rplan)
    assert not tfr.supports_fused_render(iplan, dict(rplan, mode="nerf_frame_encoding"))
    assert not tfr.supports_fused_render(iplan, dict(rplan, multires_view=4))
    assert not tfr.supports_fused_render(iplan, dict(rplan, dims=list(rplan["dims"][:-1]) + [4]))
    assert tfr.RENDER_FLOPS_PER_POINT == 2.0 * 1_300_736
    # without the pads: layer 0 and W4e at E = 39 rows, layer 3 and W4h at
    # 217, C0a at 6 columns, C4 at 3 rows
    assert tfq.TRUNK_MACS == 39 * 256 + 2 * 256 * 256 + 217 * 256 + 256 * 217 + 39 * 256 + 3 * 256 * 256 + 256
    assert tfr.RENDER_MACS == 1_247_744


@pytest.mark.parametrize("kind", ["hand", "object"])
def test_packs_match_jax(kind):
    iplan, _, (jimp, jrend), (timp, trend) = _nets(kind, seed=1)
    jt = jax.device_get(jfr.pack_trunk_transposed(jimp, iplan))
    tt = tfr.pack_trunk_transposed(timp, iplan)
    for name in ("W1T", "W2T", "W5T", "W6T", "W7T", "feat_w"):
        np.testing.assert_array_equal(_f32(tt[name]), _f32(jt[name]), err_msg=name)
    # 48-row embedding blocks in both; layer 3's 256 - E = 217 outputs are
    # padded to 224 in the TPU pack and to 256 here, with zeros
    for name in ("W0T", "W4eT"):
        np.testing.assert_array_equal(_f32(tt[name]), _f32(jt[name]), err_msg=name)
    np.testing.assert_array_equal(_f32(tt["W3T"])[:, :224], _f32(jt["W3T"]))
    np.testing.assert_array_equal(_f32(tt["W4hT"])[:224], _f32(jt["W4hT"]))
    assert not _f32(tt["W3T"])[:, 217:].any() and not _f32(tt["W4hT"])[217:].any()
    # the transposed pack is the forward pack's transpose
    fwd = tfq.pack_trunk_weights(timp, iplan)
    for name in ("W0", "W3", "W4h", "W4e", "W7"):
        assert torch.equal(tt[f"{name}T"], fwd[name].t())

    jc = jax.device_get(jfr.pack_color_weights(jrend, jimp))
    tc = tfr.pack_color_weights(trend, timp)
    for name in ("C0a", "C0f", "C1", "C2", "C3", "C4"):
        np.testing.assert_array_equal(_f32(tc[name]), _f32(jc[name]), err_msg=name)
    cb = np.asarray(jc["cbias"])
    np.testing.assert_array_equal(_f32(tc["cbias"])[:4], cb[:, :4].T)
    np.testing.assert_array_equal(_f32(tc["cbias"])[4, :8], cb[:8, 4])

    rng = np.random.RandomState(2)
    pe = rng.randn(2, 8).astype(np.float32)
    tcode = rng.randn(2, 32).astype(np.float32) if kind == "object" else None
    jfb = jfr.frame_bias0(jrend, jnp.asarray(pe), None if tcode is None else jnp.asarray(tcode))
    tfb = tfr.frame_bias0(trend, torch.tensor(pe), None if tcode is None else torch.tensor(tcode))
    np.testing.assert_allclose(tfb.detach().numpy(), np.asarray(jfb), rtol=1e-6, atol=1e-6)


def _rigid_tfs(rng, B, J, rot_scale, t_scale):
    aa = jnp.asarray(rng.randn(B, J, 3) * rot_scale, jnp.float32)
    tfs = np.zeros((B, J, 4, 4), np.float32)
    tfs[..., :3, :3] = np.asarray(axis_angle_to_matrix(aa))
    tfs[..., :3, 3] = rng.randn(B, J, 3) * t_scale
    tfs[..., 3, 3] = 1.0
    return tfs


def _render_case(kind, B=2, N=600):
    """(JAX kernel outputs, port wrapper outputs on CPU tensors) as numpy."""
    iplan, _, (jimp, jrend), (timp, trend) = _nets(kind, seed={"hand": 0, "object": 1}[kind])
    rng = np.random.RandomState({"hand": 3, "object": 5}[kind])
    plan_arr = jfq.embed_plan(iplan["multires"], None)
    jpacks = (jfq.pack_trunk_weights(jimp, iplan), jfr.pack_trunk_transposed(jimp, iplan),
              jfr.pack_color_weights(jrend, jimp))
    tpacks = (tfq.embed_window(iplan, None, (0, 1)), tfq.pack_trunk_weights(timp, iplan),
              tfr.pack_trunk_transposed(timp, iplan), tfr.pack_color_weights(trend, timp))
    T = torch.tensor
    if kind == "hand":
        V, J = 778, 16
        pts = (rng.randn(B, N, 3) * 0.15).astype(np.float32)
        verts_p = (rng.randn(B, V, 3) * 0.12).astype(np.float32)
        verts_c = (rng.randn(B, V, 3) * 0.12).astype(np.float32)
        w = rng.rand(B, V, J).astype(np.float32) ** 4
        w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
        tfs = _rigid_tfs(rng, B, J, 0.3, 0.05)
        pose = (rng.randn(B, 45) * 0.2).astype(np.float32)
        jfb = jfr.frame_bias0(jrend, j_apply_linear(jrend["lin_pose"], jnp.asarray(pose)))
        tfb = tfr.frame_bias0(trend, t_apply_linear(trend["lin_pose"], T(pose)))
        ref = jfr.fused_hand_render(*map(jnp.asarray, (pts, verts_p, verts_c, w, tfs)), plan_arr,
                                    *jpacks, jfb, K=15, interpret=True)
        got = tfr.fused_hand_render(*map(T, (pts, verts_p, verts_c, w, tfs)), *tpacks, tfb, K=15)
    else:
        pts = (rng.randn(B, N, 3) * 0.3).astype(np.float32)
        tfs = _rigid_tfs(rng, B, 1, 0.8, 0.2)[:, 0]
        tf12 = np.asarray(jnp.concatenate([j_inverse_mat3(jnp.asarray(tfs[:, :3, :3])).reshape(
            B, 9), jnp.asarray(tfs[:, :3, 3])], axis=-1))
        tc = (rng.randn(B, 32) * 0.3).astype(np.float32)
        jfb = jfr.frame_bias0(jrend, jnp.zeros((B, 8)), time_code=jnp.asarray(tc))
        tfb = tfr.frame_bias0(trend, torch.zeros(B, 8), T(tc))
        ref = jfr.fused_object_render(jnp.asarray(pts), jnp.asarray(tf12), plan_arr, *jpacks, jfb,
                                      interpret=True)
        got = tfr.fused_object_render(T(pts), T(tf12), *tpacks, tfb)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("kind", ["hand", "object"])
def test_plain_wrapper_matches_pallas_kernel(kind):
    tfr.reset_launch_counts()
    ref, got = _render_case(kind)
    assert not any(tfr.LAUNCHES.values())  # CPU tensors: the plain versions ran
    names = ("sdf", "rgb", "normal", "dist", "x_c")
    for n, r, g in zip(names, ref, got):
        assert g.shape == r.shape and g.dtype == np.float32 and np.isfinite(g).all(), n
    (rs, rr, rn, rd, rx), (gs, gr, gn, gd, gx) = ref, got
    d_sdf, d_rgb, d_nrm = np.abs(gs - rs), np.abs(gr - rr), np.abs(gn - rn)
    print(f"{kind}: x_c {np.abs(gx - rx).max():.2e} dist {np.abs(gd - rd).max():.2e} "
          f"sdf {d_sdf.max():.2e}/{d_sdf.mean():.2e} rgb {d_rgb.max():.2e} "
          f"normal p99 {np.quantile(d_nrm, 0.99):.2e} max {d_nrm.max():.2e}")
    assert np.abs(gx - rx).max() <= MAX_XC and np.abs(gd - rd).max() <= MAX_XC
    assert d_sdf.max() <= MAX_SDF and d_sdf.mean() <= MEAN_SDF
    assert d_rgb.max() <= MAX_RGB and np.quantile(d_nrm, 0.99) <= P99_NRM
    assert d_sdf.max() <= TIGHT["sdf"] and d_sdf.mean() <= TIGHT["sdf_mean"]
    assert d_rgb.max() <= TIGHT["rgb"] and np.quantile(d_nrm, 0.99) <= TIGHT["nrm_p99"]
    assert np.abs(rs).max() > 0.05 and rr.std() > 1e-3  # not a degenerate field


def _blend_inputs(seed=7, B=2, P=700, V=778, J=16):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(B, P, 3) * 0.15).astype(np.float32)
    verts = (rng.randn(B, V, 3) * 0.12).astype(np.float32)
    w = rng.rand(B, V, J).astype(np.float32) ** 4
    return pts, verts, (w / w.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("form", ["bpj", "bjp"])
def test_knn_blend_weights_match_pallas(form):
    pts, verts, w = _blend_inputs()
    jfn, tfn = ((jknn.knn_blend_weights_pallas, tknn.knn_blend_weights) if form == "bpj" else
                (jknn.knn_blend_weights_t, tknn.knn_blend_weights_t))
    wj, oj = jfn(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(w), K=15, max_dist=0.05,
                 interpret=True)
    wt, ot = tfn(*map(torch.tensor, (pts, verts, w)), K=15, max_dist=0.05)
    assert wt.shape == wj.shape
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=2e-6)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert 0 < ot.float().mean() < 1


def _render_model():
    """Full-width implicit and rendering nets (what the fused render takes),
    a short sampler and narrow background nets."""
    m = copy.deepcopy(DEFAULT_CONFIG["model"])
    m["proposal"]["enabled"] = False
    m["bg_implicit_network"]["dims"] = [96] * 8
    m["bg_rendering_network"]["dims"] = [32]
    m["ray_sampler"].update(N_samples=8, N_samples_eval=64, N_samples_extra=4,
                            max_total_iters=2, beta_iters=3)
    return m


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("render"))
    generate_sequence(os.path.join(root, "toy"), n_frames=3, img_hw=(48, 64))
    seq = tds.SequenceData.from_build_dir("toy", root, num_sample=8)
    sd = seq.scene_data()
    model, args = _render_model(), {"barf_s": 5, "barf_e": 50}
    opt = dict(model, scene_bounding_sphere=seq.scene_bounding_sphere)
    jscene = jhn.build_scene(opt, args, sd)
    jparams = jhn.init_scene_params(jax.random.PRNGKey(0), jscene, sd)
    return {"root": root, "seq": seq, "model": opt, "args": args, "jscene": jscene,
            "jparams": jparams, "tparams": params_from_jax(jax.device_get(jparams)),
            "jseq": JSequenceData("toy", root, num_sample=8)}


def test_node_render_matches_jax_nodes(toy, monkeypatch):
    monkeypatch.setenv("HOLD_FUSED_RENDER", "interpret")
    monkeypatch.delenv("HOLD_NO_FUSED_RENDER", raising=False)
    seq, jscene, jparams, tparams = toy["seq"], toy["jscene"], toy["jparams"], toy["tparams"]
    batch_np = seq.sample_tempo_batch(np.random.RandomState(0), 1, num_sample=8)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    B, P = batch_np["uv"].shape[:2]
    z = np.broadcast_to(np.linspace(0.2, 2.2, 16, dtype=np.float32)[None], (B * P, 16)).copy()
    rd, cl = jhn.get_camera_rays(jbatch["uv"], jbatch["extrinsics"], jbatch["intrinsics"])
    rd = rd.reshape(-1, 3)
    cl = jnp.broadcast_to(cl[:, None, :], (B, P, 3)).reshape(-1, 3)
    tbatch = batch_to_device(batch_np, "cpu")
    trd, tcl = thn._rays(tbatch)
    fused = thn.build_scene(toy["model"], toy["args"], seq.scene_data(), "cpu")
    layer = thn.build_scene(toy["model"], toy["args"], seq.scene_data(), "cpu", fused_render=False)
    assert all(p.fused_render for p in fused.plans.values())
    assert not any(p.fused_render for p in layer.plans.values())
    for nid, jfn, tfn in (("right", jnodes.mano_node_forward, tnodes.mano_node_render),
                          ("object", jnodes.object_node_forward, tnodes.object_node_render)):
        jf, jsd = jax.device_get(jfn(jparams[nid], jscene.servers[nid], jscene.plans[nid], jbatch,
                                     rd, cl, None, None, None, training=False,
                                     z_vals=jnp.asarray(z)))
        outs = {}
        for tag, scene in (("fused", fused), ("layer", layer)):
            outs[tag] = tfn(tparams[nid], scene.servers[nid], scene.plans[nid], tbatch, trd, tcl,
                            torch.tensor(z))
        tf, tsd = outs["fused"]
        assert set(tf) == set(jf) and set(tsd) == set(jsd), nid
        for k in ("color", "normal", "density", "z_vals"):
            d = np.abs(tf[k].numpy() - np.asarray(jf[k]))
            assert d.max() <= {"normal": 0.08}.get(k, 2e-2) * max(np.abs(jf[k]).max(), 1.0), (nid, k)
        # the K-th distinct neighbour distance can fall inside a cluster of
        # distances equal up to rounding, which the two packages round
        # differently (an MXU product there, op by op here): a few points
        # blend one vertex more or less
        d = np.abs(tsd["canonical_pts"].numpy() - jsd["canonical_pts"])
        assert np.quantile(d, 0.99) <= 1e-5 and d.max() <= 1e-3, (nid, d.max())
        if nid == "right":
            np.testing.assert_array_equal(tsd["outlier"].numpy(), jsd["outlier"])
        # the chunked f32 shade against the fused bf16 one: bf16 tolerance
        lf, _ = outs["layer"]
        for k in ("color", "density"):
            d = np.abs(lf[k].numpy() - tf[k].numpy())
            assert d.mean() <= 2e-2 * max(np.abs(tf[k].numpy()).mean(), 1.0), (nid, k)


def test_render_frame_matches_jax(toy, monkeypatch):
    """The slice: one full frame through each package's render_frame."""
    monkeypatch.setenv("HOLD_FUSED_RENDER", "interpret")
    monkeypatch.delenv("HOLD_NO_FUSED_RENDER", raising=False)
    monkeypatch.setattr(jnodes, "_use_fused_query", lambda plans: (
        jfq.supports_fused_query(plans.implicit)
        and (8 * plans.sampler.N_samples_eval) % 512 == 0))
    for name in ("fused_hand_sampler_sdf_z", "fused_object_sampler_sdf_z"):
        monkeypatch.setattr(jfq, name, functools.partial(getattr(jfq, name), interpret=True))
    seq, jseq = toy["seq"], toy["jseq"]
    fb = seq.full_frame_batch(1, downsample=8)
    jfb = jseq.full_frame_batch(1, downsample=8)
    for k in ("uv", "gt_rgb", "intrinsics", "extrinsics"):
        np.testing.assert_array_equal(fb[k], jfb[k])
    assert fb["img_hw"] == jfb["img_hw"] == (6, 8)
    # the JAX chunk renderer's two stages run eagerly: jitted whole, XLA:CPU
    # refuses the interpret-mode kernels' bf16 x bf16 -> f32 products
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda f, **kw: f)
        ref = jrenderer.render_frame(toy["jparams"], toy["jscene"],
                                     jhn.empty_object_mesh_state(), jfb, pixel_per_batch=24)

    tscene = thn.build_scene(toy["model"], toy["args"], seq.scene_data(), "cpu")
    got = trenderer.render_frame(toy["tparams"], tscene, fb, pixel_per_batch=24)
    assert set(got) == set(ref)
    # the two samplers' z tables agree to a tenth of the sample spacing
    # (test_torch_fused_query.py), and the foreground weights of the 14 final
    # samples a ray move with them: mask, depth and normal maps differ by a
    # few 1e-2 where a ray grazes the surface (measured 2.0e-2, 2.0e-2 and
    # 1.8e-2); the background net sees the same inputs
    tol = {"rgb": 2e-3, "fg_rgb_vis": 3e-2, "bg_rgb_only": 1e-5, "normal": 5e-2,
           "depth": 5e-2, "mask_prob": 5e-2}
    diffs = {}
    for k, r in ref.items():
        assert got[k].shape == np.asarray(r).shape, k
        if k in tol:
            diffs[k] = float(np.abs(got[k] - np.asarray(r)).max())
    print({k: f"{v:.2e} (range {np.abs(np.asarray(ref[k])).max():.2f})" for k, v in diffs.items()})
    assert all(diffs[k] <= tol[k] for k in tol), diffs
    assert (got["instance_map"] == np.asarray(ref["instance_map"])).mean() >= 0.95
    panel = trenderer.outputs_to_panel(got, fb["gt_rgb"])
    assert panel.shape == (6, 40, 3) and np.isfinite(panel).all()


def test_render_cli_from_a_training_run(toy, tmp_path, monkeypatch):
    """run_training on the CPU writes a checkpoint; render_cli reads it back
    and writes the panel and the fp16 normals."""
    from hold_tpu_torch import render_cli
    from hold_tpu_torch.train import run_training
    from hold_tpu_torch.utils.checkpoint import load_experiment
    from hold_tpu_torch.utils.config import Cfg

    model = copy.deepcopy(DEFAULT_CONFIG["model"])
    model["proposal"]["enabled"] = False
    for k in ("implicit_network", "rendering_network"):
        model[k]["dims"] = [64] * len(model[k]["dims"])
    model["bg_implicit_network"]["dims"] = [96] * 8
    model["bg_rendering_network"]["dims"] = [16]
    model["ray_sampler"].update(N_samples=8, N_samples_eval=16, N_samples_extra=4,
                                max_total_iters=2, beta_iters=3)
    cfg = {"model": model, "dataset": copy.deepcopy(DEFAULT_CONFIG["dataset"])}
    cfg["dataset"]["train"]["batch_size"] = 1
    args = Cfg({**toy["args"], "case": "toy", "num_sample": 8, "tempo_len": 2, "offset": 1,
                "log_every": 1, "no_meshing": True, "no_vis": True, "mute": True,
                "exp_key": "run", "log_root": str(tmp_path), "seed": 0, "total_step": 1,
                "lr": 1e-3, "data_root": toy["root"]})
    params, _, _, _, _ = run_training(args, cfg, seq=toy["seq"], device="cpu")
    exp = str(tmp_path / "run")
    loaded, scene = load_experiment(exp, toy["seq"], "cpu")
    assert torch.equal(loaded["right"]["tables"]["pose"], params["right"]["tables"]["pose"])
    assert not any(p.fused_render for p in scene.plans.values())  # 64-wide nets

    monkeypatch.chdir(tmp_path)
    recs = render_cli.main(["--exp", exp, "--case", "toy", "--data_root", toy["root"],
                            "--render_downsample", "16", "--pixel_per_batch", "8",
                            "--num_agents", "3", "--agent_id", "2", "--device", "cpu"])
    assert [r["idx"] for r in recs] == [2]
    import cv2

    png = cv2.imread(os.path.join(exp, "renders", "0002.png"))
    assert png.shape == (3, 4 * 5, 3)
    nrm = np.load(tmp_path / "exports" / "run" / "normal" / "0002.npy")
    assert nrm.dtype == np.float16 and nrm.shape == (3, 4, 3)
    assert np.isfinite(recs[0]["res"]["rgb"]).all()


def test_entry_points_need_a_card_unless_asked_for_the_cpu(toy):
    from hold_tpu_torch import render_cli
    from hold_tpu_torch.train import run_training
    from hold_tpu_torch.utils.config import Cfg, parse_args, resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert parse_args(["--case", "toy"])[0].device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_training(Cfg({"no_meshing": True, "no_vis": True}), {}, seq=toy["seq"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        render_cli.main(["--exp", "none", "--case", "toy"])
    with pytest.raises(ValueError):
        thn.build_scene(toy["model"], toy["args"], toy["seq"].scene_data(), None)
    assert tds.test_frame_split(7, 3, 1) == [3, 4]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused render and KNN blend kernels are CUDA only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hand", "object"])
def test_cuda_render_kernels_match_plain(cuda, kind):
    iplan, _, _, (timp, trend) = _nets(kind, seed=4)
    rng = np.random.RandomState(9)
    B, N = 2, 3000
    packs = (tfq.embed_window(iplan, None, (0, 1)), tfq.pack_trunk_weights(timp, iplan),
             tfr.pack_trunk_transposed(timp, iplan), tfr.pack_color_weights(trend, timp))
    fb0 = torch.tensor(rng.randn(B, 256).astype(np.float32) * 0.1)
    pts = torch.tensor((rng.randn(B, N, 3) * 0.15).astype(np.float32))
    if kind == "hand":
        V, J = 778, 16
        w = rng.rand(B, V, J).astype(np.float32) ** 4
        frame = [torch.tensor(a) for a in (
            (rng.randn(B, V, 3) * 0.12).astype(np.float32),
            (rng.randn(B, V, 3) * 0.12).astype(np.float32),
            (w / w.sum(-1, keepdims=True)).astype(np.float32), _rigid_tfs(rng, B, J, 0.3, 0.05))]
        fn = tfr.fused_hand_render
    else:
        tfs = _rigid_tfs(rng, B, 1, 0.8, 0.2)[:, 0]
        frame = [torch.tensor(np.concatenate([np.linalg.inv(tfs[:, :3, :3]).reshape(B, 9),
                                              tfs[:, :3, 3]], -1).astype(np.float32))]
        fn = tfr.fused_object_render

    def on(dev, x):
        return {k: v.to(dev) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)

    got = fn(pts.to(cuda), *[on(cuda, f) for f in frame], *[on(cuda, p) for p in packs],
             fb0.to(cuda))
    torch.cuda.synchronize()
    ref = fn(pts, *frame, *packs, fb0)
    g = [t.cpu().numpy() for t in got]
    r = [t.numpy() for t in ref]
    assert np.abs(g[4] - r[4]).max() <= MAX_XC and np.abs(g[3] - r[3]).max() <= MAX_XC
    assert np.abs(g[0] - r[0]).max() <= MAX_SDF and np.abs(g[0] - r[0]).mean() <= MEAN_SDF
    assert np.abs(g[1] - r[1]).max() <= MAX_RGB
    assert np.quantile(np.abs(g[2] - r[2]), 0.99) <= P99_NRM


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["bpj", "bjp"])
def test_cuda_knn_blend_matches_plain(cuda, form):
    pts, verts, w = (torch.tensor(a) for a in _blend_inputs(seed=11, P=5000))
    fn = tknn.knn_blend_weights if form == "bpj" else tknn.knn_blend_weights_t
    wg, og = fn(pts.to(cuda), verts.to(cuda), w.to(cuda), K=15, max_dist=0.05)
    torch.cuda.synchronize()
    wr, orf = fn(pts, verts, w, K=15, max_dist=0.05)
    np.testing.assert_allclose(wg.cpu().numpy(), wr.numpy(), atol=1e-5)
    assert torch.equal(og.cpu(), orf)
