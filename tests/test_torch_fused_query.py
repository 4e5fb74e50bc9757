"""hold_tpu_torch.ops.fused_query against the JAX package's fused sampler.

At the kernel's full width (implicit net 8x256, multires 6), everything else
small; inputs are made with numpy from a seed and the JAX Pallas kernels run
in interpret mode.  Checked:

- the port's trunk pack equals ``pack_trunk_weights`` exactly after the bf16
  round, and its embedding window equals ``embed_plan(...)[:39, 3]``;
- each of the four plain wrappers (what a wrapper runs on CPU tensors)
  against its Pallas kernel, hand and object, at P=6 rays (not a multiple of
  8: JAX pads) x S=64, within the JAX package's own bound between its fused
  and layer paths (tests/test_fused_query.py): max|d| <= 2e-2 and mean|d| <=
  4e-3.  Measured on the CPU (max / mean): hand 2.1e-4 / 1.1e-6 and object
  1.6e-3 / 2.4e-5, in both the z and the buffer form;
- the z tables of the sampler stage, fused in both packages, at a tenth of
  the median sample spacing;
- which configurations take the fused path;
- the kernel-layout step (``tile_for_kernel``): a permutation of the pack with
  zero pads, inverted bit for bit by ``untile_from_kernel``, one element of
  each matrix at the place the layout documented in ``csrc/cta_gemm.cuh``
  gives it, the graph kept under grad mode, and no trace of it in a pack that
  went through a wrapper on the CPU.

The CUDA kernels are held against the plain versions on the card (marked
``gpu``; skipped without one).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hold_tpu.mano.model_data import build_synthetic_mano
from hold_tpu.models import holdnet as jhn
from hold_tpu.models import nodes as jnodes
from hold_tpu.models.embedders import barf_alpha as jbarf_alpha
from hold_tpu.models.embedders import barf_weights as jbarf_weights
from hold_tpu.models.mlp import implicit_net_shapes as j_shapes
from hold_tpu.models.mlp import init_implicit_net as j_init
from hold_tpu.models.mlp import resolve_weight_norm as j_resolve
from hold_tpu.models.specs import MANO_SPECS, OBJECT_SPECS
from hold_tpu.ops import fused_query as jfq
from hold_tpu.utils.config import DEFAULT_CONFIG
from hold_tpu.utils.transforms import inverse_mat3 as j_inverse_mat3
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.models.mlp import resolve_weight_norm
from hold_tpu_torch.ops import fused_query as tfq
from hold_tpu_torch.train import batch_to_device
from hold_tpu_torch.utils.convert import params_from_jax

STEP, BARF = 900, (100, 2000)
MAX_TOL, MEAN_TOL = 2e-2, 4e-3
NODES = {"hand": MANO_SPECS, "object": OBJECT_SPECS}


def _net(kind, seed):
    """(plan, JAX resolved layers, port resolved layers) of one implicit net."""
    opt = DEFAULT_CONFIG["model"]["implicit_network"]
    plan = j_shapes(opt, NODES[kind])
    jparams = j_init(jax.random.PRNGKey(seed), opt, NODES[kind])
    return plan, j_resolve(jparams), resolve_weight_norm(params_from_jax(jax.device_get(jparams)))


def _jax_window(kind):
    if kind == "hand":
        return None
    wf = jbarf_weights(jbarf_alpha(jnp.asarray(STEP), 6, *BARF), 6)
    return jnp.concatenate([jnp.ones((3,)), jnp.repeat(wf, 6)])


@pytest.mark.parametrize("kind", ["hand", "object"])
def test_pack_and_window_match_jax(kind):
    plan, jres, tres = _net(kind, seed=0)
    jpack = jax.device_get(jfq.pack_trunk_weights(jres, plan))
    # the same resolved f32 weights on both sides: the pack must be exact
    with torch.no_grad():
        tpack = tfq.pack_trunk_weights(params_from_jax(jax.device_get(jres)), plan)

    def f32(t):
        return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor) else
                          np.asarray(t, np.float32))

    # the port's own weight-norm resolve rounds a few weights differently
    # (its row norms sum in another order): at most one bf16 step apart
    np.testing.assert_allclose(f32(tfq.pack_trunk_weights(tres, plan)["bf16"]),
                               f32(tpack["bf16"]), rtol=2**-7, atol=0)

    for name in ("W0", "W1", "W2", "W4e", "W5", "W6", "W7"):
        np.testing.assert_array_equal(f32(tpack[name]), f32(jpack[name]), err_msg=name)
    # layer 3 padded to 256 rows here, 224 in the TPU pack: zeros past 217
    np.testing.assert_array_equal(f32(tpack["W3"])[:224], f32(jpack["W3"]))
    np.testing.assert_array_equal(f32(tpack["W4h"])[:, :224], f32(jpack["W4h"]))
    assert not f32(tpack["W3"])[217:].any() and not f32(tpack["W4h"])[:, 217:].any()
    np.testing.assert_array_equal(f32(tpack["bias"]).T[:, :8], np.asarray(jpack["bias"]))
    np.testing.assert_array_equal(f32(tpack["head_w"]), np.asarray(jpack["head_w"])[0])
    assert float(tpack["head_b"]) == float(np.asarray(jpack["head_b"])[0, 0])

    window = tfq.embed_window(plan, STEP, BARF)
    ref = np.asarray(jfq.embed_plan(6, _jax_window(kind)))[:39, 3]
    np.testing.assert_allclose(window.numpy(), ref, rtol=1e-6, atol=1e-7)
    assert (kind == "hand") == bool((window.numpy() == 1.0).all())


def _rigid_tfs(rng, B, J, rot_scale, t_scale):
    from scipy.spatial.transform import Rotation

    tfs = np.zeros((B, J, 4, 4), np.float32)
    tfs[..., :3, :3] = Rotation.from_rotvec(rng.randn(B * J, 3) * rot_scale).as_matrix().reshape(
        B, J, 3, 3)
    tfs[..., :3, 3] = rng.randn(B, J, 3) * t_scale
    tfs[..., 3, 3] = 1.0
    return tfs


def _rays(rng, B, P, S, center, radius):
    """Rays from a camera 0.6 in front of ``center`` through points around
    it, with sorted depths that cross it."""
    cam = (center + np.array([0.0, 0.0, -0.6]) + rng.randn(B * P, 3) * 0.02).astype(np.float32)
    tgt = center + rng.randn(B * P, 3) * radius
    dirs = (tgt - cam).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.3, 0.9, (B, P, S)), axis=-1).astype(np.float32)
    pts = (cam.reshape(B, P, 1, 3) + z[..., None] * dirs.reshape(B, P, 1, 3)).reshape(B, P * S, 3)
    return dirs, cam, z, pts.astype(np.float32)


def _query_case(kind, form, B=2, P=6, S=64):
    """(JAX result, port plain result) for one of the four entry points."""
    rng = np.random.RandomState({"hand": 1, "object": 2}[kind])
    plan, jres, tres = _net(kind, seed={"hand": 3, "object": 4}[kind])
    jpack, tpack = jfq.pack_trunk_weights(jres, plan), tfq.pack_trunk_weights(tres, plan)
    plan_arr = jfq.embed_plan(6, _jax_window(kind))
    window = tfq.embed_window(plan, STEP, BARF)
    T = torch.tensor
    if kind == "hand":
        md = build_synthetic_mano(True)
        verts = (md.v_template[None] + rng.randn(B, 778, 3) * 0.003).astype(np.float32)
        skin = np.repeat(md.lbs_weights[None], B, axis=0).astype(np.float32)
        tfs = _rigid_tfs(rng, B, 16, 0.2, 0.02)
        dirs, cam, z, pts = _rays(rng, B, P, S, md.v_template.mean(0), 0.06)
        frame = (verts, skin, tfs)
    else:
        tfs = _rigid_tfs(rng, B, 1, 0.8, 0.1)[:, 0]
        tf12 = np.asarray(jnp.concatenate([j_inverse_mat3(jnp.asarray(tfs[:, :3, :3])).reshape(
            B, 9), jnp.asarray(tfs[:, :3, 3])], axis=-1))
        dirs, cam, z, pts = _rays(rng, B, P, S, np.zeros(3), 0.3)
        frame = (tf12,)
    jframe = tuple(map(jnp.asarray, frame))
    tframe = tuple(map(T, frame))
    if form == "z":
        rays8 = jfq.pack_rays8(jnp.asarray(dirs), jnp.asarray(cam), B, P, S)
        jfn = jfq.fused_hand_sampler_sdf_z if kind == "hand" else jfq.fused_object_sampler_sdf_z
        tfn = tfq.fused_hand_sampler_sdf_z if kind == "hand" else tfq.fused_object_sampler_sdf_z
        ref = jfn(rays8, jnp.asarray(z), *jframe, plan_arr, jpack, interpret=True)
        got = tfn(T(dirs), T(cam), T(z), *tframe, window, tpack)
    else:
        jfn = jfq.fused_hand_sampler_sdf if kind == "hand" else jfq.fused_object_sampler_sdf
        tfn = tfq.fused_hand_sampler_sdf if kind == "hand" else tfq.fused_object_sampler_sdf
        ref = jfn(jnp.asarray(pts), *jframe, plan_arr, jpack, interpret=True)
        got = tfn(T(pts), *tframe, window, tpack)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("kind", ["hand", "object"])
@pytest.mark.parametrize("form", ["z", "buffer"])
def test_plain_wrapper_matches_pallas_kernel(kind, form):
    ref, got = _query_case(kind, form)
    assert got.shape == ref.shape and got.dtype == np.float32
    d = np.abs(got - ref)
    print(f"{kind} {form}: max {d.max():.3e} mean {d.mean():.3e}")
    assert d.max() <= MAX_TOL and d.mean() <= MEAN_TOL, (d.max(), d.mean())
    assert np.abs(ref).max() > 0.05  # not a degenerate field


def _toy_model():
    m = copy.deepcopy(DEFAULT_CONFIG["model"])
    m["proposal"]["enabled"] = False
    m["rendering_network"]["dims"] = [64] * 4
    m["bg_implicit_network"]["dims"] = [96] * 8
    m["bg_rendering_network"]["dims"] = [32]
    m["ray_sampler"].update(N_samples=8, N_samples_eval=64, N_samples_extra=4,
                            max_total_iters=2, beta_iters=3)
    return m


@pytest.fixture(scope="module")
def toy():
    built = generate_sequence(None, n_frames=4, img_hw=(72, 96))
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    return seq, seq.scene_data()


def test_sampler_z_tables_match_jax_fused_path(toy, monkeypatch):
    seq, sd = toy
    model, args = _toy_model(), {"barf_s": 100, "barf_e": 2000}
    monkeypatch.setattr(jnodes, "_use_fused_query", lambda plans: (
        jfq.supports_fused_query(plans.implicit)
        and (8 * plans.sampler.N_samples_eval) % 512 == 0))
    for name in ("fused_hand_sampler_sdf_z", "fused_object_sampler_sdf_z"):
        monkeypatch.setattr(jfq, name, functools.partial(getattr(jfq, name), interpret=True))
    jscene = jhn.build_scene(model, args, sd)
    jparams = jhn.init_scene_params(jax.random.PRNGKey(0), jscene, sd)
    batch_np = seq.sample_tempo_batch(np.random.RandomState(0), 1, num_sample=8)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jz = jax.device_get(jhn.sample_all_z(jparams, jscene, jbatch, None, jnp.asarray(STEP),
                                         jnp.asarray(0)))

    tscene = thn.build_scene(model, args, sd, "cpu")
    assert all(tscene.plans[nid].fused_query for nid in tscene.node_ids)
    tfq.reset_launch_counts()
    tz = thn.sample_all_z(params_from_jax(jax.device_get(jparams)), tscene,
                          batch_to_device(batch_np, "cpu"), None, STEP, 0)
    for nid, ref in jz.items():
        ref = np.asarray(ref)
        got = tz[nid].numpy()
        assert got.shape == ref.shape
        assert np.all(np.diff(got, axis=1) >= 0)
        err = np.abs(got - ref).max()
        spacing = float(np.median(np.diff(ref, axis=1)))
        assert err <= 0.1 * spacing, (nid, err, spacing)
    assert not any(tfq.LAUNCHES.values())  # CPU tensors: the plain versions ran


def test_fused_sampler_configurations(toy):
    _, sd = toy
    model = _toy_model()
    args = {"barf_s": 100, "barf_e": 2000}
    fused = thn.build_scene(model, args, sd, "cpu")
    assert all(p.fused_query for p in fused.plans.values())
    off = thn.build_scene(model, args, sd, "cpu", fused_sampler=False)
    assert not any(p.fused_query for p in off.plans.values())
    narrow = copy.deepcopy(model)
    narrow["implicit_network"]["dims"] = [64] * 8
    assert not any(p.fused_query for p in thn.build_scene(narrow, args, sd, "cpu").plans.values())
    short = copy.deepcopy(model)
    short["ray_sampler"]["N_samples_eval"] = 16  # 8 x 16 points: not whole 512-point slices
    assert not any(p.fused_query for p in thn.build_scene(short, args, sd, "cpu").plans.values())
    # the trunk products of the packed layout, the head, plus the warps
    flops = tfq.sampler_query_flops_per_step(fused, 1280)
    trunk = 2.0 * 483_584 * (64 * 2) * 1280  # MACs a point x points per step, one node
    assert 2 * trunk < flops < 2.1 * trunk
    assert tfq.sampler_query_flops_per_step(off, 1280) == 0.0


@pytest.mark.parametrize("kind", ["hand", "object"])
def test_kernel_layout_is_a_permutation_of_the_pack(kind):
    plan, _, tres = _net(kind, seed=3)
    with torch.no_grad():
        pack = tfq.pack_trunk_weights(tres, plan)
    tiled = tfq.tile_for_kernel(pack)
    assert tiled.dtype == torch.bfloat16 and tiled.shape == (30 * 256 * 64,)
    assert tfq.N_SLABS == 30 and tfq.SLAB == 16384
    # the inverse gives the pack back, bit for bit
    assert torch.equal(tfq.untile_from_kernel(tiled).view(torch.int16),
                       pack["bf16"].view(torch.int16))
    # a permutation plus zeros: the same multiset of bit patterns
    bits = torch.sort(tiled.view(torch.int16)[tiled.view(torch.int16) != 0]).values
    ref = pack["bf16"].view(torch.int16)
    assert torch.equal(bits, torch.sort(ref[ref != 0]).values)
    # one element of each matrix, by the header's formula written out: slab-major,
    # rows of 128 bytes, the row's 16-byte groups XOR-ed with the row number mod 8
    first = {"W0": 0, "W1": 1, "W2": 5, "W3": 9, "W4h": 13, "W4e": 17, "W5": 18, "W6": 22,
             "W7": 26}
    rng = np.random.RandomState(0)
    raw = tiled.view(torch.int16)
    for name, rows, cols in tfq._LAYOUT:
        n, k = int(rng.randint(rows)), int(rng.randint(cols))
        byte = (first[name] + k // 64) * 32768 + n * 128 + ((((k % 64) // 8) ^ (n % 8)) * 16) \
            + (k % 8) * 2
        assert raw[byte // 2] == pack[name].view(torch.int16)[n, k], name
        assert tfq.slab_offset(first[name] + k // 64, n, k % 64) == byte // 2
    # the 48-column matrices' slabs hold zeros in columns 48..63
    for name in ("W0", "W4e"):
        slab = tiled[first[name] * tfq.SLAB:(first[name] + 1) * tfq.SLAB].view(256, 64)
        groups = torch.arange(8)[None, :] ^ (torch.arange(256)[:, None] % 8)  # logical k / 8
        assert not slab.view(256, 8, 8)[groups >= 6].any()


def test_kernel_layout_keeps_the_graph_and_stays_off_the_cpu_path():
    plan, _, tres = _net("object", seed=4)
    leaves = [l["w"].detach().clone().requires_grad_(True) for l in tres["layers"]]
    res = {"layers": [{"w": w, "b": l["b"]} for w, l in zip(leaves, tres["layers"])]}
    pack = tfq.pack_trunk_weights(res, plan)
    tiled = tfq.tile_for_kernel(pack)
    assert tiled.requires_grad
    cot = torch.tensor(np.random.RandomState(1).randn(tiled.shape[0]), dtype=torch.float32)
    (tiled.float() * cot).sum().backward()
    # the cotangent of a tiled element (rounded to bf16 by the pack's cast)
    # lands on the weight it came from
    n, k = 5, 70
    at = tfq.slab_offset(1 + k // 64, n, k % 64)
    assert leaves[1].grad[n, k] == cot[at].bfloat16().float()
    assert all(w.grad is not None and w.grad.abs().max() > 0 for w in leaves[:8])
    # a wrapper given CPU tensors runs the plain version and never tiles
    with torch.no_grad():
        cpu_pack = tfq.pack_trunk_weights(tres, plan)
    pts = torch.tensor(np.random.RandomState(2).randn(1, 5, 3) * 0.1, dtype=torch.float32)
    tf12 = torch.tensor([[1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0]])
    tfq.fused_object_sampler_sdf(pts, tf12, tfq.embed_window(plan, None, BARF), cpu_pack)
    assert "tiled" not in cpu_pack


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused query kernel is CUDA only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hand", "object"])
def test_cuda_kernels_match_plain(cuda, kind):
    rng = np.random.RandomState(5)
    plan, _, tres = _net(kind, seed=6)
    pack = tfq.pack_trunk_weights({"layers": [{k: v.to(cuda) for k, v in l.items()}
                                              for l in tres["layers"]]}, plan)
    window = tfq.embed_window(plan, STEP, BARF, cuda)
    B, P, S = 3, 37, 128
    if kind == "hand":
        md = build_synthetic_mano(True)
        frame = (np.repeat(md.v_template[None], B, axis=0).astype(np.float32),
                 np.repeat(md.lbs_weights[None], B, axis=0).astype(np.float32),
                 _rigid_tfs(rng, B, 16, 0.2, 0.02))
        dirs, cam, z, pts = _rays(rng, B, P, S, md.v_template.mean(0), 0.06)
        fz, fb = tfq.fused_hand_sampler_sdf_z, tfq.fused_hand_sampler_sdf
    else:
        tfs = _rigid_tfs(rng, B, 1, 0.8, 0.1)[:, 0]
        frame = (np.concatenate([np.linalg.inv(tfs[:, :3, :3]).reshape(B, 9), tfs[:, :3, 3]],
                                axis=-1).astype(np.float32),)
        dirs, cam, z, pts = _rays(rng, B, P, S, np.zeros(3), 0.3)
        fz, fb = tfq.fused_object_sampler_sdf_z, tfq.fused_object_sampler_sdf
    frame = [torch.tensor(a, device=cuda) for a in frame]
    dirs, cam, z, pts = (torch.tensor(a, device=cuda) for a in (dirs, cam, z, pts))
    cpu = [t.cpu() for t in frame]
    cpack = {k: v.cpu() for k, v in pack.items()}
    for got, ref in (
        (fz(dirs, cam, z, *frame, window, pack),
         fz(dirs.cpu(), cam.cpu(), z.cpu(), *cpu, window.cpu(), cpack)),
        (fb(pts, *frame, window, pack), fb(pts.cpu(), *cpu, window.cpu(), cpack)),
    ):
        torch.cuda.synchronize()
        d = (got.cpu() - ref).abs()
        assert d.max() <= MAX_TOL and d.mean() <= MEAN_TOL, (d.max(), d.mean())
