"""Host-built constants on the device without a stream sync
(``hold_tpu_torch/utils/device_constants.py``).

On the CPU at toy widths: the embedding windows, the MANO tip gather, the
object's transform, the hand's uniform-sample box and the targets' flag
hold the values of their plain construction bit for bit; the cache hands
back one tensor per window and counts what it makes and reuses.  On the card
(``gpu``): the same values there, and a warmed training step and render
chunk at the port's full widths make no stream sync
(``torch.cuda.set_sync_debug_mode("error")``)."""

import contextlib
import copy

import numpy as np
import pytest
import torch

from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.mano.lbs import lbs_forward, mano_full_pose
from hold_tpu_torch.mano.model_data import TIP_VERTEX_IDS
from hold_tpu_torch.mano.server import build_mano_server
from hold_tpu_torch.models.embedders import (barf_alpha, barf_embed, barf_window, embed_window,
                                             fourier_embed, window_on)
from hold_tpu_torch.models.holdnet import (build_scene, empty_object_mesh_state,
                                           holdnet_forward, init_scene_params,
                                           object_mesh_state_from_mesh, render_packs,
                                           sample_all_z, sample_step_draws)
from hold_tpu_torch.models.object_model import build_object_server, object_server_forward
from hold_tpu_torch.ops.sampling import HAND_GLOBAL_SIGMA_XYZ, point_in_space_sample
from hold_tpu_torch.render.renderer import make_chunk_renderer
from hold_tpu_torch.train import batch_to_device, make_train_step, optimizer_for
from hold_tpu_torch.utils import device_constants, tracing
from hold_tpu_torch.utils.config import DEFAULT_CONFIG, Cfg
from hold_tpu_torch.utils.rot import axis_angle_to_matrix
from holdbench.synthetic import geodesic_sphere

BARF = (1000, 10000)
STEPS = [None, 999, 1000, 1001, 5500, 9999, 10000, 20000]
ARGS = {"barf_s": 100, "barf_e": 10000, "lr": 1e-4, "freeze_pose": False}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these toy tensors (as test_torch_train_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain_window(embedding: str, L: int, step) -> torch.Tensor:
    """``embed_window``'s construction before its windows were kept on the
    device."""
    if embedding == "barf" and step is not None:
        return barf_window(barf_alpha(step, L, *BARF), L).to(dtype=torch.float32)
    return torch.ones(3 * (2 * L + 1)).to(dtype=torch.float32)


@pytest.mark.parametrize("step", STEPS, ids=str)
@pytest.mark.parametrize("embedding", ["fourier", "barf"])
def test_embed_window_is_the_plain_construction(embedding, step):
    for L in (6, 10):
        got = embed_window({"multires": L, "embedding": embedding}, step, BARF)
        want = _plain_window(embedding, L, step)
        assert got.dtype == want.dtype and got.device.type == "cpu"
        assert torch.equal(got, want), (L, step)


@pytest.mark.parametrize("include_input", [True, False], ids=["with_input", "no_input"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_barf_embed_is_the_plain_construction(dtype, include_input):
    x = torch.randn((33, 3), generator=torch.Generator().manual_seed(3)).to(dtype)
    for step in STEPS[1:]:
        alpha = barf_alpha(step, 6, *BARF)
        w = barf_window(alpha, 6, 3)
        if not include_input:
            w = w[3:]
        want = fourier_embed(x, 6, include_input=include_input) * w.to(dtype=dtype)
        got = barf_embed(x, 6, alpha, include_input=include_input)
        assert got.dtype == dtype and torch.equal(got, want), step
    assert torch.equal(barf_embed(x, 6, None), fourier_embed(x, 6))


def test_window_cache_gives_one_tensor_per_window_and_counts():
    cfg = (123, 4567)  # windows no other test makes
    plan = {"multires": 6, "embedding": "barf"}
    tracing.reset_constant_counts()
    a = embed_window(plan, 2000, cfg)
    assert embed_window(plan, 2000, cfg) is a
    b = embed_window(plan, 2001, cfg)
    assert b is not a and not torch.equal(a, b)
    assert tracing.CONSTANTS == {"copied": 2, "hits": 1}
    # the same window through barf_embed's f32 path is the same key
    assert window_on(barf_alpha(2000, 6, *cfg), 6, 3, "cpu") is a
    assert tracing.CONSTANTS == {"copied": 2, "hits": 2}
    assert not tracing.CONSTANTS_BY_SPAN  # by span only while a profiler records
    # the least recently used goes first; made again, it holds the same values
    for s in range(device_constants.CAPACITY):
        embed_window(plan, 3000 + s, cfg)
    again = embed_window(plan, 2000, cfg)
    assert again is not a and torch.equal(again, a)


def test_constants_are_counted_by_the_innermost_span_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    cfg = (321, 7654)
    plan = {"multires": 6, "embedding": "barf"}
    tracing.reset_constant_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        embed_window(plan, 500, cfg)
        with tracing.span("hold.outer"):
            embed_window(plan, 501, cfg)
            with tracing.span("hold.inner"):
                embed_window(plan, 501, cfg)
                embed_window(plan, 502, cfg)
            embed_window(plan, 502, cfg)
    assert tracing.CONSTANTS_BY_SPAN == {
        ("no span", "copied"): 1, ("hold.outer", "copied"): 1, ("hold.inner", "hits"): 1,
        ("hold.inner", "copied"): 1, ("hold.outer", "hits"): 1}
    assert tracing.CONSTANTS == {"copied": 3, "hits": 2}


def test_constants_are_the_plain_construction_made_once():
    tips = device_constants.constant(TIP_VERTEX_IDS, None, "cpu")
    assert tips.dtype == torch.int64 and torch.equal(tips, torch.as_tensor(TIP_VERTEX_IDS))
    assert device_constants.constant(TIP_VERTEX_IDS, None, None) is tips
    row = device_constants.constant((0.0, 0.0, 0.0, 1.0), torch.get_default_dtype(), "cpu")
    assert torch.equal(row, torch.tensor([0.0, 0.0, 0.0, 1.0])) and row.dtype == torch.float32
    box = device_constants.constant(HAND_GLOBAL_SIGMA_XYZ, torch.float32, "cpu")
    assert torch.equal(box, torch.as_tensor(HAND_GLOBAL_SIGMA_XYZ, dtype=torch.float32))
    # another dtype of the same values is another constant
    box64 = device_constants.constant(HAND_GLOBAL_SIGMA_XYZ, torch.float64, "cpu")
    assert box64.dtype == torch.float64 and box64 is not box


def test_tip_gather_is_the_plain_construction():
    srv = build_mano_server(True, np.zeros(10), device="cpu")
    g = torch.Generator().manual_seed(5)
    pose = mano_full_pose(srv.consts, 0.3 * torch.randn((2, 3), generator=g),
                          0.3 * torch.randn((2, 45), generator=g))
    out = lbs_forward(srv.consts, torch.zeros((2, 10)), pose)
    want = out.vertices[:, torch.as_tensor(TIP_VERTEX_IDS, device=out.vertices.device)]
    assert torch.equal(out.joints[:, 16:], want)


def test_object_transform_is_the_plain_construction():
    rng = np.random.RandomState(2)
    norm = np.eye(4)
    norm[:3, :3] *= 1.7
    norm[:3, 3] = rng.randn(3)
    state = build_object_server(rng.randn(40, 3), 0.8, norm, "cpu")
    rot, transl = torch.tensor(rng.randn(3, 3) * 0.5, dtype=torch.float32), \
        torch.tensor(rng.randn(3, 3), dtype=torch.float32)
    scale = torch.tensor(1.3)
    got = object_server_forward(state, scale, transl, rot)
    # the transform as it was built, its homogeneous row made on the spot
    B = 3
    s = torch.as_tensor(scale, dtype=torch.float32).reshape(-1).expand(B)
    R = axis_angle_to_matrix(rot)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(B, 1, 4)
    rigid = torch.cat([torch.cat([R, transl.reshape(B, 3, 1)], dim=-1), bottom], dim=-2)
    scale_mat = torch.diag_embed(torch.stack([s, s, s, torch.ones((B,))], dim=-1))
    o = state.obj_scale.reshape(())
    obj_scale_mat = torch.diag_embed(torch.stack([o, o, o, torch.ones_like(o)]))
    T = scale_mat @ rigid @ obj_scale_mat @ state.denorm_mat[None]
    assert torch.equal(got.obj_tfs, T)


def test_uniform_box_samples_are_the_plain_construction():
    g = torch.Generator().manual_seed(9)
    pc, noise, glob = (torch.randn((2, 5, 3), generator=g), torch.randn((2, 5, 3), generator=g),
                       torch.rand((2, 7, 3), generator=g))
    got = point_in_space_sample(pc, 0.008, HAND_GLOBAL_SIGMA_XYZ, noise, glob)
    box = torch.as_tensor(HAND_GLOBAL_SIGMA_XYZ, dtype=torch.float32)
    want = torch.cat([pc + noise * 0.008, glob * (2.0 * box) - box], dim=1)
    assert torch.equal(got, want)
    # a tensor box (the object's mesh state) is used as it is
    t = torch.tensor([0.2, 0.1, 0.3])
    assert torch.equal(point_in_space_sample(pc, 0.03, t, noise, glob)[:, 5:],
                       glob * (2.0 * t) - t)


def _toy_model() -> dict:
    m = copy.deepcopy(DEFAULT_CONFIG["model"])
    m["proposal"]["enabled"] = False
    for k in ("implicit_network", "rendering_network"):
        m[k]["dims"] = [64] * len(m[k]["dims"])
    m["bg_implicit_network"]["dims"] = [96] * 8
    m["bg_rendering_network"]["dims"] = [32]
    m["ray_sampler"].update(N_samples=8, N_samples_eval=16, N_samples_extra=4,
                            max_total_iters=2, beta_iters=3)
    return m


def _scene(model: dict, dev, rays: int, two_hands: bool = False):
    built = generate_sequence(None, n_frames=3, img_hw=(48, 64), two_hands=two_hands)
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=rays)
    model = dict(model, scene_bounding_sphere=seq.scene_bounding_sphere)
    scene = build_scene(model, Cfg(ARGS), seq.scene_data(), dev)
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    return seq, scene, params


@pytest.mark.parametrize("step", [199, 200])
def test_targets_flag_turns_on_at_step_200(step):
    seq, scene, params = _scene(_toy_model(), torch.device("cpu"), 8)
    batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(0), 1, offset=1,
                                                   num_sample=8), "cpu")
    gen = torch.Generator().manual_seed(0)
    B, P = batch["uv"].shape[:2]
    z = sample_all_z(params, scene, batch, gen, step, 0)
    out = holdnet_forward(params, scene, batch, empty_object_mesh_state("cpu"),
                          sample_step_draws(scene, B, P, gen), step, 0, z_vals_dict=z)
    flag = out["right.active"]
    want = torch.tensor(float(step >= 200))
    assert flag.shape == () and flag.dtype == want.dtype and torch.equal(flag, want)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@contextlib.contextmanager
def no_sync():
    """Every synchronising CUDA call inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_card_constants_are_the_host_values(cuda):
    for embedding in ("fourier", "barf"):
        for step in STEPS:
            for L in (6, 10):
                plan = {"multires": L, "embedding": embedding}
                got = embed_window(plan, step, BARF, cuda)
                assert got.is_cuda and torch.equal(got.cpu(), _plain_window(embedding, L, step))
    x = torch.randn((33, 3), generator=torch.Generator().manual_seed(3))
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(cuda, dtype)
        for step in STEPS[1:]:
            alpha = barf_alpha(step, 6, *BARF)
            want = fourier_embed(xd, 6) * barf_window(alpha, 6, 3).to(device=cuda, dtype=dtype)
            assert torch.equal(barf_embed(xd, 6, alpha), want), (dtype, step)
    tips = device_constants.constant(TIP_VERTEX_IDS, None, cuda)
    assert torch.equal(tips.cpu(), torch.as_tensor(TIP_VERTEX_IDS))


@pytest.mark.gpu
@pytest.mark.parametrize("step", [300, 9000], ids=["trunk", "proposal"])
@pytest.mark.parametrize("two_hands", [False, True], ids=["h1o", "h2o"])
def test_train_step_makes_no_stream_sync(cuda, two_hands, step):
    """A warmed step of the port's full widths, its BARF window new at each
    step (annealing from step 100 to 10,000), in trunk mode (the fused
    sampler query) and past the proposal's warmup."""
    seq, scene, params = _scene(copy.deepcopy(DEFAULT_CONFIG["model"]), cuda, 64, two_hands)
    train_step = make_train_step(scene, optimizer_for(Cfg(ARGS), params))
    mesh_state = object_mesh_state_from_mesh(*geodesic_sphere(0.5, 4), cuda)
    rng = np.random.RandomState(0)
    gen = torch.Generator(cuda).manual_seed(0)

    def batch():
        return batch_to_device(seq.sample_tempo_batch(rng, 2, offset=1, num_sample=64), cuda)

    train_step(params, batch(), mesh_state, gen, step, 0)
    b = batch()
    with no_sync():
        aux = train_step(params, b, mesh_state, gen, step + 1, 0)
    assert torch.isfinite(aux["loss"]).item()


@pytest.mark.gpu
def test_render_chunk_makes_no_stream_sync(cuda):
    seq, scene, params = _scene(copy.deepcopy(DEFAULT_CONFIG["model"]), cuda, 64)
    chunk = make_chunk_renderer(scene)
    with torch.no_grad():
        packs = render_packs(params, scene)
    fb = seq.full_frame_batch(1, downsample=2)
    batch = {
        "frame_idx": torch.as_tensor(np.asarray(fb["frame_idx"]), dtype=torch.long, device=cuda),
        "scene_scale": torch.as_tensor(float(fb["scene_scale"]), device=cuda),
        "intrinsics": torch.as_tensor(np.asarray(fb["intrinsics"]), dtype=torch.float32,
                                      device=cuda),
        "extrinsics": torch.as_tensor(np.asarray(fb["extrinsics"]), dtype=torch.float32,
                                      device=cuda),
    }
    uv = torch.as_tensor(fb["uv"], dtype=torch.float32, device=cuda)
    chunk(params, {**batch, "uv": uv[:, :256]}, packs)
    with no_sync():
        out = chunk(params, {**batch, "uv": uv[:, 256:512]}, packs)
    assert torch.isfinite(out["rgb"]).all().item()

