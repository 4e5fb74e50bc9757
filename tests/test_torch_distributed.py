"""hold_tpu_torch.parallel.sharding and the training loop over several
processes, on the CPU: two gloo ranks against one process, 2 steps at toy
size, resumed at step 300 so that the hand's sparse term (a masked mean
over the rays, on from step 200) is in the loss.  Held: the per-term losses
of each step and the parameters after each step; the ranks' parameters
alike; the validation chunk split over the ranks against the whole; and two
controls that must fail the same limits: ranks that average their own
masked means, and ranks that skip the gradient all-reduce.  Also
``shard_batch``'s slices against the JAX package's shards, and the
launcher's deadline.

Every test that starts processes passes the launcher a deadline: it kills
its children and fails when the deadline passes.
"""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.parallel import sharding
from hold_tpu_torch.utils.checkpoint import read_checkpoint, save_checkpoint
from hold_tpu_torch.utils.config import DEFAULT_CONFIG, Cfg

START = 300  # the hand's sparse term is on from step 200; prog = 0.01
STEPS = 2
WORLD = 2
DEADLINE_S = 240.0
# two ranks against one process: each loss term (and the psnr) of each step
# within LOSS_RTOL of the one process's, each parameter after each step
# within PARAM_ATOL.  Read on this CPU: 1.2e-7 and 5.5e-7 (the ranks sum
# their rays in two halves); the controls read 2.4e-2 (the local masked
# means' sparse term at the first step) and 1.5e-3, and 2e-3 on the
# parameters (Adam's first step moves a parameter by up to lr = 1e-3).
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


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


def _cfg():
    cfg = {"model": _toy_model(), "dataset": copy.deepcopy(DEFAULT_CONFIG["dataset"])}
    cfg["dataset"]["train"]["batch_size"] = 1
    return cfg


def _seq():
    built = generate_sequence(None, n_frames=3, img_hw=(48, 64))
    return SequenceData(built["images"], built["masks"], built["data"], num_sample=8)


def _args(log_root, exp_key, **kw):
    return Cfg({"barf_s": 0, "barf_e": 1000, "lr": 1e-3, "freeze_pose": False,
                "case": "toy", "num_sample": 8, "tempo_len": 1, "offset": 1, "log_every": 1,
                "no_meshing": True, "no_vis": True, "mute": True, "eval_every_epoch": 1,
                "render_downsample": 4, "exp_key": exp_key, "log_root": str(log_root),
                "seed": 0, "total_step": START + STEPS, **kw})


SDF_BIAS = "right/implicit/layers/8/b"
HAND_RADIUS = 0.05
VARIANTS = ("split", "local_mean", "no_allreduce")


def _rank_worker(rank, world, device, log_root):
    """One rank: the three variants in turn, each from its own copy of the
    seed checkpoint; then frame 0 rendered with the split chunk renderer
    from the split run's parameters.  Returns each variant's parameters and
    the render's maps."""
    from contextlib import nullcontext
    from unittest import mock

    from hold_tpu_torch import train
    from hold_tpu_torch.models.losses import compute_losses
    from hold_tpu_torch.render.renderer import make_chunk_renderer, render_frame
    from hold_tpu_torch.utils.convert import flatten_params

    torch.set_num_threads(1)
    seq = _seq()
    out = {}
    controls = {
        "split": {},
        # each rank's masked mean over its own rays, averaged
        "local_mean": {"compute_losses": lambda b, o, ids, step, split=None:
                       compute_losses(b, o, ids, step, None)},
        "no_allreduce": {"average_gradients": lambda params, split: None},
    }
    for name in VARIANTS:
        with mock.patch.multiple(train, **controls[name]) if controls[name] else nullcontext():
            params, scene = train.run_training(_args(log_root, name), _cfg(), seq=seq,
                                               device=device)[:2]
        out[name] = {k: v.detach().clone() for k, v in flatten_params(params).items()}
        if name == "split":
            chunk = sharding.split_chunk_renderer(make_chunk_renderer(scene),
                                                  sharding.current_split(device))
            fb = seq.full_frame_batch(0, downsample=4)
            out["render"] = render_frame(params, scene, fb, pixel_per_batch=37, chunk_fn=chunk)
    return out


def _seed_experiment(log_root, exp_key, seed_state):
    save_checkpoint(os.path.join(str(log_root), exp_key), START, seed_state)


def _records(log_root, exp_key):
    with open(os.path.join(str(log_root), exp_key, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f) if "loss" in r}


def _params_at(log_root, exp_key, step):
    path = os.path.join(str(log_root), exp_key, "checkpoints", f"step_{step:09d}.pt")
    return read_checkpoint(path)["params"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process run in this process, then the two ranks' three
    variants in two spawned processes, all from one seed checkpoint."""
    from hold_tpu_torch.train import run_training

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        root = tmp_path_factory.mktemp("dist")
        seq = _seq()
        # the seed: the init parameters saved at step START
        run_training(_args(root, "seed", total_step=0), _cfg(), seq=seq, device="cpu")
        seed = read_checkpoint(os.path.join(str(root), "seed", "checkpoints", "last.pt"))
        seed["step"] = START
        # a hand surface that cuts the rays: at the init's radius (0.6) every
        # sampled ray lies inside it, every mask_prob is 1, and the ranks'
        # masked means equal the global one whatever the split
        seed["params"][SDF_BIAS][0] = -HAND_RADIUS
        for key in ("one",) + VARIANTS:
            _seed_experiment(root, key, seed)
        t0 = time.perf_counter()
        params, scene = run_training(_args(root, "one"), _cfg(), seq=seq, device="cpu")[:2]
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = sharding.launch(_rank_worker, WORLD, ["cpu"] * WORLD, (str(root),),
                                timeout=DEADLINE_S)
        ranks_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(n)
    return {"root": root, "seq": seq, "scene": scene, "ranks": ranks, "one_s": one_s,
            "ranks_s": ranks_s}


def _loss_gaps(root, key) -> dict:
    """step -> {term: |d| / max(|ref|, 1e-12)} against the one-process run."""
    ref, got = _records(root, "one"), _records(root, key)
    assert sorted(got) == sorted(ref) == list(range(START, START + STEPS))
    return {s: {k: abs(got[s][k] - v) / max(abs(v), 1e-12) for k, v in ref[s].items()
                if k.startswith("loss") or k == "psnr"} for s in ref}


def _param_gaps(root, key) -> dict:
    """step -> the largest |d| of any parameter against the one-process run."""
    out = {}
    for s in range(START + 1, START + STEPS + 1):
        ref, got = _params_at(root, "one", s), _params_at(root, key, s)
        assert sorted(got) == sorted(ref)
        out[s] = max(float((got[k] - ref[k]).abs().max()) for k in ref)
    return out


def test_two_ranks_match_one_process(runs):
    losses = _loss_gaps(runs["root"], "split")
    params = _param_gaps(runs["root"], "split")
    print(f"one process {runs['one_s']:.1f} s, two ranks x {len(VARIANTS)} runs "
          f"{runs['ranks_s']:.1f} s; loss gaps {losses}; parameter gaps {params}")
    assert max(max(g.values()) for g in losses.values()) <= LOSS_RTOL, losses
    assert max(params.values()) <= PARAM_ATOL, params
    # the sparse term is in the loss and differs between the ranks' halves
    one = _records(runs["root"], "one")
    assert all(one[s]["loss/opacity_sparse"] > 0 for s in one)


@pytest.mark.parametrize("control", ["local_mean", "no_allreduce"])
def test_controls_fail_the_limits(runs, control):
    """Ranks that average their own masked means, and ranks that step on
    their own gradients, must fail the limits the split run meets."""
    losses = _loss_gaps(runs["root"], control)
    params = _param_gaps(runs["root"], control)
    assert max(max(g.values()) for g in losses.values()) > 10 * LOSS_RTOL, losses
    assert max(params.values()) > 10 * PARAM_ATOL, params


def test_ranks_hold_the_same_parameters(runs):
    a, b = runs["ranks"]
    for k in a["split"]:
        assert torch.equal(a["split"][k], b["split"][k]), k
    # without the all-reduce each rank steps on its own rays
    assert any(not torch.equal(a["no_allreduce"][k], b["no_allreduce"][k])
               for k in a["no_allreduce"])


def test_rank_0_alone_writes(runs):
    """One record a step and one checkpoint a step: the other rank's
    tracker and checkpoints write nothing."""
    with open(os.path.join(str(runs["root"]), "split", "metrics.jsonl")) as f:
        steps = [r["step"] for r in map(json.loads, f) if "loss" in r]
    assert steps == list(range(START, START + STEPS))
    ckpts = sorted(os.listdir(os.path.join(str(runs["root"]), "split", "checkpoints")))
    assert ckpts == ["last.pt"] + [f"step_{s:09d}.pt" for s in range(START, START + STEPS + 1)]


def test_split_render_chunks_match_the_whole(runs):
    """A frame rendered with its chunks split over the ranks (37 pixels a
    chunk: uneven splits and a short last chunk) against the whole chunks
    in one process, at rank 0's parameters."""
    from hold_tpu_torch.render.renderer import render_frame
    from hold_tpu_torch.utils.checkpoint import merge_params
    from hold_tpu_torch.models.holdnet import init_scene_params

    a, b = runs["ranks"]
    scene, seq = runs["scene"], runs["seq"]
    params = merge_params(init_scene_params(torch.Generator().manual_seed(0), scene,
                                            seq.scene_data()), a["split"])
    whole = render_frame(params, scene, seq.full_frame_batch(0, downsample=4),
                         pixel_per_batch=37)
    for k, v in whole.items():
        np.testing.assert_array_equal(a["render"][k], b["render"][k], err_msg=k)
        np.testing.assert_allclose(a["render"][k], v, rtol=0, atol=1e-6, err_msg=k)


def test_shard_batch_slices_every_frames_rays():
    B, P, W = 3, 8, 2
    rng = np.random.RandomState(0)
    batch = {"uv": rng.rand(B, P, 2), "gt_rgb": rng.rand(B * P, 3), "gt_mask": rng.rand(B * P),
             "frame_idx": np.arange(B), "intrinsics": rng.rand(B, 4, 4)}
    parts = [sharding.shard_batch(batch, r, W) for r in range(W)]
    np.testing.assert_array_equal(np.concatenate([p["uv"] for p in parts], axis=1),
                                  batch["uv"])
    for k in ("gt_rgb", "gt_mask"):
        whole = np.concatenate([p[k].reshape((B, P // W) + batch[k].shape[1:]) for p in parts],
                               axis=1)
        np.testing.assert_array_equal(whole.reshape(batch[k].shape), batch[k])
    for p in parts:
        assert p["frame_idx"] is batch["frame_idx"] and p["intrinsics"] is batch["intrinsics"]
    assert sharding.shard_batch(batch, 0, 1) is batch
    with pytest.raises(ValueError):
        sharding.shard_batch(batch, 0, 3)


def test_uv_and_render_chunk_slices_are_the_jax_shards():
    """The JAX package's shardings on a 2-device mesh: device r holds the
    port's rank-r ``uv`` slice of a training batch and of a render chunk.
    (Its ``gt_rgb``/``gt_mask`` shards are blocks of B*P rows, a layout of
    one global program; the port slices them with ``uv``.)"""
    import jax

    from hold_tpu.parallel import sharding as jsharding

    mesh = jsharding.make_mesh(2)
    rng = np.random.RandomState(1)
    batch = {"uv": rng.rand(5, 8, 2).astype(np.float32),
             "gt_rgb": rng.rand(40, 3).astype(np.float32),
             "gt_mask": rng.rand(40).astype(np.float32),
             "frame_idx": np.arange(5, dtype=np.int32)}
    jb = jsharding.shard_batch(batch, mesh)
    jc = jsharding.shard_render_chunk({"uv": batch["uv"][:1]}, mesh)
    for r, dev in enumerate(mesh.devices.flat):
        mine = sharding.shard_batch(batch, r, 2)
        shard = [s for s in jb["uv"].addressable_shards if s.device == dev][0]
        np.testing.assert_array_equal(np.asarray(shard.data), mine["uv"])
        cshard = [s for s in jc["uv"].addressable_shards if s.device == dev][0]
        np.testing.assert_array_equal(np.asarray(cshard.data), mine["uv"][:1])
    assert jax.device_count() >= 2


def test_ray_rand_slices_the_global_draws():
    """Each rank's per-ray draws are its rays' rows of the one process's
    draws, and the generator advances alike, so later draws agree too."""
    B, P, N, W = 3, 8, 5, 2
    ref_gen = torch.Generator().manual_seed(7)
    ref = torch.rand((B * P, N), generator=ref_gen)
    after = torch.rand(4, generator=ref_gen)
    for r in range(W):
        g = torch.Generator().manual_seed(7)
        got = sharding.ray_rand(sharding.RankDraws(g, r, W, B), (B * P // W, N), "cpu")
        torch.testing.assert_close(got, sharding.ray_slice(ref, B, r, W), rtol=0, atol=0)
        assert torch.equal(torch.rand(4, generator=g), after)
        assert sharding.generator_of(sharding.RankDraws(g, r, W, B)) is g


class _TwoRanks:
    """A stand-in split whose ``sum`` adds both ranks' values."""

    def __init__(self, other):
        self.world, self.other = 2, other

    def sum(self, t):
        return t.detach() + self.other


def test_masked_mean_over_ranks_is_the_global_one():
    """The ranks' masked means (and gradients) average to the one over every
    ray; the means of their own halves do not."""
    from hold_tpu_torch.models.losses import masked_mean

    rng = np.random.RandomState(3)
    v = torch.tensor(rng.rand(40), requires_grad=True)
    m = torch.tensor(np.r_[rng.rand(20) < 0.8, rng.rand(20) < 0.2])
    ref = masked_mean(v, m)
    (g_ref,) = torch.autograd.grad(ref, v)
    halves = [(v[:20], m[:20]), (v[20:], m[20:])]
    counts = [mm.double().sum() for _, mm in halves]
    vals = [masked_mean(vv, mm, _TwoRanks(counts[1 - i])) for i, (vv, mm) in enumerate(halves)]
    mean = (vals[0] + vals[1]) / 2
    (g,) = torch.autograd.grad(mean, v)
    torch.testing.assert_close(mean, ref, rtol=1e-12, atol=0)
    torch.testing.assert_close(g, g_ref, rtol=1e-12, atol=0)
    local = (masked_mean(*halves[0]) + masked_mean(*halves[1])) / 2
    assert abs(float(local.detach() - ref.detach())) > 1e-2


def _sleeper(rank, world, device):
    time.sleep(600)


def _failer(rank, world, device):
    if rank == 1:
        raise ValueError("rank 1 fails")
    time.sleep(600)


def test_launch_kills_its_ranks_at_the_deadline():
    import multiprocessing

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        sharding.launch(_sleeper, 2, ["cpu", "cpu"], timeout=8.0)
    assert time.perf_counter() - t0 < 40
    assert multiprocessing.active_children() == []


def test_launch_raises_a_ranks_error():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        sharding.launch(_failer, 2, ["cpu", "cpu"], timeout=60.0)


def test_local_process_count():
    assert sharding.local_process_count(3, "cpu") == 3
    assert sharding.local_process_count(0, "cpu") == 1
    assert sharding.rank_devices(2, "cpu") == ["cpu", "cpu"]
    assert sharding.init_url("host:1234") == "tcp://host:1234"
    assert not sharding.init_distributed("")
    assert sharding.current_split("cpu") is None


def test_train_cli_runs_two_cpu_ranks(tmp_path):
    """``python -m hold_tpu_torch.train --num_devices 2 --device cpu``: two
    gloo ranks started by the CLI's launcher, at toy width (a YAML config),
    rank 0 alone writing.  Killed with its ranks past the deadline."""
    import signal
    import subprocess
    import sys

    import yaml

    generate_sequence(str(tmp_path / "data" / "toy"), n_frames=3, img_hw=(48, 64))
    cfg = _cfg()
    (tmp_path / "toy.yaml").write_text(yaml.safe_dump(cfg))
    cmd = [sys.executable, "-m", "hold_tpu_torch.train", "--case", "toy", "--data_root",
           str(tmp_path / "data"), "--log_root", str(tmp_path / "logs"), "--config",
           str(tmp_path / "toy.yaml"), "--num_devices", "2", "--device", "cpu", "--num_epoch",
           "2", "--tempo_len", "1", "--num_sample", "8", "--no_vis", "--no_meshing",
           "--exp_key", "cli", "--barf_s", "0", "--barf_e", "1000"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, cwd=str(tmp_path), env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the CLI's two ranks not done within {DEADLINE_S} s")
    assert proc.returncode == 0, out[-3000:]
    log_dir = tmp_path / "logs" / "cli"
    with open(log_dir / "metrics.jsonl") as f:
        recs = [r for r in map(json.loads, f) if "loss" in r]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert "ranks=2 (gloo)" in (log_dir / "train.log").read_text()
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["last.pt", "step_000000002.pt"]
