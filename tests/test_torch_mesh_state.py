"""The object's mesh state in hold_tpu_torch, against the JAX package and in
training, at toy sizes.

- ``object_mesh_state_from_mesh`` equals the JAX package's buffer by buffer
  on the same mesh, as given and through the decimation walk-down;
- when 8 decimation rounds cannot fit the vertices into the bound's 8,192
  rows, the state falls back to the invalid one with a warning, never a
  truncated vertex set (counterpart of ``tests/test_mesh_state_fallback.py``);
- the invalid state trains finite and turns off only the object's sparse and
  eikonal terms;
- ``run_training`` on the CPU with meshing on, at once (``fast_dev_run``) and
  on its worker thread, writes ``mesh_cano/*.obj`` and ``misc/*.npy`` and
  adopts an object state with ``valid`` = 1.
"""

import copy
import logging
import os

import numpy as np
import pytest
import torch

from hold_tpu.models import holdnet as jhn
from hold_tpu.utils.config import DEFAULT_CONFIG
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.models.losses import compute_losses
from hold_tpu_torch.train import batch_to_device
from hold_tpu_torch.utils.config import Cfg
from hold_tpu_torch.utils.convert import flatten_params
from hold_tpu_torch.utils.mesh import load_obj


def _sphere_mesh(n_theta=40, n_phi=40):
    th = np.linspace(0.1, np.pi - 0.1, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)],
                 -1).reshape(-1, 3).astype(np.float32) * 0.1
    f = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a, b = i * n_phi + j, i * n_phi + (j + 1) % n_phi
            c, d = (i + 1) * n_phi + j, (i + 1) * n_phi + (j + 1) % n_phi
            f += [[a, b, c], [b, d, c]]
    return v, np.asarray(f, np.int64)


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


@pytest.mark.parametrize("n", [40, 100], ids=["1600_verts", "10000_verts_decimated"])
def test_mesh_state_matches_jax(n):
    v, f = _sphere_mesh(n, n)
    got = thn.object_mesh_state_from_mesh(v, f, "cpu")
    ref = jhn.object_mesh_state_from_mesh(v, f)
    assert set(ref) - set(got) == {"tri"}  # read by nothing in either package
    for k in ("centers", "bound_centers", "sigma_xyz", "valid"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    np.testing.assert_allclose(float(got["h_margin"]), float(ref["h_margin"]), rtol=1e-6)
    assert float(got["valid"]) == 1.0
    real = int((got["bound_centers"][:, 0] < 1e4).sum())
    assert real == v.shape[0] if n == 40 else 0 < real <= thn.OBJ_BOUND_V < v.shape[0]


def test_decimation_overflow_falls_back(monkeypatch, caplog):
    """8 rounds that cannot fit 8,192 vertices give the INVALID state (the
    bound off), never a truncated vertex table, which would loosen the
    off-surface bound and corrupt the sparse loss."""
    import hold_tpu_torch.utils.mesh as UM

    v, f = _sphere_mesh(100, 100)  # > 8,192 vertices: the decimation path runs

    class _Stuck:
        vertices = np.random.RandomState(0).randn(9000, 3).astype(np.float32)
        faces = np.tile(np.arange(3), (100, 1)).astype(np.int64)

    calls = []
    monkeypatch.setattr(UM, "decimate_mesh", lambda *a: calls.append(a[2]) or _Stuck())
    with caplog.at_level(logging.WARNING, logger="hold_tpu_torch"):
        state = thn.object_mesh_state_from_mesh(v, f, "cpu")
    assert len(calls) == 8 and calls[0] == thn.OBJ_MESH_MAX_F // 2 and calls[1] < calls[0]
    assert float(state["valid"]) == 0.0
    assert "disabling the off-surface vertex bound" in caplog.text
    assert float(state["bound_centers"].min()) >= 1e4  # nothing classifies on-surface


@pytest.fixture(scope="module")
def toy_seq():
    built = generate_sequence(None, n_frames=4, img_hw=(72, 96))
    return SequenceData(built["images"], built["masks"], built["data"], num_sample=8)


def test_invalid_state_trains_finite_and_gates_only_sparse_terms(toy_seq):
    seq = toy_seq
    opt = _toy_model()
    opt["scene_bounding_sphere"] = seq.scene_bounding_sphere
    scene = thn.build_scene(opt, {"barf_s": 5, "barf_e": 50}, seq.scene_data(), "cpu")
    params = thn.init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(0), 2, num_sample=8),
                            "cpu")
    B, P = batch["uv"].shape[:2]
    step, epoch = 1000, 5
    z = thn.sample_all_z(params, scene, batch, torch.Generator().manual_seed(7), step, epoch)
    v, f = _sphere_mesh()
    states = {"valid": thn.object_mesh_state_from_mesh(v, f, "cpu"),
              "empty": thn.empty_object_mesh_state("cpu")}
    losses, outs = {}, {}
    for name, state in states.items():
        draws = thn.sample_step_draws(scene, B, P, torch.Generator().manual_seed(7))
        outs[name] = thn.holdnet_forward(params, scene, batch, state, draws, step, epoch,
                                         z_vals_dict=z)
        terms = compute_losses(batch, outs[name], scene.node_ids, step)
        grads = torch.autograd.grad(terms["loss"], [t for t in flatten_params(params).values()
                                                    if t.requires_grad], allow_unused=True)
        assert all(g is None or bool(torch.isfinite(g).all()) for g in grads), name
        losses[name] = {k: float(v.detach()) for k, v in terms.items()}
        assert all(np.isfinite(x) for x in losses[name].values()), name
    assert float(outs["valid"]["object.active"]) == 1.0
    assert float(outs["empty"]["object.active"]) == 0.0
    # the photometric and semantic terms do not read the mesh state
    for k in ("loss/rgb", "loss/sem"):
        assert losses["empty"][k] == losses["valid"][k], k
    # the object's sparse and eikonal terms are gated off by valid = 0
    for k in ("loss/opacity_sparse", "loss/eikonal"):
        assert losses["empty"][k] <= losses["valid"][k] + 1e-9, k


@pytest.mark.parametrize("fast_dev_run", [True, False], ids=["at_once", "worker_thread"])
def test_run_training_meshes_and_adopts_the_object_state(toy_seq, tmp_path, fast_dev_run):
    from hold_tpu_torch.train import run_training

    cfg = {"model": _toy_model(), "dataset": copy.deepcopy(DEFAULT_CONFIG["dataset"])}
    cfg["dataset"]["train"]["batch_size"] = 1
    # one step an epoch: meshing after steps 1 and 2 at once, or after step 3
    # (epoch 3) on the worker thread, waited for at the end
    steps = 2 if fast_dev_run else 3
    args = Cfg({"barf_s": 0, "barf_e": 1000, "lr": 1e-3, "case": "toy", "num_sample": 8,
                "tempo_len": 1, "offset": 1, "log_every": 1, "no_vis": True, "mute": True,
                "exp_key": "mesh", "log_root": str(tmp_path), "seed": 0, "total_step": steps,
                "fast_dev_run": fast_dev_run})
    _, scene, mesh_state, tracker, _, _ = run_training(args, cfg, seq=toy_seq, device="cpu")
    assert float(mesh_state["valid"]) == 1.0
    at = [1, 2] if fast_dev_run else [3]
    log_dir = tracker.log_dir
    assert sorted(os.listdir(os.path.join(log_dir, "misc"))) == [f"{s:09d}.npy" for s in at]
    misc = np.load(os.path.join(log_dir, "misc", f"{at[-1]:09d}.npy"), allow_pickle=True).item()
    assert {"K", "w2c", "scale", "img_paths", "object.obj_scale", "meshes_cano"} <= set(misc)
    obj = misc["meshes_cano"]["object"]
    on_disk = load_obj(os.path.join(log_dir, "mesh_cano", f"mesh_cano_object_step_{at[-1]}.obj"))
    assert np.array_equal(on_disk.faces, obj["faces"])
    np.testing.assert_allclose(on_disk.vertices, obj["vertices"], atol=1e-6)
    real = int((mesh_state["bound_centers"][:, 0] < 1e4).sum())
    assert 0 < real <= min(obj["vertices"].shape[0], thn.OBJ_BOUND_V)
