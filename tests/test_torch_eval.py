"""hold_tpu_torch's evaluation against the JAX package's.

- ``eval/metrics.py`` and ``eval/icp.py`` (numpy copies) on seeded inputs:
  equal to 1e-9;
- the synthetic generator's ``pose_noise``: the port's data.npy equals the
  JAX package's (entities and their truth exactly, cameras to 1e-6);
- ``gt_from_sequence`` within 1e-5;
- ``load_data`` from a port checkpoint of converted params against the JAX
  ``load_data`` from a JAX checkpoint of the same params, in one experiment
  dir with two misc sidecars (the one at or before the checkpoint's step is
  read), within 1e-5; ``run_evaluation`` on both within 1e-4, with the
  first frame's ICP and with ``--icp_every_frame``'s;
- the CLIs: ``evaluate`` writes the JAX format, and with ``--gt ho3d`` (an
  HO3D v3 fixture processed by the port, tests/test_torch_gt.py) scores the
  experiment as the JAX ``run_evaluation`` does against the JAX ``gt_ho3d``
  (within 1e-4); ``summarize_metrics`` prints the JAX package's table.

The experiment's scene is the toy model (widths 64) of
tests/test_torch_train_step.py: the JAX ``load_data``, which rebuilds its
scene from ``load_config()``, is given it; the port reads it from its
checkpoint.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_train_step import _toy_model, jax_params_of

from hold_tpu import evaluate as jeval
from hold_tpu import summarize_metrics as jsumm
from hold_tpu.data.dataset import SequenceData as JSequenceData
from hold_tpu.data.synthetic import generate_sequence as jgenerate
from hold_tpu.eval import icp as jicp
from hold_tpu.eval import metrics as jmetrics
from hold_tpu.models import holdnet as jhn
from hold_tpu.utils import config as jconfig
from hold_tpu_torch import evaluate as teval
from hold_tpu_torch import summarize_metrics as tsumm
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import _sphere_mesh, generate_sequence
from hold_tpu_torch.eval import icp as ticp
from hold_tpu_torch.eval import io_pred as tio
from hold_tpu_torch.eval import metrics as tmetrics
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.utils import checkpoint as tckpt
from hold_tpu_torch.utils.convert import flatten_params, params_from_jax

CKPT_STEP = 5


def _pts(rng, n):
    return rng.randn(n, 3) * 0.05


def _mesh(rng):
    v, f = _sphere_mesh(0.05, 1)
    return v.astype(np.float64) * (1 + 0.2 * rng.rand(3)), f


METRIC_CASES = {
    "chamfer_f_scores": lambda m, rng: m.chamfer_f_scores(_pts(rng, 300), _pts(rng, 250)),
    "per_frame_chamfer_f": lambda m, rng: m.per_frame_chamfer_f(
        [_pts(rng, 400) for _ in range(3)], [_pts(rng, 500) for _ in range(3)],
        np.array([1, 0, 1]), n_points=200),
    "mpjpe_ra": lambda m, rng: m.mpjpe_ra(_pts(rng, 4 * 21).reshape(4, 21, 3),
                                          _pts(rng, 4 * 21).reshape(4, 21, 3),
                                          np.array([1, 1, 0, 1])),
    "mrrpe": lambda m, rng: m.mrrpe(*[_pts(rng, 5) for _ in range(4)], np.ones(5)),
    "iou_per_frame": lambda m, rng: m.iou_per_frame(
        rng.choice([0, 100, 200], (2, 8, 8)), rng.choice([0, 100, 200], (2, 8, 8))),
    "bbox_centers": lambda m, rng: m.bbox_centers(_pts(rng, 3 * 50).reshape(3, 50, 3)),
}


def _icp_case(name, m, rng):
    v, f = _mesh(rng)
    if name == "sample_surface":
        return m.sample_surface(v, f, 100, rng, return_normals=True)
    if name == "umeyama":
        src = _pts(rng, 60)
        return m.umeyama(src, 1.2 * src @ m.random_rotation(rng).T + 0.1)
    pts, nrm = m.sample_surface(v, f, 150, rng, return_normals=True)
    src = pts @ m.random_rotation(rng).T * 0.1 + 0.01
    if name == "pca_init_rotations":
        return m.pca_init_rotations(src, pts)
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    s, R, t = m.icp_point_to_point(src, tree, pts, np.eye(3), [0.05, 0.02], iters_per_stage=4)
    if name == "icp_point_to_point":
        return s, R, t
    return m.icp_point_to_plane(src, tree, pts, nrm, s, R, t, 0.02, max_iters=4)


def _assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metrics_match_jax(name):
    _assert_same(METRIC_CASES[name](tmetrics, np.random.RandomState(0)),
                 METRIC_CASES[name](jmetrics, np.random.RandomState(0)))


@pytest.mark.parametrize("name", ["sample_surface", "umeyama", "pca_init_rotations",
                                  "icp_point_to_point", "icp_point_to_plane"])
def test_icp_steps_match_jax(name):
    _assert_same(_icp_case(name, ticp, np.random.RandomState(1)),
                 _icp_case(name, jicp, np.random.RandomState(1)))


def test_compute_icp_metrics_matches_jax():
    rng = np.random.RandomState(2)
    tv, tf = _mesh(rng)
    sv = tv @ jicp.random_rotation(rng).T * 1.05 + 0.003
    got = ticp.compute_icp_metrics(tv, tf, sv, tf, num_iters=3, n_sample=200)
    want = jicp.compute_icp_metrics(tv, tf, sv, tf, num_iters=3, n_sample=200)
    _assert_same(got, want)
    assert list(teval.EVAL_FN_DICT) == list(jeval.EVAL_FN_DICT)


@pytest.mark.parametrize("mode", ["all", "trans"])
def test_pose_noise_data_matches_jax(mode, tmp_path):
    build = jgenerate(str(tmp_path / "j"), 3, (48, 64), seed=3, pose_noise=0.3,
                      pose_noise_mode=mode)
    want = np.load(os.path.join(build, "data.npy"), allow_pickle=True).item()
    got = generate_sequence(None, 3, (48, 64), seed=3, pose_noise=0.3,
                            pose_noise_mode=mode)["data"]
    assert set(got) == set(want) and "entities_gt" in got
    for key in ("entities", "entities_gt"):
        assert set(got[key]) == set(want[key])
        for nid, e in want[key].items():
            assert set(got[key][nid]) == set(e)
            for k, v in e.items():
                np.testing.assert_array_equal(got[key][nid][k], v, err_msg=f"{key}.{nid}.{k}")
    for k, v in want["cameras"].items():
        np.testing.assert_allclose(got["cameras"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["normalize_shift"], want["normalize_shift"])
    assert got["scene_bounding_sphere"] == want["scene_bounding_sphere"]
    clean = generate_sequence(None, 3, (48, 64), seed=3)["data"]
    assert "entities_gt" not in clean
    np.testing.assert_array_equal(got["entities_gt"]["right"]["hand_poses"],
                                  clean["entities"]["right"]["hand_poses"])
    moved = got["entities"]["right"]["hand_poses"] != clean["entities"]["right"]["hand_poses"]
    assert moved.any() == (mode == "all")


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A noised synthetic sequence, and one experiment dir holding a JAX
    checkpoint and a port checkpoint of the same params (tables moved off
    the init), with misc sidecars before and after the checkpoint's step."""
    from hold_tpu.utils import checkpoint as jckpt  # orbax: not on every host

    root = tmp_path_factory.mktemp("eval")
    data_root = str(root / "data")
    generate_sequence(os.path.join(data_root, "noisy"), 3, (48, 64), seed=1, pose_noise=0.3)
    jseq = JSequenceData("noisy", data_root)
    tseq = SequenceData.from_build_dir("noisy", data_root)
    # the JAX load_experiment rebuilds its scene from load_config(): give it
    # the toy model; the port reads the model config from its checkpoint
    mp = pytest.MonkeyPatch()
    mp.setattr(jconfig, "load_config", lambda: {"model": _toy_model()})
    # the params: the port's init, in the JAX package's tree
    opt = _toy_model()
    opt["scene_bounding_sphere"] = tseq.scene_bounding_sphere
    tscene = thn.build_scene(opt, {}, tseq.scene_data(), "cpu")
    params = jax.device_get(jax_params_of(
        thn.init_scene_params(torch.Generator().manual_seed(0), tscene, tseq.scene_data()),
        jhn.build_scene(opt, {}, jseq.scene_data()), jseq.scene_data()))
    # the JAX load_experiment restores into a template from its init, whose
    # values the checkpoint replaces: trace the init for its tree and shapes
    # instead of running it
    init = jhn.init_scene_params
    mp.setattr(jhn, "init_scene_params", lambda key, scene, sd: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(lambda k: init(k, scene, sd), key)))
    rng = np.random.RandomState(4)
    for nid in tscene.node_ids:
        params[nid]["tables"] = {k: (np.asarray(v) + 0.02 * rng.randn(*np.shape(v)))
                                 .astype(np.float32) for k, v in params[nid]["tables"].items()}
    exp = str(root / "exp")
    jckpt.save_checkpoint(exp, CKPT_STEP, {"params": params, "step": CKPT_STEP})
    flat = flatten_params(params_from_jax(params))
    tckpt.save_checkpoint(exp, CKPT_STEP, {"params": {k: v.detach() for k, v in flat.items()},
                                           "step": CKPT_STEP, "model": _toy_model()})
    with open(os.path.join(exp, "args.json"), "w") as f:
        json.dump({}, f)
    for step, scale in ((3, 1.0), (9, 1.3)):  # only the first is at or before the step
        v, f = _sphere_mesh(0.5 * scale, 1)
        jckpt.save_misc(exp, step, {"meshes_cano": {"object": {"vertices": v, "faces": f}}})
    yield {"exp": exp, "data_root": data_root, "jseq": jseq, "tseq": tseq}
    mp.undo()


def _assert_bus_close(got, want, atol):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "faces":
            assert set(got[k]) == set(v)
            for nid in v:
                np.testing.assert_array_equal(got[k][nid], v[nid], err_msg=k)
        elif isinstance(v, np.ndarray):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=atol, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.fixture(scope="module")
def eval_inputs(experiment):
    from hold_tpu.eval import io_pred as jio  # orbax: not on every host

    jpred = jio.load_data(experiment["exp"], experiment["jseq"])
    tpred = tio.load_data(experiment["exp"], experiment["tseq"], "cpu")
    jgt = jio.gt_from_sequence(experiment["jseq"])
    tgt = tio.gt_from_sequence(experiment["tseq"], "cpu")
    return {"jpred": jpred, "tpred": tpred, "jgt": jgt, "tgt": tgt}


def test_gt_from_sequence_matches_jax(eval_inputs, experiment):
    _assert_bus_close(eval_inputs["tgt"], eval_inputs["jgt"], 1e-5)
    # the truth, not the noised init: the hands' joints differ from the init's
    init = experiment["tseq"].data["entities"]["right"]["hand_trans"]
    truth = experiment["tseq"].data["entities_gt"]["right"]["hand_trans"]
    assert not np.allclose(init, truth)


def test_load_data_matches_jax(eval_inputs):
    got, want = eval_inputs["tpred"], eval_inputs["jpred"]
    _assert_bus_close(got, want, 1e-5)
    # the misc at the checkpoint's step or before: the unscaled sphere
    v, f = _sphere_mesh(0.5, 1)
    assert got["faces"]["object"].shape == f.shape
    assert got["v3d_c.object"].shape[1] == v.shape[0]


def test_run_evaluation_matches_jax(eval_inputs):
    got, got_all = teval.run_evaluation(eval_inputs["tpred"], eval_inputs["tgt"], icp_iters=1)
    want, want_all = jeval.run_evaluation(eval_inputs["jpred"], eval_inputs["jgt"], icp_iters=1)
    assert set(got) == set(want) and {"mpjpe_ra_r", "mrrpe_ho", "cd_ra", "cd_icp"} <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
        assert np.isfinite(got[k]), k
    for k, v in want_all.items():
        np.testing.assert_allclose(got_all[k], v, rtol=1e-4, atol=1e-4, err_msg=k)


def test_icp_every_frame_matches_jax(eval_inputs):
    """``--icp_every_frame``: a short ICP on every valid frame, nan-averaged
    (here one iteration, on the first frame: the others marked invalid)."""
    n = len(eval_inputs["tgt"]["v3d_ra.object"])
    valid = np.arange(n) == 0
    tgt, jgt = dict(eval_inputs["tgt"]), dict(eval_inputs["jgt"])
    tgt["is_valid"], jgt["is_valid"] = valid, valid.copy()
    got = teval.eval_icp_every_frame(eval_inputs["tpred"], tgt, {}, num_iters=1)
    want = jeval.eval_icp_every_frame(eval_inputs["jpred"], jgt, {}, num_iters=1)
    assert set(got) == set(want) == {"cd_icp", "f5_icp", "f10_icp"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
        assert np.isfinite(got[k]), k


def test_evaluate_cli_writes_the_jax_format(experiment, eval_inputs, tmp_path):
    argv = ["--exp", experiment["exp"], "--case", "noisy", "--data_root",
            experiment["data_root"], "--icp_iters", "1", "--device", "cpu"]
    rec = teval.main(argv)
    with open(os.path.join(experiment["exp"], "eval.metric.json")) as f:
        written = json.load(f)
    assert written == rec["mean"] and written["seq_name"] == "noisy" and "timestamp" in written
    per_frame = np.load(os.path.join(experiment["exp"], "eval.metric_all.npy"),
                        allow_pickle=True).item()
    assert set(per_frame) == set(rec["per_frame"])
    assert rec["servers_s"] > 0 and rec["metrics_s"] > 0
    from hold_tpu.eval import gt_ho3d as jgt_ho3d
    from test_torch_gt import write_ho3d_gt

    ho3d_root = write_ho3d_gt(str(tmp_path), "noisy", 3)  # frame 2 unannotated
    rec = teval.main(argv + ["--gt", "ho3d", "--ho3d_root", ho3d_root])
    jgt = jgt_ho3d.load_data("noisy", experiment["data_root"], ho3d_root)
    want, _ = jeval.run_evaluation(eval_inputs["jpred"], jgt, icp_iters=1)
    assert set(rec["mean"]) == set(want) | {"timestamp", "seq_name"}
    for k, v in want.items():
        np.testing.assert_allclose(rec["mean"][k], v, rtol=1e-4, atol=1e-4, err_msg=k)
        assert np.isfinite(rec["mean"][k]), k


def test_summarize_metrics_prints_the_jax_table(tmp_path, capsys):
    dirs = []
    for i, cd in enumerate((1.5, 2.5)):
        d = tmp_path / f"e{i}"
        d.mkdir()
        (d / "eval.metric.json").write_text(json.dumps(
            {"cd_icp": cd, "mpjpe_ra_r": 10.0 + i, "seq_name": f"s{i}"}))
        dirs.append(str(d))
    dirs.append(str(tmp_path / "missing"))
    tsumm.main(dirs)
    got = capsys.readouterr().out
    import sys

    argv, sys.argv = sys.argv, ["summarize_metrics"] + dirs
    try:
        jsumm.main()
    finally:
        sys.argv = argv
    assert got == capsys.readouterr().out and "cd_icp" in got
