"""hold_tpu_torch's dataset ground truth against the JAX package's, on the
CPU, on real-format fixtures written here (nothing is downloaded):

- ``eval/gt_ho3d.py``: an HO3D v3 sequence (rgb/ + meta/*.pkl, one frame
  without annotations) processed by ``data/process_ho3d.py``, with and
  without the build's ``corres.txt``; the bus within 1e-5 (float32 MANO on
  both sides), faces and ``is_valid`` equal; ``hand_root_pivot`` and
  ``cv2gl_mano`` within 1e-6;
- ``eval/gt_arctic.py``: ``arctic_object_forward`` within 1e-6 and
  ``load_data`` on a ``data/process_arctic.py`` archive of both hands within
  1e-5;
- ``eval/arctic.py``: ``extract_preds``' archive equal, ``evaluate_arctic``'s
  metrics within 1e-6.

``evaluate --gt ho3d`` runs in tests/test_torch_eval.py, on its experiment.
"""

import os
import os.path as op
import zipfile

import numpy as np
import pytest
import torch
from test_arctic import _fake_pred_gt
from test_real_data_paths import _write_ho3d_sequence

from hold_tpu.data import process_arctic as jprocess_arctic
from hold_tpu.eval import arctic as jarctic
from hold_tpu.eval import gt_arctic as jgt_arctic
from hold_tpu.eval import gt_ho3d as jgt_ho3d
from hold_tpu.mano.server import build_mano_server as jbuild_mano_server
from hold_tpu.utils import transforms as jtransforms
from hold_tpu_torch.data import process_arctic, process_ho3d
from hold_tpu_torch.eval import arctic, gt_arctic, gt_ho3d
from hold_tpu_torch.mano.server import build_mano_server
from hold_tpu_torch.utils import transforms

OBJ = "021_bleach_cleanser"
CUBE_V = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1), (-1, -1, 1), (1, -1, 1), (1, 1, 1),
          (-1, 1, 1)]
CUBE_F = [(1, 2, 3), (1, 3, 4), (5, 7, 6), (5, 8, 7), (1, 5, 6), (1, 6, 2), (2, 6, 7), (2, 7, 3),
          (3, 7, 8), (3, 8, 4), (4, 8, 5), (4, 5, 1)]


def write_object_model(ho3d_root: str, name: str = OBJ) -> None:
    """The scanned object in the YCB layout: a 10 cm cube."""
    mdl_dir = op.join(ho3d_root, "models", name)
    os.makedirs(mdl_dir, exist_ok=True)
    with open(op.join(mdl_dir, "textured_simple.obj"), "w") as f:
        for v in CUBE_V:
            f.write(f"v {0.05 * v[0]} {0.05 * v[1]} {0.05 * v[2]}\n")
        for a, b, c in CUBE_F:
            f.write(f"f {a} {b} {c}\n")


def write_ho3d_gt(root: str, seq_name: str, n_frames: int) -> str:
    """An HO3D v3 sequence (frame 2 unannotated) processed by the port into
    ``<root>/ho3d/processed/<seq_name>.npz``, the object model beside it.
    Returns the HO3D root."""
    seq_dir = _write_ho3d_sequence(root, n_frames)
    ho3d_root = op.join(root, "ho3d")
    process_ho3d.process_sequence(seq_dir, ho3d_root, seq_name, np.zeros(45, np.float32))
    write_object_model(ho3d_root)
    return ho3d_root


def _assert_bus_close(got, want, atol):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "faces":
            assert set(got[k]) == set(v)
            for nid in v:
                np.testing.assert_array_equal(got[k][nid], v[nid], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("corres", [True, False], ids=["corres", "all_frames"])
def test_gt_ho3d_load_data_matches_jax(tmp_path, corres):
    ho3d_root = write_ho3d_gt(str(tmp_path), "ABF10", 5)
    data_root = str(tmp_path / "data")
    build = op.join(data_root, "hold_ABF10_ho3d", "build")
    os.makedirs(build)
    if corres:  # frames 0, 1, 3, 4: the unannotated one left out
        with open(op.join(build, "corres.txt"), "w") as f:
            f.write("".join(f"rgb/{i:04d}.jpg\n" for i in (0, 1, 3, 4)))
    got = gt_ho3d.load_data("hold_ABF10_ho3d", data_root, ho3d_root, device="cpu")
    want = jgt_ho3d.load_data("hold_ABF10_ho3d", data_root, ho3d_root)
    _assert_bus_close(got, want, 1e-5)
    n = 4 if corres else 5
    assert got["v3d_c.right"].shape == (n, 778, 3) and got["v3d_c.object"].shape == (n, 8, 3)
    assert got["is_valid"].tolist() == ([1.0] * 4 if corres else [1.0, 1.0, 0.0, 1.0, 1.0])


def test_hand_root_pivot_and_gl_cv_flip_match_jax():
    rng = np.random.RandomState(2)
    betas = (rng.randn(10) * 0.03).astype(np.float32)
    got = gt_ho3d.hand_root_pivot(build_mano_server(True, betas), betas)
    want = jgt_ho3d.hand_root_pivot(jbuild_mano_server(True, betas), betas)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    aa, t = rng.randn(4, 3) * 0.5, rng.randn(4, 3) * 0.1
    flipped = transforms.cv2gl_mano(aa, t, got)
    for a, b in zip(flipped, jtransforms.cv2gl_mano(aa, t, got)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    back = transforms.cv2gl_mano(flipped[0], flipped[1], got)  # its own inverse
    np.testing.assert_allclose(back[1], t, rtol=0, atol=1e-6)


def test_project2d_and_kabsch_match_jax():
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    K = np.array([[100.0, 0, 40], [0, 110.0, 30], [0, 0, 1]], np.float32)
    pts = (rng.randn(2, 7, 3) * 0.1 + [0, 0, 0.6]).astype(np.float32)
    got = transforms.project2d(torch.as_tensor(K), torch.as_tensor(pts)).numpy()
    want = np.asarray(jtransforms.project2d(jnp.asarray(K), jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    src = rng.randn(20, 3)
    for a, b in zip(transforms.solve_rigid_tf_np(src, src @ np.eye(3)[[1, 2, 0]] + 0.3),
                    jtransforms.solve_rigid_tf_np(src, src @ np.eye(3)[[1, 2, 0]] + 0.3)):
        np.testing.assert_array_equal(a, b)


def _arctic_raw(F=4, seed=0):
    rng = np.random.RandomState(seed)
    mano = {
        "right": {"rot": rng.randn(F, 3) * 0.3, "pose": rng.randn(F, 45) * 0.1,
                  "trans": rng.randn(F, 3) * 0.05, "shape": rng.randn(10) * 0.03},
        "left": {"rot": rng.randn(F, 3) * 0.3, "pose": rng.randn(F, 45) * 0.1,
                 "trans": rng.randn(F, 3) * 0.05, "shape": rng.randn(F, 10) * 0.03},
    }
    obj = np.concatenate([rng.rand(F, 1), rng.randn(F, 3) * 0.4, rng.randn(F, 3) * 50], axis=1)
    w2c = np.tile(np.eye(4), (3, 1, 1))
    for v in range(3):
        c, s = np.cos(0.3 * v), np.sin(0.3 * v)
        w2c[v, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        w2c[v, :3, 3] = [0.01 * v, 0.02, 0.7]
    K = np.tile(np.array([[600.0, 0, 300], [0, 600.0, 200], [0, 0, 1]]), (3, 1, 1))
    top = rng.randn(30, 3) * 40
    bottom = rng.randn(20, 3) * 40
    faces = rng.randint(0, 50, (40, 3))
    return mano, obj, w2c, K, top, bottom, faces


def test_arctic_object_forward_matches_jax():
    rng = np.random.RandomState(1)
    args = (rng.randn(30, 3), rng.randn(20, 3), rng.rand(5) * 3, rng.randn(5, 3) * 0.5,
            rng.randn(5, 3))
    np.testing.assert_allclose(gt_arctic.arctic_object_forward(*args),
                               jgt_arctic.arctic_object_forward(*args), rtol=0, atol=1e-6)


def test_process_arctic_and_gt_arctic_match_jax(tmp_path):
    mano, obj, w2c, K, top, bottom, faces = _arctic_raw()
    ours = process_arctic.process_sequence(mano, obj, w2c, K, 1, top, bottom, faces, 7,
                                           str(tmp_path / "port"), "s01_box")
    theirs = jprocess_arctic.process_sequence(mano, obj, w2c, K, 1, top, bottom, faces, 7,
                                              str(tmp_path / "jax"), "s01_box")
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    got = gt_arctic.load_data("s01_box", str(tmp_path / "port"), device="cpu")
    want = jgt_arctic.load_data("s01_box", str(tmp_path / "jax"))
    _assert_bus_close(got, want, 1e-5)
    assert {"v3d_left.object", "v3d_right.object", "j3d_ra.left"} <= set(got)


def test_process_arctic_cli_matches_jax(tmp_path, monkeypatch, capsys):
    import sys

    mano, obj, w2c, K, top, bottom, faces = _arctic_raw(F=3, seed=4)
    np.save(tmp_path / "s02.mano.npy", mano, allow_pickle=True)
    np.save(tmp_path / "s02.object.npy", obj)
    np.save(tmp_path / "meta.npy", {"world2cam": w2c, "intris_mat": K, "ioi_offset": 3},
            allow_pickle=True)
    for name, v in (("top", top), ("bottom", bottom)):
        with open(tmp_path / f"{name}.obj", "w") as f:
            f.writelines(f"v {x} {y} {z}\n" for x, y, z in v)
            f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces[:10] % len(v))
    argv = ["--mano", str(tmp_path / "s02.mano.npy"), "--object",
            str(tmp_path / "s02.object.npy"), "--meta", str(tmp_path / "meta.npy"),
            "--obj_template", f"{tmp_path / 'top.obj'},{tmp_path / 'bottom.obj'}"]
    ours = process_arctic.main(argv + ["--out", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["process_arctic"] + argv + ["--out", str(tmp_path / "jax")])
    jprocess_arctic.main()
    a = np.load(ours)
    b = np.load(tmp_path / "jax" / "processed" / "s02.npz")
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["ioi_offset"]) == 3


def test_extract_preds_matches_jax(tmp_path):
    pred, _ = _fake_pred_gt()
    ours = arctic.extract_preds(pred, str(tmp_path / "port"))
    theirs = jarctic.extract_preds(pred, str(tmp_path / "jax"))
    with zipfile.ZipFile(ours) as za, zipfile.ZipFile(theirs) as zb:
        assert za.namelist() == zb.namelist()
    a = np.load(tmp_path / "port" / "s01_box_grab_01.npy", allow_pickle=True).item()
    b = np.load(tmp_path / "jax" / "s01_box_grab_01.npy", allow_pickle=True).item()
    assert list(a) == list(b) and set(a) <= set(arctic.EXTRACTION_KEYS)
    assert len(arctic.EXTRACTION_KEYS) == 19
    for k, v in b.items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(a[k][kk], v[kk])
                assert a[k][kk].dtype == v[kk].dtype
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(a[k], v)
            assert a[k].dtype == v.dtype == np.float16 or v.dtype.kind != "f"
        else:
            assert a[k] == v


def test_evaluate_arctic_matches_jax(tmp_path):
    pred, gt = _fake_pred_gt()
    got = arctic.evaluate_arctic(pred, gt, str(tmp_path / "port"), icp_iters=5)
    want = jarctic.evaluate_arctic(pred, gt, str(tmp_path / "jax"), icp_iters=5)
    assert set(got) == set(want)
    for k, v in want.items():
        if k not in ("timestamp", "seq_name"):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["cd_h"], 0.4899, atol=1e-3)  # 2 mm off in x, y, z
    assert (tmp_path / "port" / "s01_box_grab_01.metric.json").exists()
    assert (tmp_path / "port" / "s01_box_grab_01.metric_all.npy").exists()
