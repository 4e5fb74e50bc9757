"""hold_tpu_torch's real-data tooling against the JAX package's, on the CPU,
on fixtures written here:

- ``data/process_ho3d.py`` on an HO3D v3 layout (one frame unannotated): the
  npz equal but for the object's rotation matrices (torch against jnp
  Rodrigues, within 1e-6); its CLI;
- ``data/crop_videos.py`` on a tiny MJPG ``.avi`` written by cv2, to a box and
  to the masks' union: the box, the frame count and every decoded frame
  equal;
- ``generator/build_dataset.py``: ``camera_normalization``,
  ``entities_from_fits``, ``build_from_arrays`` (data.npy, images, masks and
  corres.txt equal), ``init_dataset_from_video`` and ``merge_entity_masks``
  equal; the build read by both packages' SequenceData (cameras within
  1e-9), and 2 training steps of the port on it with finite losses.
"""

import json
import os
import os.path as op
import sys

import cv2
import numpy as np
import pytest
import torch
from test_real_data_paths import _write_ho3d_sequence

from hold_tpu.data import crop_videos as jcrop
from hold_tpu.data import process_ho3d as jprocess_ho3d
from hold_tpu.data.dataset import SequenceData as JSequenceData
from hold_tpu.generator import build_dataset as jbuild
from hold_tpu_torch.data import crop_videos, process_ho3d
from hold_tpu_torch.data.dataset import SequenceData, load_K_Rt_from_P
from hold_tpu_torch.generator import build_dataset


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_process_ho3d_matches_jax(tmp_path):
    seq_dir = _write_ho3d_sequence(str(tmp_path), 5)
    hands_mean = (np.random.RandomState(0).randn(45) * 0.1).astype(np.float32)
    a = np.load(process_ho3d.process_sequence(seq_dir, str(tmp_path / "port"), "ABF10",
                                              hands_mean))
    b = np.load(jprocess_ho3d.process_sequence(seq_dir, str(tmp_path / "jax"), "ABF10",
                                               hands_mean))
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype, k
        if k == "obj_rot":
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["is_valid"].tolist() == [1.0, 1.0, 0.0, 1.0, 1.0]
    np.testing.assert_array_equal(a["hand_pose"][2], a["hand_pose"][1])  # nearest, earlier


def test_process_ho3d_cli(tmp_path, capsys):
    _write_ho3d_sequence(str(tmp_path), 3)
    out = process_ho3d.main(["--ho3d_root", str(tmp_path), "--seq", "ABF10", "--out",
                             str(tmp_path / "assets")])
    assert out == str(tmp_path / "assets" / "processed" / "ABF10.npz")
    assert "wrote" in capsys.readouterr().out
    assert np.load(out)["hand_pose"].shape == (3, 48)


def _write_video(path, n=6, hw=(36, 48)):
    rng = np.random.RandomState(3)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, hw[::-1])
    for _ in range(n):
        w.write(rng.randint(0, 255, hw + (3,), dtype=np.uint8))
    w.release()


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


@pytest.mark.parametrize("source", ["box", "masks"])
def test_crop_video_matches_jax(tmp_path, source):
    video = tmp_path / "in.avi"
    _write_video(video)
    kw = {"box": (-4, 5, 30, 60)}
    if source == "masks":
        mask_dir = tmp_path / "masks"
        mask_dir.mkdir()
        for i, (y, x) in enumerate(((10, 12), (20, 30))):
            m = np.zeros((36, 48), np.uint8)
            m[y:y + 4, x:x + 5] = 255
            cv2.imwrite(str(mask_dir / f"{i:04d}.png"), m)
        kw = {"mask_dir": str(mask_dir), "margin": 3}
    got = crop_videos.crop_video(str(video), str(tmp_path / "port.mp4"), **kw)
    want = jcrop.crop_video(str(video), str(tmp_path / "jax.mp4"), **kw)
    assert got == want and got[1] == 6
    a, b = _frames(tmp_path / "port.mp4"), _frames(tmp_path / "jax.mp4")
    assert len(a) == len(b) == 6
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)
    if source == "masks":
        assert got[0] == (12 - 3, 10 - 3, 34 + 3, 23 + 3)


def test_crop_videos_cli(tmp_path, capsys):
    video = tmp_path / "in.avi"
    _write_video(video, n=3)
    box, n = crop_videos.main(["--video", str(video), "--out", str(tmp_path / "o.mp4"),
                               "--box", "0", "0", "20", "10"])
    assert (box, n) == ([0, 0, 20, 10], 3)
    assert _frames(tmp_path / "o.mp4")[0].shape == (10, 20, 3)


def _fits(F, rng):
    return {"right": {"poses": (rng.randn(F, 48) * 0.1).astype(np.float32),
                      "betas": (rng.randn(10) * 0.03).astype(np.float32),
                      "transl": (rng.randn(F, 3) * 0.02).astype(np.float32)}}


@pytest.fixture(scope="module")
def build_inputs(tmp_path_factory):
    """Frames and masks from the synthetic sequence, its cameras and its
    entities as fits."""
    from hold_tpu_torch.data.synthetic import generate_sequence

    root = tmp_path_factory.mktemp("build")
    built = generate_sequence(str(root / "src"), n_frames=3, img_hw=(48, 64))
    seq = SequenceData.from_build_dir("src", str(root), num_sample=8)
    cams = built["data"]["cameras"]  # world_mat = K @ w2c, unscaled
    Ks, w2c = zip(*[(K, np.linalg.inv(c2w)) for K, c2w in (
        load_K_Rt_from_P(cams[f"world_mat_{i}"][:3, :4]) for i in range(seq.n_frames))])
    K = Ks[0][:3, :3]
    ent = built["data"]["entities"]
    fits = {"right": {"poses": ent["right"]["hand_poses"], "betas": ent["right"]["mean_shape"],
                      "transl": ent["right"]["hand_trans"]}}
    return {"root": root, "images": seq.img_paths, "masks": seq.mask_paths, "K": K,
            "w2c": np.stack(w2c), "fits": fits, "obj": ent["object"]}


def test_camera_normalization_and_entities_match_jax():
    rng = np.random.RandomState(0)
    w2c = np.tile(np.eye(4), (4, 1, 1))
    w2c[:, :3, 3] = rng.randn(4, 3)
    for a, b in zip(build_dataset.camera_normalization(w2c, 2.5),
                    jbuild.camera_normalization(w2c, 2.5)):
        np.testing.assert_array_equal(a, b)
    args = (_fits(4, rng), rng.randn(4, 6), rng.randn(30, 3), 0.7)
    a, b = build_dataset.entities_from_fits(*args), jbuild.entities_from_fits(*args)
    assert a.keys() == b.keys()
    for nid in b:
        assert a[nid].keys() == b[nid].keys()
        for k in b[nid]:
            np.testing.assert_array_equal(a[nid][k], b[nid][k])
            assert np.asarray(a[nid][k]).dtype == np.asarray(b[nid][k]).dtype


def test_build_from_arrays_matches_jax_and_trains(build_inputs, tmp_path):
    bi = build_inputs
    ent = build_dataset.entities_from_fits(
        bi["fits"], bi["obj"]["object_poses"], bi["obj"]["pts.cano"], bi["obj"]["obj_scale"],
        bi["obj"].get("norm_mat"))
    out = {}
    for name, mod in (("port", build_dataset), ("jax", jbuild)):
        out[name] = mod.build_from_arrays(str(tmp_path / name), bi["images"], bi["masks"],
                                          bi["K"], bi["w2c"], ent)
    a = np.load(op.join(out["port"], "data.npy"), allow_pickle=True).item()
    b = np.load(op.join(out["jax"], "data.npy"), allow_pickle=True).item()
    assert a.keys() == b.keys() and a["cameras"].keys() == b["cameras"].keys()
    for k, v in b["cameras"].items():
        np.testing.assert_array_equal(a["cameras"][k], v)
    assert a["scene_bounding_sphere"] == b["scene_bounding_sphere"]
    np.testing.assert_array_equal(a["normalize_shift"], b["normalize_shift"])
    for sub in ("image", "mask"):
        assert sorted(os.listdir(op.join(out["port"], sub))) == \
            sorted(os.listdir(op.join(out["jax"], sub)))
    with open(op.join(out["port"], "corres.txt")) as f, \
            open(op.join(out["jax"], "corres.txt")) as g:
        assert f.read() == g.read()

    seq = SequenceData.from_build_dir("port", str(tmp_path), num_sample=8)
    jseq = JSequenceData("jax", str(tmp_path))
    assert seq.n_frames == jseq.n_frames == 3
    np.testing.assert_allclose(seq.intrinsics_all, jseq.intrinsics_all, rtol=0, atol=1e-9)
    np.testing.assert_allclose(seq.extrinsics_all, jseq.extrinsics_all, rtol=0, atol=1e-9)
    np.testing.assert_allclose(seq.intrinsics_all[0][:3, :3], bi["K"], rtol=1e-6, atol=1e-6)
    centers = np.linalg.norm(seq.extrinsics_all[:, :3, 3], axis=1)
    assert centers.max() <= seq.scene_bounding_sphere

    from test_torch_distributed import _args, _cfg

    from hold_tpu_torch.train import run_training

    run = run_training(_args(tmp_path / "logs", "built", total_step=2), _cfg(), seq=seq,
                       device="cpu")
    with open(op.join(run[3].log_dir, "metrics.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "loss" in r]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(v) for r in recs for k, v in r.items() if k.startswith("loss"))


def test_init_dataset_from_video_matches_jax(tmp_path):
    video = tmp_path / "in.avi"
    _write_video(video, n=7)
    a = build_dataset.init_dataset_from_video(str(video), str(tmp_path / "port"), 2, 3)
    b = jbuild.init_dataset_from_video(str(video), str(tmp_path / "jax"), 2, 3)
    assert [op.basename(p) for p in a] == [op.basename(p) for p in b] == \
        ["0000.png", "0001.png", "0002.png"]
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(cv2.imread(pa), cv2.imread(pb))


def test_merge_entity_masks_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    dirs = {}
    for nid in ("object", "right"):
        d = tmp_path / nid
        d.mkdir()
        dirs[nid] = str(d)
        for i in range(2):
            cv2.imwrite(str(d / f"{i:04d}.png"), (rng.rand(12, 16) > 0.6).astype(np.uint8) * 255)
    a = build_dataset.merge_entity_masks(dirs, str(tmp_path / "port"))
    b = jbuild.merge_entity_masks(dirs, str(tmp_path / "jax"))
    assert [op.basename(p) for p in a] == [op.basename(p) for p in b]
    for pa, pb in zip(a, b):
        ma, mb = cv2.imread(pa, cv2.IMREAD_GRAYSCALE), cv2.imread(pb, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(ma, mb)
        assert set(np.unique(ma)) <= {0, 50, 150}


def test_build_dataset_cli(tmp_path, capsys):
    rng = np.random.RandomState(8)
    video = tmp_path / "in.avi"
    _write_video(video, n=3)
    (tmp_path / "m" / "right").mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(tmp_path / "m" / "right" / f"{i:04d}.png"),
                    (rng.rand(36, 48) > 0.5).astype(np.uint8) * 255)
    w2c = np.tile(np.eye(4), (3, 1, 1))
    w2c[:, 2, 3] = 0.5
    fits = _fits(3, rng)["right"]
    np.savez(tmp_path / "fits.npz", K=np.array([[50.0, 0, 24], [0, 50.0, 18], [0, 0, 1]]),
             w2c=w2c, obj_poses=np.zeros((3, 6)), pts_cano=rng.randn(20, 3), obj_scale=0.1,
             right_poses=fits["poses"], right_betas=fits["betas"], right_transl=fits["transl"])
    build = build_dataset.main(["--video", str(video), "--out", str(tmp_path / "seq"),
                                "--fits", str(tmp_path / "fits.npz"), "--mask_dir",
                                str(tmp_path / "m")])
    seq = SequenceData.from_build_dir("seq", str(tmp_path))
    assert build.endswith(op.join("seq", "build")) and seq.n_frames == 3
    assert set(np.unique(seq.masks)) <= {0, 150}
    assert seq.hand_ids == ["right"]


NEW_MODULES = ("hold_tpu_torch.data.process_ho3d", "hold_tpu_torch.data.process_arctic",
               "hold_tpu_torch.data.crop_videos", "hold_tpu_torch.generator.build_dataset",
               "hold_tpu_torch.eval.gt_ho3d", "hold_tpu_torch.eval.gt_arctic",
               "hold_tpu_torch.eval.arctic", "hold_tpu_torch.parallel.sharding",
               "hold_tpu_torch.utils.remote")


def test_real_data_and_parallel_modules_import_no_jax():
    """The modules added for real data, several processes and the remote
    sink load neither JAX nor the JAX package; and no file of the port, nor
    chip_smoke.py, imports either anywhere, inside a function included."""
    import re
    import subprocess

    repo = op.dirname(op.dirname(op.abspath(__file__)))
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {NEW_MODULES!r}]; "
            "bad = [m for m in sys.modules if m in ('jax', 'optax', 'orbax') or m == 'hold_tpu' "
            "or m.startswith(('hold_tpu.', 'jax.'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120)
    pattern = re.compile(r"^\s*(from|import)\s+(jax|hold_tpu)\b", re.M)
    files = [op.join(d, f) for d, _, fs in os.walk(op.join(repo, "hold_tpu_torch"))
             for f in fs if f.endswith(".py")] + [op.join(repo, "chip_smoke.py")]
    found = [p for p in files if pattern.search(open(p).read())]
    assert not found, found
