"""hold_tpu_torch's camera helpers (utils/camera.py) and debug dumps
(utils/debug.py) against the JAX package's on the CPU, the same numpy
inputs.

- the tensor functions within 1e-5 relative (weak perspective both ways,
  the default camera, ``estimate_translation_k`` batched and weighted,
  ``estimate_translation``), and the translation fit recovering the truth
  within 1e-3 as tests/test_camera.py asks;
- the host functions equal: ``look_at``, ``to_sphere``, the sphere
  sampling from a seeded ``np.random.RandomState``, ``rectify_pose``,
  ``get_coord_maps``;
- ``debug_world2pix``'s PNG, ``debug_deformer``'s OBJ files and
  ``dump_dataset_info``'s snapshot equal to JAX's; ``capture_profile``
  writes a Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

from hold_tpu.utils import camera as jcam
from hold_tpu.utils import debug as jdebug
from hold_tpu_torch.utils import camera as tcam
from hold_tpu_torch.utils import debug as tdebug


def _project(K, pts):
    uvw = pts @ np.asarray(K).T
    return uvw[:, :2] / uvw[:, 2:3]


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(want),
                               rtol=rtol, atol=atol)


def test_weak_perspective_matches_jax():
    rng = np.random.RandomState(0)
    cam_t = rng.randn(6, 3).astype(np.float32)
    cam_t[:, 2] = np.abs(cam_t[:, 2]) + 0.5
    weak = tcam.perspective_to_weak_perspective(cam_t, 500.0, 224)
    _close(weak, jcam.perspective_to_weak_perspective(cam_t, 500.0, 224))
    _close(tcam.weak_perspective_to_perspective(weak, 500.0, 224),
           jcam.weak_perspective_to_perspective(weak.numpy(), 500.0, 224))
    _close(tcam.weak_perspective_to_perspective(weak, 500.0, 224), cam_t, atol=1e-4)
    _close(tcam.default_cam_t(500.0, 224), jcam.default_cam_t(500.0, 224))


def test_estimate_translation_matches_jax():
    rng = np.random.RandomState(2)
    K = np.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]], np.float32)
    B = 4
    S = rng.randn(B, 21, 3).astype(np.float32) * 0.08
    t_true = np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                       rng.uniform(0.5, 1.0, B)], -1).astype(np.float32)
    uv = np.stack([_project(K, S[i] + t_true[i]) for i in range(B)]).astype(np.float32)
    uv[:, 0] += 500.0  # one joint off, with no confidence
    conf = np.ones((B, 21), np.float32)
    conf[:, 0] = 0.0
    Ks = np.tile(K, (B, 1, 1))
    got = tcam.estimate_translation_k(S, uv, conf, Ks)
    _close(got, jcam.estimate_translation_k(S, uv, conf, Ks), rtol=1e-5, atol=1e-5)
    _close(got, t_true, rtol=0, atol=1e-3)
    # one frame, unbatched, and the focal / centre form
    _close(tcam.estimate_translation_k(S[0], uv[0], conf[0], K),
           jcam.estimate_translation_k(S[0], uv[0], conf[0], K), rtol=1e-5, atol=1e-5)
    f, img = 450.0, 256
    K2 = np.array([[f, 0, img / 2], [0, f, img / 2], [0, 0, 1]], np.float32)
    uv2 = _project(K2, S[1] + t_true[1]).astype(np.float32)
    got = tcam.estimate_translation(S[1], uv2, np.ones(21, np.float32), f, img)
    _close(got, jcam.estimate_translation(S[1], uv2, np.ones(21, np.float32), f, img),
           rtol=1e-5, atol=1e-5)
    _close(got, t_true[1], rtol=0, atol=1e-3)


def test_host_camera_functions_match_jax():
    for eye, at, up in (([1.0, 2.0, 3.0], None, None), ([[0.3, -1, 2], [1, 1, 1]],
                                                        [0.1, 0, 0], [0, 1, 0])):
        np.testing.assert_array_equal(tcam.look_at(eye, at, up), jcam.look_at(eye, at, up))
    np.testing.assert_array_equal(tcam.to_sphere(0.3, 0.7), jcam.to_sphere(0.3, 0.7))
    np.testing.assert_array_equal(
        tcam.sample_on_sphere(np.random.RandomState(4), (0.1, 0.5), (0.2, 0.9)),
        jcam.sample_on_sphere(np.random.RandomState(4), (0.1, 0.5), (0.2, 0.9)))
    np.testing.assert_array_equal(
        tcam.sample_pose_on_sphere(np.random.RandomState(0), radius=2.0),
        jcam.sample_pose_on_sphere(np.random.RandomState(0), radius=2.0))
    rng = np.random.RandomState(5)
    R, aa = jcam.look_at(rng.randn(3))[0], rng.randn(3)
    np.testing.assert_array_equal(tcam.rectify_pose(R, aa), jcam.rectify_pose(R, aa))
    np.testing.assert_array_equal(tcam.get_coord_maps(8), jcam.get_coord_maps(8))


class _Seq:
    """The fields of a sequence that dump_dataset_info reads."""

    def __init__(self):
        rng = np.random.RandomState(6)
        self.intrinsics_all = rng.randn(2, 4, 4).astype(np.float32)
        self.extrinsics_all = rng.randn(2, 4, 4).astype(np.float32)
        self.img_paths = ["a/image/0000.png", "a/image/0001.png"]
        self.mask_paths = [None, None]
        self.img_size = (48, 64)
        self.n_frames = 2
        self.scale = 0.25


def test_debug_dumps_match_jax(tmp_path):
    rng = np.random.RandomState(7)
    verts = (rng.randn(300, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32)
    img = rng.rand(48, 64, 3).astype(np.float32)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.01, -0.02, 0.05]
    for side, mod in (("jax", jdebug), ("torch", tdebug)):
        mod.debug_world2pix(str(tmp_path / side), verts, img, K, w2c, "right", 3)
    sd = {"right": {"canonical_pts": rng.randn(2, 40, 3).astype(np.float32),
                    "verts_posed": verts[None]},
          "object": {"canonical_pts": rng.randn(12000, 3).astype(np.float32)}}
    jdebug.debug_deformer(str(tmp_path / "jax"), None, None, sd, 5)
    tdebug.debug_deformer(str(tmp_path / "torch"), None, None,
                          {n: {k: torch.tensor(v) for k, v in s.items()} for n, s in sd.items()},
                          5)
    jdebug.dump_dataset_info(str(tmp_path / "jax"), _Seq())
    tdebug.dump_dataset_info(str(tmp_path / "torch"), _Seq())
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert {"reproj_right_0003.png", "cano_pts_right_5.obj", "posed_verts_right_5.obj",
            "cano_pts_object_5.obj", "dataset_info.npy"} == set(names)
    for n in names:
        a, b = (open(tmp_path / s / n, "rb").read() for s in ("jax", "torch"))
        if n.endswith(".npy"):
            a, b = (np.load(tmp_path / s / n, allow_pickle=True).item() for s in ("jax", "torch"))
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k], object), np.asarray(b[k], object))
        else:
            assert a == b, n


def test_capture_profile_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    d = tdebug.capture_profile(str(tmp_path), lambda a: a @ a, x, steps=2)
    with open(os.path.join(d, "trace.json")) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_sphere_sampling_needs_a_generator():
    with pytest.raises(TypeError):
        tcam.sample_on_sphere()


def test_dump_dataset_info_of_a_sequence_matches_jax(tmp_path):
    """The snapshot of a sequence on disk, read by each package's dataset
    (the cameras decomposed by each: within 1e-5)."""
    from hold_tpu.data.dataset import SequenceData as JSequenceData
    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.data.synthetic import generate_sequence

    generate_sequence(str(tmp_path / "data" / "toy"), 2, (48, 64))
    jdebug.dump_dataset_info(str(tmp_path / "jax"), JSequenceData("toy", str(tmp_path / "data")))
    tdebug.dump_dataset_info(str(tmp_path / "torch"),
                             SequenceData.from_build_dir("toy", str(tmp_path / "data")))
    a, b = (np.load(tmp_path / s / "dataset_info.npy", allow_pickle=True).item()
            for s in ("jax", "torch"))
    assert set(a) == set(b)
    for k in ("img_paths", "mask_paths", "n_frames"):
        assert list(np.atleast_1d(a[k])) == list(np.atleast_1d(b[k])), k
    assert tuple(a["img_size"]) == tuple(b["img_size"])
    for k in ("intrinsics_all", "extrinsics_all", "scale"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-5, err_msg=k)
