"""hold_tpu_torch's viewing tools (render/html_viewer.py, visualize_ckpt.py)
against the JAX package's on the CPU.

- ``pack_scene`` equals JAX's key by key on the same inputs, and
  ``export_html_viewer`` writes the same bytes under the same title;
- ``overlay_mesh`` paints the same image on the same inputs;
- ``visualize_ckpt`` on the experiment of tests/test_torch_eval.py (3
  frames at 48x64, the port's and JAX's checkpoints of the same parameters)
  against the JAX CLI: the same PNG names, each frame's pixels equal but for
  at most 2 % of them (the posed vertices agree to ~1e-6, and ``fillPoly``
  rounds a triangle's corners to whole pixels, so an edge can move by one
  pixel), a non-empty ``overlay.mp4``, and a ``viewer.html`` whose scene
  blob has JAX's keys, frames, faces and billboards and vertices within
  1e-5;
- the CLI runs on the card by default: without one it raises
  ``resolve_device``'s error.
"""

import base64
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from test_torch_eval import experiment  # noqa: F401 (the fixture)

from hold_tpu import visualize_ckpt as jvis
from hold_tpu.render import html_viewer as jhtml
from hold_tpu_torch import visualize_ckpt as tvis
from hold_tpu_torch.render import html_viewer as thtml

PIXEL_SHARE = 0.02


def _tiny_scene(F=5, V=12, T=16):
    """tests/test_html_viewer.py's scene, with two nodes and varied frames."""
    rng = np.random.RandomState(0)
    verts = rng.randn(F, V, 3).astype(np.float32) * 0.1
    faces = rng.randint(0, V, (T, 3)).astype(np.int64)
    w2c = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    w2c[:, 2, 3] = 0.6
    K = np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]])
    imgs = [rng.randint(0, 255, (60, 80, 3)).astype(np.uint8) for _ in range(F)]
    return {"right": (verts, faces), "object": (verts[:, ::-1] * 2, faces[:8])}, w2c, K, imgs


@pytest.mark.parametrize("max_frames", [120, 3])
def test_pack_scene_and_html_match_jax(tmp_path, max_frames):
    meshes, w2c, K, imgs = _tiny_scene()
    got = thtml.pack_scene(meshes, w2c, K, (60, 80), images=imgs, max_frames=max_frames)
    want = jhtml.pack_scene(meshes, w2c, K, (60, 80), images=imgs, max_frames=max_frames)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == v, k
    p_t = thtml.export_html_viewer(str(tmp_path / "t.html"), got, title="scene")
    p_j = jhtml.export_html_viewer(str(tmp_path / "j.html"), want, title="scene")
    assert open(p_t, "rb").read() == open(p_j, "rb").read()


def test_overlay_mesh_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (60, 80, 3)).astype(np.uint8)
    verts = (rng.randn(40, 3) * 0.05 + np.array([0, 0, 0.5])).astype(np.float32)
    verts[0, 2] = -0.1  # a face behind the camera is skipped
    faces = rng.randint(0, 40, (70, 3))
    K = np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]])
    got = tvis.overlay_mesh(img, verts, faces, K, (255, 180, 140))
    want = jvis.overlay_mesh(img, verts, faces, K, (255, 180, 140))
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()


def _blob(path):
    html = open(path).read()
    return json.loads(re.search(r"const SCENE = (\{.*?\});\n", html, re.S).group(1))


@pytest.fixture(scope="module")
def viewers(experiment, tmp_path_factory):  # noqa: F811
    """Both CLIs' outputs on the experiment's newest checkpoint."""
    import cv2

    from hold_tpu.utils import compile_cache

    root = tmp_path_factory.mktemp("viewer")
    common = ["--exp", experiment["exp"], "--case", "noisy", "--data_root",
              experiment["data_root"]]
    mp = pytest.MonkeyPatch()
    mp.setattr(compile_cache, "enable_compile_cache", lambda: None)
    mp.setattr(sys, "argv", ["visualize_ckpt"] + common + ["--out", str(root / "jax")])
    jvis.main()
    mp.undo()
    tvis.main(common + ["--out", str(root / "torch"), "--device", "cpu"])
    out = {}
    for side in ("jax", "torch"):
        d = root / side
        pngs = sorted(p for p in os.listdir(d) if p.endswith(".png"))
        out[side] = {"dir": d, "pngs": pngs,
                     "images": [cv2.imread(str(d / p)) for p in pngs],
                     "blob": _blob(d / "viewer.html")}
    return out


def test_visualize_ckpt_frames_match_jax(viewers):
    got, want = viewers["torch"], viewers["jax"]
    assert got["pngs"] == want["pngs"] == ["0000.png", "0001.png", "0002.png"]
    for name, a, b in zip(got["pngs"], got["images"], want["images"]):
        share = float(np.mean(np.any(a != b, axis=-1)))
        assert share <= PIXEL_SHARE, (name, share)
    src = viewers["torch"]["images"][0]
    assert os.path.getsize(got["dir"] / "overlay.mp4") > 0
    assert src.shape == (48, 64, 3)


def test_visualize_ckpt_viewer_matches_jax(viewers):
    got, want = viewers["torch"]["blob"], viewers["jax"]["blob"]
    assert list(got) == list(want)
    for k in ("n_frames", "frame_ids", "K", "img_hw", "billboards", "w2c_b64"):
        assert got[k] == want[k], k
    assert [n["id"] for n in got["nodes"]] == [n["id"] for n in want["nodes"]]
    for g, w in zip(got["nodes"], want["nodes"]):
        for k in ("color", "n_verts", "n_faces", "faces_b64"):
            assert g[k] == w[k], (g["id"], k)
        gv, wv = (np.frombuffer(base64.b64decode(n["verts_b64"]), np.float32)
                  for n in (g, w))
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5, err_msg=g["id"])


def test_cli_needs_the_card_unless_asked(experiment):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.main(["--exp", experiment["exp"], "--case", "noisy", "--data_root",
                   experiment["data_root"]])
