"""hold_tpu_torch data + config against the JAX package.

The port builds the synthetic sequence in memory with its own MANO and a
numpy rasteriser; its entities and cameras must equal the JAX generator's,
its masks must overlap the cv2-drawn ones (IoU >= 0.97 per class), its RQ
camera decomposition must match cv2's, and its default config must equal
the JAX one.
"""

import os

import numpy as np
import pytest

from hold_tpu.data import dataset as jds
from hold_tpu.data.synthetic import generate_sequence as jax_generate
from hold_tpu.utils import config as jcfg
from hold_tpu_torch.data import dataset as tds
from hold_tpu_torch.data.synthetic import generate_sequence as torch_generate
from hold_tpu_torch.utils import config as tcfg

N_FRAMES, HW = 3, (120, 160)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jaxseq") / "toy")
    jax_generate(out, n_frames=N_FRAMES, img_hw=HW)
    jdata = np.load(os.path.join(out, "build", "data.npy"), allow_pickle=True).item()
    tseq = torch_generate(None, n_frames=N_FRAMES, img_hw=HW)
    return out, jdata, tseq


def _assert_tree_close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_close(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-6, atol=1e-7, err_msg=path)


def test_entities_and_cameras_equal_jax(both):
    _, jdata, tseq = both
    _assert_tree_close(tseq["data"]["entities"], jdata["entities"])
    _assert_tree_close(tseq["data"]["cameras"], jdata["cameras"])
    assert tseq["data"]["scene_bounding_sphere"] == jdata["scene_bounding_sphere"]


@pytest.mark.parametrize("segm_id", [50, 150])
def test_masks_overlap_cv2_rasteriser(both, segm_id):
    import cv2

    out, _, tseq = both
    for i in range(N_FRAMES):
        jm = cv2.imread(os.path.join(out, "build", "mask", f"{i:04d}.png"), cv2.IMREAD_GRAYSCALE)
        a, b = jm == segm_id, tseq["masks"][i] == segm_id
        iou = (a & b).sum() / max((a | b).sum(), 1)
        assert a.sum() > 50 and iou >= 0.97, (i, segm_id, iou)


def test_images_close_to_cv2_rasteriser(both):
    import cv2

    out, _, tseq = both
    for i in range(N_FRAMES):
        ji = cv2.imread(os.path.join(out, "build", "image", f"{i:04d}.png"))[:, :, ::-1]
        same = np.all(ji == tseq["images"][i], axis=-1).mean()
        assert same >= 0.97, (i, same)


def test_rq_decomposition_matches_cv2(both):
    _, jdata, _ = both
    rng = np.random.RandomState(0)
    mats = [jdata["cameras"][f"world_mat_{i}"][:3, :4] for i in range(N_FRAMES)]
    for _ in range(5):  # random cameras: K upper-triangular, R a rotation
        from scipy.spatial.transform import Rotation

        K = np.array([[rng.uniform(100, 400), rng.uniform(-2, 2), rng.uniform(50, 150)],
                      [0, rng.uniform(100, 400), rng.uniform(50, 150)], [0, 0, 1]])
        R = Rotation.from_rotvec(rng.randn(3)).as_matrix()
        t = rng.randn(3)
        mats.append(rng.uniform(0.5, 2.0) * K @ np.concatenate([R, t[:, None]], 1))
    for P in mats:
        Kj, pose_j = jds.load_K_Rt_from_P(P)
        Kt, pose_t = tds.load_K_Rt_from_P(P)
        np.testing.assert_allclose(Kt, Kj, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pose_t, pose_j, rtol=1e-5, atol=1e-5)


def test_tempo_batches_equal_jax_from_the_same_build(both):
    out, _, _ = both
    root, case = os.path.split(out)
    jseq = jds.SequenceData(case, root, num_sample=32)
    tseq = tds.SequenceData.from_build_dir(case, root, num_sample=32)
    jb = jseq.sample_tempo_batch(np.random.RandomState(3), 2)
    tb = tseq.sample_tempo_batch(np.random.RandomState(3), 2)
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_allclose(np.asarray(tb[k], np.float64), np.asarray(jb[k], np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert tseq.scene_data()["scale"] == jseq.scene_data()["scale"]


def test_default_config_equals_jax():
    assert tcfg.DEFAULT_CONFIG == jcfg.DEFAULT_CONFIG
    assert tcfg.load_config().model.implicit_network.dims == [256] * 8
