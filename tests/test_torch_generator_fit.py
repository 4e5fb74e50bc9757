"""hold_tpu_torch's generator fitting loops (generator/register_mano.py,
generator/align.py, fitting/diagnostics.alignment_preview) against the JAX
package's, float32 on the CPU, the same numpy inputs.

- ``fit_mano_to_verts`` on tests/test_generator.py's 3-frame hand sequence
  (20 coarse + 20 fine Adam steps at lr 2e-2): poses, betas, translations
  and per-frame errors within 1e-4 (40 smooth Adam steps, no thresholds);
- ``mark_outliers`` equal, ``slerp_infill`` within 1e-6;
- ``AlignmentProblem``: the loss in modes h, o and ho within 1e-5
  relative, every gradient within 1e-4 of its largest element; the
  trainability labels equal; a short ``fit`` in each mode (the scale
  unlocking in o) with its loss history within 1e-4 relative and the
  parameters within 1e-4; every iteration's learning rate equal to JAX's
  (halving at iteration 1,000, restarting in each phase);
- ``alignment_preview``: the same image but for at most 1 % of its pixels
  (a marker's position is truncated to a whole pixel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hold_tpu.fitting import diagnostics as jdiag
from hold_tpu.generator import align as jalign
from hold_tpu.generator import register_mano as jreg
from hold_tpu.mano.lbs import lbs_forward, mano_full_pose
from hold_tpu.mano.server import build_mano_server
from hold_tpu_torch.fitting import diagnostics as tdiag
from hold_tpu_torch.generator import align as talign
from hold_tpu_torch.generator import register_mano as treg

F = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hand_sequence():
    """tests/test_generator.py::_gt_hand_sequence (3 frames), with the JAX
    package's LBS compiled once."""
    rng = np.random.RandomState(0)
    srv = build_mano_server(True, np.zeros(10))
    poses = np.zeros((F, 48), np.float32)
    poses[:, 0] = 0.3 * rng.randn(F)
    transl = np.array([[0.02, 0.01, 0.0]] * F, np.float32)
    out = jax.jit(lambda p: lbs_forward(srv.consts, jnp.zeros((F, 10)),
                                        mano_full_pose(srv.consts, p[:, :3], p[:, 3:])))(poses)
    return {"poses": poses, "transl": transl,
            "verts": np.asarray(out.vertices) + transl[:, None],
            "joints": np.asarray(out.joints) + transl[:, None]}


def test_fit_mano_to_verts_matches_jax(hand_sequence):
    noisy = hand_sequence["verts"] + 0.002 * np.random.RandomState(1).randn(
        *hand_sequence["verts"].shape).astype(np.float32)
    kw = dict(coarse_iters=20, fine_iters=20, lr=2e-2)
    got = treg.fit_mano_to_verts(noisy, True, **kw)
    want = jreg.fit_mano_to_verts(noisy, True, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-4, err_msg=k)
    assert got["vert_err"].mean() < 0.5 * np.linalg.norm(
        noisy - noisy.mean(1, keepdims=True), axis=-1).mean()


def test_outliers_and_slerp_infill_match_jax():
    err = np.array([0.001, 0.001, 0.5, 0.001, 0.002, 0.3])
    np.testing.assert_array_equal(treg.mark_outliers(err), jreg.mark_outliers(err))
    rng = np.random.RandomState(2)
    poses = (0.4 * rng.randn(6, 48)).astype(np.float32)
    transl = rng.randn(6, 3).astype(np.float32)
    for bad in (jreg.mark_outliers(err), np.array([1, 0, 0, 1, 0, 1], bool),
                np.zeros(6, bool)):
        got = treg.slerp_infill(poses, transl, bad)
        want = jreg.slerp_infill(poses, transl, bad)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
    # the JAX test's case: frame 2 between 0.1 and 0.3
    p = np.zeros((5, 48), np.float32)
    p[:, 0] = [0.0, 0.1, 99.0, 0.3, 0.4]
    t = np.tile(np.arange(5)[:, None], (1, 3)).astype(np.float32)
    p2, t2 = treg.slerp_infill(p, t, np.array([0, 0, 1, 0, 0], bool))
    np.testing.assert_allclose(t2[2], [2.0, 2.0, 2.0], atol=1e-5)
    assert abs(p2[2, 0] - 0.2) < 0.02


@pytest.fixture(scope="module")
def problems(hand_sequence):
    """Both packages' AlignmentProblem: the hand's joints pushed 0.5 forward
    and projected, 30 canonical object points and their projections at a
    known pose; parameters off the truth."""
    rng = np.random.RandomState(3)
    K = np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]], np.float32)
    j2d = np.asarray(jalign.project(jnp.asarray(K), jnp.asarray(
        hand_sequence["joints"] + np.array([0, 0, 0.5], np.float32))))
    pts_cano = (0.03 * rng.randn(30, 3)).astype(np.float32)
    obj_2d = np.asarray(jalign.project(jnp.asarray(K), jnp.asarray(
        pts_cano[None] + np.array([0.02, 0.0, 0.55], np.float32))))
    obj_2d = np.broadcast_to(obj_2d, (F, 30, 2)).copy()
    args = ({"right": j2d}, obj_2d, pts_cano, K)
    jp = jalign.AlignmentProblem(*args, hands=("right",))
    tp = talign.AlignmentProblem(*args, hands=("right",))
    init = {"right": {"global_orient": hand_sequence["poses"][:, :3] + 0.05,
                      "pose": hand_sequence["poses"][:, 3:],
                      "transl": (0.01 * rng.randn(F, 3) + [0, 0, 0.45]).astype(np.float32),
                      "betas": (0.1 * rng.randn(10)).astype(np.float32)},
            "object": {"global_orient": (0.1 * rng.randn(F, 3)).astype(np.float32),
                       "transl": np.tile([0.0, 0.0, 0.5], (F, 1)).astype(np.float32)},
            "obj_scale_log": np.float32(0.1)}
    return {"jax": (jp, jp.init_params(F, init)), "torch": (tp, tp.init_params(F, init)),
            "K": K}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree.detach() if torch.is_tensor(tree) else tree)}


def _requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_tensors(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("mode", ["h", "o", "ho"])
def test_alignment_loss_and_gradients_match_jax(problems, mode):
    (jp, jparams), (tp, tparams) = problems["jax"], problems["torch"]
    for unlocked in (False, True):
        want, jg = jax.value_and_grad(lambda p: jp.loss(p, mode, unlocked))(jparams)
        leaves = _requiring_grad(tparams)
        got = tp.loss(leaves, mode, unlocked)
        flat = _flat_tensors(leaves)
        grads = torch.autograd.grad(got, list(flat.values()), allow_unused=True)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        jflat = _flat(jg)
        for (k, x), g in zip(flat.items(), grads):
            g = np.zeros(x.shape, np.float32) if g is None else g.numpy()
            scale = max(float(np.abs(jflat[k]).max()), 1e-12)
            assert np.abs(g - jflat[k]).max() <= 1e-4 * scale, (mode, k)
        assert tp.trainable(mode, unlocked)(tparams, ()) == jp.trainable(mode, unlocked)(
            jparams, ())


def test_alignment_fit_matches_jax(problems):
    """h, then o with the scale unlocking at 4 of 8, then ho: histories and
    parameters, each mode from the last one's result."""
    (jp, jparams), (tp, tparams) = problems["jax"], problems["torch"]
    for mode, kw in (("h", dict(iters=8, lr=2e-2)),
                     ("o", dict(iters=8, lr=2e-2, scale_unlock_at=4)),
                     ("ho", dict(iters=4, lr=5e-3))):
        jparams = jp.fit(jparams, mode, **kw)
        tparams = tp.fit(tparams, mode, **kw)
        np.testing.assert_allclose(tp.history, jp.history, rtol=1e-4, err_msg=mode)
        jflat, tflat = _flat(jparams), _flat(tparams)
        for k, v in jflat.items():
            np.testing.assert_allclose(tflat[k], v, rtol=0, atol=1e-4, err_msg=f"{mode} {k}")
    assert tflat["obj_scale_log"] != np.float32(0.1)  # the scale unlocked in o


def test_alignment_lr_schedule_matches_jax(problems, monkeypatch):
    """The learning rate of every iteration of a fit whose second phase
    (the scale unlocked at 998 of 1,003) crosses iteration 1,000, in both
    packages, the loss replaced by a free one: halved at 1,000, restarting
    at lr in each phase."""
    (jp, jparams), (tp, tparams) = problems["jax"], problems["torch"]
    seen = {"jax": [], "torch": []}
    real_step = torch.optim.Adam.step
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: (
        seen["torch"].append(self.param_groups[0]["lr"]), real_step(self, *a, **k))[1])
    monkeypatch.setattr(tp, "loss", lambda p, mode, unlocked: p["right"]["transl"].sum() * 0)

    class Jit:  # jax.jit, recording the learning rate each step is given
        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, fn):
            jitted = jax.jit(fn)

            def call(p, adam_state, mask_state, lr_):
                seen["jax"].append(float(lr_))
                return jitted(p, adam_state, mask_state, lr_)
            return call

    monkeypatch.setattr(jalign, "jax", Jit())
    monkeypatch.setattr(jp, "loss", lambda p, mode, unlocked: jnp.sum(p["right"]["transl"]) * 0)
    kw = dict(iters=1003, lr=1e-2, scale_unlock_at=998)
    jp.fit(jparams, "h", **kw)
    tp.fit(tparams, "h", **kw)
    # JAX hands the step the rate as a float32 array
    assert [float(np.float32(x)) for x in seen["torch"]] == seen["jax"]
    assert len(seen["torch"]) == 1003
    assert seen["torch"][997] == seen["torch"][998] == 1e-2 and seen["torch"][1002] == 5e-3


def test_alignment_preview_matches_jax(problems):
    (jp, jparams), (tp, tparams) = problems["jax"], problems["torch"]
    got = tdiag.alignment_preview(tp, tparams, max_frames=2)
    want = jdiag.alignment_preview(jp, jparams, max_frames=2)
    assert got.shape == want.shape == (60, 80 * 2, 3)
    assert np.isfinite(got).all()
    assert np.mean(np.any(np.abs(got - want) > 1e-6, axis=-1)) <= 0.01
