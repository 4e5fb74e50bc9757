"""hold_tpu_torch's pose-refinement fitting (fitting/silhouette.py, fit.py,
diagnostics.py) against the JAX package's, float32 on the CPU, the same
numpy inputs on both sides.

- ``render_silhouette`` at 48x64 on the sphere of tests/test_fitting.py at
  the default sigma (1e-6 NDC^2, a ~0.03-pixel band): coverage within 1e-4
  and the gradient with respect to the vertices within 1e-4 of its largest
  element.  Beside each, the port in float64 must pass the same limit
  (forward 2e-5, gradient 3.1e-5 read on this input) and a control must
  fail it: the principal point moved by 1e-3 pixel (forward 1.3e-2,
  gradient 4.8e-2) and sigma by 1 % (3.7e-3, 1.3e-2).  Then the JAX test's
  analytic-disc check on the port.
- ``FittingProblem`` (tests/test_fitting.py's problem: a right hand and a
  sphere, sigma 5e-3, 2 frames; and the same with a left hand):
  ``forward``'s masks within 1e-4 and vertices within 1e-5, both losses'
  terms within 1e-4 relative, ``hard_iou`` within 1e-6.
- ``run_fit`` (one frame at 24x32): 5 iterations against JAX, the loss
  histories within 1e-4 relative and the parameters within 1e-5; the
  guard's decision equal to JAX's on the perfect init (kept out) and on the
  shifted object translation (kept, the error halved in both), each far
  from the 1e-4 margin; the contact deadzone as JAX has it.
- ``FitRecorder``: its panels within 1e-4 of JAX's and the GIF's frames
  equal to JAX's GIF's but for at most 1 % of the pixels (the palette of a
  frame can shift with a value that rounds across a level).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mano import _jax_server

from hold_tpu.data.synthetic import _sphere_mesh
from hold_tpu.fitting import diagnostics as jdiag
from hold_tpu.fitting import fit as jfit
from hold_tpu.fitting.silhouette import render_silhouette as jrender
from hold_tpu.mano.model_data import TIP_VERTEX_IDS
from hold_tpu.models import object_model as jobj
from hold_tpu_torch.fitting import diagnostics as tdiag
from hold_tpu_torch.fitting import fit as tfit
from hold_tpu_torch.fitting.silhouette import render_silhouette as trender
from hold_tpu_torch.mano.server import build_mano_server
from hold_tpu_torch.models import object_model as tobj

IMSIZE = (48, 64)
# the fitting loops at a quarter of the pixels and one frame: the port's
# silhouette runs op by op on the CPU, ~10x the JAX package's fused loop
FIT = {"B": 1, "imsize": (24, 32)}
SIL_TOL = 1e-4  # forward: coverage; gradient: of its largest element


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere_case():
    verts, faces = _sphere_mesh(0.04, 1)
    verts = (verts + np.array([0.01, -0.01, 0.4]))[None].astype(np.float32)
    K = np.array([[80.0, 0, 32], [0, 80.0, 24], [0, 0, 1]])
    w = np.random.RandomState(0).rand(1, *IMSIZE).astype(np.float32)
    return verts, faces, K, w


def _port_silhouette(verts, faces, K, w, dtype=torch.float32, sigma=1e-6):
    v = torch.tensor(verts, dtype=dtype, requires_grad=True)
    alpha = trender(v, faces, torch.tensor(K, dtype=dtype), IMSIZE, sigma=sigma)
    (alpha * torch.tensor(w, dtype=dtype)).sum().backward()
    return alpha.detach().double().numpy(), v.grad.double().numpy()


def test_silhouette_and_its_gradient_match_jax():
    verts, faces, K, w = _sphere_case()
    ref = np.asarray(jrender(jnp.asarray(verts), jnp.asarray(faces),
                             jnp.asarray(K, jnp.float32), IMSIZE))
    ref_g = np.asarray(jax.grad(lambda v: jnp.sum(jrender(
        v, jnp.asarray(faces), jnp.asarray(K, jnp.float32), IMSIZE) * w))(jnp.asarray(verts)))

    def reading(alpha, g):
        return np.abs(alpha - ref).max(), np.abs(g - ref_g).max() / np.abs(ref_g).max()

    got = reading(*_port_silhouette(verts, faces, K, w))
    sound = reading(*_port_silhouette(verts, faces, K, w, torch.float64))
    K_moved = K.copy()
    K_moved[0, 2] += 1e-3
    controls = {"principal point +1e-3 px": reading(*_port_silhouette(verts, faces, K_moved, w)),
                "sigma +1 %": reading(*_port_silhouette(verts, faces, K, w, sigma=1.01e-6))}
    assert max(got) <= SIL_TOL, got
    assert max(sound) <= SIL_TOL, sound
    for name, (f, g) in controls.items():
        assert f > SIL_TOL and g > SIL_TOL, (name, f, g)


def test_silhouette_matches_hard_raster():
    """tests/test_fitting.py's analytic projected disc, on the port."""
    verts, faces, K, _ = _sphere_case()
    alpha = trender(torch.tensor(verts), faces, torch.tensor(K, dtype=torch.float32),
                    IMSIZE)[0].numpy()
    ys, xs = np.mgrid[0:48, 0:64]
    cx = 0.01 / 0.4 * 80 + 32
    cy = -0.01 / 0.4 * 80 + 24
    r = 0.04 / 0.4 * 80
    inside = ((xs + 0.5 - cx) ** 2 + (ys + 0.5 - cy) ** 2) < (r - 1.5) ** 2
    outside = ((xs - cx) ** 2 + (ys - cy) ** 2) > (r + 1.5) ** 2
    assert alpha[inside].min() > 0.9
    assert alpha[outside].max() < 0.1


@pytest.fixture(scope="module")
def servers():
    """Both packages' servers: right and left hands, the object sphere."""
    overts, ofaces = _sphere_mesh(0.5, 1)
    return {
        "jax": {"right": _jax_server(True, np.zeros(10, np.float32)),
                "left": _jax_server(False, np.zeros(10, np.float32)),
                "object": jobj.build_object_server(overts, 0.1, np.eye(4))},
        "torch": {"right": build_mano_server(True, np.zeros(10)),
                  "left": build_mano_server(False, np.zeros(10)),
                  "object": tobj.build_object_server(overts, 0.1, np.eye(4))},
        "faces": ofaces,
    }


def _tables(B, two_hands, obj_offset=(0.0, 0.0, 0.0)):
    t = {
        "right": {"betas": np.zeros((1, 10), np.float32),
                  "global_orient": np.zeros((B, 3), np.float32),
                  "pose": np.zeros((B, 45), np.float32),
                  "transl": np.tile([0.0, 0.0, 0.45], (B, 1)).astype(np.float32)},
        "object": {"global_orient": np.zeros((B, 3), np.float32),
                   # resting just above the fingertips: the contact prior is
                   # near-satisfied at the true pose
                   "transl": (np.tile([0.0, 0.23, 0.45], (B, 1))
                              + np.asarray(obj_offset)).astype(np.float32)},
    }
    if two_hands:
        t["left"] = {"betas": np.zeros((1, 10), np.float32),
                     "global_orient": np.zeros((B, 3), np.float32),
                     "pose": np.zeros((B, 45), np.float32),
                     "transl": np.tile([-0.12, 0.02, 0.5], (B, 1)).astype(np.float32)}
    return t


def _problems(servers, two_hands=False, obj_offset=(0.0, 0.0, 0.0), B=2, imsize=IMSIZE,
              sigma=5e-3):
    """tests/test_fitting.py's problem in both packages (its camera scaled to
    ``imsize``): targets from the JAX package's render at the true pose,
    thresholded; the init's object moved by ``obj_offset``.  Returns
    ({"jax": (problem, params), "torch": ...}, true object translations)."""
    nids = ["right", "left", "object"] if two_hands else ["right", "object"]
    s = imsize[1] / IMSIZE[1]
    K = np.array([[60.0 * s, 0, 32 * s], [0, 60.0 * s, 24 * s], [0, 0, 1]])
    w2c = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    faces = {n: np.asarray(servers["torch"][n].consts.faces) if n != "object"
             else servers["faces"] for n in nids}
    zeros = {n: np.zeros((B, *imsize)) for n in nids}
    common = (w2c, K, 1.0, imsize, TIP_VERTEX_IDS)
    jp = jfit.FittingProblem({n: servers["jax"][n] for n in nids}, faces, zeros, *common,
                             face_chunk=64, sigma=sigma)
    truth = _tables(B, two_hands)
    gt_out = jp.forward(jfit.build_fit_params(truth, nids, 0.1, np.arange(B)))
    targets = {n: np.asarray(gt_out[f"{n}.mask"] > 0.5, np.float32) for n in nids}
    jp.targets = {k: jnp.asarray(v) for k, v in targets.items()}
    tp = tfit.FittingProblem({n: servers["torch"][n] for n in nids}, faces, targets, *common,
                             face_chunk=64, sigma=sigma)
    init = _tables(B, two_hands, obj_offset)
    return ({"jax": (jp, jfit.build_fit_params(init, nids, 0.1, np.arange(B))),
             "torch": (tp, tfit.build_fit_params(init, nids, 0.1, np.arange(B)))},
            truth["object"]["transl"])


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("two_hands", [False, True], ids=["one hand", "two hands"])
def test_fitting_problem_matches_jax(servers, two_hands):
    probs, _ = _problems(servers, two_hands, obj_offset=(0.01, 0.0, 0.0))
    (jp, jparams), (tp, tparams) = probs["jax"], probs["torch"]
    jout, tout = jp.forward(jparams), tp.forward(tparams)
    assert set(tout) == set(jout)
    for k, v in jout.items():
        _close(tout[k].detach(), v, 0, 1e-4 if k.endswith(".mask") else 1e-5, k)
    assert abs(tp.hard_iou(tout) - jp.hard_iou(jout)) <= 1e-6
    if two_hands:
        # 2D anchors half a pixel off the projection, so that the terms pull
        K = np.asarray(jp.K)
        j2d = {}
        for f in ("right", "left"):
            v = np.asarray(jout[f"{f}.v3d_c"])
            j2d[f] = (v[..., :2] / np.maximum(v[..., 2:3], 1e-6) * K[[0, 1], [0, 1]]
                      + K[[0, 1], [2, 2]] + 0.5).astype(np.float32)
        want = jp.loss_two_hands(jout, {f: jnp.asarray(v) for f, v in j2d.items()})
        got = tp.loss_two_hands(tout, {f: torch.tensor(v) for f, v in j2d.items()})
    else:
        want, got = jp.loss_single_hand(jout, "right"), tp.loss_single_hand(tout, "right")
    assert set(got) == set(want)
    for k, v in want.items():
        _close(float(got[k]), float(v), 1e-4, 1e-7, k)
    assert float(want["loss"]) > 0


def test_run_fit_matches_jax(servers):
    probs, _ = _problems(servers, obj_offset=(0.015, 0.0, 0.0), **FIT)
    (jp, jparams), (tp, tparams) = probs["jax"], probs["torch"]
    jfitted, jhist, _, jguard = jfit.run_fit(jp, jparams, True, True, num_iterations=5,
                                             lr0=5e-3)
    tfitted, thist, _, tguard = tfit.run_fit(tp, tparams, True, True, num_iterations=5,
                                             lr0=5e-3)
    _close(thist, jhist, 1e-4, 0, "history")
    for nid in ("right", "object"):
        for k, v in jfitted[nid].items():
            _close(tfitted[nid][k], v, 0, 1e-5, f"{nid}.{k}")
    for k in ("iou_init", "iou_final"):
        _close(tguard[k], jguard[k], 0, 1e-6, k)


# (init offset of the object, image size, learning rate, iterations): the
# true pose at the fitting loops' size; the object 1.5 cm off along x at
# 36x48, where 20 iterations at lr 1e-2 recover it (tests/test_fitting.py
# takes 80 at 5e-3 and 48x64; its first iterations drag both entities along
# the camera ray before the shift is found)
GUARD_CASES = {"perfect init": ((0.0, 0.0, 0.0), FIT["imsize"], 5e-3, 8),
               "shifted object": ((0.015, 0.0, 0.0), (36, 48), 1e-2, 20)}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_decides_as_jax(servers, case):
    """tests/test_fitting.py:89 (the true pose is kept out: its hard IoU
    cannot improve) and :161 (a shifted object is recovered), in both
    packages: the same decision, far from the guard's 1e-4 margin, and the
    port's fit halves the error as JAX's does."""
    offset, imsize, lr, iters = GUARD_CASES[case]
    probs, truth = _problems(servers, obj_offset=offset, B=1, imsize=imsize)
    out = {}
    for side in ("jax", "torch"):
        prob, params = probs[side]
        fit_fn = jfit.run_fit if side == "jax" else tfit.run_fit
        fitted, hist, improved, guard = fit_fn(prob, params, True, True, num_iterations=iters,
                                               lr0=lr, plateau_patience=10)
        err0 = np.abs(np.asarray(params["object"]["transl"]) - truth)[:, 0].max()
        err1 = np.abs(np.asarray(fitted["object"]["transl"]) - truth)[:, 0].max()
        out[side] = (improved, err0, err1, guard)
        assert abs(guard["iou_final"] - guard["iou_init"]) > 1e-2, guard
        if not improved:  # a rejected batch keeps its input exactly
            for nid in ("right", "object"):
                for k, v in params[nid].items():
                    np.testing.assert_array_equal(np.asarray(fitted[nid][k]), np.asarray(v))
    assert out["torch"][0] == out["jax"][0] == (case == "shifted object"), out
    if case == "shifted object":
        assert out["torch"][2] < 0.5 * out["torch"][1], out
        assert out["jax"][2] < 0.5 * out["jax"][1], out


def test_contact_deadzone_matches_jax(servers):
    """The contact deadzone as in JAX (tests/test_fitting.py:190): tips within
    the threshold pull with zero loss, the mask terms unchanged."""
    probs, _ = _problems(servers)
    (jp, jparams), (tp, tparams) = probs["jax"], probs["torch"]
    jout, tout = jp.forward(jparams), tp.forward(tparams)
    ref_j, ref_t = jp.loss_single_hand(jout, "right"), tp.loss_single_hand(tout, "right")
    assert float(ref_t["fine_ho"]) > 0.0
    d2 = tfit._min_dist2(tout["right.v3d_c"][:, tp.contact_idx], tout["object.v3d_c"])
    thres = float(torch.sqrt(d2.max())) * 1.01
    jp.contact_thres = tp.contact_thres = thres
    dz_j, dz_t = jp.loss_single_hand(jout, "right"), tp.loss_single_hand(tout, "right")
    assert float(dz_t["fine_ho"]) == float(dz_j["fine_ho"]) == 0.0
    for k in ("mask_o", "mask_h"):
        _close(float(dz_t[k]), float(ref_t[k]), 1e-6, 0, k)
        _close(float(dz_t[k]), float(dz_j[k]), 1e-4, 0, k)


def test_fit_recorder_matches_jax(servers, tmp_path):
    from PIL import Image

    probs, _ = _problems(servers, obj_offset=(0.01, 0.0, 0.0), **FIT)
    frames = {}
    for side, diag, fit_mod in (("jax", jdiag, jfit), ("torch", tdiag, tfit)):
        prob, params = probs[side]
        rec = diag.FitRecorder(prob, every=3)
        fit_mod.run_fit(prob, params, True, True, num_iterations=7, lr0=5e-3, callback=rec)
        assert len(rec.frames) == 3  # iterations 0, 3, 6
        path = rec.save(str(tmp_path / f"{side}.gif"))
        im = Image.open(path)
        frames[side] = (rec.frames, [np.asarray(im.seek(i) or im.convert("RGB"))
                                     for i in range(im.n_frames)])
    H, W = FIT["imsize"]
    for got, want in zip(frames["torch"][0], frames["jax"][0]):
        assert got.shape == (H, 3 * W, 3) and got.max() > 0.1
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert len(frames["torch"][1]) == len(frames["jax"][1]) == 3
    for got, want in zip(frames["torch"][1], frames["jax"][1]):
        assert np.mean(np.any(got != want, axis=-1)) <= 0.01


def test_seal_mano_verts_matches_jax():
    """The wrist-ring centroid appended: 778 -> 779 vertices, numpy and
    torch, against the JAX package's on a posed hand."""
    from hold_tpu.utils.mesh import seal_mano_verts as jseal
    from hold_tpu_torch.utils.mesh import seal_mano_faces, seal_mano_verts

    v = np.random.RandomState(8).randn(2, 778, 3).astype(np.float32)
    want = np.asarray(jseal(jnp.asarray(v)))
    assert want.shape == (2, 779, 3)
    np.testing.assert_allclose(seal_mano_verts(torch.tensor(v)).numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(seal_mano_verts(v), jseal(v))
    faces = seal_mano_faces(np.zeros((1538, 3), np.int64), True)
    assert faces.shape == (1554, 3) and faces.max() == 778
