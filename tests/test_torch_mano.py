"""hold_tpu_torch geometry (MANO LBS, servers, rotations, transforms)
against the JAX package, float32 on the CPU, inputs from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hold_tpu.mano import lbs as jlbs
from hold_tpu.mano import server as jsrv
from hold_tpu.mano.model_data import load_mano
from hold_tpu.models import object_model as jobj
from hold_tpu.utils import rot as jrot
from hold_tpu.utils import transforms as jtf
from hold_tpu_torch.mano import lbs as tlbs
from hold_tpu_torch.mano import server as tsrv
from hold_tpu_torch.models import object_model as tobj
from hold_tpu_torch.utils import rot as trot
from hold_tpu_torch.utils import transforms as ttf

ATOL = 1e-5  # fp32 chains of a few 4x4 products at unit scale


def _t(x):
    return torch.tensor(np.asarray(x))


def _jax_server(is_rhand, betas):
    """The JAX package's build_mano_server, compiled once (eager dispatch of
    its ~100 small ops costs seconds on the CPU)."""
    names = ("betas", "verts_c", "joints_c", "tfs_c_inv", "skin_weights_c")
    built = jax.jit(lambda b: tuple(getattr(jsrv.build_mano_server(is_rhand, b), n)
                                    for n in names))(np.asarray(betas, np.float32))
    consts = jlbs.constants_from_model(load_mano(is_rhand))
    return jsrv.ManoServerState(consts, *built)


def _poses(seed, B=3):
    rng = np.random.RandomState(seed)
    return (
        (rng.randn(B, 48) * 0.3).astype(np.float32),
        (rng.randn(B, 10) * 0.5).astype(np.float32),
        (rng.randn(B, 3) * 0.1).astype(np.float32),
        np.float32(rng.uniform(0.5, 2.0)),
    )


def test_rotations_and_inverses_match_jax():
    rng = np.random.RandomState(0)
    aa = (rng.randn(20, 3) * 1.5).astype(np.float32)
    M = rng.randn(20, 3, 3).astype(np.float32)
    T = np.zeros((20, 4, 4), np.float32)
    T[:, :3] = rng.randn(20, 3, 4)
    T[:, 3, 3] = 1
    ref = jax.jit(lambda a, m, t: (jrot.axis_angle_to_matrix(a), jlbs.rodrigues(a),
                                   jtf.inverse_mat3(m), jtf.inverse_affine4(t)))(aa, M, T)
    got = (trot.axis_angle_to_matrix(_t(aa)), tlbs.rodrigues(_t(aa)),
           ttf.inverse_mat3(_t(M)), ttf.inverse_affine4(_t(T)))
    for g, r, tol in zip(got, ref, (1e-6, 1e-6, 1e-5, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=tol, atol=tol)


def test_mano_server_build_and_forward_match_jax():
    betas0 = np.random.RandomState(1).randn(10).astype(np.float32) * 0.3
    js = _jax_server(True, betas0)
    ts = tsrv.build_mano_server(True, betas0)
    for name in ("verts_c", "joints_c", "tfs_c_inv", "skin_weights_c"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=ATOL, err_msg=name)
    thetas, betas, transl, scale = _poses(2)
    jo = jax.jit(lambda tr, th, b: jsrv.mano_server_forward(js, jnp.full((3,), scale), tr, th, b))(
        transl, thetas, betas)
    to = tsrv.mano_server_forward(ts, _t(scale), _t(transl), _t(thetas), _t(betas))
    for name in ("verts", "jnts", "tfs", "v_posed"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   atol=2 * ATOL, err_msg=name)


def test_mano_forward_gradient_matches_jax():
    js = _jax_server(False, np.zeros(10, np.float32))
    ts = tsrv.build_mano_server(False, np.zeros(10))
    thetas, betas, transl, scale = _poses(3, B=2)
    g = np.random.RandomState(4).randn(2, 778, 3).astype(np.float32)
    gt = np.random.RandomState(5).randn(2, 16, 4, 4).astype(np.float32)

    def jf(th, tr):
        o = jsrv.mano_server_forward(js, jnp.full((2,), scale), tr, th, jnp.asarray(betas))
        return jnp.sum(o.verts * g) + jnp.sum(o.tfs * gt)

    gj = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(thetas), jnp.asarray(transl))
    th, tr = _t(thetas).requires_grad_(), _t(transl).requires_grad_()
    o = tsrv.mano_server_forward(ts, _t(scale), tr, th, _t(betas))
    ((o.verts * _t(g)).sum() + (o.tfs * _t(gt)).sum()).backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gj[0]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(gj[1]), rtol=1e-4, atol=1e-3)


def test_object_server_and_deform_match_jax():
    rng = np.random.RandomState(6)
    pts_c = (rng.randn(40, 3) * 0.5).astype(np.float32)
    norm = np.eye(4, dtype=np.float32)
    norm[:3, 3] = [0.1, -0.2, 0.05]
    js = jobj.build_object_server(pts_c, 0.1, norm)
    ts = tobj.build_object_server(pts_c, 0.1, norm)
    aa = (rng.randn(4, 3) * 0.4).astype(np.float32)
    tr = (rng.randn(4, 3) * 0.1).astype(np.float32)
    jo = jax.jit(lambda t, a: jobj.object_server_forward(
        js, jnp.full((4,), 1.3), t, a, obj_scale=jnp.asarray(0.12, jnp.float32)))(tr, aa)
    to = tobj.object_server_forward(ts, torch.tensor(1.3), _t(tr), _t(aa),
                                    obj_scale=torch.tensor(0.12))
    np.testing.assert_allclose(to.obj_tfs.numpy(), np.asarray(jo.obj_tfs), atol=1e-6)
    np.testing.assert_allclose(to.verts.numpy(), np.asarray(jo.verts), atol=1e-6)
    x = (rng.randn(4, 30, 3) * 0.2).astype(np.float32)
    np.testing.assert_allclose(
        tobj.object_deform(_t(x), to.obj_tfs, inverse=True).numpy(),
        np.asarray(jax.jit(lambda x, t: jobj.object_deform(x, t, inverse=True))(x, jo.obj_tfs)),
        rtol=1e-5, atol=1e-5)
