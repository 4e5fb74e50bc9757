"""The library functions of hold_tpu_torch that no training path reaches,
against the JAX package's: every public rotation conversion of
``utils/rot.py`` not held elsewhere, ``utils/transforms.py``'s ``to_homo``,
``transform_points`` and ``inverse_rigid``, ``models/density.py``'s
``simple_density`` and ``mano/lbs.py``'s ``blend_shapes`` and
``vertices2joints``.  One case a function, on seeded inputs (random
rotations, one of them at gimbal lock, quaternions with negative real
parts), at float32 rounding (1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hold_tpu.mano import lbs as jlbs
from hold_tpu.models import density as jdensity
from hold_tpu.utils import rot as jrot
from hold_tpu.utils import transforms as jtf
from hold_tpu_torch.mano import lbs as tlbs
from hold_tpu_torch.models import density as tdensity
from hold_tpu_torch.utils import rot as trot
from hold_tpu_torch.utils import transforms as ttf

TOL = 1e-5


def _rng():
    return np.random.RandomState(5)


def _aa(n=6):
    return (_rng().randn(n, 3) * 0.9).astype(np.float32)


def _mats(n=6):
    m = np.array(jrot.axis_angle_to_matrix(jnp.asarray(_aa(n))))
    # one at gimbal lock (R[2, 0] = -1): a quarter turn about y
    m[0] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], dtype=np.float32)
    return m


def _quats(n=6):
    q = _rng().randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q  # some with w < 0


def _rigid(n=4):
    T = np.zeros((n, 4, 4), np.float32)
    T[:, :3, :3] = _mats(n)
    T[:, :3, 3] = _rng().randn(n, 3)
    T[:, 3, 3] = 1.0
    return T


# name -> (module pair, function name, seeded numpy arguments)
CASES = {
    "matrix_to_quaternion": (jrot, trot, "matrix_to_quaternion", lambda: (_mats(),)),
    "quaternion_to_matrix": (jrot, trot, "quaternion_to_matrix", lambda: (_quats(),)),
    "matrix_to_axis_angle": (jrot, trot, "matrix_to_axis_angle", lambda: (_mats(),)),
    "rotation_6d_to_matrix": (jrot, trot, "rotation_6d_to_matrix",
                              lambda: (_rng().randn(6, 6).astype(np.float32),)),
    "matrix_to_rotation_6d": (jrot, trot, "matrix_to_rotation_6d", lambda: (_mats(),)),
    "standardize_quaternion": (jrot, trot, "standardize_quaternion", lambda: (_quats(),)),
    "quaternion_raw_multiply": (jrot, trot, "quaternion_raw_multiply",
                                lambda: (_quats(), _quats()[::-1].copy())),
    "quaternion_multiply": (jrot, trot, "quaternion_multiply",
                            lambda: (_quats(), _quats()[::-1].copy())),
    "quaternion_invert": (jrot, trot, "quaternion_invert", lambda: (_quats(),)),
    "quaternion_apply": (jrot, trot, "quaternion_apply",
                         lambda: (_quats(), _rng().randn(6, 3).astype(np.float32))),
    "euler_to_quaternion": (jrot, trot, "euler_to_quaternion", lambda: (_aa(),)),
    "euler_to_matrix": (jrot, trot, "euler_to_matrix", lambda: (_aa(),)),
    "matrix_to_euler": (jrot, trot, "matrix_to_euler", lambda: (_mats(),)),
    "compute_geodesic_distance": (jrot, trot, "compute_geodesic_distance",
                                  lambda: (_mats(), _mats()[::-1].copy())),
    "rot_aa": (jrot, trot, "rot_aa", lambda: (_aa(), 30.0)),
    "rot6d_to_rotmat_ref": (jrot, trot, "rot6d_to_rotmat_ref",
                            lambda: (_rng().randn(6, 6).astype(np.float32),)),
    "rotmat_to_rot6d_ref": (jrot, trot, "rotmat_to_rot6d_ref", lambda: (_mats(),)),
    "to_homo": (jtf, ttf, "to_homo", lambda: (_rng().randn(4, 5, 3).astype(np.float32),)),
    "transform_points": (jtf, ttf, "transform_points",
                         lambda: (_rigid(), _rng().randn(4, 5, 3).astype(np.float32))),
    "inverse_rigid": (jtf, ttf, "inverse_rigid", lambda: (_rigid(),)),
    "simple_density": (jdensity, tdensity, "simple_density",
                       lambda: (_rng().randn(50).astype(np.float32),)),
    "blend_shapes": (jlbs, tlbs, "blend_shapes",
                     lambda: (_rng().randn(2, 10).astype(np.float32),
                              _rng().randn(30, 3, 10).astype(np.float32))),
    "vertices2joints": (jlbs, tlbs, "vertices2joints",
                        lambda: (_rng().rand(16, 30).astype(np.float32),
                                 _rng().randn(2, 30, 3).astype(np.float32))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    jmod, tmod, fn, make = CASES[name]
    args = make()
    ref = np.asarray(getattr(jmod, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                         for a in args)))
    got = getattr(tmod, fn)(*(torch.tensor(a) if isinstance(a, np.ndarray) else a
                              for a in args))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
