"""hold_tpu_torch.meshing (MISE, the canonical meshes) against the JAX
package, at toy sizes.

- the port's ``mise.cpp`` is a byte-identical copy of the JAX package's;
- the port's ``generate_mesh`` on analytic fields: a sphere's radius and
  closure (the bounds of ``tests/test_meshing.py``), the largest of two
  components, an empty field;
- the port's and the JAX package's ``generate_mesh`` on the same field give
  identical vertices and faces.  The JAX wrapper is handed the port's built
  library (its ``_build_lib`` patched), so that nothing is built or written
  under ``hold_tpu/``;
- ``make_node_sdf_fn`` of both packages on converted toy-width weights
  within 1e-5, and ``mesh_all_cano`` of both at ``res_scale`` 4: equal faces,
  vertices within 1e-4;
- ``decimate_mesh`` equal to the JAX package's.
"""

import copy
import filecmp
import os
from collections import Counter

import jax
import numpy as np
import pytest
import torch

import hold_tpu.meshing.mise as jmise
from hold_tpu.meshing import cano as jcano
from hold_tpu.models import holdnet as jhn
from hold_tpu.utils.config import DEFAULT_CONFIG
from hold_tpu.utils.mesh import decimate_mesh as j_decimate
from hold_tpu_torch.data.dataset import SequenceData
from hold_tpu_torch.data.synthetic import generate_sequence
from hold_tpu_torch.meshing import cano as tcano
from hold_tpu_torch.meshing import mise as tmise
from hold_tpu_torch.models import holdnet as thn
from hold_tpu_torch.utils.convert import params_from_jax
from hold_tpu_torch.utils.mesh import decimate_mesh, load_obj

ARGS = {"barf_s": 0, "barf_e": 1000}


def _sphere_sdf(center, r):
    def f(p):
        return np.linalg.norm(p - center, axis=1) - r
    return f


@pytest.fixture
def jax_mise_on_port_lib(monkeypatch):
    """The JAX package's generate_mesh, loading the port's library: its own
    would build (and may rebuild) next to its tracked source."""
    monkeypatch.setattr(jmise, "_build_lib", tmise._build_lib)
    monkeypatch.setattr(jmise, "_LIB", None)
    yield jmise


def test_mise_source_is_the_jax_packages():
    here = os.path.dirname(os.path.abspath(__file__))
    assert filecmp.cmp(os.path.join(here, "..", "hold_tpu", "meshing", "csrc", "mise.cpp"),
                       str(tmise.SRC), shallow=False)
    assert os.path.basename(tmise._build_lib()).startswith("libmise_")


def test_mise_sphere_accuracy(tmp_path):
    m = tmise.generate_mesh(_sphere_sdf(np.array([0.05, 0.0, 0.0]), 0.3),
                            np.array([[-0.4, -0.4, -0.4], [0.5, 0.4, 0.4]]), res_init=16, res_up=2)
    r = np.linalg.norm(m.vertices - [0.05, 0, 0], axis=1)
    assert abs(r.mean() - 0.3) < 1e-3
    assert np.abs(r - 0.3).max() < 5e-3
    cnt = Counter()  # watertight: every edge shared by two faces
    for f in m.faces:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            cnt[(min(a, b), max(a, b))] += 1
    assert set(cnt.values()) == {2}
    v0, v1, v2 = (m.vertices[m.faces[:, i]] - [0.05, 0, 0] for i in range(3))
    vol = np.einsum("ij,ij->i", v0, np.cross(v1, v2)).sum() / 6.0  # outward winding
    assert abs(vol - 4 / 3 * np.pi * 0.3**3) < 2e-3
    p = str(tmp_path / "m.obj")
    m.export(p)
    back = load_obj(p)
    assert back.vertices.shape == m.vertices.shape and np.array_equal(back.faces, m.faces)


def test_mise_largest_component_and_empty_field():
    big = _sphere_sdf(np.array([-0.25, 0, 0]), 0.2)
    small = _sphere_sdf(np.array([0.3, 0, 0]), 0.08)
    m = tmise.generate_mesh(lambda p: np.minimum(big(p), small(p)),
                            np.array([[-0.5, -0.3, -0.3], [0.45, 0.3, 0.3]]), res_init=24,
                            res_up=1)
    assert np.abs(np.linalg.norm(m.vertices - [-0.25, 0, 0], axis=1) - 0.2).max() < 0.02
    assert tmise.generate_mesh(lambda p: np.ones(p.shape[0]), np.array([[-1, -1, -1], [1, 1, 1.0]]),
                               res_init=8, res_up=0) is None


def test_generate_mesh_equals_the_jax_packages(jax_mise_on_port_lib):
    def field(p):  # two overlapping spheres and a small far one
        a = np.linalg.norm(p - [0.05, 0.0, 0.0], axis=1) - 0.25
        b = np.linalg.norm(p - [-0.15, 0.1, 0.0], axis=1) - 0.15
        c = np.linalg.norm(p - [0.3, -0.3, 0.2], axis=1) - 0.05
        return np.minimum(np.minimum(a, b), c)

    bbox = np.array([[-0.4, -0.4, -0.3], [0.45, 0.3, 0.35]])
    for keep in (True, False):
        t = tmise.generate_mesh(field, bbox, res_init=16, res_up=2, keep_largest=keep)
        j = jax_mise_on_port_lib.generate_mesh(field, bbox, res_init=16, res_up=2,
                                               keep_largest=keep)
        assert np.array_equal(t.vertices, j.vertices) and np.array_equal(t.faces, j.faces)
        assert t.vertices.dtype == j.vertices.dtype == np.float32


@pytest.fixture(scope="module")
def toy_nets():
    """One toy-width scene (64-wide nets) in both packages from the same
    synthetic sequence; the JAX params converted for the port."""
    built = generate_sequence(None, n_frames=3, img_hw=(48, 64))
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=8)
    model = copy.deepcopy(DEFAULT_CONFIG["model"])
    model["proposal"]["enabled"] = False
    for k in ("implicit_network", "rendering_network"):
        model[k]["dims"] = [64] * len(model[k]["dims"])
    model["bg_implicit_network"]["dims"] = [96] * 8
    model["bg_rendering_network"]["dims"] = [16]
    sd = seq.scene_data()
    jscene = jhn.build_scene(model, ARGS, sd)
    jparams = jax.device_get(jhn.init_scene_params(jax.random.PRNGKey(3), jscene, sd))
    tscene = thn.build_scene(model, ARGS, sd, "cpu")
    return jscene, jparams, tscene, params_from_jax(jparams)


def test_node_sdf_fn_matches_jax(toy_nets):
    jscene, jparams, tscene, tparams = toy_nets
    pts = (np.random.RandomState(0).rand(12_345, 3).astype(np.float32) - 0.5) * 2.5
    for nid, cond in (("right", 45), ("object", 0)):
        got = tcano.make_node_sdf_fn(tparams[nid], tscene.plans[nid], cond, "cpu")(pts)
        ref = jcano.make_node_sdf_fn(jparams[nid], jscene.plans[nid], cond)(pts)
        assert got.shape == (12_345,)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_mesh_all_cano_matches_jax(toy_nets, jax_mise_on_port_lib):
    jscene, jparams, tscene, tparams = toy_nets
    got = tcano.mesh_all_cano(tparams, tscene, res_scale=4)
    ref = jcano.mesh_all_cano(jparams, jscene, res_scale=4)
    assert set(got) == set(ref) and "object" in got  # the object's field has a surface at init
    for nid in got:
        assert np.array_equal(got[nid].faces, ref[nid].faces), nid
        np.testing.assert_allclose(got[nid].vertices, ref[nid].vertices, atol=1e-4, rtol=0)


def test_decimate_mesh_equals_the_jax_packages():
    m = tmise.generate_mesh(_sphere_sdf(np.zeros(3), 0.3), np.array([[-0.4] * 3, [0.4] * 3]),
                            res_init=16, res_up=1)
    for target in (500, 3000, m.faces.shape[0] + 1):
        d, r = decimate_mesh(m.vertices, m.faces, target), j_decimate(m.vertices, m.faces, target)
        assert np.array_equal(d.vertices, r.vertices) and np.array_equal(d.faces, r.faces)
    d = decimate_mesh(m.vertices, m.faces, 500)
    assert 100 <= d.faces.shape[0] <= m.faces.shape[0]
    assert abs(np.linalg.norm(d.vertices, axis=1).mean() - 0.3) < 0.02
