"""hold_tpu_torch.ops.point_mesh against hold_tpu.ops.point_mesh.

The plain min-vertex-distance (what the wrapper runs on CPU tensors) is held
against the Pallas kernel in interpret mode, including the 1e4 far-padding
rows of the object's empty mesh state; the loss-target helpers against their
jnp counterparts.  The CUDA kernel is held against the plain version on the
card (marked ``gpu``; skipped without one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hold_tpu.ops import point_mesh as jpm
from hold_tpu_torch.ops import point_mesh as tpm


def _cloud(seed, P, V, pad=0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(P, 3) * 0.3).astype(np.float32)
    verts = np.full((V + pad, 3), 1e4, np.float32)
    verts[:V] = rng.randn(V, 3) * 0.3
    return pts, verts


@pytest.mark.parametrize("P,V,pad", [(300, 200, 0), (700, 1500, 600), (257, 0, 2048)])
def test_min_vertex_dist_matches_pallas(P, V, pad):
    """Far-padded rows never win against a real vertex; an all-padding
    buffer (the empty object state) gives the distance to the padding."""
    pts, verts = _cloud(P + V, P, V, pad)
    ref = np.asarray(jpm.min_vertex_dist_pallas(jnp.asarray(pts), jnp.asarray(verts),
                                                interpret=True))
    got = tpm.min_vertex_dist_fast(torch.tensor(pts), torch.tensor(verts)).numpy()
    # fp32 cancellation in |v|^2 + |p|^2 - 2 p.v: ~sqrt(ulp(|p|^2)) near 0,
    # relative 1e-6 at the 1.7e4 distance of the padding rows
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    if V:
        exact = np.sqrt(((pts[:, None] - verts[None, :V]) ** 2).sum(-1)).min(1)
        np.testing.assert_allclose(got, exact, atol=1e-3)


def test_off_surface_bound_matches_jax():
    pts, verts = _cloud(1, 64 * 10, 120, pad=200)
    for h in (0.0, 0.02):
        ref = jpm.off_surface_by_vertex_bound(jnp.asarray(pts), jnp.asarray(verts), 64, 0.05, h)
        got = tpm.off_surface_by_vertex_bound(torch.tensor(pts), torch.tensor(verts), 64, 0.05, h)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_signed_distance_and_parts_match_jax():
    from hold_tpu.data.synthetic import _sphere_mesh

    verts, faces = _sphere_mesh(0.5, 1)
    rng = np.random.RandomState(2)
    pts = (rng.randn(150, 3) * 0.4).astype(np.float32)
    tri = verts[faces]
    np.testing.assert_allclose(
        tpm.point_mesh_sqdist(torch.tensor(pts), torch.tensor(tri)).numpy(),
        np.asarray(jpm.point_mesh_sqdist(jnp.asarray(pts), jnp.asarray(tri))), atol=1e-6)
    np.testing.assert_allclose(
        tpm.winding_number(torch.tensor(pts), torch.tensor(tri)).numpy(),
        np.asarray(jpm.winding_number(jnp.asarray(pts), jnp.asarray(tri))), atol=1e-5)
    sd_t = tpm.signed_distance_to_mesh(torch.tensor(pts), torch.tensor(verts), torch.tensor(faces))
    sd_j = jpm.signed_distance_to_mesh(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(faces))
    np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j), atol=1e-5)
    r = np.linalg.norm(pts, axis=1)  # the mesh lies between radius 0.4 and 0.5
    assert (sd_t.numpy()[r < 0.4] < 0).all() and (sd_t.numpy()[r > 0.5] > 0).all()
    np.testing.assert_allclose(
        float(tpm.face_circumradius_bound(torch.tensor(verts), torch.tensor(faces))),
        float(jpm.face_circumradius_bound(jnp.asarray(verts), jnp.asarray(faces))), rtol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the min-distance kernel is CUDA only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_min_vertex_dist_matches_plain(cuda):
    pts, verts = _cloud(5, 20000, 3000, pad=5192)
    p, v = torch.tensor(pts, device=cuda), torch.tensor(verts, device=cuda)
    got = tpm.min_vertex_dist_fast(p, v)
    torch.testing.assert_close(got, tpm.min_vertex_dist(p, v), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("V,pad,tiled", [(3000, 0, True), (778, 7414, False), (0, 8192, False)],
                         ids=["tiled_cloud", "object_buffer", "all_padding"])
def test_cuda_min_vertex_dist_culls_exactly(cuda, V, pad, tiled):
    """Tile culling changes no minimum: bit for bit the plain version on a
    tiled cloud, the object's far-padded buffer and the all-padding empty
    state, at points ordered as consecutive ray samples."""
    from hold_tpu_torch.ops.knn import tile_order

    pts, verts = _cloud(V + pad, 20000, V, pad)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]  # neighbouring lanes, neighbouring points
    p, v = torch.tensor(pts, device=cuda), torch.tensor(verts, device=cuda)
    got = tpm.min_vertex_dist_fast(p, v, tile_order(v) if tiled else None)
    assert torch.equal(got, tpm.min_vertex_dist(p, v))
