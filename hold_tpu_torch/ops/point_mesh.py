"""Point-to-mesh distances for the loss targets (counterpart of
hold_tpu/ops/point_mesh.py).

Brute-force point-triangle distances with a generalized winding number for
the sign (the meshes are small), and the conservative vertex-distance
off-surface bound.  ``min_vertex_dist_fast`` is the one kernel here
(``csrc/point_mesh.cu``): on CUDA tensors it launches it or raises, on CPU
tensors it runs the plain ``min_vertex_dist``.
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from .knn import sqnorm3

_EPS = 1e-12
LAUNCHES = {"min_vertex_dist": 0}


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def triangle_sqdist(p, v0, v1, v2):
    """Squared distance from points to triangles, broadcast over leading dims
    (Ericson's region decomposition)."""
    ab, ac = v1 - v0, v2 - v0
    ap, bp, cp = p - v0, p - v1, p - v2
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    w_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=_EPS), 0.0, 1.0)
    den_ab = torch.where((d1 - d3).abs() < _EPS, torch.full_like(d1, _EPS), d1 - d3)
    den_ac = torch.where((d2 - d6).abs() < _EPS, torch.full_like(d2, _EPS), d2 - d6)
    v_ab = torch.clamp(d1 / den_ab, 0.0, 1.0)
    w_ac = torch.clamp(d2 / den_ac, 0.0, 1.0)
    denom_in = torch.clamp(va + vb + vc, min=_EPS)
    v_in, w_in = vb / denom_in, vc / denom_in

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = ~in_a & ~in_b & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = ~in_a & ~in_c & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = ~in_b & ~in_c & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    closest = v0 + v_in[..., None] * ab + w_in[..., None] * ac
    for mask, cand in (
        (on_bc, v1 + w_bc[..., None] * (v2 - v1)),
        (on_ac, v0 + w_ac[..., None] * ac),
        (on_ab, v0 + v_ab[..., None] * ab),
        (in_c, v2),
        (in_b, v1),
        (in_a, v0),
    ):
        closest = torch.where(mask[..., None], cand, closest)
    diff = p - closest
    return _dot(diff, diff)


def point_mesh_sqdist(pts, tri_verts):
    """(P,3),(F,3,3) -> (P,) min squared distance over all faces."""
    d = triangle_sqdist(
        pts[:, None, :], tri_verts[None, :, 0], tri_verts[None, :, 1],
        tri_verts[None, :, 2],
    )
    return torch.amin(d, dim=-1)


def winding_number(pts, tri_verts):
    """Generalized winding number (solid-angle sum), (P,): ~1 inside."""
    a = tri_verts[None, :, 0] - pts[:, None, :]
    b = tri_verts[None, :, 1] - pts[:, None, :]
    c = tri_verts[None, :, 2] - pts[:, None, :]
    la, lb, lc = (torch.linalg.norm(x, dim=-1) for x in (a, b, c))
    det = _dot(a, torch.cross(b, c, dim=-1))
    denom = la * lb * lc + _dot(a, b) * lc + _dot(b, c) * la + _dot(c, a) * lb
    omega = 2.0 * torch.atan2(det, denom)
    return torch.sum(omega, dim=-1) / (4.0 * math.pi)


def signed_distance_to_mesh(pts, verts, faces):
    """SDF of points (P,3) to a mesh (V,3),(F,3): negative inside."""
    tri = verts[faces]
    dist = torch.sqrt(torch.clamp(point_mesh_sqdist(pts, tri), min=0.0))
    sign = torch.where(winding_number(pts, tri) > 0.5, -1.0, 1.0)
    return sign * dist


def min_vertex_dist(pts, verts, chunk_elems: int = 1 << 24):
    """Plain version of the kernel: (P,3),(V,3) -> (P,) min distance to the
    vertex set, d2 = (|v|^2 + |p|^2) - 2 p.v with the kernel's operation
    order.  Points go in chunks so the (chunk, V) block stays bounded."""
    v = verts[None, :, :]
    vsq = sqnorm3(verts)[None, :]
    step = max(1, chunk_elems // max(verts.shape[0], 1))
    out = []
    for s in range(0, pts.shape[0], step):
        p = pts[s:s + step, None, :]
        cross = (p[..., 0] * v[..., 0] + p[..., 1] * v[..., 1]) + p[..., 2] * v[..., 2]
        out.append(torch.amin((vsq + sqnorm3(p)) - 2.0 * cross, dim=-1))
    return torch.sqrt(torch.clamp(torch.cat(out), min=0.0))


def min_vertex_dist_fast(pts, verts):
    """Kernel 4: min distance (P,) from points (P,3) to vertices (V,3),
    stop-gradient.  CUDA tensors launch csrc/point_mesh.cu; CPU tensors run
    the plain version."""
    pts, verts = pts.detach(), verts.detach()
    if pts.is_cuda:
        P, V = pts.shape[0], verts.shape[0]
        _cuda.check(pts, "pts", (P, 3))
        _cuda.check(verts, "verts", (V, 3))
        out = torch.empty((P,), dtype=torch.float32, device=pts.device)
        _cuda.launch("hold_min_vertex_dist", pts.data_ptr(), verts.data_ptr(),
                     out.data_ptr(), P, V)
        LAUNCHES["min_vertex_dist"] += 1
        return out
    if pts.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for device {pts.device}")
    with torch.no_grad():
        return min_vertex_dist(pts, verts)


def off_surface_by_vertex_bound(pts, verts, num_rays: int, threshold: float,
                                h_margin) -> torch.Tensor:
    """Conservative off-surface ray classification: min over a ray's samples
    of the vertex distance > threshold + h implies the exact
    point-to-mesh test (d_triangle <= d_vertex <= d_triangle + h)."""
    d = min_vertex_dist_fast(pts, verts)
    per_ray = torch.amin(d.reshape(num_rays, -1), dim=1)
    return per_ray > (threshold + h_margin)


def face_circumradius_bound(verts, faces) -> torch.Tensor:
    """max over faces of (longest edge / sqrt(3)): bounds the distance from
    any surface point to its nearest vertex."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    e = torch.stack([
        torch.linalg.norm(v1 - v0, dim=-1),
        torch.linalg.norm(v2 - v1, dim=-1),
        torch.linalg.norm(v0 - v2, dim=-1),
    ])
    return torch.amax(e) / math.sqrt(3.0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
