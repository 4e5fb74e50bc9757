"""The native MISE + marching-tetrahedra extractor (counterpart of
hold_tpu/meshing/mise.py).

``csrc/mise.cpp`` is the port's own copy of the JAX package's source.  It is
built with g++ at first use into ``hold_tpu_torch/_build/`` under a name
keyed by the source's hash (as ``ops/_cuda.py`` builds the CUDA kernels),
and loaded with ctypes.  ``generate_mesh`` drives its query / update loop
with batched SDF evaluations and keeps the largest connected component, as
the reference's generate_mesh does (code/src/utils/meshing.py:9-72).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..utils.mesh import Mesh

SRC = Path(__file__).resolve().parent / "csrc" / "mise.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lock = threading.Lock()
_LIB = None


def _build_lib() -> str:
    """The built library's path, ``_build/libmise_<hash>.so``; built with
    g++ if absent.  Raises if the build fails."""
    out = BUILD_DIR / f"libmise_{hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]}.so"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SRC}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(out)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(_build_lib())
            i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
            lib.mise_create.restype = ctypes.c_void_p
            lib.mise_create.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_double]
            lib.mise_resolution.restype = ctypes.c_int64
            lib.mise_resolution.argtypes = [ctypes.c_void_p]
            lib.mise_query.restype = ctypes.c_int64
            lib.mise_query.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64]
            lib.mise_update.restype = ctypes.c_int32
            lib.mise_update.argtypes = [ctypes.c_void_p, i64p, f64p, ctypes.c_int64]
            lib.mise_extract.restype = ctypes.c_int64
            lib.mise_extract.argtypes = [ctypes.c_void_p, f64p, ctypes.c_int64, i64p,
                                         ctypes.c_int64, i64p]
            lib.mise_free.restype = None
            lib.mise_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def largest_component(verts: np.ndarray, faces: np.ndarray) -> Mesh:
    """Keep the connected component with the largest surface area (scipy
    sparse connected components; replaces trimesh.split at
    meshing.py:61-70)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = verts.shape[0]
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = coo_matrix((np.ones(rows.shape[0], np.int8), (rows, cols)), shape=(n, n))
    _, roots = connected_components(adj, directed=False)

    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    comp_of_face = roots[faces[:, 0]]
    comps, inv = np.unique(comp_of_face, return_inverse=True)
    best = comps[np.argmax(np.bincount(inv, weights=area))]
    faces_k = faces[comp_of_face == best]
    used = np.unique(faces_k)
    remap = np.full(n, -1, np.int64)
    remap[used] = np.arange(used.shape[0])
    return Mesh(verts[used].astype(np.float32), remap[faces_k])


def generate_mesh(sdf_fn, bbox_verts: np.ndarray, level_set: float = 0.0, res_init: int = 32,
                  res_up: int = 3, point_batch: int = 10000,
                  keep_largest: bool = True) -> Mesh | None:
    """Extract the level set of ``sdf_fn`` inside a padded bbox; None when
    the field has no surface there.

    sdf_fn: (N, 3) float32 points -> (N,) sdf values (numpy in and out),
    called with at most ``point_batch`` points.  bbox_verts: any point set
    whose tight bbox bounds the surface (padded by 1.1, cubic scale = the
    largest extent; meshing.py:13-18)."""
    lib = _lib()
    bbox_verts = np.asarray(bbox_verts, np.float64)
    gt_bbox = np.stack([bbox_verts.min(axis=0), bbox_verts.max(axis=0)])
    gt_center = 0.5 * (gt_bbox[0] + gt_bbox[1])
    gt_scale = (gt_bbox[1] - gt_bbox[0]).max()
    pad = 1.1
    i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)

    h = lib.mise_create(res_init, res_up, float(level_set))
    try:
        res = lib.mise_resolution(h)

        def to_world(grid_pts):
            return ((grid_pts / res - 0.5) * pad) * gt_scale + gt_center

        while True:
            n = lib.mise_query(h, None, 0)
            if n == 0:
                break
            coords = np.empty((n, 3), np.int64)
            lib.mise_query(h, coords.ctypes.data_as(i64p), n)
            pts = to_world(coords.astype(np.float64))
            vals = np.empty(n, np.float64)
            for s in range(0, n, point_batch):
                e = min(s + point_batch, n)
                vals[s:e] = np.asarray(sdf_fn(pts[s:e].astype(np.float32))).reshape(-1)
            if not lib.mise_update(h, coords.ctypes.data_as(i64p), vals.ctypes.data_as(f64p), n):
                break

        nv = lib.mise_extract(h, None, 0, None, 0, None)
        if nv == 0:
            return None
        max_f = max(nv * 8, 1024)  # marching tetrahedra: ~4 faces a vertex
        verts = np.empty((nv, 3), np.float64)
        faces = np.empty((max_f, 3), np.int64)
        nf = ctypes.c_int64(0)
        lib.mise_extract(h, verts.ctypes.data_as(f64p), nv, faces.ctypes.data_as(i64p), max_f,
                         ctypes.byref(nf))
        mesh = Mesh(to_world(verts).astype(np.float32), faces[: nf.value])
        if keep_largest and mesh.faces.shape[0] > 0:
            mesh = largest_component(mesh.vertices, mesh.faces)
        return mesh
    finally:
        lib.mise_free(h)
