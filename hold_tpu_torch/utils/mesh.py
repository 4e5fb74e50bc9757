"""Mesh utilities (the part of hold_tpu/utils/mesh.py the port uses, copied
so that the port imports nothing of the JAX package): the ``Mesh`` container
and OBJ I/O, vertex-clustering decimation and face normals (numpy, on the
host), MANO wrist sealing (faces and vertices) and the one-step Loop
subdivision operator.

Sealing + one Loop iteration on the fixed MANO topology is a linear operator
on vertex positions, so it is precomputed once as a dense (V_div x 778)
matrix and applied as a matmul.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Vertex ids around the MANO wrist ring and the fan faces that close it —
# the standard sealing used by the reference (common/body_models.py:36-104).
SEAL_CIRCLE_V_ID = np.array(
    [108, 79, 78, 121, 214, 215, 279, 239, 234, 92, 38, 122, 118, 117, 119, 120],
    dtype=np.int64,
)
_SEAL_RING = [120, 108, 79, 78, 121, 214, 215, 279, 239, 234, 92, 38, 122, 118, 117, 119]
SEAL_FACES_R = np.array(
    [[_SEAL_RING[i], _SEAL_RING[(i + 1) % 16], 778] for i in range(16)], dtype=np.int64
)



@dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float
    faces: np.ndarray  # (F, 3) int

    def export(self, path: str) -> None:
        save_obj(path, self.vertices, self.faces)

    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    def copy(self) -> "Mesh":
        return Mesh(self.vertices.copy(), self.faces.copy())


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in np.asarray(faces) + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def load_obj(path: str) -> Mesh:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return Mesh(np.array(verts, np.float32), np.array(faces, np.int64))


def decimate_mesh(vertices: np.ndarray, faces: np.ndarray, target_faces: int) -> Mesh:
    """Vertex-clustering decimation towards ``target_faces`` (replaces
    pymeshlab at code/src/fitting/utils.py:75-98): vertices clustered on a
    uniform grid, doubled in resolution until the remapped faces reach the
    target, degenerate and repeated faces removed."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    if faces.shape[0] <= target_faces:
        return Mesh(vertices.astype(np.float32), faces)
    lo, hi = vertices.min(0), vertices.max(0)
    extent = np.maximum(hi - lo, 1e-9)
    res = 16  # faces grow ~ quadratically with the grid's resolution
    for _ in range(12):
        cell = extent / res
        keys = np.minimum(np.floor((vertices - lo) / cell).astype(np.int64), res - 1)
        flat = (keys[:, 0] * res + keys[:, 1]) * res + keys[:, 2]
        uniq, inv = np.unique(flat, return_inverse=True)
        new_f = inv[faces]
        good = ((new_f[:, 0] != new_f[:, 1]) & (new_f[:, 1] != new_f[:, 2])
                & (new_f[:, 0] != new_f[:, 2]))
        if int(good.sum()) >= target_faces or res > 512:
            new_v = np.zeros((len(uniq), 3))
            counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
            for d in range(3):
                new_v[:, d] = np.bincount(inv, weights=vertices[:, d], minlength=len(uniq))
            new_v /= counts[:, None]
            _, keep = np.unique(np.sort(new_f[good], axis=1), axis=0, return_index=True)
            return Mesh(new_v.astype(np.float32), new_f[good][np.sort(keep)])
        res *= 2
    return Mesh(vertices.astype(np.float32), faces)


def face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def seal_mano_faces(faces: np.ndarray, is_rhand: bool) -> np.ndarray:
    """Close the MANO wrist hole with a 16-triangle fan to vertex 778."""
    seal = SEAL_FACES_R if is_rhand else SEAL_FACES_R[:, [1, 0, 2]]
    return np.concatenate([np.asarray(faces, np.int64), seal], axis=0)


def seal_mano_verts(verts):
    """Append the wrist-ring centroid vertex: (..., 778, 3) -> (..., 779, 3).

    Works on numpy arrays and torch tensors (indexing, mean, concatenation);
    pair with :func:`seal_mano_faces`.
    """
    if isinstance(verts, np.ndarray):
        center = np.mean(verts[..., SEAL_CIRCLE_V_ID, :], axis=-2, keepdims=True)
        return np.concatenate([verts, center], axis=-2)
    import torch

    ring = torch.as_tensor(SEAL_CIRCLE_V_ID, device=verts.device)
    center = verts[..., ring, :].mean(dim=-2, keepdim=True)
    return torch.cat([verts, center], dim=-2)


def seal_matrix(num_verts: int = 778) -> np.ndarray:
    """Linear map (V+1, V) appending the wrist-ring centroid vertex."""
    S = np.zeros((num_verts + 1, num_verts), dtype=np.float32)
    S[:num_verts] = np.eye(num_verts, dtype=np.float32)
    S[num_verts, SEAL_CIRCLE_V_ID] = 1.0 / len(SEAL_CIRCLE_V_ID)
    return S


def loop_subdivide_topology(faces: np.ndarray, num_verts: int):
    """One Loop-subdivision step on a fixed topology.

    Returns (S, new_faces) where S is the dense (V_new, V) matrix such that
    new_vertices = S @ vertices, and new_faces the subdivided face list.
    Standard Loop weights: even (original) vertices use Warren's beta rule,
    odd (edge) vertices 3/8-3/8-1/8-1/8 (boundary: midpoint / 1/8-rule).
    """
    faces = np.asarray(faces, np.int64)
    # edge bookkeeping
    edges = {}
    edge_faces: dict[tuple[int, int], list[int]] = {}
    for fi, (a, b, c) in enumerate(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            key = (min(u, v), max(u, v))
            if key not in edges:
                edges[key] = len(edges)
                edge_faces[key] = []
            edge_faces[key].append(fi)

    num_edges = len(edges)
    V_new = num_verts + num_edges
    S = np.zeros((V_new, num_verts), dtype=np.float32)

    # adjacency for even vertices
    neighbors: list[set[int]] = [set() for _ in range(num_verts)]
    boundary_nbrs: list[set[int]] = [set() for _ in range(num_verts)]
    for (u, v), key_faces in edge_faces.items():
        neighbors[u].add(v)
        neighbors[v].add(u)
        if len(key_faces) == 1:  # boundary edge
            boundary_nbrs[u].add(v)
            boundary_nbrs[v].add(u)

    for vi in range(num_verts):
        bn = boundary_nbrs[vi]
        if bn:  # boundary vertex: 3/4 self + 1/8 each boundary neighbor
            S[vi, vi] = 0.75
            for nb in bn:
                S[vi, nb] += 0.125 * (2.0 / len(bn))
        else:
            n = len(neighbors[vi])
            if n == 0:
                S[vi, vi] = 1.0
                continue
            beta = (
                3.0 / 16.0
                if n == 3
                else 3.0 / (8.0 * n)
            )
            S[vi, vi] = 1.0 - n * beta
            for nb in neighbors[vi]:
                S[vi, nb] = beta

    # odd (edge) vertices
    # opposite vertices per edge
    for (u, v), key_faces in edge_faces.items():
        ei = num_verts + edges[(u, v)]
        if len(key_faces) == 1:  # boundary: midpoint
            S[ei, u] = 0.5
            S[ei, v] = 0.5
        else:
            opp = []
            for fi in key_faces[:2]:
                a, b, c = faces[fi]
                for w in (a, b, c):
                    if w != u and w != v:
                        opp.append(w)
            S[ei, u] = 0.375
            S[ei, v] = 0.375
            for w in opp:
                S[ei, w] += 0.125

    # new faces: each triangle -> 4
    new_faces = []
    for a, b, c in faces:
        eab = num_verts + edges[(min(a, b), max(a, b))]
        ebc = num_verts + edges[(min(b, c), max(b, c))]
        eca = num_verts + edges[(min(c, a), max(c, a))]
        new_faces += [[a, eab, eca], [b, ebc, eab], [c, eca, ebc], [eab, ebc, eca]]
    return S, np.array(new_faces, np.int64)


def mano_subdivision_operator(mano_faces: np.ndarray, is_rhand: bool):
    """Composite linear operator: seal wrist then Loop-subdivide once.

    Returns (M, faces_div): verts_div = M @ verts_778 (M: (V_div, 778)).
    """
    sealed_faces = seal_mano_faces(mano_faces, is_rhand)
    S_sub, faces_div = loop_subdivide_topology(sealed_faces, 779)
    S_seal = seal_matrix(778)
    return (S_sub @ S_seal).astype(np.float32), faces_div
