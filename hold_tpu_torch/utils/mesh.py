"""MANO wrist sealing and the one-step Loop subdivision operator (the part of
hold_tpu/utils/mesh.py the port uses, copied so that the port imports nothing
of the JAX package).

Sealing + one Loop iteration on the fixed MANO topology is a linear operator
on vertex positions, so it is precomputed once as a dense (V_div x 778)
matrix and applied as a matmul.
"""

from __future__ import annotations

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


def seal_mano_faces(faces: np.ndarray, is_rhand: bool) -> np.ndarray:
    """Close the MANO wrist hole with a 16-triangle fan to vertex 778."""
    seal = SEAL_FACES_R if is_rhand else SEAL_FACES_R[:, [1, 0, 2]]
    return np.concatenate([np.asarray(faces, np.int64), seal], axis=0)


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
