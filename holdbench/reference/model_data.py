"""MANO model constants: loading + a deterministic synthetic stand-in (a frozen
copy of the port's hold_tpu_torch/mano/model_data.py, synthetic model only).

The real MANO assets (MANO_RIGHT/LEFT.pkl) are licensed and must be supplied by
the user under ``body_models/`` exactly as in the reference
(code/src/model/mano/server.py:121-128).  When absent (CI, tests, benchmarks)
we build a synthetic hand model with the *exact* MANO tensor shapes and
topology counts (778 verts / 1538 faces / 16 joints / 45-d pose / 10-d shape)
whose wrist boundary ring coincides with the canonical sealing ring vertex ids,
so every downstream component (sealing, subdivision, skinning, eval) runs
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mesh import _SEAL_RING

NUM_VERTS = 778
NUM_JOINTS = 16
NUM_BETAS = 10
POSE_DIM = 45  # 15 joints x 3 (axis-angle), global orient excluded

# MANO fingertip vertex ids (thumb, index, middle, ring, pinky) — the standard
# smplx convention used by the reference's vertex_joint_selector.
TIP_VERTEX_IDS = np.array([744, 320, 443, 554, 671], dtype=np.int64)

# kinematic tree: wrist, then index/middle/pinky/ring/thumb chains of 3
PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], np.int64)


@dataclass
class ManoModelData:
    v_template: np.ndarray  # (778, 3)
    shapedirs: np.ndarray  # (778, 3, 10)
    posedirs: np.ndarray  # (135, 778*3)  [pose basis -> vertex offsets]
    J_regressor: np.ndarray  # (16, 778)
    parents: np.ndarray  # (16,)
    lbs_weights: np.ndarray  # (778, 16)
    hands_mean: np.ndarray  # (45,)
    faces: np.ndarray  # (1538, 3)
    is_rhand: bool
    synthetic: bool = False


def _synthetic_topology():
    """Mitten-shaped open surface: 48 rings x 16 segments + 9-ring + apex
    = 778 verts, 1538 faces; wrist boundary permuted onto the seal ring ids."""
    nseg, nrings = 16, 48
    n_main = nseg * nrings  # 768
    n_small = 9
    apex = n_main + n_small  # 777; total 778

    faces = []
    for r in range(nrings - 1):
        for s in range(nseg):
            a = r * nseg + s
            b = r * nseg + (s + 1) % nseg
            c = (r + 1) * nseg + s
            d = (r + 1) * nseg + (s + 1) % nseg
            faces.append([a, b, d])
            faces.append([a, d, c])
    # bridge 16-ring (last main ring) -> 9-ring: m + n = 25 triangles
    big = [(nrings - 1) * nseg + s for s in range(nseg)]
    small = [n_main + s for s in range(n_small)]
    i = j = 0
    while i < nseg or j < n_small:
        # advance whichever loop is "behind" in angular progress
        if j >= n_small or (i < nseg and (i + 1) / nseg <= (j + 1) / n_small):
            faces.append([big[i % nseg], big[(i + 1) % nseg], small[j % n_small]])
            i += 1
        else:
            faces.append([big[i % nseg], small[(j + 1) % n_small], small[j % n_small]])
            j += 1
    # cap 9-ring with apex
    for s in range(n_small):
        faces.append([small[s], small[(s + 1) % n_small], apex])
    faces = np.array(faces, dtype=np.int64)
    assert faces.shape[0] == 1538, faces.shape

    # permute indices so the wrist boundary (ring 0, positions 0..15) receives
    # the canonical seal ring ids in circular order
    perm = -np.ones(NUM_VERTS, dtype=np.int64)
    for pos, vid in enumerate(_SEAL_RING):
        perm[pos] = vid
    free = sorted(set(range(NUM_VERTS)) - set(_SEAL_RING))
    fi = 0
    for old in range(NUM_VERTS):
        if perm[old] < 0:
            perm[old] = free[fi]
            fi += 1
    faces = perm[faces]
    return perm, faces, nseg, nrings, n_small


def build_synthetic_mano(is_rhand: bool, seed: int = 0) -> ManoModelData:
    rng = np.random.RandomState(seed)
    perm, faces, nseg, nrings, n_small = _synthetic_topology()

    # geometry: hand ~18cm long along +y, flattened in z, widest mid-palm
    verts = np.zeros((NUM_VERTS, 3), dtype=np.float64)
    t_ring = np.linspace(0.0, 1.0, nrings)
    for r in range(nrings):
        t = t_ring[r]
        radius = 0.045 * (0.55 + 0.9 * np.sin(np.pi * min(t * 1.15, 1.0)) ** 0.8 + 0.05)
        for s in range(nseg):
            ang = 2 * np.pi * s / nseg
            old = r * nseg + s
            verts[perm[old]] = [
                radius * np.cos(ang),
                0.18 * t,
                0.55 * radius * np.sin(ang),
            ]
    for s in range(n_small):
        ang = 2 * np.pi * s / n_small
        verts[perm[nseg * nrings + s]] = [
            0.018 * np.cos(ang),
            0.184,
            0.010 * np.sin(ang),
        ]
    verts[perm[-1]] = [0.0, 0.19, 0.0]

    if not is_rhand:
        verts[:, 0] *= -1.0
        faces = faces[:, [0, 2, 1]]

    # joints: wrist + 5 chains of 3 spread across the "finger" region
    joints = np.zeros((NUM_JOINTS, 3))
    joints[0] = [0.0, 0.015, 0.0]
    chain_x = {1: 0.02, 4: 0.0, 7: -0.04, 10: -0.02, 13: 0.045}  # idx/mid/pinky/ring/thumb
    for root, x in chain_x.items():
        for k in range(3):
            joints[root + k] = [x * (1 if is_rhand else -1), 0.095 + 0.03 * k, 0.0]

    # J_regressor: gaussian weights over nearest template verts
    d2 = ((verts[None, :, :] - joints[:, None, :]) ** 2).sum(-1)
    Jreg = np.exp(-d2 / (2 * 0.02**2))
    Jreg /= Jreg.sum(axis=1, keepdims=True)

    # skinning weights: smooth softmax over joint distances
    sigma = 0.03
    W = np.exp(-d2.T / (2 * sigma**2))
    W /= W.sum(axis=1, keepdims=True)

    shapedirs = rng.randn(NUM_VERTS, 3, NUM_BETAS) * 1.5e-3
    posedirs = rng.randn(135, NUM_VERTS * 3) * 2.0e-4
    hands_mean = rng.randn(POSE_DIM) * 0.1

    return ManoModelData(
        v_template=verts.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        J_regressor=Jreg.astype(np.float32),
        parents=PARENTS,
        lbs_weights=W.astype(np.float32),
        hands_mean=hands_mean.astype(np.float32),
        faces=faces,
        is_rhand=is_rhand,
        synthetic=True,
    )


def load_mano(is_rhand: bool) -> ManoModelData:
    """The synthetic hand model (the MANO .pkl files are licensed and not in
    the repository)."""
    return build_synthetic_mano(is_rhand)
