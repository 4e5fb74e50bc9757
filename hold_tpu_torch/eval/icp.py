"""Multi-restart scaled ICP alignment for the CD_icp / F_icp metrics (host-side;
a copy of hold_tpu/eval/icp.py, so that the port imports nothing of the JAX
package).

The reference leans on open3d (FPFH RANSAC global registration + point-to-
point ICP with scaling, many restarts — code/src/utils/icp.py:113-199);
open3d isn't in this image, so this is a from-scratch scipy/numpy equivalent
engineered to match or beat the reference's alignment quality:

- global initialisation: identity + the 24 proper rotations aligning the PCA
  frames of source and target (plays the role of the reference's FPFH-RANSAC
  hypotheses — deterministic and much stronger on elongated/flat objects),
  then random-rotation restarts for the remaining budget;
- refinement stage 1: point-to-point scaled-Umeyama ICP with an annealed
  correspondence threshold (loose -> tight, replacing the fixed threshold
  that stalled on bad inits);
- refinement stage 2: point-to-plane polish (normals from the sampled faces;
  linearised [rotation, translation, scale] least squares), which converges
  past the point-to-point floor on smooth/thin geometry;
- acceptance: the restart with the best chamfer wins (same criterion as the
  reference's best-CD-over-restarts loop).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from .metrics import chamfer_f_scores


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng: np.random.RandomState,
                   return_normals: bool = False):
    """Area-weighted uniform surface sampling (optionally with face normals)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    if area.sum() <= 0:
        idx = rng.randint(0, verts.shape[0], n)
        pts = verts[idx].astype(np.float64)
        if return_normals:
            return pts, np.tile([0.0, 0.0, 1.0], (n, 1))
        return pts
    fidx = rng.choice(faces.shape[0], n, p=area / area.sum())
    u = rng.rand(n, 1)
    v = rng.rand(n, 1)
    flip = (u + v) > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    pts = (u * v0[fidx] + v * v1[fidx] + (1 - u - v) * v2[fidx]).astype(
        np.float64
    )
    if return_normals:
        nrm = cross[fidx]
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                               1e-12)
        return pts, nrm
    return pts


def umeyama(src: np.ndarray, dst: np.ndarray, with_scaling: bool = True):
    """Least-squares similarity transform src -> dst (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scaling:
        var_s = (sc**2).sum() / src.shape[0]
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _correspondences(cur, tgt_tree, thresh):
    d, idx = tgt_tree.query(cur)
    keep = d < thresh
    if keep.sum() < 10:
        keep = np.argsort(d)[: max(int(0.5 * len(d)), 10)]
    return keep, idx


def icp_point_to_point(src, tgt_tree, tgt, init_R, thresholds,
                       iters_per_stage: int = 12, with_scaling: bool = True):
    """Scaled point-to-point ICP with threshold annealing.

    `thresholds` is a loose->tight sequence of correspondence radii; each
    stage runs up to `iters_per_stage` Umeyama updates."""
    s_tot, R_tot, t_tot = 1.0, init_R.copy(), np.zeros(3)
    cur = src @ init_R.T
    for thresh in thresholds:
        for _ in range(iters_per_stage):
            keep, idx = _correspondences(cur, tgt_tree, thresh)
            s, R, t = umeyama(cur[keep], tgt[idx[keep]], with_scaling)
            cur = s * cur @ R.T + t
            R_tot = R @ R_tot
            s_tot = s * s_tot
            t_tot = s * R @ t_tot + t
            if abs(s - 1) < 1e-7 and np.abs(R - np.eye(3)).max() < 1e-7 and \
               np.linalg.norm(t) < 1e-9:
                break
    return s_tot, R_tot, t_tot


def _rodrigues(w: np.ndarray) -> np.ndarray:
    ang = np.linalg.norm(w)
    if ang < 1e-12:
        return np.eye(3)
    a = w / ang
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)


def icp_point_to_plane(src, tgt_tree, tgt, tgt_normals, s0, R0, t0,
                       thresh: float, max_iters: int = 15,
                       with_scaling: bool = True):
    """Point-to-plane polish from a (s0, R0, t0) similarity estimate.

    Linearised residual per correspondence:
      ((1+sigma) p + omega x p + t - q) . n
    solved for x = [omega, t, sigma] by least squares each iteration."""
    s_tot, R_tot, t_tot = s0, R0.copy(), t0.copy()
    cur = s0 * src @ R0.T + t0
    for _ in range(max_iters):
        keep, idx = _correspondences(cur, tgt_tree, thresh)
        p = cur[keep]
        q = tgt[idx[keep]]
        n = tgt_normals[idx[keep]]
        cols = [np.cross(p, n), n]
        if with_scaling:
            cols.append((p * n).sum(1, keepdims=True))
        A = np.concatenate(cols, axis=1)
        b = -((p - q) * n).sum(1)
        x, *_ = np.linalg.lstsq(A, b, rcond=None)
        w, dt = x[:3], x[3:6]
        ds = x[6] if with_scaling else 0.0
        dR = _rodrigues(w)
        scale = 1.0 + ds
        cur = scale * cur @ dR.T + dt
        R_tot = dR @ R_tot
        s_tot = scale * s_tot
        t_tot = scale * dR @ t_tot + dt
        if np.linalg.norm(x) < 1e-10:
            break
    return s_tot, R_tot, t_tot


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _octahedral_rotations() -> list[np.ndarray]:
    """The 24 proper rotations of the signed-permutation (octahedral) group."""
    out = []
    for perm in ([0, 1, 2], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 0, 1],
                 [2, 1, 0]):
        P = np.eye(3)[list(perm)]
        for sx in (1, -1):
            for sy in (1, -1):
                for sz in (1, -1):
                    R = np.diag([sx, sy, sz]).astype(np.float64) @ P
                    if np.linalg.det(R) > 0:
                        out.append(R)
    return out


def pca_frame(pts: np.ndarray) -> np.ndarray:
    """Right-handed principal-axis frame (columns = axes, by eigenvalue)."""
    c = pts - pts.mean(0)
    _, _, Vt = np.linalg.svd(c, full_matrices=False)
    U = Vt.T
    if np.linalg.det(U) < 0:
        U[:, 2] = -U[:, 2]
    return U


def pca_init_rotations(src_pts: np.ndarray, tgt_pts: np.ndarray):
    """24 deterministic global-init hypotheses: rotate the source PCA frame
    onto the target PCA frame through every octahedral axis matching."""
    U_s = pca_frame(src_pts)
    U_t = pca_frame(tgt_pts)
    return [U_t @ S @ U_s.T for S in _octahedral_rotations()]


def compute_icp_metrics(
    tgt_verts: np.ndarray, tgt_faces: np.ndarray,
    src_verts: np.ndarray, src_faces: np.ndarray,
    num_iters: int = 600, n_sample: int = 1000, seed: int = 0,
):
    """Best (cd cm^2, f5 fraction, f10 fraction) over ICP restarts — role
    parity with the reference's compute_icp_metrics (best CD wins; the caller
    multiplies f* by 100, eval_modules.py:70-71)."""
    rng = np.random.RandomState(seed)
    src_verts = np.asarray(src_verts, np.float64)
    tgt_verts = np.asarray(tgt_verts, np.float64)
    src_c = src_verts - src_verts.mean(0)
    tgt_c = tgt_verts - tgt_verts.mean(0)

    src_pts = sample_surface(src_c, src_faces, n_sample, rng)
    tgt_pts, tgt_nrm = sample_surface(tgt_c, tgt_faces, n_sample, rng,
                                      return_normals=True)
    tree = cKDTree(tgt_pts)

    # correspondence radii scale with the scene: anneal from a quarter of the
    # target's bounding diagonal down to ~voxel scale
    diag = float(np.linalg.norm(tgt_pts.max(0) - tgt_pts.min(0)))
    thresholds = [0.25 * diag, 0.10 * diag, 0.04 * diag, 0.015 * diag]

    def metrics_for(s, R, t):
        aligned = s * src_c @ R.T + t
        cd, f5, f10 = chamfer_f_scores(aligned, tgt_c)
        return cd, f5 / 100.0, f10 / 100.0

    def run_from(R0):
        """Both refinement stages; yields each stage's estimate.

        The acceptance below takes the best CD over BOTH stages: under
        partial overlap the p2pl linearisation can be dragged off the true
        pose by correspondences into the missing region (measured: p2p CD
        1.08 -> p2pl 1.71 on a 30%-cropped fixture), and the reference's
        best-CD-over-restarts loop equally never accepts a refinement that
        worsened its score."""
        s, R, t = icp_point_to_point(src_pts, tree, tgt_pts, R0, thresholds)
        yield s, R, t
        yield icp_point_to_plane(src_pts, tree, tgt_pts, tgt_nrm,
                                 s, R, t, thresholds[-1])

    inits = [np.eye(3)] + pca_init_rotations(src_pts, tgt_pts)
    n_random = max(num_iters - len(inits) + 1, 0)
    inits += [random_rotation(rng) for _ in range(n_random)]

    best = None
    for R0 in inits:
        for est in run_from(R0):
            m = metrics_for(*est)
            if best is None or m[0] < best[0]:
                best = m
    return best
