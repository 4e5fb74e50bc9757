"""The benchmark's input sequence: a frozen copy of the port's synthetic
sequence generator (``hold_tpu_torch/data/synthetic.py``), in memory only.

The synthetic MANO hand (one or two) holding an icosphere, an orbiting
camera: images, masks and the ``data.npy`` dict.  Triangles are filled by a
numpy rasteriser (painter's order, pixel centres on or inside the projected
triangle, plus its edges), vectorised over the faces.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .reference.mano import build_mano_server, mano_server_forward
from .reference.mesh import SEAL_CIRCLE_V_ID, seal_mano_faces
from .reference.rot import axis_angle_to_matrix


def _project(P: np.ndarray, pts: np.ndarray) -> np.ndarray:
    ph = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    uvw = (P @ ph.T).T
    return uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-8)


def _edge_pixels(tri: np.ndarray, H: int, W: int):
    """(flat pixel, face) pairs of every face's three edges, one pixel per
    step of the longer axis (what cv2's polygon fill adds around the exact
    interior).  tri (F, 3, 2) integer (x, y)."""
    p = tri.reshape(-1, 2).astype(np.float64)
    q = tri[:, [1, 2, 0]].reshape(-1, 2).astype(np.float64)
    n = np.abs(q - p).max(axis=1).astype(np.int64) + 1
    t = np.arange(n.max())[None, :] / np.maximum(n - 1, 1)[:, None]
    xy = np.round(p[:, None] + (q - p)[:, None] * t[..., None]).astype(np.int64)
    ok = ((np.arange(n.max())[None, :] < n[:, None]) & (xy[..., 0] >= 0) & (xy[..., 0] < W)
          & (xy[..., 1] >= 0) & (xy[..., 1] < H))
    face = np.repeat(np.arange(tri.shape[0]), 3)[:, None].repeat(n.max(), axis=1)
    return (xy[..., 1] * W + xy[..., 0])[ok], face[ok]


def _interior_pixels(tri: np.ndarray, H: int, W: int, group: int = 512):
    """(flat pixel, face) pairs of every pixel centre on or inside each
    non-degenerate face, faces in groups of like bounding boxes."""
    lo = np.maximum(tri.min(axis=1), 0)
    hi = np.minimum(tri.max(axis=1), [W - 1, H - 1])
    a, b, c = (tri[:, i].astype(np.int64) for i in range(3))
    area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    live = np.nonzero((lo <= hi).all(axis=1) & (area != 0))[0]
    size = (hi - lo + 1)[live]
    live = live[np.argsort(size.max(axis=1), kind="stable")]
    pix, fid = [], []
    for s in range(0, live.size, group):
        f = live[s:s + group]
        w, h = (hi[f] - lo[f] + 1).max(axis=0)
        xs = lo[f, 0, None, None] + np.arange(w)[None, None, :]
        ys = lo[f, 1, None, None] + np.arange(h)[None, :, None]
        ax, ay, bx, by, cx, cy = (v[f, None, None] for v in
                                  (a[:, 0], a[:, 1], b[:, 0], b[:, 1], c[:, 0], c[:, 1]))
        e0 = (bx - ax) * (ys - ay) - (by - ay) * (xs - ax)
        e1 = (cx - bx) * (ys - by) - (cy - by) * (xs - bx)
        e2 = (ax - cx) * (ys - cy) - (ay - cy) * (xs - cx)
        inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
        inside &= (xs <= hi[f, 0, None, None]) & (ys <= hi[f, 1, None, None])
        k, yy, xx = np.nonzero(inside)
        pix.append((lo[f[k], 1] + yy) * W + lo[f[k], 0] + xx)
        fid.append(f[k])
    if not pix:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(pix), np.concatenate(fid)


def _raster_meshes(img, mask, P, meshes, cam_loc):
    """Painter's-algorithm rasterisation with Lambert-shaded faces: the
    meshes in the given order, each one's faces far to near, a pixel taking
    the last face that covers it (its edges included)."""
    H, W = mask.shape
    owner = np.full(H * W, -1, np.int64)
    colours, segms, base = [], [], 0
    light = np.array([0.3, -0.5, -0.8])
    light /= np.linalg.norm(light)
    for verts, faces, color, segm_id in meshes:
        uv = _project(P, verts)
        depth = np.linalg.norm(verts - cam_loc[None], axis=1)
        order = np.argsort(-depth[faces].mean(axis=1))  # far to near
        v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        n = np.cross(v1 - v0, v2 - v0)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
        shade = (0.55 + 0.45 * np.abs(n @ light))[order]
        tri = uv[faces[order]].astype(np.int32)
        for pix, f in (_edge_pixels(tri, H, W), _interior_pixels(tri, H, W)):
            np.maximum.at(owner, pix, base + f)
        colours.append(np.clip(np.asarray(color)[None] * shade[:, None], 0, 255).astype(np.int64))
        segms.append(np.full(len(faces), int(segm_id)))
        base += len(faces)
    hit = owner >= 0
    img.reshape(-1, 3)[hit] = np.concatenate(colours)[owner[hit]]
    mask.reshape(-1)[hit] = np.concatenate(segms)[owner[hit]]


def _sphere_mesh(radius: float, n_sub: int = 2):
    """Icosphere (the JAX package's object mesh)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    for _ in range(n_sub):
        edge_mid: dict = {}
        new_faces = []
        verts = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                verts.append((np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0)
                edge_mid[key] = len(verts) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = np.array(new_faces)
        verts = np.array(verts)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return verts.astype(np.float32), faces.astype(np.int64)


def _seal_verts(verts: np.ndarray) -> np.ndarray:
    center = verts[..., SEAL_CIRCLE_V_ID, :].mean(axis=-2, keepdims=True)
    return np.concatenate([verts, center], axis=-2)


def _aa2mat(aa) -> np.ndarray:
    return axis_angle_to_matrix(torch.tensor(np.asarray(aa, np.float32)[None]))[0].numpy()


def generate_sequence(n_frames: int = 12,
                      img_hw: tuple[int, int] = (240, 320), two_hands: bool = False,
                      seed: int = 0, pose_noise: float = 0.0,
                      pose_noise_mode: str = "all") -> dict:
    """Render the synthetic hand+object sequence.

    Returns {"images": (N,H,W,3) uint8 RGB, "masks": (N,H,W) uint8,
    "data": the data.npy dict}.

    ``pose_noise`` > 0 simulates a real capture's noisy initialisation:
    images and masks come from the true poses, the ``entities`` that
    training starts from get Gaussian noise of this std (radians on
    rotations, ``pose_noise`` * 0.05 m on translations, drawn from
    ``RandomState(seed + 7)``), and the truth is kept as ``entities_gt`` for
    evaluation.  ``pose_noise_mode`` "all" perturbs the hand articulation
    and orientation, the translations and the object's rotation; "trans"
    only what pose refinement optimises (the hands' translations, the
    object's rotation and translation)."""
    H, W = img_hw
    K = np.eye(4, dtype=np.float64)
    f = 1.2 * W
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = f, f, W / 2, H / 2

    hands = ["right", "left"] if two_hands else ["right"]
    t_lin = np.linspace(0, 1, n_frames)
    entities: dict = {}
    hand_meshes: dict = {}
    for h in hands:
        srv = build_mano_server(h == "right", np.zeros(10))
        poses = np.zeros((n_frames, 48), np.float32)
        poses[:, 0] = 0.3 * np.sin(2 * np.pi * t_lin)
        poses[:, 2] = 0.2 * np.cos(2 * np.pi * t_lin)
        poses[:, 5] = 0.4 + 0.3 * np.sin(2 * np.pi * t_lin + 1.0)
        trans = np.stack(
            [
                0.06 * np.sin(2 * np.pi * t_lin) + (0.12 if h == "left" else 0.0),
                0.02 * np.cos(2 * np.pi * t_lin),
                0.55 + 0.05 * t_lin,
            ],
            axis=1,
        ).astype(np.float32)
        with torch.no_grad():
            out = mano_server_forward(srv, torch.ones(n_frames), torch.tensor(trans),
                                      torch.tensor(poses), torch.zeros((n_frames, 10)))
        hand_meshes[h] = (_seal_verts(out.verts.numpy()),
                          seal_mano_faces(srv.consts.faces, h == "right"))
        entities[h] = {
            "mean_shape": np.zeros(10, np.float32),
            "hand_poses": poses,
            "hand_trans": trans,
        }

    obj_scale = 2.0 * 0.05  # cano radius 0.5 -> world radius 0.05
    overts_c, ofaces = _sphere_mesh(0.5, 2)
    obj_poses = np.zeros((n_frames, 6), np.float32)
    obj_poses[:, 1] = 0.5 * t_lin
    obj_poses[:, 3:] = entities[hands[0]]["hand_trans"] + np.array([0.0, 0.09, 0.0], np.float32)
    entities["object"] = {
        "object_poses": obj_poses,
        "pts.cano": overts_c.astype(np.float32),
        "obj_scale": np.float32(obj_scale),
        "norm_mat": np.eye(4, dtype=np.float32),
        "faces": ofaces.astype(np.int64),
    }

    cameras = {}
    images = np.zeros((n_frames, H, W, 3), np.uint8)
    masks = np.zeros((n_frames, H, W), np.uint8)
    center = np.array([0.03, 0.03, 0.58])
    for i in range(n_frames):
        ang = 0.35 * np.sin(2 * np.pi * i / n_frames)
        cam_pos = center + _aa2mat([0.0, ang, 0.0]) @ np.array([0.0, 0.0, -0.58])
        fwd = center - cam_pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R_w2c = np.stack([right, np.cross(fwd, right), fwd])
        w2c = np.eye(4)
        w2c[:3, :3] = R_w2c
        w2c[:3, 3] = -R_w2c @ cam_pos
        world_mat = (K @ w2c).astype(np.float64)
        cameras[f"world_mat_{i}"] = world_mat
        cameras[f"scale_mat_{i}"] = np.eye(4, dtype=np.float64)

        img = images[i]
        grad = np.linspace(60, 140, H, dtype=np.uint8)
        img[:, :, 0] = grad[:, None]
        img[:, :, 1] = (grad[:, None] * 0.8).astype(np.uint8)
        img[:, :, 2] = 90
        overts_w = overts_c * obj_scale @ _aa2mat(obj_poses[i, :3]).T + obj_poses[i, 3:]
        draw_list = [("object", overts_w, ofaces, (40, 90, 200), 50)]
        for h in hands:
            v, fc = hand_meshes[h][0][i], hand_meshes[h][1]
            draw_list.append((h, v, fc, (180, 140, 110) if h == "right" else (110, 140, 180),
                              150 if h == "right" else 250))
        draw_list.sort(key=lambda e: -np.linalg.norm(e[1].mean(0) - cam_pos))
        _raster_meshes(img, masks[i], world_mat[:3], [d[1:] for d in draw_list], cam_pos)

    entities_gt = None
    if pose_noise > 0.0:
        entities_gt = copy.deepcopy(entities)
        nrng = np.random.RandomState(seed + 7)
        for h in hands:
            e = entities[h]
            if pose_noise_mode == "all":
                e["hand_poses"] = (e["hand_poses"] + nrng.randn(*e["hand_poses"].shape)
                                   * pose_noise).astype(np.float32)
            e["hand_trans"] = (e["hand_trans"] + nrng.randn(*e["hand_trans"].shape)
                               * pose_noise * 0.05).astype(np.float32)
        noise = np.concatenate([nrng.randn(n_frames, 3) * pose_noise,
                                nrng.randn(n_frames, 3) * pose_noise * 0.05], axis=1)
        entities["object"]["object_poses"] = (entities["object"]["object_poses"]
                                              + noise).astype(np.float32)

    data = {
        "cameras": cameras,
        "entities": entities,
        "scene_bounding_sphere": 3.0,
        "normalize_shift": np.zeros(3, np.float32),
    }
    if entities_gt is not None:
        data["entities_gt"] = entities_gt
    seq = {"images": images, "masks": masks, "data": data}
    return seq


def geodesic_sphere(radius: float, frequency: int):
    """A sphere tessellated as finely as a meshing pass leaves it: each face
    of the icosahedron cut into ``frequency``^2 triangles, projected onto
    the sphere.  (10 f^2 + 2 vertices, 20 f^2 faces.)"""
    base_v, base_f = _sphere_mesh(1.0, 0)
    n = int(frequency)
    ij = [(i, j) for i in range(n + 1) for j in range(n + 1 - i)]
    index = {p: k for k, p in enumerate(ij)}
    local = []
    for i in range(n):
        for j in range(n - i):
            local.append((index[(i, j)], index[(i + 1, j)], index[(i, j + 1)]))
            if i + j < n - 1:
                local.append((index[(i + 1, j)], index[(i + 1, j + 1)], index[(i, j + 1)]))
    ij, local = np.asarray(ij, np.float64), np.asarray(local, np.int64)
    pts, faces = [], []
    for a, b, c in base_f:
        va, vb, vc = (base_v[k].astype(np.float64) for k in (a, b, c))
        p = va[None] + (vb - va)[None] * ij[:, :1] / n + (vc - va)[None] * ij[:, 1:] / n
        faces.append(local + len(pts) * len(ij))
        pts.append(p / np.linalg.norm(p, axis=1, keepdims=True))
    pts, faces = np.concatenate(pts), np.concatenate(faces)
    _, first, inverse = np.unique(np.round(pts, 9), axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first)  # vertices in the order they were made
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    verts = pts[first[order]] * radius
    return verts.astype(np.float32), rank[inverse.reshape(-1)][faces].astype(np.int64)
