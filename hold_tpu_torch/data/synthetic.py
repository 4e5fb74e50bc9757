"""Synthetic sequence generator (counterpart of hold_tpu/data/synthetic.py).

Builds the same scene as the JAX package (the synthetic MANO hand holding an
icosphere, an orbiting camera) in memory: images, masks and the ``data.npy``
dict.  Triangles are filled by a numpy rasteriser (painter's order, pixel
centres on or inside the projected triangle) in place of ``cv2.fillPoly``.
Writing the build dir (PNGs) is optional and imports cv2 then.

Run: python -m hold_tpu_torch.data.synthetic --out ./data/toy --frames 12
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils.mesh import SEAL_CIRCLE_V_ID, seal_mano_faces

from ..mano.server import build_mano_server, mano_server_forward
from ..utils.rot import axis_angle_to_matrix


def _project(P: np.ndarray, pts: np.ndarray) -> np.ndarray:
    ph = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    uvw = (P @ ph.T).T
    return uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-8)


def _draw_edges(img: np.ndarray, tri: np.ndarray, value) -> None:
    """The triangle's three edges, one pixel per step of the longer axis
    (what cv2's polygon fill adds around the exact interior)."""
    H, W = img.shape[:2]
    for p, q in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
        n = int(np.abs(q - p).max()) + 1
        xy = np.round(np.linspace(p, q, n)).astype(np.int64)
        ok = (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H)
        img[xy[ok, 1], xy[ok, 0]] = value


def fill_triangle(img: np.ndarray, tri: np.ndarray, value) -> None:
    """Set the pixels of the integer triangle ``tri`` (3, 2) of (x, y)
    coords to ``value``: every pixel centre on or inside it, plus its edges."""
    H, W = img.shape[:2]
    _draw_edges(img, tri, value)
    x0, y0 = np.maximum(tri.min(axis=0), 0)
    x1, y1 = np.minimum(tri.max(axis=0), [W - 1, H - 1])
    (ax, ay), (bx, by), (cx, cy) = tri.astype(np.int64)
    if x0 > x1 or y0 > y1 or (bx - ax) * (cy - ay) - (by - ay) * (cx - ax) == 0:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    e0 = (bx - ax) * (ys - ay) - (by - ay) * (xs - ax)
    e1 = (cx - bx) * (ys - by) - (cy - by) * (xs - bx)
    e2 = (ax - cx) * (ys - cy) - (ay - cy) * (xs - cx)
    inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    img[y0:y1 + 1, x0:x1 + 1][inside] = value


def _raster_mesh(img, mask, P, verts, faces, color, segm_id, cam_loc):
    """Painter's-algorithm rasterisation with Lambert-shaded faces."""
    uv = _project(P, verts)
    depth = np.linalg.norm(verts - cam_loc[None], axis=1)
    order = np.argsort(-depth[faces].mean(axis=1))  # far to near
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    light = np.array([0.3, -0.5, -0.8])
    light /= np.linalg.norm(light)
    shade = 0.55 + 0.45 * np.abs(n @ light)
    for fi in order:
        tri = uv[faces[fi]].astype(np.int32)
        c = [int(min(255, max(0, ch * shade[fi]))) for ch in color]
        fill_triangle(img, tri, c)
        fill_triangle(mask, tri, int(segm_id))


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


def generate_sequence(out_dir: str | None = None, n_frames: int = 12,
                      img_hw: tuple[int, int] = (240, 320), two_hands: bool = False) -> dict:
    """Render the synthetic hand+object sequence.

    Returns {"images": (N,H,W,3) uint8 RGB, "masks": (N,H,W) uint8,
    "data": the data.npy dict}.  With ``out_dir`` it also writes
    ``out_dir/build/{image,mask}/*.png``, ``data.npy`` and ``corres.txt``."""
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
        for _, v, fc, col, sid in draw_list:
            _raster_mesh(img, masks[i], world_mat[:3], v, fc, col, sid, cam_pos)

    data = {
        "cameras": cameras,
        "entities": entities,
        "scene_bounding_sphere": 3.0,
        "normalize_shift": np.zeros(3, np.float32),
    }
    seq = {"images": images, "masks": masks, "data": data}
    if out_dir is not None:
        write_build(out_dir, seq)
    return seq


def write_build(out_dir: str, seq: dict) -> str:
    """Write ``out_dir/build`` in the layout SequenceData reads."""
    import cv2

    build = os.path.join(out_dir, "build")
    os.makedirs(os.path.join(build, "image"), exist_ok=True)
    os.makedirs(os.path.join(build, "mask"), exist_ok=True)
    for i, (img, mask) in enumerate(zip(seq["images"], seq["masks"])):
        cv2.imwrite(os.path.join(build, "image", f"{i:04d}.png"), img[:, :, ::-1])
        cv2.imwrite(os.path.join(build, "mask", f"{i:04d}.png"), mask)
    np.save(os.path.join(build, "data.npy"), seq["data"])
    with open(os.path.join(build, "corres.txt"), "w") as fh:
        for i in range(len(seq["images"])):
            fh.write(f"{i:04d}.png\n")
    return build


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--two_hands", action="store_true")
    args = ap.parse_args()
    generate_sequence(args.out, args.frames, (args.height, args.width), args.two_hands)
    print(f"Wrote synthetic sequence to {os.path.join(args.out, 'build')}")


if __name__ == "__main__":
    main()
