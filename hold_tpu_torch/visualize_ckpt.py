"""Checkpoint visualization entry point:

    python -m hold_tpu_torch.visualize_ckpt --exp <logs/key> --case <seq> [--device cuda|cpu]

Counterpart of hold_tpu/visualize_ckpt.py (the reference's
code/visualize_ckpt.py + common/viewer.py, aitviewer based, which has no
headless form): the posed MANO and object meshes of every frame come from
the port's servers on the card (unless ``--device cpu``); on the host they
are painted onto the source frames (``overlay_mesh``, cv2), written as
per-frame PNGs and ``overlay.mp4``, and packed into the self-contained
``viewer.html`` (``render/html_viewer.py``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def overlay_mesh(img: np.ndarray, verts_cam: np.ndarray, faces: np.ndarray,
                 K: np.ndarray, color, alpha=0.6):
    """The painter's algorithm: faces far to near, flat-shaded by a fixed
    light, blended over ``img`` (uint8 RGB) at ``alpha``."""
    import cv2

    layer = img.copy()
    z = np.maximum(verts_cam[:, 2], 1e-6)
    u = verts_cam[:, 0] * K[0, 0] / z + K[0, 2]
    v = verts_cam[:, 1] * K[1, 1] / z + K[1, 2]
    uv = np.stack([u, v], 1)
    depth = np.linalg.norm(verts_cam, axis=1)
    tri_depth = depth[faces].mean(1)
    order = np.argsort(-tri_depth)
    v0 = verts_cam[faces[:, 0]]
    v1 = verts_cam[faces[:, 1]]
    v2 = verts_cam[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    light = np.array([0.2, -0.4, -0.9])
    light /= np.linalg.norm(light)
    shade = 0.5 + 0.5 * np.abs(n @ light)
    for fi in order:
        if (verts_cam[faces[fi], 2] <= 1e-6).any():
            continue
        tri = uv[faces[fi]].astype(np.int32)
        c = tuple(int(min(255, ch * shade[fi])) for ch in color)
        cv2.fillPoly(layer, [tri], c)
    return cv2.addWeighted(layer, alpha, img, 1 - alpha, 0)


@torch.no_grad()
def posed_meshes(params, misc, scene, seq, device) -> dict:
    """node id -> (every frame's posed vertices (F, V, 3) on the host, faces):
    the MANO servers at the pose tables, the object server on the canonical
    mesh (decimated to 8,000 faces) when meshing made one."""
    from .mano.server import mano_server_forward
    from .models.object_model import build_object_server, object_server_forward
    from .utils.mesh import decimate_mesh

    n = seq.n_frames
    scale = torch.full((n,), seq.scale, device=device)
    meshes = {}
    for nid in scene.node_ids:
        tables = params[nid]["tables"]
        if nid in ("right", "left"):
            srv = scene.servers[nid]
            thetas = torch.cat([tables["global_orient"], tables["pose"]], dim=-1)
            o = mano_server_forward(srv, scale, tables["transl"], thetas,
                                    tables["betas"].expand(n, 10))
            meshes[nid] = (o.verts.cpu().numpy(), np.asarray(srv.consts.faces))
        else:
            mc = misc.get("meshes_cano", {}).get("object")
            if mc is None:
                continue
            m = decimate_mesh(mc["vertices"], mc["faces"], 8000)
            srv = build_object_server(m.vertices, float(params[nid]["obj_scale"]), np.eye(4),
                                      device)
            o = object_server_forward(srv, scale, tables["transl"], tables["global_orient"])
            meshes[nid] = (o.verts.cpu().numpy(), m.faces)
    return meshes


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", required=True)
    ap.add_argument("--case", required=True)
    ap.add_argument("--data_root", default="./data")
    ap.add_argument("--out", default="")
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--headless", action="store_true", default=True)
    ap.add_argument("--no_html", action="store_true",
                    help="skip the interactive HTML viewer export")
    ap.add_argument("--html_max_frames", type=int, default=120)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> str:
    """Writes the overlays, the mp4 and the viewer; returns the output dir."""
    import cv2

    from .data.dataset import SequenceData
    from .eval.io_pred import load_experiment
    from .utils.config import resolve_device

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    seq = SequenceData.from_build_dir(args.case, args.data_root)
    params, misc, scene = load_experiment(args.exp, seq, device)
    out_dir = args.out or os.path.join(args.exp, "viewer")
    os.makedirs(out_dir, exist_ok=True)

    n = seq.n_frames
    w2c_all = np.stack([np.linalg.inv(e) for e in seq.extrinsics_all])
    K = seq.intrinsics_all[0][:3, :3]
    meshes = posed_meshes(params, misc, scene, seq, device)

    colors = {"right": (255, 180, 140), "left": (140, 180, 255),
              "object": (120, 220, 120)}
    H, W = seq.img_size
    video = cv2.VideoWriter(
        os.path.join(out_dir, "overlay.mp4"),
        cv2.VideoWriter_fourcc(*"mp4v"), args.fps, (W, H),
    )
    images = []
    for i in range(n):
        img, _ = seq.load_frame(i)
        images.append((img * 255).astype(np.uint8))
        frame = images[-1].copy()
        w2c = w2c_all[i]
        for nid, (verts_all, faces) in meshes.items():
            v_cam = verts_all[i] @ w2c[:3, :3].T + w2c[:3, 3]
            frame = overlay_mesh(frame, v_cam, faces, K, colors[nid])
        cv2.imwrite(os.path.join(out_dir, f"{i:04d}.png"), frame[:, :, ::-1])
        video.write(frame[:, :, ::-1])
    video.release()
    print(f"wrote {n} overlay frames + overlay.mp4 to {out_dir}")

    if not args.no_html:
        # interactive substitute for the aitviewer scene (viewer.py:42-301):
        # orbit-able posed meshes + camera path + billboarded source video,
        # one self-contained file
        from .render.html_viewer import export_html_viewer, pack_scene

        blob = pack_scene(
            meshes, w2c_all, K, seq.img_size, images=images,
            max_frames=args.html_max_frames,
        )
        p = export_html_viewer(
            os.path.join(out_dir, "viewer.html"), blob,
            title=f"hold_tpu {args.case}",
        )
        print(f"wrote interactive viewer {p}")
    return out_dir


if __name__ == "__main__":
    main()
