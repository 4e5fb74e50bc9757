"""Hand-object alignment: 3-stage optimization (h -> o -> ho) (counterpart of
hold_tpu/generator/align.py).

The generator's alignment stage (generator/scripts/align_hands_object.py:
20-110 + generator/src/alignment/pl_module/* of the reference):
- mode 'h':  hand 2D-keypoint reprojection with a GMoF robust kernel
- mode 'o':  object: centroid-contact to the hand + 2D point reprojection +
             in-front-of-camera hinge; the SfM scene scale unlocks after a
             warmup (generic_module.py staged requires_grad)
- mode 'ho': joint refinement + temporal smoothness on all trajectories

Each stage is an Adam loop over one parameter tree with per-stage
trainability labels, on the device of the problem.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..fitting.fit import detached, trainable_copy
from ..mano.lbs import lbs_forward, mano_full_pose
from ..mano.server import build_mano_server


def gmof(x: torch.Tensor, sigma: float = 100.0) -> torch.Tensor:
    """Geman-McClure robust kernel on squared residuals."""
    x2 = x**2
    return (sigma**2) * x2 / (sigma**2 + x2)


def project(K: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(pts[..., 2:3], min=1e-6)
    return pts[..., :2] / z * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])


def _merge(p, init):
    """``p`` with each leaf that ``init`` gives (not None) replaced."""
    if isinstance(p, dict):
        return {k: _merge(v, init.get(k)) if init is not None else v for k, v in p.items()}
    if init is None:
        return p
    return torch.as_tensor(np.asarray(init) if not torch.is_tensor(init) else init,
                           dtype=torch.float32, device=p.device)


class AlignmentProblem:
    def __init__(
        self,
        j2d_target: dict[str, np.ndarray],  # hand -> (F, 21, 2) 2D keypoints
        obj_pts2d: np.ndarray | None,  # (F, M, 2) tracked SfM keypoints
        obj_pts_cano: np.ndarray | None,  # (M, 3) canonical SfM points
        K: np.ndarray,  # (3, 3)
        hands=("right",),
        model_dir: str | None = None,
        weights: dict | None = None,
        device=None,
    ):
        self.device = device
        self.hands = list(hands)
        self.servers = {
            h: build_mano_server(h == "right", np.zeros(10), model_dir, device=device)
            for h in self.hands
        }

        def f32(x):
            return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)

        self.j2d_target = {h: f32(v) for h, v in j2d_target.items()}
        self.obj_pts2d = f32(obj_pts2d) if obj_pts2d is not None else None
        self.obj_pts_cano = f32(obj_pts_cano) if obj_pts_cano is not None else None
        self.K = f32(K)
        # loss weights following generator/confs/generic.yaml roles
        self.w = dict(
            j2d=1.0, o2d=1.0, contact=10.0, front=100.0, smooth=100.0,
        )
        if weights:
            self.w.update(weights)

    def init_params(self, n_frames: int, init: dict | None = None) -> dict:
        dev = self.device
        p: dict[str, Any] = {"obj_scale_log": torch.zeros((), device=dev)}
        for h in self.hands:
            p[h] = {
                "global_orient": torch.zeros((n_frames, 3), device=dev),
                "pose": torch.zeros((n_frames, 45), device=dev),
                "transl": torch.tensor([0.0, 0.0, 0.6], device=dev).repeat(n_frames, 1),
                "betas": torch.zeros((10,), device=dev),
            }
        p["object"] = {
            "global_orient": torch.zeros((n_frames, 3), device=dev),
            "transl": torch.tensor([0.0, 0.0, 0.6], device=dev).repeat(n_frames, 1),
        }
        if init:
            p = _merge(p, init)
        return p

    def hand_joints(self, p: dict, h: str) -> torch.Tensor:
        srv = self.servers[h]
        F = p[h]["transl"].shape[0]
        full = mano_full_pose(srv.consts, p[h]["global_orient"], p[h]["pose"])
        out = lbs_forward(srv.consts, p[h]["betas"].expand(F, 10), full)
        return out.joints + p[h]["transl"][:, None]

    def object_pts(self, p: dict) -> torch.Tensor:
        from ..utils.rot import axis_angle_to_matrix

        R = axis_angle_to_matrix(p["object"]["global_orient"])
        s = torch.exp(p["obj_scale_log"])
        return (
            torch.einsum("fij,mj->fmi", R, self.obj_pts_cano * s)
            + p["object"]["transl"][:, None]
        )

    def loss(self, p: dict, mode: str, scale_unlocked: bool) -> torch.Tensor:
        total = 0.0
        if mode in ("h", "ho"):
            for h in self.hands:
                j3d = self.hand_joints(p, h)
                j2d = project(self.K, j3d)
                total = total + self.w["j2d"] * torch.mean(
                    gmof(j2d - self.j2d_target[h]).sum(-1)
                )
        if mode in ("o", "ho") and self.obj_pts_cano is not None:
            pts = self.object_pts(p)
            if self.obj_pts2d is not None:
                o2d = project(self.K, pts)
                total = total + self.w["o2d"] * torch.mean(
                    gmof(o2d - self.obj_pts2d).sum(-1)
                )
            # centroid contact: object centroid near the hand root trajectory
            centroid = pts.mean(dim=1)
            for h in self.hands:
                j3d = self.hand_joints(p, h).detach()
                total = total + self.w["contact"] * torch.mean(
                    torch.sum((centroid - j3d[:, 0]) ** 2, -1)
                )
            # in-front-of-camera hinge
            total = total + self.w["front"] * torch.mean(
                torch.clamp(0.05 - pts[..., 2], min=0.0)
            )
        if mode == "ho":
            # temporal smoothness on all trajectories
            for h in self.hands:
                t = p[h]["transl"]
                total = total + self.w["smooth"] * torch.mean(
                    torch.sum((t[1:] - t[:-1]) ** 2, -1)
                )
            t = p["object"]["transl"]
            total = total + self.w["smooth"] * torch.mean(
                torch.sum((t[1:] - t[:-1]) ** 2, -1)
            )
        return total

    def trainable(self, mode: str, scale_unlocked: bool):
        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            root = path[0] if path else ""
            if root == "obj_scale_log":
                return "free" if (mode in ("o", "ho") and scale_unlocked) else "frozen"
            if root == "object":
                return "free" if mode in ("o", "ho") else "frozen"
            # hands
            return "free" if mode in ("h", "ho") else "frozen"

        return walk

    def fit(self, p: dict, mode: str, iters: int = 2000, lr: float = 1e-2,
            scale_unlock_at: int = 2000) -> dict:
        """Adam in two phases, the scale locked then unlocked, each with fresh
        Adam state and its learning rate restarting at ``lr``; the rate
        halves at every 1,000th global iteration.  ``self.history`` holds
        every iteration's loss."""
        history = []
        for phase, (start, end) in enumerate(
            [(0, min(scale_unlock_at, iters)), (min(scale_unlock_at, iters), iters)]
        ):
            if end <= start:
                continue
            unlocked = phase == 1
            p, free = trainable_copy(p, self.trainable(mode, unlocked)(p, ()))
            opt = torch.optim.Adam(free, lr=lr)
            cur_lr = lr
            for i in range(start, end):
                if i > 0 and i % 1000 == 0:
                    cur_lr *= 0.5  # staged lr decay (generic_module role)
                opt.zero_grad()
                loss = torch.as_tensor(self.loss(p, mode, unlocked))
                if loss.requires_grad:  # else no term of this mode applies
                    loss.backward()
                opt.param_groups[0]["lr"] = cur_lr
                opt.step()
                history.append(float(loss.detach()))
        self.history = history
        return detached(p)
