"""Pose refinement (stage 2): silhouette + contact fitting of pose tables
(counterpart of hold_tpu/fitting/fit.py).

- stage 1 optimises object scale + hand betas on a frame subsample,
- stage 2 refines per-frame translations / object orientation per batch,
- losses: cross-entity-masked silhouette L1 (x1000), fingertip-contact
  nearest-distance (x100), and for two-hand scenes 2D joint anchors +
  thresholded contact (the reference's fitting/loss.py:84-165),
- Adam with a reduce-on-plateau schedule and lr<1e-5 early stop
  (fitting/model.py:161-199), then a do-no-harm guard on the hard IoU.

Everything runs in plain PyTorch on the device of the problem's servers.
The optimiser is ``torch.optim.Adam`` over the free leaves, its learning
rate set from the schedule each iteration; the frozen leaves take no step.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..mano.model_data import TIP_VERTEX_IDS
from ..mano.server import mano_server_forward
from ..models.object_model import object_server_forward
from ..utils.mesh import seal_mano_faces, seal_mano_verts
from .silhouette import render_silhouette


def load_contact_idx(model_dir: str = "./body_models") -> np.ndarray:
    """Fingertip contact-zone vertex ids: the reference ships them as
    contact_zones.pkl (fitting/loss.py:27-30); fall back to fingertip
    neighborhoods derived from the tip vertices when the asset is absent."""
    p = os.path.join(model_dir, "contact_zones.pkl")
    if os.path.exists(p):
        with open(p, "rb") as f:
            zones = pickle.load(f)["contact_zones"]
        return np.array([i for zone in zones.values() for i in zone])
    return TIP_VERTEX_IDS.copy()


def _min_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N) min squared distances."""
    d2 = (
        torch.sum(a * a, -1)[:, :, None]
        + torch.sum(b * b, -1)[:, None, :]
        - 2.0 * torch.einsum("bnd,bmd->bnm", a, b)
    )
    return torch.clamp(torch.amin(d2, dim=-1), min=0.0)


def _server_device(server) -> torch.device:
    return (server.consts.v_template if hasattr(server, "consts") else server.v3d_cano).device


def trainable_copy(params: dict, labels: dict) -> tuple[dict, list]:
    """A copy of ``params`` whose leaves labelled "free" require grad, and
    the list of those leaves (an optimiser's parameters)."""
    free = []

    def walk(p, label):
        if isinstance(p, dict):
            return {k: walk(v, label[k]) for k, v in p.items()}
        x = p.detach().clone()
        if label == "free":
            free.append(x.requires_grad_(True))
        return x

    return walk(params, labels), free


def detached(params: dict) -> dict:
    if isinstance(params, dict):
        return {k: detached(v) for k, v in params.items()}
    return params.detach()


class FittingProblem:
    """Static data for one optimization batch, on the device of the servers."""

    def __init__(
        self,
        servers: dict[str, Any],  # node_id -> server state
        faces: dict[str, np.ndarray],
        target_masks: dict[str, np.ndarray],  # node_id -> (B, H, W) binary
        w2c: np.ndarray,  # (B, 4, 4)
        K: np.ndarray,  # (3, 3) scaled to the mask resolution
        scene_scale: float,
        imsize: tuple[int, int],
        contact_idx: np.ndarray,
        face_chunk: int = 64,
        sigma: float = 1e-6,
        contact_thres: float = 0.0,
    ):
        self.servers = servers
        self.node_ids = list(servers.keys())
        self.hand_ids = [n for n in self.node_ids if n in ("right", "left")]
        self.device = _server_device(next(iter(servers.values())))
        dev = self.device
        self.faces = {
            nid: (
                seal_mano_faces(f, nid == "right") if nid in ("right", "left")
                else np.asarray(f)
            )
            for nid, f in faces.items()
        }
        self.faces_t = {nid: torch.as_tensor(f, dtype=torch.int64, device=dev)
                        for nid, f in self.faces.items()}
        self.targets = {
            k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
            for k, v in target_masks.items()
        }
        self.w2c = torch.as_tensor(np.asarray(w2c), dtype=torch.float32, device=dev)
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev)
        self.scene_scale = float(scene_scale)
        self.imsize = imsize
        self.contact_idx = torch.as_tensor(np.asarray(contact_idx), device=dev)
        self.face_chunk = face_chunk
        self.sigma = sigma
        self.contact_thres = float(contact_thres)

    # -- forward ------------------------------------------------------------

    def forward(self, params: dict) -> dict:
        B = self.w2c.shape[0]
        scale = torch.full((B,), self.scene_scale, device=self.device)
        out: dict[str, Any] = {}
        for nid in self.node_ids:
            p = params[nid]
            if nid in ("right", "left"):
                thetas = torch.cat([p["global_orient"], p["pose"]], dim=-1)
                betas = p["betas"].expand(B, 10)
                srv_out = mano_server_forward(self.servers[nid], scale, p["transl"], thetas,
                                              betas)
                verts = srv_out.verts
                out[f"{nid}.jnts"] = srv_out.jnts
            else:
                srv_out = object_server_forward(
                    self.servers[nid], scale, p["transl"], p["global_orient"],
                    obj_scale=params["obj_scale"],
                )
                verts = srv_out.verts
            # world -> camera
            v_cam = (
                torch.einsum("bij,bnj->bni", self.w2c[:, :3, :3], verts)
                + self.w2c[:, None, :3, 3]
            )
            out[f"{nid}.v3d_c"] = v_cam
            v_render = seal_mano_verts(v_cam) if nid in ("right", "left") else v_cam
            out[f"{nid}.mask"] = render_silhouette(
                v_render, self.faces_t[nid], self.K, self.imsize,
                sigma=self.sigma, face_chunk=self.face_chunk,
            )
        return out

    # -- losses (loss.py parity) -------------------------------------------

    @torch.no_grad()
    def hard_iou(self, out: dict) -> float:
        """Binarized silhouette IoU vs the targets, averaged over entities
        and frames: the do-no-harm guard's acceptance metric (not the fit
        loss).  The soft L1 carries a boundary-band bias (the sigma blur
        fattens every predicted silhouette) that an optimizer can exploit on
        an already-correct init by shrinking the model along the camera ray;
        thresholding at 0.5 removes the band, so the IoU moves only when the
        hard silhouette alignment changes."""
        ious = []
        for nid in self.node_ids:
            pred = (out[f"{nid}.mask"] > 0.5).float()
            tgt = self.targets[nid]
            inter = torch.sum(pred * tgt, dim=(1, 2))
            union = torch.sum(torch.maximum(pred, tgt), dim=(1, 2))
            ious.append(inter / torch.clamp(union, min=1.0))
        return float(torch.mean(torch.stack(ious)))

    def loss_single_hand(self, out: dict, flag: str) -> dict:
        tips = out[f"{flag}.v3d_c"][:, self.contact_idx]
        d2 = _min_dist2(tips, out["object.v3d_c"])
        if self.contact_thres > 0.0:
            # deadzone (opt-in via --contact_thres; the default 0 is the
            # reference's, fitting/loss.py:92, which penalises any tip-object
            # gap): stop pulling once the tips are within the threshold, as
            # the reference's two-hand variant does (loss.py:135-140)
            d2 = torch.where(d2 < self.contact_thres**2, 0.0, d2)
        loss_contact = torch.mean(d2)

        valid_o = 1.0 - self.targets[flag]
        err_o = torch.abs(out["object.mask"] - self.targets["object"]) * valid_o
        loss_mask_o = torch.sum(err_o) / torch.clamp(torch.sum(valid_o), min=1.0)

        valid_h = 1.0 - self.targets["object"]
        err_h = torch.abs(out[f"{flag}.mask"] - self.targets[flag]) * valid_h
        loss_mask_h = torch.sum(err_h) / torch.clamp(torch.sum(valid_h), min=1.0)

        d = {
            "mask_o": loss_mask_o * 1000.0,
            "mask_h": loss_mask_h * 1000.0,
            "fine_ho": loss_contact * 100.0,
        }
        d["loss"] = sum(d.values())
        return d

    def project_verts(self, v3d_c: torch.Tensor) -> torch.Tensor:
        """(B, V, 3) camera-space vertices -> (B, V, 2) pixels."""
        z = torch.clamp(v3d_c[..., 2:3], min=1e-6)
        return (v3d_c[..., :2] / z * torch.stack([self.K[0, 0], self.K[1, 1]])
                + torch.stack([self.K[0, 2], self.K[1, 2]]))

    def loss_two_hands(self, out: dict, j2d_targets: dict) -> dict:
        valid = (1.0 - self.targets["right"]) * (1.0 - self.targets["left"])
        err_o = torch.abs(out["object.mask"] - self.targets["object"]) * valid
        loss_mask_o = torch.sum(err_o) / torch.clamp(torch.sum(valid), min=1.0)

        v_o = out["object.v3d_c"]
        thres = 2.0**2
        d = {}
        for flag in ("right", "left"):
            tips = out[f"{flag}.v3d_c"][:, self.contact_idx]
            c = torch.mean(_min_dist2(tips, v_o), dim=1)
            c = torch.where(c < thres, 0.0, c)
            d[f"contact_{flag[0]}o"] = torch.mean(c) * 0.05
            # 2D vertex anchors against the initial projection
            j2d = self.project_verts(out[f"{flag}.v3d_c"])
            d[f"v2d_{flag[0]}"] = torch.mean((j2d - j2d_targets[flag]) ** 2)
        d["mask_o"] = loss_mask_o * 1000.0
        d["loss"] = sum(d.values())
        return d


def build_fit_params(
    tables: dict[str, dict], node_ids, obj_scale: float, frame_idx: np.ndarray, device=None
) -> dict:
    """Slice per-frame pose tables (host arrays) into an optimization tree of
    float32 tensors on ``device``."""

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device).clone()

    p: dict[str, Any] = {}
    for nid in node_ids:
        tab = tables[nid]
        if nid in ("right", "left"):
            p[nid] = {
                "betas": t(tab["betas"]),
                "global_orient": t(np.asarray(tab["global_orient"])[frame_idx]),
                "pose": t(np.asarray(tab["pose"])[frame_idx]),
                "transl": t(np.asarray(tab["transl"])[frame_idx]),
            }
        else:
            p[nid] = {
                "global_orient": t(np.asarray(tab["global_orient"])[frame_idx]),
                "transl": t(np.asarray(tab["transl"])[frame_idx]),
            }
    p["obj_scale"] = t(float(obj_scale))
    return p


def fit_labels(params: dict, freeze_scale: bool, freeze_shape: bool) -> Any:
    """Trainability schedule (fitting.py:58-68): hand pose + hand global
    orient always frozen; betas/obj_scale per stage; translations + object
    orientation free."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        name = path[-1]
        if name == "obj_scale":
            return "frozen" if freeze_scale else "free"
        if name == "betas":
            return "frozen" if freeze_shape else "free"
        if name == "pose":
            return "frozen"
        if name == "global_orient" and path[0] in ("right", "left"):
            return "frozen"
        return "free"

    return walk(params, ())


def run_fit(
    problem: FittingProblem,
    params: dict,
    freeze_scale: bool,
    freeze_shape: bool,
    num_iterations: int = 500,
    lr0: float = 1e-2,
    tol_lr: float = 1e-5,
    plateau_patience: int = 30,
    verbose: bool = False,
    callback=None,  # fn(iter, params, loss) — e.g. diagnostics.FitRecorder
):
    """Returns (params, loss history, kept, guard): the fitted parameters
    when the guard keeps them, else ``params`` itself."""
    two_hands = len(problem.hand_ids) == 2
    j2d_targets = {}
    if two_hands:
        with torch.no_grad():
            out0 = problem.forward(params)
            for flag in ("right", "left"):
                j2d_targets[flag] = problem.project_verts(out0[f"{flag}.v3d_c"])

    params0 = params
    params, free = trainable_copy(params0, fit_labels(params0, freeze_scale, freeze_shape))
    opt = torch.optim.Adam(free, lr=lr0, eps=1e-8)

    def loss_fn(p):
        out = problem.forward(p)
        if two_hands:
            return problem.loss_two_hands(out, j2d_targets)["loss"]
        return problem.loss_single_hand(out, problem.hand_ids[0])["loss"]

    lr = lr0
    best = np.inf
    plateau = 0
    history = []
    for i in range(num_iterations):
        opt.zero_grad()
        loss = loss_fn(params)
        loss.backward()
        opt.param_groups[0]["lr"] = lr
        opt.step()
        loss_v = float(loss.detach())
        history.append(loss_v)
        if callback is not None:
            callback(i, detached(params), loss_v)
        if not np.isfinite(loss_v):
            break
        if loss_v < best - 1e-6:
            best = loss_v
            plateau = 0
        else:
            plateau += 1
            if plateau > plateau_patience:
                lr *= 0.1
                plateau = 0
        if lr < tol_lr:
            break
        if verbose and i % 50 == 0:
            print(f"  fit iter {i}: loss {loss_v:.4f} lr {lr:.2e}")
    # do-no-harm guard: accept the refinement only when the BINARIZED
    # silhouette IoU improves (not the soft fit loss, whose sigma-band bias
    # an optimizer exploits on near-perfect inits) and the loss did not
    # diverge.  The reference has no such guard (model.py:161-199 only
    # early-stops on lr).
    params = detached(params)
    finite = [h for h in history if np.isfinite(h)]
    loss_ok = bool(finite and min(finite[1:] or [np.inf]) < finite[0] - 1e-6)
    with torch.no_grad():
        iou0 = problem.hard_iou(problem.forward(params0))
        iou1 = problem.hard_iou(problem.forward(params))
    improved = bool(loss_ok and iou1 > iou0 + 1e-4)
    if not improved:
        params = params0
    guard = {"iou_init": iou0, "iou_final": iou1, "loss_improved": loss_ok}
    return params, history, improved, guard
