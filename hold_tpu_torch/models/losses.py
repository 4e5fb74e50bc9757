"""Training losses and schedules (counterpart of hold_tpu/models/losses.py).
Masked index-selects become masked means, as in the JAX package."""

from __future__ import annotations

import torch

from .specs import SEGM_IDS

from ..utils.transforms import safe_norm

MILESTONE = 30000


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.expand(values.shape).to(values.dtype)
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1e-6)


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """L1 with non-finite rays filtered out."""
    finite = torch.all(torch.isfinite(pred), dim=-1, keepdim=True)
    pred = torch.where(finite, pred, torch.zeros_like(pred))
    gt = torch.where(finite, gt, torch.zeros_like(gt))
    return torch.sum(torch.abs(pred - gt) * finite) / max(pred.shape[0], 1)


def semantic_gt_onehot(mask_vals: torch.Tensor) -> torch.Tensor:
    """<25 bg, <100 object, <200 right, else left."""
    cls = torch.where(
        mask_vals < 25, 0,
        torch.where(mask_vals < 100, 1, torch.where(mask_vals < 200, 2, 3)),
    )
    return torch.eye(len(SEGM_IDS), device=mask_vals.device)[cls]


def sem_loss(sem_pred: torch.Tensor, mask_gt: torch.Tensor) -> torch.Tensor:
    l2 = (sem_pred - semantic_gt_onehot(mask_gt)) ** 2
    return torch.sum(l2) / max(sem_pred.shape[0], 1)


def eikonal_loss(grad_theta: torch.Tensor) -> torch.Tensor:
    return torch.mean((safe_norm(grad_theta) - 1.0) ** 2)


def opacity_sparse_loss(mask_prob: torch.Tensor, off_surface: torch.Tensor) -> torch.Tensor:
    return masked_mean(torch.abs(mask_prob[:, 0]), off_surface.float())


def mano_cano_loss(pred_sdf, gt_sdf, limit: float = 0.01) -> torch.Tensor:
    return torch.mean(torch.abs(torch.clamp(pred_sdf, -limit, limit)
                                - torch.clamp(gt_sdf, -limit, limit)))


def compute_losses(batch: dict, outputs: dict, node_ids, step: int) -> dict:
    """batch: gt_rgb (R,3), gt_mask (R,); outputs from holdnet_forward."""
    prog = min(step, MILESTONE) / MILESTONE
    w_sem = 1.1 + (0.1 - 1.1) * prog

    losses = {
        "loss/rgb": rgb_loss(outputs["rgb"], batch["gt_rgb"]),
        "loss/sem": sem_loss(outputs["semantics"], batch["gt_mask"]) * w_sem,
    }
    sparse = eik = cano = 0.0
    for nid in node_ids:
        if f"{nid}.index_off_surface" in outputs:
            active = outputs[f"{nid}.active"]
            sparse = sparse + active * opacity_sparse_loss(
                outputs[f"{nid}.mask_prob"], outputs[f"{nid}.index_off_surface"]
            )
            eik = eik + active * eikonal_loss(outputs[f"{nid}.grad_theta"])
        if f"{nid}.pts2mano_sdf_cano" in outputs:
            cano = cano + outputs[f"{nid}.active"] * mano_cano_loss(
                outputs[f"{nid}.pred_sdf"], outputs[f"{nid}.pts2mano_sdf_cano"]
            )
    # the proposal-net distillation term is 0: the surrogate is not ported
    losses["loss/proposal"] = torch.zeros((), device=losses["loss/rgb"].device)
    eik = eik * 1e-5
    losses["loss/eikonal"] = torch.where(eik > 8e-4, eik, torch.zeros_like(eik))
    losses["loss/mano_cano"] = cano * 5.0
    losses["loss/opacity_sparse"] = sparse * prog
    losses["loss"] = (
        losses["loss/rgb"] + losses["loss/sem"] + losses["loss/eikonal"]
        + losses["loss/mano_cano"] + losses["loss/opacity_sparse"]
        + losses["loss/proposal"]
    )
    return losses
