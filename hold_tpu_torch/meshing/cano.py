"""Canonical meshing of the nodes' SDF fields, between training epochs
(counterpart of hold_tpu/meshing/cano.py).

The MISE octree (C++, on the host) proposes grid points; each node's f32
implicit net evaluates them on the scene's device in 10,000-point batches
under ``torch.no_grad``, with zero conditioning and no BARF step.  Mirrors
meshing_cano at code/src/model/renderables/{mano_node.py:137-151,
object_node.py:112-121}.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..models.mlp import apply_implicit_net
from ..utils.mesh import Mesh
from .mise import generate_mesh

POINT_BATCH = 10000


def make_node_sdf_fn(nparams: dict, plans, cond_dim: int, device):
    """numpy (N, 3) float32 points -> numpy (N,) sdf of the node's implicit
    net (``nparams["implicit"]``) on ``device``."""
    implicit = nparams["implicit"]
    device = torch.device(device)

    def sdf_fn(pts_np: np.ndarray) -> np.ndarray:
        out = np.empty(pts_np.shape[0], np.float32)
        with torch.no_grad():
            for s in range(0, pts_np.shape[0], POINT_BATCH):
                pts = torch.as_tensor(pts_np[s:s + POINT_BATCH], dtype=torch.float32,
                                      device=device)
                cond = torch.zeros((pts.shape[0], cond_dim), device=device) if cond_dim else None
                sdf = apply_implicit_net(implicit, plans.implicit, pts, cond, step=None,
                                         barf_cfg=plans.barf_cfg)[:, 0]
                out[s:s + pts.shape[0]] = sdf.float().cpu().numpy()
        return out

    return sdf_fn


def mesh_hand_cano(nparams: dict, scene, nid: str, res_init: int = 64,
                   res_up: int = 1) -> Mesh | None:
    """The hand's canonical mesh, in the bbox of the server's canonical
    vertices (the reference hard-codes the empirical MANO one,
    mano_node.py:143)."""
    bbox_pts = scene.servers[nid].verts_c[0].detach().cpu().numpy()
    sdf_fn = make_node_sdf_fn(nparams, scene.plans[nid], 45, scene.device)
    return generate_mesh(sdf_fn, bbox_pts, res_init=res_init, res_up=res_up,
                         point_batch=POINT_BATCH)


def mesh_object_cano(nparams: dict, scene, res_init: int = 32,
                     res_up: int = 2) -> Mesh | None:
    """The object's canonical mesh over 2x the bbox of its canonical SfM
    points (object_node.py:49-50, 112-121)."""
    v = scene.servers["object"].v3d_cano.detach().cpu().numpy()
    bbox = np.stack([v.min(0), v.max(0)]) * 2.0
    sdf_fn = make_node_sdf_fn(nparams, scene.plans["object"], 0, scene.device)
    return generate_mesh(sdf_fn, bbox, res_init=res_init, res_up=res_up,
                         point_batch=POINT_BATCH)


def mesh_all_cano(params: dict, scene, res_scale: int = 1) -> dict[str, Mesh]:
    """Every node's canonical mesh that has faces; ``res_scale`` divides the
    grid resolutions (smoke runs use > 1).  A node whose meshing raises is
    left out with a warning: meshing never ends training (hold.py:154-166)."""
    out = {}
    for nid in scene.node_ids:
        try:
            if nid in ("right", "left"):
                m = mesh_hand_cano(params[nid], scene, nid, res_init=max(64 // res_scale, 8))
            else:
                m = mesh_object_cano(params[nid], scene, res_init=max(32 // res_scale, 8))
            if m is not None and m.faces.shape[0] > 0:
                out[nid] = m
        except Exception as e:  # meshing must never kill training (hold.py:154-166)
            logging.getLogger("hold_tpu_torch").warning(f"[meshing] failed for {nid}: {e}")
    return out
