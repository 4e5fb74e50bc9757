"""The plain HOLD scene: nodes, background, loss targets, the training step
and the render of a chunk, in float32 PyTorch with no kernel.

A frozen copy of the plain paths of ``hold_tpu_torch/models/holdnet.py`` and
``models/nodes.py`` (the layer-by-layer sampler query, the chunked shade
with its double backward, each chunk recomputed in the backward), with every
vertex search the plain threshold-form blend of ``knn.py``.  Where the
program runs products in bfloat16 (the sampler's queries, the nodes' trunk
and colour nets) this runs them in float32; ``mlp.rounding`` gives those
products a lower precision for the control.  Nothing here reads what the program made:
the scene is built from the sequence's entities and the configuration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from . import mlp
from .background import background_forward, background_plans
from .chunk import map_chunked
from .density import laplace_beta, laplace_density
from .knn import inverse_warp_plain, jacobian_inverse_plain
from .losses import compute_losses
from .mano import build_mano_server, mano_server_forward
from .mesh import mano_subdivision_operator
from .mlp import (
    _apply_linear,
    apply_implicit_net,
    apply_implicit_trunk,
    apply_proposal_net,
    apply_rendering_net,
    implicit_feat_from_trunk,
    implicit_net_shapes,
    implicit_sdf_from_trunk,
    proposal_net_shapes,
    rendering_net_shapes,
    resolve_weight_norm,
)
from .object_model import build_object_server, object_deform, object_server_forward
from .point_mesh import (
    face_circumradius_bound,
    off_surface_by_vertex_bound,
    signed_distance_to_mesh,
)
from .ray_sampler import SamplerConfig, error_bound_z_vals, inverse_sphere_z_vals, ray_rand
from .sampling import (
    HAND_GLOBAL_SIGMA_XYZ,
    draw_barycentric,
    draw_point_in_space,
    point_in_space_sample,
    sample_on_mesh_barycentric,
)
from .specs import CLASS_IDS, MANO_SPECS, MAX_CLASS, OBJECT_SPECS, TIME_CODE_DIM
from .transforms import inverse_mat3, safe_norm
from .volsdf import get_camera_rays, merge_factors, volumetric_render

OBJ_CENTERS = 16384
OBJ_BOUND_V = 8192
N_SURF = 256
KNN_K, MAX_DIST = 15, 0.1
SHADE_CHUNK = 32768


@dataclass
class RefScene:
    node_ids: tuple
    servers: dict
    plans: dict  # node -> dict of its nets' shapes and constants
    bg_plans: dict
    sampler_cfg: SamplerConfig
    barf_cfg: tuple
    device: torch.device
    sub_ops: dict = field(default_factory=dict)


def build_scene(opt_model: dict, entities: dict, barf_cfg: tuple, device) -> RefScene:
    hands = [k for k in ("right", "left") if k in entities]
    node_ids = tuple(hands + ["object"])
    rs = opt_model["ray_sampler"]
    cfg = SamplerConfig(
        near=rs["near"], N_samples=rs["N_samples"], N_samples_eval=rs["N_samples_eval"],
        N_samples_extra=rs["N_samples_extra"], eps=rs["eps"], beta_iters=rs["beta_iters"],
        max_total_iters=rs["max_total_iters"], add_tiny=rs["add_tiny"],
        scene_bounding_sphere=opt_model["scene_bounding_sphere"], inverse_sphere_bg=True,
        N_samples_inverse_sphere=rs.get("N_samples_inverse_sphere", 32),
        conv_check=rs.get("conv_check", "current"),
    )
    prop = opt_model.get("proposal", {})
    servers, plans, sub_ops = {}, {}, {}
    for nid in node_ids:
        if nid == "object":
            e = entities["object"]
            servers[nid] = build_object_server(e["pts.cano"], e["obj_scale"], e["norm_mat"],
                                               device)
            specs = OBJECT_SPECS
            render_opt = dict(opt_model["rendering_network"])
            render_opt["d_in"] = render_opt["d_in"] + TIME_CODE_DIM
        else:
            servers[nid] = build_mano_server(nid == "right", entities[nid]["mean_shape"],
                                             device=device)
            specs, render_opt = MANO_SPECS, opt_model["rendering_network"]
            M, faces_div = mano_subdivision_operator(servers[nid].consts.faces, nid == "right")
            sub_ops[nid] = (torch.as_tensor(M, device=device),
                            torch.as_tensor(faces_div, device=device))
        plans[nid] = {
            "implicit": implicit_net_shapes(opt_model["implicit_network"], specs),
            "rendering": rendering_net_shapes(render_opt, specs),
            "proposal": proposal_net_shapes(prop) if prop.get("enabled", False) else None,
            "class_id": CLASS_IDS[nid],
        }
    return RefScene(node_ids, servers, plans, background_plans(opt_model), cfg, barf_cfg,
                    torch.device(device), sub_ops)


def mesh_state(vertices: np.ndarray, faces: np.ndarray, device) -> dict:
    """The object's mesh state from a canonical mesh that fits its rows
    (as the program's meshing fills it: the vertices tiled to OBJ_CENTERS,
    the vertices once then far padding, the box, the face bound)."""
    vertices = np.asarray(vertices, np.float32)
    if vertices.shape[0] > OBJ_BOUND_V:
        raise ValueError(f"{vertices.shape[0]} vertices do not fit {OBJ_BOUND_V} rows")
    reps = int(np.ceil(OBJ_CENTERS / vertices.shape[0]))
    bound = np.full((OBJ_BOUND_V, 3), 1e4, np.float32)
    bound[: vertices.shape[0]] = vertices
    h = face_circumradius_bound(torch.as_tensor(vertices),
                                torch.as_tensor(np.asarray(faces, np.int64)))
    return {
        "centers": torch.as_tensor(np.tile(vertices, (reps, 1))[:OBJ_CENTERS], device=device),
        "bound_centers": torch.as_tensor(bound, device=device),
        "sigma_xyz": torch.as_tensor(np.abs(vertices).max(axis=0) * 1.1, device=device),
        "h_margin": h.to(device),
        "valid": torch.tensor(1.0, device=device),
    }


# --------------------------------------------------------------------------
# Poses and rays
# --------------------------------------------------------------------------

def _flat_per_point(x, n):
    B, C = x.shape
    return x[:, None, :].expand(B, n, C).reshape(B * n, C)


def _mano_pose(nparams, server, batch, epoch):
    tables, frame_idx = nparams["tables"], batch["frame_idx"]
    B = frame_idx.shape[0]
    full_pose = torch.cat([tables["global_orient"][frame_idx], tables["pose"][frame_idx]], dim=-1)
    out = mano_server_forward(server, batch["scene_scale"], tables["transl"][frame_idx],
                              full_pose, tables["betas"].expand(B, -1))
    cond_pose = full_pose[:, 3:] / math.pi
    if epoch is not None and epoch < 20:
        cond_pose = cond_pose * 0.0
    return out, cond_pose


def _object_tfs(nparams, server, batch):
    tables, frame_idx = nparams["tables"], batch["frame_idx"]
    return object_server_forward(server, batch["scene_scale"], tables["transl"][frame_idx],
                                 tables["global_orient"][frame_idx],
                                 obj_scale=nparams.get("obj_scale")).obj_tfs


def _rays(batch):
    B, P = batch["uv"].shape[:2]
    dirs, cam = get_camera_rays(batch["uv"], batch["extrinsics"], batch["intrinsics"])
    return dirs.reshape(-1, 3), cam[:, None, :].expand(B, P, 3).reshape(-1, 3)


def _hand_frame(nparams, scene, nid, batch, epoch):
    B = batch["frame_idx"].shape[0]
    srv = scene.servers[nid]
    out, cond_pose = _mano_pose(nparams, srv, batch, epoch)
    return (out, cond_pose, srv.verts_c.expand(B, -1, -1),
            srv.skin_weights_c.expand(B, -1, -1))


# --------------------------------------------------------------------------
# Sampler stage
# --------------------------------------------------------------------------

@torch.no_grad()
def sample_z(params, scene: RefScene, batch, gen, step, epoch, proposal_mode: bool) -> dict:
    """Every node's error-bound z table (the program's sampler stage; gen
    None: the render's even grid)."""
    ray_dirs, cam_loc = _rays(batch)
    B, P = batch["uv"].shape[:2]
    clip_v = 2.0 * scene.sampler_cfg.scene_bounding_sphere
    out = {}
    for nid in scene.node_ids:
        nparams, plan = params[nid], scene.plans[nid]
        if nid == "object":
            tfs = _object_tfs(nparams, scene.servers[nid], batch)

            def to_canonical(pts, tfs=tfs):
                return object_deform(pts, tfs, inverse=True)
        else:
            srv_out, _, _, skin_w = _hand_frame(nparams, scene, nid, batch, epoch)

            def to_canonical(pts, srv_out=srv_out, skin_w=skin_w):
                return inverse_warp_plain(pts, srv_out.verts, skin_w, srv_out.tfs, K=KNN_K,
                                          max_dist=MAX_DIST)[0]
        if proposal_mode and plan["proposal"] is not None and "proposal" in nparams:
            def sdf_fn(pts_RS3, nparams=nparams, plan=plan, to_canonical=to_canonical):
                S = pts_RS3.shape[1]
                x_c = to_canonical(pts_RS3.reshape(B, P * S, 3)).reshape(-1, 3)
                with mlp.lowp():
                    sdf = apply_proposal_net(nparams["proposal"], plan["proposal"], x_c,
                                             step=step, barf_cfg=scene.barf_cfg,
                                             embedding=plan["implicit"]["embedding"])
                return torch.clamp(sdf, -clip_v, clip_v).reshape(B * P, S)
        else:
            imp = resolve_weight_norm(nparams["implicit"])

            def sdf_fn(pts_RS3, imp=imp, plan=plan, to_canonical=to_canonical):
                S = pts_RS3.shape[1]
                x_c = to_canonical(pts_RS3.reshape(B, P * S, 3)).reshape(-1, 3)
                with mlp.lowp():
                    h = apply_implicit_trunk(imp, plan["implicit"], x_c, None, step=step,
                                             barf_cfg=scene.barf_cfg)
                return implicit_sdf_from_trunk(imp, h).reshape(B * P, S)
        out[nid] = error_bound_z_vals(gen, sdf_fn, ray_dirs, cam_loc,
                                      laplace_beta(nparams["density"]), scene.sampler_cfg)
    return out


# --------------------------------------------------------------------------
# Grad stage and render: the shade
# --------------------------------------------------------------------------

def _tree_tensors(*trees) -> tuple:
    out = []
    for t in trees:
        if isinstance(t, dict):
            out.extend(_tree_tensors(*t.values()))
        elif isinstance(t, (list, tuple)):
            out.extend(_tree_tensors(*t))
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return tuple(out)


def _normalize(n):
    return n / torch.clamp(safe_norm(n, keepdim=True), min=1e-6)


def _sdf_and_grad(imp, plan, xc, step, barf_cfg, create_graph):
    with torch.enable_grad():
        if not xc.requires_grad:
            xc = xc.detach().requires_grad_(True)
        h = apply_implicit_trunk(imp, plan["implicit"], xc, None, step=step, barf_cfg=barf_cfg)
        sdf = implicit_sdf_from_trunk(imp, h)
        (g,) = torch.autograd.grad(sdf, xc, torch.ones_like(sdf), create_graph=create_graph)
    if not create_graph:
        sdf, h, g = sdf.detach(), h.detach(), g.detach()
    return xc, sdf, h, g


def _semantics(plan, R, S, device):
    sem = torch.zeros((R, S, MAX_CLASS), device=device)
    sem[:, :, plan["class_id"]] = 1.0
    return sem


def node_forward(nparams, scene: RefScene, nid: str, batch, ray_dirs, cam_loc, step, epoch,
                 z_vals, create_graph=True):
    """(factors, sample_dict) of one node at its z table: the warp, the
    shade (sdf, its gradient for the normal, features, colour) in chunks."""
    B, P = batch["uv"].shape[:2]
    plan = scene.plans[nid]
    imp = resolve_weight_norm(nparams["implicit"])
    rend = resolve_weight_norm(nparams["rendering"])
    S_f = z_vals.shape[1]
    N = B * P * S_f
    pts = (cam_loc[:, None, :] + z_vals[:, :, None] * ray_dirs[:, None, :]).reshape(B, P * S_f, 3)
    view = -ray_dirs[:, None, :].expand(B * P, S_f, 3).reshape(-1, 3)
    barf = scene.barf_cfg
    if nid == "object":
        tfs = _object_tfs(nparams, scene.servers[nid], batch)
        x_c = object_deform(pts, tfs, inverse=True)
        sd = {"canonical_pts": x_c.reshape(B, P, S_f, 3)}
        rinv = inverse_mat3(tfs[:, :3, :3])[:, None].expand(B, P * S_f, 3, 3).reshape(N, 3, 3)
        tc = _flat_per_point(nparams["frame_latent"][batch["frame_idx"]], P * S_f)

        def shade(xc, vw, jinv, tc):
            with mlp.lowp():
                xc, sdf, h, g = _sdf_and_grad(imp, plan, xc, step, barf, create_graph)
                feat = implicit_feat_from_trunk(imp, h)
                nrm = _normalize(torch.einsum("ni,nij->nj", g, jinv))
                rgb = apply_rendering_net(rend, plan["rendering"], xc, nrm, vw, None,
                                          torch.cat([feat, tc], dim=-1), step=step,
                                          barf_cfg=barf)
            return sdf, rgb, nrm

        args = (x_c.reshape(-1, 3), view, rinv, tc)
    else:
        srv_out, cond_pose, verts_c, skin_w = _hand_frame(nparams, scene, nid, batch, epoch)
        x_c, _ = inverse_warp_plain(pts, srv_out.verts, skin_w, srv_out.tfs, K=KNN_K,
                                    max_dist=MAX_DIST)
        jinv9 = jacobian_inverse_plain(x_c, verts_c, skin_w, srv_out.tfs, K=KNN_K)
        sd = {"canonical_pts": x_c.reshape(B, P, S_f, 3), "cond_pose": cond_pose,
              "v_posed": srv_out.v_posed}
        pe = _flat_per_point(_apply_linear(rend["lin_pose"], cond_pose), P * S_f)

        def shade(xc, pe, vw, jinv):
            with mlp.lowp():
                xc, sdf, h, g = _sdf_and_grad(imp, plan, xc, step, barf, create_graph)
                feat = implicit_feat_from_trunk(imp, h)
                nrm = _normalize(torch.stack(
                    [sum(g[:, i] * jinv[:, 3 * i + j] for i in range(3)) for j in range(3)],
                    dim=-1))
                rgb = apply_rendering_net(rend, plan["rendering"], xc, nrm, vw, None, feat,
                                          step=step, barf_cfg=barf, pose_embed=pe)
            return sdf, rgb, nrm

        args = (x_c.reshape(-1, 3), pe, view, jinv9.reshape(-1, 9))
    sdf, rgb, nrm = map_chunked(shade, args, N, chunk=SHADE_CHUNK,
                                closed=_tree_tensors(imp, rend))
    sd["sample_sdf"] = sdf.reshape(B, P, S_f)
    factors = {
        "color": rgb.reshape(B * P, S_f, 3),
        "normal": nrm.reshape(B * P, S_f, 3),
        "density": laplace_density(nparams["density"], sdf).reshape(B * P, S_f, 1),
        "semantics": _semantics(plan, B * P, S_f, z_vals.device),
        "z_vals": z_vals,
    }
    return factors, sd


# --------------------------------------------------------------------------
# Loss targets
# --------------------------------------------------------------------------

def step_draws(scene: RefScene, B: int, P: int, gen) -> dict:
    """The step's random draws, in the program's order (``sample_step_draws``)."""
    dev = scene.device
    draws = {}
    for nid in scene.node_ids:
        if nid == "object":
            n_centers = OBJ_CENTERS
        else:
            faces_div = scene.sub_ops[nid][1]
            draws[f"{nid}.bary"] = draw_barycentric(gen, B, N_SURF, faces_div.shape[0], dev)
            draws[f"{nid}.surf"] = draw_point_in_space(gen, B, N_SURF, 0.20, dev)
            n_centers = scene.servers[nid].verts_c.shape[1]
        draws[f"{nid}.eik_idx"] = torch.randperm(n_centers, generator=gen, device=dev)[:N_SURF]
        draws[f"{nid}.eik"] = draw_point_in_space(gen, B, min(n_centers, N_SURF), 0.20, dev)
    draws["bg_u"] = ray_rand(gen, (B * P, scene.sampler_cfg.N_samples_inverse_sphere), dev)
    return draws


def _eikonal(nparams, plan, barf, centers, local_sigma, sigma_xyz, step, idx, noise, glob_u):
    pts = point_in_space_sample(centers[:, idx], local_sigma, sigma_xyz, noise, glob_u)
    B, N = pts.shape[:2]
    with torch.enable_grad():
        p = pts.reshape(-1, 3).detach().requires_grad_(True)
        imp = nparams["implicit"]
        h = apply_implicit_trunk(imp, plan["implicit"], p, None, step=step, barf_cfg=barf)
        sdf = implicit_sdf_from_trunk(imp, h)
        (g,) = torch.autograd.grad(sdf.sum(), p, create_graph=True)
    return g.reshape(B, N, 3)


def loss_targets(nparams, scene: RefScene, nid, sd, mesh, step, draws) -> dict:
    plan, barf = scene.plans[nid], scene.barf_cfg
    B, P = sd["canonical_pts"].shape[:2]
    if nid == "object":
        tgt = {
            "index_off_surface": off_surface_by_vertex_bound(
                sd["canonical_pts"].reshape(-1, 3), mesh["bound_centers"], B * P, 0.05,
                mesh["h_margin"]),
            "grad_theta": _eikonal(nparams, plan, barf, mesh["centers"][None].expand(B, -1, -1),
                                   0.03, mesh["sigma_xyz"], step, draws["object.eik_idx"],
                                   *draws["object.eik"]),
            "active": mesh["valid"],
        }
    else:
        M_sub, faces_div = scene.sub_ops[nid]
        v_div = M_sub @ sd["v_posed"][0]
        surf = sample_on_mesh_barycentric(v_div[None].expand(B, -1, -1), faces_div,
                                          *draws[f"{nid}.bary"])
        samples = point_in_space_sample(surf, 0.008, HAND_GLOBAL_SIGMA_XYZ, *draws[f"{nid}.surf"])
        Ns = samples.shape[1]
        with torch.no_grad():
            gt_sdf = torch.stack([signed_distance_to_mesh(samples[b], v_div, faces_div)
                                  for b in range(B)])
        pred = apply_implicit_net(nparams["implicit"], plan["implicit"], samples.reshape(-1, 3),
                                  _flat_per_point(sd["cond_pose"], Ns), step=step, barf_cfg=barf)
        v_div = v_div.detach()
        tgt = {
            "pts2mano_sdf_cano": gt_sdf,
            "pred_sdf": pred[:, 0].reshape(B, Ns),
            "index_off_surface": off_surface_by_vertex_bound(
                sd["canonical_pts"].reshape(-1, 3), v_div, B * P, 0.01,
                face_circumradius_bound(v_div, faces_div)),
            "grad_theta": _eikonal(nparams, plan, barf,
                                   scene.servers[nid].verts_c.expand(B, -1, -1), 0.008,
                                   HAND_GLOBAL_SIGMA_XYZ, step, draws[f"{nid}.eik_idx"],
                                   *draws[f"{nid}.eik"]),
            "active": torch.tensor(float(step >= 200), device=scene.device),
        }
    if "proposal" in nparams:
        pts = sd["canonical_pts"][:, :, ::6].detach().reshape(-1, 3)
        clip_v = 2.0 * scene.sampler_cfg.scene_bounding_sphere
        tgt["proposal_tgt"] = torch.clamp(sd["sample_sdf"][:, :, ::6].detach().reshape(-1),
                                          -clip_v, clip_v)
        tgt["proposal_pred"] = apply_proposal_net(
            nparams["proposal"], plan["proposal"], pts, step=step, barf_cfg=barf,
            embedding=plan["implicit"]["embedding"])
    return tgt


# --------------------------------------------------------------------------
# Composite
# --------------------------------------------------------------------------

def _background(params, scene, out, batch, ray_dirs, cam_loc, u, step):
    B, P = batch["uv"].shape[:2]
    radius = scene.sampler_cfg.scene_bounding_sphere
    bg_z = inverse_sphere_z_vals(u, B * P, scene.sampler_cfg.N_samples_inverse_sphere,
                                 device=scene.device) * (1.0 / radius)
    frame_idx = batch["frame_idx"][:, None].expand(B, P).reshape(-1)
    return background_forward(params["background"], scene.bg_plans, out["bg_weights"],
                              ray_dirs, cam_loc, bg_z, frame_idx, radius, step=step)


def forward(params, scene: RefScene, batch, mesh, draws, step, epoch, z_vals: dict) -> dict:
    """The grad stage's outputs (the program's ``holdnet_forward``)."""
    ray_dirs, cam_loc = _rays(batch)
    out, factors_list, sds = {}, [], {}
    for nid in scene.node_ids:
        f, sd = node_forward(params[nid], scene, nid, batch, ray_dirs, cam_loc, step, epoch,
                             z_vals[nid])
        factors_list.append(f)
        sds[nid] = sd
    for nid in scene.node_ids:
        tgt = loss_targets(params[nid], scene, nid, sds[nid], mesh, step, draws)
        out.update({f"{nid}.{k}": v for k, v in tgt.items()})
    out.update(volumetric_render(merge_factors(factors_list)))
    for nid, f in zip(scene.node_ids, factors_list):
        f = dict(f)
        f["z_max"] = f["z_vals"][:, -1]
        out.update({f"{nid}.{k}": v for k, v in volumetric_render(f).items()})
    bg = _background(params, scene, out, batch, ray_dirs, cam_loc, draws["bg_u"], step)
    out["rgb"] = out["fg_rgb"] + bg["bg_rgb"]
    out["semantics"] = out["fg_semantics"] + bg["bg_semantics"]
    return out


RENDER_KEEP = ("rgb", "instance_map", "bg_rgb_only", "normal", "depth", "mask_prob",
               "fg_rgb_vis")
RENDER_KEEP_NODE = ("fg_rgb_vis", "mask_prob", "normal")


@torch.no_grad()
def render_chunk(params, scene: RefScene, batch) -> dict:
    """One chunk of a frame's pixels (the program's ``make_chunk_renderer``):
    the eval sampler on the even grid through the trunk, the shade without
    the graph, the background on its even grid, every kept map."""
    z_vals = sample_z(params, scene, batch, None, None, None, proposal_mode=False)
    ray_dirs, cam_loc = _rays(batch)
    factors_list = []
    for nid in scene.node_ids:
        f, _ = node_forward(params[nid], scene, nid, batch, ray_dirs, cam_loc, None, None,
                            z_vals[nid], create_graph=False)
        factors_list.append({k: v.detach() for k, v in f.items()})
    out = volumetric_render(merge_factors(factors_list), vis=True)
    for nid, f in zip(scene.node_ids, factors_list):
        f = dict(f)
        f["z_max"] = f["z_vals"][:, -1]
        out.update({f"{nid}.{k}": v for k, v in volumetric_render(f, vis=True).items()})
    bg = _background(params, scene, out, batch, ray_dirs, cam_loc, None, None)
    out["rgb"] = out["fg_rgb"] + bg["bg_rgb"]
    out["semantics"] = out["fg_semantics"] + bg["bg_semantics"]
    out["bg_rgb_only"] = bg["bg_rgb_only"]
    out["instance_map"] = torch.argmax(out["semantics"], dim=1)
    keep = {k: out[k] for k in RENDER_KEEP}
    for nid in scene.node_ids:
        keep.update({f"{nid}.{k}": out[f"{nid}.{k}"] for k in RENDER_KEEP_NODE})
    return keep


# --------------------------------------------------------------------------
# Training step
# --------------------------------------------------------------------------

def adam_groups(params) -> list:
    """The program's three Adam groups' members, by path: the pose tables at
    0.1x lr, the proposal nets, every other trainable tensor."""
    main, pose, prop = [], [], []

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + (str(i),))
        elif node.requires_grad:
            (prop if "proposal" in path else pose if "tables" in path else main).append(node)

    rec(params, ())
    return [main, pose, prop]


def train_step(params, scene: RefScene, batch, mesh, gen, step, epoch, optimizer,
               z_vals: dict | None = None) -> dict:
    """One training step (the program's ``make_train_step``'s ``train_step``):
    the sampler stage, the grad stage, the losses, backward, Adam.  Returns
    the losses and each node's z table.  ``z_vals`` given: the grad stage
    runs at those tables (the sampler stage still runs and is returned)."""
    B, P = batch["uv"].shape[:2]
    own = sample_z(params, scene, batch, gen, step, epoch, proposal_mode=True)
    draws = step_draws(scene, B, P, gen)
    optimizer.zero_grad(set_to_none=True)
    out = forward(params, scene, batch, mesh, draws, step, epoch, own if z_vals is None else z_vals)
    losses = compute_losses(batch, out, scene.node_ids, step)
    losses["loss"].backward()
    optimizer.step()
    return {"losses": {k: float(v.detach()) for k, v in losses.items()}, "z_vals": own}
