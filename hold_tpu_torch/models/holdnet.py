"""Scene composition: nodes + NeRF++ background + loss-target preparation
(counterpart of hold_tpu/models/holdnet.py).

Static scene state (MANO/object servers, layer plans, the hand subdivision
operator) lives in a ``Scene``; everything trainable is in the params tree
(utils/convert.py); the object's canonical mesh rides in a fixed-shape
``mesh_state`` dict.  The random draws of one step are made up front by
``sample_step_draws`` and handed to ``holdnet_forward`` as tensors.
``holdnet_render`` is the inference composite (the JAX ``holdnet_forward`` at
``training=False``): no loss targets, the even background grid.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..mano.server import build_mano_server
from ..ops.fused_render import supports_fused_render
from ..ops.point_mesh import (
    face_circumradius_bound,
    off_surface_by_vertex_bound,
    signed_distance_to_mesh,
)
from ..ops.sampling import (
    HAND_GLOBAL_SIGMA_XYZ,
    draw_barycentric,
    draw_point_in_space,
    point_in_space_sample,
    sample_on_mesh_barycentric,
)
from ..render.background import background_forward, background_plans, init_background
from ..render.ray_sampler import SamplerConfig, inverse_sphere_z_vals
from ..render.volsdf import get_camera_rays, merge_factors, volumetric_render
from ..utils.convert import leaf_params
from ..utils.mesh import mano_subdivision_operator
from .density import init_laplace_density
from .mlp import (
    apply_implicit_net,
    apply_implicit_trunk,
    implicit_net_shapes,
    implicit_sdf_from_trunk,
    init_implicit_net,
    init_rendering_net,
    rendering_net_shapes,
)
from .nodes import (
    NodePlans,
    _flat_per_point,
    mano_node_forward,
    mano_node_render,
    mano_node_sample_z,
    node_render_packs,
    object_node_forward,
    object_node_render,
    object_node_sample_z,
    use_fused_query,
)
from .object_model import build_object_server
from .specs import CLASS_IDS, MANO_SPECS, OBJECT_SPECS, TIME_CODE_DIM

OBJ_CENTERS = 16384
OBJ_BOUND_V = 8192
N_SURF = 256  # surface / eikonal samples per frame


@dataclass
class Scene:
    node_ids: tuple  # ("right" | "left" ..., "object")
    servers: dict
    plans: dict
    bg_plans: dict
    n_frames: int
    sampler_cfg: SamplerConfig
    device: torch.device
    sub_ops: dict = field(default_factory=dict)  # hand id -> (M_sub, faces_div)
    opt_model: dict = field(default_factory=dict)


def _hand_ids(entities) -> list:
    return [k for k in ("right", "left") if k in entities]


def _object_render_opt(opt_model) -> dict:
    # the object's rendering net also takes the 32-d per-frame time code
    opt = dict(opt_model["rendering_network"])
    opt["d_in"] = opt["d_in"] + TIME_CODE_DIM
    return opt


def build_scene(opt_model, args, scene_data: dict, device, fused_sampler: bool = True,
                fused_render: bool = True, fused_train: bool = True,
                remat: bool = True) -> Scene:
    """Static scene state on ``device``.  ``fused_sampler=False`` makes every
    node's sampler query the trunk layer by layer (the JAX package's
    ``HOLD_NO_FUSED_SAMPLER=1``), ``fused_render=False`` every node's render
    shade run the chunked grad-stage shade (``HOLD_NO_FUSED_RENDER=1``, which
    turns the fused training shade off too, as in the JAX package),
    ``fused_train=False`` every node's grad stage run the chunked shade
    (``HOLD_NO_FUSED_TRAIN=1``); otherwise nodes whose nets the fused kernels
    support use them.  ``remat=False`` makes the chunked shade keep every
    chunk's graph instead of recomputing it in the backward
    (``HOLD_NO_REMAT=1``)."""
    if opt_model.get("proposal", {}).get("enabled", False):
        raise NotImplementedError(
            "the proposal net is not ported: set model.proposal.enabled to false"
        )
    if device is None:
        raise ValueError("build_scene needs a device")
    device = torch.device(device)
    entities = scene_data["entities"]
    node_ids = tuple(_hand_ids(entities) + ["object"])
    rs = opt_model["ray_sampler"]
    sampler_cfg = SamplerConfig(
        near=rs["near"], N_samples=rs["N_samples"], N_samples_eval=rs["N_samples_eval"],
        N_samples_extra=rs["N_samples_extra"], eps=rs["eps"], beta_iters=rs["beta_iters"],
        max_total_iters=rs["max_total_iters"], add_tiny=rs["add_tiny"],
        scene_bounding_sphere=opt_model["scene_bounding_sphere"], inverse_sphere_bg=True,
        N_samples_inverse_sphere=rs.get("N_samples_inverse_sphere", 32),
        conv_check=rs.get("conv_check", "current"),
    )
    barf_cfg = (int(args.get("barf_s", 1000)), int(args.get("barf_e", 10000)))
    servers, plans, sub_ops = {}, {}, {}
    for nid in node_ids:
        if nid == "object":
            obj = entities["object"]
            servers[nid] = build_object_server(obj["pts.cano"], obj["obj_scale"],
                                               obj["norm_mat"], device)
            specs, render_opt = OBJECT_SPECS, _object_render_opt(opt_model)
        else:
            servers[nid] = build_mano_server(nid == "right", entities[nid]["mean_shape"],
                                             model_dir=args.get("mano_dir"), device=device)
            specs, render_opt = MANO_SPECS, opt_model["rendering_network"]
            M, faces_div = mano_subdivision_operator(servers[nid].consts.faces, nid == "right")
            sub_ops[nid] = (torch.as_tensor(M, device=device),
                            torch.as_tensor(faces_div, device=device))
        implicit = implicit_net_shapes(opt_model["implicit_network"], specs)
        rendering = rendering_net_shapes(render_opt, specs)
        plans[nid] = NodePlans(
            implicit=implicit, rendering=rendering,
            sampler=sampler_cfg, barf_cfg=barf_cfg, class_id=CLASS_IDS[nid],
            fused_query=fused_sampler and use_fused_query(implicit, sampler_cfg),
            fused_render=fused_render and supports_fused_render(implicit, rendering),
            fused_train=(fused_train and fused_render
                         and supports_fused_render(implicit, rendering)),
            remat=remat,
        )
    return Scene(
        node_ids=node_ids, servers=servers, plans=plans,
        bg_plans=background_plans(opt_model),
        n_frames=int(scene_data["n_frames"]), sampler_cfg=sampler_cfg, device=device,
        sub_ops=sub_ops, opt_model=opt_model,
    )


def init_scene_params(gen: torch.Generator, scene: Scene, scene_data: dict) -> dict:
    """Trainable tree: per-node nets, density, pose tables; background.
    Random weights come from ``gen`` (a CPU generator), then move to the
    scene's device."""
    entities = scene_data["entities"]
    opt_model = scene.opt_model

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)

    params = {}
    for nid in scene.node_ids:
        density = init_laplace_density(opt_model["density"]["params_init"],
                                       opt_model["density"]["beta_min"])
        if nid == "object":
            e = entities["object"]
            node = {
                "implicit": init_implicit_net(gen, opt_model["implicit_network"], OBJECT_SPECS),
                "rendering": init_rendering_net(gen, _object_render_opt(opt_model), OBJECT_SPECS),
                "density": density,
                "tables": {
                    "global_orient": f32(e["object_poses"][:, :3]),
                    "transl": f32(e["object_poses"][:, 3:]),
                },
                "frame_latent": torch.randn((scene.n_frames, TIME_CODE_DIM), generator=gen),
                "obj_scale": f32(float(e["obj_scale"])),
            }
        else:
            e = entities[nid]
            node = {
                "implicit": init_implicit_net(gen, opt_model["implicit_network"], MANO_SPECS),
                "rendering": init_rendering_net(gen, opt_model["rendering_network"], MANO_SPECS),
                "density": density,
                "tables": {
                    "betas": f32(e["mean_shape"])[None],
                    "global_orient": f32(e["hand_poses"][:, :3]),
                    "pose": f32(e["hand_poses"][:, 3:]),
                    "transl": f32(e["hand_trans"]),
                },
            }
        params[nid] = node
    params["background"] = init_background(gen, opt_model, scene.n_frames)
    return leaf_params(params, scene.device)


def empty_object_mesh_state(device) -> dict:
    """Fixed-shape buffers for the object's canonical mesh, before meshing:
    the far-padded bound rows (1e4) make every ray off-surface, and
    ``valid`` = 0 disables the object's sparse/eikonal terms."""
    return {
        "centers": torch.zeros((OBJ_CENTERS, 3), device=device),
        "bound_centers": torch.full((OBJ_BOUND_V, 3), 1e4, device=device),
        "sigma_xyz": torch.ones((3,), device=device),
        "h_margin": torch.tensor(0.0, device=device),
        "valid": torch.tensor(0.0, device=device),
    }


def sample_step_draws(scene: Scene, B: int, P: int, gen: torch.Generator) -> dict:
    """Every random number one training step's loss targets and background
    use, made from ``gen`` on the scene's device."""
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
    draws["bg_u"] = torch.rand((B * P, scene.sampler_cfg.N_samples_inverse_sphere),
                               generator=gen, device=dev)
    return draws


# --------------------------------------------------------------------------
# Loss-target preparation
# --------------------------------------------------------------------------

def _eikonal_grad_samples(nparams, plans, centers, local_sigma, sigma_xyz, step,
                          idx, noise, glob_u):
    """SDF gradient at jittered samples around ``centers[:, idx]`` (B,N,3)."""
    pts = point_in_space_sample(centers[:, idx], local_sigma, sigma_xyz, noise, glob_u)
    B, N = pts.shape[:2]
    with torch.enable_grad():
        p = pts.reshape(-1, 3).detach().requires_grad_(True)
        h = apply_implicit_trunk(nparams["implicit"], plans.implicit, p, None, step=step,
                                 barf_cfg=plans.barf_cfg)
        sdf = implicit_sdf_from_trunk(nparams["implicit"], h)
        (g,) = torch.autograd.grad(sdf.sum(), p, create_graph=True)
    return g.reshape(B, N, 3)


def prepare_loss_targets_hand(nparams, scene: Scene, nid: str, sample_dict: dict,
                              step, draws: dict) -> dict:
    plans = scene.plans[nid]
    M_sub, faces_div = scene.sub_ops[nid]
    B, P = sample_dict["canonical_pts"].shape[:2]
    cond_pose = sample_dict["cond_pose"]

    # subdivided sealed canonical mesh from the batch's first frame
    v_div = M_sub @ sample_dict["v_posed"][0]
    surf = sample_on_mesh_barycentric(v_div[None].expand(B, -1, -1), faces_div,
                                      *draws[f"{nid}.bary"])
    samples = point_in_space_sample(surf, 0.008, HAND_GLOBAL_SIGMA_XYZ, *draws[f"{nid}.surf"])
    Ns = samples.shape[1]
    with torch.no_grad():  # detached ground truth
        gt_sdf = torch.stack([
            signed_distance_to_mesh(samples[b], v_div, faces_div) for b in range(B)
        ])
    pred = apply_implicit_net(nparams["implicit"], plans.implicit, samples.reshape(-1, 3),
                              _flat_per_point(cond_pose, Ns), step=step,
                              barf_cfg=plans.barf_cfg)
    v_div = v_div.detach()
    h_margin = face_circumradius_bound(v_div, faces_div)
    return {
        "pts2mano_sdf_cano": gt_sdf,
        "pred_sdf": pred[:, 0].reshape(B, Ns),
        # conservative vertex-distance bound in place of the exact sweep
        "index_off_surface": off_surface_by_vertex_bound(
            sample_dict["canonical_pts"].reshape(-1, 3), v_div, B * P, 0.01, h_margin
        ),
        "grad_theta": _eikonal_grad_samples(
            nparams, plans, scene.servers[nid].verts_c.expand(B, -1, -1), 0.008,
            HAND_GLOBAL_SIGMA_XYZ, step, draws[f"{nid}.eik_idx"], *draws[f"{nid}.eik"],
        ),
        # the reference activates these targets once its canonical mesh
        # exists (step 200)
        "active": torch.tensor(float(step >= 200), device=scene.device),
    }


def prepare_loss_targets_object(nparams, scene: Scene, sample_dict: dict, mesh_state: dict,
                                step, draws: dict) -> dict:
    plans = scene.plans["object"]
    B, P = sample_dict["canonical_pts"].shape[:2]
    return {
        "index_off_surface": off_surface_by_vertex_bound(
            sample_dict["canonical_pts"].reshape(-1, 3), mesh_state["bound_centers"],
            B * P, 0.05, mesh_state["h_margin"],
        ),
        "grad_theta": _eikonal_grad_samples(
            nparams, plans, mesh_state["centers"][None].expand(B, -1, -1), 0.03,
            mesh_state["sigma_xyz"], step, draws["object.eik_idx"], *draws["object.eik"],
        ),
        "active": mesh_state["valid"],
    }


# --------------------------------------------------------------------------
# Scene forward
# --------------------------------------------------------------------------

def _rays(batch):
    B, P = batch["uv"].shape[:2]
    ray_dirs_b, cam_loc_b = get_camera_rays(batch["uv"], batch["extrinsics"],
                                            batch["intrinsics"])
    cam_loc = cam_loc_b[:, None, :].expand(B, P, 3).reshape(-1, 3)
    return ray_dirs_b.reshape(-1, 3), cam_loc


@torch.no_grad()
def sample_all_z(params, scene: Scene, batch, gen, step, epoch) -> dict:
    """Sampler stage: per-node error-bound z tables (no gradient)."""
    ray_dirs, cam_loc = _rays(batch)
    out = {}
    for nid in scene.node_ids:
        fn = object_node_sample_z if nid == "object" else mano_node_sample_z
        out[nid] = fn(params[nid], scene.servers[nid], scene.plans[nid], batch, ray_dirs,
                      cam_loc, step, epoch, gen)
    return out


def holdnet_forward(params, scene: Scene, batch, mesh_state, draws, step, epoch,
                    z_vals_dict: dict) -> dict:
    """Grad stage at the sampler's z tables: composited render + loss
    targets.  batch: frame_idx (B,), uv (B,P,2), intrinsics/extrinsics
    (B,4,4), scene_scale; draws from ``sample_step_draws``."""
    B, P = batch["uv"].shape[:2]
    ray_dirs, cam_loc = _rays(batch)
    out = {}
    factors_list, sample_dicts = [], {}
    for nid in scene.node_ids:
        fn = object_node_forward if nid == "object" else mano_node_forward
        factors, sd = fn(params[nid], scene.servers[nid], scene.plans[nid], batch, ray_dirs,
                         cam_loc, step, epoch, z_vals_dict[nid])
        factors_list.append(factors)
        sample_dicts[nid] = sd

    for nid in scene.node_ids:
        if nid == "object":
            tgt = prepare_loss_targets_object(params[nid], scene, sample_dicts[nid],
                                              mesh_state, step, draws)
        else:
            tgt = prepare_loss_targets_hand(params[nid], scene, nid, sample_dicts[nid],
                                            step, draws)
        out.update({f"{nid}.{k}": v for k, v in tgt.items()})

    out.update(volumetric_render(merge_factors(factors_list)))
    for nid, factors in zip(scene.node_ids, factors_list):
        f = dict(factors)
        f["z_max"] = f["z_vals"][:, -1]
        out.update({f"{nid}.{k}": v for k, v in volumetric_render(f).items()})

    radius = scene.sampler_cfg.scene_bounding_sphere
    bg_z = inverse_sphere_z_vals(
        draws["bg_u"], B * P, scene.sampler_cfg.N_samples_inverse_sphere, device=scene.device,
    ) * (1.0 / radius)
    frame_idx = batch["frame_idx"][:, None].expand(B, P).reshape(-1)
    bg = background_forward(params["background"], scene.bg_plans, out["bg_weights"],
                            ray_dirs, cam_loc, bg_z, frame_idx, radius, step=step)
    out["rgb"] = out["fg_rgb"] + bg["bg_rgb"]
    out["semantics"] = out["fg_semantics"] + bg["bg_semantics"]
    return out


def render_packs(params, scene: Scene) -> dict:
    """The fused render's weight packs of every node that uses it, to build
    once per set of params and pass to each ``holdnet_render`` call."""
    return {nid: node_render_packs(params[nid], scene.plans[nid], scene.device)
            for nid in scene.node_ids if scene.plans[nid].fused_render}


@torch.no_grad()
def holdnet_render(params, scene: Scene, batch, z_vals_dict: dict,
                   packs: dict | None = None) -> dict:
    """Inference composite at the eval sampler's z tables, with no step (the
    BARF window open): the merged and per-node renders (with
    ``fg_rgb_vis``), the background on its even grid, ``rgb``,
    ``semantics``, ``bg_rgb_only`` and ``instance_map`` (argmax of the
    semantics).  ``packs`` is ``render_packs``'s, built here when not
    given."""
    B, P = batch["uv"].shape[:2]
    ray_dirs, cam_loc = _rays(batch)
    if packs is None:
        packs = render_packs(params, scene)
    factors_list = []
    for nid in scene.node_ids:
        fn = object_node_render if nid == "object" else mano_node_render
        factors, _ = fn(params[nid], scene.servers[nid], scene.plans[nid], batch, ray_dirs,
                        cam_loc, z_vals_dict[nid], packs.get(nid))
        factors_list.append(factors)
    out = volumetric_render(merge_factors(factors_list), vis=True)
    for nid, factors in zip(scene.node_ids, factors_list):
        f = dict(factors)
        f["z_max"] = f["z_vals"][:, -1]
        out.update({f"{nid}.{k}": v for k, v in volumetric_render(f, vis=True).items()})

    radius = scene.sampler_cfg.scene_bounding_sphere
    bg_z = inverse_sphere_z_vals(
        None, B * P, scene.sampler_cfg.N_samples_inverse_sphere, device=scene.device,
    ) * (1.0 / radius)
    frame_idx = batch["frame_idx"][:, None].expand(B, P).reshape(-1)
    bg = background_forward(params["background"], scene.bg_plans, out["bg_weights"],
                            ray_dirs, cam_loc, bg_z, frame_idx, radius, step=None)
    out["rgb"] = out["fg_rgb"] + bg["bg_rgb"]
    out["semantics"] = out["fg_semantics"] + bg["bg_semantics"]
    out["bg_rgb_only"] = bg["bg_rgb_only"]
    out["instance_map"] = torch.argmax(out["semantics"], dim=1)
    return out
