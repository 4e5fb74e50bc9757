"""Scene nodes: the MANO hand and the rigid object (counterpart of
hold_tpu/models/nodes.py).

Each node owns a canonical SDF field, a color field, a Laplace density, and
per-frame pose tables; a deformer warps deformed-space ray samples into the
canonical field.  Training runs in two stages:

- ``*_node_sample_z``: the error-bound sampler, stop-gradient.  Its SDF
  queries run the trunk in bfloat16 (sample placement tolerates it).  By
  default (``NodePlans.fused_query``) each round's query is one fused
  kernel per node (``ops/fused_query.py``: warp, embedding, trunk and head
  from the z table); otherwise the layer-by-layer path warps the hand's
  points with the ``knn_inverse_warp`` kernel and runs the trunk in torch.
  In proposal mode (after the proposal's warmup) the queries read the
  proposal net instead, the hand's points warped by ``knn_inverse_warp``.
  The knobs of ``NodePlans``: the fused query's relu trunk
  (``sampler_relu``), the hand's search on every n-th vertex
  (``knn_stride``) and each ray's interval clipped to the node's bounding
  sphere (``node_bounds``).
- ``*_node_forward``: the grad stage.  The hand's warp and inverse skinning
  Jacobian are the ``knn_inverse_warp_diff`` and ``knn_jacobian_inverse``
  kernels.  Where the kernels take the node's nets (``NodePlans.fused_shade``)
  the shade (SDF, its gradient for the normal, features, color) is the fused
  training shade (``ops/fused_shade.py``: one forward kernel per node, and a
  backward that recomputes it and applies the second-order chain, its J^-1
  gradient going on to the Jacobian kernel's backward).  Otherwise it runs
  chunked over the points (``ops/chunk.py``), with the SDF gradient taken
  with ``create_graph=True`` so the loss differentiates through it, each
  chunk recomputed in the backward; with ``NodePlans.shade_bf16`` (on the
  card, as the JAX package on its accelerator) the trunk's and the colour
  net's products run in bfloat16.

Rendering (``*_node_render``, the JAX forwards at ``training=False``) runs
under ``torch.no_grad()`` at the eval sampler's z table.  With
``NodePlans.fused_shade`` each node's shade is one fused kernel
(``ops/fused_render.py``: warp, J^-1, trunk, normal and colour); otherwise it
is the grad stage's warps and chunked shade without the graph.

A batch carries B frames x P pixels; ray tensors are flat (R = B*P); warp
tensors keep the (B, P*S) frame grouping because bone transforms differ per
frame.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..mano.server import ManoServerState, mano_server_forward
from ..ops.chunk import map_chunked
from ..ops.fused_query import fused_hand_sampler_sdf_z, fused_object_sampler_sdf_z
from ..ops.fused_render import frame_bias0, fused_hand_render, fused_object_render
from ..ops.fused_shade import fused_shade_train
from ..ops.knn import knn_inverse_warp, knn_inverse_warp_diff, knn_jacobian_inverse
from ..ops.weight_pack import (
    pack_color_weights,
    pack_trunk_transposed,
    pack_trunk_weights,
    tile_shade_fwd,
)
from ..render.ray_sampler import SamplerConfig, error_bound_z_vals, node_ray_interval
from ..utils.transforms import inverse_mat3, safe_norm
from .density import laplace_beta, laplace_density
from .embedders import embed_window
from .mlp import (
    _apply_linear,
    apply_implicit_trunk,
    apply_proposal_net,
    apply_rendering_net,
    cast_tree,
    implicit_feat_from_trunk,
    implicit_sdf_from_trunk,
    resolve_weight_norm,
)
from .object_model import ObjectServerState, object_deform, object_server_forward
from .specs import MAX_CLASS


class NodePlans(NamedTuple):
    implicit: dict
    rendering: dict
    sampler: SamplerConfig
    barf_cfg: tuple
    class_id: int
    knn_k: int = 15
    max_dist: float = 0.1
    fused_query: bool = False  # sampler queries through ops/fused_query.py
    # the grad stage's and the render's shade through ops/fused_shade.py and
    # ops/fused_render.py
    fused_shade: bool = False
    # the chunked shade's trunk and colour net in bf16 (the JAX _shade_params)
    shade_bf16: bool = False
    # the vertex searches' tile orders (ops/knn.py tile_order), int32, hands
    # only: of the MANO vertices and of the subdivided mesh's
    tile_order: torch.Tensor | None = None
    sub_tile_order: torch.Tensor | None = None
    # the proposal net's plan (models/mlp.py proposal_net_shapes), or None
    proposal: dict | None = None
    sampler_relu: bool = False  # the fused query's relu trunk (HOLD_SAMPLER_RELU)
    node_bounds: bool = False  # the sampler's rays clipped to the node (HOLD_NODE_BOUNDS)
    # the sampler's searches on every knn_stride-th MANO vertex, in the tile
    # order of that set (HOLD_SAMPLER_KNN_STRIDE); hands only
    knn_stride: int = 1
    stride_tile_order: torch.Tensor | None = None


def _flat_per_point(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, C) -> (B*n, C): per-frame vectors repeated for each point."""
    B, C = x.shape
    return x[:, None, :].expand(B, n, C).reshape(B * n, C)


def _mano_pose(nparams, server: ManoServerState, batch, epoch):
    tables, frame_idx = nparams["tables"], batch["frame_idx"]
    B = frame_idx.shape[0]
    full_pose = torch.cat(
        [tables["global_orient"][frame_idx], tables["pose"][frame_idx]], dim=-1
    )
    srv_out = mano_server_forward(
        server, batch["scene_scale"], tables["transl"][frame_idx], full_pose,
        tables["betas"].expand(B, -1),
    )
    # pose conditioning: /pi normalisation, zeroed for epochs < 20
    cond_pose = full_pose[:, 3:] / math.pi
    if epoch is not None and epoch < 20:
        cond_pose = cond_pose * 0.0
    return srv_out, cond_pose


def _object_pose(nparams, server: ObjectServerState, batch):
    tables, frame_idx = nparams["tables"], batch["frame_idx"]
    return object_server_forward(
        server, batch["scene_scale"], tables["transl"][frame_idx],
        tables["global_orient"][frame_idx], obj_scale=nparams.get("obj_scale"),
    )


def _semantics(plans: NodePlans, R: int, S: int, device) -> torch.Tensor:
    sem = torch.zeros((R, S, MAX_CLASS), device=device)
    sem[:, :, plans.class_id] = 1.0
    return sem


def _shade_sdf_and_grad(imp, plans, xc, step, create_graph=True, trunk=None):
    """SDF trunk + width-1 head at ``xc`` and d(sdf)/d(xc), with its graph
    when ``create_graph`` (the grad stage), else detached (rendering).  The
    trunk runs on ``trunk`` (default ``imp``; a bf16 copy runs it in bf16),
    the head always on ``imp`` in float32."""
    with torch.enable_grad():
        if not xc.requires_grad:
            xc = xc.detach().requires_grad_(True)
        h = apply_implicit_trunk(imp if trunk is None else trunk, plans.implicit, xc, None,
                                 step=step, barf_cfg=plans.barf_cfg)
        sdf = implicit_sdf_from_trunk(imp, h)
        (g,) = torch.autograd.grad(sdf, xc, torch.ones_like(sdf), create_graph=create_graph)
    if not create_graph:
        xc, sdf, h = xc.detach(), sdf.detach(), h.detach()
    return xc, sdf, h, g


def _tree_tensors(*trees) -> tuple:
    """Every tensor of nested dicts and lists: what a chunk body closes over."""
    out = []
    for t in trees:
        if isinstance(t, dict):
            out.extend(_tree_tensors(*t.values()))
        elif isinstance(t, (list, tuple)):
            out.extend(_tree_tensors(*t))
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return tuple(out)


def _normalize(n: torch.Tensor) -> torch.Tensor:
    return n / torch.clamp(safe_norm(n, keepdim=True), min=1e-6)


def _shade_params(plans: NodePlans, tree: dict) -> dict:
    """The chunked shade's copy of a parameter tree: bf16 with
    ``plans.shade_bf16`` (the JAX ``_shade_params``), else the tree itself.
    The cast is part of the graph, so the f32 params get f32 gradients."""
    return cast_tree(tree, torch.bfloat16) if plans.shade_bf16 else tree


def _fused_shade(imp, rend, plans, x_c, jinv9, fb0, step):
    """The fused training shade at (B, N) canonical points, with the packs
    built from the live params so that their gradients reach them."""
    # the transposed pack from the params too, not from the forward pack, so
    # that the two packs' gradients add up in f32 at the params, as in JAX
    return fused_shade_train(
        x_c, jinv9, fb0, embed_window(plans.implicit, step, plans.barf_cfg, x_c.device),
        pack_trunk_weights(imp, plans.implicit), pack_trunk_transposed(imp, plans.implicit),
        pack_color_weights(rend, imp))


def _node_outputs(plans, nparams, z_vals, sdf, rgb, normals, B, P, S_f):
    return {
        "color": rgb.reshape(B * P, S_f, 3),
        "normal": normals.reshape(B * P, S_f, 3),
        "density": laplace_density(nparams["density"], sdf).reshape(B * P, S_f, 1),
        "semantics": _semantics(plans, B * P, S_f, z_vals.device),
        "z_vals": z_vals,
    }


# --------------------------------------------------------------------------
# Grad stage
# --------------------------------------------------------------------------

def mano_node_forward(nparams, server: ManoServerState, plans: NodePlans, batch,
                      ray_dirs, cam_loc, step, epoch, z_vals, create_graph=True):
    """Returns (factors, sample_dict) for the hand at the given z table;
    ``create_graph=False`` leaves the SDF gradient out of the graph."""
    B, P = batch["uv"].shape[:2]
    imp = resolve_weight_norm(nparams["implicit"])
    rend = resolve_weight_norm(nparams["rendering"])
    srv_out, cond_pose = _mano_pose(nparams, server, batch, epoch)
    tfs = srv_out.tfs.contiguous()
    verts_posed = srv_out.verts.contiguous()
    verts_c = server.verts_c.expand(B, -1, -1).contiguous()
    skin_w = server.skin_weights_c.expand(B, -1, -1).contiguous()

    S_f = z_vals.shape[1]
    pts = (cam_loc[:, None, :] + z_vals[:, :, None] * ray_dirs[:, None, :]).reshape(B, P * S_f, 3)
    x_c, outlier = knn_inverse_warp_diff(
        pts, verts_posed, skin_w, tfs, K=plans.knn_k, max_dist=plans.max_dist,
        order=plans.tile_order,
    )
    # inverse skinning Jacobian at the canonical points (weights queried
    # against the CANONICAL vertices)
    jinv9 = knn_jacobian_inverse(x_c, verts_c, skin_w, tfs, K=plans.knn_k,
                                 order=plans.tile_order)
    sample_dict = {
        "canonical_pts": x_c.reshape(B, P, S_f, 3),
        "cond_pose": cond_pose,
        "tfs": tfs,
        "verts_posed": verts_posed,
        "v_posed": srv_out.v_posed,
        "jnts": srv_out.jnts,
        "outlier": outlier,
    }
    if plans.fused_shade:
        pe = _apply_linear(rend["lin_pose"], cond_pose).float()  # (B, 8), once per frame
        sdf, rgb, normals = _fused_shade(imp, rend, plans, x_c, jinv9, frame_bias0(rend, pe), step)
        sample_dict["sample_sdf"] = sdf.reshape(B, P, S_f)
        return _node_outputs(plans, nparams, z_vals, sdf.reshape(-1), rgb, normals, B, P,
                             S_f), sample_dict
    jinv9 = jinv9.reshape(-1, 9)
    view = -ray_dirs[:, None, :].expand(B * P, S_f, 3).reshape(-1, 3)
    # lin_pose once per frame, then broadcast to the frame's points
    pe_pp = _flat_per_point(
        _apply_linear(_shade_params(plans, rend["lin_pose"]), cond_pose).float(), P * S_f)

    def shade(xc, pe, vw, jinv):
        # cast in the chunk: each chunk's gradients reach the params in f32
        imp_sh, rend_sh = _shade_params(plans, imp), _shade_params(plans, rend)
        xc, sdf, h, g = _shade_sdf_and_grad(imp, plans, xc, step, create_graph, trunk=imp_sh)
        feat = implicit_feat_from_trunk(imp_sh, h)
        # n_j = sum_i g_i (J^-1)_ij with J^-1 row-major
        nrm = _normalize(torch.stack(
            [sum(g[:, i] * jinv[:, 3 * i + j] for i in range(3)) for j in range(3)], dim=-1
        ))
        rgb = apply_rendering_net(rend_sh, plans.rendering, xc, nrm, vw, None, feat,
                                  step=step, barf_cfg=plans.barf_cfg, pose_embed=pe)
        return sdf, rgb, nrm

    sdf, rgb, normals = map_chunked(shade, (x_c.reshape(-1, 3), pe_pp, view, jinv9),
                                    B * P * S_f, closed=_tree_tensors(imp, rend))
    factors = _node_outputs(plans, nparams, z_vals, sdf, rgb, normals, B, P, S_f)
    sample_dict["sample_sdf"] = sdf.reshape(B, P, S_f)
    return factors, sample_dict


def object_node_forward(nparams, server: ObjectServerState, plans: NodePlans, batch,
                        ray_dirs, cam_loc, step, epoch, z_vals, create_graph=True):
    B, P = batch["uv"].shape[:2]
    imp = resolve_weight_norm(nparams["implicit"])
    rend = resolve_weight_norm(nparams["rendering"])
    tfs = _object_pose(nparams, server, batch).obj_tfs
    time_code = nparams["frame_latent"][batch["frame_idx"]]

    S_f = z_vals.shape[1]
    N = B * P * S_f
    pts = (cam_loc[:, None, :] + z_vals[:, :, None] * ray_dirs[:, None, :]).reshape(B, P * S_f, 3)
    x_c = object_deform(pts, tfs, inverse=True)
    sample_dict = {
        "canonical_pts": x_c.reshape(B, P, S_f, 3),
        "tfs": tfs,
    }
    if plans.fused_shade:
        # J^-1 = Rinv, the same for every point of a frame
        jinv9 = inverse_mat3(tfs[:, :3, :3]).reshape(B, 1, 9).expand(B, P * S_f, 9)
        fb0 = frame_bias0(rend, torch.zeros((B, 8), device=pts.device), time_code)
        sdf, rgb, normals = _fused_shade(imp, rend, plans, x_c, jinv9, fb0, step)
        sample_dict["sample_sdf"] = sdf.reshape(B, P, S_f)
        return _node_outputs(plans, nparams, z_vals, sdf.reshape(-1), rgb, normals, B, P,
                             S_f), sample_dict
    # rigid deformer: J = R per frame, n = g R^-1
    rinv = inverse_mat3(tfs[:, :3, :3])[:, None].expand(B, P * S_f, 3, 3).reshape(N, 3, 3)
    tc_pp = _flat_per_point(time_code, P * S_f)
    view = -ray_dirs[:, None, :].expand(B * P, S_f, 3).reshape(-1, 3)

    def shade(xc, vw, jinv, tc):
        imp_sh, rend_sh = _shade_params(plans, imp), _shade_params(plans, rend)
        xc, sdf, h, g = _shade_sdf_and_grad(imp, plans, xc, step, create_graph, trunk=imp_sh)
        feat = implicit_feat_from_trunk(imp_sh, h)
        nrm = _normalize(torch.einsum("ni,nij->nj", g, jinv))
        rgb = apply_rendering_net(
            rend_sh, plans.rendering, xc, nrm, vw, None,
            torch.cat([feat.to(tc.dtype), tc], dim=-1), step=step, barf_cfg=plans.barf_cfg,
        )
        return sdf, rgb, nrm

    sdf, rgb, normals = map_chunked(shade, (x_c.reshape(-1, 3), view, rinv, tc_pp), N,
                                    closed=_tree_tensors(imp, rend))
    factors = _node_outputs(plans, nparams, z_vals, sdf, rgb, normals, B, P, S_f)
    sample_dict["sample_sdf"] = sdf.reshape(B, P, S_f)
    return factors, sample_dict


# --------------------------------------------------------------------------
# Rendering
# --------------------------------------------------------------------------

def _world_points(ray_dirs, cam_loc, z_vals, B):
    return (cam_loc[:, None, :] + z_vals[:, :, None] * ray_dirs[:, None, :]).reshape(
        B, -1, 3).contiguous()


@torch.no_grad()
def node_render_packs(nparams, plans: NodePlans, device) -> tuple:
    """The fused render's weights for one node, (window, trunk pack,
    transposed pack, colour pack): built once per set of params and shared by
    every chunk.  On the card the colour pack also carries the shade kernel's
    weight stream (``"stream"``).  No step when rendering: the BARF window is
    open."""
    imp = resolve_weight_norm(nparams["implicit"])
    fwd = pack_trunk_weights(imp, plans.implicit)
    tpack = pack_trunk_transposed(imp, plans.implicit, fwd)
    cpack = pack_color_weights(resolve_weight_norm(nparams["rendering"]), imp)
    if fwd["bf16"].is_cuda:
        cpack["stream"] = tile_shade_fwd(fwd, tpack, cpack)
    return embed_window(plans.implicit, None, plans.barf_cfg, device), fwd, tpack, cpack


@torch.no_grad()
def mano_node_render(nparams, server: ManoServerState, plans: NodePlans, batch, ray_dirs,
                     cam_loc, z_vals, packs=None):
    """The hand's inference forward (the JAX ``mano_node_forward`` at
    ``training=False``): (factors, sample_dict), no gradient.  The pose
    conditioning is not zeroed (no epoch).  ``packs`` is
    ``node_render_packs``'s, built here when not given."""
    if not plans.fused_shade:
        return mano_node_forward(nparams, server, plans, batch, ray_dirs, cam_loc, None, None,
                                 z_vals, create_graph=False)
    B, P = batch["uv"].shape[:2]
    rend = resolve_weight_norm(nparams["rendering"])
    srv_out, cond_pose = _mano_pose(nparams, server, batch, None)
    tfs = srv_out.tfs.contiguous()
    verts_posed = srv_out.verts.contiguous()
    verts_c = server.verts_c.expand(B, -1, -1).contiguous()
    skin_w = server.skin_weights_c.expand(B, -1, -1).contiguous()
    S_f = z_vals.shape[1]
    pts = _world_points(ray_dirs, cam_loc, z_vals, B)
    pe = _apply_linear(rend["lin_pose"], cond_pose).float()  # (B, 8), f32
    if packs is None:
        packs = node_render_packs(nparams, plans, pts.device)
    sdf, rgb, nrm, dist, x_c = fused_hand_render(
        pts, verts_posed, verts_c, skin_w, tfs, *packs, frame_bias0(rend, pe), K=plans.knn_k,
        order=plans.tile_order)
    factors = _node_outputs(plans, nparams, z_vals, sdf.reshape(-1), rgb, nrm, B, P, S_f)
    sample_dict = {
        "canonical_pts": x_c.reshape(B, P, S_f, 3),
        "cond_pose": cond_pose,
        "tfs": tfs,
        "verts_posed": verts_posed,
        "v_posed": srv_out.v_posed,
        "jnts": srv_out.jnts,
        "outlier": dist > plans.max_dist,
    }
    return factors, sample_dict


@torch.no_grad()
def object_node_render(nparams, server: ObjectServerState, plans: NodePlans, batch, ray_dirs,
                       cam_loc, z_vals, packs=None):
    """The object's inference forward: its colour net takes no pose
    embedding and the frame latent as its time code."""
    if not plans.fused_shade:
        return object_node_forward(nparams, server, plans, batch, ray_dirs, cam_loc, None, None,
                                   z_vals, create_graph=False)
    B, P = batch["uv"].shape[:2]
    rend = resolve_weight_norm(nparams["rendering"])
    srv_out = _object_pose(nparams, server, batch)
    tfs = srv_out.obj_tfs
    time_code = nparams["frame_latent"][batch["frame_idx"]]
    tf12 = torch.cat([inverse_mat3(tfs[:, :3, :3]).reshape(B, 9), tfs[:, :3, 3]], dim=-1)
    S_f = z_vals.shape[1]
    pts = _world_points(ray_dirs, cam_loc, z_vals, B)
    fb0 = frame_bias0(rend, torch.zeros((B, 8), device=pts.device), time_code)
    if packs is None:
        packs = node_render_packs(nparams, plans, pts.device)
    sdf, rgb, nrm, _, x_c = fused_object_render(pts, tf12.contiguous(), *packs, fb0)
    factors = _node_outputs(plans, nparams, z_vals, sdf.reshape(-1), rgb, nrm, B, P, S_f)
    sample_dict = {
        "canonical_pts": x_c.reshape(B, P, S_f, 3),
        "tfs": tfs,
        "verts_posed": srv_out.verts,
    }
    return factors, sample_dict


# --------------------------------------------------------------------------
# Sampler stage
# --------------------------------------------------------------------------

def _bf16_trunk_sdf(implicit_bf16, plans, x_c, step):
    h = apply_implicit_trunk(implicit_bf16, plans.implicit, x_c, None, step=step,
                             barf_cfg=plans.barf_cfg)
    return implicit_sdf_from_trunk(implicit_bf16, h).float()


def _use_proposal(nparams, plans: NodePlans, proposal_mode: bool) -> bool:
    return proposal_mode and plans.proposal is not None and "proposal" in nparams


def _proposal_query_z(nparams, plans: NodePlans, ray_dirs, cam_loc, B, P, to_canonical, step):
    """The sampler's query through the proposal net on its bf16 tree: world
    points -> canonical (``to_canonical``, (B, N, 3) -> (B, N, 3)) -> the
    surrogate sdf, clipped to +-2 scene radii as the distillation target is
    (the density is saturated beyond)."""
    prop_bf16 = cast_tree(nparams["proposal"], torch.bfloat16)
    clip_v = 2.0 * plans.sampler.scene_bounding_sphere

    def query_z(z_RS):
        S = z_RS.shape[1]
        pts = (cam_loc[:, None, :] + z_RS[:, :, None] * ray_dirs[:, None, :]).reshape(B, P * S, 3)
        sdf = apply_proposal_net(prop_bf16, plans.proposal, to_canonical(pts).reshape(-1, 3),
                                 step=step, barf_cfg=plans.barf_cfg,
                                 embedding=plans.implicit["embedding"])
        return torch.clamp(sdf, -clip_v, clip_v).reshape(B * P, S)

    return query_z


def _node_bound_sphere(verts_posed: torch.Tensor, P: int, margin: float) -> tuple:
    """(B, V, 3) posed points -> per-ray centres (B*P, 3) and radii (B*P,):
    each frame's centroid and its farthest point's distance times
    ``margin``."""
    B = verts_posed.shape[0]
    center_b = verts_posed.mean(dim=1)
    rad_b = torch.linalg.norm(verts_posed - center_b[:, None], dim=-1).amax(dim=1) * margin
    return (center_b[:, None, :].expand(B, P, 3).reshape(-1, 3),
            rad_b[:, None].expand(B, P).reshape(-1))


def _sampler_vertex_set(plans: NodePlans, verts_posed, skin_w) -> tuple:
    """The hand's vertices, skinning weights and tile order the sampler's
    searches use: every ``knn_stride``-th vertex (the JAX package's
    ``HOLD_SAMPLER_KNN_STRIDE``); the grad stage always searches them all."""
    n = plans.knn_stride
    if n == 1:
        return verts_posed, skin_w, plans.tile_order
    return (verts_posed[:, ::n].contiguous(), skin_w[:, ::n].contiguous(),
            plans.stride_tile_order)


@torch.no_grad()
def mano_node_sample_z(nparams, server, plans: NodePlans, batch, ray_dirs, cam_loc,
                       step, epoch, gen, proposal_mode: bool = False):
    """Stop-gradient error-bound z table (R, S_f) for the hand.  In
    ``proposal_mode`` (with a proposal net) the queries warp the points with
    the ``knn_inverse_warp`` kernel and read the proposal net; otherwise the
    fused query kernel, or the trunk layer by layer."""
    B, P = batch["uv"].shape[:2]
    srv_out, _ = _mano_pose(nparams, server, batch, epoch)
    tfs = srv_out.tfs.contiguous()
    verts_posed = srv_out.verts.contiguous()
    skin_w = server.skin_weights_c.expand(B, -1, -1).contiguous()
    beta0 = laplace_beta(nparams["density"])
    near = far = None
    if plans.node_bounds:
        center, radius = _node_bound_sphere(verts_posed, P, 1.15)
        near, far = node_ray_interval(cam_loc, ray_dirs, center, radius + plans.max_dist,
                                      plans.sampler)
    q_verts, q_skin, q_order = _sampler_vertex_set(plans, verts_posed, skin_w)

    query_z = sampler_sdf = None
    if _use_proposal(nparams, plans, proposal_mode):
        def to_canonical(pts):
            return knn_inverse_warp(pts, q_verts, q_skin, tfs, K=plans.knn_k,
                                    max_dist=plans.max_dist, order=q_order)[0]

        query_z = _proposal_query_z(nparams, plans, ray_dirs, cam_loc, B, P, to_canonical, step)
    elif plans.fused_query:
        pack = pack_trunk_weights(resolve_weight_norm(nparams["implicit"]), plans.implicit)
        window = embed_window(plans.implicit, step, plans.barf_cfg, ray_dirs.device)
        dirs, cams = ray_dirs.contiguous(), cam_loc.contiguous()

        def query_z(z_RS):
            sdf = fused_hand_sampler_sdf_z(dirs, cams, z_RS.reshape(B, P, -1).contiguous(),
                                           q_verts, q_skin, tfs, window, pack, K=plans.knn_k,
                                           relu=plans.sampler_relu, order=q_order)
            return sdf.reshape(B * P, -1)
    else:
        implicit_bf16 = cast_tree(resolve_weight_norm(nparams["implicit"]), torch.bfloat16)

        def sampler_sdf(pts_RS3):
            S = pts_RS3.shape[1]
            x_c, _ = knn_inverse_warp(pts_RS3.reshape(B, P * S, 3), verts_posed, skin_w, tfs,
                                      K=plans.knn_k, max_dist=plans.max_dist,
                                      order=plans.tile_order)
            return _bf16_trunk_sdf(implicit_bf16, plans, x_c.reshape(-1, 3),
                                   step).reshape(B * P, S)

    return error_bound_z_vals(gen, sampler_sdf, ray_dirs, cam_loc, beta0, plans.sampler,
                              query_z_fn=query_z, near=near, far=far)


@torch.no_grad()
def object_node_sample_z(nparams, server, plans: NodePlans, batch, ray_dirs, cam_loc,
                         step, epoch, gen, proposal_mode: bool = False):
    """Stop-gradient error-bound z table (R, S_f) for the object."""
    B, P = batch["uv"].shape[:2]
    srv_out = _object_pose(nparams, server, batch)
    tfs = srv_out.obj_tfs
    beta0 = laplace_beta(nparams["density"])
    near = far = None
    if plans.node_bounds:
        # the sparse points' sphere with a wide margin, the radius floored so
        # that the geometric init's sphere always lies inside
        center, radius = _node_bound_sphere(srv_out.verts, P, 1.75)
        radius = torch.clamp(radius, min=0.25 * plans.sampler.scene_bounding_sphere)
        near, far = node_ray_interval(cam_loc, ray_dirs, center, radius, plans.sampler)

    query_z = sampler_sdf = None
    if _use_proposal(nparams, plans, proposal_mode):
        query_z = _proposal_query_z(nparams, plans, ray_dirs, cam_loc, B, P,
                                    lambda pts: object_deform(pts, tfs, inverse=True), step)
    elif plans.fused_query:
        pack = pack_trunk_weights(resolve_weight_norm(nparams["implicit"]), plans.implicit)
        window = embed_window(plans.implicit, step, plans.barf_cfg, ray_dirs.device)
        tf12 = torch.cat([inverse_mat3(tfs[:, :3, :3]).reshape(B, 9), tfs[:, :3, 3]], dim=-1)
        dirs, cams = ray_dirs.contiguous(), cam_loc.contiguous()

        def query_z(z_RS):
            sdf = fused_object_sampler_sdf_z(dirs, cams, z_RS.reshape(B, P, -1).contiguous(),
                                             tf12.contiguous(), window, pack,
                                             relu=plans.sampler_relu)
            return sdf.reshape(B * P, -1)
    else:
        implicit_bf16 = cast_tree(resolve_weight_norm(nparams["implicit"]), torch.bfloat16)

        def sampler_sdf(pts_RS3):
            S = pts_RS3.shape[1]
            x_c = object_deform(pts_RS3.reshape(B, P * S, 3), tfs, inverse=True)
            return _bf16_trunk_sdf(implicit_bf16, plans, x_c.reshape(-1, 3),
                                   step).reshape(B * P, S)

    return error_bound_z_vals(gen, sampler_sdf, ray_dirs, cam_loc, beta0, plans.sampler,
                              query_z_fn=query_z, near=near, far=far)
