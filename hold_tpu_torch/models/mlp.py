"""SDF and color MLPs as plain functions over parameter dicts (counterpart of
hold_tpu/models/mlp.py).

- ImplicitNet: 8x256 softplus(beta=100) trunk, skip at layer 4, SAL geometric
  init, weight normalisation, conditioning at layer 0, output
  [sdf, 256-d feature]; the width-1 SDF head is applied separately so the
  double backward (normals, eikonal) only runs through that one row.
- RenderingNet: 'pose' mode (points, normals, 8-d pose embedding, features)
  and 'nerf_frame_encoding' mode (embedded view dirs, frame latent,
  features); ReLU hidden layers, sigmoid output.

Parameters mirror the JAX pytree: ``{"layers": [{"v", "g", "b"} | {"w", "b"}],
"lin_pose": {"w", "b"}}`` with ``w``/``v`` shaped (out, in) as in
``nn.Linear`` and ``g`` shaped (out, 1).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .embedders import embed_dim, make_embedder


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _linear_params(gen: torch.Generator, fan_in: int, fan_out: int) -> dict:
    """nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    return {
        "w": _uniform(gen, (fan_out, fan_in), -bound, bound),
        "b": _uniform(gen, (fan_out,), -bound, bound),
    }


def _weight_normalize(layer: dict) -> dict:
    """w -> (v, g) with g the row norms (torch weight_norm, dim=0)."""
    w = layer["w"]
    return {"v": w, "g": torch.linalg.norm(w, dim=1, keepdim=True), "b": layer["b"]}


def _resolved_weight(layer: dict) -> torch.Tensor:
    if "v" in layer:
        v, g = layer["v"], layer["g"]
        return g * v / torch.linalg.norm(v, dim=1, keepdim=True)
    return layer["w"]


def _apply_linear(layer: dict, x: torch.Tensor, in_cols: int | None = None) -> torch.Tensor:
    w = _resolved_weight(layer)
    if in_cols is not None:
        # inputs beyond in_cols are identically zero (the zeroed 45-d pose
        # conditioning): drop those columns after the weight-norm resolve
        w = w[:, :in_cols]
    if w.dtype != x.dtype:
        x = x.to(w.dtype)
    return F.linear(x, w, layer["b"])


def resolve_weight_norm(net_params: dict) -> dict:
    """Materialise weight-normed layers to plain {'w', 'b'} once per step."""
    def conv(layer):
        if "v" in layer:
            return {"w": _resolved_weight(layer), "b": layer["b"]}
        return layer

    out = dict(net_params)
    if "layers" in out:
        out["layers"] = [conv(l) for l in out["layers"]]
    if "lin_pose" in out:
        out["lin_pose"] = conv(out["lin_pose"])
    return out


def cast_tree(tree, dtype):
    """Copy of a parameter tree with every float32 tensor cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(dtype)
    return tree


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus(100 x)/100 in the split max/log1p form."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(100.0 * x))) / 100.0


# --------------------------------------------------------------------------
# ImplicitNet
# --------------------------------------------------------------------------

def implicit_net_shapes(opt, specs) -> dict[str, Any]:
    d_out = opt["d_out"] + opt["feature_vector_size"]
    dims = [opt["d_in"]] + list(opt["dims"]) + [d_out]
    multires = opt["multires"]
    if multires > 0:
        dims[0] = embed_dim(opt["d_in"], multires)
    cond = opt["cond"]
    if cond == "pose":
        cond_dim = specs["pose_dim"]
    elif cond == "frame":
        cond_dim = opt["dim_frame_encoding"]
    else:
        cond_dim = 0
    return {
        "dims": dims,
        "raw_in": opt["d_in"],
        "skip_in": tuple(opt["skip_in"]),
        "cond": cond,
        "cond_dim": cond_dim,
        "multires": multires,
        "embedding": specs["embedding"],
        "weight_norm": bool(opt.get("weight_norm", True)),
        "init": opt.get("init", "geometry"),
        "bias": float(opt.get("bias", 0.6)),
        "num_layers": len(dims),
    }


def init_implicit_net(gen: torch.Generator, opt, specs) -> dict:
    plan = implicit_net_shapes(opt, specs)
    dims, skip_in = plan["dims"], plan["skip_in"]
    layers = []
    for l in range(plan["num_layers"] - 1):
        out_dim = dims[l + 1] - dims[0] if (l + 1) in skip_in else dims[l + 1]
        in_dim = dims[l] + (plan["cond_dim"] if l == 0 and plan["cond"] != "none" else 0)
        p = _linear_params(gen, in_dim, out_dim)
        if plan["init"] == "geometry":
            # SAL geometric init: the field starts as a sphere of radius `bias`
            std = np.sqrt(2) / np.sqrt(out_dim)
            if l == plan["num_layers"] - 2:
                p["w"] = np.sqrt(np.pi) / np.sqrt(dims[l]) + 1e-4 * torch.randn(
                    p["w"].shape, generator=gen)
                p["b"] = torch.full_like(p["b"], -plan["bias"])
            elif plan["multires"] > 0 and l == 0:
                w = torch.zeros_like(p["w"])
                w[:, :3] = torch.randn((out_dim, 3), generator=gen) * std
                p["w"], p["b"] = w, torch.zeros_like(p["b"])
            elif plan["multires"] > 0 and l in skip_in:
                w = torch.randn(p["w"].shape, generator=gen) * std
                w[:, -(dims[0] - 3):] = 0.0
                p["w"], p["b"] = w, torch.zeros_like(p["b"])
            else:
                p["w"] = torch.randn(p["w"].shape, generator=gen) * std
                p["b"] = torch.zeros_like(p["b"])
        elif plan["init"] == "zero" and l == plan["num_layers"] - 2:
            p["w"] = _uniform(gen, p["w"].shape, -1e-5, 1e-5)
            p["b"] = torch.zeros_like(p["b"])
        p = {k: v.float() for k, v in p.items()}
        if plan["weight_norm"]:
            p = _weight_normalize(p)
        layers.append(p)
    return {"layers": layers}


def _embed(plan, x, step, barf_cfg):
    if plan["multires"] > 0:
        return make_embedder(plan["embedding"], plan["multires"], *barf_cfg)(x, step)
    return x


def _hidden_layers(params, plan, x, cond, n_layers):
    """Layers 0..n_layers-1 of the implicit net on embedded input ``x``."""
    inp = x
    # the 45-d MANO pose conditioning is always zeroed (CVPR behaviour): drop
    # the matching layer-0 columns instead of concatenating zeros
    zero_cond = plan["cond"] != "none" and plan["cond_dim"] == 45
    h = x
    for l in range(n_layers):
        cols = None
        if plan["cond"] != "none" and l == 0 and plan["cond_dim"] > 0:
            if zero_cond:
                cols = h.shape[-1]
            else:
                h = torch.cat([h, cond.to(h.dtype)], dim=-1)
        if l in plan["skip_in"]:
            h = torch.cat([h, inp.to(h.dtype)], dim=-1) / float(np.sqrt(2))
        h = _apply_linear(params["layers"][l], h, in_cols=cols)
        if l < plan["num_layers"] - 2:
            h = softplus100(h)
    return h


def apply_implicit_trunk(params, plan, x, cond, step=None, barf_cfg=(0, 1)):
    """All layers up to the last hidden activation: (N, W)."""
    return _hidden_layers(params, plan, _embed(plan, x, step, barf_cfg), cond,
                          plan["num_layers"] - 2)


def implicit_sdf_from_trunk(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Scalar SDF head (row 0 of the output layer): (N,), always float32."""
    layer = params["layers"][-1]
    w = _resolved_weight(layer)
    return h.float() @ w[0].float() + layer["b"][0].float()


def implicit_feat_from_trunk(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Feature head (rows 1:): (N, F)."""
    layer = params["layers"][-1]
    w = _resolved_weight(layer)
    return F.linear(h, w[1:].to(h.dtype), layer["b"][1:].to(h.dtype))


def apply_implicit_net(params, plan, x, cond, step=None, barf_cfg=(0, 1)):
    """(N, 1 + feature_size): [sdf, features]."""
    return _hidden_layers(params, plan, _embed(plan, x, step, barf_cfg), cond,
                          plan["num_layers"] - 1)


# --------------------------------------------------------------------------
# RenderingNet
# --------------------------------------------------------------------------

def rendering_net_shapes(opt, specs) -> dict[str, Any]:
    dims = [opt["d_in"] + opt["feature_vector_size"]] + list(opt["dims"]) + [opt["d_out"]]
    multires_view = opt.get("multires_view", -1)
    if multires_view > 0:
        dims[0] += embed_dim(3, multires_view) - 3
    if opt["mode"] == "nerf_frame_encoding":
        dims[0] += opt["dim_frame_encoding"]
    return {
        "dims": dims,
        "mode": opt["mode"],
        "multires_view": multires_view,
        "embedding": specs["embedding"],
        "weight_norm": bool(opt.get("weight_norm", True)),
        "num_layers": len(dims),
        "pose_dim": specs.get("pose_dim", 0),
        "dim_cond_embed": 8,
    }


def init_rendering_net(gen: torch.Generator, opt, specs) -> dict:
    plan = rendering_net_shapes(opt, specs)
    layers = []
    for l in range(plan["num_layers"] - 1):
        p = _linear_params(gen, plan["dims"][l], plan["dims"][l + 1])
        if plan["weight_norm"]:
            p = _weight_normalize(p)
        layers.append(p)
    out = {"layers": layers}
    if plan["mode"] == "pose" and plan["pose_dim"] > 0:
        out["lin_pose"] = _linear_params(gen, plan["pose_dim"], plan["dim_cond_embed"])
    return out


def apply_rendering_net(params, plan, points, normals, view_dirs, body_pose,
                        feature_vectors, frame_latent_code=None, step=None,
                        barf_cfg=(0, 1), pose_embed=None):
    if plan["mode"] == "nerf_frame_encoding":
        if plan["multires_view"] > 0:
            view_dirs = make_embedder(plan["embedding"], plan["multires_view"],
                                      *barf_cfg)(view_dirs, step)
        h = torch.cat([view_dirs, frame_latent_code, feature_vectors], dim=-1)
    elif plan["mode"] == "pose":
        if pose_embed is None:
            if plan["pose_dim"] > 0:
                pose_embed = _apply_linear(params["lin_pose"], body_pose)
            else:
                pose_embed = torch.zeros(points.shape[:-1] + (plan["dim_cond_embed"],),
                                         dtype=points.dtype, device=points.device)
        h = torch.cat(
            [points, normals.to(points.dtype), pose_embed.to(points.dtype),
             feature_vectors.to(points.dtype)],
            dim=-1,
        )
    else:
        raise NotImplementedError(plan["mode"])
    for l in range(plan["num_layers"] - 1):
        h = _apply_linear(params["layers"][l], h)
        if l < plan["num_layers"] - 2:
            h = torch.relu(h)
    return torch.sigmoid(h.float())
