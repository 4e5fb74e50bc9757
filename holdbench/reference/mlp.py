"""SDF and color MLPs as plain functions over parameter dicts (a frozen copy
of ``hold_tpu_torch/models/mlp.py`` without its initialisers, in float32;
``rounding`` gives the control its lower precision).

- ImplicitNet: 8x256 softplus(beta=100) trunk, skip at layer 4, SAL geometric
  init, weight normalisation, conditioning at layer 0, output
  [sdf, 256-d feature]; the width-1 SDF head is applied separately so the
  double backward (normals, eikonal) only runs through that one row.
- ProposalNet: [39, 64, 64, 64, 1] softplus100 surrogate of the SDF for
  the sampler's queries after a warmup.
- RenderingNet: 'pose' mode (points, normals, 8-d pose embedding, features)
  and 'nerf_frame_encoding' mode (embedded view dirs, frame latent,
  features); ReLU hidden layers, sigmoid output.

Parameters mirror the JAX pytree: ``{"layers": [{"v", "g", "b"} | {"w", "b"}],
"lin_pose": {"w", "b"}}`` with ``w``/``v`` shaped (out, in) as in
``nn.Linear`` and ``g`` shaped (out, 1).
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .embedders import embed_dim, make_embedder


def _resolved_weight(layer: dict) -> torch.Tensor:
    if "v" in layer:
        v, g = layer["v"], layer["g"]
        return g * v / torch.linalg.norm(v, dim=1, keepdim=True)
    return layer["w"]


# The control's rounding of the operands of the products that the program
# runs in bfloat16 (those inside ``lowp()``); None: float32 throughout.
_ROUND = None
_SCOPE = [0]


@contextlib.contextmanager
def lowp():
    """Marks the products that the program runs in bfloat16: the sampler's
    queries and the nodes' trunk, feature head and colour net."""
    _SCOPE[0] += 1
    try:
        yield
    finally:
        _SCOPE[0] -= 1


@contextlib.contextmanager
def rounding(fn):
    """Runs the ``lowp()`` products on operands rounded by ``fn`` (the
    gradient passes the rounding unchanged)."""
    global _ROUND
    old, _ROUND = _ROUND, fn
    try:
        yield
    finally:
        _ROUND = old


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale a tensor (its largest magnitude at 448)."""
    s = torch.clamp(t.detach().abs().amax(), min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


def _operand(x: torch.Tensor) -> torch.Tensor:
    if _ROUND is None or not _SCOPE[0]:
        return x
    return x + (_ROUND(x) - x).detach()


def _apply_linear(layer: dict, x: torch.Tensor, in_cols: int | None = None) -> torch.Tensor:
    w = _resolved_weight(layer)
    if in_cols is not None:
        # inputs beyond in_cols are identically zero (the zeroed 45-d pose
        # conditioning): drop those columns after the weight-norm resolve
        w = w[:, :in_cols]
    return F.linear(_operand(x), _operand(w), layer["b"])


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
    return F.linear(_operand(h), _operand(w[1:]), layer["b"][1:])


def apply_implicit_net(params, plan, x, cond, step=None, barf_cfg=(0, 1)):
    """(N, 1 + feature_size): [sdf, features]."""
    return _hidden_layers(params, plan, _embed(plan, x, step, barf_cfg), cond,
                          plan["num_layers"] - 1)


# --------------------------------------------------------------------------
# Proposal net: a small canonical-SDF surrogate distilled online from the
# trunk (``loss/proposal``); after a warmup it replaces the trunk in the
# sampler's queries.  Plain PyTorch, as the JAX package's is plain jnp.
# --------------------------------------------------------------------------

def proposal_net_shapes(opt: dict) -> dict:
    width = int(opt.get("width", 64))
    depth = int(opt.get("depth", 3))
    multires = int(opt.get("multires", 6))
    return {"dims": [embed_dim(3, multires)] + [width] * depth + [1], "multires": multires}


def apply_proposal_net(params: dict, plan: dict, x: torch.Tensor, step=None,
                       barf_cfg: tuple = (0, 1), embedding: str = "barf") -> torch.Tensor:
    """(N, 3) canonical points -> (N,) float32 surrogate sdf, through the
    trunk's (annealed) embedding.  A bf16 tree runs its layers in bf16
    (``_apply_linear`` casts the f32 embedding down), an f32 tree in f32."""
    h = make_embedder(embedding, plan["multires"], *barf_cfg)(x, step)
    n = len(params["layers"])
    for l, layer in enumerate(params["layers"]):
        h = _apply_linear(layer, h)
        if l < n - 1:
            h = softplus100(h)
    return h[..., 0].float()


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
