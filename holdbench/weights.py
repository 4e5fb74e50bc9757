"""The scene's parameters, made on the device from the seed.

The tree has the layout the program trains (per node ``implicit`` and
``rendering`` layers, weight-normed as ``{v, g, b}`` or plain ``{w, b}`` with
``w`` shaped (out, in), the hand's ``lin_pose``, ``density``, the pose
``tables``, the object's ``frame_latent`` and ``obj_scale``, the
``background``, each node's ``proposal`` net) and HOLD's initialisation: the
SAL geometric init of the SDF nets (a sphere of radius ``bias``),
``nn.Linear``'s uniform init elsewhere, standard normal frame latents, the
sequence's pose tables.  Every random number comes from two draws of one
``torch.Generator`` on the card (one uniform, one normal), sliced leaf by
leaf in a fixed order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.mlp import implicit_net_shapes, proposal_net_shapes, rendering_net_shapes
from .reference.specs import MANO_SPECS, OBJECT_SPECS, TIME_CODE_DIM

BG_SPECS = {"pose_dim": 45, "embedding": "fourier"}


class _Draws:
    """Hands out consecutive slices of one uniform and one normal draw."""

    def __init__(self, n_uniform: int, n_normal: int, gen: torch.Generator, device):
        self.u = torch.rand(max(n_uniform, 1), generator=gen, device=device)
        self.n = torch.randn(max(n_normal, 1), generator=gen, device=device)
        self.iu = self.in_ = 0

    def uniform(self, shape, lo, hi):
        k = math.prod(shape)
        out = self.u[self.iu:self.iu + k].reshape(shape) * (hi - lo) + lo
        self.iu += k
        return out

    def normal(self, shape):
        k = math.prod(shape)
        out = self.n[self.in_:self.in_ + k].reshape(shape)
        self.in_ += k
        return out


def _layer_dims(plan: dict) -> list:
    """(in, out) of each layer of an implicit net's plan."""
    dims, skip_in = plan["dims"], plan["skip_in"]
    out = []
    for l in range(plan["num_layers"] - 1):
        o = dims[l + 1] - dims[0] if (l + 1) in skip_in else dims[l + 1]
        i = dims[l] + (plan["cond_dim"] if l == 0 and plan["cond"] != "none" else 0)
        out.append((i, o))
    return out


def _linear(d: _Draws, fan_in: int, fan_out: int) -> dict:
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    return {"w": d.uniform((fan_out, fan_in), -bound, bound),
            "b": d.uniform((fan_out,), -bound, bound)}


def _weight_norm(layer: dict) -> dict:
    w = layer["w"]
    return {"v": w, "g": torch.linalg.norm(w, dim=1, keepdim=True), "b": layer["b"]}


def _implicit(d: _Draws, plan: dict) -> dict:
    dims, layers = plan["dims"], []
    last = plan["num_layers"] - 2
    for l, (fan_in, fan_out) in enumerate(_layer_dims(plan)):
        p = _linear(d, fan_in, fan_out)
        if plan["init"] == "geometry":
            std = math.sqrt(2) / math.sqrt(fan_out)
            if l == last:
                p["w"] = math.sqrt(math.pi) / math.sqrt(dims[l]) + 1e-4 * d.normal((fan_out, fan_in))
                p["b"] = torch.full_like(p["b"], -plan["bias"])
            elif plan["multires"] > 0 and l == 0:
                w = torch.zeros_like(p["w"])
                w[:, :3] = d.normal((fan_out, 3)) * std
                p["w"], p["b"] = w, torch.zeros_like(p["b"])
            elif plan["multires"] > 0 and l in plan["skip_in"]:
                w = d.normal((fan_out, fan_in)) * std
                w[:, -(dims[0] - 3):] = 0.0
                p["w"], p["b"] = w, torch.zeros_like(p["b"])
            else:
                p["w"], p["b"] = d.normal((fan_out, fan_in)) * std, torch.zeros_like(p["b"])
        layers.append(_weight_norm(p) if plan["weight_norm"] else p)
    return {"layers": layers}


def _rendering(d: _Draws, plan: dict) -> dict:
    dims = plan["dims"]
    layers = [_linear(d, dims[l], dims[l + 1]) for l in range(plan["num_layers"] - 1)]
    out = {"layers": [_weight_norm(p) if plan["weight_norm"] else p for p in layers]}
    if plan["mode"] == "pose" and plan["pose_dim"] > 0:
        out["lin_pose"] = _linear(d, plan["pose_dim"], plan["dim_cond_embed"])
    return out


def _plans(opt_model: dict, node_ids: tuple) -> dict:
    render_obj = dict(opt_model["rendering_network"])
    render_obj["d_in"] = render_obj["d_in"] + TIME_CODE_DIM
    plans = {}
    for nid in node_ids:
        specs = OBJECT_SPECS if nid == "object" else MANO_SPECS
        plans[nid] = (implicit_net_shapes(opt_model["implicit_network"], specs),
                      rendering_net_shapes(render_obj if nid == "object"
                                           else opt_model["rendering_network"], specs))
    plans["background"] = (implicit_net_shapes(opt_model["bg_implicit_network"], BG_SPECS),
                           rendering_net_shapes(opt_model["bg_rendering_network"], BG_SPECS))
    return plans


def _count(opt_model: dict, node_ids: tuple, n_frames: int) -> tuple:
    """Uniform and normal draws the tree takes (an upper bound)."""
    nu = nn = 0
    for key, (imp, rend) in _plans(opt_model, node_ids).items():
        for fi, fo in _layer_dims(imp):
            nu += fi * fo + fo
            nn += fi * fo
        dims = rend["dims"]
        nu += sum(dims[l] * dims[l + 1] + dims[l + 1] for l in range(len(dims) - 1))
        nu += rend["pose_dim"] * rend["dim_cond_embed"] + rend["dim_cond_embed"]
        nn += n_frames * 32
    pd = proposal_net_shapes(opt_model.get("proposal", {}))["dims"]
    nu += len(node_ids) * sum(pd[l] * pd[l + 1] + pd[l + 1] for l in range(len(pd) - 1))
    return nu, nn


def make_params(opt_model: dict, entities: dict, n_frames: int, seed: int, device) -> dict:
    """The scene's parameter tree on ``device`` from ``seed``, float32,
    detached (the caller makes leaves of its own copy)."""
    hands = [k for k in ("right", "left") if k in entities]
    node_ids = tuple(hands + ["object"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d = _Draws(*_count(opt_model, node_ids, n_frames), gen, device)
    plans = _plans(opt_model, node_ids)
    beta = float(opt_model["density"]["params_init"].get("beta", 0.1))

    def table(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).clone()

    params = {}
    for nid in node_ids:
        imp_plan, rend_plan = plans[nid]
        node = {"implicit": _implicit(d, imp_plan), "rendering": _rendering(d, rend_plan),
                "density": {"beta": torch.tensor(beta, device=device)}}
        e = entities[nid]
        if nid == "object":
            node["tables"] = {"global_orient": table(e["object_poses"][:, :3]),
                              "transl": table(e["object_poses"][:, 3:])}
            node["frame_latent"] = d.normal((n_frames, TIME_CODE_DIM)).clone()
            node["obj_scale"] = table(float(e["obj_scale"]))
        else:
            node["tables"] = {"betas": table(e["mean_shape"])[None],
                              "global_orient": table(e["hand_poses"][:, :3]),
                              "pose": table(e["hand_poses"][:, 3:]),
                              "transl": table(e["hand_trans"])}
        params[nid] = node
    bg_imp, bg_rend = plans["background"]
    params["background"] = {
        "implicit": _implicit(d, bg_imp), "rendering": _rendering(d, bg_rend),
        "frame_latent": d.normal((n_frames, opt_model["bg_rendering_network"]
                                  ["dim_frame_encoding"])).clone(),
    }
    pd = proposal_net_shapes(opt_model.get("proposal", {}))["dims"]
    if opt_model.get("proposal", {}).get("enabled", False):
        for nid in node_ids:
            params[nid]["proposal"] = {"layers": [_linear(d, pd[l], pd[l + 1])
                                                  for l in range(len(pd) - 1)]}
    return map_tree(params, lambda t: t.detach().contiguous().clone())


def map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn) for v in tree]
    return fn(tree)


def leaves(tree, prefix: str = "") -> dict:
    """{'right/implicit/layers/0/v': tensor, ...} in a stable order."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def trainable(tree) -> dict:
    """A copy of the tree whose tensors are leaves that take a gradient,
    ``obj_scale`` excepted (scene training keeps it fixed)."""
    def rec(node, key):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v, key) for v in node]
        return node.detach().clone().requires_grad_(key != "obj_scale")
    return rec(tree, "")
