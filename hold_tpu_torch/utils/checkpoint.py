"""Experiment files: what ``train.run_training`` writes, and loading it back.

A run leaves ``<log_root>/<exp_key>/args.json`` (its arguments), step
checkpoints ``checkpoints/step_<step, 9 digits>.pt`` with
``checkpoints/last.pt`` a symlink to the newest (the JAX package's
``step_*`` / ``last`` layout, in ``torch.save`` files) and, with meshing on,
a ``misc/<step>.npy`` sidecar for each meshing (``save_misc``).  A
checkpoint holds the flat parameter tree (``convert.flatten_params``, on the
CPU), ``optimizer`` (the Adam ``state_dict``), the ``step`` and the
``model`` config the scene was built from.  The JAX package's checkpoints
are not read.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models.holdnet import build_scene, init_scene_params
from .config import sampler_flags
from .convert import flatten_params, map_params


def save_checkpoint(log_dir: str, step: int, state: dict) -> str:
    """Write ``state`` to ``<log_dir>/checkpoints/step_<step>.pt``, then point
    ``last.pt`` at it atomically (a temporary symlink renamed over it), as
    the JAX package points ``last``.  Returns the step file's path."""
    root = os.path.abspath(os.path.join(log_dir, "checkpoints"))
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"step_{step:09d}.pt")
    tmp_file = path + ".tmp"
    torch.save(state, tmp_file)
    os.replace(tmp_file, path)
    last = os.path.join(root, "last.pt")
    tmp = last + ".tmp"
    if os.path.lexists(tmp):
        os.remove(tmp)
    os.symlink(os.path.basename(path), tmp)
    os.replace(tmp, last)
    return path


def training_state(params, optimizer, step: int, model: dict) -> dict:
    """What a checkpoint holds: the flat parameters on the CPU, the
    optimizer's state, the step and the model config (JSON types only)."""
    return {"params": {k: v.detach().cpu() for k, v in flatten_params(params).items()},
            "optimizer": optimizer.state_dict(), "step": int(step),
            "model": json.loads(json.dumps(model))}


def latest_checkpoint(log_dir: str) -> str | None:
    """``checkpoints/last.pt`` of an experiment, else its newest step file,
    else None."""
    root = os.path.join(log_dir, "checkpoints")
    last = os.path.join(root, "last.pt")
    if os.path.exists(last):
        return last
    if not os.path.isdir(root):
        return None
    steps = sorted(f for f in os.listdir(root) if f.startswith("step_") and f.endswith(".pt"))
    return os.path.join(root, steps[-1]) if steps else None


def read_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def merge_params(params, saved: dict, predicate=None) -> dict:
    """A new parameter tree: each tensor of ``params`` whose flat path is in
    ``saved`` (and, with ``predicate``, whose path tuple it accepts) takes the
    saved values; the rest keep ``params``' (a checkpoint that lacks a
    subtree leaves its init in place).  Tensors stay leaves on their device,
    trainable as before."""

    def leaf(t, path):
        key = "/".join(map(str, path))
        if key not in saved or (predicate is not None and not predicate(tuple(key.split("/")))):
            return t
        v = saved[key]
        if v.shape != t.shape:
            raise ValueError(f"{key}: checkpoint holds {tuple(v.shape)}, the scene "
                             f"{tuple(t.shape)}")
        return v.detach().to(t.device, t.dtype).clone().requires_grad_(t.requires_grad)

    return map_params(params, (), leaf)


def load_checkpoint(path: str, template: dict) -> dict:
    """Restore ``template``'s entries from the checkpoint at ``path``: its
    ``params`` by ``merge_params`` (entries the checkpoint lacks keep the
    template's), every other key the checkpoint has replaces the template's.
    Extra entries of the checkpoint are left out."""
    state = read_checkpoint(path)
    out = {}
    for k, v in template.items():
        if k == "params":
            out[k] = merge_params(v, state.get("params", {}))
        else:
            out[k] = state.get(k, v)
    return out


def load_optimizer_state(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """Load an Adam ``state_dict`` into ``optimizer`` whose parameter groups
    begin with the saved ones, group for group and tensor for tensor: each
    saved tensor's state is restored as it was, and the groups the saved
    state predates (the proposal nets' against a checkpoint written
    without them) start fresh, as the JAX package keeps the template's
    init for subtrees a checkpoint lacks.  Raises ValueError when the saved
    groups are not such a prefix."""
    cur = optimizer.state_dict()
    old_groups, new_groups = saved["param_groups"], cur["param_groups"]
    if len(old_groups) > len(new_groups) or any(
            len(a["params"]) != len(b["params"]) for a, b in zip(old_groups, new_groups)):
        raise ValueError(f"saved parameter groups {[len(g['params']) for g in old_groups]} are "
                         f"no prefix of {[len(g['params']) for g in new_groups]}")
    state, groups = {}, []
    for old, new in zip(old_groups, new_groups):
        for i, j in zip(old["params"], new["params"]):
            if i in saved["state"]:
                state[j] = saved["state"][i]
        groups.append({**old, "params": new["params"]})
    optimizer.load_state_dict({"state": state,
                               "param_groups": groups + new_groups[len(old_groups):]})


def load_params_subset(path: str, params: dict, predicate) -> dict:
    """Restore only the tensors whose path tuple (the flat path split at
    '/') satisfies ``predicate``: the reference's filtered state-dict loads
    (``--load_pose``, ``--shape_init``)."""
    return merge_params(params, read_checkpoint(path)["params"], predicate)


def load_experiment(exp_dir: str, seq, device, ckpt: str | None = None):
    """Rebuild the scene of the run in ``exp_dir`` for sequence ``seq`` on
    ``device`` (with the run's sampler and the model config its checkpoint
    holds) and load the checkpoint ``ckpt`` (default: the newest).  The
    run's proposal and sampler flags build the scene it trained (a run with
    the proposal on keeps its nets; none of the loaders samples in proposal
    mode, as in the JAX package); every other key of its ``args.json`` is
    ignored, and each node's paths follow from its nets
    (``build_scene``).  Returns (params, scene, step)."""
    with open(os.path.join(exp_dir, "args.json")) as f:
        args = json.load(f)
    ckpt = ckpt or latest_checkpoint(exp_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {exp_dir}")
    state = read_checkpoint(ckpt)
    opt_model = dict(state["model"])
    opt_model["scene_bounding_sphere"] = seq.scene_bounding_sphere
    scene = build_scene(opt_model, args, seq.scene_data(), device, **sampler_flags(args))
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    saved = state["params"]
    flat = flatten_params(params)
    if set(saved) != set(flat):
        raise ValueError(f"{exp_dir}: checkpoint tree differs from the scene's: "
                         f"{sorted(set(saved) ^ set(flat))[:8]}")
    return merge_params(params, saved), scene, int(state["step"])


def save_misc(log_dir: str, step: int, misc: dict) -> str:
    """``misc`` (camera, scale, image paths, the canonical meshes) as
    ``<log_dir>/misc/<step, 9 digits>.npy``, the JAX package's sidecar."""
    out_p = os.path.join(log_dir, "misc", f"{step:09d}.npy")
    os.makedirs(os.path.dirname(out_p), exist_ok=True)
    np.save(out_p, misc)
    return out_p
