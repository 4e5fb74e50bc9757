"""Experiment loading: what ``train.run_training`` wrote, back as (params, scene).

A run leaves ``<log_root>/<exp_key>/args.json`` (its arguments) and
``checkpoints/last.pt`` (the flat parameter tree, the optimizer state, the
step count and the model config it was built from).  The JAX package's
checkpoints and their sidecars are not read.
"""

from __future__ import annotations

import json
import os

import torch

from ..models.holdnet import build_scene, init_scene_params
from .convert import flatten_params


def load_experiment(exp_dir: str, seq, device, fused_render: bool = True):
    """Rebuild the scene of the run in ``exp_dir`` for sequence ``seq`` on
    ``device`` (with the run's sampler) and load its last parameters.
    ``fused_render=False`` gives the chunked render shade.  Returns (params,
    scene)."""
    with open(os.path.join(exp_dir, "args.json")) as f:
        args = json.load(f)
    ckpt = torch.load(os.path.join(exp_dir, "checkpoints", "last.pt"), map_location="cpu",
                      weights_only=True)
    opt_model = dict(ckpt["model"])
    opt_model["scene_bounding_sphere"] = seq.scene_bounding_sphere
    scene = build_scene(opt_model, args, seq.scene_data(), device,
                        fused_sampler=not args.get("no_fused_sampler", False),
                        fused_render=fused_render)
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    flat = flatten_params(params)
    saved = ckpt["params"]
    if set(saved) != set(flat):
        raise ValueError(f"{exp_dir}: checkpoint tree differs from the scene's: "
                         f"{sorted(set(saved) ^ set(flat))[:8]}")
    with torch.no_grad():
        for k, t in flat.items():
            if saved[k].shape != t.shape:
                raise ValueError(f"{exp_dir}: {k} is {tuple(saved[k].shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(saved[k])
    return params, scene
