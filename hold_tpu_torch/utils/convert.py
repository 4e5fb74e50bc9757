"""Parameter trees: JAX params -> the port's params, and flat views.

The port keeps the JAX package's parameter layout as nested dicts of tensors
(see hold_tpu/models/holdnet.py init_scene_params): per node ``implicit`` and
``rendering`` layers (weight-norm ``{v, g, b}`` or plain ``{w, b}``, ``w``
shaped (out, in) as in ``nn.Linear``), ``lin_pose``, ``density``, the pose
``tables``, and for the object ``frame_latent`` and ``obj_scale``; plus the
``background``.  Every tensor is a trainable leaf except ``obj_scale``,
which scene training keeps fixed.
"""

from __future__ import annotations

import numpy as np
import torch

FROZEN = ("obj_scale",)


def _leaf(x, path, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype != np.float32:
        raise TypeError(f"{'/'.join(map(str, path))}: expected float32, got {arr.dtype}")
    t = torch.tensor(arr, dtype=torch.float32, device=device)
    return t.requires_grad_(path[-1] not in FROZEN)


def map_params(tree, path, leaf):
    """The tree with each leaf replaced by ``leaf(x, path)``, ``path`` the
    tuple of keys and list indices down to it."""
    if isinstance(tree, dict):
        return {k: map_params(v, path + (k,), leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_params(v, path + (i,), leaf) for i, v in enumerate(tree)]
    return leaf(tree, path)


def params_from_jax(jax_params, device=None) -> dict:
    """Convert a JAX params pytree (arrays as numpy or anything
    ``np.asarray`` takes) into the port's parameter tree."""
    return map_params(jax_params, (), lambda x, p: _leaf(x, p, device))


def leaf_params(tree, device=None) -> dict:
    """Make every tensor of a freshly initialised tree a leaf on ``device``
    (trainable unless frozen)."""
    return map_params(tree, (), lambda t, p: t.detach().to(device).requires_grad_(p[-1] not in FROZEN))


def detached_copy(tree) -> dict:
    """A copy of a parameter tree (or subtree) that later in-place updates
    of the live tensors do not reach."""
    return map_params(tree, (), lambda t, p: t.detach().clone())


def flatten_params(params, prefix: str = "") -> dict[str, torch.Tensor]:
    """{'right/implicit/layers/0/v': tensor, ...} in a stable order."""
    out: dict[str, torch.Tensor] = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k in node:
                rec(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + (str(i),))
        else:
            out["/".join(path)] = node

    rec(params, (prefix,) if prefix else ())
    return out
