"""The comparisons that decide ``correct``: what the program produced
against what the plain reference works out from the same inputs.

Each function returns one number; ``checks`` sets each beside its limit
(a workload file's ``limits``).  A number with no limit, or one that is not
finite, fails.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

# a leaf whose reference gradient is under this share of the median leaf's
# is left out of the gradient and change readings: it moves by round-off
LEAF_FLOOR = 1e-3
# the quantile of a node's absolute z gaps that ``z_gap`` holds
Z_QUANTILE = 0.99


def loss_gap(prog: list, ref: list) -> float:
    """The largest relative gap of a step's total loss."""
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref))


def counted_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient norm reaches LEAF_FLOOR of the
    median leaf's (the rule on the reference's gradient)."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= LEAF_FLOOR * med]


def leaf_group(name: str) -> str:
    """A leaf's group, by its path ``<node>/...``: each hand's pose and shape
    tables (``<hand>/pose``) apart from its nets (``<hand>/net``); the
    object and the background whole."""
    node = name.split("/")[0]
    if node in ("object", "background"):
        return node
    return f"{node}/pose" if "/tables/" in name else f"{node}/net"


def group_gap(prog: dict, ref: dict, leaves: list) -> tuple:
    """(gap, group): the largest over the leaf groups of the group's median
    leaf gap.  A leaf's gap is that between the program's norm and the
    reference's, against the reference's norm of that leaf or of the
    group's median leaf, whichever is larger.  A leaf the program left
    without Adam state or change reads as norm 0, so its gap is 1."""
    groups: dict = {}
    for k in leaves:
        groups.setdefault(leaf_group(k), []).append(k)
    out = {}
    for g, ks in groups.items():
        med = statistics.median(ref[k] for k in ks)
        out[g] = statistics.median(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
                                   for k in ks)
    worst = max(out, key=out.get)
    return out[worst], worst


def z_moved(prog: dict, ref: dict, radius: float) -> dict:
    """Each node's absolute z gaps in scene radii, flat (None where the
    tables' shapes differ)."""
    out = {}
    for nid, r in ref.items():
        p = prog.get(nid)
        out[nid] = (None if p is None or p.shape != r.shape
                    else ((p.double() - r.double()).abs() / radius).reshape(-1))
    return out


def z_gap(prog_steps: list, ref_steps: list, radius: float) -> tuple:
    """(gap, where): over every compared step and node, the largest
    Z_QUANTILE-quantile of the sampler's absolute z gaps, in scene radii."""
    worst, where = -1.0, None
    for i, (p, r) in enumerate(zip(prog_steps, ref_steps)):
        for nid, d in z_moved(p, r, radius).items():
            v = math.inf if d is None else float(torch.quantile(d.float(), Z_QUANTILE))
            if v > worst:
                worst, where = v, f"step {i + 1} {nid}"
    return worst, where


def map_gap(prog: dict, ref: dict) -> tuple:
    """(gap, map): the worst map's sum of absolute gaps over the compared
    pixels against the reference's sum of magnitudes (``instance_map``: the
    share of pixels whose class differs)."""
    gaps = {}
    for k, r in ref.items():
        p = np.asarray(prog[k], np.float64)
        r = np.asarray(r, np.float64)
        if k.endswith("instance_map"):
            gaps[k] = float(np.mean(p != r))
        else:
            gaps[k] = float(np.abs(p - r).sum() / max(np.abs(r).sum(), 1e-30))
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def checks(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its limit."""
    out, ok = {}, True
    for name, v in values.items():
        lim = limits.get(name)
        out[name] = {"value": v, "limit": lim}
        if lim is None or not math.isfinite(v) or v > lim:
            ok = False
    return ok, out
