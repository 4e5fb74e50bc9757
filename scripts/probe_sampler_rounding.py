#!/usr/bin/env python3
"""Where the error-bound sampler's rounding grows, card against CPU
(``render/ray_sampler.py::error_bound_z_vals`` for the object's node).

    PYTHONPATH=. python3 scripts/probe_sampler_rounding.py [--frames 4] [--rays 32]

Needs one CUDA device; builds no kernel.  The inputs are ``chip_smoke.py``'s:
the synthetic sequence (12 frames, 240x320), the full-width model from seed
0, one batch's first ``--frames`` frames x ``--rays`` rays, the sampler's
deterministic grid (no generator).  The object's sdf is one function on
both sides: the trunk in float64 on the CPU, to which each device's sampler
hands its z table and from which it takes the sdf back in its own dtype.
So two runs differ only by the sampler's own arithmetic and by what the
sdf makes of the z tables they hand it.

The sampler's plain steps (on the card too, in place of its kernels,
``csrc/error_bound.cu``): the cumulative sums (``torch.cumsum``), the
exponentials (``torch.exp``, ``torch.expm1``) and the inverse-CDF search
(``sample_pdf``).  Every call of each is recorded, in order (the sampler has
no data-dependent control flow, so the i-th call is the same step on both
devices).

1. Each step on the same inputs: every call of a CPU run replayed on the
   card at the CPU's inputs; the largest difference of the outputs over the
   largest value of its ray, and the share of elements not bit-equal (the
   search: the share of samples moved farther than 0.1 x the ray's median
   sample spacing, as ``chip_smoke.py`` counts it).  In float32, and in
   float64.
2. The whole sampler on each device: each round's calls (a round ends with
   its search) against the other device's, and the final z tables' moved
   share.  In float32 and in float64.
3. Attribution: the whole sampler on both devices with one step (the
   cumulative sums, ``exp``, ``expm1`` or the search) computed in float64
   inside (its inputs widened, its output rounded back to float32), the
   rest in float32: the moved share that remains.
"""

from __future__ import annotations

import argparse
import os
import sys
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hold_tpu_torch.render import ray_sampler as rs  # noqa: E402

FAMILIES = {"cumsum": ("cumsum",), "exponentials": ("exp", "expm1"), "search": ("search",)}


class SamplerTorch:
    """``ray_sampler``'s view of torch: ``cumsum``, ``exp`` and ``expm1``
    recorded, and computed in float64 when named in ``wide``; every other
    name is torch's own."""

    def __init__(self, calls: list, wide=(), keep_inputs: bool = False):
        self.calls, self.wide, self.keep_inputs = calls, set(wide), keep_inputs

    def __getattr__(self, name):
        return getattr(torch, name)

    def run(self, name, fn, *args, **kw):
        if name in self.wide:
            out = fn(*(a.double() for a in args), **kw).to(args[0].dtype)
        else:
            out = fn(*args, **kw)
        self.calls.append((name, [a.detach().cpu() for a in args] if self.keep_inputs else None,
                           kw, out.detach().cpu()))
        return out

    def cumsum(self, x, dim):
        return self.run("cumsum", torch.cumsum, x, dim=dim)

    def exp(self, x):
        return self.run("exp", torch.exp, x)

    def expm1(self, x):
        return self.run("expm1", torch.expm1, x)

    def search(self, bins, cdf, u):
        return self.run("search", SEARCH, bins, cdf, u)


SEARCH = rs.sample_pdf


def moved(got, ref) -> float:
    """The share of samples of ``got`` farther than 0.1 x the ray's median
    sample spacing from ``ref``'s."""
    got, ref = got.double(), ref.double()
    spacing = torch.diff(torch.sort(ref, dim=-1)[0], dim=-1).median(dim=-1, keepdim=True)[0]
    return float(((got - ref).abs() > 0.1 * spacing).float().mean())


def rel(got, ref) -> float:
    """The largest |got - ref| over the largest |ref| of its ray (its last
    axis): a ray's values span many scales (a cumulative sum starts near 0),
    so each is read against its ray's own."""
    g, r = got.double(), ref.double()
    scale = r.abs().amax(dim=-1, keepdim=True).clamp(min=1e-300)
    return float(((g - r).abs() / scale).max())


def compare(name, got, ref) -> tuple:
    """(the figure a worst is taken by, the line): the search's moved share,
    else ``rel`` and the share of elements not bit-equal."""
    if name == "search":
        m = moved(got, ref)
        return m, f"moved {m:.5f}, max |dz| {float((got - ref).abs().max()):.3e}"
    r = rel(got, ref)
    return r, f"rel {r:.3e}, not bit-equal {float((got != ref).float().mean()):.5f}"


def setup(frames: int, rays: int):
    """(sdf function, rays in float64 on the CPU, beta0, the sampler config)."""
    from chip_smoke import BATCH_SIZE, FRAMES, IMG_HW, RAYS_PER_FRAME, slice_config
    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.data.synthetic import generate_sequence
    from hold_tpu_torch.models.density import laplace_beta
    from hold_tpu_torch.models.holdnet import _rays, build_scene, init_scene_params
    from hold_tpu_torch.models.mlp import (
        _resolved_weight, apply_implicit_trunk, cast_tree, resolve_weight_norm,
    )
    from hold_tpu_torch.models.nodes import _object_pose
    from hold_tpu_torch.models.object_model import object_deform
    from hold_tpu_torch.train import batch_to_device

    built = generate_sequence(None, FRAMES, IMG_HW)
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=RAYS_PER_FRAME)
    args, cfg = slice_config()
    cpu = torch.device("cpu")
    scene = build_scene(dict(cfg["model"]), dict(args), seq.scene_data(), cpu)
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    full = seq.sample_tempo_batch(np.random.RandomState(0), BATCH_SIZE, 1, RAYS_PER_FRAME)
    batch = batch_to_device({k: (v[:frames, :rays] if k == "uv" else v[:frames])
                             if k in ("uv", "frame_idx", "intrinsics", "extrinsics") else v
                             for k, v in full.items()}, cpu)
    plans = scene.plans["object"]
    with torch.no_grad():
        tfs = _object_pose(params["object"], scene.servers["object"], batch).obj_tfs.double()
        impl = cast_tree(resolve_weight_norm(params["object"]["implicit"]), torch.float64)
        ray_dirs, cam_loc = _rays({k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                                       else v) for k, v in batch.items()})
        beta0 = float(laplace_beta(params["object"]["density"]))
    head = impl["layers"][-1]
    w0, b0 = _resolved_weight(head)[0], head["b"][0]

    @torch.no_grad()
    def sdf_fn(pts):  # (R, S, 3) on the sampler's device and dtype
        x = pts.detach().cpu().double()
        R, S = x.shape[:2]
        x_c = object_deform(x.reshape(frames, -1, 3), tfs, inverse=True).reshape(-1, 3)
        h = apply_implicit_trunk(impl, plans.implicit, x_c, None, step=0,
                                 barf_cfg=plans.barf_cfg)
        return (h @ w0 + b0).reshape(R, S).to(pts.device, pts.dtype)

    return sdf_fn, ray_dirs, cam_loc, beta0, plans.sampler


def sampler_run(inputs, dev, dtype, wide=(), keep_inputs=False):
    """One sampler run on ``dev`` in ``dtype`` (float64: every tensor the
    sampler makes too); returns (final z table on the CPU, the calls)."""
    sdf_fn, ray_dirs, cam_loc, beta0, cfg = inputs
    calls: list = []
    hooked = SamplerTorch(calls, wide, keep_inputs)
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with mock.patch.object(rs, "torch", hooked), \
                mock.patch.object(rs, "sample_pdf", hooked.search), \
                mock.patch.object(rs, "error_bound_round", rs.error_bound_round_plain), \
                mock.patch.object(rs, "error_bound_final", rs.error_bound_final_plain):
            z = rs.error_bound_z_vals(None, sdf_fn, ray_dirs.to(dev, dtype),
                                      cam_loc.to(dev, dtype), beta0, cfg)
    finally:
        torch.set_default_dtype(default)
    return z.cpu(), calls


def rounds(calls) -> list:
    """The calls cut into rounds, each ending with its search."""
    out, cur = [], []
    for c in calls:
        cur.append(c)
        if c[0] == "search":
            out.append(cur)
            cur = []
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--rays", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="the device held against the CPU (cpu: a dry run, every figure 0)")
    a = ap.parse_args()
    if a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cuda, cpu = torch.device(a.device), torch.device("cpu")
    inputs = setup(a.frames, a.rays)
    name = torch.cuda.get_device_name(0) if cuda.type == "cuda" else "the CPU"
    print(f"{a.frames} frames x {a.rays} rays, the object's sampler, {name} against the CPU")

    runs = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[-1]
        z_cpu, calls_cpu = sampler_run(inputs, cpu, dtype, keep_inputs=True)
        z_gpu, calls_gpu = sampler_run(inputs, cuda, dtype)
        runs[tag] = (z_cpu, z_gpu)
        print(f"== {tag}: 1. each step at the CPU's inputs, replayed on the card "
              f"({len(calls_cpu)} calls)")
        for fam, names in FAMILIES.items():
            worst = []
            for name, args, kw, out in calls_cpu:
                if name not in names:
                    continue
                fn = SEARCH if name == "search" else getattr(torch, name)
                got = fn(*(x.to(cuda) for x in args), **kw).cpu()
                worst.append(compare(name, got, out))
            print(f"  {fam}: {len(worst)} calls; worst {max(worst)[1]}")
        print(f"== {tag}: 2. the whole sampler, card run against CPU run, round by round")
        for i, (rc, rg) in enumerate(zip(rounds(calls_cpu), rounds(calls_gpu))):
            parts = []
            for fam, names in FAMILIES.items():
                pairs = [(g[3], c[3]) for c, g in zip(rc, rg) if c[0] in names]
                if fam == "search":
                    parts.append(f"search {compare('search', *pairs[-1])[1]}")
                else:
                    parts.append(f"{fam} rel {max(rel(g, c) for g, c in pairs):.3e}")
            print(f"  round {i}: " + "; ".join(parts))
        print(f"  final z: moved {moved(z_gpu, z_cpu):.5f}, max |dz| "
              f"{float((z_gpu.double() - z_cpu.double()).abs().max()):.3e}")

    print("== 3. float32, one step computed in float64 inside: final z moved, card vs CPU")
    print(f"  none: {moved(runs['float32'][1], runs['float32'][0]):.5f}")
    for fam, names in (("cumsum", ("cumsum",)), ("exp", ("exp",)), ("expm1", ("expm1",)),
                       ("search", ("search",)), ("all three", sum(FAMILIES.values(), ()))):
        z_cpu, _ = sampler_run(inputs, cpu, torch.float32, wide=names)
        z_gpu, _ = sampler_run(inputs, cuda, torch.float32, wide=names)
        print(f"  {fam}: {moved(z_gpu, z_cpu):.5f}")
    print(f"  everything (float64 run): {moved(runs['float64'][1], runs['float64'][0]):.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
