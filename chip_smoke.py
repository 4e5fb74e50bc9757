#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hold_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. Environment: versions, the card's name and power limit, TF32 off.
2. Build: compile hold_tpu_torch/csrc/*.cu for sm_90a (nvcc, first use).
3. Kernel checks: each hand-written kernel against its plain PyTorch
   version on the card, at the shapes one full-width training step gives
   it, with the tolerance stated; kernel and plain times from CUDA events
   over enough launches to fill 100 ms.  The fused query's four forms run
   again at shapes that are no multiple of its 128-point tile, and the hand's
   on one frame alone.  The fused training shade (row 7)
   runs forward and backward at the grad stage's real canonical points and
   J^-1 of both nodes (10 frames x 12,544 points) and at an N that is no
   multiple of its tile; its backward's time by kernel (torch.profiler); its
   backward part by part (each matrix and bias
   of the packs, the rows where its work divides), beside the plain version
   with float64 products and without its bf16 roundings, under the JAX
   package's test loss, under seeded cotangents, and under those with only
   the rows where its work divides carrying them.  The render
   kernels run at one render chunk's shapes (4096 rays x 98 samples of the
   eval sampler: a frame's hand and object pixels, then background ones),
   the KNN blend kernels at the sampler warp's.
4. Agreement on a small batch: the sampler's z tables (fused query kernels
   on the card, their plain versions on the CPU), then one grad-stage loss
   and its parameter gradients, kernels on the card against the plain path
   on the CPU, twice: with the chunked shade (``--no_fused_train``) and with
   the fused training shade; then 256 hand and object rays of a frame, the
   card's z tables given to both sides, composited maps on the card against
   the CPU.
5. The training slice: ``hold_tpu_torch.train.run_training`` on the
   synthetic sequence (12 frames, 240x320) at full width, 10 frames x 128
   rays = 1280 rays per step, three times: 5 steps with the defaults (fused
   sampler, fused training shade), 3 steps with ``--no_fused_sampler`` (the
   layer-by-layer sampler), 3 steps with ``--no_fused_train`` (the chunked
   shade, each chunk recomputed in the backward) and 2 more of those with
   ``--no_remat`` (for its peak memory), every kernel's launch counter set to
   0 just before each.  Every
   loss must be finite and every kernel of a path launched in its run, and
   none off it; one more step of each run under torch.profiler gives the
   device time of each stage by kernel family.
6. The render slice: ``hold_tpu_torch.render_cli`` loads the fused run's
   checkpoint and renders two full frames at ``render_downsample`` 2
   (120x160 = 19,200 rays, 4096 a chunk), counters at 0 just before: the
   maps must be finite and exactly the render path's kernels launched.  Then
   phase 3's chunk again with the chunked render shade
   (``--no_fused_render``), whose PSNR against the fused render must reach
   ``PSNR_FLOOR``, and one frame under torch.profiler for the device time by
   kernel family.

The last three lines of standard output are the card's name and power
limit, one JSON object describing the kernels (errors, kernel and plain
times, the bound from this run's shapes, launches per path), and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory that does not hold the hold_tpu_torch package, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 5
FRAMES, IMG_HW = 12, (240, 320)
BATCH_SIZE, RAYS_PER_FRAME = 5, 128
LAYER_STEPS = 3
RENDER_FRAMES, RENDER_DOWNSAMPLE, PIXEL_PER_BATCH = 2, 2, 4096
SOURCES = {"knn": "hold_tpu_torch/csrc/knn.cu", "pm": "hold_tpu_torch/csrc/point_mesh.cu",
           "fq": "hold_tpu_torch/csrc/fused_query.cu",
           "fr": "hold_tpu_torch/csrc/fused_render.cu", "fs": "hold_tpu_torch/csrc/fused_shade.cu"}
# kernel name -> (source, TPU kernel it replaces: file:line of the pallas_call,
# the runs whose path launches it: "fused" (phase 5, the defaults), "layer"
# (phase 5, --no_fused_sampler), "chunked" (phase 5, --no_fused_train),
# "render" (phase 6)).  The point-buffer forms of the fused query and the KNN
# blend kernels are on no path, in the JAX package as here: phase 3 alone
# drives them.
GRAD = ("fused", "layer", "chunked")
KERNELS = {
    "knn_inverse_warp": ("knn", "hold_tpu/ops/knn.py:416", ("layer",)),
    "knn_inverse_warp_diff.fwd": ("knn", "hold_tpu/ops/knn.py:547", GRAD),
    "knn_inverse_warp_diff.bwd": ("knn", "hold_tpu/ops/knn.py:581", GRAD),
    "knn_jacobian_inverse.fwd": ("knn", "hold_tpu/ops/knn.py:737", GRAD),
    "knn_jacobian_inverse.bwd": ("knn", "hold_tpu/ops/knn.py:781", GRAD),
    "min_vertex_dist": ("pm", "hold_tpu/ops/point_mesh.py:228", GRAD),
    "fused_hand_sampler_sdf_z": ("fq", "hold_tpu/ops/fused_query.py:484",
                                 ("fused", "chunked", "render")),
    "fused_object_sampler_sdf_z": ("fq", "hold_tpu/ops/fused_query.py:520",
                                   ("fused", "chunked", "render")),
    "fused_shade_train.fwd": ("fs", "hold_tpu/ops/fused_shade.py:294", ("fused", "layer")),
    "fused_shade_train.bwd": ("fs", "hold_tpu/ops/fused_shade.py:315", ("fused", "layer")),
    "fused_hand_sampler_sdf": ("fq", "hold_tpu/ops/fused_query.py:389", ()),
    "fused_object_sampler_sdf": ("fq", "hold_tpu/ops/fused_query.py:419", ()),
    "fused_hand_render": ("fr", "hold_tpu/ops/fused_render.py:480", ("render",)),
    "fused_object_render": ("fr", "hold_tpu/ops/fused_render.py:514", ("render",)),
    "knn_blend_weights": ("knn", "hold_tpu/ops/knn.py:144", ()),
    "knn_blend_weights_t": ("knn", "hold_tpu/ops/knn.py:254", ()),
}
# the card's peak rates (NVIDIA's H100 SXM data sheet, dense, at 700 W):
# bf16 tensor cores, f32 outside them, device memory
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# the fused query against its plain version: the JAX package's own bound
# between its fused and layer-by-layer sampler (tests/test_fused_query.py),
# |d| <= 2e-2 and mean |d| <= 4e-3, with |d| scaled by max(1, |sdf|).  Both
# versions round every activation to bf16 (8 bits), and their sums differ in
# order, so a rounding step falls on different sides now and then; the step
# grows with the value.  The object's canonical space is world space over its
# scale (0.1 here), so far samples reach |sdf| ~ 30.
FQ_MAX, FQ_MEAN = 2e-2, 4e-3
# card vs CPU z tables: the share of samples farther apart than 0.1 x the
# median sample spacing.  Not the max: the sampler's inverse-CDF draws
# amplify rare rounding differences, and a few samples move by up to 20x
# that.  On an H100 the plain fused path alone, card against CPU, put 1.1 %
# of the object's samples beyond it, and the layer-by-layer sampler 2.2 %;
# the kernel against the plain path on the card 0.45 %.
Z_FAR_SHARE = 0.03
# the render kernels against their plain versions (phase 3): sdf as FQ_MAX /
# FQ_MEAN scaled by max(1, |sdf|), as for the query; x_c and the nearest
# distance are computed op for op alike (1e-5).  The JAX package holds its
# fused render to its XLA shade at rgb 3e-2 and normal p99 0.08
# (tests/test_fused_render.py); here both sides round at the same places, so
# the bounds are tighter: on an H100 the kernels read rgb 1.1e-4 (hand) and
# 1.9e-3 (object), normal p99 1.1e-3 and max 7.9e-3 (hand), 1.5e-2 (object),
# on the frame's first 4096 pixels.  A normal's error grows as |dSDF/dx|
# shrinks, hence the looser max.
RENDER_RGB, RENDER_NRM_P99, RENDER_NRM_MAX = 1e-2, 1e-2, 0.1
# the fused training shade's backward against its plain version (phase 3)
# and the fused grad stage, card against CPU (phase 4): the JAX package's
# bound between its kernel and the same math in XLA
# (tests/test_fused_shade.py), |d| <= rtol |ref| + atol max|ref|, applied in
# phase 3 to each part of a returned tensor on its own (x_c, J^-1, their
# rows next to where the backward's work divides, the frame bias, every
# matrix and bias row of the packs, the SDF head's bias) and in phase 4 to
# each parameter's gradient.  A part may have a share of its elements
# beyond the bound and none beyond a cap times it: GRAD_LIMITS by the kind
# of part, AGREE_LIMIT in phase 4.  Beside the kernel, each part is read for
# the plain version with its products summed in float64 (sound: the same
# math, another summation) and for a control that must fail: in phase 3 the
# plain version without its bf16 roundings, in phase 4 the chunked f32
# shade.  Set from those readings on an H100 (PERF.md), at 10 x
# 12,544 points under seeded cotangents, with only the tail rows' too: the
# per-point gradients read at most 0.87 of the bound (sound 0.60, control
# up to 3.5); the sums through the trunk at most 4.6 with 1.0 % of a part
# beyond (sound 3.0 and 0.4 %, control up to 34 and 44 %); the sums through
# the colour net's hidden layers and the frame bias, whose terms cancel so
# that a flipped bf16 rounding moves them far beyond their scale, at most
# 9.9 with 58 % beyond (sound 8.2 and 46 %, control up to 71); of those the
# frame bias at most 8.2 with 7.9 % beyond (sound 4.6 and 3.6 %, control
# 12 and 44 %; each frame's first 16 points counted in the frame before
# 8.0 and 20-28 %).  Under the cotangents of the JAX package's test loss,
# which do not cancel, the sums read at most 0.27 (sound 0.25, control up
# to 1.6) and are held to the bound itself, while a per-point gradient whose
# terms cancel within the point reads up to 2.0 on 0.007 % of its elements
# (sound 1.7 and 0.001 %, control 9.0 and 1.1 %): LOSS_LIMITS.
SHADE_GRAD_RTOL, SHADE_GRAD_ATOL = 5e-3, 5e-3
GRAD_LIMITS = {"point": (0.0, 1.0), "trunk": (2e-2, 8.0), "colour": (1.0, 15.0),
               "frame bias": (0.12, 15.0)}
LOSS_LIMITS = {"point": (5e-4, 4.0), "trunk": (0.0, 1.0), "colour": (0.0, 1.0),
               "frame bias": (0.0, 1.0)}
COLOUR_PARTS = ("bw.feat_w", "cw.C0a", "cw.C0f", "cw.C1", "cw.C2", "cw.C3", "cw.cbias0",
                "cw.cbias1", "cw.cbias2", "cw.cbias3")
# phase 4, 16 rays: the card at most 2.5 with 0.4 % of a tensor beyond,
# the CPU's own float64 reading 1.9 and 0.4 %, the chunked shade 2.5 and 25 %
AGREE_LIMIT = (1e-2, 5.0)
# one render chunk, card against CPU (phase 4), on the composited maps: the
# per-sample rgb bound integrated over a ray stays under it; normals are
# averaged unit vectors; the mask and depth move with the density, which
# moves with the sdf's bf16 steps
RENDER_MAP_TOL = {"rgb": 3e-2, "mask_prob": 3e-2, "normal": 8e-2, "depth": 3e-2}
# the rays of the render checks are the pixels the ground-truth mask marks
# as hand or object; their composited mask_prob must reach this, or the
# check would compare background
MASK_FLOOR = 0.5
# the fused render against the chunked f32 render shade (phase 6): a render
# whose every pixel were off by the JAX package's per-sample rgb bound
# between the two, 3e-2, would score 20 log10(1 / 3e-2) = 30.5 dB
PSNR_FLOOR = 30.0


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(torch, fn, fill_ms: float = 100.0, max_reps: int = 5000) -> float:
    """Mean milliseconds of ``fn`` over enough back-to-back launches to fill
    ``fill_ms`` (at least 3), after one warm-up and one timed call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(reps):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    fn()
    once = timed(1)
    return timed(min(max(3, math.ceil(fill_ms / max(once, 1e-3))), max_reps))


def bound(tc_flops: float, f32_flops: float, nbytes: float) -> dict:
    """The least time the card could take: the largest of the tensor-core
    operations at the bf16 peak, the other operations at the f32 peak (the
    two pipes run at once) and the bytes moved (each input read once, each
    output written once) at the memory rate.  Operations count what the
    function needs, not a kernel's zero pads."""
    ops_ms = max(tc_flops / PEAK_BF16, f32_flops / PEAK_F32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "tc_flops": tc_flops, "f32_flops": f32_flops, "bytes": nbytes}


def knn_cost(n_pts: int, V: int, J: int, K: int = 15) -> float:
    """f32 operations a point of one KNN blend: two sweeps over V vertices
    (a distance of 9 operations and one comparison each), the exponential
    and J multiply-adds of the K vertices blended, the normalisation."""
    return n_pts * (2 * 10.0 * V + K * (2 * J + 2) + J)


def frame_bytes(B: int, V: int, J: int) -> float:
    """Per-frame inputs of a hand kernel: vertices, skinning weights, bones."""
    return B * (V * 12.0 + V * J * 4.0 + J * 64.0)


def kernel_label(ptxas_line: str) -> str:
    """'fused_render_kernel<true>' from ptxas's line naming a mangled entry
    function."""
    import re

    m = re.search(r"([a-z_]+_kernel)(I(?:Lb[01]E)+E)?", ptxas_line)
    if not m:
        return ptxas_line.strip()
    args = re.findall(r"Lb([01])E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join('true' if a == '1' else 'false' for a in args)}>"
                         if args else "")


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


@contextlib.contextmanager
def products_in_f64(torch):
    """Every product ``a @ b`` of a float32 ``a`` summed in float64, then
    rounded to float32."""
    matmul = torch.Tensor.__matmul__
    torch.Tensor.__matmul__ = lambda a, b: (matmul(a.double(), b.double()).float()
                                            if a.dtype == torch.float32 else matmul(a, b))
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = matmul


def check_bf16_query(name: str, got, ref) -> float:
    """|d| <= FQ_MAX * max(1, |ref|) and mean|d| <= FQ_MEAN, else raise;
    returns max|d|."""
    d = (got.float() - ref.float()).abs()
    mag = ref.float().abs()
    err, mean = float(d.max()), float(d.mean())
    near = float(d[mag <= 1.0].max()) if bool((mag <= 1.0).any()) else 0.0
    worst = float((d / (FQ_MAX * mag.clamp(min=1.0))).max())
    ok = worst <= 1.0 and mean <= FQ_MEAN
    print(f"  {name}: max_abs_err {err:.3e} (at |sdf| <= 1: {near:.3e}; worst "
          f"|d| / ({FQ_MAX:g} max(1, |sdf|)) {worst:.3f}), mean_abs_err {mean:.3e} "
          f"(tol {FQ_MEAN:g}), max |sdf| {float(mag.max()):.2f} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_close(name: str, got, ref, rtol: float, atol: float) -> float:
    """max|got - ref| <= atol + rtol * max|ref|, else raise."""
    err = max_err(got, ref)
    tol = atol + rtol * float(ref.detach().abs().max())
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e} = {atol:g} + {rtol:g}*max|ref|) {status}",
          flush=True)
    if err > tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def slice_config():
    from hold_tpu_torch.utils.config import Cfg, load_config

    cfg = load_config()
    cfg["model"]["proposal"]["enabled"] = False  # not ported: exact sampler
    args = Cfg({
        "case": "synthetic", "lr": 1e-4, "num_sample": RAYS_PER_FRAME, "tempo_len": 2000,
        "offset": 1, "log_every": 1, "no_meshing": True, "no_vis": True, "mute": True,
        "exp_key": "chip_smoke", "barf_s": 1000, "barf_e": 10000, "seed": 0,
        "log_root": os.path.join(ROOT, "logs", "chip_smoke"), "total_step": STEPS,
    })
    return args, cfg


def kernel_checks(torch, seq, args, cfg, dev) -> dict:
    """Phase 3: every kernel against its plain version at slice shapes."""
    import numpy as np

    from hold_tpu_torch.models.holdnet import (
        _rays, build_scene, empty_object_mesh_state, init_scene_params, sample_all_z,
    )
    from hold_tpu_torch.models.mlp import resolve_weight_norm
    from hold_tpu_torch.models.nodes import _mano_pose, _object_pose
    from hold_tpu_torch.ops import fused_query as fq
    from hold_tpu_torch.ops import knn, point_mesh
    from hold_tpu_torch.utils.transforms import inverse_mat3
    from hold_tpu_torch.render.ray_sampler import uniform_z_vals
    from hold_tpu_torch.render.volsdf import get_sphere_intersections
    from hold_tpu_torch.train import batch_to_device

    opt_model = dict(cfg["model"])
    scene = build_scene(opt_model, dict(args), seq.scene_data(), dev)
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    batch = batch_to_device(
        seq.sample_tempo_batch(np.random.RandomState(0), BATCH_SIZE, 1, RAYS_PER_FRAME), dev)
    B, P = batch["uv"].shape[:2]
    server = scene.servers["right"]
    with torch.no_grad():
        srv_out, _ = _mano_pose(params["right"], server, batch, 0)
    tfs = srv_out.tfs.detach().contiguous()
    verts = srv_out.verts.detach().contiguous()
    verts_c = server.verts_c.expand(B, -1, -1).contiguous()
    skin = server.skin_weights_c.expand(B, -1, -1).contiguous()
    ray_dirs, cam_loc = _rays(batch)
    far = get_sphere_intersections(cam_loc, ray_dirs, scene.sampler_cfg.scene_bounding_sphere)[:, 1:]
    z0 = uniform_z_vals(None, ray_dirs, cam_loc, torch.zeros_like(far), far,
                        scene.sampler_cfg.N_samples_eval)
    pts_s = (cam_loc[:, None] + z0[..., None] * ray_dirs[:, None]).reshape(B, -1, 3).contiguous()
    zs = sample_all_z(params, scene, batch, torch.Generator(dev).manual_seed(0), 0, 0)
    z = zs["right"]
    pts_g = (cam_loc[:, None] + z[..., None] * ray_dirs[:, None]).reshape(B, -1, 3).contiguous()
    rng = torch.Generator(dev).manual_seed(1)
    results = {}

    def record(name, err, ms, plain_ms, shape, cost, **extra):
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": shape,
                         "library_ms": None, **cost, **extra}
        print(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{cost['bound_ms']:.4f} ms ({cost['bound_by']}) {extra or ''}", flush=True)

    V, J = verts.shape[1], skin.shape[2]
    n_s, n_g = pts_s.shape[0] * pts_s.shape[1], pts_g.shape[0] * pts_g.shape[1]
    fbytes = frame_bytes(B, V, J)

    # 1: sampler warp, one error-bound round of 128 samples on 1280 rays
    got_x, got_o = knn.knn_inverse_warp(pts_s, verts, skin, tfs)
    ref_x, ref_o = knn.inverse_warp_plain(pts_s, verts, skin, tfs)
    err = check_close("knn_inverse_warp x_c", got_x, ref_x, 1e-5, 1e-5)
    if not torch.equal(got_o, ref_o):
        raise AssertionError("knn_inverse_warp: outlier mask differs")
    record("knn_inverse_warp", err,
           cuda_ms(torch, lambda: knn.knn_inverse_warp(pts_s, verts, skin, tfs)),
           cuda_ms(torch, lambda: knn.inverse_warp_plain(pts_s, verts, skin, tfs)),
           f"B={B} P={pts_s.shape[1]} V={verts.shape[1]}",
           bound(0, knn_cost(n_s, V, J) + n_s * (24 * J + 45), n_s * 25 + fbytes))

    # 2: grad-stage warp, 98 samples on 1280 rays, forward and backward
    pts_r = pts_g.clone().requires_grad_(True)
    tfs_r = tfs.clone().requires_grad_(True)
    g = torch.randn(pts_g.shape, generator=rng, device=dev)
    got_x, got_o = knn.knn_inverse_warp_diff(pts_r, verts, skin, tfs_r)
    got_dp, got_dt = torch.autograd.grad(got_x, (pts_r, tfs_r), g)
    ref_x, ref_o = knn.inverse_warp_plain(pts_r, verts, skin, tfs_r)
    ref_dp, ref_dt = torch.autograd.grad(ref_x, (pts_r, tfs_r), g, retain_graph=True)
    err_f = check_close("knn_inverse_warp_diff x_c", got_x, ref_x, 1e-5, 1e-5)
    if not torch.equal(got_o, ref_o):
        raise AssertionError("knn_inverse_warp_diff: outlier mask differs")
    err_p = check_close("knn_inverse_warp_diff d/dpts", got_dp, ref_dp, 1e-5, 1e-5)
    # the per-frame transform gradient sums 12,544 points with atomicAdd in
    # a run-dependent order: fp32 reduction-order tolerance
    err_t = check_close("knn_inverse_warp_diff d/dtfs", got_dt, ref_dt, 2e-5, 1e-5)
    shape = f"B={B} P={pts_g.shape[1]} V={verts.shape[1]}"
    record("knn_inverse_warp_diff.fwd", err_f,
           cuda_ms(torch, lambda: knn._warp_fwd_cuda(pts_g, verts, skin, tfs, 15, 0.1, True,
                                                     "knn_inverse_warp_diff.fwd")),
           cuda_ms(torch, lambda: knn.inverse_warp_plain(pts_g, verts, skin, tfs)), shape,
           bound(0, knn_cost(n_g, V, J) + n_g * (24 * J + 45),
                 n_g * (25 + 36 + 4 * J) + fbytes))
    _, _, inv, wb = knn._warp_fwd_cuda(pts_g, verts, skin, tfs, 15, 0.1, True,
                                       "knn_inverse_warp_diff.fwd")
    record("knn_inverse_warp_diff.bwd", max(err_p, err_t),
           cuda_ms(torch, lambda: knn._warp_bwd_cuda(g, inv, got_x.detach(), wb)),
           cuda_ms(torch, lambda: torch.autograd.grad(ref_x, (pts_r, tfs_r), g,
                                                      retain_graph=True)), shape,
           bound(0, n_g * (30 + 24 * J), n_g * (72 + 4 * J) + B * J * 64))

    # 3: inverse skinning Jacobian at the canonical points
    xc = got_x.detach().contiguous()
    tfs_r = tfs.clone().requires_grad_(True)
    gj = torch.randn(xc.shape[:2] + (9,), generator=rng, device=dev)
    got_j = knn.knn_jacobian_inverse(xc, verts_c, skin, tfs_r)
    (got_jt,) = torch.autograd.grad(got_j, tfs_r, gj)
    ref_j = knn.jacobian_inverse_plain(xc, verts_c, skin, tfs_r)
    (ref_jt,) = torch.autograd.grad(ref_j, tfs_r, gj, retain_graph=True)
    err_f = check_close("knn_jacobian_inverse J^-1", got_j, ref_j, 1e-5, 1e-5)
    err_t = check_close("knn_jacobian_inverse d/dtfs", got_jt, ref_jt, 2e-5, 1e-5)
    record("knn_jacobian_inverse.fwd", err_f,
           cuda_ms(torch, lambda: knn._jinv_fwd_cuda(xc, verts_c, skin, tfs, 15)),
           cuda_ms(torch, lambda: knn.jacobian_inverse_plain(xc, verts_c, skin, tfs)), shape,
           bound(0, knn_cost(n_g, V, J) + n_g * (18 * J + 30), n_g * (48 + 4 * J) + fbytes))
    inv_j, wb_j = knn._jinv_fwd_cuda(xc, verts_c, skin, tfs, 15)
    record("knn_jacobian_inverse.bwd", err_t,
           cuda_ms(torch, lambda: knn._jinv_bwd_cuda(gj, inv_j, wb_j)),
           cuda_ms(torch, lambda: torch.autograd.grad(ref_j, tfs_r, gj, retain_graph=True)),
           shape, bound(0, n_g * (108 + 18 * J), n_g * (72 + 4 * J) + B * J * 64))

    # 4: min vertex distance, hand (subdivided mesh) and object (far-padded
    # empty mesh state with real vertices in the first rows)
    cano = xc.reshape(-1, 3)
    M_sub = scene.sub_ops["right"][0]
    v_div = (M_sub @ srv_out.v_posed[0]).detach().contiguous()
    bound_v = empty_object_mesh_state(dev)["bound_centers"].clone()
    n_obj = server.verts_c.shape[1]
    bound_v[:n_obj] = server.verts_c[0] * 2.0
    errs = []
    for label, vv in (("hand", v_div), ("object", bound_v)):
        got = point_mesh.min_vertex_dist_fast(cano, vv)
        ref = point_mesh.min_vertex_dist(cano, vv)
        errs.append(check_close(f"min_vertex_dist {label} (V={vv.shape[0]})", got, ref, 1e-5, 1e-4))
    record("min_vertex_dist", max(errs),
           cuda_ms(torch, lambda: point_mesh.min_vertex_dist_fast(cano, bound_v)),
           cuda_ms(torch, lambda: point_mesh.min_vertex_dist(cano, bound_v)),
           f"P={cano.shape[0]} V={bound_v.shape[0]}",
           bound(0, cano.shape[0] * bound_v.shape[0] * 10.0,
                 (cano.shape[0] + bound_v.shape[0]) * 12.0 + cano.shape[0] * 4))

    # 5, 6, 12, 13: the fused sampler query, on the first round's 128
    # samples of 1280 rays (z forms) and the same points as a buffer; the
    # object's BARF window half open (all six bands partly weighted)
    S = z0.shape[1]
    z_t = z0.reshape(B, P, S).contiguous()
    packs, windows = {}, {}
    for nid in ("right", "object"):
        plans = scene.plans[nid]
        with torch.no_grad():
            packs[nid] = fq.pack_trunk_weights(resolve_weight_norm(params[nid]["implicit"]),
                                               plans.implicit)
        windows[nid] = fq.embed_window(plans.implicit, sum(plans.barf_cfg) // 2,
                                       plans.barf_cfg, dev)
    obj_tfs = _object_pose(params["object"], scene.servers["object"], batch).obj_tfs.detach()
    tf12 = torch.cat([inverse_mat3(obj_tfs[:, :3, :3]).reshape(B, 9), obj_tfs[:, :3, 3]],
                     dim=-1).contiguous()
    hand = (verts, skin, tfs, windows["right"], packs["right"])
    obj = (tf12, windows["object"], packs["object"])
    rays = (ray_dirs.contiguous(), cam_loc.contiguous(), z_t)
    pts_b = fq.points_from_rays_z(*rays)
    wbytes = fq.W_TOTAL * 2.0 + fq.F_TOTAL * 4.0
    act = 8 * 256 * 8.0  # softplus100 a hidden unit: f32 operations
    hand_f32 = knn_cost(1, V, J) + 24 * J + 45  # a point of the hand's warp
    cases = (
        ("fused_hand_sampler_sdf_z", lambda: fq.fused_hand_sampler_sdf_z(*rays, *hand),
         lambda: fq.hand_query_plain(pts_b, *hand).reshape(z_t.shape), f"B={B} P={P} S={S}",
         act + hand_f32, 8.0, wbytes + fbytes + B * P * 24),
        ("fused_object_sampler_sdf_z", lambda: fq.fused_object_sampler_sdf_z(*rays, *obj),
         lambda: fq.object_query_plain(pts_b, *obj).reshape(z_t.shape), f"B={B} P={P} S={S}",
         act + 24, 8.0, wbytes + B * P * 24),
        ("fused_hand_sampler_sdf", lambda: fq.fused_hand_sampler_sdf(pts_s, *hand),
         lambda: fq.hand_query_plain(pts_s, *hand), f"B={B} N={pts_s.shape[1]}",
         act + hand_f32, 16.0, wbytes + fbytes),
        ("fused_object_sampler_sdf", lambda: fq.fused_object_sampler_sdf(pts_s, *obj),
         lambda: fq.object_query_plain(pts_s, *obj), f"B={B} N={pts_s.shape[1]}",
         act + 24, 16.0, wbytes),
    )
    for name, kern, plain, shape, f32_pp, bytes_pp, bytes_once in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite values")
        err = check_bf16_query(name, got, ref)
        ms = cuda_ms(torch, kern)
        n = got.numel()
        record(name, err, ms, cuda_ms(torch, plain), shape,
               bound(2.0 * fq.TRUNK_MACS * n, f32_pp * n, bytes_pp * n + bytes_once),
               mean_abs_err=float((got - ref).abs().mean()),
               trunk_tflop_s=fq.TRUNK_FLOPS_PER_POINT * n / (ms * 1e-3) / 1e12)

    # the same four at shapes that are no multiple of the kernel's 128-point
    # tile (37 rays x 100 samples a frame; a buffer 61 points short), and the
    # hand's z form on one frame alone
    Pr, Sr = 37, 100
    rays_r = tuple(t.reshape(B, P, 3)[:, :Pr].reshape(-1, 3).contiguous() for t in rays[:2]) + (
        z_t[:, :Pr, :Sr].contiguous(),)
    pts_r = pts_s[:, :pts_s.shape[1] - 61].contiguous()
    rays_1 = (rays[0][:P].contiguous(), rays[1][:P].contiguous(), z_t[:1].contiguous())
    hand_1 = (verts[:1].contiguous(), skin[:1].contiguous(), tfs[:1].contiguous(), *hand[3:])
    for name, kern, plain, shape in (
        ("fused_hand_sampler_sdf_z", lambda: fq.fused_hand_sampler_sdf_z(*rays_r, *hand),
         lambda: fq.hand_query_plain(fq.points_from_rays_z(*rays_r), *hand), f"B={B} P={Pr} S={Sr}"),
        ("fused_object_sampler_sdf_z", lambda: fq.fused_object_sampler_sdf_z(*rays_r, *obj),
         lambda: fq.object_query_plain(fq.points_from_rays_z(*rays_r), *obj),
         f"B={B} P={Pr} S={Sr}"),
        ("fused_hand_sampler_sdf", lambda: fq.fused_hand_sampler_sdf(pts_r, *hand),
         lambda: fq.hand_query_plain(pts_r, *hand), f"B={B} N={pts_r.shape[1]}"),
        ("fused_object_sampler_sdf", lambda: fq.fused_object_sampler_sdf(pts_r, *obj),
         lambda: fq.object_query_plain(pts_r, *obj), f"B={B} N={pts_r.shape[1]}"),
        ("fused_hand_sampler_sdf_z", lambda: fq.fused_hand_sampler_sdf_z(*rays_1, *hand_1),
         lambda: fq.hand_query_plain(fq.points_from_rays_z(*rays_1), *hand_1),
         f"B=1 P={P} S={S}"),
    ):
        got, ref = kern().reshape(-1), plain().reshape(-1)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {shape}: shape {tuple(got.shape)} or non-finite values")
        results[name].setdefault("ragged", {})[shape] = check_bf16_query(f"{name} {shape}", got,
                                                                         ref)

    # 10, 11: the KNN blend kernels at the sampler warp's shape
    for name, fn in (("knn_blend_weights", knn.knn_blend_weights),
                     ("knn_blend_weights_t", knn.knn_blend_weights_t)):
        got_w, got_o = fn(pts_s, verts, skin)
        ref_w, ref_o = knn.blend_weights_plain(pts_s, verts, skin)
        if name.endswith("_t"):
            ref_w = ref_w.transpose(1, 2)
        err = check_close(f"{name} weights", got_w, ref_w, 1e-5, 1e-5)
        if not torch.equal(got_o, ref_o):
            raise AssertionError(f"{name}: outlier mask differs")
        record(name, err, cuda_ms(torch, lambda: fn(pts_s, verts, skin)),
               cuda_ms(torch, lambda: knn.blend_weights_plain(pts_s, verts, skin)),
               f"B={B} P={pts_s.shape[1]} V={V}",
               bound(0, knn_cost(n_s, V, J), n_s * (13 + 4 * J) + B * V * (12 + 4 * J)))

    shade_checks(torch, scene, params, batch, zs["object"], xc, got_j.detach().contiguous(), dev,
                 record, results)
    render_checks(torch, seq, scene, params, dev, record)
    return results


def grad_reading(torch, got, ref) -> tuple:
    """(worst |got - ref| over the bound SHADE_GRAD_RTOL |ref| +
    SHADE_GRAD_ATOL max|ref|, share of elements beyond it, max |got - ref|);
    (inf, 1, inf) when ``got`` is not finite."""
    ref = ref.detach().float()
    got = got.detach().float()
    if not bool(torch.isfinite(got).all()):
        return math.inf, 1.0, math.inf
    d = (got - ref).abs()
    tol = SHADE_GRAD_RTOL * ref.abs() + SHADE_GRAD_ATOL * max(float(ref.abs().max()), 1e-30)
    ratio = d / tol
    return float(ratio.max()), float((ratio > 1.0).float().mean()), float(d.max())


def shade_tail_rows(fs, B: int, N: int, width: int = 64) -> list:
    """Flattened point indices within ``width`` of a place where the
    backward's work divides: a chunk's first and last points, the blocks
    that split its sums (colsum_kernel's, and wgrad_kernel's rounded to its
    pipeline steps), every frame boundary, the last point."""
    total = B * N
    _, chunks = fs.bwd_chunks(total)
    edges = set(range(0, total + 1, N))
    for c0, rows, splits in chunks:
        per = -(-rows // splits)
        for step in (per, -(-per // fs.WGRAD_STEP) * fs.WGRAD_STEP):
            edges.update(range(c0, c0 + rows, step))
        edges.add(c0 + rows)
    return sorted({p for e in edges for p in range(max(0, e - width), min(total, e + width))})


def shade_grad_parts(fs, g: dict, tail) -> dict:
    """The backward's returned tensors cut into the parts checked on their
    own: x_c, J^-1 and (given) their ``tail`` rows, the frame bias, each
    matrix of the three packs, each bias row, the SDF head's row and bias."""
    tw, bw, cw = fs._unpack(g["tw_b"], g["tw_f"], g["bw_b"], g["cw_b"], g["cw_f"])
    parts = {"xc": g["xc"], "jinv9": g["jinv9"], "fb0": g["fb0"]}
    if tail is not None:
        parts.update({"xc tail": g["xc"].reshape(-1, 3)[tail],
                      "jinv9 tail": g["jinv9"].reshape(-1, 9)[tail]})
    for tag, pack in (("tw", tw), ("bw", bw), ("cw", cw)):
        for k, v in pack.items():
            if k in ("bias", "cbias"):
                parts.update({f"{tag}.{k}{i}": row for i, row in enumerate(v)})
            elif k not in ("bf16", "f32"):
                parts[f"{tag}.{k}"] = v
    return parts


def part_kind(name: str, n: int) -> str:
    """The key of a part of ``n`` elements in GRAD_LIMITS and LOSS_LIMITS."""
    if name == "fb0":
        return "frame bias"
    if name in COLOUR_PARTS:
        return "colour"
    return "point" if name.startswith(("xc", "jinv9")) or n == 1 else "trunk"


def grad_table(read: dict, limits: dict, show, control: str) -> tuple:
    """Holds each part's kernel reading, and the ``control``'s, to the
    part's (share, cap) in ``limits``; prints a line for each part in
    ``show`` and each that either fails.  Returns (parts the kernel fails,
    parts the control fails)."""
    failed, caught = [], []
    for k, (w, sh, _) in read["kernel"].items():
        share, cap = limits[k]
        ok = sh <= share and w <= cap
        cw, csh, _ = read[control][k]
        if not ok:
            failed.append(k)
        if not (csh <= share and cw <= cap):
            caught.append(k)
        if k in show or not ok or k in caught:
            print(f"      {k}: " + " | ".join(f"{read[lab][k][0]:.3f} ({read[lab][k][1]:.1e})"
                                         for lab in ("kernel", "f64 products", control))
                  + f"; limit {cap:g} ({share:g}) {'ok' if ok else 'FAIL'}", flush=True)
    return failed, caught


def shade_grad_check(torch, fs, args, cts, tail, kinds: dict = GRAD_LIMITS) -> dict:
    """One backward of row 7, part by part: the kernel, the plain version
    with float64 products and without its bf16 roundings, each against the
    plain version, held to ``kinds``' limits.  Returns {reading: {part: (worst,
    share, max|d|)}, "limits": ..., "failed": [...], "caught": [...],
    "ref": the plain version's gradients}."""
    from unittest import mock

    def plain():
        return fs.shade_train_bwd_plain(*args, *cts)

    ref = plain()
    got = fs.shade_train_bwd_cuda(*args, *cts)
    torch.cuda.synchronize()
    with products_in_f64(torch):
        f64 = plain()
    with mock.patch.object(fs, "_bf", lambda x: x):
        unrounded = plain()
    tail_t = torch.tensor(tail, device=args[0].device)
    ref_p = shade_grad_parts(fs, ref, tail_t)
    out = {}
    for lab, g in (("kernel", got), ("f64 products", f64), ("unrounded", unrounded)):
        parts = shade_grad_parts(fs, g, tail_t)
        out[lab] = {k: grad_reading(torch, parts[k], r) for k, r in ref_p.items()}
    out["limits"] = {k: kinds[part_kind(k, r.numel())] for k, r in ref_p.items()}
    print(f"    backward, {len(ref_p)} parts, worst |d| / bound (share beyond) of the kernel | f64 "
          f"products | unrounded, and the part's limit:", flush=True)
    out["failed"], out["caught"] = grad_table(out, out["limits"], ref_p, "unrounded")
    out["ref"] = ref
    print(f"    the unrounded control fails {len(out['caught'])} of {len(ref_p)} parts "
          f"{'ok' if out['caught'] else 'FAIL'}", flush=True)
    return out


def shade_checks(torch, scene, params, batch, z_obj, xc_hand, jinv_hand, dev, record,
                 results) -> None:
    """Phase 3, row 7: the fused training shade's forward and backward
    kernels against their plain versions, at the grad stage's real canonical
    points and J^-1 of both nodes (the sampler's z tables of one step, 10
    frames x 12,544 points) and at an N that is no multiple of the kernel's
    128-point tile; seeded cotangents."""
    from hold_tpu_torch.models.holdnet import _rays
    from hold_tpu_torch.models.mlp import _apply_linear, resolve_weight_norm
    from hold_tpu_torch.models.nodes import _mano_pose, _object_pose
    from hold_tpu_torch.models.object_model import object_deform
    from hold_tpu_torch.ops import fused_query as fq
    from hold_tpu_torch.ops import fused_render as fr
    from hold_tpu_torch.ops import fused_shade as fs
    from hold_tpu_torch.utils.transforms import inverse_mat3

    B = xc_hand.shape[0]
    ray_dirs, cam_loc = _rays(batch)
    cases = {}
    with torch.no_grad():
        for nid in ("right", "object"):
            plans = scene.plans[nid]
            imp = resolve_weight_norm(params[nid]["implicit"])
            rend = resolve_weight_norm(params[nid]["rendering"])
            tw = fq.pack_trunk_weights(imp, plans.implicit)
            packs = (fq.embed_window(plans.implicit, sum(plans.barf_cfg) // 2, plans.barf_cfg, dev),
                     tw, fr.pack_trunk_transposed(imp, plans.implicit, tw),
                     fr.pack_color_weights(rend, imp))
            if nid == "right":
                _, cond = _mano_pose(params[nid], scene.servers[nid], batch, 25)
                fb0 = fr.frame_bias0(rend, _apply_linear(rend["lin_pose"], cond))
                xc, jinv = xc_hand, jinv_hand
            else:
                tfs = _object_pose(params[nid], scene.servers[nid], batch).obj_tfs
                pts = (cam_loc[:, None] + z_obj[..., None] * ray_dirs[:, None]).reshape(B, -1, 3)
                xc = object_deform(pts, tfs, inverse=True).contiguous()
                jinv = inverse_mat3(tfs[:, :3, :3]).reshape(B, 1, 9).expand(
                    B, xc.shape[1], 9).contiguous()
                tc = params[nid]["frame_latent"][batch["frame_idx"]]
                fb0 = fr.frame_bias0(rend, torch.zeros((B, 8), device=dev), tc)
            cases[nid] = (xc, jinv, fb0.detach().contiguous(), *packs)
        n_pad = cases["right"][0].shape[1] - 61
        cases[f"right N={n_pad}"] = (cases["right"][0][:, :n_pad].contiguous(),
                                     cases["right"][1][:, :n_pad].contiguous(),
                                     *cases["right"][2:])
    gen = torch.Generator(dev).manual_seed(7)
    errs = {"fwd": {}, "bwd": {}}
    failed = []
    for label, args in cases.items():
        Bc, N = args[0].shape[:2]
        print(f"  fused_shade_train, {label} (B={Bc} N={N}):", flush=True)
        got, ref = fs.shade_train_fwd_cuda(*args), fs.shade_train_plain(*args)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"fused_shade_train.fwd: shape {tuple(g.shape)} or non-finite")
        e = {"sdf": check_bf16_query("  sdf", got[0], ref[0]),
             "rgb": check_close("  rgb", got[1], ref[1], 0.0, RENDER_RGB)}
        d_n = (got[2] - ref[2]).abs().flatten()
        p99, n_max = float(d_n.quantile(0.99)), float(d_n.max())
        ok = p99 <= RENDER_NRM_P99 and n_max <= RENDER_NRM_MAX
        print(f"    normal: p99 |d| {p99:.3e} (tol {RENDER_NRM_P99}), max {n_max:.3e} "
              f"(tol {RENDER_NRM_MAX}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("fused_shade_train.fwd: normals disagree with the plain version")
        e["normal"] = n_max
        errs["fwd"][label] = e
        tail = shade_tail_rows(fs, Bc, N)
        # the cotangents of the JAX package's test loss, sum sdf^2 + |rgb|^2
        # + |n_x|, which do not cancel over the points
        g_nrm = torch.zeros_like(ref[2])
        g_nrm[..., 0] = torch.sign(ref[2][..., 0])
        print("    under the JAX test's loss:", flush=True)
        res_l = shade_grad_check(torch, fs, args, (2.0 * ref[0], 2.0 * ref[1], g_nrm), tail,
                                 LOSS_LIMITS)
        failed += [f"{label} {k} (the JAX test's loss)" for k in res_l["failed"]]
        cts = [torch.randn(s, generator=gen, device=dev) for s in ((Bc, N), (Bc, N, 3), (Bc, N, 3))]
        print("    under seeded cotangents:", flush=True)
        res = shade_grad_check(torch, fs, args, cts, tail)
        # the tail rows alone: with the other points' cotangents zero, every
        # sum over the points holds only theirs
        mask = torch.zeros(Bc * N, device=dev)
        mask[tail] = 1.0

        def masked(m):
            return [c * m.view((Bc, N) + (1,) * (c.dim() - 2)) for c in cts]

        # control: the first 16 points of each frame summed into the frame
        # before must fail the frame bias's limits
        first = torch.zeros((Bc, N), device=dev)
        first[1:, :16] = 1.0
        moved = fs.shade_train_bwd_plain(*args, *masked(first.view(-1)))["fb0"]
        ref_fb = res["ref"]["fb0"]
        w, sh, _ = grad_reading(torch, ref_fb - moved + moved.roll(-1, 0), ref_fb)
        share, cap = res["limits"]["fb0"]
        ok = sh > share or w > cap
        print(f"    control, each frame's first 16 points summed into the frame before: fb0 "
              f"{w:.3f} ({sh:.1e}), limit {cap:g} ({share:g}) {'fails it, ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failed.append(f"{label}: the frame bias's limits pass misplaced frame boundaries")

        print(f"    the {len(tail)} tail rows alone (cotangents zero elsewhere):", flush=True)
        res_t = shade_grad_check(torch, fs, args, masked(mask), tail)
        failed += [f"{label} {k}" for k in res["failed"]]
        failed += [f"{label} {k} (tail rows alone)" for k in res_t["failed"]]
        if not (res["caught"] and res_t["caught"]):
            failed.append(f"{label}: the limits pass the unrounded control")
        kern = res["kernel"]
        top = max((k for k in kern if k != "fb0"), key=lambda k: kern[k][0])
        errs["bwd"][label] = {
            "worst_part": top, "worst": kern[top][0], "fb0": kern["fb0"][0],
            "sound_worst": max(v[0] for v in res["f64 products"].values()),
            "tail_alone_worst": max(v[0] for v in res_t["kernel"].values()),
            "jax_loss_worst": max(v[0] for v in res_l["kernel"].values()),
            "max_abs_err": max(v[2] for v in kern.values())}
        if N % fr.TILE:
            # control: the plain version without the last partial 16-point
            # block must fail the limits, or they could not see a kernel that
            # dropped one
            k = (Bc * N) % 16 or 16
            drop = mask.clone()
            drop[-k:] = 0.0
            ref_t = shade_grad_parts(fs, fs.shade_train_bwd_plain(*args, *masked(mask)), None)
            ctl = shade_grad_parts(fs, fs.shade_train_bwd_plain(*args, *masked(drop)), None)
            caught = []
            for p, r in ref_t.items():
                w, sh, _ = grad_reading(torch, ctl[p], r)
                share, cap = res_t["limits"][p]
                if sh > share or w > cap:
                    caught.append(p)
            print(f"    control, the last {k} points dropped: the limits fail it on "
                  f"{len(caught)} parts ({', '.join(caught[:6])}, ...) "
                  f"{'ok' if caught else 'FAIL'}", flush=True)
            if not caught:
                failed.append(f"{label}: the limits pass a dropped last block")
    args = cases["right"]
    n = args[0].shape[0] * args[0].shape[1]
    cts = [torch.randn(s, generator=gen, device=dev) for s in ((B, n // B), (B, n // B, 3),
                                                               (B, n // B, 3))]
    wbytes = ((fq.W_TOTAL + fr.T_TOTAL + fr.C_TOTAL) * 2.0 + (fq.F_TOTAL + fr.CB_TOTAL) * 4.0
              + B * 256 * 4.0)
    act = 8 * 256 * 10.0 + 8 * 256 + 4 * 256 * 2 + 60  # activations, sigmoids, relus
    shape = f"B={B} N={n // B} (hand; also the object and N={n // B - 61})"
    for name, kern, plain, macs, f32_pp, bytes_pp, bytes_once in (
        ("fused_shade_train.fwd", lambda: fs.shade_train_fwd_cuda(*args),
         lambda: fs.shade_train_plain(*args), fs.SHADE_FWD_MACS, act, 76.0, wbytes),
        ("fused_shade_train.bwd", lambda: fs.shade_train_bwd_cuda(*args, *cts),
         lambda: fs.shade_train_bwd_plain(*args, *cts), fs.SHADE_BWD_MACS, 3 * act, 124.0,
         wbytes * 3),
    ):
        ms = cuda_ms(torch, kern)
        part = errs[name.split(".")[1]]
        worst = max(e["max_abs_err"] if "max_abs_err" in e else max(e.values())
                    for e in part.values())
        record(name, worst, ms, cuda_ms(torch, plain, fill_ms=0.0), shape,
               bound(2.0 * macs * n, f32_pp * n, bytes_pp * n + bytes_once), errors=part,
               tflop_s=2.0 * macs * n / (ms * 1e-3) / 1e12)
    # the backward's device time by kernel: three more calls under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fs.shade_train_bwd_cuda(*args, *cts)
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = next((k for k in ("fused_shade_bwd_kernel", "wgrad_kernel", "colsum_kernel")
                        if k in e.name), "other (memset, copies, elementwise)")
            split[key] = split.get(key, 0.0) + e.time_range.elapsed_us() / 3e3
    if split:
        results["fused_shade_train.bwd"]["split_ms"] = split
        print("  fused_shade_train.bwd by kernel (torch.profiler, ms a call over 3 calls): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items())), flush=True)
    else:
        print("  fused_shade_train.bwd by kernel: not measured (the profiler saw no device events)")
    if failed:
        raise AssertionError(f"fused_shade_train.bwd disagrees with its plain version: {failed}")


def render_batch(torch, seq, dev, n_rays):
    """``n_rays`` pixels of frame 0 at RENDER_DOWNSAMPLE, as one chunk of the
    renderer: those that the ground-truth mask marks as hand or object
    (evenly spaced when there are more), then background pixels evenly
    spaced to fill, in the frame's order.  Returns (batch, pixel indices)."""
    import numpy as np

    from hold_tpu_torch.train import batch_to_device

    fb = seq.full_frame_batch(0, downsample=RENDER_DOWNSAMPLE)

    def spaced(ix, n):
        return ix[np.linspace(0, len(ix) - 1, n).round().astype(int)] if n < len(ix) else ix

    fg = spaced(np.flatnonzero(fb["gt_mask"] > 0), n_rays)
    pix = np.sort(np.concatenate([fg, spaced(np.flatnonzero(fb["gt_mask"] == 0),
                                             n_rays - len(fg))]))
    batch = batch_to_device({k: fb[k] for k in ("frame_idx", "intrinsics", "extrinsics",
                                                  "scene_scale")}, dev)
    batch["uv"] = torch.as_tensor(np.asarray(fb["uv"])[:, pix], device=dev)
    return batch, pix


def render_checks(torch, seq, scene, params, dev, record) -> None:
    """Phase 3, rows 8 and 9: the fused render kernels against their plain
    versions at one render chunk's real points."""
    from hold_tpu_torch.models.holdnet import _rays, sample_all_z
    from hold_tpu_torch.models.mlp import _apply_linear, resolve_weight_norm
    from hold_tpu_torch.models.nodes import _mano_pose, _object_pose, node_render_packs
    from hold_tpu_torch.ops import fused_query as fq
    from hold_tpu_torch.ops import fused_render as fr
    from hold_tpu_torch.utils.transforms import inverse_mat3

    batch, _ = render_batch(torch, seq, dev, PIXEL_PER_BATCH)
    ray_dirs, cam_loc = _rays(batch)
    z = sample_all_z(params, scene, batch, None, None, None)
    B = 1
    inputs = {}
    with torch.no_grad():
        for nid in ("right", "object"):
            rend = resolve_weight_norm(params[nid]["rendering"])
            pts = (cam_loc[:, None] + z[nid][..., None] * ray_dirs[:, None]).reshape(1, -1, 3)
            packs = node_render_packs(params[nid], scene.plans[nid], dev)
            if nid == "right":
                srv = scene.servers[nid]
                out, cond = _mano_pose(params[nid], srv, batch, None)
                frame = (out.verts.contiguous(), srv.verts_c.expand(B, -1, -1).contiguous(),
                         srv.skin_weights_c.expand(B, -1, -1).contiguous(), out.tfs.contiguous())
                fb0 = fr.frame_bias0(rend, _apply_linear(rend["lin_pose"], cond))
            else:
                tfs = _object_pose(params[nid], scene.servers[nid], batch).obj_tfs
                frame = (torch.cat([inverse_mat3(tfs[:, :3, :3]).reshape(B, 9), tfs[:, :3, 3]],
                                   -1).contiguous(),)
                tc = params[nid]["frame_latent"][batch["frame_idx"]]
                fb0 = fr.frame_bias0(rend, torch.zeros((B, 8), device=dev), tc)
            inputs[nid] = (pts.contiguous(), *frame, *packs, fb0.detach())
    V, J = inputs["right"][1].shape[1], inputs["right"][3].shape[2]
    wbytes = ((fq.W_TOTAL + fr.T_TOTAL + fr.C_TOTAL) * 2.0
              + (fq.F_TOTAL + fr.CB_TOTAL + 256) * 4.0)
    act = 8 * 256 * 10.0 + 8 * 256 + 4 * 256 * 2 + 60  # activations, sigmoids, relus
    for name, nid, kern, plain, f32_pp, bytes_once in (
        ("fused_hand_render", "right", fr.fused_hand_render, fr.hand_render_plain,
         act + 2 * knn_cost(1, V, J) + 42 * J + 75, wbytes + frame_bytes(B, V, J) + B * V * 12),
        ("fused_object_render", "object", fr.fused_object_render, fr.object_render_plain,
         act + 24, wbytes + 48),
    ):
        args = inputs[nid]
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name}: shape {tuple(g.shape)} or non-finite values")
        err = check_bf16_query(f"{name} sdf", got[0], ref[0])
        errs = {"sdf": err}
        errs["x_c"] = check_close(f"{name} x_c", got[4], ref[4], 1e-5, 1e-5)
        errs["dist"] = check_close(f"{name} dist", got[3], ref[3], 0.0, 1e-5)
        errs["rgb"] = check_close(f"{name} rgb", got[1], ref[1], 0.0, RENDER_RGB)
        d_n = (got[2] - ref[2]).abs().flatten()
        p99, n_max = float(d_n.quantile(0.99)), float(d_n.max())
        ok = p99 <= RENDER_NRM_P99 and n_max <= RENDER_NRM_MAX
        print(f"  {name} normal: p99 |d| {p99:.3e} (tol {RENDER_NRM_P99}), max {n_max:.3e} "
              f"(tol {RENDER_NRM_MAX}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: normals disagree with the plain version")
        n = got[0].numel()
        ms = cuda_ms(torch, lambda: kern(*args))
        record(name, max(errs.values()), ms, cuda_ms(torch, lambda: plain(*args), fill_ms=0.0),
               f"B={B} N={n} ({PIXEL_PER_BATCH} rays x {n // PIXEL_PER_BATCH} samples)",
               bound(2.0 * fr.RENDER_MACS * n, f32_pp * n, 56.0 * n + bytes_once),
               errors=errs, mean_abs_err=float((got[0] - ref[0]).abs().mean()),
               normal_p99=p99, max_abs_sdf=float(ref[0].abs().max()),
               tflop_s=fr.RENDER_FLOPS_PER_POINT * n / (ms * 1e-3) / 1e12)


def agreement_check(torch, seq, args, cfg, dev, fused_train: bool) -> None:
    """Phase 4: grad-stage loss and gradients, card kernels vs CPU plain path,
    with the fused training shade or the chunked one (``--no_fused_train``).
    The chunked path is held to 1e-4 (losses) and 2e-4 (gradients); the
    fused one, whose bf16 roundings fall on different sides where the sums'
    order differs, to 2e-3 (losses, the JAX package's fused-vs-chunked bound)
    and each parameter's gradient to AGREE_LIMIT, beside two more CPU runs
    read the same way: the plain path with float64 products (sound) and the
    chunked f32 shade (the control)."""
    import numpy as np

    from hold_tpu_torch.models.holdnet import (
        build_scene, empty_object_mesh_state, holdnet_forward, init_scene_params,
        sample_all_z, sample_step_draws,
    )
    from hold_tpu_torch.models.losses import compute_losses
    from hold_tpu_torch.train import batch_to_device
    from hold_tpu_torch.utils.convert import flatten_params, leaf_params

    step, epoch = 300, 25  # hand loss targets active, pose conditioning on
    opt_model = dict(cfg["model"])
    batch_np = seq.sample_tempo_batch(np.random.RandomState(1), 1, 1, 16)
    params0 = init_scene_params(torch.Generator().manual_seed(3),
                                build_scene(opt_model, dict(args), seq.scene_data(), "cpu"),
                                seq.scene_data())
    scene_cpu = build_scene(opt_model, dict(args), seq.scene_data(), "cpu")
    draws_cpu = sample_step_draws(scene_cpu, 2, 16, torch.Generator().manual_seed(4))
    z_card = {}

    def grad_stage(device, check_z: bool = False, fused: bool = fused_train):
        scene = build_scene(opt_model, dict(args), seq.scene_data(), device, fused_train=fused)
        if [scene.plans[nid].fused_train for nid in scene.node_ids] != [fused] * 2:
            raise AssertionError(f"fused training shade not {fused} on every node")
        params = leaf_params(params0, device)
        batch = batch_to_device(batch_np, device)
        if not z_card:  # the card's sampler places the samples for every run
            if not all(scene.plans[nid].fused_query for nid in scene.node_ids):
                raise AssertionError("the slice's sampler is not the fused one")
            z_card.update(sample_all_z(params, scene, batch, None, step, epoch))
        elif check_z:  # fused query kernels on the card against their plain versions
            for nid, ref in sample_all_z(params, scene, batch, None, step, epoch).items():
                d = (z_card[nid].cpu() - ref).abs()
                tol = 0.1 * float(torch.diff(ref, dim=1).median())
                far = float((d > tol).float().mean())
                ok = far <= Z_FAR_SHARE
                print(f"  z table {nid}: |card - cpu| max {float(d.max()):.3e}, p99 "
                      f"{float(d.flatten().quantile(0.99)):.3e}; share beyond 0.1 x median "
                      f"spacing ({tol:.3e}) {far:.5f} (tol {Z_FAR_SHARE}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"{nid}: card and CPU z tables disagree")
        z = {k: v.to(device) for k, v in z_card.items()}
        draws = {k: (tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device))
                 for k, v in draws_cpu.items()}
        out = holdnet_forward(params, scene, batch, empty_object_mesh_state(device), draws,
                              step, epoch, z_vals_dict=z)
        loss = compute_losses(batch, out, scene.node_ids, step)
        flat = flatten_params(params)
        names = [k for k, t in flat.items() if t.requires_grad]
        g = torch.autograd.grad(loss["loss"], [flat[k] for k in names], allow_unused=True)
        return ({k: float(v.detach()) for k, v in loss.items()},
                {k: (torch.zeros_like(flat[k]) if gi is None else gi).cpu()
                 for k, gi in zip(names, g)})

    losses, grads = {}, {}
    losses["cuda"], grads["cuda"] = grad_stage(dev)
    losses["cpu"], grads["cpu"] = grad_stage(torch.device("cpu"), check_z=True)
    rtol = 2e-3 if fused_train else 1e-4
    for k, v in losses["cpu"].items():
        got = losses["cuda"][k]
        print(f"  {k}: card {got:.6f} cpu {v:.6f}", flush=True)
        if not (math.isfinite(got) and abs(got - v) <= rtol * abs(v) + 1e-5):
            raise AssertionError(f"{k}: card and CPU disagree")
    if fused_train:
        with products_in_f64(torch):
            _, grads["f64 products"] = grad_stage(torch.device("cpu"))
        _, grads["chunked"] = grad_stage(torch.device("cpu"), fused=False)
        read = {lab: {k: grad_reading(torch, grads[src][k], ref) for k, ref in grads["cpu"].items()}
                for lab, src in (("kernel", "cuda"), ("f64 products", "f64 products"),
                                 ("chunked", "chunked"))}
        print(f"  {len(read['kernel'])} gradient tensors, worst |d| / bound (share beyond) against "
              f"the CPU's, of the card | f64 products | chunked:", flush=True)
        for lab, r in read.items():
            w = max(r.values())
            print(f"    {lab}: {sum(v[0] <= 1.0 for v in r.values())} tensors wholly within the "
                  f"bound, worst {w[0]:.3f} (share {w[1]:.2e}), largest share "
                  f"{max(v[1] for v in r.values()):.2e}", flush=True)
        show = sorted(read["kernel"], key=lambda k: -max(read["kernel"][k][0],
                                                         read["f64 products"][k][0]))[:12]
        print("    the 12 worst, and every tensor that either fails:", flush=True)
        failed, caught = grad_table(read, {k: AGREE_LIMIT for k in read["kernel"]}, show,
                                    "chunked")
        print(f"  the chunked control fails {len(caught)} of {len(read['kernel'])} tensors "
              f"{'ok' if caught else 'FAIL'}", flush=True)
        if failed or not caught:
            raise AssertionError(f"gradients beyond their limit: {failed[:8]}, or the limit "
                                 f"passes the chunked control")
        return
    bad = []
    for k, ref in grads["cpu"].items():
        scale = float(ref.abs().max())
        if max_err(grads["cuda"][k], ref) > 2e-4 * scale + 2e-4:
            bad.append(k)
    print(f"  {len(grads['cpu'])} gradient tensors, tolerance 2e-4*max|ref| + 2e-4: "
          f"{len(bad)} outside", flush=True)
    if bad:
        raise AssertionError(f"gradients disagree: {bad[:8]}")


def render_agreement(torch, seq, args, cfg, dev) -> None:
    """Phase 4, render: one chunk of 256 hand and object rays, the card's
    eval z tables given to both sides, holdnet_render with the fused render
    kernels on the card against their plain versions on the CPU, on the
    composited maps.  The rays' mean mask_prob must reach MASK_FLOOR, so
    that the maps compared carry the nodes' shade."""
    from hold_tpu_torch.models.holdnet import (
        build_scene, holdnet_render, init_scene_params, sample_all_z,
    )
    from hold_tpu_torch.utils.convert import leaf_params

    params0 = init_scene_params(torch.Generator().manual_seed(3),
                                build_scene(dict(cfg["model"]), dict(args), seq.scene_data(), "cpu"),
                                seq.scene_data())
    maps, z_vals = {}, None
    for device in (dev, torch.device("cpu")):
        scene = build_scene(dict(cfg["model"]), dict(args), seq.scene_data(), device)
        if not all(p.fused_render for p in scene.plans.values()):
            raise AssertionError("the slice's render shade is not the fused one")
        params = leaf_params(params0, device)
        batch, _ = render_batch(torch, seq, device, 256)
        if z_vals is None:
            z_vals = sample_all_z(params, scene, batch, None, None, None)
        out = holdnet_render(params, scene, batch, {k: v.to(device) for k, v in z_vals.items()})
        maps[device.type] = {k: out[k].cpu() for k in RENDER_MAP_TOL}
    mask = float(maps["cuda"]["mask_prob"].mean())
    print(f"  render rays: mean mask_prob {mask:.4f} (floor {MASK_FLOOR}) "
          f"{'ok' if mask >= MASK_FLOOR else 'FAIL'}", flush=True)
    if mask < MASK_FLOOR:
        raise AssertionError("the compared render rays miss the hand and the object")
    for k, tol in RENDER_MAP_TOL.items():
        d = max_err(maps["cuda"][k], maps["cpu"][k])
        print(f"  render {k}: max |card - cpu| {d:.3e} (tol {tol:g}) "
              f"{'ok' if d <= tol else 'FAIL'}", flush=True)
        if not (d <= tol and bool(torch.isfinite(maps["cuda"][k]).all())):
            raise AssertionError(f"render {k}: card and CPU disagree")


def slice_run(torch, seq, args, cfg, dev, steps: int) -> dict:
    """Phase 5, one run: ``run_training`` from counters at 0; checks the
    losses and that this path launched each of its kernels.  Returns the
    launch counts."""
    from hold_tpu_torch.ops import fused_query, fused_render, fused_shade, knn, point_mesh
    from hold_tpu_torch.train import run_training

    path = ("layer" if args.get("no_fused_sampler") else
            "chunked" if args.get("no_fused_train") else "fused")
    print(f"  -- {path}{' (--no_remat)' if args.get('no_remat') else ''}: {steps} steps", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mods = (knn, point_mesh, fused_query, fused_render, fused_shade)
    for mod in mods:
        mod.reset_launch_counts()
    params, scene, mesh_state, tracker, timer = run_training(args, cfg, seq=seq, max_steps=steps,
                                                             device=dev)
    torch.cuda.synchronize()
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    fused = [nid for nid in scene.node_ids if scene.plans[nid].fused_query]
    shade = [nid for nid in scene.node_ids if scene.plans[nid].fused_train]
    if (fused != (list(scene.node_ids) if path != "layer" else [])
            or shade != (list(scene.node_ids) if path != "chunked" else [])):
        raise AssertionError(f"{path} run: fused sampler on {fused}, fused shade on {shade}")
    with open(os.path.join(tracker.log_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if len(records) != steps:
        raise AssertionError(f"expected {steps} metric records, got {len(records)}")
    for rec in records:
        bad = {k: v for k, v in rec.items() if k.startswith("loss") and not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite losses at step {rec['step']}: {bad}")
        print(f"  step {rec['step']}: loss {rec['loss']:.5f} rgb {rec['loss/rgb']:.5f} "
              f"psnr {rec['psnr']:.3f}")
    print(f"  launches: {launches}")
    missing = [k for k, (_, _, paths) in KERNELS.items() if path in paths and launches[k] == 0]
    stray = [k for k, (_, _, paths) in KERNELS.items() if path not in paths and launches[k]]
    if missing or stray:
        raise AssertionError(f"{path} run: not launched {missing}, launched off its path {stray}")
    summ = timer.summary()
    rays = BATCH_SIZE * 2 * RAYS_PER_FRAME
    step_s = summ["sampler"] + summ["grad"] + summ["data"]
    print(f"  sampler_ms {summ['sampler'] * 1e3:.3f}")
    print(f"  grad_ms {summ['grad'] * 1e3:.3f}")
    print(f"  data_ms {summ['data'] * 1e3:.3f}")
    print(f"  rays_per_s {rays / step_s:.1f} ({rays} rays per step, steps 1..{steps - 1})")
    print(f"  max_memory_allocated_bytes {peak} ({peak / 2**30:.3f} GiB)", flush=True)
    train_profile(torch, seq, args, scene, params, mesh_state, dev, summ)
    return launches


# kernel families of the device time: (family, substrings of kernel names)
FAMILIES = (
    ("fused_shade fwd", ("fused_shade_fwd_kernel",)),
    ("fused_shade bwd rows", ("fused_shade_bwd_kernel",)),
    ("fused_shade wgrad", ("wgrad_kernel",)),
    ("fused_shade colsum", ("colsum_kernel",)),
    ("fused_render", ("fused_render_kernel",)),
    ("fused_query warp", ("query_embed_kernel",)),
    ("fused_query trunk", ("query_trunk_kernel",)),
    ("knn", ("knn_", "min_vertex_dist")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_")),
    ("memcpy", ("memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized")),
    ("reduce", ("reduce",)),
)


def device_split(torch, prof) -> tuple:
    """Device time (ms) and launches by kernel family from a profile."""
    fams = {f: [0.0, 0] for f, _ in FAMILIES}
    fams["other"] = [0.0, 0]
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        fam = next((f for f, keys in FAMILIES if any(k in name for k in keys)), "other")
        fams[fam][0] += e.time_range.elapsed_us() / 1e3
        fams[fam][1] += 1
    total = sum(ms for ms, _ in fams.values())
    split = ", ".join(f"{k} {ms:.3f} ms / {n}" for k, (ms, n) in fams.items() if n)
    return total, sum(n for _, n in fams.values()), split


def train_profile(torch, seq, args, scene, params, mesh_state, dev, summ) -> None:
    """Phase 5, report only: one more step of the run's path under
    torch.profiler, its sampler and grad stages profiled apart; device time
    and launches by kernel family, and the busy share, device time over the
    run's mean unprofiled stage wall."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from hold_tpu_torch.models.holdnet import holdnet_forward, sample_all_z, sample_step_draws
    from hold_tpu_torch.models.losses import compute_losses
    from hold_tpu_torch.train import batch_to_device, optimizer_for

    opt = optimizer_for(args, params)
    batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(5), BATCH_SIZE, 1,
                                                   RAYS_PER_FRAME), dev)
    B, P = batch["uv"].shape[:2]
    gen = torch.Generator(dev).manual_seed(5)
    step = int(args["total_step"])

    def sampler():
        return sample_all_z(params, scene, batch, gen, step, 0)

    def grad(z):
        draws = sample_step_draws(scene, B, P, gen)
        opt.zero_grad(set_to_none=True)
        out = holdnet_forward(params, scene, batch, mesh_state, draws, step, 0, z_vals_dict=z)
        compute_losses(batch, out, scene.node_ids, step)["loss"].backward()
        opt.step()

    z = sampler()
    grad(z)
    torch.cuda.synchronize()
    for stage, fn in (("sampler", sampler), ("grad", lambda: grad(z))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        total, n, split = device_split(torch, prof)
        if not total:
            print(f"  {stage} device split: not measured (the profiler saw no device events)")
            continue
        print(f"  {stage} device split (torch.profiler, one step): {split}; device total "
              f"{total:.3f} ms in {n} launches, busy share {total / (summ[stage] * 1e3):.3f} of "
              f"the {summ[stage] * 1e3:.3f} ms stage", flush=True)


def render_slice(torch, seq, data_root, args, dev) -> dict:
    """Phase 6: render_cli on the fused run's checkpoint, from counters at 0;
    checks the maps and the launches, prints the frame times; then one chunk
    with the chunked render shade, held to PSNR_FLOOR.  Returns the counts."""
    import numpy as np

    from hold_tpu_torch import render_cli
    from hold_tpu_torch.ops import fused_query, fused_render, fused_shade, knn, point_mesh
    from hold_tpu_torch.render.renderer import make_chunk_renderer
    from hold_tpu_torch.utils.checkpoint import load_experiment

    exp = os.path.join(args["log_root"], args["exp_key"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mods = (knn, point_mesh, fused_query, fused_render, fused_shade)
    for mod in mods:
        mod.reset_launch_counts()
    records = render_cli.main([
        "--exp", exp, "--case", "synthetic", "--data_root", data_root,
        "--render_downsample", str(RENDER_DOWNSAMPLE), "--pixel_per_batch", str(PIXEL_PER_BATCH),
        "--num_agents", str(FRAMES // RENDER_FRAMES), "--agent_id", "0",
        "--out", os.path.join(args["log_root"], "renders"),
        "--export_root", os.path.join(args["log_root"], "exports"), "--device", dev.type,
    ])
    torch.cuda.synchronize()
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    if len(records) != RENDER_FRAMES:
        raise AssertionError(f"rendered {len(records)} frames, expected {RENDER_FRAMES}")
    for rec in records:
        res = rec["res"]
        bad = [k for k, v in res.items() if not np.isfinite(v).all()]
        if bad or res["rgb"].shape[:2] != (IMG_HW[0] // RENDER_DOWNSAMPLE,
                                           IMG_HW[1] // RENDER_DOWNSAMPLE):
            raise AssertionError(f"frame {rec['idx']}: non-finite {bad} or shape "
                                 f"{res['rgb'].shape}")
        rays = res["rgb"].shape[0] * res["rgb"].shape[1]
        ph = rec["phases"]
        print(f"  frame {rec['idx']}: render_ms {rec['seconds'] * 1e3:.3f} (sampler "
              f"{ph['sampler'] * 1e3:.3f}, shade {ph['shade'] * 1e3:.3f}), rays_per_s "
              f"{rays / rec['seconds']:.1f} ({rays} rays, mask mean "
              f"{float(res['mask_prob'].mean()):.4f})", flush=True)
    print(f"  max_memory_allocated_bytes {peak} ({peak / 2**30:.3f} GiB)")
    print(f"  launches: {launches}")
    missing = [k for k, (_, _, paths) in KERNELS.items() if "render" in paths and launches[k] == 0]
    stray = [k for k, (_, _, paths) in KERNELS.items() if "render" not in paths and launches[k]]
    if missing or stray:
        raise AssertionError(f"render run: not launched {missing}, launched off its path {stray}")

    params, scene = load_experiment(exp, seq, dev, fused_render=False)
    batch, pix = render_batch(torch, seq, dev, PIXEL_PER_BATCH)
    layer = make_chunk_renderer(scene)(params, batch)
    res0 = records[0]["res"]  # frame 0
    mse = float(np.mean((layer["rgb"].cpu().numpy() - res0["rgb"].reshape(-1, 3)[pix]) ** 2))
    psnr = -10.0 * math.log10(max(mse, 1e-20))
    d_n = np.abs(layer["normal"].cpu().numpy() - res0["normal"].reshape(-1, 3)[pix])
    mask = float(layer["mask_prob"].mean())
    ok = psnr >= PSNR_FLOOR and mask >= MASK_FLOOR
    print(f"  one chunk (hand and object pixels first), fused render vs chunked f32 shade: "
          f"rgb PSNR {psnr:.2f} dB (floor {PSNR_FLOOR}); mean mask_prob {mask:.4f} (floor "
          f"{MASK_FLOOR}) {'ok' if ok else 'FAIL'}; normal map |d| max {d_n.max():.3e} mean "
          f"{d_n.mean():.3e}", flush=True)
    if not ok:
        raise AssertionError("the fused render disagrees with the chunked render shade, or "
                             "the chunk misses the hand and the object")
    render_profile(torch, seq, exp, dev, sum(r["seconds"] for r in records) / len(records))
    return launches


def render_profile(torch, seq, exp: str, dev, frame_s: float) -> None:
    """Phase 6, report only: one more frame of the fused render under
    torch.profiler; device time and launches by kernel family, and the busy
    share, device time over ``frame_s`` (the unprofiled frames' mean wall)."""
    from torch.profiler import ProfilerActivity, profile

    from hold_tpu_torch.render.renderer import make_chunk_renderer, render_frame
    from hold_tpu_torch.utils.checkpoint import load_experiment

    params, scene = load_experiment(exp, seq, dev)
    fb = seq.full_frame_batch(0, downsample=RENDER_DOWNSAMPLE)
    chunk_fn = make_chunk_renderer(scene)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render_frame(params, scene, fb, PIXEL_PER_BATCH, chunk_fn)
        torch.cuda.synchronize()
    total, n, split = device_split(torch, prof)
    if not total:
        print("  device split of a frame: not measured (the profiler saw no device events)")
        return
    print(f"  device split of a frame (torch.profiler): {split}; device total {total:.3f} ms in "
          f"{n} launches, busy share {total / (frame_s * 1e3):.3f} of the {frame_s * 1e3:.3f} ms "
          f"frame", flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "hold_tpu_torch")):
        print("chip_smoke.py must run from a checkout holding hold_tpu_torch/", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels run only on the card", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    t_all = time.perf_counter()

    phase("1 environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    print(f"  card: {smi}")
    import importlib.util

    for mod in ("cv2", "PIL", "yaml"):
        print(f"  {mod}: {'present' if importlib.util.find_spec(mod) else 'absent'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase("2 build")
    from hold_tpu_torch.ops import _cuda

    _cuda.lib()
    info = _cuda.build_info
    print(f"  {info['path']}: {info['seconds']:.1f} s ({'cached' if info['cached'] else 'built'})")
    kernel = "?"
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_label(line)
        elif "registers" in line or "spill" in line:
            print(f"  {kernel}: {line.split('info    :')[-1].strip()}")

    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.data.synthetic import generate_sequence

    data_root = os.path.join(ROOT, "logs", "chip_smoke", "data")
    built = generate_sequence(os.path.join(data_root, "synthetic"), FRAMES, IMG_HW)
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=RAYS_PER_FRAME)
    args, cfg = slice_config()

    phase("3 kernel checks")
    results = kernel_checks(torch, seq, args, cfg, dev)

    phase("4 card vs CPU agreement on a small batch")
    print("  -- chunked shade (--no_fused_train)", flush=True)
    agreement_check(torch, seq, args, cfg, dev, fused_train=False)
    print("  -- fused training shade", flush=True)
    agreement_check(torch, seq, args, cfg, dev, fused_train=True)
    print("  -- render", flush=True)
    render_agreement(torch, seq, args, cfg, dev)

    phase(f"5 the slice: run_training, {STEPS} steps fused, {LAYER_STEPS} layer by layer, "
          f"{LAYER_STEPS} with the chunked shade")
    from hold_tpu_torch.utils.config import Cfg

    launches = {
        "fused": slice_run(torch, seq, args, cfg, dev, STEPS),
        "layer": slice_run(torch, seq, Cfg({**args, "no_fused_sampler": True,
                                            "exp_key": "chip_smoke_layer"}),
                           cfg, dev, LAYER_STEPS),
        "chunked": slice_run(torch, seq, Cfg({**args, "no_fused_train": True,
                                              "exp_key": "chip_smoke_chunked"}),
                             cfg, dev, LAYER_STEPS),
    }
    # the chunked shade once more with every chunk's graph kept, for its peak
    # memory beside the recomputing default's
    slice_run(torch, seq, Cfg({**args, "no_fused_train": True, "no_remat": True,
                               "exp_key": "chip_smoke_no_remat"}), cfg, dev, 2)

    phase(f"6 the render slice: render_cli, {RENDER_FRAMES} frames at render_downsample "
          f"{RENDER_DOWNSAMPLE}")
    launches["render"] = render_slice(torch, seq, data_root, args, dev)
    print(f"  total {time.perf_counter() - t_all:.1f} s")

    kernels = []
    for name, (src, replaces, paths) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[src], "replaces": replaces,
            "launches": launches[paths[0]][name] if paths else 0,
            "path": paths[0] if paths else None,
            "launches_by_path": {k: v[name] for k, v in launches.items()},
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape")},
            **{k: r[k] for k in ("mean_abs_err", "trunk_tflop_s", "tflop_s", "errors",
                                 "normal_p99") if k in r},
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
