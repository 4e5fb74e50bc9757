#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hold_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. Environment: versions, the card's name and power limit, TF32 off.
2. Build: compile hold_tpu_torch/csrc/*.cu for sm_90a (nvcc, first use).
3. Kernel checks: each hand-written kernel against its plain PyTorch
   version on the card, at the shapes one full-width training step gives
   it, with the tolerance stated; kernel and plain times from CUDA events.
4. Agreement: one grad-stage loss and its parameter gradients on a small
   batch, kernels on the card against the plain path on the CPU.
5. The slice: ``hold_tpu_torch.train.run_training`` for a few steps on the
   synthetic sequence (12 frames, 240x320) at full width, 10 frames x 128
   rays = 1280 rays per step, with every kernel's launch counter set to 0
   just before; every loss must be finite and every kernel launched.

The last three lines of standard output are the card's name and power
limit, one JSON object describing the kernels, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory that does not hold the hold_tpu_torch package, it exits non-zero
and prints no result.
"""

from __future__ import annotations

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
SOURCES = {"knn": "hold_tpu_torch/csrc/knn.cu", "pm": "hold_tpu_torch/csrc/point_mesh.cu"}
# kernel name -> (source, TPU kernel it replaces: file:line of the pallas_call)
KERNELS = {
    "knn_inverse_warp": ("knn", "hold_tpu/ops/knn.py:416"),
    "knn_inverse_warp_diff.fwd": ("knn", "hold_tpu/ops/knn.py:547"),
    "knn_inverse_warp_diff.bwd": ("knn", "hold_tpu/ops/knn.py:581"),
    "knn_jacobian_inverse.fwd": ("knn", "hold_tpu/ops/knn.py:737"),
    "knn_jacobian_inverse.bwd": ("knn", "hold_tpu/ops/knn.py:781"),
    "min_vertex_dist": ("pm", "hold_tpu/ops/point_mesh.py:228"),
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` launches (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


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
    from hold_tpu_torch.models.nodes import _mano_pose
    from hold_tpu_torch.ops import knn, point_mesh
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
    z = sample_all_z(params, scene, batch, torch.Generator(dev).manual_seed(0), 0, 0)["right"]
    pts_g = (cam_loc[:, None] + z[..., None] * ray_dirs[:, None]).reshape(B, -1, 3).contiguous()
    rng = torch.Generator(dev).manual_seed(1)
    results = {}

    def record(name, err, ms, plain_ms, shape):
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": shape}
        print(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)

    # 1: sampler warp, one error-bound round of 128 samples on 1280 rays
    got_x, got_o = knn.knn_inverse_warp(pts_s, verts, skin, tfs)
    ref_x, ref_o = knn.inverse_warp_plain(pts_s, verts, skin, tfs)
    err = check_close("knn_inverse_warp x_c", got_x, ref_x, 1e-5, 1e-5)
    if not torch.equal(got_o, ref_o):
        raise AssertionError("knn_inverse_warp: outlier mask differs")
    record("knn_inverse_warp", err,
           cuda_ms(torch, lambda: knn.knn_inverse_warp(pts_s, verts, skin, tfs), 20),
           cuda_ms(torch, lambda: knn.inverse_warp_plain(pts_s, verts, skin, tfs), 3),
           f"B={B} P={pts_s.shape[1]} V={verts.shape[1]}")

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
                                                     "knn_inverse_warp_diff.fwd"), 20),
           cuda_ms(torch, lambda: knn.inverse_warp_plain(pts_g, verts, skin, tfs), 3), shape)
    _, _, inv, wb = knn._warp_fwd_cuda(pts_g, verts, skin, tfs, 15, 0.1, True,
                                       "knn_inverse_warp_diff.fwd")
    record("knn_inverse_warp_diff.bwd", max(err_p, err_t),
           cuda_ms(torch, lambda: knn._warp_bwd_cuda(g, inv, got_x.detach(), wb), 20),
           cuda_ms(torch, lambda: torch.autograd.grad(ref_x, (pts_r, tfs_r), g,
                                                      retain_graph=True), 3), shape)

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
           cuda_ms(torch, lambda: knn._jinv_fwd_cuda(xc, verts_c, skin, tfs, 15), 20),
           cuda_ms(torch, lambda: knn.jacobian_inverse_plain(xc, verts_c, skin, tfs), 3), shape)
    inv_j, wb_j = knn._jinv_fwd_cuda(xc, verts_c, skin, tfs, 15)
    record("knn_jacobian_inverse.bwd", err_t,
           cuda_ms(torch, lambda: knn._jinv_bwd_cuda(gj, inv_j, wb_j), 20),
           cuda_ms(torch, lambda: torch.autograd.grad(ref_j, tfs_r, gj, retain_graph=True), 3),
           shape)

    # 4: min vertex distance, hand (subdivided mesh) and object (far-padded
    # empty mesh state with real vertices in the first rows)
    cano = xc.reshape(-1, 3)
    M_sub = scene.sub_ops["right"][0]
    v_div = (M_sub @ srv_out.v_posed[0]).detach().contiguous()
    bound = empty_object_mesh_state(dev)["bound_centers"].clone()
    n_obj = server.verts_c.shape[1]
    bound[:n_obj] = server.verts_c[0] * 2.0
    errs = []
    for label, vv in (("hand", v_div), ("object", bound)):
        got = point_mesh.min_vertex_dist_fast(cano, vv)
        ref = point_mesh.min_vertex_dist(cano, vv)
        errs.append(check_close(f"min_vertex_dist {label} (V={vv.shape[0]})", got, ref, 1e-5, 1e-4))
    record("min_vertex_dist", max(errs),
           cuda_ms(torch, lambda: point_mesh.min_vertex_dist_fast(cano, bound), 20),
           cuda_ms(torch, lambda: point_mesh.min_vertex_dist(cano, bound), 3),
           f"P={cano.shape[0]} V={bound.shape[0]}")
    return results


def agreement_check(torch, seq, args, cfg, dev) -> None:
    """Phase 4: grad-stage loss and gradients, card kernels vs CPU plain path."""
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
    losses, grads = {}, {}
    params0 = init_scene_params(torch.Generator().manual_seed(3),
                                build_scene(opt_model, dict(args), seq.scene_data(), "cpu"),
                                seq.scene_data())
    scene_cpu = build_scene(opt_model, dict(args), seq.scene_data(), "cpu")
    draws_cpu = sample_step_draws(scene_cpu, 2, 16, torch.Generator().manual_seed(4))
    z_vals = None
    for device in (dev, torch.device("cpu")):
        scene = build_scene(opt_model, dict(args), seq.scene_data(), device)
        params = leaf_params(params0, device)
        batch = batch_to_device(batch_np, device)
        if z_vals is None:  # the card's sampler places the samples for both
            z_vals = sample_all_z(params, scene, batch, None, step, epoch)
        z = {k: v.to(device) for k, v in z_vals.items()}
        draws = {k: (tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device))
                 for k, v in draws_cpu.items()}
        out = holdnet_forward(params, scene, batch, empty_object_mesh_state(device), draws,
                              step, epoch, z_vals_dict=z)
        loss = compute_losses(batch, out, scene.node_ids, step)
        flat = flatten_params(params)
        names = [k for k, t in flat.items() if t.requires_grad]
        g = torch.autograd.grad(loss["loss"], [flat[k] for k in names], allow_unused=True)
        losses[device.type] = {k: float(v.detach()) for k, v in loss.items()}
        grads[device.type] = {k: (torch.zeros_like(flat[k]) if gi is None else gi).cpu()
                              for k, gi in zip(names, g)}
    for k, v in losses["cpu"].items():
        got = losses["cuda"][k]
        print(f"  {k}: card {got:.6f} cpu {v:.6f}", flush=True)
        if not (math.isfinite(got) and abs(got - v) <= 1e-4 * abs(v) + 1e-5):
            raise AssertionError(f"{k}: card and CPU disagree")
    bad = []
    for k, ref in grads["cpu"].items():
        scale = float(ref.abs().max())
        if max_err(grads["cuda"][k], ref) > 2e-4 * scale + 2e-4:
            bad.append(k)
    print(f"  {len(grads['cpu'])} gradient tensors, tolerance 2e-4*max|ref| + 2e-4: "
          f"{len(bad)} outside", flush=True)
    if bad:
        raise AssertionError(f"gradients disagree: {bad[:8]}")


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
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.data.synthetic import generate_sequence

    built = generate_sequence(None, FRAMES, IMG_HW)
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=RAYS_PER_FRAME)
    args, cfg = slice_config()

    phase("3 kernel checks")
    results = kernel_checks(torch, seq, args, cfg, dev)

    phase("4 card vs CPU agreement on a small batch")
    agreement_check(torch, seq, args, cfg, dev)

    phase(f"5 the slice: run_training, {STEPS} steps")
    from hold_tpu_torch.ops import knn, point_mesh
    from hold_tpu_torch.train import run_training

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn.reset_launch_counts()
    point_mesh.reset_launch_counts()
    _, scene, _, tracker, timer = run_training(args, cfg, seq=seq, max_steps=STEPS, device=dev)
    torch.cuda.synchronize()
    launches = {**knn.LAUNCHES, **point_mesh.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(tracker.log_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if len(records) != STEPS:
        raise AssertionError(f"expected {STEPS} metric records, got {len(records)}")
    for rec in records:
        bad = {k: v for k, v in rec.items() if k.startswith("loss") and not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite losses at step {rec['step']}: {bad}")
        print(f"  step {rec['step']}: loss {rec['loss']:.5f} rgb {rec['loss/rgb']:.5f} "
              f"psnr {rec['psnr']:.3f}")
    print(f"  launches in the slice: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the slice: {missing}")
    summ = timer.summary()
    rays = BATCH_SIZE * 2 * RAYS_PER_FRAME
    step_s = summ["sampler"] + summ["grad"] + summ["data"]
    print(f"  sampler_ms {summ['sampler'] * 1e3:.3f}")
    print(f"  grad_ms {summ['grad'] * 1e3:.3f}")
    print(f"  data_ms {summ['data'] * 1e3:.3f}")
    print(f"  rays_per_s {rays / step_s:.1f} ({rays} rays per step, steps 1..{STEPS - 1})")
    print(f"  max_memory_allocated_bytes {peak} ({peak / 2**30:.3f} GiB)")
    print(f"  total {time.perf_counter() - t_all:.1f} s")

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[src], "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "shape": r["shape"],
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
