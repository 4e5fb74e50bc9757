#!/usr/bin/env python3
"""Where the neighbour search spends its time on the card (one NVIDIA GPU,
sm_90a): the search of ``csrc/knn_common.cuh`` that the KNN kernels, the
fused query's and the fused render's hand warp steps share.

    python3 scripts/probe_knn.py
    python3 scripts/probe_knn.py --wrappers [--package DIR]

Builds ``hold_tpu_torch/csrc/knn.cu`` once a variant from copies of the
sources in a temporary directory, each variant with one kind of work taken
out of the search or one choice changed, and times each (CUDA events, the
mean of 20 calls after 3 warm-up calls) at the shapes and on the points of
``chip_smoke.py``'s phase 3, with the hand's vertices in their tile order:

- row 2: ``knn_warp_fwd_kernel<true>`` on one training step's grad-stage
  points (10 frames x 12,544);
- row 8: the render warp step's two searches, ``knn_warp_fwd_kernel<true>``
  on one render chunk's points (4,096 rays x 98 samples) against the posed
  vertices, then ``knn_jinv_fwd_kernel`` at their x_c against the canonical
  ones: the render warp kernel runs the same two searches.

The variants:

- ``base``: the search as it is;
- ``no_order``: the vertices searched in their given order (no tile order);
- ``no_cull``: no tile is ever culled (every warp visits every tile);
- ``inline_insert``: the candidate queue replaced by an insertion into the
  sorted list at each candidate, lane by lane;
- ``chained_insert``: the list's insertion as a shift register, each of its
  16 steps waiting on the one before (the search before this design);
- ``warp_first_tile``: every lane's list filled first from one tile, the
  warp's nearest, not from the lane's own nearest tile;
- ``tie_sweep``: every lane takes the tie sweep (the second sweep over the
  tiles near it) in place of blending its list;
- ``no_sweep``: no vertex searched (the list stays empty and is blended as
  if full): what staging, the tile order, the blend, the skinning and the
  stores cost;
- ``tile_merge``: the queues merged also before each tile's cull test, not
  only when one is nearly full (the test then reads a newer K-th value);
- ``qstep_8``: the queues looked at every 8 vertices, not 4;
- ``qlen_32``: queues of 32 entries, not 16;
- ``min_blocks_5``: the KNN kernels' launch bounds ask for 5 resident CTAs
  of 128 threads an SM (at most 102 registers a thread), as
  ``knn_blend_kernel``'s do.

With ``--wrappers`` it builds nothing of its own: it times the package's
public wrappers on the same inputs, row 2's forward and row 4 on its three
buffers (the hand's subdivided mesh, the object's buffer with the hand's
778 vertices scaled by 2 in its first rows and far padding after them, the
all-padding empty state), each with the vertex order the package keeps, if
it keeps one; and rows 2-3's backward (the closed-form VJPs of row 2's
forward and of row 3's at row 2's x_c) by wrapper time (CUDA events around
the call) and by device time by kernel (torch.profiler).  ``--package DIR``
takes ``hold_tpu_torch`` from the checkout DIR (an earlier tree, to time
both in one run on one card).

Each line says whether the variant's outputs equal ``base``'s bit for bit,
the culled share and tie lanes, and ptxas's registers and spills of the
variant's kernels.  A lane that takes the tie sweep sums its set in slot
order, one that blends its list in d2 order: a variant that moves lanes
into or out of the tie sweep, or reorders the slots, differs from ``base``
by rounding (``tie_sweep``, ``inline_insert``, ``no_order``); ``no_sweep``
computes wrong numbers, and only its time means anything.  Nothing in the
package is changed.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
if "--package" in sys.argv:  # hold_tpu_torch from another checkout
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--package") + 1]))

import chip_smoke  # noqa: E402
from hold_tpu_torch.ops import _cuda  # noqa: E402

# (file, text, replacement): each text unique in its file unless marked "all"
CULL = ("knn_common.cuh", "    return L > thr + MARGIN * ((lo.w + psq) + thr);")
PUSH = ("knn_common.cuh", """                const bool push = t != mine && c + u < n && d2[u] <= thr;
                if (push) q[32 * cnt] = make_float2(d2[u], __int_as_float(s0 + c + u));
                cnt += push;""")
INLINE = """                if (t != mine && c + u < n && d2[u] <= thr) {
                    list_insert(top, slot, d2[u], s0 + c + u, tie);
                    thr = kth_of(top, K);
                }"""
SHIFT = ("knn_common.cuh", """#pragma unroll
    for (int k = KMAX - 1; k > 0; --k) {
        const bool here = x < top[k], before = x < top[k - 1];
        top[k] = before ? top[k - 1] : (here ? x : top[k]);
        slot[k] = before ? slot[k - 1] : (here ? s : slot[k]);
    }
    const bool first = x < top[0];
    top[0] = first ? x : top[0];
    slot[0] = first ? s : slot[0];""")
CHAIN = """#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        const float t = top[k];
        const int ts = slot[k];
        const bool lt = x < t;
        top[k] = lt ? x : t;
        slot[k] = lt ? s : ts;
        x = lt ? t : x;
        s = lt ? ts : s;
    }"""
TIE = ("knn_common.cuh",
       "    tie |= !(thr < BIG);  // fewer than K distinct values: every vertex is in the set")
FIRST = ("knn_common.cuh", "        for (int j = 0; j < TILE_V; ++j) {")
SWEEP = ("knn_common.cuh", "    for (int i = 0; i < order.nt; ++i) {")
OWN = ("knn_common.cuh", "            mine = k < best ? t : mine;")
BOUNDS = ("knn.cu", "__launch_bounds__(BLOCK)\nknn_")
VARIANTS = {
    "base": [],
    "no_order": [],
    "no_cull": [(*CULL, "    return false;")],
    "inline_insert": [(*PUSH, INLINE)],
    "chained_insert": [(*SHIFT, CHAIN)],
    "tie_sweep": [(*TIE, "    tie = true;")],
    "no_sweep": [(*FIRST, "        for (int j = 0; j < 0; ++j) {"),
                 (*SWEEP, "    for (int i = 0; i < 0; ++i) {"), (*TIE, "    tie = false;")],
    "warp_first_tile": [(*OWN, "            mine = tile_at(order, 0);")],
    "tile_merge": [("knn_common.cuh", "        // a lane skips its own tile, already in its list",
                    """        if (__any_sync(FULL, cnt > 0)) {
            pushed += cnt;
            rounds += merge_queue(q, cnt, top, slot, tie);
            thr = kth_of(top, K);
        }""")],
    "qstep_8": [("knn_common.cuh", "constexpr int QSTEP = 4;", "constexpr int QSTEP = 8;")],
    "qlen_32": [("knn_common.cuh", "constexpr int QLEN = 16;", "constexpr int QLEN = 32;")],
    "min_blocks_5": [(*BOUNDS, "__launch_bounds__(BLOCK, 5)\nknn_", "all")],
}
WARP_FWD = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 2
JINV_FWD = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


def inputs(torch, dev) -> dict:
    """Row 2's and row 8's hand frames and points, made as chip_smoke.py's
    phase 3 makes them (the synthetic sequence, random nets from seed 0)."""
    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.data.synthetic import generate_sequence
    from hold_tpu_torch.models.holdnet import (
        _rays, build_scene, empty_object_mesh_state, init_scene_params, sample_all_z,
    )
    from hold_tpu_torch.models.nodes import _mano_pose
    from hold_tpu_torch.train import batch_to_device

    built = generate_sequence(os.path.join(ROOT, "logs", "probe_knn", "data", "synthetic"),
                              chip_smoke.FRAMES, chip_smoke.IMG_HW)
    seq = SequenceData(built["images"], built["masks"], built["data"],
                       num_sample=chip_smoke.RAYS_PER_FRAME)
    args, cfg = chip_smoke.slice_config()
    scene = build_scene(dict(cfg["model"]), dict(args), seq.scene_data(), dev)
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    server = scene.servers["right"]
    plans = scene.plans["right"]
    out = {"order": getattr(plans, "tile_order", None)}
    with torch.no_grad():
        batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(0),
                                                       chip_smoke.BATCH_SIZE, 1,
                                                       chip_smoke.RAYS_PER_FRAME), dev)
        B = batch["uv"].shape[0]
        srv, _ = _mano_pose(params["right"], server, batch, 0)
        ray_dirs, cam_loc = _rays(batch)
        z = sample_all_z(params, scene, batch, torch.Generator(dev).manual_seed(0), 0, 0)["right"]
        out["row 2"] = ((cam_loc[:, None] + z[..., None] * ray_dirs[:, None]).reshape(B, -1, 3),
                        srv.verts, server.verts_c.expand(B, -1, -1),
                        server.skin_weights_c.expand(B, -1, -1), srv.tfs)
        # row 4's buffers, as phase 3 makes them
        bound_v = empty_object_mesh_state(dev)["bound_centers"]
        real = bound_v.clone()
        real[:server.verts_c.shape[1]] = server.verts_c[0] * 2.0
        out["row 4"] = {"hand": ((scene.sub_ops["right"][0] @ srv.v_posed[0]).contiguous(),
                                 getattr(plans, "sub_tile_order", None)),
                        "object": (real, None), "empty object": (bound_v, None)}
        batch, _ = chip_smoke.render_batch(torch, seq, dev, chip_smoke.PIXEL_PER_BATCH)
        ray_dirs, cam_loc = _rays(batch)
        z = sample_all_z(params, scene, batch, None, None, None)["right"]
        srv, _ = _mano_pose(params["right"], server, batch, None)
        out["row 8"] = ((cam_loc[:, None] + z[..., None] * ray_dirs[:, None]).reshape(1, -1, 3),
                        srv.verts, server.verts_c, server.skin_weights_c, srv.tfs)
    return {k: tuple(t.contiguous() for t in v) if isinstance(v, tuple) else v
            for k, v in out.items()}


def wrapper_times(dev) -> int:
    """--wrappers: row 2's forward and row 4 on its three buffers through the
    package's public wrappers, CUDA events over 100 ms of launches
    (chip_smoke.cuda_ms); rows 2-3's backward also by device time."""
    from hold_tpu_torch.ops import knn, point_mesh

    data = inputs(torch, dev)
    pts, verts, _, skin, tfs = data["row 2"]

    def kw(order):
        return {} if order is None else {"order": order}

    with torch.no_grad():
        def row2():
            return knn.knn_inverse_warp_diff(pts, verts, skin, tfs, **kw(data["order"]))

        cano = row2()[0].reshape(-1, 3).contiguous()
        print(f"  {knn.__file__}", flush=True)
        print(f"  row 2 fwd (B={pts.shape[0]} P={pts.shape[1]}): "
              f"{chip_smoke.cuda_ms(torch, row2):.4f} ms", flush=True)
        for label, (vv, order) in data["row 4"].items():
            ms = chip_smoke.cuda_ms(
                torch, lambda: point_mesh.min_vertex_dist_fast(cano, vv, **kw(order)))
            print(f"  row 4 {label} (P={cano.shape[0]} V={vv.shape[0]}): {ms:.4f} ms",
                  flush=True)

        gen = torch.Generator(dev).manual_seed(1)
        xc, _, inv, wb = knn._warp_fwd_cuda(pts, verts, skin, tfs, 15, 0.1, True,
                                            "knn_inverse_warp_diff.fwd", data["order"])
        inv_j, wb_j = knn._jinv_fwd_cuda(xc, data["row 2"][2], skin, tfs, 15, data["order"])
        g = torch.randn(pts.shape, generator=gen, device=dev)
        gj = torch.randn(pts.shape[:2] + (9,), generator=gen, device=dev)
        keys = ("knn_warp_bwd_kernel", "knn_jinv_bwd_kernel", "knn_tfs_bwd_kernel",
                "knn_tfs_bwd_final_kernel")
        for label, fn in (("row 2 bwd", lambda: knn._warp_bwd_cuda(g, inv, xc, wb)),
                          ("row 3 bwd", lambda: knn._jinv_bwd_cuda(gj, inv_j, wb_j))):
            wrapper = chip_smoke.cuda_ms(torch, fn)
            split = chip_smoke.kernel_split(torch, label, fn, keys)
            device = f"{sum(split.values()):.4f} ms" if split else "not measured"
            print(f"  {label} (B={pts.shape[0]} P={pts.shape[1]}): wrapper {wrapper:.4f} ms, "
                  f"device {device}", flush=True)
    return 0


def ptxas_lines(err: str) -> list:
    kernel, out = "?", []
    for line in err.splitlines():
        if "Compiling entry function" in line:
            kernel = chip_smoke.kernel_label(line)
        elif "registers" in line or "spill" in line:
            out.append(f"{kernel}: {line.split('info    :')[-1].strip()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if "--wrappers" in sys.argv:
        return wrapper_times(dev)
    work = tempfile.mkdtemp()
    procs = []
    for name, swaps in VARIANTS.items():
        d = os.path.join(work, name)
        shutil.copytree(_cuda.SRC_DIR, d)
        for fname, old, new, *every in swaps:
            path = os.path.join(d, fname)
            src = open(path).read()
            if src.count(old) < 1 or (not every and src.count(old) != 1):
                raise RuntimeError(f"{name}: {fname} has changed; update {old.strip()!r}")
            open(path, "w").write(src.replace(old, new))
        so = os.path.join(d, "knn.so")
        procs.append((name, so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler",
             "-fPIC", "-shared", "-o", so, os.path.join(d, "knn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

    data = inputs(torch, dev)
    order = data["order"]
    shapes = {}
    for row in ("row 2", "row 8"):
        pts, verts, verts_c, skin, tfs = data[row]
        B, P = pts.shape[:2]
        V, J = verts.shape[1], skin.shape[2]
        outs = [torch.empty(s, device=dev) for s in ((B, P, 3), (B, P), (B, P, 9), (B, P, J),
                                                     (B, P, 9), (B, P, J))]
        outs[1] = torch.empty((B, P), dtype=torch.bool, device=dev)
        shapes[row] = (pts, verts, verts_c, skin, tfs, B, P, V, J, outs)
    base = {}
    try:
        for name, so, proc in procs:
            _, err = proc.communicate()
            if proc.returncode:
                print(err[-3000:], file=sys.stderr)
                return 1
            lib = ctypes.CDLL(so)
            lib.hold_knn_warp_fwd.argtypes = WARP_FWD
            lib.hold_knn_jinv_fwd.argtypes = JINV_FWD
            lib.hold_knn_warp_fwd.restype = lib.hold_knn_jinv_fwd.restype = ctypes.c_int
            for row, (pts, verts, verts_c, skin, tfs, B, P, V, J, outs) in shapes.items():
                stream = torch.cuda.current_stream().cuda_stream
                given = torch.arange(V, dtype=torch.int32, device=dev)
                order_ptr = (given if name == "no_order" else order).data_ptr()

                def run(stats=None):
                    rc = lib.hold_knn_warp_fwd(
                        pts.data_ptr(), verts.data_ptr(), skin.data_ptr(), tfs.data_ptr(),
                        order_ptr, *(t.data_ptr() for t in outs[:4]), B, P, V, J, 15,
                        0.1, stats, stream)
                    if row == "row 8" and rc == 0:  # the second search, at x_c
                        rc = lib.hold_knn_jinv_fwd(
                            outs[0].data_ptr(), verts_c.data_ptr(), skin.data_ptr(),
                            tfs.data_ptr(), order_ptr, outs[4].data_ptr(),
                            outs[5].data_ptr(), B, P, V, J, 15, stats, stream)
                    if rc:
                        raise RuntimeError(f"{name} {row}: CUDA error {rc}")

                for _ in range(3):
                    run()
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(20):
                    run()
                t1.record()
                torch.cuda.synchronize()
                got = [t.clone() for t in outs]
                counts = torch.zeros(6, dtype=torch.int64, device=dev)
                run(counts.data_ptr())
                lanes, tie, vis, cul, rounds, inserts = counts.tolist()
                ref = base.setdefault(row, got)
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
                close = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
                print(f"{name} {row} (B={B} P={P} V={V}): {t0.elapsed_time(t1) / 20:.4f} ms; "
                      f"outputs equal base's: {same} (max |d| {close:.2e}); "
                      f"{cul / max(vis + cul, 1):.4f} of {vis + cul} warp-tiles culled, {tie} of "
                      f"{lanes} lanes in the tie sweep, {inserts / lanes:.1f} inserts a lane in "
                      f"{32 * rounds / lanes:.1f} rounds a warp", flush=True)
            for line in ptxas_lines(err):
                if "knn_warp_fwd" in line or "knn_jinv_fwd" in line or "knn_blend" in line:
                    print(f"  {name} ptxas {line}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
