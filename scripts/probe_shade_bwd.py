#!/usr/bin/env python3
"""Where the fused training shade's backward spends its time on the card (one
NVIDIA GPU, sm_90a).

    python3 scripts/probe_shade_bwd.py

Builds ``hold_tpu_torch/csrc/fused_shade.cu`` six times from copies of the
sources in a temporary directory, each with one kind of work taken out of the
per-point kernel's epilogues, and reads the three backward kernels' device
time a node (10 frames x 12,544 points, seeded inputs) from torch.profiler:

- ``base``: the kernel as it is;
- ``no_st_bf16`` / ``no_st_f32``: without the bf16 stores to the workspace (from
  the fragments and out of the A tile) / without the f32 ones;
- ``no_st_tile``: without the stores to the shared-memory A tiles;
- ``no_ld``: without the loads back from the workspace;
- ``fast_math``: the recompute's expf, log1pf and two divisions replaced by
  the hardware's approximations.

Every variant but ``base`` computes wrong numbers: only the times mean
anything.  Nothing in the package is changed.
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

from hold_tpu_torch.models.mlp import (  # noqa: E402
    implicit_net_shapes, init_implicit_net, init_rendering_net, resolve_weight_norm,
)
from hold_tpu_torch.models.specs import MANO_SPECS  # noqa: E402
from hold_tpu_torch.ops import _cuda  # noqa: E402
from hold_tpu_torch.ops import fused_query as fq  # noqa: E402
from hold_tpu_torch.ops import fused_render as fr  # noqa: E402
from hold_tpu_torch.ops import fused_shade as fs  # noqa: E402
from hold_tpu_torch.utils.config import DEFAULT_CONFIG  # noqa: E402

# lines of fused_shade.cu, each unique in it
ST2 = ("    *reinterpret_cast<__nv_bfloat162*>(buf + (size_t)row * ld + col) = "
       "__floats2bfloat162_rn(v0, v1);")
ST2F = "    *reinterpret_cast<float2*>(buf + (size_t)row * ld + col) = make_float2(v0, v1);"
ST2T = "    *reinterpret_cast<uint32_t*>(tile_w + cta::a_offset(row, col)) = pack_bf16(v0, v1);"
LD2F = "    return *reinterpret_cast<const float2*>(buf + (size_t)row * ld + col);"
LD2 = ("    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(buf + (size_t)row "
       "* ld + col));")
COPY = "        *reinterpret_cast<uint4*>(dst_w + (size_t)r * H + 8 * lane) ="
NEVER = "    if (v0 == 12345.0f) "  # keeps the store in the code and off the run
VARIANTS = {
    "base": [],
    "no_st_bf16": [(ST2, NEVER + ST2.strip()), (COPY, "        if (lane == 77) " + COPY.strip())],
    "no_st_f32": [(ST2F, NEVER + ST2F.strip())],
    "no_st_tile": [(ST2T, NEVER + ST2T.strip())],
    "no_ld": [(LD2F, "    return make_float2(0.5f + col * 1e-3f, 0.25f);"),
              (LD2, "    return make_float2(0.5f, 0.25f + col * 1e-3f);")],
    "fast_math": [
        ("                h[e] = fmaxf(a[e], 0.0f) + log1pf(ex) / 100.0f;",
         "                h[e] = fmaxf(a[e], 0.0f) + __logf(1.0f + ex) * 0.01f;"),
        ("                const float ex = expf(-fabsf(100.0f * a[e]));",
         "                const float ex = __expf(-fabsf(100.0f * a[e]));"),
        ("                s[e] = (a[e] >= 0.0f ? 1.0f : ex) / (1.0f + ex);",
         "                s[e] = __fdividef(a[e] >= 0.0f ? 1.0f : ex, 1.0f + ex);"),
    ],
}
KERNELS = ("fused_shade_bwd_kernel", "wgrad_kernel", "colsum_kernel")


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    work = tempfile.mkdtemp()
    procs = []
    for name, swaps in VARIANTS.items():
        d = os.path.join(work, name)
        shutil.copytree(_cuda.SRC_DIR, d)
        path = os.path.join(d, "fused_shade.cu")
        src = open(path).read()
        for old, new in swaps:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: fused_shade.cu has changed; update {old.strip()!r}")
            src = src.replace(old, new)
        open(path, "w").write(src)
        so = os.path.join(d, "shade.so")
        procs.append((name, so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler",
             "-fPIC", "-shared", "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

    g = torch.Generator().manual_seed(0)
    model = DEFAULT_CONFIG["model"]
    iplan = implicit_net_shapes(model["implicit_network"], MANO_SPECS)
    imp = to_device(resolve_weight_norm(init_implicit_net(g, model["implicit_network"],
                                                          MANO_SPECS)), dev)
    rend = to_device(resolve_weight_norm(init_rendering_net(g, model["rendering_network"],
                                                            MANO_SPECS)), dev)
    with torch.no_grad():
        tw = fq.pack_trunk_weights(imp, iplan)
        bw = fr.pack_trunk_transposed(imp, iplan, tw)
        cw = fr.pack_color_weights(rend, imp)
    window = fq.embed_window(iplan, None, (0, 1), dev)
    B, N = 10, 12544
    rng = np.random.RandomState(B)

    def f32(a):
        return torch.tensor(a.astype(np.float32), device=dev)

    ins = [f32(rng.randn(B, N, 3) * 0.1), f32(np.eye(3).reshape(9) + rng.randn(B, N, 9) * 0.05),
           f32(rng.randn(B, 256) * 0.1), window,
           *(f32(rng.randn(*s)) for s in ((B, N), (B, N, 3), (B, N, 3))), tw["f32"], cw["f32"],
           fs.tile_shade_bwd(tw, bw, cw)]
    cap, chunks = fs.bwd_chunks(B * N)
    lib = _cuda.lib()
    ws = [torch.empty(cap * lib.hold_fused_shade_ws_cols(0), dtype=torch.bfloat16, device=dev),
          torch.empty(cap * lib.hold_fused_shade_ws_cols(1), dtype=torch.float32, device=dev)]
    outs = [torch.zeros(s, device=dev) for s in (
        (B, N, 3), (B, N, 9), (fq.W_TOTAL,), (fq.F_TOTAL,), (fr.T_TOTAL,), (fr.C_TOTAL,),
        (fr.CB_TOTAL,), (B, 256))]
    ptrs = [t.data_ptr() for t in (*ins, *ws, *outs)]
    try:
        for name, so, proc in procs:
            _, err = proc.communicate()
            if proc.returncode:
                print(err[-3000:], file=sys.stderr)
                return 1
            fn = ctypes.CDLL(so).hold_fused_shade_bwd
            fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run():
                for c0, rows, splits in chunks:
                    rc = fn(*ptrs, B * N, N, c0, rows, cap, fq._multires(window), splits,
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
            split = dict.fromkeys(KERNELS, 0.0)
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    for k in KERNELS:
                        if k in e.name:
                            split[k] += e.time_range.elapsed_us() / 3e3
            print(f"{name}: ms a node (B={B} N={N}) "
                  + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
