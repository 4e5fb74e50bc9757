#!/usr/bin/env python3
"""Where the fused training shade's backward spends its time on the card (one
NVIDIA GPU, sm_90a).

    python3 scripts/probe_shade_bwd.py [--checkout DIR]

Builds ``hold_tpu_torch/csrc/fused_shade.cu`` eight times from copies of the
sources in a temporary directory, each with one kind of work taken out of the
per-point kernel's epilogues, and reads the three backward kernels' device
time a node (10 frames x 12,544 points, seeded inputs) from torch.profiler:

- ``base``: the kernel as it is;
- ``no_st_bf16`` / ``no_st_f32``: without the bf16 stores to the workspace
  (the TMA stores out of the A tile and out of the bf16 staging boxes, and
  the narrow rows' stores) / without the f32 ones;
- ``no_st_tile``: without the stores to the shared-memory A tiles;
- ``no_ld``: without the loads back from the workspace;
- ``ieee_div``: the recompute's quotients by ``/`` (div.rn, with its branch
  to the slow path) in place of ``div_rn``;
- ``exact_h``: every h of the recompute by log1pf, none by the series;
- ``fast_math``: the recompute's softplus and sigmoid by the forward shade's
  approximations (``shade::softplus_sigmoid``), which move the backward past
  the limits that hold it to its plain version.

With ``--checkout DIR`` the
``fused_shade.cu`` of another checkout (its sources as they are, e.g. a ``git
archive`` of another commit in a gitignored directory) is timed too, as
``checkout``, between two runs of ``base``.  Every variant but ``base``,
``ieee_div``, ``exact_h`` and ``checkout`` computes other numbers (those
three differ at most in subnormal h): only the times mean anything.  Nothing
in the package is changed.
"""

from __future__ import annotations

import argparse
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

from hold_tpu_torch.models.embedders import embed_window  # noqa: E402
from hold_tpu_torch.models.mlp import (  # noqa: E402
    implicit_net_shapes, init_implicit_net, init_rendering_net, resolve_weight_norm,
)
from hold_tpu_torch.models.specs import MANO_SPECS  # noqa: E402
from hold_tpu_torch.ops import _cuda  # noqa: E402
from hold_tpu_torch.ops import fused_shade as fs  # noqa: E402
from hold_tpu_torch.ops import weight_pack as wp  # noqa: E402
from hold_tpu_torch.utils.config import DEFAULT_CONFIG  # noqa: E402

# lines of fused_shade.cu, each unique in it
ST2 = ("    *reinterpret_cast<__nv_bfloat162*>(buf + (size_t)row * ld + col) = "
       "__floats2bfloat162_rn(v0, v1);")
ST2F = "    *reinterpret_cast<float2*>(buf + (size_t)row * ld + col) = make_float2(v0, v1);"
ST2T = "    *reinterpret_cast<uint32_t*>(tile_w + cta::a_offset(row, col)) = pack_bf16(v0, v1);"
TMA_F32 = "        if (f32) cta::tensor_store_2d(&q.tmf, box, col, q.rf[k] + pl.rowc);"
TMA_BF16 = "        else cta::tensor_store_2d(&q.tmb, box, col, q.rb[k] + pl.rowc);"
TMA_TILE = ("            cta::tensor_store_2d(&q.tmb, tile + s * cta::A_SLAB_BYTES, 64 * s, "
            "q.rb[k] + pl.rowc);")
LD2F = "    return *reinterpret_cast<const float2*>(buf + (size_t)row * ld + col);"
LD2 = ("    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(buf + (size_t)row "
       "* ld + col));")
DIV_RN = "    return fmaf(fmaf(-y, q, x), r, q);"
SP_RN = "__device__ __forceinline__ void softplus_sigmoid_rn(float a, float& h, float& s) {"
SP_BF = "__device__ __forceinline__ bool softplus_sigmoid_bf(float a, float& h, float& s) {"
NEVER = "    if (v0 == 12345.0f) "  # keeps the store in the code and off the run
NEVER_Q = "if (q.total == -7) "
VARIANTS = {
    "base": [],
    "no_st_bf16": [(ST2, NEVER + ST2.strip()),
                   (TMA_BF16, "        else " + NEVER_Q + TMA_BF16.strip()[len("else "):]),
                   (TMA_TILE, "            " + NEVER_Q + TMA_TILE.strip())],
    "no_st_f32": [(ST2F, NEVER + ST2F.strip()),
                  (TMA_F32, "        if (f32) { " + NEVER_Q + TMA_F32.strip()[len("if (f32) "):]
                   + " }")],
    "no_st_tile": [(ST2T, NEVER + ST2T.strip())],
    "no_ld": [(LD2F, "    return make_float2(0.5f + col * 1e-3f, 0.25f);"),
              (LD2, "    return make_float2(0.5f, 0.25f + col * 1e-3f);")],
    "ieee_div": [(DIV_RN, "    return x / y;")],
    "exact_h": [(SP_BF, SP_BF + "\n    softplus_sigmoid_rn(a, h, s);\n    return true;")],
    "fast_math": [(SP_RN, SP_RN + "\n    shade::softplus_sigmoid(a, h, s);\n    return;"),
                  (SP_BF, SP_BF + "\n    shade::softplus_sigmoid(a, h, s);\n    return true;")],
}
# a kernel's time goes to the first of these its name holds
KERNELS = ("fused_shade_bwd_kernel_sums", "fused_shade_bwd_kernel", "wgrad_kernel")


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _build(name: str, src_dir: str, work: str, swaps: list):
    """nvcc of a copy of ``src_dir`` with ``swaps`` made in its fused_shade.cu,
    started: (name, library path, process)."""
    d = os.path.join(work, name)
    shutil.copytree(src_dir, d)
    path = os.path.join(d, "fused_shade.cu")
    src = open(path).read()
    for old, new in swaps:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: fused_shade.cu has changed; update {old.strip()!r}")
        src = src.replace(old, new)
    open(path, "w").write(src)
    so = os.path.join(d, "shade.so")
    return name, so, subprocess.Popen(
        [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler",
         "-fPIC", "-shared", "-o", so, path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _rows_kernel_ptxas(err: str) -> str:
    """ptxas's registers and spills of the rows kernel, from nvcc's output."""
    lines = err.splitlines()
    for i, line in enumerate(lines):
        if ("Compiling entry function" in line and "fused_shade_bwd_kernel" in line
                and "fused_shade_bwd_kernel_sums" not in line):
            return " | ".join(x.split("info    : ")[-1].strip() for x in lines[i + 1:i + 4])
    return ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=None,
                    help="another checkout whose fused_shade.cu is timed as 'checkout'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    work = tempfile.mkdtemp()
    builds = [_build(name, str(_cuda.SRC_DIR), work, swaps) for name, swaps in VARIANTS.items()]
    order = list(VARIANTS)
    if args.checkout:
        builds.append(_build("checkout", os.path.join(args.checkout, "hold_tpu_torch", "csrc"),
                             work, []))
        order = ["base", "checkout", *order[1:], "checkout", "base"]

    g = torch.Generator().manual_seed(0)
    model = DEFAULT_CONFIG["model"]
    iplan = implicit_net_shapes(model["implicit_network"], MANO_SPECS)
    imp = to_device(resolve_weight_norm(init_implicit_net(g, model["implicit_network"],
                                                          MANO_SPECS)), dev)
    rend = to_device(resolve_weight_norm(init_rendering_net(g, model["rendering_network"],
                                                            MANO_SPECS)), dev)
    with torch.no_grad():
        tw = wp.pack_trunk_weights(imp, iplan)
        bw = wp.pack_trunk_transposed(imp, iplan, tw)
        cw = wp.pack_color_weights(rend, imp)
    window = embed_window(iplan, None, (0, 1), dev)
    B, N = 10, 12544
    rng = np.random.RandomState(B)

    def f32(a):
        return torch.tensor(a.astype(np.float32), device=dev)

    ins = [f32(rng.randn(B, N, 3) * 0.1), f32(np.eye(3).reshape(9) + rng.randn(B, N, 9) * 0.05),
           f32(rng.randn(B, 256) * 0.1), window,
           *(f32(rng.randn(*s)) for s in ((B, N), (B, N, 3), (B, N, 3))), tw["f32"], cw["f32"],
           wp.tile_shade_bwd(tw, bw, cw)]
    cap, chunks = fs.bwd_chunks(B * N)
    lib = _cuda.lib()
    kmax = fs.frame_slots(B, N)
    ws = [torch.empty(cap * lib.hold_fused_shade_ws_cols(0), dtype=torch.bfloat16, device=dev),
          torch.empty(cap * lib.hold_fused_shade_ws_cols(1), dtype=torch.float32, device=dev)]
    outs = [torch.zeros(s, device=dev) for s in (
        (B, N, 3), (B, N, 9), (wp.W_TOTAL,), (wp.F_TOTAL,), (wp.T_TOTAL,), (wp.C_TOTAL,),
        (wp.CB_TOTAL,), (B, 256))]
    part = torch.empty(cap // fs.BWD_ROWS * lib.hold_fused_shade_part_cols(kmax), device=dev)
    ptrs = [t.data_ptr() for t in (*ins, *ws, *outs)]
    fns = {}
    try:
        for name, so, proc in builds:
            _, err = proc.communicate()
            if proc.returncode:
                print(err[-3000:], file=sys.stderr)
                return 1
            print(f"{name}: fused_shade_bwd_kernel {_rows_kernel_ptxas(err)}", flush=True)
            lib_v = ctypes.CDLL(so)
            fn = lib_v.hold_fused_shade_bwd
            fn.restype = ctypes.c_int
            if hasattr(lib_v, "hold_fused_shade_part_cols"):
                fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
                fns[name] = (fn, [*ptrs, part.data_ptr()], [kmax])
            else:  # a checkout from before the column sums moved into the rows kernel
                fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
                fns[name] = (fn, ptrs, [])
        for name in order:
            fn, p, extra = fns[name]

            def run():
                for c0, rows, splits in chunks:
                    rc = fn(*p, B * N, N, c0, rows, cap, wp.window_multires(window), splits, *extra,
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
                    k = next((k for k in KERNELS if k in e.name), None)
                    if k:
                        split[k] += e.time_range.elapsed_us() / 3e3
            print(f"{name}: ms a node (B={B} N={N}) "
                  + ", ".join(f"{k} {v:.3f}" for k, v in split.items() if v)
                  + f", total {sum(split.values()):.3f}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
