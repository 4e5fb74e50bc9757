#!/usr/bin/env python3
"""Where the forward shade spends its time on the card (one NVIDIA GPU,
sm_90a): the kernel that the training shade's forward and the render's
shade share (``csrc/shade_common.cuh``).

    python3 scripts/probe_shade_fwd.py

Builds ``hold_tpu_torch/csrc/fused_shade.cu`` six times from copies of the
sources in a temporary directory, each with one kind of work taken out of
the shade, and reads the forward kernel's time a node (10 frames x 12,544
points, seeded inputs; CUDA events, the mean of 20 calls after 3 warm-up
calls):

- ``base``: the kernel as it is;
- ``no_scratch_st``: without the sigmoids' and the features' stores to the
  device scratch;
- ``no_scratch_ld``: without their loads back (constants in their place);
- ``no_scratch``: without either, so that the scratch moves no bytes;
- ``no_act``: the trunk's softplus and sigmoid replaced by relu and a step;
- ``no_discard``: without dropping each scratch line from L2 once it has
  been read back (``discard.global.L2``), so that L2 writes the lines it
  still holds back to memory (the numbers stay right).

Each line also says whether the variant's outputs equal ``base``'s bit for
bit: every variant but ``no_discard`` computes wrong numbers, and only its
time means anything.  Nothing in the package is changed.
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

from hold_tpu_torch.models.embedders import embed_window  # noqa: E402
from hold_tpu_torch.models.mlp import (  # noqa: E402
    implicit_net_shapes, init_implicit_net, init_rendering_net, resolve_weight_norm,
)
from hold_tpu_torch.models.specs import MANO_SPECS  # noqa: E402
from hold_tpu_torch.ops import _cuda  # noqa: E402
from hold_tpu_torch.ops import fused_render as fr  # noqa: E402
from hold_tpu_torch.ops import weight_pack as wp  # noqa: E402
from hold_tpu_torch.utils.config import DEFAULT_CONFIG  # noqa: E402

# lines of shade_common.cuh, each unique in it
ST_SIG = "        sig[32 * q] = make_uint4(w[0], w[1], w[2], w[3]);"
ST_FEAT = "            feat[32 * qs] = make_uint4(w[0], w[1], w[2], w[3]);"
LD = "        for (int i = 0; i < NB; ++i) v[i] = src[32 * (q0 + i)];"
NEVER = "if (w[0] == 0x7f7f7f7fu) "  # keeps the store in the code and off the run
LD_CONST = ("        for (int i = 0; i < NB; ++i) v[i] = make_uint4(0x3f003f00u + q0 + i, "
            "0x3f003f00u, 0x3f003f00u, 0x3f003f00u);")
NO_ST = [(ST_SIG, "        " + NEVER + ST_SIG.strip()),
         (ST_FEAT, "            " + NEVER + ST_FEAT.strip())]
DISCARD = """        __syncwarp();
        if ((threadIdx.x & 7) == 0) {
#pragma unroll
            for (int i = 0; i < NB; ++i)
                asm volatile("discard.global.L2 [%0], 128;" ::"l"(src + 32 * (q0 + i)) : "memory");
        }
"""
VARIANTS = {
    "base": [],
    "no_scratch_st": NO_ST,
    "no_scratch_ld": [(LD, LD_CONST)],
    "no_scratch": [*NO_ST, (LD, LD_CONST)],
    "no_act": [
        ("    const float e = __expf(-fabsf(100.0f * a));\n"
         "    h = fmaxf(a, 0.0f) + __logf(1.0f + e) * 0.01f;\n"
         "    s = __fdividef(a >= 0.0f ? 1.0f : e, 1.0f + e);",
         "    h = fmaxf(a, 0.0f);\n    s = a >= 0.0f ? 1.0f : 0.0f;"),
    ],
    "no_discard": [(DISCARD, "")],
}


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
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    work = tempfile.mkdtemp()
    procs = []
    for name, swaps in VARIANTS.items():
        d = os.path.join(work, name)
        shutil.copytree(_cuda.SRC_DIR, d)
        path = os.path.join(d, "shade_common.cuh")
        src = open(path).read()
        for old, new in swaps:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: shade_common.cuh has changed; update {old.strip()!r}")
            src = src.replace(old, new)
        open(path, "w").write(src)
        so = os.path.join(d, "shade.so")
        procs.append((name, so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler",
             "-fPIC", "-shared", "-o", so, os.path.join(d, "fused_shade.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

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

    scratch, ctas = fr.shade_scratch(B * N, dev)
    outs = [torch.empty(s, device=dev) for s in ((B, N), (B, N, 3), (B, N, 3))]
    ins = [f32(rng.randn(B, N, 3) * 0.1), f32(np.eye(3).reshape(9) + rng.randn(B, N, 9) * 0.05),
           f32(rng.randn(B, 256) * 0.1), window, wp.tile_shade_fwd(tw, bw, cw), tw["f32"],
           cw["f32"], scratch, *outs]
    ptrs = [t.data_ptr() for t in ins]
    base = None
    try:
        for name, so, proc in procs:
            _, err = proc.communicate()
            if proc.returncode:
                print(err[-3000:], file=sys.stderr)
                return 1
            spill = [ln.split("info    :")[-1].strip() for ln in err.splitlines()
                     if "spill" in ln][-1:]
            fn = ctypes.CDLL(so).hold_fused_shade_fwd
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run():
                rc = fn(*ptrs, B, N, wp.window_multires(window), ctas,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            for _ in range(3):
                run()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                run()
            t1.record()
            torch.cuda.synchronize()
            got = [t.clone() for t in outs]
            base = got if base is None else base
            same = all(torch.equal(a, b) for a, b in zip(got, base))
            print(f"{name}: {t0.elapsed_time(t1) / 20:.4f} ms a node (B={B} N={N}, {ctas} CTAs); "
                  f"outputs equal base's: {same}; ptxas {spill}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
