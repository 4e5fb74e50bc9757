#!/usr/bin/env python3
"""What the fused query's softplus costs on the card (one NVIDIA GPU, sm_90a).

    python3 scripts/probe_query_softplus.py

Builds ``hold_tpu_torch/csrc/fused_query.cu`` five times from copies of the
sources in a temporary directory, each with another body for the trunk
epilogue's ``softplus100_fast``, and times the object query's z form at the
training slice's shape (10 frames x 128 rays x 128 samples) with CUDA events:

- ``fast``: the kernel as it is (``__expf`` / ``__logf``, ``* 0.01f``);
- ``exact``: ``expf``, ``log1pf`` and a division by 100, the form of
  ``trunk_common.cuh`` ``softplus100``;
- ``mul``: the exact form with ``* 0.01f`` for the division;
- ``exp2``: ``exp2f`` / ``__log2f`` with the constants folded;
- ``relu``: no softplus at all (wrong numbers; the trunk without its cost).

Prints each variant's registers, milliseconds a call, and its largest and
mean difference from the plain version.  Nothing in the package is changed.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hold_tpu_torch.models.embedders import embed_window  # noqa: E402
from hold_tpu_torch.models.mlp import (  # noqa: E402
    implicit_net_shapes, init_implicit_net, resolve_weight_norm,
)
from hold_tpu_torch.models.specs import OBJECT_SPECS  # noqa: E402
from hold_tpu_torch.ops import _cuda  # noqa: E402
from hold_tpu_torch.ops import fused_query as fq  # noqa: E402
from hold_tpu_torch.ops import weight_pack as wp  # noqa: E402
from hold_tpu_torch.utils.config import DEFAULT_CONFIG  # noqa: E402

FAST = "return fmaxf(x, 0.0f) + __logf(1.0f + __expf(-fabsf(100.0f * x))) * 0.01f;"
VARIANTS = {
    "fast": None,
    "exact": "return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(100.0f * x))) / 100.0f;",
    "mul": "return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(100.0f * x))) * 0.01f;",
    "exp2": "return fmaxf(x, 0.0f) + 0.0069314718f * __log2f(1.0f + "
            "exp2f(-144.26950409f * fabsf(x)));",
    "relu": "return fmaxf(x, 0.0f);",
}


def cuda_ms(fn, fill_ms: float = 100.0) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(reps):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    fn()
    return timed(min(max(3, math.ceil(fill_ms / max(timed(1), 1e-3))), 2000))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    work = tempfile.mkdtemp()
    procs = []
    for name, body in VARIANTS.items():
        d = os.path.join(work, name)
        shutil.copytree(_cuda.SRC_DIR, d)
        if body:
            path = os.path.join(d, "fused_query.cu")
            src = open(path).read()
            if FAST not in src:
                raise RuntimeError("softplus100_fast's body has changed: update FAST")
            open(path, "w").write(src.replace(FAST, body))
        so = os.path.join(d, "query.so")
        procs.append((name, so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler",
             "-fPIC", "-shared", "-o", so, os.path.join(d, "fused_query.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

    opt = DEFAULT_CONFIG["model"]["implicit_network"]
    plan = implicit_net_shapes(opt, OBJECT_SPECS)
    res = resolve_weight_norm(init_implicit_net(torch.Generator().manual_seed(6), opt,
                                                OBJECT_SPECS))
    with torch.no_grad():
        pack = wp.pack_trunk_weights(
            {"layers": [{k: v.to(dev) for k, v in l.items()} for l in res["layers"]]}, plan)
    tiled = wp.tile_trunk(pack)
    window = embed_window(plan, 900, (100, 2000), dev)
    B, P, S = 10, 128, 128
    g = torch.Generator(dev).manual_seed(0)
    dirs = torch.nn.functional.normalize(torch.randn(B * P, 3, generator=g, device=dev), dim=-1)
    cam = torch.randn(B * P, 3, generator=g, device=dev) * 0.02
    z = torch.rand(B, P, S, generator=g, device=dev).sort(-1).values * 0.3
    tf12 = torch.tensor([[1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0]], device=dev).repeat(B, 1)
    ref = fq.object_query_plain(fq.points_from_rays_z(dirs, cam, z), tf12, window, pack)
    out = torch.empty(B, P, S, device=dev)
    emb = fq._emb_scratch(B, P * S, dev)
    try:
        for name, so, proc in procs:
            _, err = proc.communicate()
            if proc.returncode:
                print(err, file=sys.stderr)
                return 1
            regs = next((ln.strip() for ln in err.splitlines()
                         if "Used" in ln and "barriers" in ln and "used 16" in ln), "")
            fn = ctypes.CDLL(so).hold_fused_object_sdf_z
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run():
                rc = fn(dirs.data_ptr(), cam.data_ptr(), z.data_ptr(), tf12.data_ptr(),
                        window.data_ptr(), tiled.data_ptr(), pack["f32"].data_ptr(),
                        emb.data_ptr(), out.data_ptr(), B, P, S, wp.window_multires(window), 0,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            d = (out.reshape(B, -1) - ref).abs()
            print(f"{name}: {cuda_ms(run):.4f} ms a call (B={B} P={P} S={S}); against plain max "
                  f"{float(d.max()):.3e} mean {float(d.mean()):.3e}; trunk kernel: {regs}",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
