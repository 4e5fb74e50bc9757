#!/usr/bin/env python3
"""Whether the fused object render's time depends on its data (one NVIDIA
GPU, sm_90a).

    python3 scripts/probe_render_data.py [--checkout DIR] [--ftz]

Times ``fused_object_render`` of the checkout at DIR (default: this one) on
one frame of 401,408 seeded points (a render chunk's size), the object's
rigid inverse the identity, so that the canonical points are the seeded
points at three scales: 0.1 (a hand's canonical extent), 1 and 10 (the
object's, whose SDF reaches 35 on the card's render chunk).  The nets are the
object node's at their initial weights from seed 0.  With ``--ftz`` the
checkout's kernels are built with ``-ftz=true`` (denormal floats flushed to
zero), into a build directory of their own, so that a gap the flag closes is
the cost of denormal operands in the kernel's exact transcendentals and
divisions.  Prints the card's name and power limit, then ms a call at each
scale (CUDA events, the mean of 20 calls after 3 warm-up calls).  Nothing in
the checkout is changed.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

SCALES = (0.1, 1.0, 10.0)
N = 401_408


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout",
                    default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--ftz", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.checkout))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from hold_tpu_torch.models.embedders import embed_window
    from hold_tpu_torch.models.holdnet import _object_render_opt
    from hold_tpu_torch.models.mlp import (
        implicit_net_shapes, init_implicit_net, init_rendering_net, resolve_weight_norm,
    )
    from hold_tpu_torch.models.specs import OBJECT_SPECS
    from hold_tpu_torch.ops import _cuda
    from hold_tpu_torch.ops import fused_render as fr
    from hold_tpu_torch.ops import weight_pack as wp
    from hold_tpu_torch.utils.config import DEFAULT_CONFIG

    if opts.ftz:
        _cuda.ARCH_FLAGS = [*_cuda.ARCH_FLAGS, "-ftz=true"]
    _cuda.BUILD_DIR = Path(tempfile.mkdtemp())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    model = DEFAULT_CONFIG["model"]
    iplan = implicit_net_shapes(model["implicit_network"], OBJECT_SPECS)

    def resolved(tree):
        if isinstance(tree, dict):
            return {k: resolved(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [resolved(v) for v in tree]
        return tree.to(dev) if isinstance(tree, torch.Tensor) else tree

    imp = resolved(resolve_weight_norm(init_implicit_net(g, model["implicit_network"],
                                                         OBJECT_SPECS)))
    rend = resolved(resolve_weight_norm(init_rendering_net(g, _object_render_opt(model),
                                                           OBJECT_SPECS)))
    with torch.no_grad():
        pack = wp.pack_trunk_weights(imp, iplan)
        packs = (embed_window(iplan, None, (0, 1), dev), pack,
                 wp.pack_trunk_transposed(imp, iplan, pack), wp.pack_color_weights(rend, imp))
        if hasattr(fr, "tile_shade_fwd"):  # the weight stream, made once as the render makes it
            packs[3]["stream"] = wp.tile_shade_fwd(*packs[1:])
    rng = np.random.RandomState(0)
    unit = torch.tensor(rng.randn(1, N, 3).astype(np.float32), device=dev)
    tf12 = torch.tensor([[1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0]], device=dev)
    fb0 = torch.tensor(rng.randn(1, 256).astype(np.float32) * 0.1, device=dev)
    _cuda.lib()
    print(f"{smi}; checkout {opts.checkout}; -ftz=true: {opts.ftz}; build "
          f"{_cuda.build_info['seconds']:.1f} s", flush=True)
    for scale in SCALES:
        pts = (unit * scale).contiguous()

        def call():
            return fr.fused_object_render(pts, tf12, *packs, fb0)

        for _ in range(3):
            sdf = call()[0]
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(20):
            call()
        t1.record()
        torch.cuda.synchronize()
        print(f"  scale {scale}: {t0.elapsed_time(t1) / 20:.4f} ms a call (N={N}); max |sdf| "
              f"{float(sdf.abs().max()):.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
