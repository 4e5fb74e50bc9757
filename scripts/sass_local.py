#!/usr/bin/env python3
"""Where the kernels of a CUDA source touch local memory (a machine with the
CUDA toolkit, nvcc and nvdisasm; no GPU needed).

    python3 scripts/sass_local.py hold_tpu_torch/csrc/fused_render.cu [more.cu ...]

Compiles each source for sm_90a with ops/_cuda.py's flags plus -lineinfo to
a cubin, disassembles it with ``nvdisasm -g`` and counts, kernel by kernel,
the local loads (LDL) and stores (STL) by the source line that the
disassembly names for them, with that line's text.  Then prints ptxas's
stack and spill lines.  Local memory is both a register spill and an array
that the code indexes or takes the address of (a small per-thread array, the
slow-path argument reduction of sinf and cosf, which runs only for
|x| > 105,615): ptxas's "spill stores" count the first kind alone.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def tally(sass: str) -> dict:
    """{kernel: Counter({(op, file, line): count})} from ``nvdisasm -g`` text."""
    out: dict = {}
    kernel, where = None, ("?", 0)
    for line in sass.splitlines():
        m = re.match(r"\s*\.section\s+\.text\.(\S+?),", line)
        if m:
            kernel = m.group(1)
            out[kernel] = Counter()
            continue
        m = re.search(r'//## File "([^"]+)", line (\d+)', line)
        if m:
            where = (m.group(1), int(m.group(2)))
            continue
        m = re.search(r"\b(STL|LDL)(\.\w+)*\s", line)
        if m and kernel:
            out[kernel][(m.group(1), *where)] += 1
    return out


def label(mangled: str) -> str:
    """'render_warp_kernel ILb1E' from a mangled kernel name."""
    m = re.search(r"\d+([a-z_]+_kernel)(I\w+?E)?E", mangled)
    return f"{m.group(1)} {m.group(2) or ''}".strip() if m else mangled


def source_line(path: str, n: int) -> str:
    try:
        with open(path) as f:
            return f.read().splitlines()[n - 1].strip()
    except (OSError, IndexError):
        return ""


def main(sources: list) -> int:
    from hold_tpu_torch.ops import _cuda

    work = tempfile.mkdtemp()
    for src in sources:
        cubin = os.path.join(work, os.path.basename(src) + ".cubin")
        built = subprocess.run(
            [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
             "-cubin", "-o", cubin, src], capture_output=True, text=True)
        if built.returncode:
            print(built.stderr[-3000:], file=sys.stderr)
            return 1
        nvdisasm = os.path.join(os.path.dirname(_cuda._nvcc()), "nvdisasm")
        sass = subprocess.run([nvdisasm, "-g", "-c", cubin], capture_output=True, text=True,
                              check=True).stdout
        print(f"== {src}")
        for kernel, counts in tally(sass).items():
            if not counts:
                continue
            print(f"  {label(kernel)}: {sum(counts.values())} local accesses")
            for (op, path, n), c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
                print(f"    {op} x{c:<4d} {os.path.basename(path)}:{n}  "
                      f"{source_line(path, n)[:90]}")
        for line in built.stderr.splitlines():
            if "Compiling entry" in line or "spill" in line:
                print("  ptxas: " + line.split("info    :")[-1].strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
