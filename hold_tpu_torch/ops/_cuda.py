"""Build and load the package's CUDA kernels (``hold_tpu_torch/csrc/*.cu``).

The sources have a plain C interface, so they compile with ``nvcc`` alone
(seconds, no PyTorch headers), one process per source in parallel, into one
shared library that ``ctypes`` loads.  The build happens at the first kernel
launch, into ``hold_tpu_torch/_build/`` under a name keyed by the hash of the
sources and their headers, so an edited source or header never loads a
stale library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every entry point returns cudaError_t as int
_SIGNATURES = {
    "hold_knn_warp_fwd": [_P] * 9 + [_I] * 5 + [_F, _P, _P],
    "hold_knn_warp_bwd": [_P] * 7 + [_I] * 3 + [_P],
    "hold_knn_jinv_fwd": [_P] * 7 + [_I] * 5 + [_P, _P],
    "hold_knn_jinv_bwd": [_P] * 5 + [_I] * 3 + [_P],
    "hold_min_vertex_dist": [_P] * 4 + [_I] * 2 + [_P, _P],
    "hold_fused_hand_sdf_z": [_P] * 12 + [_I] * 8 + [_P, _P],
    "hold_fused_object_sdf_z": [_P] * 9 + [_I] * 5 + [_P],
    "hold_fused_hand_sdf": [_P] * 10 + [_I] * 7 + [_P, _P],
    "hold_fused_object_sdf": [_P] * 7 + [_I] * 4 + [_P],
    "hold_knn_blend": [_P] * 6 + [_I] * 5 + [_F, _I, _P, _P],
    "hold_fused_hand_render": [_P] * 18 + [_I] * 7 + [_P, _P],
    "hold_fused_object_render": [_P] * 14 + [_I] * 4 + [_P],
    "hold_fused_render_scratch_words": [],
    "hold_fused_shade_fwd": [_P] * 11 + [_I] * 4 + [_P],
    "hold_fused_shade_bwd": [_P] * 21 + [_I] * 8 + [_P],
    "hold_fused_shade_part_cols": [_I],
    "hold_fused_shade_fwd_slabs": [],
    "hold_fused_shade_ws_cols": [_I],
    "hold_fused_shade_bwd_slabs": [],
    "hold_eb_round": [_P] * 11 + [_I] * 6 + [_F, _F, _P],
    "hold_eb_final": [_P] * 11 + [_I] * 10 + [_F, _P],
    "hold_eb_smem_bytes": [_I, _I],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds: list) -> list:
    """Start every command at once; wait for all; raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}\n{err}")
    return [err for _, err in outs]


def _build() -> Path:
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for s in sorted(SRC_DIR.glob("*.cu*")):  # headers (.cuh) key the build too
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    out = BUILD_DIR / f"libhold_kernels_{digest.hexdigest()[:12]}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True, ptxas="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        objs = [os.path.join(work, s.stem + ".o") for s in sources]
        # one nvcc per source, all started together
        ptxas = _run_all([
            [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
             "-c", str(s), "-o", o]
            for s, o in zip(sources, objs)
        ])
        tmp = os.path.join(work, out.name)
        _run_all([[_nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_info.update(
        path=str(out), seconds=time.perf_counter() - t0, cached=False, ptxas="".join(ptxas),
    )
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a CUDA error."""
    err = getattr(lib(), name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def check(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape``/``dtype``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def ptrs(*ts) -> list:
    """The tensors' device addresses, as the entry points take them."""
    return [t.data_ptr() for t in ts]


def require_cpu(t: torch.Tensor) -> None:
    """Raise unless ``t`` is on the CPU: a wrapper given neither a CUDA nor
    a CPU tensor has no kernel and no plain version to run."""
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for device {t.device}")
