"""Row 7's backward (the training shade's backward kernels: its rows,
wgrad_kernel, colsum_kernel) against the least time the work needs at
every node's grad-stage points (holdbench/counts.py)."""

from holdbench import counts
from holdbench.trace import kernel_seconds

KINDS = ("train",)
UNIT = "%"
LAYER = "kernels (csrc/fused_shade.cu, csrc/fused_render.cu)"
MOVES = "train_rays_per_s"
KERNELS = ("fused_shade_bwd_kernel", "wgrad_kernel", "colsum_kernel")


def read(t: dict):
    s = t.get("summary")
    if not s:
        return None
    secs = kernel_seconds(s, KERNELS)
    if secs <= 0:
        return None
    return 100.0 * counts.row7_bwd_bound_s(t["row7_points"] * t["steps"]) / secs
