"""Rows 8-9 (render_warp_kernel, render_shade_kernel) against the least
time the render shade's work needs at every node's points
(holdbench/counts.py)."""

from holdbench import counts
from holdbench.trace import kernel_seconds

KINDS = ("render",)
UNIT = "%"
LAYER = "kernels (csrc/fused_shade.cu, csrc/fused_render.cu)"
MOVES = "render_rays_per_s"
KERNELS = ("render_warp_kernel", "render_shade_kernel")


def read(t: dict):
    s = t.get("summary")
    if not s:
        return None
    secs = kernel_seconds(s, KERNELS)
    if secs <= 0:
        return None
    return 100.0 * counts.render_shade_bound_s(t["shade_points"] * t["frames"]) / secs
