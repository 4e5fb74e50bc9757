"""The render's model FLOPs a frame (holdbench/counts.py) over the traced
window's seconds, against one H100's bf16 peak."""

from holdbench import counts

KINDS = ("render",)
UNIT = "%"
LAYER = "model step (whole)"
MOVES = "render_rays_per_s"


def read(t: dict):
    s = t.get("summary")
    if not s or not s.get("window_s"):
        return None
    return 100.0 * t["frame_flops"] * t["frames"] / s["window_s"] / counts.PEAK_BF16
