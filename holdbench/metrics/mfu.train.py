"""The whole training step's model FLOPs (holdbench/counts.py) over the
traced window's seconds, against one H100's bf16 peak."""

from holdbench import counts

KINDS = ("train",)
UNIT = "%"
LAYER = "model step (whole)"
MOVES = "train_rays_per_s"


def read(t: dict):
    s = t.get("summary")
    if not s or not s.get("window_s"):
        return None
    return 100.0 * t["step_flops"] * t["steps"] / s["window_s"] / counts.PEAK_BF16
