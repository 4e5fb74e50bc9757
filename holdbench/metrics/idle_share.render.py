"""The share of the traced window in which no operation ran on the device
(the union of the profiler's device intervals)."""

KINDS = ("render",)
UNIT = "%"
LAYER = "device (one H100)"
MOVES = "render_rays_per_s"


def read(t: dict):
    s = t.get("summary")
    if not s or not s.get("window_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
