"""The device's idle time a frame while a chunk's sampler stage (the
port's span ``hold.sampler``, and the spans inside it) was the innermost
span open: the traced window's idle gaps by their host span
(holdbench/stages.py)."""

from holdbench import stages

KINDS = ("render",)
UNIT = "ms"
LAYER = "render loop (renderer.render_frame, holdnet_render)"
MOVES = "render_rays_per_s"


def read(t: dict):
    v = stages.idle_s(t.get("summary"), "render", "hold.sampler")
    return None if v is None else v * 1e3 / t["frames"]
