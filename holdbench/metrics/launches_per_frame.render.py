"""CUDA kernel launches a rendered frame, counted in the traced window."""

KINDS = ("render",)
UNIT = "launches"
LAYER = "render loop (renderer.render_frame, holdnet_render)"
MOVES = "render_rays_per_s"


def read(t: dict):
    s = t.get("summary")
    return s["launches"] / t["frames"] if s and t.get("frames") else None
