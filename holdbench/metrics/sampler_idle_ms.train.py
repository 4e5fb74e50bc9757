"""The device's idle time a step while the port's sampler stage (the span
``hold.sampler``, and the spans inside it) was the innermost span open:
the traced window's idle gaps by their host span (holdbench/stages.py),
with no device sync."""

from holdbench import stages

KINDS = ("train",)
UNIT = "ms"
LAYER = "sampler stage (holdnet.sample_all_z, nodes, ray_sampler, proposal net)"
MOVES = "train_rays_per_s"


def read(t: dict):
    v = stages.idle_s(t.get("summary"), "train", "hold.sampler")
    return None if v is None else v * 1e3 / t["steps"]
