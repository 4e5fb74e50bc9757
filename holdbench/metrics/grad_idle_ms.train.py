"""The device's idle time a step while the port's grad stage (the span
``hold.grad``, and the spans inside it) was the innermost span open: the
traced window's idle gaps by their host span (holdbench/stages.py), with
no device sync."""

from holdbench import stages

KINDS = ("train",)
UNIT = "ms"
LAYER = "grad stage (holdnet_forward, losses, backward, Adam)"
MOVES = "train_rays_per_s"


def read(t: dict):
    v = stages.idle_s(t.get("summary"), "train", "hold.grad")
    return None if v is None else v * 1e3 / t["steps"]
