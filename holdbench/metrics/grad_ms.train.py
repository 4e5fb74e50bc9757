"""The grad stage's wall a step (forward, losses, backward, Adam): the
port's StepTimer "grad" phase; read in the traced run only."""

KINDS = ("train",)
UNIT = "ms"
LAYER = "grad stage (holdnet_forward, losses, backward, Adam)"
MOVES = "train_rays_per_s"


def read(t: dict):
    v = t.get("phases", {}).get("grad")
    return v * 1e3 if v else None
