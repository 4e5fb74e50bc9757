"""CUDA kernel launches a training step, counted in the traced window."""

KINDS = ("train",)
UNIT = "launches"
LAYER = "training loop (train.py make_train_step, prefetch_batches)"
MOVES = "train_rays_per_s"


def read(t: dict):
    s = t.get("summary")
    return s["launches"] / t["steps"] if s and t.get("steps") else None
