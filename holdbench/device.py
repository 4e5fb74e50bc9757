"""The few calls that differ between the card and the CPU (the CPU runs
only in the tests, at toy sizes)."""

from __future__ import annotations

import torch


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0


def reset_peak(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def empty_cache(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
