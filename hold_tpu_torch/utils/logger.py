"""Experiment tracking: scalars to ``<log_root>/<exp_key>/metrics.jsonl``, the
run's arguments to ``args.json`` and its log to ``train.log`` (the layout of
hold_tpu/utils/logger.py, kept so that tools written for either package find
the same files; the remote sink is not ported)."""

from __future__ import annotations

import json
import logging
import os
import secrets
import sys
import time
from typing import Any

import numpy as np


def make_exp_key() -> str:
    return secrets.token_hex(5)[:9]


def setup_logging(log_dir: str | None = None) -> logging.Logger:
    logger = logging.getLogger("hold_tpu_torch")
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s|%(levelname)s] %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class Tracker:
    """Scalar tracker with a stable on-disk layout."""

    def __init__(self, log_root: str, exp_key: str = "", args: dict | None = None,
                 mute: bool = False):
        self.exp_key = exp_key or make_exp_key()
        self.log_dir = os.path.join(log_root, self.exp_key)
        self.mute = mute
        os.makedirs(self.log_dir, exist_ok=True)
        self._scalars = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        self.logger = setup_logging(self.log_dir)
        if args is not None:
            self.save_args(args)

    def save_args(self, args: dict) -> None:
        def conv(v):
            if isinstance(v, (np.integer, np.floating)):
                return v.item()
            return v

        with open(os.path.join(self.log_dir, "args.json"), "w") as f:
            json.dump({k: conv(v) for k, v in dict(args).items()}, f, indent=2, default=str)

    def log_dict(self, d: dict[str, Any], step: int, epoch: int | None = None) -> None:
        rec = {"step": int(step), "t": time.time()}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        for k, v in d.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._scalars.write(json.dumps(rec) + "\n")
        self._scalars.flush()

    def close(self) -> None:
        self._scalars.close()


class StepTimer:
    """Per-phase wall-clock accounting."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._start: dict[str, float] = {}

    def start(self, phase: str) -> None:
        self._start[phase] = time.perf_counter()

    def stop(self, phase: str) -> float:
        dt = time.perf_counter() - self._start.pop(phase)
        self.totals[phase] = self.totals.get(phase, 0.0) + dt
        self.counts[phase] = self.counts.get(phase, 0) + 1
        return dt

    def summary(self) -> dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in sorted(self.totals)}
