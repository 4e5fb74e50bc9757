"""Experiment tracking: scalars to ``<log_root>/<exp_key>/metrics.jsonl``,
images to ``visuals/``, the run's arguments to ``args.json`` and its log to
``train.log`` (the layout of
hold_tpu/utils/logger.py, kept so that tools written for either package find
the same files), each scalar record and image also to a remote sink when
one is given (``utils/remote.py``: the ``remote=`` argument, the
``remote_track`` argument or HOLD_TPU_REMOTE).  In a run over several
processes only rank 0's tracker writes: the others' are inactive."""

from __future__ import annotations

import json
import logging
import os
import secrets
import sys
import time
from typing import Any

import numpy as np

from .tracing import StepTimer  # noqa: F401  (holdbench/entries/train.py imports it here)


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
    """Scalar tracker with a stable on-disk layout.  An inactive tracker
    (``active=False``: a rank other than 0) writes no file, has no remote
    sink and logs warnings alone, to stderr."""

    def __init__(self, log_root: str, exp_key: str = "", args: dict | None = None,
                 mute: bool = False, remote: str | None = None, active: bool = True):
        self.exp_key = exp_key or make_exp_key()
        self.log_dir = os.path.join(log_root, self.exp_key)
        self.mute = mute
        self.active = active
        self.remote = None
        if not active:
            self._scalars = None
            self.logger = logging.getLogger("hold_tpu_torch.inactive")
            if not self.logger.handlers:
                self.logger.addHandler(logging.StreamHandler(sys.stderr))
                self.logger.setLevel(logging.WARNING)
                self.logger.propagate = False
            return
        from .remote import remote_from_spec

        spec = remote
        if spec is None and args is not None:
            spec = dict(args).get("remote_track")
        self.remote = remote_from_spec(spec)
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
        if not self.active:
            return
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
        if self.remote is not None and not self.mute:
            self.remote.log_metrics(rec, step=step)

    def log_image(self, name: str, img: np.ndarray, step: int) -> str:
        """Write ``img`` (H, W, 3) RGB, uint8 or floats in [0, 1], as
        ``visuals/<name>_<step, 9 digits>.png``; returns the path (written
        only by an active tracker)."""
        import cv2

        out_p = os.path.join(self.log_dir, "visuals", f"{name}_{step:09d}.png")
        if not self.active:
            return out_p
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        os.makedirs(os.path.dirname(out_p), exist_ok=True)
        if not cv2.imwrite(out_p, np.ascontiguousarray(arr[..., ::-1])):
            raise OSError(f"cv2 could not write {out_p}")
        if self.remote is not None and not self.mute:
            self.remote.log_image(name, out_p, step=step)
        return out_p

    def close(self) -> None:
        if self._scalars is not None:
            self._scalars.close()
        if self.remote is not None:
            self.remote.close()
