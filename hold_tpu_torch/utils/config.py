"""Config system: python-dict defaults + YAML overlay + CLI flags
(counterpart of hold_tpu/utils/config.py; PyYAML is imported only when a
YAML file is loaded).

Two-tier design mirroring the reference's argparse + OmegaConf merge
(code/src/utils/parser.py:13-104 and code/confs/general.yaml), without the
OmegaConf dependency: plain nested dicts with dotted-path override, wrapped in
an attribute-access view.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Any

import numpy as np
import torch



class Cfg(dict):
    """Attribute-access view over a nested dict."""

    def __getattr__(self, k: str) -> Any:
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Cfg(v) if isinstance(v, dict) and not isinstance(v, Cfg) else v

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v


def deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def set_dotted(cfg: dict, path: str, value: Any) -> None:
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


# Default model/dataset config — parity with the reference's
# code/confs/general.yaml:1-96 (same architecture constants).
DEFAULT_CONFIG: dict = {
    "model": {
        "implicit_network": {
            "feature_vector_size": 256,
            "d_in": 3,
            "d_out": 1,
            "dims": [256] * 8,
            "init": "geometry",
            "bias": 0.6,
            "skip_in": [4],
            "weight_norm": True,
            "multires": 6,
            "cond": "pose",
        },
        "rendering_network": {
            "feature_vector_size": 256,
            "mode": "pose",
            "d_in": 14,
            "d_out": 3,
            "dims": [256] * 4,
            "weight_norm": True,
            "multires_view": -1,
        },
        "bg_implicit_network": {
            "feature_vector_size": 256,
            "d_in": 4,
            "d_out": 1,
            "dims": [256] * 8,
            "init": "none",
            "bias": 0.0,
            "skip_in": [4],
            "weight_norm": False,
            "multires": 10,
            "cond": "frame",
            "dim_frame_encoding": 32,
        },
        "bg_rendering_network": {
            "feature_vector_size": 256,
            "mode": "nerf_frame_encoding",
            "d_in": 3,
            "d_out": 3,
            "dims": [128],
            "weight_norm": False,
            "multires_view": 4,
            "dim_frame_encoding": 32,
        },
        "density": {"params_init": {"beta": 0.1}, "beta_min": 0.0001},
        # sampler FLOP diet (no reference counterpart): small canonical-SDF
        # surrogate distilled online from the trunk; replaces the trunk in
        # the error-bound sampler's table-building queries after `warmup`
        # steps.  --no_proposal turns it off (the JAX HOLD_NO_PROPOSAL=1).
        "proposal": {
            "enabled": True,
            "width": 64,
            "depth": 3,
            "multires": 6,
            "warmup": 1000,
            "lr": 1.0e-03,
        },
        "ray_sampler": {
            "near": 0.0,
            "N_samples": 64,
            "N_samples_eval": 128,
            "N_samples_extra": 32,
            "eps": 0.1,
            "beta_iters": 10,
            "max_total_iters": 5,
            "N_samples_inverse_sphere": 32,
            "add_tiny": 1.0e-06,
            # bisection convergence test: "current" (training default,
            # measured better on bench_seq — docs/pipeline.md) or "beta0"
            # (reference parity, ray_sampler.py:207-211)
            "conv_check": "current",
        },
        "scene_bounding_sphere": 3.0,
    },
    "dataset": {
        "train": {"type": "train", "batch_size": 5, "drop_last": False, "shuffle": True},
        "valid": {"type": "val", "batch_size": 1, "pixel_per_batch": 512},
        "test": {"type": "test", "batch_size": 1, "pixel_per_batch": 512},
    },
}


def load_config(path: str | None = None, overrides: dict | None = None) -> Cfg:
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    if path:
        import yaml

        with open(path) as f:
            cfg = deep_merge(cfg, yaml.safe_load(f) or {})
    if overrides:
        for k, v in overrides.items():
            set_dotted(cfg, k, v)
    return Cfg(cfg)


def build_argparser() -> argparse.ArgumentParser:
    """Training CLI flags — surface parity with code/src/utils/parser.py:13-70
    and every flag of the JAX package's, with its defaults; the port adds
    ``--seed``, ``--device`` and, for the JAX package's environment switches,
    ``--no_proposal``, ``--node_bounds``, ``--sampler_knn_stride`` and
    ``--sampler_relu``.  The
    multi-process flags keep the JAX names with the port's meaning: ``--num_devices`` local processes, one a card (0: every
    card; with ``--device cpu``, gloo processes on the CPU), or with
    ``--coordinator`` one process of ``--num_processes`` (rank
    ``--process_id``, on card ``process_id`` mod the host's cards)."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default="")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--case", type=str, required=True)
    p.add_argument("--shape_init", type=str, default="")
    p.add_argument("--mute", action="store_true")
    p.add_argument("--agent_id", type=int, default=0)  # declared, unused (as in the reference)
    p.add_argument("--num_sample", type=int, default=128)
    p.add_argument("--exp_key", type=str, default="")
    p.add_argument("--debug", action="store_true")  # declared, unused (as in the reference)
    p.add_argument("--num_epoch", type=int, default=200)
    p.add_argument("--freeze_pose", action="store_true")
    p.add_argument("--barf_s", type=int, default=1000)
    p.add_argument("--barf_e", type=int, default=10000)
    p.add_argument("--no_barf", action="store_true")  # declared, unused (as in the reference)
    p.add_argument("--lr", type=float, default=1.0e-4)
    p.add_argument("--offset", type=int, default=1)
    p.add_argument("--no_meshing", action="store_true")
    p.add_argument("--no_vis", action="store_true")
    p.add_argument("--render_downsample", type=int, default=2)
    p.add_argument("-f", "--fast", dest="fast_dev_run", action="store_true")
    p.add_argument("--infer_ckpt", type=str, default="")  # declared, unused (as in the reference)
    p.add_argument("--load_ckpt", type=str, default="")
    p.add_argument("--load_pose", type=str, default="")
    p.add_argument("--eval_every_epoch", type=int, default=6)
    p.add_argument("--tempo_len", type=int, default=2000)
    p.add_argument("--num_devices", type=int, default=0, help="0 = all local devices")
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--log_root", type=str, default="./logs")
    p.add_argument("--remote_track", type=str, default="",
                   help="remote tracker sink: jsonl:<path> or http(s)://url "
                        "(comet_utils streaming role; also HOLD_TPU_REMOTE)")
    p.add_argument("--coordinator", type=str, default="",
                   help="multi-host: coordinator address host:port "
                        "(torch.distributed); empty = single host")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0)
    # the sampler's knobs, off by default as in the JAX package:
    # HOLD_NO_PROPOSAL=1: no proposal net, the sampler queries the trunk always
    p.add_argument("--no_proposal", action="store_true")
    # HOLD_NODE_BOUNDS=1: each node's rays clipped to its bounding sphere
    p.add_argument("--node_bounds", action="store_true")
    # HOLD_SAMPLER_KNN_STRIDE=N: the sampler searches every N-th MANO vertex
    p.add_argument("--sampler_knn_stride", type=int, default=1)
    # HOLD_SAMPLER_RELU=1: relu hidden layers in the fused sampler query
    p.add_argument("--sampler_relu", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    return p


def sampler_flags(args) -> dict:
    """``build_scene``'s proposal and sampler keywords from the flags (absent
    flags, as in an older run's args.json, are their defaults)."""
    return {"proposal": not args.get("no_proposal", False),
            "node_bounds": bool(args.get("node_bounds", False)),
            "sampler_knn_stride": int(args.get("sampler_knn_stride", 1) or 1),
            "sampler_relu": bool(args.get("sampler_relu", False))}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU.  Raises when a CUDA device is asked for and there is none."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device='cpu') to run on the CPU")
    return dev


def parse_args(argv=None):
    """Parse CLI + config; inject the data's scene bounding sphere like the
    reference does at code/src/utils/parser.py:77-103.  ``-f`` (fast dev
    run) validates and checkpoints every epoch of 10 steps of 8 rays a frame
    and logs every step; ``run_training`` also shortens the sampler."""
    args = Cfg(vars(build_argparser().parse_args(argv)))
    cfg = load_config(args.config or None)

    build_dir = os.path.join(args.data_root, args.case, "build")
    data_p = os.path.join(build_dir, "data.npy")
    if os.path.exists(data_p):
        data = np.load(data_p, allow_pickle=True).item()
        cfg["model"]["scene_bounding_sphere"] = float(data["scene_bounding_sphere"])

    if args.fast_dev_run:
        args.eval_every_epoch = 1
        args.num_sample = 8
        args.tempo_len = 50
        args.log_every = 1

    args.total_step = int(
        args.num_epoch * args.tempo_len / cfg["dataset"]["train"]["batch_size"]
    )
    return args, cfg
