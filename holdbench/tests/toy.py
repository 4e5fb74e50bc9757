"""A toy copy of the benchmark's data files for the CPU tests: every
configuration, traffic mix, cell and metric reader of the benchmark, plus
toy-width cells of both entry kinds, written under a temporary directory
that ``holdbench.run`` is pointed at (``run.HERE``)."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import holdbench

SRC = Path(holdbench.__file__).resolve().parent

# sound toy readings on the CPU are 0 but for the z tables (the program's
# bf16 proposal queries, under 3e-3); the faults read 1e-2 and more
TOY_LIMITS = {"draws": 0.0, "loss": 1e-5, "z": 1e-2, "grad": 1e-4, "change": 1e-4}
TOY_RENDER_LIMITS = {"maps": 0.05}


def toy_config(src: dict) -> dict:
    c = copy.deepcopy(src)
    c["name"] = "toy_h1o"
    m = c["model"]
    m["implicit_network"].update(dims=[64] * 4, skip_in=[2], feature_vector_size=16)
    m["rendering_network"].update(dims=[16] * 2, feature_vector_size=16)
    m["bg_implicit_network"].update(dims=[16] * 2, skip_in=[], feature_vector_size=16)
    m["bg_rendering_network"].update(dims=[16], feature_vector_size=16)
    m["ray_sampler"].update(N_samples=16, N_samples_eval=32, N_samples_extra=8,
                            max_total_iters=2)
    c["sequence"] = {"frames": 4, "height": 48, "width": 64}
    c["object_mesh"] = dict(c["object_mesh"], frequency=4)
    return c


def write(root: Path, name: str, kind: str, obj: dict) -> None:
    (root / kind).mkdir(parents=True, exist_ok=True)
    (root / kind / f"{name}.json").write_text(json.dumps(obj, indent=1))


def make(root: Path) -> Path:
    """The data files under ``root`` (configs/, traffic/, workloads/,
    metrics/), with the toy cells ``toy_train`` and ``toy_render``."""
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(SRC / kind, root / kind)
    write(root, "toy_h1o", "configs",
          toy_config(json.loads((SRC / "configs" / "hold_h1o.json").read_text())))
    train = json.loads((SRC / "traffic" / "train_r20480_prop.json").read_text())
    write(root, "toy_train", "traffic", dict(train, name="toy_train", frames_per_step=4,
                                             rays_per_frame=8, compare_steps=2, trace_steps=1))
    render = json.loads((SRC / "traffic" / "render_r2.json").read_text())
    write(root, "toy_render", "traffic", dict(render, name="toy_render", render_downsample=4,
                                              pixel_per_batch=512, warmup_frames=1,
                                              compare_pixels=64))
    write(root, "toy_train", "workloads", {"name": "toy_train", "config": "toy_h1o",
                                           "traffic": "toy_train", "chips": 1,
                                           "limits": TOY_LIMITS})
    write(root, "toy_render", "workloads", {"name": "toy_render", "config": "toy_h1o",
                                            "traffic": "toy_render", "chips": 1,
                                            "limits": TOY_RENDER_LIMITS})
    return root
