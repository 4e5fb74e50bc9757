"""Run one cell of the benchmark of hold_tpu_torch once and print its result.

    python3 holdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``holdbench/workloads/<cell>.json``; it names its configuration
(``holdbench/configs/<config>.json``) and its traffic
(``holdbench/traffic/<traffic>.json``), whose entry kind names the window
driver, ``holdbench/entries/<kind>.py``.  ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` traces a few steps or frames and
reports every per-layer metric of ``holdbench/metrics/<metric>.py`` whose
reader finds something to read there.  Both decide ``correct`` against the
plain reference (``holdbench/reference/``).  The last line of standard
output is one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hold_tpu")
# kernel caches of the program and of torch, at fixed paths in the checkout
CACHE = ROOT / ".holdbench_cache"


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"holdbench: no {kind[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str) -> dict:
    """A cell (``workloads/<name>.json``: its configuration, its traffic,
    its chips and limits) with its traffic's parameters
    (``traffic/<traffic>.json``: the entry kind and its shapes) merged in."""
    cell = load_json("workloads", name)
    return {**load_json("traffic", cell["traffic"]), **cell}


def metric_modules(kind: str) -> dict:
    """Every per-layer metric reader that applies to entries of ``kind``,
    by its file name."""
    out = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        name = path.name[:-3]
        spec = importlib.util.spec_from_file_location(f"holdbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if kind in getattr(mod, "KINDS", ()):
            out[name] = mod
    return out


def loaded_forbidden() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)  # tests: cpu
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ.pop("MANO_MODEL_DIR", None)  # the synthetic hand, as in the reference
    sys.path.insert(0, str(ROOT))

    cell = load_cell(args.workload)
    cfg = load_json("configs", cell["config"])

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"holdbench: {cell['chips']} CUDA device(s) needed, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    entry = importlib.import_module(f"holdbench.entries.{cell['kind']}")
    res = entry.run(cell, cfg, args.seed, args.seconds, bool(args.trace), dev, T_START)

    from holdbench.compare import checks

    correct, checked = checks(res["values"], cell.get("limits", {}))
    metrics = {}
    if args.trace:
        t = res["trace"]
        for name, mod in metric_modules(cell["kind"]).items():
            v = mod.read(t)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
    else:
        for name, unit in cell["end_to_end"].items():
            metrics[name] = {"value": res[name], "unit": unit}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": correct, "attempted": int(res["attempted"]),
           "failed": 0 if correct else 1, "metrics": metrics, "device": device}
    if args.trace and res["trace"].get("summary"):
        from holdbench.trace import breakdown

        s = res["trace"]["summary"]
        device["busy_s"], device["window_s"] = s["busy_s"], s["window_s"]
        out["breakdown"] = breakdown(s)
    out["worst"] = res.get("worst", {})
    out["checks"] = checked
    bad = loaded_forbidden()  # the readers and the breakdown loaded too
    if bad:
        print(f"holdbench: modules of {FORBIDDEN} loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in checked.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
