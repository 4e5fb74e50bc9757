"""Aggregate metric JSONs across experiments (counterpart of
hold_tpu/summarize_metrics.py) — parity with
code/summarize_metrics.py: averages every eval.metric.json under the given
experiment folders and prints a table.

python -m hold_tpu_torch.summarize_metrics logs/<k1> logs/<k2> ...
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_dirs", nargs="+")
    args = ap.parse_args(argv)

    rows = []
    for d in args.exp_dirs:
        p = os.path.join(d, "eval.metric.json")
        if not os.path.exists(p):
            print(f"[skip] {d}: no eval.metric.json")
            continue
        with open(p) as f:
            rows.append(json.load(f))

    if not rows:
        print("no metrics found")
        return

    keys = sorted(
        k for k in rows[0] if isinstance(rows[0][k], (int, float))
    )
    print(f"{'metric':<14}" + "".join(f"{r.get('seq_name','?')[:12]:>14}" for r in rows)
          + f"{'mean':>14}")
    for k in keys:
        vals = [r.get(k, np.nan) for r in rows]
        print(f"{k:<14}" + "".join(f"{v:>14.3f}" for v in vals)
              + f"{np.nanmean(vals):>14.3f}")


if __name__ == "__main__":
    main()
