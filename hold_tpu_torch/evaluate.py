"""Evaluation entry point:

    python -m hold_tpu_torch.evaluate --exp <logs/key> --case <seq> [--ckpt PATH]
        [--gt synthetic|ho3d] [--ho3d_root DIR] [--icp_iters 600] [--icp_every_frame]
        [--device cuda|cpu]

Counterpart of hold_tpu/evaluate.py, with its metric registry and output
format (the reference's code/evaluate.py:9-90): {mpjpe_ra_r, mrrpe_ho,
cd_f_ra, cd_f_right, icp} -> the means as JSON (<exp>/eval.metric.json) and
the per-frame values (<exp>/eval.metric_all.npy).  The predictions come from
the experiment's checkpoint through its MANO and object servers, on the card
unless asked for the CPU; the metrics and the ICP run on the host.  Ground
truth: the synthetic sequence's build parameters (``--gt synthetic``), or
HO3D v3's annotations (``--gt ho3d``: ``eval/gt_ho3d.py`` reads
``<ho3d_root>/processed/<seq>.npz``, which ``data/process_ho3d.py`` writes,
and the scanned object under ``<ho3d_root>/models``; the MANO layer runs on
the same device).  ``--ho3d_root`` is the port's: the JAX package reads
its default, ``./generator/assets/ho3d_v3``, always.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from datetime import datetime

import numpy as np

from .eval.icp import compute_icp_metrics
from .eval.metrics import mpjpe_ra, mrrpe, per_frame_chamfer_f


def eval_mpjpe_right(pred, gt, md):
    md["mpjpe_ra_r"] = mpjpe_ra(pred["j3d_ra.right"], gt["j3d_ra.right"], gt["is_valid"])
    return md


def eval_mrrpe_ho(pred, gt, md):
    md["mrrpe_ho"] = mrrpe(gt["j3d_c.right"][:, 0], gt["root.object"],
                           pred["j3d_c.right"][:, 0], pred["root.object"], gt["is_valid"])
    return md


def eval_cd_f_ra(pred, gt, md):
    cd, f5, f10 = per_frame_chamfer_f(pred["v3d_ra.object"], gt["v3d_ra.object"],
                                      gt["is_valid"])
    md["cd_ra"], md["f5_ra"], md["f10_ra"] = cd, f5, f10
    return md


def eval_cd_f_right(pred, gt, md):
    cd, f5, f10 = per_frame_chamfer_f(pred["v3d_right.object"], gt["v3d_right.object"],
                                      gt["is_valid"])
    md["cd_right"], md["f5_right"], md["f10_right"] = cd, f5, f10
    return md


def eval_icp_first_frame(pred, gt, md, num_iters=600):
    cd, f5, f10 = compute_icp_metrics(
        gt["v3d_ra.object"][0], gt["faces"]["object"],
        pred["v3d_ra.object"][0], pred["faces"]["object"], num_iters=num_iters,
    )
    md["cd_icp"] = cd
    md["f5_icp"] = f5 * 100.0
    md["f10_icp"] = f10 * 100.0
    return md


def eval_icp_every_frame(pred, gt, md, num_iters=10):
    """Per-frame ICP-aligned CD/F (the reference's eval_modules.py:75-118): a
    short ICP for every valid frame, the metrics nan-averaged.  Not in the
    default registry, as in the reference (``--icp_every_frame``)."""
    n = len(pred["v3d_ra.object"])
    if len(gt["v3d_ra.object"]) != n:
        raise ValueError(f"pred/gt frame mismatch: {n} vs {len(gt['v3d_ra.object'])}")
    valid = np.asarray(gt["is_valid"]).astype(bool)
    if len(valid) != n:
        raise ValueError(f"is_valid length {len(valid)} != {n}")
    cds, f5s, f10s = [], [], []
    for i in range(n):
        if valid[i]:
            cd, f5, f10 = compute_icp_metrics(
                gt["v3d_ra.object"][i], gt["faces"]["object"],
                pred["v3d_ra.object"][i], pred["faces"]["object"], num_iters=num_iters,
            )
        else:
            cd = f5 = f10 = float("nan")
        cds.append(cd)
        f5s.append(f5)
        f10s.append(f10)
    md["cd_icp"] = float(np.nanmean(cds))
    md["f5_icp"] = float(np.nanmean(f5s)) * 100.0
    md["f10_icp"] = float(np.nanmean(f10s)) * 100.0
    return md


EVAL_FN_DICT = {
    "mpjpe_ra_r": eval_mpjpe_right,
    "mrrpe_ho": eval_mrrpe_ho,
    "cd_f_ra": eval_cd_f_ra,
    "cd_f_right": eval_cd_f_right,
}


def run_evaluation(pred, gt, icp_iters: int = 600,
                   icp_every_frame: bool = False) -> tuple[dict, dict]:
    """(mean metrics, per-frame metrics).  A metric whose inputs are missing
    is skipped; the ICP metrics run when both sides have object faces."""
    metric_dict: dict = {}
    for name, fn in EVAL_FN_DICT.items():
        try:
            metric_dict = fn(pred, gt, metric_dict)
        except KeyError as e:
            print(f"[eval] skipping {name}: missing {e}")
    if pred["faces"]["object"].shape[0] > 0 and gt["faces"]["object"].shape[0] > 0:
        if icp_every_frame:
            metric_dict = eval_icp_every_frame(pred, gt, metric_dict)
        else:
            metric_dict = eval_icp_first_frame(pred, gt, metric_dict, icp_iters)
    mean_metrics = {k: float(np.nanmean(v)) for k, v in sorted(metric_dict.items())}
    return mean_metrics, metric_dict


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", required=True, help="experiment dir (logs/<key>)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path (default: the newest; the reference's --sd_p role)")
    ap.add_argument("--out_json", default=None,
                    help="metrics JSON path (default <exp>/eval.metric.json)")
    ap.add_argument("--case", required=True)
    ap.add_argument("--data_root", default="./data")
    ap.add_argument("--gt", default="synthetic", choices=["synthetic", "ho3d"],
                    help="ground-truth source")
    ap.add_argument("--ho3d_root", default="./generator/assets/ho3d_v3",
                    help="processed HO3D annotations and object models (--gt ho3d)")
    ap.add_argument("--icp_iters", type=int, default=600)
    ap.add_argument("--icp_every_frame", action="store_true",
                    help="per-frame short-ICP variant (eval_modules.py:75)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Evaluate and write the metrics; returns {"mean": the JSON written,
    "per_frame": the per-frame dict, "servers_s": the predictions' and the
    ground truth's wall (checkpoint, servers, mapping to eval space),
    "metrics_s": the metrics' and the ICP's wall (host)}."""
    args = build_argparser().parse_args(argv)
    from .data.dataset import SequenceData
    from .eval.io_pred import gt_from_sequence, load_data
    from .utils.config import resolve_device

    device = resolve_device(args.device)
    seq = SequenceData.from_build_dir(args.case, args.data_root)
    t0 = time.perf_counter()
    pred = load_data(args.exp, seq, device, ckpt=args.ckpt)
    if args.gt == "synthetic":
        gt = gt_from_sequence(seq, device)
    else:
        from .eval.gt_ho3d import load_data as load_gt_ho3d

        gt = load_gt_ho3d(args.case, args.data_root, args.ho3d_root, device=device)
    servers_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean_metrics, metric_dict = run_evaluation(pred, gt, args.icp_iters,
                                               icp_every_frame=args.icp_every_frame)
    metrics_s = time.perf_counter() - t0
    for k, v in mean_metrics.items():
        print(f"{k.upper()}: {v:.2f}")

    mean_metrics["timestamp"] = datetime.now().strftime("%m-%d %H:%M")
    mean_metrics["seq_name"] = args.case
    json_p = args.out_json or os.path.join(args.exp, "eval.metric.json")
    with open(json_p, "w") as f:
        json.dump(mean_metrics, f, indent=2)
    np.save(os.path.join(args.exp, "eval.metric_all.npy"), metric_dict)
    print(f"wrote {json_p} (servers and eval space {servers_s:.3f} s, metrics and ICP "
          f"{metrics_s:.3f} s)")
    return {"mean": mean_metrics, "per_frame": metric_dict, "servers_s": servers_s,
            "metrics_s": metrics_s}


if __name__ == "__main__":
    main()
