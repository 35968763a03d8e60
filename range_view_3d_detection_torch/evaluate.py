"""Standalone evaluation (the port's twin of ``tools/evaluate.py``): score
prediction shards against a ground-truth split and print the metrics as
JSON.

    python -m range_view_3d_detection_torch.evaluate --pred-dir RUN/predictions \\
        --gt-dir ROOT/sensor/val [--dataset av2|waymo] [--categories A,B,C] \\
        [--workers N] [--no-recall-gap-penalty]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


def evaluate_dirs(
    pred_dir: Path,
    gt_dir: Path,
    dataset: str = "av2",
    categories: Optional[List[str]] = None,
    *,
    workers: Optional[int] = None,
    recall_gap_penalty: bool = True,
) -> Dict[str, Any]:
    """The metrics ``tools/evaluate.py`` prints for these arguments."""
    from range_view_3d_detection_torch.evaluation.av2_eval import (
        _join_valid_uuids,
        annotate_detection_roi,
        dedupe_predictions,
        evaluate,
        load_ground_truth,
        load_predictions,
    )

    dts = load_predictions(Path(pred_dir))
    gts = load_ground_truth(Path(gt_dir))
    dts = dedupe_predictions(dts)
    dts, gts = _join_valid_uuids(dts, gts)
    if dataset == "av2":
        # ROI-filter detections too (GT flags come from the converter);
        # otherwise correct detections of off-ROI objects count as FPs.
        dts = annotate_detection_roi(dts, Path(gt_dir))
    categories = categories or sorted(np.unique(gts["category"]).tolist())
    if dataset == "av2":
        return evaluate(dts, gts, categories)
    from range_view_3d_detection_torch.evaluation.waymo_eval import evaluate_waymo, mean_ap

    metrics = evaluate_waymo(
        dts, gts, categories, workers=workers,
        **({} if recall_gap_penalty else {"max_recall_delta": None}),
    )
    metrics["mAP_L2"] = mean_ap(metrics, level=2)
    metrics["mAPH_L2"] = mean_ap(metrics, level=2, metric="APH")
    return metrics


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred-dir", required=True)
    ap.add_argument("--gt-dir", required=True)
    ap.add_argument("--dataset", default="av2", choices=["av2", "waymo"])
    ap.add_argument("--categories", default=None)
    ap.add_argument(
        "--workers", type=int, default=None,
        help="process-pool width for the WOD per-sweep Hungarian solves "
        "(default: RV3D_EVAL_WORKERS env var; 0 forces serial)",
    )
    ap.add_argument(
        "--no-recall-gap-penalty", action="store_true",
        help="WOD only: evaluate with max_recall_delta=None, which separates "
        "pipeline correctness from the official penalty's cap on detectors "
        "whose scores saturate",
    )
    args = ap.parse_args(argv)
    metrics = evaluate_dirs(
        Path(args.pred_dir), Path(args.gt_dir), args.dataset,
        args.categories.split(",") if args.categories else None,
        workers=args.workers, recall_gap_penalty=not args.no_recall_gap_penalty,
    )
    print(json.dumps(metrics, indent=2, default=float))
    return metrics


if __name__ == "__main__":
    main()
