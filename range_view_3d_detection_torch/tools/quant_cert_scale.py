"""Scaled int8 accuracy certification (counterpart of the repo-root
``tools/quant_cert_scale.py``): per seed, a synthetic corpus (3 categories,
a val split of 3 logs x 24 sweeps, about 500 boxes), a training run
(``python -m range_view_3d_detection_torch.train``), then fp against int8
PTQ scoring (``tools/quant_accuracy.py``), each in a subprocess; the PTQ
delta is reported as its mean and spread over the seeds:

    python -m range_view_3d_detection_torch.tools.quant_cert_scale --seeds 3 --epochs 40 \\
        [--qat-steps N] [--x-stride-eval N] [--work DIR] [--device cpu]

A seed whose ``summary.json`` already answers the run is not trained again.
Writes ``cert.json`` under ``--work``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
CATEGORIES = ("PEDESTRIAN", "REGULAR_VEHICLE", "BICYCLIST")


def _num_val_gts(root: Path) -> int:
    from range_view_3d_detection_torch.evaluation.av2_eval import load_ground_truth

    gts = load_ground_truth(root / "val")
    return int((np.asarray(gts["num_interior_pts"]) > 0).sum())


def _done(out_dir: Path, qat_steps: int, x_stride_eval: int):
    """The seed's summary if it answers this run, else None: a PTQ-only
    summary does not answer a ``--qat-steps`` run."""
    path = out_dir / "summary.json"
    if not path.exists():
        return None
    done = json.loads(path.read_text())
    if qat_steps and not done.get("qat_steps"):
        return None
    if x_stride_eval and done.get(f"mean_cds_delta_fp_x{x_stride_eval}") is None:
        return None
    return done


def run_seed(seed: int, work: Path, epochs: int, verbose: bool, *, qat_steps: int = 0,
             qat_lr: float = 1e-4, x_stride_eval: int = 0, device: str = "cuda",
             sweeps_per_log: int = 24) -> dict:
    from range_view_3d_detection_torch.data.synthetic import generate_dataset

    root = work / f"sensor_s{seed}"
    run_dir = work / f"run_s{seed}"
    out_dir = work / f"quant_s{seed}"
    summary = _done(out_dir, qat_steps, x_stride_eval)
    if summary is not None:
        summary["num_val_gts"] = _num_val_gts(root)
        summary["resumed"] = True
        return summary
    generate_dataset(root, splits={"train": 3, "val": 3}, sweeps_per_log=sweeps_per_log,
                     height=32, width=248, categories=CATEGORIES, num_boxes=8,
                     num_bg_points=4000, seed=seed)

    def sh(args):
        r = subprocess.run(args, cwd=REPO, capture_output=not verbose, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"{' '.join(args[:4])}... rc={r.returncode}\n"
                f"{(r.stdout or '')[-2000:]}\n{(r.stderr or '')[-2000:]}"
            )
        return r

    sh([
        sys.executable, "-m", "range_view_3d_detection_torch.train",
        "experiment=rv-synthetic",
        f"++dataset.root_dir={root}",
        "++model.tasks={0: [PEDESTRIAN, REGULAR_VEHICLE, BICYCLIST]}",
        "++model.debug=false",
        "++model.train_log_freq=0",
        "++model.augmentations_config=null",
        f"++trainer.max_epochs={epochs}",
        "++trainer.check_val_every_n_epoch=10000",  # scored by quant_accuracy
        f"++trainer.device={device}",
        f"++run_dir={run_dir}",
        f"++trainer.checkpoint.dir={run_dir}/checkpoints",
    ])
    sh([
        sys.executable, "-m", "range_view_3d_detection_torch.tools.quant_accuracy",
        "--run-dir", str(run_dir), "--out", str(out_dir), "--calib-batches", "4",
        "--device", device,
        *(["--qat-steps", str(qat_steps), "--qat-lr", str(qat_lr)] if qat_steps else []),
        *(["--x-stride-eval", str(x_stride_eval)] if x_stride_eval else []),
    ])
    summary = json.loads((out_dir / "summary.json").read_text())
    summary["num_val_gts"] = _num_val_gts(root)
    return summary


def _spread(xs) -> dict:
    return {"mean": float(np.mean(xs)), "spread": float(np.max(xs) - np.min(xs))}


def aggregate(per_seed: list, *, qat_steps: int = 0, x_stride_eval: int = 0) -> dict:
    """The deltas' mean and spread (max - min) over the seeds."""
    agg = {"seeds": len(per_seed), "num_val_gts": [s["num_val_gts"] for s in per_seed]}
    for key, prefix in (("ptq", ""), *((("qat", "_int8_qat"),) if qat_steps else ()),
                        *((("fast", f"_fp_x{x_stride_eval}"),) if x_stride_eval else ())):
        for metric in ("ap", "cds"):
            name = f"mean_{metric}_delta{prefix}"
            s = _spread([seed[name] for seed in per_seed])
            agg[f"{key}_{metric}_delta_mean"] = s["mean"]
            agg[f"{key}_{metric}_delta_spread"] = s["spread"]
    if qat_steps:
        agg["qat_steps"] = qat_steps
    if x_stride_eval:
        agg["x_stride_eval"] = x_stride_eval
    agg["per_seed"] = per_seed
    return agg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--sweeps-per-log", type=int, default=24,
                    help="sweeps a log of each split (24: about 500 val boxes)")
    ap.add_argument("--work", default=str(Path(tempfile.gettempdir()) / "quant_cert_scale"))
    ap.add_argument("--qat-steps", type=int, default=0)
    ap.add_argument("--qat-lr", type=float, default=1e-4)
    ap.add_argument("--x-stride-eval", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    per_seed = []
    for seed in range(args.seeds):
        print(f"=== seed {seed} ===", flush=True)
        s = run_seed(seed, work, args.epochs, args.verbose, qat_steps=args.qat_steps,
                     qat_lr=args.qat_lr, x_stride_eval=args.x_stride_eval,
                     device=args.device, sweeps_per_log=args.sweeps_per_log)
        print(json.dumps(s), flush=True)
        per_seed.append(s)
    agg = aggregate(per_seed, qat_steps=args.qat_steps, x_stride_eval=args.x_stride_eval)
    print(json.dumps(agg), flush=True)
    (work / "cert.json").write_text(json.dumps(agg, indent=1))
    return agg


if __name__ == "__main__":
    main(sys.argv[1:])
