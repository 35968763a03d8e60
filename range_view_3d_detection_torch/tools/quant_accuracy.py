"""End-to-end accuracy cost of int8 PTQ serving: fp against int8 AP and
CDS (counterpart of the repo-root ``tools/quant_accuracy.py``).

Restore a port training run, export ONE serving artifact whose activation
scales are calibrated on ``--calib-batches`` val batches, decode the val
split through both the fp and the int8 predict paths (K3 with K1, or with
K4 under ``RV3D_STEM_INT8=1``), score each with the trainer's protocol
(``evaluation/av2_eval.py``) and print the per-category table and the mean
AP/CDS deltas:

    python -m range_view_3d_detection_torch.train experiment=rv-synthetic \\
        ++model.debug=false ++dataset.root_dir=DIR ++run_dir=RUN
    python -m range_view_3d_detection_torch.tools.quant_accuracy --run-dir RUN \\
        [--out OUT] [--scope full|heads] [--calib-batches 2] \\
        [--qat-steps N --qat-lr 1e-4] [--x-stride-eval N] [--device cpu]

``--qat-steps`` first fine-tunes the weights under QAT
(``training/state.py::make_train_step(quant_tree=...)``: STE fake-quant
forward, frozen activation scales) and adds an ``int8_qat`` row. The PTQ
delta is deterministic given a checkpoint; the QAT delta is not on a card
(cuDNN's bf16 backward is not deterministic).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from range_view_3d_detection_torch import export, serving
from range_view_3d_detection_torch.training.loop import resolve_device


def _predict_split(predict, loader, categories, dst: Path) -> None:
    from range_view_3d_detection_torch.training.loop import write_prediction_shards

    dst.mkdir(parents=True, exist_ok=True)
    for batch in loader:
        result = predict(batch["features"], batch["cart"], batch["mask"])
        write_prediction_shards(result, batch["uuids"], categories, dst)


def _qat_finetune(model, det_cfg, cfg, qtree, *, steps: int, lr: float, device) -> dict:
    """``steps`` train steps under QAT from ``model``'s weights (AdamW at
    ``lr``, weight decay 1e-4 as optax's ``adamw``, the clip at 35, a
    constant rate); returns the fine-tuned state dict."""
    from range_view_3d_detection_torch.data.dataset import DataLoader, RangeViewDataset
    from range_view_3d_detection_torch.training import optim
    from range_view_3d_detection_torch.training.builders import build_dataset_config
    from range_view_3d_detection_torch.training.state import create_state, make_train_step

    tx, _ = optim.make_optimizer(lr, steps, weight_decay=1e-4, grad_clip_norm=35.0, debug=True)
    state = create_state(det_cfg, tx, device=device)
    state.model.load_state_dict(model.state_dict())
    step_fn = make_train_step(det_cfg, quant_tree=qtree)
    ds = RangeViewDataset(build_dataset_config(cfg, "train"))
    batch_size = int(cfg["model"]["batch_size"])
    done = 0
    while done < steps:
        for batch in DataLoader(ds, batch_size, shuffle=True, drop_last=True):
            state, metrics = step_fn(state, batch)
            done += 1
            if done % 10 == 0 or done == 1:
                print(f"qat step {done}/{steps} loss={float(metrics['loss']):.4f}")
            if done >= steps:
                break
    return state.model.state_dict()


def calibrate(model, det_cfg, dec_cfg, calib, scope: str, device):
    """The activation scales of ``model`` BatchNorm-folded, calibrated on
    ``calib`` and kept to ``scope`` (``model`` is left as it was)."""
    from range_view_3d_detection_torch.models.quantized import (
        calibrate_scales,
        filter_scope,
        fold_batch_norms,
    )

    p = serving.Predictor(det_cfg, dec_cfg, device=device)
    p.model.load_state_dict(model.state_dict())
    fold_batch_norms(p.model)
    with torch.inference_mode():
        return filter_scope(calibrate_scales(p.model, calib), scope)


def score(pred_dir: Path, cfg, categories) -> dict:
    """The trainer's evaluation of the shards in ``pred_dir`` against the
    val split (``train.py::evaluate_run``'s arguments)."""
    from range_view_3d_detection_torch.evaluation import detection_cfg_factory
    from range_view_3d_detection_torch.evaluation.av2_eval import evaluate_predictions

    eval_cfg = detection_cfg_factory(cfg["dataset"].get("dataset_name", "av2"))
    val_split = cfg["dataset"]["_val_dataset"].get("split_name", "val")
    return evaluate_predictions(
        pred_dir,
        Path(cfg["dataset"]["root_dir"]) / val_split,
        categories=categories,
        max_range_m=eval_cfg.max_range_m,
        eval_only_roi_instances=eval_cfg.eval_only_roi_instances,
        dataset_name=eval_cfg.dataset_name,
    )


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--out", default=str(Path(tempfile.gettempdir()) / "quant_accuracy"))
    ap.add_argument("--scope", default="full", choices=("full", "heads"))
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--qat-steps", type=int, default=0,
                    help="QAT fine-tune steps before a second int8 export (int8_qat row)")
    ap.add_argument("--qat-lr", type=float, default=1e-4)
    ap.add_argument("--x-stride-eval", type=int, default=0,
                    help="also serve the fp weights through an x_stride=N val loader "
                    "(fp_xN row)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    from range_view_3d_detection_torch.data.dataset import DataLoader, RangeViewDataset
    from range_view_3d_detection_torch.training.builders import build_dataset_config

    device = resolve_device(args.device)
    run_dir, out = Path(args.run_dir), Path(args.out)
    cfg = json.loads((run_dir / "config.json").read_text())
    model, det_cfg, dec_cfg = export._restore_from_run_dir(run_dir, device)

    ds = RangeViewDataset(build_dataset_config(cfg, "val"))
    batch_size = int(cfg["model"]["batch_size"])
    categories = []
    for _, cats in sorted(det_cfg.tasks, key=lambda kv: kv[0]):
        categories.extend(sorted(cats))

    # Calibrate on real val batches, once: the same frozen scales feed the
    # PTQ export, the QAT fine-tune and the QAT export.
    calib = []
    for batch in DataLoader(ds, batch_size, shuffle=False, drop_last=False):
        calib.append(tuple(torch.as_tensor(batch[k], device=device)
                           for k in ("features", "cart", "mask")))
        if len(calib) >= args.calib_batches:
            break
    qtree = calibrate(model, det_cfg, dec_cfg, calib, args.scope, device)
    art = out / "artifact"
    export.export_artifact(model, det_cfg, dec_cfg, art, quantize_scales=qtree)

    runs = [("fp", art, False, ds), ("int8", art, "auto", ds)]
    if args.x_stride_eval > 1:
        ds_fast = RangeViewDataset(dataclasses.replace(
            build_dataset_config(cfg, "val"), x_stride=args.x_stride_eval))
        runs.append((f"fp_x{args.x_stride_eval}", art, False, ds_fast))
    if args.qat_steps > 0:
        qat_model = serving.Predictor(det_cfg, dec_cfg, device=device).model
        qat_model.load_state_dict(_qat_finetune(model, det_cfg, cfg, qtree,
                                                steps=args.qat_steps, lr=args.qat_lr,
                                                device=device))
        art_qat = out / "artifact_qat"
        export.export_artifact(qat_model, det_cfg, dec_cfg, art_qat, quantize_scales=qtree)
        runs.append(("int8_qat", art_qat, "auto", ds))

    results = {}
    for name, art_dir, quantized, run_ds in runs:
        predict, _, _ = export.load_artifact(art_dir, quantized=quantized, device=device)
        dst = out / f"predictions_{name}"
        loader = DataLoader(run_ds, batch_size, shuffle=False, drop_last=False)
        _predict_split(predict, loader, categories, dst)
        results[name] = score(dst, cfg, categories)

    names = [name for name, *_ in runs]
    rows = sorted(set().union(*(results[n] for n in names)))
    hdr = " ".join(f"{'AP ' + n:>12s} {'CDS ' + n:>12s}" for n in names)
    print(f"{'category':30s} {hdr}")
    deltas = {n: {"AP": [], "CDS": []} for n in names[1:]}
    for r in rows:
        cells = []
        fp = results["fp"].get(r, {})
        for n in names:
            m = results[n].get(r, {})
            cells.append(f"{m.get('AP', np.nan):12.4f} {m.get('CDS', np.nan):12.4f}")
            if n != "fp":
                for metric in ("AP", "CDS"):
                    a, b = fp.get(metric, np.nan), m.get(metric, np.nan)
                    if np.isfinite(a) and np.isfinite(b):
                        deltas[n][metric].append(b - a)
        print(f"{r:30s} " + " ".join(cells))
    summary = {"scope": args.scope, "qat_steps": args.qat_steps,
               "device": str(device)}
    for n in names:
        summary[f"mean_ap_{n}"] = float(results[n]["AVERAGE_METRICS"]["AP"])
    for n, d in deltas.items():
        summary[f"mean_ap_delta_{n}"] = float(np.mean(d["AP"])) if d["AP"] else None
        summary[f"mean_cds_delta_{n}"] = float(np.mean(d["CDS"])) if d["CDS"] else None
    summary["mean_ap_delta"] = summary.get("mean_ap_delta_int8")
    summary["mean_cds_delta"] = summary.get("mean_cds_delta_int8")
    print(json.dumps(summary))
    (out / "summary.json").write_text(json.dumps(summary))
    summary["results"] = results
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
