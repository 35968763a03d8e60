"""Debug overfit, the end-to-end correctness oracle (the port's twin of
``scripts/debug-overfit.sh`` and ``scripts/debug-overfit-waymo.sh``):

    python -m range_view_3d_detection_torch.overfit {av2,waymo} [epochs] \\
        [--work-dir DIR] [--device cpu]

It writes the scripts' synthetic corpus (one log; the train split doubles
as the val split), trains the scripts' experiment with their overrides,
writes prediction shards and scores them: AV2 by ``train.py``'s
evaluation, Waymo by the WOD protocol with and without the recall-gap
penalty, as the Waymo script prints both. Convergence on the same data
is the oracle: the loss falls and the mAP is real. It prints one JSON
line: the step count, the first and last-10 mean loss, the wall seconds
of corpus, training and scoring, and the metrics.
"""

from __future__ import annotations

import argparse
import json
import logging
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from range_view_3d_detection_torch.data.synthetic import generate_dataset

DEFAULT_EPOCHS = 20  # the scripts' default
# Each corpus and its overrides, as the two scripts write them.
CORPORA = {
    "av2": dict(
        experiment="rv-synthetic",
        corpus=dict(splits={"train": 1, "val": 1}, sweeps_per_log=2, height=32,
                    width=248, seed=0),
        overrides=["++model.debug=true", "++model.batch_size=2",
                   "++model.augmentations_config=null",
                   "++dataset._val_dataset.split_name=train"],
    ),
    "waymo": dict(
        experiment="rv-waymo-synthetic",
        corpus=dict(splits={"train": 1, "val": 1}, sweeps_per_log=16, num_boxes=8,
                    height=32, width=250, seed=0, dataset_name="waymo",
                    categories=("VEHICLE", "PEDESTRIAN", "CYCLIST")),
        overrides=["++model.augmentations_config=null",
                   "++dataset._val_dataset.split_name=train"],
    ),
}


def build_trainer(dataset: str, epochs: Optional[int], work_dir: Path,
                  device: Optional[str] = None):
    """Write the corpus under ``work_dir`` and build the overfit's
    ``Trainer`` (run directory ``work_dir/run``)."""
    from range_view_3d_detection_torch.train import CONF_DIR
    from range_view_3d_detection_torch.training.loop import Trainer
    from range_view_3d_detection_torch.utils.config import compose

    spec = CORPORA[dataset]
    root = generate_dataset(work_dir / "sensor", **spec["corpus"])
    overrides = spec["overrides"] + [
        f"++dataset.root_dir={root}",
        f"++run_dir={work_dir / 'run'}",
        f"++trainer.max_epochs={epochs or DEFAULT_EPOCHS}",
    ]
    return Trainer(compose(CONF_DIR, spec["experiment"], overrides), device=device)


def record_losses(trainer) -> List[float]:
    """Wrap the trainer's step so that each step's loss is appended to the
    returned list."""
    losses: List[float] = []
    step = trainer.train_step

    def recording_step(state, batch):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics

    trainer.train_step = recording_step
    return losses


def score(trainer, pred_dir: Path, *, write: bool = False) -> Dict[str, Any]:
    """The overfit's metrics of the shards in ``pred_dir``: ``train.py``'s
    evaluation for AV2 (``write`` puts its ``metrics.feather`` in the run
    directory); for Waymo the WOD protocol with the recall-gap penalty and
    without it, against the train split."""
    if trainer.cfg["dataset"]["dataset_name"] != "waymo":
        from range_view_3d_detection_torch.train import evaluate_run

        metrics = evaluate_run(trainer, pred_dir, write=write)
        return {"mAP": metrics["AVERAGE_METRICS"]["AP"], "metrics": metrics}
    from range_view_3d_detection_torch.evaluate import evaluate_dirs

    gt_dir = Path(trainer.cfg["dataset"]["root_dir"]) / "train"
    out: Dict[str, Any] = {}
    for tag, penalty in (("penalty", True), ("no_penalty", False)):
        m = evaluate_dirs(pred_dir, gt_dir, "waymo", recall_gap_penalty=penalty)
        out[tag] = {"mAP_L2": m["mAP_L2"], "mAPH_L2": m["mAPH_L2"]}
    out["mAP"] = out["no_penalty"]["mAP_L2"]
    return out


def write_predictor_shards(trainer, predictor, dst: Path) -> Path:
    """Run ``predictor`` (a ``serving.Predictor``) over the val split and
    write its shards as ``Trainer.validate`` writes them."""
    from range_view_3d_detection_torch.training.loop import write_prediction_shards

    dst.mkdir(parents=True, exist_ok=True)
    for batch in trainer.val_loader:
        result = predictor(batch["features"], batch["cart"], batch["mask"])
        write_prediction_shards(result, batch["uuids"], trainer.categories, dst)
    return dst


def int8_predictor(trainer):
    """The trained model as the int8 PTQ ``Predictor``: full scope,
    calibrated on the train split's batches."""
    from range_view_3d_detection_torch.serving import Predictor

    predictor = Predictor(trainer.det_cfg, trainer.dec_cfg, device=trainer.device)
    predictor.model.load_state_dict(trainer.state.model.state_dict())
    calib = [
        tuple(torch.as_tensor(b[k], device=trainer.device) for k in ("features", "cart", "mask"))
        for b in trainer.train_loader
    ]
    return predictor.quantize(calib, scope="full")


def run(dataset: str, epochs: Optional[int] = None, work_dir: Optional[Path] = None,
        device: Optional[str] = None) -> Dict[str, Any]:
    """Train the overfit and score it; returns the per-step losses and the
    metrics (``mAP``: AV2's mean AP, Waymo's mAP_L2 without the penalty)."""
    work_dir = Path(work_dir or tempfile.mkdtemp(prefix=f"overfit-{dataset}-"))
    trainer = build_trainer(dataset, epochs, work_dir, device)
    losses = record_losses(trainer)
    trainer.fit()
    pred_dir = trainer.validate()
    return {"losses": losses, **score(trainer, pred_dir, write=True), "trainer": trainer}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=sorted(CORPORA))
    ap.add_argument("epochs", nargs="?", type=int, default=None)
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run(args.dataset, args.epochs, args.work_dir, args.device)
    wall_s = time.perf_counter() - t0
    losses = out.pop("losses")
    trainer = out.pop("trainer")
    out.pop("metrics", None)
    print(json.dumps({
        "steps": len(losses), "first_loss": losses[0],
        "last10_mean_loss": float(np.mean(losses[-10:])),
        "run_dir": str(trainer.run_dir), "wall_s": wall_s, **out,
    }, default=float))
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
