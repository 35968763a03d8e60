"""Training entry point (the port's twin of ``scripts/train.py``):

    python -m range_view_3d_detection_torch.train experiment=rv-av2 [++key=value ...]

Composes the ``conf/`` tree (``--conf-dir``-free: the ``conf`` directory
of the checkout holding this package), builds the ``Trainer``, fits,
validates (writing prediction shards), evaluates them and writes
``metrics.feather`` beside them. It trains on the card unless
``++trainer.device=cpu`` asks for the CPU.

Data-parallel over the cards of one machine (one process a card, NCCL):

    python -m torch.distributed.run --nproc_per_node=N \
        -m range_view_3d_detection_torch.train experiment=rv-av2

Each rank trains on its shard of the data, validates its shard, and rank
0 evaluates the shards once every rank has written them.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

from range_view_3d_detection_torch.utils.config import compose

CONF_DIR = Path(__file__).resolve().parent.parent / "conf"
logger = logging.getLogger("train")


def evaluate_run(trainer, pred_dir: Path, *, write: bool = True) -> Dict[str, Dict[str, float]]:
    """Score the shards in ``pred_dir`` against the val split's ground
    truth under the dataset's protocol and (with ``write``) write
    ``metrics.feather`` in the run directory (``scripts/train.py:75-113``)."""
    from range_view_3d_detection_torch.evaluation import detection_cfg_factory
    from range_view_3d_detection_torch.evaluation.av2_eval import evaluate_predictions
    from range_view_3d_detection_torch.utils.feather import write_feather

    cfg = trainer.cfg
    eval_cfg = detection_cfg_factory(cfg["dataset"].get("dataset_name", "av2"))
    eval_split = cfg["dataset"]["_val_dataset"].get("split_name", "val")
    metrics = evaluate_predictions(
        pred_dir,
        Path(cfg["dataset"]["root_dir"]) / eval_split,
        categories=trainer.categories,
        max_range_m=eval_cfg.max_range_m,
        eval_only_roi_instances=eval_cfg.eval_only_roi_instances,
        dataset_name=eval_cfg.dataset_name,
    )
    if not write:
        return metrics
    rows = sorted(metrics)
    write_feather(
        trainer.run_dir / "metrics.feather",
        {
            "category": np.asarray(rows),
            **{
                m: np.asarray([metrics[r].get(m, np.nan) for r in rows])
                for m in ("AP", "ATE", "ASE", "AOE", "CDS", "num_gts")
            },
        },
    )
    return metrics


def main(argv: List[str]) -> Dict[str, Dict[str, float]]:
    experiment = None
    overrides = []
    for arg in argv:
        if arg.startswith("experiment="):
            experiment = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    if experiment is None:
        raise SystemExit(
            "usage: python -m range_view_3d_detection_torch.train "
            "experiment=<name> [++key=value ...]"
        )
    import torch.distributed

    from range_view_3d_detection_torch.parallel import mesh
    from range_view_3d_detection_torch.training.loop import Trainer

    cfg = compose(CONF_DIR, experiment, overrides)
    trainer = Trainer(cfg)
    try:
        logger.info(
            "experiment=%s device=%s rank=%d world=%d train_sweeps=%d val_sweeps=%d "
            "batch=%d (global %d)",
            experiment, trainer.device, trainer.rank, trainer.world, len(trainer.train_ds),
            len(trainer.val_ds), trainer.batch_size, trainer.global_batch,
        )
        trainer.fit()
        pred_dir = trainer.validate()
        logger.info("predictions written to %s", pred_dir)
        if not trainer.is_main:
            return {}
        metrics = evaluate_run(trainer, pred_dir)
        for k, v in metrics.items():
            logger.info("metric %s = %s", k, v)
        return metrics
    finally:
        if mesh.active():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main(sys.argv[1:])
