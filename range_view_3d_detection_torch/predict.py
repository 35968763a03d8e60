"""Standalone inference (the port's twin of ``tools/predict.py``): restore
a run's latest checkpoint, decode a split, write prediction shards.

    python -m range_view_3d_detection_torch.predict --ckpt-dir RUN \\
        [--split val] [--root-dir DIR] [--out-dir DIR] [--device cuda|cpu]

``RUN`` is a training run directory of the port (its ``config.json`` and
``checkpoints/``); the run's config names the data unless ``--root-dir``
does. The shards go to ``--out-dir``, else ``RUN/predictions``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Sequence


def main(argv: Sequence[str] | None = None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True, help="the training run directory")
    ap.add_argument("--split", default="val", choices=("val",),
                    help="the split decoded: val, as tools/predict.py decodes")
    ap.add_argument("--root-dir", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the run's trainer.device, else cuda)")
    args = ap.parse_args(argv)

    from range_view_3d_detection_torch.training.loop import Trainer

    run = Path(args.ckpt_dir)
    cfg = json.loads((run / "config.json").read_text())
    if args.root_dir:
        cfg["dataset"]["root_dir"] = args.root_dir
        for k in ("_train_dataset", "_val_dataset", "_test_dataset"):
            if k in cfg["dataset"]:
                cfg["dataset"][k]["root_dir"] = args.root_dir
    cfg["trainer"].setdefault("checkpoint", {}).setdefault("dir", str(run / "checkpoints"))
    cfg["trainer"]["checkpoint"]["enable"] = True
    cfg["model"]["debug"] = False
    cfg["run_dir"] = str(run)

    trainer = Trainer(cfg, device=args.device)
    if trainer.ckpt.latest_step() is None:
        raise FileNotFoundError(f"no checkpoint in {trainer.ckpt.directory}")
    # Restore without training: the latest checkpoint's state.
    trainer.state = trainer._init_state()
    out = trainer.validate(
        Path(args.out_dir) if args.out_dir else None, compute_losses=False
    )
    print(f"predictions written to {out}")
    return out


if __name__ == "__main__":
    main()
