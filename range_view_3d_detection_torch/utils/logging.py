"""Metrics logging to JSONL (counterpart of the JAX ``utils/logging.py``).

The JSONL sink is the JAX package's. ``backend="tensorboard"`` needs
tensorboard, which the port does not depend on: where it is missing the
logger raises instead of quietly logging nothing (the JAX logger falls
back to JSONL alone).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict


class MetricsLogger:
    def __init__(
        self,
        save_dir: str | Path,
        *,
        backend: str = "jsonl",
        enabled: bool = True,
    ):
        # enabled=False opens no files and drops every record.
        self.enabled = enabled
        self.save_dir = Path(save_dir)
        self._jsonl = None
        self._tb = None
        if not enabled:
            return
        if backend == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as exc:
                raise RuntimeError(
                    "logger backend 'tensorboard' needs the tensorboard package, "
                    "which this host lacks; use backend 'jsonl'"
                ) from exc
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.save_dir / "metrics.jsonl", "a")
        if backend == "tensorboard":
            self._tb = SummaryWriter(log_dir=str(self.save_dir))

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if not self.enabled:
            return
        scalars = {k: float(v) for k, v in metrics.items() if _is_scalar(v)}
        record = {"step": int(step), "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def _is_scalar(v: Any) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False
