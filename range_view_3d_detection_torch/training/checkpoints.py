"""Checkpoints of the train state with the config inside (counterpart of
the JAX ``training/checkpoints.py``, which uses orbax).

A checkpoint is one ``torch.save`` file, ``step_<step>.pt``, holding the
model's ``state_dict`` (parameters and BatchNorm statistics), the
optimizer's state (AdamW moments, the schedule's update count, the
accumulator), the step, and the config as a JSON string. It is read back
with ``weights_only=True``: tensors and plain containers only. Saves are
synchronous and atomic (written to a temporary file, then renamed); the
newest ``keep`` are kept.

Under a process group every rank calls ``save`` (a ZeRO-1 optimizer
gathers its moments there, a collective) and rank 0 writes; the file is
the one a single device writes, so a run resumes at any world size.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from range_view_3d_detection_torch.parallel import mesh
from range_view_3d_detection_torch.training.state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 2):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def steps(self) -> List[int]:
        return sorted(
            int(m[1]) for p in self.directory.iterdir() if (m := _NAME.match(p.name))
        )

    def save(self, step: int, state: TrainState, config: Dict[str, Any]) -> None:
        payload = {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.opt.state_dict(),
            "config": json.dumps(config),
        }
        if mesh.rank() == 0:
            tmp = self.directory / f".step_{step}.pt.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, self._path(step))
            for old in self.steps()[: -self.keep]:
                self._path(old).unlink()
        mesh.barrier()

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(
        self, state_template: TrainState, *, step: Optional[int] = None
    ) -> Tuple[TrainState, Dict[str, Any]]:
        """Load checkpoint ``step`` (the latest by default) into the
        template's model and optimizer, in place; returns (state, config)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        # Loaded to the host: load_state_dict moves each tensor to its
        # parameter's device (AdamW keeps its step counts on the host).
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state_template.model.load_state_dict(payload["model"], strict=True)
        state_template.opt.load_state_dict(payload["optimizer"])
        state_template.step = int(payload["step"])
        return state_template, json.loads(payload["config"])

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing to release."""
