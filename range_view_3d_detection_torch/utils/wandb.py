"""W&B artifact utilities (counterpart of the JAX package's
``utils/wandb.py``, parity with ``src/torchbox3d/utils/wandb.py``).

The reference pulls model checkpoints and metric feathers from W&B
artifacts (``load_artifact`` 180-205, ``pull_wandb_feather`` 207-222). The
port logs metrics to JSONL by default; when the ``wandb`` package is
present these helpers give the same artifact surface, and without it they
raise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def _require_wandb():
    try:
        import wandb  # noqa: F401

        return wandb
    except ImportError as exc:
        raise RuntimeError(
            "wandb is not installed in this image; artifacts are stored "
            "locally under the run dir instead (checkpoints/ + metrics.jsonl)."
        ) from exc


def load_artifact(
    artifact_name: str, *, project: str, entity: Optional[str] = None
) -> Path:
    """Download a model-checkpoint artifact; returns the local directory."""
    wandb = _require_wandb()
    api = wandb.Api()
    ref = f"{entity + '/' if entity else ''}{project}/{artifact_name}"
    artifact = api.artifact(ref)
    return Path(artifact.download())


def log_artifact_dir(run, directory: str | Path, *, name: str, type_: str) -> None:
    """Upload a directory (predictions/metrics feathers) as an artifact."""
    wandb = _require_wandb()
    artifact = wandb.Artifact(name, type=type_)
    artifact.add_dir(str(directory))
    run.log_artifact(artifact)
