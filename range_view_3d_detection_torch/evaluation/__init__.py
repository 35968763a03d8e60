"""Evaluation layer (reference: ``src/torchbox3d/evaluation/`` + the
``av2`` package's detection eval invoked at ``nn/arch/detector.py:472``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DetectionEvalConfig:
    """Per-dataset evaluation settings (``detection_cfg_factory``,
    ``src/torchbox3d/datasets/__init__.py:15-47``)."""

    dataset_name: str
    max_range_m: float
    eval_only_roi_instances: bool


def detection_cfg_factory(dataset_name: str) -> DetectionEvalConfig:
    if dataset_name == "av2":
        return DetectionEvalConfig("av2", 150.0, True)
    if dataset_name == "waymo":
        return DetectionEvalConfig("waymo", float("inf"), False)
    if dataset_name.startswith("nuscenes"):
        return DetectionEvalConfig(dataset_name, 55.0, False)
    raise NotImplementedError(dataset_name)
