"""Build typed framework objects from a composed ``conf/`` dict (the
port's counterpart of the JAX ``training/builders.py``).

The reference instantiates everything with ``hydra.utils.instantiate`` on
``_target_`` classes (``scripts/train.py:70-79``); here, as in the JAX
package, the composed YAML dict is translated into the port's frozen
dataclass configs, field for field the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from range_view_3d_detection_torch.data.dataset import (
    DatasetConfig,
    RangeViewConfig,
)
from range_view_3d_detection_torch.models.decoder import DecoderConfig
from range_view_3d_detection_torch.models.detector import (
    DetectorConfig,
    TargetsConfig,
)


def _as_float(v) -> float:
    if v is None:
        return float("inf")
    if isinstance(v, str):
        if v.strip(".").lower() in ("inf", "infinity"):
            return float("inf")
        return float(v)
    return float(v)


def _tasks_tuple(tasks: Dict[Any, Any]) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    return tuple(
        (int(k), tuple(sorted(v))) for k, v in sorted(tasks.items(), key=lambda kv: int(kv[0]))
    )


def build_detector_config(cfg: Dict[str, Any]) -> DetectorConfig:
    m = cfg["model"]
    bb = m["_backbone"]
    hd = m["_head"]
    tc = hd["targets_config"]

    fpn = tuple(sorted((int(k), int(v)) for k, v in hd["fpn"].items()))
    fks = tuple(
        sorted(
            (int(k), tuple(int(x) for x in v))
            for k, v in hd["fpn_kernel_sizes"].items()
        )
    )
    rp = tuple(
        sorted(
            (int(k), (_as_float(v[0]), _as_float(v[1])))
            for k, v in (tc.get("range_partitions") or {}).items()
        )
    )
    pi = tuple(
        sorted(
            (int(k), (_as_float(v[0]), _as_float(v[1])))
            for k, v in (tc.get("point_intervals") or {}).items()
        )
    )
    targets = TargetsConfig(
        enable_azimuth_invariant_targets=bool(
            tc.get("enable_azimuth_invariant_targets", True)
        ),
        fpn_assignment_method=tc.get("fpn_assignment_method"),
        range_partitions=rp,
        point_intervals=pi,
        affinity_fn=str(tc.get("affinity_fn", "GAUSSIAN")),
        sigma=float(tc.get("sigma", 0.75)),
        normalize_affinities=bool(tc.get("normalize_affinities", False)),
        k=_as_float(tc.get("k", float("inf"))),
    )
    cls_loss = hd.get("_cls_loss", {})
    return DetectorConfig(
        tasks=_tasks_tuple(m["tasks"]),
        in_channels=int(bb["in_channels"]),
        layers=tuple(int(x) for x in bb["layers"]),
        stem_type=str(bb.get("stem_type", "BASIC")),
        num_neighbors=int(bb.get("num_neighbors", 3)),
        num_stem_layers=int(bb.get("num_layers", 2)),
        stem_pallas=bool(bb.get("stem_pallas", False)),
        projection_kernel_size=int(bb.get("projection_kernel_size", 1)),
        fpn=fpn,
        fpn_kernel_sizes=fks,
        classification_head_channels=int(hd["classification_head_channels"]),
        regression_head_channels=int(hd["regression_head_channels"]),
        num_classification_blocks=int(hd.get("num_classification_blocks", 4)),
        num_regression_blocks=int(hd.get("num_regression_blocks", 4)),
        final_kernel_size=int(hd.get("final_kernel_size", 1)),
        classification_weight=float(hd.get("classification_weight", 1.0)),
        regression_weight=float(hd.get("regression_weight", 1.0)),
        coding_weights=tuple(
            float(x) for x in hd.get("coding_weights", [1.0] * 8)
        ),
        vfl_alpha=float(cls_loss.get("alpha", 0.75)),
        vfl_gamma=float(cls_loss.get("gamma", 2.0)),
        targets=targets,
        max_boxes=int(m.get("max_boxes", 256)),
        dtype="bfloat16" if str(m.get("precision", "bfloat16")).startswith("bf") else "float32",
        # Checkpointed groups during training (models/detector.py).
        remat=bool(m.get("remat", False)),
        remat_scope=tuple(
            str(s)
            for s in m.get(
                "remat_scope", ("stem", "stages", "heads", "loss")
            )
        ),
    )


def build_decoder_config(cfg: Dict[str, Any]) -> DecoderConfig:
    """The decoder's config. ``post_processing_config.num_pre_nms`` is
    accepted and dropped: the port's ``DecoderConfig`` has no such field,
    and the JAX package carries it without reading it (the static
    ``nms_cap`` bounds the proposals in both)."""
    m = cfg["model"]
    d = m["_decoder"]
    pp = m["post_processing_config"]
    return DecoderConfig(
        enable_azimuth_invariant_targets=bool(
            d.get("enable_azimuth_invariant_targets", True)
        ),
        enable_sample_by_range=bool(d.get("enable_sample_by_range", True)),
        lower_bounds=tuple(_as_float(x) for x in d["lower_bounds"]),
        upper_bounds=tuple(_as_float(x) for x in d["upper_bounds"]),
        subsampling_rates=tuple(int(x) for x in d["subsampling_rates"]),
        num_post_nms=int(pp.get("num_post_nms", 1000)),
        nms_threshold=float(pp.get("nms_threshold", 0.3)),
        min_confidence=float(pp.get("min_confidence", 0.1)),
        nms_mode=str(pp.get("nms_mode", "WEIGHTED")),
        nms_cap=int(pp.get("nms_cap", 2048)),
    )


def build_dataset_config(cfg: Dict[str, Any], split: str) -> DatasetConfig:
    ds = cfg["dataset"]
    key = {"train": "_train_dataset", "val": "_val_dataset", "test": "_test_dataset"}[
        split
    ]
    d = ds[key]
    rv = d["range_view_config"]
    feature_names = tuple(
        rv.get(
            "feature_column_names",
            cfg["dataset"]["_train_dataset"]["range_view_config"].get(
                "feature_column_names", ("intensity", "range", "x", "y", "z")
            ),
        )
    )
    return DatasetConfig(
        root_dir=str(d["root_dir"]),
        dataset_name=str(d["dataset_name"]),
        split_name=str(d["split_name"]),
        range_view=RangeViewConfig(
            height=int(rv["height"]),
            width=int(rv["width"]),
            feature_column_names=feature_names,
            filter_roi=bool(rv.get("filter_roi", False)),
        ),
        tasks={int(k): tuple(sorted(v)) for k, v in cfg["model"]["tasks"].items()},
        max_boxes=int(cfg["model"].get("max_boxes", 256)),
        subsampling_rate=int(d.get("subsampling_rate", 1)),
        x_stride=int(d.get("x_stride", 1)),
        padding_mode=str(d.get("padding_mode", "constant")),
        augmentations=(
            cfg["model"].get("augmentations_config")
            if split == "train"
            else None
        ),
        use_median_filter=bool(d.get("use_median_filter", False)),
        use_repeat_factor_sampling=bool(
            d.get("use_repeat_factor_sampling", False)
        ),
        min_points_filter=int(d.get("min_points_filter", 0)),
        enable_database=bool(
            cfg["model"].get("enable_database", False) and split == "train"
        ),
        db_config=cfg["model"].get("db_config"),
    )
