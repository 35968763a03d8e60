"""Ground-truth database: its construction and the copy-paste sampler
(the port's copy of the JAX ``data/database.py``: the same crops, catalog
and draws, bit for bit, on the port's Feather IO and numpy rotated IoU).

Capability parity with the reference's GT-paste pipeline
(``prototype/loader.py::sample_database`` 708-789 and ``_load_db``
291-296): sample per-category boxes from an offline database, reject
samples that collide (rotated-BEV IoU) with scene annotations or each
other, scatter their points into the range image by raveled pixel index
(nearest-range wins across samples, occlusion-unaware vs. the scene —
matching the reference's overwrite semantics), and append their boxes.

The reference assumes a prebuilt ``db/`` directory; :func:`build_database`
constructs one from a converted train split (per-annotation point crops
keyed by category + row number).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from range_view_3d_detection_torch.evaluation.iou_np import iou_rotated_bev_np
from range_view_3d_detection_torch.utils.feather import read_feather, write_feather

logger = logging.getLogger(__name__)

DB_BOX_COLUMNS = (
    "tx_m",
    "ty_m",
    "tz_m",
    "length_m",
    "width_m",
    "height_m",
    "qw",
    "qx",
    "qy",
    "qz",
)


def _np_quat_to_yaw(qw, qx, qy, qz):
    return np.arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy**2 + qz**2))


def _bev_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return iou_rotated_bev_np(a, b)


def _boxes_bev(frame: Dict[str, np.ndarray]) -> np.ndarray:
    yaw = _np_quat_to_yaw(frame["qw"], frame["qx"], frame["qy"], frame["qz"])
    return np.stack(
        [frame["tx_m"], frame["ty_m"], frame["length_m"], frame["width_m"], yaw],
        axis=-1,
    ).astype(np.float32)


def build_database(
    root_dir: str | Path,
    db_dir: str | Path,
    *,
    height: int,
    width: int,
    feature_columns: Sequence[str],
    split: str = "train",
    min_interior_pts: int = 5,
) -> None:
    """Crop per-annotation range-view points into a paste database.

    Writes ``db/db.feather`` (box catalog with row_nr) and
    ``db/train/<category>/<row_nr>.feather`` point crops carrying the sweep
    feature columns + the raveled pixel ``index``.
    """
    root, db = Path(root_dir), Path(db_dir)
    catalog: Dict[str, List] = {k: [] for k in DB_BOX_COLUMNS}
    catalog.update({"category": [], "num_interior_pts": [], "row_nr": []})
    row_nr = 0
    for log_path in sorted((root / split).glob("*")):
        ann_path = log_path / "annotations.feather"
        if not ann_path.is_file():
            continue
        ann = read_feather(ann_path)
        sweeps = {
            int(p.stem): p
            for p in (log_path / "sensors" / "range_view").glob("*.feather")
        }
        for ts in np.unique(ann["timestamp_ns"]):
            if int(ts) not in sweeps:
                continue
            sweep = read_feather(sweeps[int(ts)])
            xyz = np.stack([sweep["x"], sweep["y"], sweep["z"]], axis=-1)
            valid = sweep["range"] > 0
            sel = ann["timestamp_ns"] == ts
            yaw = _np_quat_to_yaw(
                ann["qw"][sel], ann["qx"][sel], ann["qy"][sel], ann["qz"][sel]
            )
            for i in range(int(sel.sum())):
                idx = np.nonzero(sel)[0][i]
                c, s = np.cos(yaw[i]), np.sin(yaw[i])
                ctr = np.array(
                    [ann["tx_m"][idx], ann["ty_m"][idx], ann["tz_m"][idx]]
                )
                dims = np.array(
                    [
                        ann["length_m"][idx],
                        ann["width_m"][idx],
                        ann["height_m"][idx],
                    ]
                )
                d = xyz - ctr
                lx = c * d[:, 0] + s * d[:, 1]
                ly = -s * d[:, 0] + c * d[:, 1]
                inside = (
                    valid
                    & (np.abs(lx) <= dims[0] / 2)
                    & (np.abs(ly) <= dims[1] / 2)
                    & (np.abs(d[:, 2]) <= dims[2] / 2)
                )
                n = int(inside.sum())
                if n < min_interior_pts:
                    continue
                cat = str(ann["category"][idx])
                crop = {
                    col: sweep[col][inside].astype(np.float32)
                    for col in feature_columns
                    if col in sweep
                }
                crop["index"] = np.nonzero(inside)[0].astype(np.int64)
                crop["range"] = sweep["range"][inside].astype(np.float32)
                for col in ("x", "y", "z"):
                    crop[col] = sweep[col][inside].astype(np.float32)
                write_feather(db / split / cat / f"{row_nr}.feather", crop)
                for k in DB_BOX_COLUMNS:
                    catalog[k].append(float(ann[k][idx]))
                catalog["category"].append(cat)
                catalog["num_interior_pts"].append(n)
                catalog["row_nr"].append(row_nr)
                row_nr += 1
    write_feather(
        db / "db.feather", {k: np.asarray(v) for k, v in catalog.items()}
    )
    logger.info("built database with %d crops at %s", row_nr, db)


class DatabaseSampler:
    """Paste sampler over a built database (``sample_database`` parity)."""

    def __init__(self, db_dir: str | Path, split: str = "train"):
        self.db_dir = Path(db_dir)
        self.split = split
        db = read_feather(self.db_dir / "db.feather")
        keep = db["num_interior_pts"] > 0
        self.catalog = {k: v[keep] for k, v in db.items()}

    def sample(
        self,
        sweep: Dict[str, np.ndarray],
        boxes: np.ndarray,
        box_cats: np.ndarray,
        config: Dict[str, int],
        rng: np.random.Generator,
        *,
        feature_columns: Sequence[str],
        feature_transform=None,
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        """Paste sampled crops into the sweep image dict.

        Args:
            sweep: {features (H,W,F), cart (H,W,3), range (H,W), mask (H,W)}.
            boxes: (N, 7) scene cuboids.
            box_cats: (N,) scene category names.
            config: {category: num_samples}.

        Returns:
            (sweep, boxes, categories) with pasted samples appended.
        """
        cat_col = self.catalog["category"]
        picks: List[int] = []
        for cat, n in config.items():
            pool = np.nonzero(cat_col == cat)[0]
            if len(pool) == 0 or n <= 0:
                continue
            picks.extend(
                rng.choice(pool, size=min(n, len(pool)), replace=False)
            )
        if not picks:
            return sweep, boxes, box_cats
        picks = np.asarray(picks)

        cand_bev = _boxes_bev({k: v[picks] for k, v in self.catalog.items()})
        # Reject candidates intersecting scene boxes (loader.py:726-728).
        if len(boxes):
            scene_bev = boxes[:, [0, 1, 3, 4, 6]].astype(np.float32)
            ious = _bev_iou_np(scene_bev, cand_bev)
            picks = picks[(ious > 0).sum(axis=0) == 0]
            cand_bev = _boxes_bev({k: v[picks] for k, v in self.catalog.items()})
        if len(picks) == 0:
            return sweep, boxes, box_cats
        # Reject mutually intersecting candidates (loader.py:730-732).
        self_iou = _bev_iou_np(cand_bev, cand_bev)
        keep = (self_iou > 0).sum(axis=0) == 1
        picks = picks[keep]
        if len(picks) == 0:
            return sweep, boxes, box_cats

        H, W = sweep["range"].shape
        crops = []
        for p in picks:
            cat = str(self.catalog["category"][p])
            nr = int(self.catalog["row_nr"][p])
            crop = read_feather(self.db_dir / self.split / cat / f"{nr}.feather")
            crops.append(crop)

        # Nearest-range-wins across samples (sort by range, first write wins
        # via unique-first — loader.py:745-748).
        all_idx = np.concatenate([c["index"] for c in crops])
        all_rng = np.concatenate([c["range"] for c in crops])
        all_crop = np.concatenate(
            [np.full(len(c["index"]), i) for i, c in enumerate(crops)]
        )
        order = np.lexsort((all_rng, all_idx))
        first = np.ones(len(order), bool)
        sorted_idx = all_idx[order]
        first[1:] = sorted_idx[1:] != sorted_idx[:-1]
        sel = order[first]

        # Drop crops whose every pixel lost the dedupe: their boxes would
        # have zero supporting points (reference keeps only valid_nr —
        # loader.py:745-751) and the model would train on invisible
        # objects.
        survived = np.zeros(len(crops), bool)
        survived[np.unique(all_crop[sel])] = True
        if not survived.all():
            picks = picks[survived]
            if len(picks) == 0:
                return sweep, boxes, box_cats

        rows, cols = np.unravel_index(all_idx[sel], (H, W))
        missing = [c for c in feature_columns if c not in crops[0]]
        if missing:
            raise ValueError(
                f"GT-paste crops lack feature column(s) {missing}; derived "
                "channels (e.g. 'view') are not supported with "
                "enable_database — rebuild the database with those columns "
                "or drop them from feature_column_names"
            )
        feat_cols = {
            col: np.concatenate([c[col] for c in crops])[sel]
            for col in feature_columns
        }
        if feature_transform is not None:
            # Per-dataset normalization (Waymo tanh intensity, timedelta
            # scaling) that load_sweep applied to the scene pixels; raw
            # crop values must match.
            feat_cols = feature_transform(feat_cols)
        feat_stack = np.stack(
            [feat_cols[col] for col in feature_columns], axis=-1
        )
        cart_stack = np.stack(
            [np.concatenate([c[col] for c in crops])[sel] for col in ("x", "y", "z")],
            axis=-1,
        )
        sweep["features"][rows, cols] = feat_stack
        sweep["cart"][rows, cols] = cart_stack
        sweep["range"][rows, cols] = all_rng[sel]
        sweep["mask"][rows, cols] = all_rng[sel] > 0

        yaw = _np_quat_to_yaw(
            self.catalog["qw"][picks],
            self.catalog["qx"][picks],
            self.catalog["qy"][picks],
            self.catalog["qz"][picks],
        )
        new_boxes = np.stack(
            [
                self.catalog["tx_m"][picks],
                self.catalog["ty_m"][picks],
                self.catalog["tz_m"][picks],
                self.catalog["length_m"][picks],
                self.catalog["width_m"][picks],
                self.catalog["height_m"][picks],
                yaw,
            ],
            axis=-1,
        ).astype(np.float32)
        boxes = np.concatenate([boxes, new_boxes]) if len(boxes) else new_boxes
        box_cats = np.concatenate(
            [box_cats, self.catalog["category"][picks]]
        ) if len(box_cats) else self.catalog["category"][picks]
        return sweep, boxes, box_cats
