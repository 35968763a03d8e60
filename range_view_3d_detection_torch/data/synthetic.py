"""Synthetic range-view dataset generator (the port's copy of the JAX
``data/synthetic.py``).

Writes the exact on-disk layout produced by the reference converters
(``converters/av2/export.py:31-163``):

    root/<split>/<log_id>/sensors/range_view/<timestamp_ns>.feather
    root/<split>/<log_id>/annotations.feather

Scenes contain randomly placed cuboids with LiDAR-like returns (points on
box surfaces + ground/background clutter), projected through the same
spherical z-buffer the real converter uses. Used by the test suite, the
debug-overfit path, and the benchmark harness — this image has no AV2/Waymo
data or their SDKs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

from range_view_3d_detection_torch.ops.projection import z_buffer_numpy
from range_view_3d_detection_torch.utils.feather import write_feather


def _yaw_to_quat_np(yaw):
    return np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)


def _sample_scene(
    rng: np.random.Generator,
    categories: Sequence[str],
    *,
    num_boxes: int,
    num_bg_points: int,
):
    n = num_boxes
    az = rng.uniform(-np.pi, np.pi, n)
    dist = rng.uniform(8, 50, n)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0] = dist * np.cos(az)
    boxes[:, 1] = dist * np.sin(az)
    boxes[:, 2] = rng.uniform(0.5, 1.2, n)
    boxes[:, 3] = rng.uniform(3.0, 6.0, n)
    boxes[:, 4] = rng.uniform(1.6, 2.6, n)
    boxes[:, 5] = rng.uniform(1.4, 2.2, n)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    cats = rng.choice(list(categories), n)

    # Points on the two visible faces of each box.
    pts_list, owner = [], []
    for k in range(n):
        m = rng.integers(60, 200)
        face = rng.integers(0, 2, m)
        u = rng.uniform(-0.5, 0.5, m)
        v = rng.uniform(-0.5, 0.5, m)
        local = np.zeros((m, 3))
        # face 0: long side; face 1: short side.
        local[face == 0, 0] = u[face == 0] * boxes[k, 3]
        local[face == 0, 1] = -boxes[k, 4] / 2
        local[face == 1, 0] = -boxes[k, 3] / 2
        local[face == 1, 1] = u[face == 1] * boxes[k, 4]
        local[:, 2] = v * boxes[k, 5]
        c, s = np.cos(boxes[k, 6]), np.sin(boxes[k, 6])
        world = np.stack(
            [
                c * local[:, 0] - s * local[:, 1] + boxes[k, 0],
                s * local[:, 0] + c * local[:, 1] + boxes[k, 1],
                local[:, 2] + boxes[k, 2],
            ],
            axis=-1,
        )
        pts_list.append(world)
        owner.append(np.full(m, k))

    # Background: ground plane + far clutter.
    bg_az = rng.uniform(-np.pi, np.pi, num_bg_points)
    bg_r = rng.uniform(3, 80, num_bg_points)
    bg = np.stack(
        [
            bg_r * np.cos(bg_az),
            bg_r * np.sin(bg_az),
            rng.uniform(-1.8, 4.0, num_bg_points),
        ],
        axis=-1,
    )
    pts = np.concatenate(pts_list + [bg]).astype(np.float32)
    owner = np.concatenate(owner + [np.full(num_bg_points, -1)])
    return boxes, cats, pts, owner


def generate_dataset(
    root_dir: str | Path,
    *,
    splits: Dict[str, int] = None,
    sweeps_per_log: int = 4,
    height: int = 32,
    width: int = 248,  # + 2*4 av2 padding = 256, divisible by 16
    categories: Sequence[str] = ("REGULAR_VEHICLE", "PEDESTRIAN"),
    num_boxes: int = 6,
    num_bg_points: int = 4000,
    seed: int = 0,
    dataset_name: str = "av2",
) -> Path:
    """Generate a synthetic converter-layout dataset. Returns the sensor
    root.

    ``dataset_name="waymo"`` writes the Waymo converter's 6-channel sweep
    schema instead (``converters/waymo/export.py``: + ``elongation``, no
    ``is_within_roi`` — WOD has no ROI concept; reference
    ``conf/experiment/rv-waymo.yaml`` feature_column_names), for closing
    the WOD-protocol train->decode->evaluate_waymo loop without real data.
    """
    splits = splits or {"train": 1, "val": 1}
    root = Path(root_dir)
    rng = np.random.default_rng(seed)

    for split, num_logs in splits.items():
        for li in range(num_logs):
            log_id = f"{split}_log_{li:03d}"
            ann_cols: Dict[str, list] = {
                k: []
                for k in (
                    "timestamp_ns",
                    "category",
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
                    "num_interior_pts",
                )
            }
            for si in range(sweeps_per_log):
                ts = 1_000_000_000 * (si + 1)
                boxes, cats, pts, owner = _sample_scene(
                    rng,
                    categories,
                    num_boxes=num_boxes,
                    num_bg_points=num_bg_points,
                )
                rngs = np.linalg.norm(pts, axis=-1)
                az = np.arctan2(pts[:, 1], pts[:, 0])
                incl = np.arcsin(np.clip(pts[:, 2] / np.maximum(rngs, 1e-6), -1, 1))
                # Row: uniform inclination binning (synthetic "laser rows").
                lo, hi = -0.35, 0.25
                row = np.clip(
                    ((incl - lo) / (hi - lo) * height).astype(np.int64),
                    0,
                    height - 1,
                )
                col = ((az + np.pi) / (2 * np.pi) * width).astype(np.int64) % width

                intensity = rng.uniform(0, 1, len(pts)).astype(np.float32)
                values = np.concatenate(
                    [pts, intensity[:, None], rngs[:, None]], axis=-1
                ).astype(np.float32)
                img = z_buffer_numpy(
                    row, col, rngs, values, height=height, width=width
                )
                # Columns in the converter schema (converters/av2/utils.py:17-26).
                flat = img.reshape(-1, img.shape[-1])
                sweep_cols = {
                    "x": flat[:, 0],
                    "y": flat[:, 1],
                    "z": flat[:, 2],
                    "intensity": flat[:, 3],
                    "range": flat[:, 4],
                    "timedelta_ns": np.zeros(len(flat), np.float32),
                }
                if dataset_name == "waymo":
                    # Waymo sweeps carry pulse elongation (raw, like the
                    # converter writes it) and raw intensity (the loader
                    # tanh-normalizes); no ROI flags.
                    valid_px = (flat[:, 4] > 0).astype(np.float32)
                    sweep_cols["elongation"] = (
                        rng.uniform(0, 0.3, len(flat)).astype(np.float32)
                        * valid_px
                    )
                else:
                    sweep_cols["is_within_roi"] = (flat[:, 4] > 0).astype(
                        np.float32
                    )
                write_feather(
                    root
                    / split
                    / log_id
                    / "sensors"
                    / "range_view"
                    / f"{ts}.feather",
                    sweep_cols,
                )

                # Count interior points per box from the rasterized image.
                cart = flat[:, :3]
                valid = flat[:, 4] > 0
                qw, qx, qy, qz = _yaw_to_quat_np(boxes[:, 6].astype(np.float64))
                for k in range(len(boxes)):
                    c, s = np.cos(boxes[k, 6]), np.sin(boxes[k, 6])
                    d = cart - boxes[k, :3]
                    lx = c * d[:, 0] + s * d[:, 1]
                    ly = -s * d[:, 0] + c * d[:, 1]
                    inside = (
                        valid
                        & (np.abs(lx) <= boxes[k, 3] / 2)
                        & (np.abs(ly) <= boxes[k, 4] / 2)
                        & (np.abs(d[:, 2]) <= boxes[k, 5] / 2)
                    )
                    ann_cols["timestamp_ns"].append(np.int64(ts))
                    ann_cols["category"].append(str(cats[k]))
                    ann_cols["tx_m"].append(boxes[k, 0])
                    ann_cols["ty_m"].append(boxes[k, 1])
                    ann_cols["tz_m"].append(boxes[k, 2])
                    ann_cols["length_m"].append(boxes[k, 3])
                    ann_cols["width_m"].append(boxes[k, 4])
                    ann_cols["height_m"].append(boxes[k, 5])
                    ann_cols["qw"].append(np.float32(qw[k]))
                    ann_cols["qx"].append(np.float32(qx[k]))
                    ann_cols["qy"].append(np.float32(qy[k]))
                    ann_cols["qz"].append(np.float32(qz[k]))
                    ann_cols["num_interior_pts"].append(np.int64(inside.sum()))

            write_feather(
                root / split / log_id / "annotations.feather",
                {k: np.asarray(v) for k, v in ann_cols.items()},
            )
    return root
