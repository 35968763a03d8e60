"""nuScenes -> range-view feather converter (offline, host-side, SDK-free):
the port's copy of ``converters/nuscenes/export.py``, on the port's
Feather writer and native z-buffer.

    python -m range_view_3d_detection_torch.converters.nuscenes.export \\
        --src-root-dir NUSC --dst-root-dir OUT [--version v1.0-trainval]

The reference ships a nuScenes *config* (``conf/dataset/nuscenes.yaml``,
32 x 1800) but no converter; this fills the gap so the nuScenes
experiment surface is actually runnable. Reads the nuScenes on-disk
format directly (JSON relational tables + ``.pcd.bin`` point files) —
no nuscenes-devkit required.

Output is the AV2 directory layout every other part of the framework
consumes (``converters/av2/export.py`` semantics):

    dst/<split>/<scene_name>/sensors/range_view/<timestamp_ns>.feather
    dst/<split>/<scene_name>/annotations.feather
    dst/<split>/<scene_name>/city_SE3_egovehicle.feather

- Rows come from the 32-beam ``ring`` index shipped per point (no
  z-ordering tables needed: nuScenes points carry their beam id).
- Columns from sensor-frame azimuth; nearest-return z-buffer.
- Point coordinates are written in the EGO frame (calibrated_sensor
  transform applied), matching the AV2 exporter's frame convention.
- Annotations (global frame in nuScenes) are re-expressed in the ego
  frame at their sample timestamp; ``num_interior_pts`` is computed from
  the sweep's points. Categories map to the competition's 10 classes
  (reference ``NuscenesCompetitionCategories``,
  ``datasets/argoverse/constants.py:20-32``).
"""

from __future__ import annotations

import argparse
import json
import logging
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from range_view_3d_detection_torch.data.native_io import z_buffer_native
from range_view_3d_detection_torch.utils.feather import write_feather

logger = logging.getLogger("nuscenes_export")

HEIGHT, WIDTH = 32, 1800

OUTPUT_COLUMNS = (
    "x",
    "y",
    "z",
    "intensity",
    "laser_number",
    "is_within_roi",
    "timedelta_ns",
    "range",
)

# nuScenes detection-challenge mapping (10 competition classes).
CATEGORY_MAP = {
    "vehicle.car": "CAR",
    "vehicle.truck": "TRUCK",
    "vehicle.bus.bendy": "BUS",
    "vehicle.bus.rigid": "BUS",
    "vehicle.trailer": "TRAILER",
    "vehicle.construction": "CONSTRUCTION_VEHICLE",
    "human.pedestrian.adult": "PEDESTRIAN",
    "human.pedestrian.child": "PEDESTRIAN",
    "human.pedestrian.construction_worker": "PEDESTRIAN",
    "human.pedestrian.police_officer": "PEDESTRIAN",
    "vehicle.motorcycle": "MOTORCYCLE",
    "vehicle.bicycle": "BICYCLE",
    "movable_object.trafficcone": "TRAFFIC_CONE",
    "movable_object.barrier": "BARRIER",
}


def _quat_to_mat(q) -> np.ndarray:
    """nuScenes [w, x, y, z] quaternion -> 3x3 rotation."""
    w, x, y, z = (float(v) for v in q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _mat_to_quat(m: np.ndarray):
    """3x3 rotation -> (w, x, y, z)."""
    from scipy.spatial.transform import Rotation

    x, y, z, w = Rotation.from_matrix(m).as_quat()
    return w, x, y, z


class Tables:
    """The subset of nuScenes relational tables the converter needs."""

    def __init__(self, root: Path, version: str):
        tdir = root / version

        def load(name):
            return json.loads((tdir / f"{name}.json").read_text())

        self.scene = load("scene")
        self.sample = {s["token"]: s for s in load("sample")}
        self.sample_data = load("sample_data")
        self.ego_pose = {p["token"]: p for p in load("ego_pose")}
        self.calibrated_sensor = {
            c["token"]: c for c in load("calibrated_sensor")
        }
        self.category = {c["token"]: c["name"] for c in load("category")}
        self.instance = {i["token"]: i for i in load("instance")}
        self.sample_annotation = defaultdict(list)
        for a in load("sample_annotation"):
            self.sample_annotation[a["sample_token"]].append(a)
        # Keyframe LIDAR_TOP sample_data per sample.
        self.lidar_by_sample: Dict[str, dict] = {}
        for sd in self.sample_data:
            if sd.get("is_key_frame") and "LIDAR_TOP" in sd.get(
                "filename", ""
            ):
                self.lidar_by_sample[sd["sample_token"]] = sd


def load_points(root: Path, filename: str) -> np.ndarray:
    """``.pcd.bin`` -> (N, 5): x, y, z, intensity, ring."""
    raw = np.fromfile(root / filename, dtype=np.float32)
    return raw.reshape(-1, 5)


def build_range_view(
    pts_sensor: np.ndarray,
    sensor_from_ego_rot: np.ndarray,
    sensor_t: np.ndarray,
    *,
    height: int = HEIGHT,
    width: int = WIDTH,
) -> Dict[str, np.ndarray]:
    """Project one sweep; rows from ring index, columns from sensor-frame
    azimuth; output coordinates in the EGO frame."""
    ring = pts_sensor[:, 4].astype(np.int64)
    keep = (ring >= 0) & (ring < height)
    pts_sensor = pts_sensor[keep]
    ring = ring[keep]

    xyz_s = pts_sensor[:, :3].astype(np.float64)
    az = np.arctan2(xyz_s[:, 1], xyz_s[:, 0])
    col = ((az + np.pi) / (2 * np.pi) * width).astype(np.int64) % width

    # Ego-frame coordinates (ego = R @ sensor + t).
    xyz_e = xyz_s @ sensor_from_ego_rot.T + sensor_t
    rng = np.linalg.norm(xyz_e, axis=-1)

    values = np.stack(
        [
            xyz_e[:, 0],
            xyz_e[:, 1],
            xyz_e[:, 2],
            pts_sensor[:, 3],
            ring.astype(np.float64),
            np.ones(len(ring)),
            np.zeros(len(ring)),
            rng,
        ],
        axis=-1,
    ).astype(np.float32)
    img = z_buffer_native(
        ring, col, rng.astype(np.float32), values, height=height, width=width
    )
    flat = img.reshape(-1, img.shape[-1])
    return {name: flat[:, i] for i, name in enumerate(OUTPUT_COLUMNS)}


def build_annotations(
    anns: List[dict],
    tables: Tables,
    ego_from_global_rot: np.ndarray,
    ego_from_global_t: np.ndarray,
    timestamp_ns: int,
    xyz_ego: Optional[np.ndarray],
) -> Dict[str, np.ndarray]:
    cols: Dict[str, List] = defaultdict(list)
    for a in anns:
        inst = tables.instance[a["instance_token"]]
        name = tables.category[inst["category_token"]]
        cat = CATEGORY_MAP.get(name)
        if cat is None:
            continue
        # Global -> ego.
        center = ego_from_global_rot @ (
            np.asarray(a["translation"], np.float64) - ego_from_global_t
        )
        rot_global = _quat_to_mat(a["rotation"])
        rot_ego = ego_from_global_rot @ rot_global
        qw, qx, qy, qz = _mat_to_quat(rot_ego)
        w, l, h = (float(v) for v in a["size"])  # nuScenes order: w, l, h

        if xyz_ego is not None and len(xyz_ego):
            local = (xyz_ego - center) @ rot_ego
            inside = (
                (np.abs(local[:, 0]) <= l / 2)
                & (np.abs(local[:, 1]) <= w / 2)
                & (np.abs(local[:, 2]) <= h / 2)
            )
            n_pts = int(inside.sum())
        else:
            n_pts = int(a.get("num_lidar_pts", 0))

        cols["timestamp_ns"].append(np.int64(timestamp_ns))
        cols["category"].append(cat)
        cols["tx_m"].append(center[0])
        cols["ty_m"].append(center[1])
        cols["tz_m"].append(center[2])
        cols["length_m"].append(l)
        cols["width_m"].append(w)
        cols["height_m"].append(h)
        cols["qw"].append(qw)
        cols["qx"].append(qx)
        cols["qy"].append(qy)
        cols["qz"].append(qz)
        cols["num_interior_pts"].append(np.int64(n_pts))
    return {k: np.asarray(v) for k, v in cols.items()}


def export_scene(
    root: Path,
    tables: Tables,
    scene: dict,
    dst_log_dir: Path,
    *,
    height: int = HEIGHT,
    width: int = WIDTH,
) -> int:
    ann_parts: List[Dict[str, np.ndarray]] = []
    pose_cols: Dict[str, List] = defaultdict(list)

    token = scene["first_sample_token"]
    n = 0
    while token:
        sample = tables.sample[token]
        sd = tables.lidar_by_sample.get(token)
        if sd is None:
            token = sample["next"]
            continue
        ts_ns = int(sample["timestamp"]) * 1000

        calib = tables.calibrated_sensor[sd["calibrated_sensor_token"]]
        sensor_rot = _quat_to_mat(calib["rotation"])
        sensor_t = np.asarray(calib["translation"], np.float64)

        pts = load_points(root, sd["filename"])
        cols = build_range_view(
            pts, sensor_rot, sensor_t, height=height, width=width
        )
        write_feather(
            dst_log_dir / "sensors" / "range_view" / f"{ts_ns}.feather", cols
        )

        pose = tables.ego_pose[sd["ego_pose_token"]]
        g_rot = _quat_to_mat(pose["rotation"])  # global <- ego
        g_t = np.asarray(pose["translation"], np.float64)
        qw, qx, qy, qz = _mat_to_quat(g_rot)
        pose_cols["timestamp_ns"].append(np.int64(ts_ns))
        for k, v in zip(("qw", "qx", "qy", "qz"), (qw, qx, qy, qz)):
            pose_cols[k].append(v)
        for k, v in zip(("tx_m", "ty_m", "tz_m"), g_t):
            pose_cols[k].append(v)

        xyz_ego = np.stack(
            [cols["x"], cols["y"], cols["z"]], axis=-1
        ).astype(np.float64)
        xyz_ego = xyz_ego[cols["range"] > 0]
        ann_parts.append(
            build_annotations(
                tables.sample_annotation.get(token, []),
                tables,
                g_rot.T,
                g_t,
                ts_ns,
                xyz_ego,
            )
        )
        n += 1
        token = sample["next"]

    merged: Dict[str, List[np.ndarray]] = defaultdict(list)
    for part in ann_parts:
        for k, v in part.items():
            merged[k].append(v)
    if any(len(v) for v in merged.values()):
        ann_out = {k: np.concatenate(v) for k, v in merged.items()}
    else:
        # A scene whose annotations are all unmapped categories must still
        # produce a schema-complete (empty) table: the dataset index build
        # and GT loaders read annotations.feather unconditionally.
        ann_out = {
            "timestamp_ns": np.zeros(0, np.int64),
            "category": np.zeros(0, dtype="<U32"),
            **{
                k: np.zeros(0, np.float64)
                for k in (
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
            },
            "num_interior_pts": np.zeros(0, np.int64),
        }
    if n > 0:
        write_feather(dst_log_dir / "annotations.feather", ann_out)
    if pose_cols:
        write_feather(
            dst_log_dir / "city_SE3_egovehicle.feather",
            {k: np.asarray(v) for k, v in pose_cols.items()},
        )
    return n


def export_dataset(
    src_root_dir: str,
    dst_root_dir: str,
    *,
    version: str = "v1.0-trainval",
    height: int = HEIGHT,
    width: int = WIDTH,
    split_map: Optional[Dict[str, str]] = None,
) -> None:
    """Convert every scene; scenes land in ``<dst>/<split>/<scene_name>``.

    nuScenes defines train/val by scene-name lists; without the devkit we
    accept an explicit ``split_map`` (scene name -> split) and default
    everything to ``train``.
    """
    root, dst = Path(src_root_dir), Path(dst_root_dir)
    tables = Tables(root, version)
    for scene in tables.scene:
        split = (split_map or {}).get(scene["name"], "train")
        n = export_scene(
            root,
            tables,
            scene,
            dst / split / scene["name"],
            height=height,
            width=width,
        )
        logger.info("exported %s (%d sweeps)", scene["name"], n)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--src-root-dir", required=True)
    ap.add_argument("--dst-root-dir", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--width", type=int, default=WIDTH)
    args = ap.parse_args()
    export_dataset(
        args.src_root_dir,
        args.dst_root_dir,
        version=args.version,
        height=args.height,
        width=args.width,
    )
