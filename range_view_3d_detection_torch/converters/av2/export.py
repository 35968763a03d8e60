"""AV2 -> range-view feather converter (offline, host-side): the port's
copy of ``converters/av2/export.py``, on the port's Feather reader (which
takes the LZ4-compressed, ``float16`` and dictionary columns real logs
carry), its native z-buffer (``data/native_io.py``) and its ROI raster
(``evaluation/roi.py``).

    python -m range_view_3d_detection_torch.converters.av2.export \\
        --src-root-dir RAW --dst-root-dir OUT [--height 64] [--width 1800]

Capability parity with the reference ``converters/av2/export.py`` (31-163)
and ``converters/av2/utils.py`` (32-295), re-implemented without the av2
SDK: raw AV2 sensor logs are themselves feather/JSON files, read directly.

Per sweep:
  1. load ``sensors/lidar/<ts>.feather`` (x, y, z, intensity, laser_number,
     offset_ns),
  2. select the beam subset (up/down 32-beam LiDAR -> 64 rows, or upper 32),
  3. undo per-point ego-motion compensation by SLERP-interpolating the city
     pose to each point's capture time and re-projecting into the sweep
     frame (``unmotion_compensate``, utils.py:95-184) — so the cloud matches
     raw capture geometry and projects onto a clean grid,
  4. map laser_number -> image row (ROW_MAPPING tables, with per-log
     corrections), azimuth -> column, nearest-return z-buffer,
  5. write ``sensors/range_view/<ts>.feather`` with columns
     x, y, z, intensity, laser_number, is_within_roi, timedelta_ns, range
     (``converters/av2/utils.py:17-26``),
  6. copy ``annotations.feather`` and compute ``num_interior_pts`` when the
     source lacks it.

The ROI flag requires the HD map rasters; when absent every point is
flagged in-ROI (and AV2 eval's ROI filtering is skipped to match).
"""

from __future__ import annotations

import argparse
import logging
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from range_view_3d_detection_torch.converters.av2.log_corrections import correct_laser_numbers
from range_view_3d_detection_torch.converters.av2.row_mappings import (
    ROW_MAPPING_32,
    ROW_MAPPING_64,
)
from range_view_3d_detection_torch.data.native_io import z_buffer_native
from range_view_3d_detection_torch.evaluation.roi import load_roi_map, slerp_poses
from range_view_3d_detection_torch.utils.feather import read_feather, write_feather

logger = logging.getLogger("av2_export")

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


def unmotion_compensate(
    xyz: np.ndarray,
    offsets_ns: np.ndarray,
    sweep_ts: int,
    poses: Dict[str, np.ndarray],
) -> np.ndarray:
    """Undo ego-motion compensation (utils.py ``unmotion_compensate``).

    AV2 points are stored motion-compensated to the sweep end; re-express
    each point in the ego frame at its own capture time so rows/azimuths
    line up with the physical scan pattern.
    """
    point_ts = sweep_ts + offsets_ns.astype(np.int64)
    city_from_ego_at_point = slerp_poses(poses, point_ts)
    city_from_ego_at_sweep = slerp_poses(poses, np.asarray([sweep_ts]))[0]

    # p_city = sweep_pose @ p ; p_raw = point_pose^-1 @ p_city
    homo = np.concatenate([xyz, np.ones((len(xyz), 1))], axis=-1)
    p_city = homo @ city_from_ego_at_sweep.T
    rot = city_from_ego_at_point[:, :3, :3]
    t = city_from_ego_at_point[:, :3, 3]
    diff = p_city[:, :3] - t
    return np.einsum("nij,nj->ni", rot.transpose(0, 2, 1), diff)


def build_range_view(
    sweep: Dict[str, np.ndarray],
    *,
    height: int,
    width: int,
    sweep_ts: int,
    poses: Optional[Dict[str, np.ndarray]],
    roi_fn=None,
    log_id: str = "",
) -> Dict[str, np.ndarray]:
    """Project one sweep into the (height x width) range image."""
    xyz = np.stack([sweep["x"], sweep["y"], sweep["z"]], axis=-1).astype(
        np.float64
    )
    laser = correct_laser_numbers(
        sweep["laser_number"].astype(np.int64), log_id
    )
    offsets = sweep.get("offset_ns", np.zeros(len(laser), np.int64))

    if height == 32:
        keep = laser < 32
        xyz, laser, offsets = xyz[keep], laser[keep], offsets[keep]
        sweep = {k: v[keep] for k, v in sweep.items()}
        mapping = ROW_MAPPING_32
    else:
        mapping = ROW_MAPPING_64

    proj_xyz = xyz
    if poses is not None:
        proj_xyz = unmotion_compensate(xyz, offsets, sweep_ts, poses)

    az = np.arctan2(proj_xyz[:, 1], proj_xyz[:, 0])
    rng = np.linalg.norm(xyz, axis=-1)
    col = ((az + np.pi) / (2 * np.pi) * width).astype(np.int64) % width
    row = mapping[np.clip(laser, 0, len(mapping) - 1)]

    roi = (
        roi_fn(xyz[:, :2]).astype(np.float32)
        if roi_fn is not None
        else np.ones(len(xyz), np.float32)
    )
    values = np.stack(
        [
            xyz[:, 0],
            xyz[:, 1],
            xyz[:, 2],
            sweep["intensity"].astype(np.float32),
            laser.astype(np.float32),
            roi,
            offsets.astype(np.float32),
            rng,
        ],
        axis=-1,
    ).astype(np.float32)
    img = z_buffer_native(
        row, col, rng.astype(np.float32), values, height=height, width=width
    )
    flat = img.reshape(-1, img.shape[-1])
    return {name: flat[:, i] for i, name in enumerate(OUTPUT_COLUMNS)}


def _quat_to_mat(qw, qx, qy, qz) -> np.ndarray:
    """Unit quaternion (scalar-first) -> (N, 3, 3) rotation matrices."""
    qw, qx, qy, qz = (np.asarray(q, np.float64) for q in (qw, qx, qy, qz))
    return np.stack(
        [
            np.stack(
                [
                    1 - 2 * (qy**2 + qz**2),
                    2 * (qx * qy - qw * qz),
                    2 * (qx * qz + qw * qy),
                ],
                -1,
            ),
            np.stack(
                [
                    2 * (qx * qy + qw * qz),
                    1 - 2 * (qx**2 + qz**2),
                    2 * (qy * qz - qw * qx),
                ],
                -1,
            ),
            np.stack(
                [
                    2 * (qx * qz - qw * qy),
                    2 * (qy * qz + qw * qx),
                    1 - 2 * (qx**2 + qy**2),
                ],
                -1,
            ),
        ],
        -2,
    )


def count_interior_points(
    ann: Dict[str, np.ndarray], sel: np.ndarray, xyz: np.ndarray
) -> np.ndarray:
    """Count lidar points inside each selected cuboid.

    The reference dataset ships ``num_interior_pts`` per annotation and the
    loader's train filter depends on it (``prototype/loader.py:331-344``);
    when a source lacks the column we compute it here from the sweep's
    (ego-frame, motion-compensated) points — the frame annotations live in.
    """
    idx = np.flatnonzero(sel)
    counts = np.zeros(len(idx), np.int64)
    if len(xyz) == 0:
        return counts
    rots = _quat_to_mat(
        ann["qw"][idx], ann["qx"][idx], ann["qy"][idx], ann["qz"][idx]
    )
    centers = np.stack(
        [ann["tx_m"][idx], ann["ty_m"][idx], ann["tz_m"][idx]], -1
    )
    half_dims = (
        np.stack(
            [ann["length_m"][idx], ann["width_m"][idx], ann["height_m"][idx]],
            -1,
        )
        / 2.0
    )
    for i in range(len(idx)):
        local = (xyz - centers[i]) @ rots[i]  # world->box frame
        inside = np.all(np.abs(local) <= half_dims[i] + 1e-9, axis=-1)
        counts[i] = int(inside.sum())
    return counts


def annotation_roi_flags(
    ann: Dict[str, np.ndarray], roi_map, poses: Optional[Dict[str, np.ndarray]]
) -> np.ndarray:
    """Per-cuboid ROI membership: any BEV footprint corner (or the center)
    inside the rasterized ROI — the SDK's ``compute_objects_in_roi_mask``
    vertex rule. Annotations are ego-frame at their timestamp; the ROI
    raster is city-frame, so each cuboid footprint is transformed by its
    sweep's city pose first."""
    n = len(ann["tx_m"])
    yaw = np.arctan2(
        2 * (ann["qw"] * ann["qz"] + ann["qx"] * ann["qy"]),
        1 - 2 * (ann["qy"] ** 2 + ann["qz"] ** 2),
    )
    c, s = np.cos(yaw), np.sin(yaw)
    half_l, half_w = ann["length_m"] / 2, ann["width_m"] / 2
    corners_local = np.stack(
        [
            np.stack([half_l, half_w], -1),
            np.stack([half_l, -half_w], -1),
            np.stack([-half_l, half_w], -1),
            np.stack([-half_l, -half_w], -1),
            np.zeros((n, 2)),
        ],
        1,
    )  # (N, 5, 2)
    rot = np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], -2
    )  # (N, 2, 2)
    corners = np.einsum("nij,nkj->nki", rot, corners_local) + np.stack(
        [ann["tx_m"], ann["ty_m"]], -1
    )[:, None]
    if poses is not None:
        city_from_ego = slerp_poses(poses, np.asarray(ann["timestamp_ns"]))
        corners = (
            np.einsum("nij,nkj->nki", city_from_ego[:, :2, :2], corners)
            + city_from_ego[:, None, :2, 3]
        )
    flags = roi_map.contains(corners.reshape(-1, 2)).reshape(n, 5)
    return flags.any(axis=1)


def export_log(
    log_dir: Path, dst_log_dir: Path, *, height: int, width: int
) -> None:
    poses = None
    pose_path = log_dir / "city_SE3_egovehicle.feather"
    if pose_path.is_file():
        poses = read_feather(pose_path)

    roi_map = load_roi_map(log_dir)

    def make_roi_fn(sweep_ts: int):
        """Per-point ROI lookup: ego->city at the sweep pose, then raster
        query (``converters/av2/utils.py:97-99`` capability)."""
        if roi_map is None or poses is None:
            return None
        city_from_ego = slerp_poses(poses, np.asarray([sweep_ts]))[0]

        def roi_fn(xy_ego: np.ndarray) -> np.ndarray:
            xy_city = xy_ego @ city_from_ego[:2, :2].T + city_from_ego[:2, 3]
            return roi_map.contains(xy_city)

        return roi_fn

    ann = None
    ann_path = log_dir / "annotations.feather"
    if ann_path.is_file():
        ann = read_feather(ann_path)
        needs_pts = "num_interior_pts" not in ann
        if needs_pts:
            ann["num_interior_pts"] = np.zeros(len(ann["tx_m"]), np.int64)

    lidar_dir = log_dir / "sensors" / "lidar"
    for sweep_path in sorted(lidar_dir.glob("*.feather")):
        ts = int(sweep_path.stem)
        sweep = read_feather(sweep_path)
        cols = build_range_view(
            sweep,
            height=height,
            width=width,
            sweep_ts=ts,
            poses=poses,
            roi_fn=make_roi_fn(ts),
            log_id=log_dir.stem,
        )
        write_feather(
            dst_log_dir / "sensors" / "range_view" / f"{ts}.feather", cols
        )
        if ann is not None and needs_pts:
            sel = ann["timestamp_ns"] == ts
            if sel.any():
                xyz = np.stack(
                    [sweep["x"], sweep["y"], sweep["z"]], axis=-1
                ).astype(np.float64)
                ann["num_interior_pts"][sel] = count_interior_points(
                    ann, sel, xyz
                )

    if ann is not None:
        # Poses are required to express the ego-frame cuboids in the
        # map's city frame; with a map but no poses, skip the flags
        # (everything stays in-ROI) rather than query garbage coordinates.
        if roi_map is not None and poses is not None:
            ann["is_within_roi"] = annotation_roi_flags(ann, roi_map, poses)
        write_feather(dst_log_dir / "annotations.feather", ann)

    # Carry poses + map through (reference copies annotations/poses/map —
    # export.py:31-163); evaluation needs them for detection-side ROI.
    if pose_path.is_file():
        shutil.copy(pose_path, dst_log_dir / pose_path.name)
    map_dir = log_dir / "map"
    if map_dir.is_dir():
        shutil.copytree(
            map_dir, dst_log_dir / "map", dirs_exist_ok=True
        )


def export_dataset(
    src_root_dir: str,
    dst_root_dir: str,
    *,
    height: int = 64,
    width: int = 1800,
    splits=("train", "val"),
) -> None:
    src, dst = Path(src_root_dir), Path(dst_root_dir)
    for split in splits:
        for log_dir in sorted((src / split).glob("*")):
            if not log_dir.is_dir():
                continue
            logger.info("exporting %s/%s", split, log_dir.stem)
            export_log(
                log_dir, dst / split / log_dir.stem, height=height, width=width
            )


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--src-root-dir", required=True)
    ap.add_argument("--dst-root-dir", required=True)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=1800)
    args = ap.parse_args()
    export_dataset(
        args.src_root_dir,
        args.dst_root_dir,
        height=args.height,
        width=args.width,
    )
