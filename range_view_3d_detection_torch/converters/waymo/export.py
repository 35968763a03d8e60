"""Waymo Open -> range-view feather converter (offline, host-side): the
port's copy of ``converters/waymo/export.py``, on the port's Feather
writer.

    python -m range_view_3d_detection_torch.converters.waymo.export \\
        --src-root-dir WOD --dst-root-dir OUT

Capability parity with the reference ``converters/waymo/export.py``
(55-525): convert Waymo TFRecords into the AV2 directory layout, keeping
the sensor's native 64 x 2650 TOP-lidar range image (no re-projection —
SURVEY §2.2 note), masking no-label zones, and writing AV2-style
annotations with ``num_interior_pts`` and ``difficulty_level``.

TensorFlow + the waymo_open_dataset SDK are required only here (the
reference has the same requirement); imports are gated so the rest of the
framework never touches TF. Run on a host with those wheels installed.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Dict

import numpy as np

from range_view_3d_detection_torch.converters.waymo.camera import (
    export_camera_images,
    form_calibration,
    pose_row,
)
from range_view_3d_detection_torch.converters.waymo.range_image import (
    compute_inclinations,
    polar_to_cartesian,
)
from range_view_3d_detection_torch.utils.feather import write_feather

logger = logging.getLogger("waymo_export")

HEIGHT, WIDTH = 64, 2650
OUTPUT_COLUMNS = ("x", "y", "z", "range", "intensity", "elongation")

WAYMO_CATEGORIES = {1: "VEHICLE", 2: "PEDESTRIAN", 3: "SIGN", 4: "CYCLIST"}


def _require_waymo():
    try:
        import tensorflow as tf  # noqa: F401
        from waymo_open_dataset import dataset_pb2  # noqa: F401
        from waymo_open_dataset.utils import frame_utils  # noqa: F401
    except ImportError as exc:  # pragma: no cover - requires Waymo SDK
        raise RuntimeError(
            "The Waymo converter needs tensorflow + waymo_open_dataset "
            "(same requirement as the reference converter). Install them on "
            "the conversion host; training/eval never need TF."
        ) from exc


def euler_to_matrix(roll, pitch, yaw) -> np.ndarray:
    """Z-Y-X Euler angles -> (..., 3, 3) rotation (the SDK's
    ``transform_utils.get_rotation_matrix`` convention)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    zeros = np.zeros_like(cr)
    ones = np.ones_like(cr)
    rz = np.stack(
        [
            np.stack([cy, -sy, zeros], -1),
            np.stack([sy, cy, zeros], -1),
            np.stack([zeros, zeros, ones], -1),
        ],
        -2,
    )
    ry = np.stack(
        [
            np.stack([cp, zeros, sp], -1),
            np.stack([zeros, ones, zeros], -1),
            np.stack([-sp, zeros, cp], -1),
        ],
        -2,
    )
    rx = np.stack(
        [
            np.stack([ones, zeros, zeros], -1),
            np.stack([zeros, cr, -sr], -1),
            np.stack([zeros, sr, cr], -1),
        ],
        -2,
    )
    return rz @ ry @ rx


def convert_range_image_to_cartesian(frame, range_images, range_image_top_pose):
    """First-return TOP range image -> (64, 2650, 6) columns, keeping the
    polar features (range/intensity/elongation) alongside Cartesian
    (reference export.py:55-132). No-label-zone pixels are masked out.

    The geometry (polar -> vehicle frame with rolling-shutter per-pixel
    poses) runs in pure numpy (``converters/waymo/range_image.py``); the
    SDK is only needed upstream to parse the TFRecord protos.
    """
    try:  # LaserName.TOP == 1 in the WOD proto; constant when SDK absent
        from waymo_open_dataset import dataset_pb2

        top = dataset_pb2.LaserName.TOP
    except ImportError:
        top = 1

    calib = next(
        c for c in frame.context.laser_calibrations if c.name == top
    )
    ri = range_images[top][0]
    ri_tensor = np.asarray(ri.data, np.float32).reshape(
        ri.shape.dims
    )  # (64, 2650, 4): range, intensity, elongation, is_in_nlz

    extrinsic = np.reshape(np.array(calib.extrinsic.transform), [4, 4])
    if len(calib.beam_inclinations) == 0:
        inclinations = compute_inclinations(
            calib.beam_inclination_min,
            calib.beam_inclination_max,
            ri.shape.dims[0],
        )
    else:
        inclinations = np.asarray(calib.beam_inclinations, np.float64)
    inclinations = inclinations[::-1]

    pose_tensor = np.asarray(range_image_top_pose.data, np.float64).reshape(
        range_image_top_pose.shape.dims
    )  # (H, W, 6): roll, pitch, yaw, x, y, z
    pose_full = np.zeros(pose_tensor.shape[:2] + (4, 4))
    pose_full[..., :3, :3] = euler_to_matrix(
        pose_tensor[..., 0], pose_tensor[..., 1], pose_tensor[..., 2]
    )
    pose_full[..., :3, 3] = pose_tensor[..., 3:]
    pose_full[..., 3, 3] = 1.0

    frame_pose = np.reshape(np.array(frame.pose.transform), [4, 4])
    cart = polar_to_cartesian(
        ri_tensor[..., 0].astype(np.float64),
        inclinations,
        extrinsic,
        pixel_pose=pose_full,
        frame_pose=frame_pose,
    )

    rng = ri_tensor[..., 0]
    intensity = ri_tensor[..., 1]
    elongation = ri_tensor[..., 2]
    nlz = ri_tensor[..., 3] if ri_tensor.shape[-1] > 3 else -np.ones_like(rng)

    valid = (rng > 0) & (nlz < 0)  # mask no-label zones (export.py:129-132)
    rng = np.where(valid, rng, 0.0)
    cart = np.where(valid[..., None], cart, 0.0)
    intensity = np.where(valid, intensity, 0.0)
    elongation = np.where(valid, elongation, 0.0)

    return {
        "x": cart[..., 0].reshape(-1).astype(np.float32),
        "y": cart[..., 1].reshape(-1).astype(np.float32),
        "z": cart[..., 2].reshape(-1).astype(np.float32),
        "range": rng.reshape(-1).astype(np.float32),
        "intensity": intensity.reshape(-1).astype(np.float32),
        "elongation": elongation.reshape(-1).astype(np.float32),
    }


def build_argo_label(frame, cart: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Waymo laser labels -> AV2-style annotation columns
    (reference export.py:440-456)."""
    xyz = np.stack([cart["x"], cart["y"], cart["z"]], axis=-1)
    valid = cart["range"] > 0

    cols: Dict[str, list] = {
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
            "difficulty_level",
        )
    }
    ts = frame.timestamp_micros * 1000
    for label in frame.laser_labels:
        b = label.box
        yaw = b.heading
        c, s = np.cos(yaw), np.sin(yaw)
        d = xyz - np.array([b.center_x, b.center_y, b.center_z])
        lx = c * d[:, 0] + s * d[:, 1]
        ly = -s * d[:, 0] + c * d[:, 1]
        inside = (
            valid
            & (np.abs(lx) <= b.length / 2)
            & (np.abs(ly) <= b.width / 2)
            & (np.abs(d[:, 2]) <= b.height / 2)
        )
        cols["timestamp_ns"].append(np.int64(ts))
        cols["category"].append(WAYMO_CATEGORIES.get(label.type, "UNKNOWN"))
        cols["tx_m"].append(b.center_x)
        cols["ty_m"].append(b.center_y)
        cols["tz_m"].append(b.center_z)
        cols["length_m"].append(b.length)
        cols["width_m"].append(b.width)
        cols["height_m"].append(b.height)
        cols["qw"].append(np.cos(yaw / 2))
        cols["qx"].append(0.0)
        cols["qy"].append(0.0)
        cols["qz"].append(np.sin(yaw / 2))
        cols["num_interior_pts"].append(np.int64(inside.sum()))
        cols["difficulty_level"].append(np.int64(label.detection_difficulty_level))
    return {k: np.asarray(v) for k, v in cols.items()}


def _read_frames(tfrecord_path: Path):
    """Yield (frame, range_images, range_image_top_pose) per sweep.

    The only function that touches TensorFlow + the WOD SDK (TFRecord +
    proto parsing); everything downstream is SDK-free numpy and is
    covered by fixtures (``tests/test_torch_converters.py``).
    """
    import tensorflow as tf
    from waymo_open_dataset import dataset_pb2
    from waymo_open_dataset.utils import frame_utils

    for data in tf.data.TFRecordDataset(str(tfrecord_path), compression_type=""):
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        (
            range_images,
            camera_projections,
            _,
            range_image_top_pose,
        ) = frame_utils.parse_range_image_and_camera_projection(frame)
        yield frame, range_images, range_image_top_pose


def export_log(
    tfrecord_path: Path,
    dst_log_dir: Path,
    *,
    frames=None,
    export_cameras: bool = True,
) -> int:
    """Convert one segment; returns sweep count.

    ``frames`` overrides the TFRecord reader with any iterable of
    (frame, range_images, range_image_top_pose) — duck-typed protos are
    enough (used by the fixture tests; mirrors reference export.py:181+).

    Beyond the lidar/label side, this writes the reference's full per-log
    sidecar surface (export.py:199-305): ``city_SE3_egovehicle.feather``
    (frame + per-camera-image poses), ``calibration/intrinsics.feather``
    + ``calibration/egovehicle_SE3_sensor.feather``, and undistorted
    camera JPEGs (``export_cameras=False`` skips the image decode for
    lidar-only conversions).
    """
    if frames is None:
        frames = _read_frames(tfrecord_path)

    num_pts_rows = []
    ann_frames = []
    pose_rows = []
    wrote_calibration = False
    n = 0
    for frame, range_images, range_image_top_pose in frames:
        cols = convert_range_image_to_cartesian(
            frame, range_images, range_image_top_pose
        )
        ts = frame.timestamp_micros * 1000
        write_feather(
            dst_log_dir / "sensors" / "range_view" / f"{ts}.feather", cols
        )
        ann_frames.append(build_argo_label(frame, cols))
        num_pts_rows.append((dst_log_dir.stem, ts, int((cols["range"] > 0).sum())))

        pose_rows.append(
            pose_row(
                np.asarray(frame.pose.transform, np.float64).reshape(4, 4), ts
            )
        )
        cam_calibs = getattr(frame.context, "camera_calibrations", ())
        if not wrote_calibration and len(cam_calibs):
            intr, extr = form_calibration(cam_calibs)
            write_feather(
                dst_log_dir / "calibration" / "intrinsics.feather", intr
            )
            write_feather(
                dst_log_dir / "calibration" / "egovehicle_SE3_sensor.feather",
                extr,
            )
            wrote_calibration = True
        if export_cameras and len(getattr(frame, "images", ())):
            pose_rows.extend(export_camera_images(frame, dst_log_dir))
        n += 1

    ann = {
        k: np.concatenate([f[k] for f in ann_frames])
        for k in ann_frames[0]
    }
    write_feather(dst_log_dir / "annotations.feather", ann)

    if pose_rows:
        poses = {
            k: np.asarray([r[k] for r in pose_rows]) for k in pose_rows[0]
        }
        poses["timestamp_ns"] = poses["timestamp_ns"].astype(np.int64)
        write_feather(dst_log_dir / "city_SE3_egovehicle.feather", poses)

    # Per-sweep point counts feed the <50k-point train filter
    # (metadata/waymo.feather, loader.py:350-358).
    write_feather(
        dst_log_dir / "metadata.feather",
        {
            "log_id": np.asarray([r[0] for r in num_pts_rows]),
            "timestamp_ns": np.asarray([r[1] for r in num_pts_rows], np.int64),
            "num_pts": np.asarray([r[2] for r in num_pts_rows], np.int64),
        },
    )
    return n


def export_dataset(src_root_dir: str, dst_root_dir: str, splits=("training", "validation")) -> None:
    _require_waymo()
    split_map = {"training": "train", "validation": "val", "testing": "test"}
    src, dst = Path(src_root_dir), Path(dst_root_dir)
    for split in splits:
        for rec in sorted((src / split).glob("*.tfrecord*")):
            log_id = rec.stem.replace(".tfrecord", "")
            logger.info("exporting %s/%s", split, log_id)
            export_log(rec, dst / split_map[split] / log_id)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--src-root-dir", required=True)
    ap.add_argument("--dst-root-dir", required=True)
    args = ap.parse_args()
    export_dataset(args.src_root_dir, args.dst_root_dir)
