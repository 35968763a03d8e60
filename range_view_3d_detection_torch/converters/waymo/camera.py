"""Waymo camera/calibration/pose export — SDK-free math (the port's copy
of ``converters/waymo/camera.py``).

Capability parity with the camera half of the reference
``converters/waymo/export.py`` (form_calibration_json 307-377, export_pose
379-413, undistortion + JPEG write 225-249): AV2-layout calibration
feathers (``calibration/intrinsics.feather`` +
``calibration/egovehicle_SE3_sensor.feather``), per-frame
``city_SE3_egovehicle.feather`` pose rows, and undistorted camera JPEGs
under ``sensors/cameras/<name>/<timestamp_ns>.jpg``.

Re-designed without cv2/scipy/argoverse dependencies: rotation matrices,
quaternion conversion, and the Brown–Conrady inverse-mapping undistortion
are pure numpy; JPEG decode/encode prefers TensorFlow (present wherever
Waymo TFRecords are parsed), falling back to PIL.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

CAMERA_NAMES = (
    "unknown",  # 0
    "ring_front_center",  # 1 FRONT
    "ring_front_left",  # 2 FRONT_LEFT
    "ring_front_right",  # 3 FRONT_RIGHT
    "ring_side_left",  # 4 SIDE_LEFT
    "ring_side_right",  # 5 SIDE_RIGHT
)


def rot_x(deg: float) -> np.ndarray:
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def rot_y(deg: float) -> np.ndarray:
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def rotmat_to_quat(R: np.ndarray) -> Tuple[float, float, float, float]:
    """(3, 3) rotation -> (qw, qx, qy, qz), Shepperd's method (stable for
    every trace sign; matches scipy's convention up to global sign)."""
    m = np.asarray(R, np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    if w < 0:  # canonical sign
        w, x, y, z = -w, -x, -y, -z
    return float(w), float(x), float(y), float(z)


def form_calibration(
    camera_calibrations,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Camera calibrations -> (intrinsics, extrinsics) AV2-style columns.

    Waymo provides ``egovehicle_SE3_waymocam`` with the camera x-axis
    pointing forward; AV2 expects the standard camera frame (z forward,
    x right, y down). The reference composes
    ``standardcam_R_waymocam = rotY(-90) @ rotX(90)`` and stores
    ``egovehicle_SE3_standardcam`` (export.py:319-341); with the pure
    rotation S this reduces to ``R = R_ego @ S.T``, ``t = t_ego``.
    """
    intr: Dict[str, List] = {
        k: []
        for k in (
            "sensor_name",
            "fx_px",
            "fy_px",
            "cx_px",
            "cy_px",
            "k1",
            "k2",
            "k3",
            "height_px",
            "width_px",
        )
    }
    extr: Dict[str, List] = {
        k: []
        for k in ("sensor_name", "qw", "qx", "qy", "qz", "tx_m", "ty_m", "tz_m")
    }
    S = rot_y(-90) @ rot_x(90)
    for calib in camera_calibrations:
        name = CAMERA_NAMES[calib.name]
        E = np.asarray(calib.extrinsic.transform, np.float64).reshape(4, 4)
        R = E[:3, :3] @ S.T
        t = E[:3, 3]
        qw, qx, qy, qz = rotmat_to_quat(R)
        f_u, f_v, c_u, c_v, k1, k2, p1, p2, k3 = calib.intrinsic
        intr["sensor_name"].append(name)
        intr["fx_px"].append(f_u)
        intr["fy_px"].append(f_v)
        intr["cx_px"].append(c_u)
        intr["cy_px"].append(c_v)
        intr["k1"].append(k1)
        intr["k2"].append(k2)
        intr["k3"].append(k3)
        intr["height_px"].append(calib.height)
        intr["width_px"].append(calib.width)
        extr["sensor_name"].append(name)
        extr["qw"].append(qw)
        extr["qx"].append(qx)
        extr["qy"].append(qy)
        extr["qz"].append(qz)
        extr["tx_m"].append(t[0])
        extr["ty_m"].append(t[1])
        extr["tz_m"].append(t[2])
    return (
        {k: np.asarray(v) for k, v in intr.items()},
        {k: np.asarray(v) for k, v in extr.items()},
    )


def pose_row(city_SE3_egovehicle: np.ndarray, timestamp_ns: int) -> Dict[str, float]:
    """One ``city_SE3_egovehicle`` row (reference export_pose, 379-413)."""
    T = np.asarray(city_SE3_egovehicle, np.float64)
    assert np.allclose(T[3], [0, 0, 0, 1])
    qw, qx, qy, qz = rotmat_to_quat(T[:3, :3])
    return {
        "timestamp_ns": int(timestamp_ns),
        "qw": qw,
        "qx": qx,
        "qy": qy,
        "qz": qz,
        "tx_m": float(T[0, 3]),
        "ty_m": float(T[1, 3]),
        "tz_m": float(T[2, 3]),
    }


def undistort_image(img: np.ndarray, intrinsic) -> np.ndarray:
    """Brown–Conrady undistortion by inverse mapping + bilinear sampling.

    ``intrinsic`` is the Waymo 9-vector (f_u, f_v, c_u, c_v, k1, k2, p1,
    p2, k3). For each undistorted output pixel, apply the distortion model
    to locate its source in the distorted image (the same model cv2's
    ``undistort`` inverts — reference utils.py:48-61), then sample.
    """
    f_u, f_v, c_u, c_v, k1, k2, p1, p2, k3 = [float(v) for v in intrinsic]
    H, W = img.shape[:2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    x = (u - c_u) / f_u
    y = (v - c_v) / f_v
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    us = xd * f_u + c_u
    vs = yd * f_v + c_v

    u0 = np.clip(np.floor(us).astype(np.int64), 0, W - 2)
    v0 = np.clip(np.floor(vs).astype(np.int64), 0, H - 2)
    du = np.clip(us - u0, 0.0, 1.0)[..., None]
    dv = np.clip(vs - v0, 0.0, 1.0)[..., None]
    imgf = img.astype(np.float64)
    if imgf.ndim == 2:
        imgf = imgf[..., None]
    top = imgf[v0, u0] * (1 - du) + imgf[v0, u0 + 1] * du
    bot = imgf[v0 + 1, u0] * (1 - du) + imgf[v0 + 1, u0 + 1] * du
    out = top * (1 - dv) + bot * dv
    inside = (us >= 0) & (us <= W - 1) & (vs >= 0) & (vs <= H - 1)
    out = np.where(inside[..., None], out, 0.0)
    if img.ndim == 2:
        out = out[..., 0]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _decode_jpeg(data: bytes) -> np.ndarray:
    try:
        import tensorflow as tf

        return np.asarray(tf.image.decode_jpeg(data))
    except ImportError:
        import io

        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _encode_jpeg(img: np.ndarray, dst: Path) -> None:
    try:
        import tensorflow as tf

        dst.write_bytes(tf.io.encode_jpeg(img).numpy())
    except ImportError:
        from PIL import Image

        Image.fromarray(img).save(dst, quality=95)


def export_camera_images(frame, dst_log_dir: Path) -> List[Dict[str, float]]:
    """Write undistorted JPEGs for every camera image of a frame and
    return the per-image camera-pose rows (reference export.py:221-249).
    """
    calibs = {c.name: c for c in frame.context.camera_calibrations}
    rows = []
    for cam_img in frame.images:
        cam_ts = int(cam_img.pose_timestamp * 1e9)
        rows.append(
            pose_row(
                np.asarray(cam_img.pose.transform, np.float64).reshape(4, 4),
                cam_ts,
            )
        )
        name = CAMERA_NAMES[cam_img.name]
        img = _decode_jpeg(cam_img.image)
        img = undistort_image(img, calibs[cam_img.name].intrinsic)
        dst = dst_log_dir / "sensors" / "cameras" / name / f"{cam_ts}.jpg"
        dst.parent.mkdir(parents=True, exist_ok=True)
        _encode_jpeg(img, dst)
    return rows
