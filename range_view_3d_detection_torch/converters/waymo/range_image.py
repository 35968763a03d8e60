"""Pure-numpy Waymo range-image geometry (the port's copy of
``converters/waymo/range_image.py``).

Reimplements the math of the WOD SDK's
``range_image_utils.extract_point_cloud_from_range_image`` (used by the
reference converter, ``converters/waymo/export.py:55-132``) without the
SDK/TF dependency, so the conversion geometry is unit-testable in this
image and the SDK is needed only for TFRecord/protobuf parsing.

Conventions (Waymo TOP lidar):
- row r maps to ``inclinations[r]`` (callers pass the calibration's beam
  inclinations reversed, top row = highest beam);
- column c maps to azimuth ``((W - c - 0.5) / W * 2 - 1) * pi -
  az_correction`` where ``az_correction = atan2(extr[1,0], extr[0,0])``
  (the sensor's mounting yaw);
- polar -> sensor frame: ``x = cos(i)cos(a)R, y = cos(i)sin(a)R,
  z = sin(i)R``;
- sensor -> vehicle via the 4x4 extrinsic; optionally vehicle(t_pixel) ->
  global via the per-pixel pose then global -> vehicle(t_frame) via the
  inverse frame pose (rolling-shutter correction).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def azimuth_grid(width: int, extrinsic: np.ndarray) -> np.ndarray:
    """Per-column azimuth in the vehicle frame's convention."""
    az_correction = float(np.arctan2(extrinsic[1, 0], extrinsic[0, 0]))
    ratios = (width - np.arange(width, dtype=np.float64) - 0.5) / width
    return (ratios * 2.0 - 1.0) * np.pi - az_correction


def polar_to_cartesian(
    range_img: np.ndarray,
    inclinations: np.ndarray,
    extrinsic: np.ndarray,
    *,
    pixel_pose: Optional[np.ndarray] = None,
    frame_pose: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(H, W) ranges -> (H, W, 3) points in the vehicle frame.

    Args:
        range_img: (H, W) range in meters (<=0 marks empty pixels).
        inclinations: (H,) beam inclinations, row-aligned (top first).
        extrinsic: (4, 4) vehicle-from-sensor mount transform
            (vehicle = extrinsic @ sensor point).
        pixel_pose: optional (H, W, 4, 4) vehicle->global pose at each
            pixel's capture time (rolling shutter).
        frame_pose: (4, 4) vehicle->global pose at the frame timestamp;
            required with ``pixel_pose``.
    """
    H, W = range_img.shape
    az = azimuth_grid(W, extrinsic)[None, :]
    incl = np.asarray(inclinations, np.float64)[:, None]
    cos_i = np.cos(incl)
    x = cos_i * np.cos(az) * range_img
    y = cos_i * np.sin(az) * range_img
    z = np.sin(incl) * range_img

    pts = np.stack([x, y, z], axis=-1)  # sensor frame
    # Sensor -> vehicle.
    pts = pts @ extrinsic[:3, :3].T + extrinsic[:3, 3]

    if pixel_pose is not None:
        if frame_pose is None:
            raise ValueError("frame_pose required with pixel_pose")
        # vehicle(t_pixel) -> global.
        rot = pixel_pose[..., :3, :3]
        t = pixel_pose[..., :3, 3]
        pts = np.einsum("hwij,hwj->hwi", rot, pts) + t
        # global -> vehicle(t_frame).
        inv_rot = frame_pose[:3, :3].T
        pts = (pts - frame_pose[:3, 3]) @ inv_rot.T

    return pts.astype(np.float32)


def compute_inclinations(
    inclination_min: float, inclination_max: float, height: int
) -> np.ndarray:
    """Uniform beam inclinations when the calibration ships only a range
    (SDK ``compute_inclination`` semantics: bin centers, bottom first)."""
    ratios = (np.arange(height, dtype=np.float64) + 0.5) / height
    return inclination_min + ratios * (inclination_max - inclination_min)
