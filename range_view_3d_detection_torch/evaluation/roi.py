"""Map-based region-of-interest (ROI) computation for AV2 logs (the
port's copy of ``converters/av2/roi.py`` and of the pose interpolation
of ``converters/av2/export.py::_slerp_poses``, which the AV2 evaluator
needs to place detections in the city frame).

The reference carries a per-point ``is_within_roi`` flag produced by the
av2 SDK's raster map layer (``converters/av2/export.py:97``,
``converters/av2/utils.py:23,99``) and evaluates ROI-only
(``src/torchbox3d/datasets/__init__.py:27-34``). The SDK defines the ROI
as the union of the city's drivable-area polygons dilated by 5 m.

This module reproduces that definition without the SDK: the log map
archive (``map/log_map_archive_<log>.json``) ships the drivable-area
boundary polygons in city coordinates; we rasterize them at a fixed
resolution, binary-dilate by the ROI buffer, and answer point queries by
raster lookup — the same mechanism as the SDK's ``RasterLayerType.ROI``.
The polygon fill is matplotlib's crossing test, in numpy (the JAX
converter calls matplotlib, which the port does not depend on).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROI_BUFFER_M = 5.0
RASTER_RESOLUTION_M = 0.3


def points_in_polygon(xy: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """(N,) whether each point lies inside the closed polygon ``poly``
    ((M, 2) vertices): the crossing test of matplotlib's
    ``Path.contains_points`` (``_path.h::point_in_path_impl``) with its
    convention for points on an edge or a vertex, so that the raster equals
    the JAX converter's cell for cell."""
    inside = np.zeros(len(xy), bool)
    x, y = xy[:, 0], xy[:, 1]
    for (x0, y0), (x1, y1) in zip(poly, np.roll(poly, -1, axis=0)):
        above0, above1 = y0 >= y, y1 >= y
        hit = ((y1 - y) * (x0 - x1) >= (x1 - x) * (y0 - y1)) == above1
        inside ^= (above0 != above1) & hit
    return inside


def slerp_poses(poses: Dict[str, np.ndarray], timestamps: np.ndarray) -> np.ndarray:
    """Interpolate city_SE3_egovehicle to per-point timestamps.

    Returns (N, 4, 4) transforms.
    """
    from scipy.spatial.transform import Rotation, Slerp

    ts = poses["timestamp_ns"].astype(np.float64)
    order = np.argsort(ts)
    ts = ts[order]
    quat = np.stack(
        [poses["qx"], poses["qy"], poses["qz"], poses["qw"]], axis=-1
    )[order]
    trans = np.stack(
        [poses["tx_m"], poses["ty_m"], poses["tz_m"]], axis=-1
    )[order]

    t_clip = np.clip(timestamps.astype(np.float64), ts[0], ts[-1])
    slerp = Slerp(ts, Rotation.from_quat(quat))
    rots = slerp(t_clip).as_matrix()  # (N, 3, 3)
    tx = np.stack(
        [np.interp(t_clip, ts, trans[:, i]) for i in range(3)], axis=-1
    )
    out = np.tile(np.eye(4), (len(timestamps), 1, 1))
    out[:, :3, :3] = rots
    out[:, :3, 3] = tx
    return out


class RoiMap:
    """Rasterized drivable-area ROI for one log, in city coordinates."""

    def __init__(
        self,
        drivable_polygons: List[np.ndarray],
        *,
        buffer_m: float = ROI_BUFFER_M,
        resolution_m: float = RASTER_RESOLUTION_M,
    ) -> None:
        self.resolution = float(resolution_m)
        if not drivable_polygons:
            self.origin = np.zeros(2)
            self.raster = np.zeros((1, 1), bool)
            return
        pts = np.concatenate(drivable_polygons, axis=0)
        lo = pts.min(axis=0) - buffer_m - 2 * resolution_m
        hi = pts.max(axis=0) + buffer_m + 2 * resolution_m
        self.origin = lo
        shape = np.ceil((hi - lo) / resolution_m).astype(int) + 1
        raster = np.zeros((shape[1], shape[0]), bool)  # (rows=y, cols=x)

        ys, xs = np.mgrid[0 : shape[1], 0 : shape[0]]
        cell_xy = (
            np.stack([xs.ravel(), ys.ravel()], axis=-1) * resolution_m + lo
        )
        for poly in drivable_polygons:
            mask = points_in_polygon(cell_xy, poly)
            raster |= mask.reshape(raster.shape)

        from scipy import ndimage

        r = int(np.ceil(buffer_m / resolution_m))
        yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
        disk = (xx**2 + yy**2) <= (buffer_m / resolution_m) ** 2
        self.raster = ndimage.binary_dilation(raster, structure=disk)

    def contains(self, xy_city: np.ndarray) -> np.ndarray:
        """Query point membership. ``xy_city``: (N, 2) city-frame meters."""
        idx = np.floor((xy_city - self.origin) / self.resolution).astype(int)
        inside = (
            (idx[:, 0] >= 0)
            & (idx[:, 0] < self.raster.shape[1])
            & (idx[:, 1] >= 0)
            & (idx[:, 1] < self.raster.shape[0])
        )
        out = np.zeros(len(xy_city), bool)
        sel = np.flatnonzero(inside)
        out[sel] = self.raster[idx[sel, 1], idx[sel, 0]]
        return out


_ROI_CACHE: dict = {}
_ROI_CACHE_SIZE = 16


def load_roi_map(log_dir: Path) -> Optional[RoiMap]:
    """Build the ROI raster from a log's map archive, or None if absent.

    Rasterization (polygon fill + 5 m dilation) costs seconds per log, so
    results are cached by (archive path, mtime) — evaluation calls this
    once per log per epoch."""
    map_dir = Path(log_dir) / "map"
    archives = sorted(map_dir.glob("log_map_archive_*.json"))
    if not archives:
        return None
    cache_key = (str(archives[0]), archives[0].stat().st_mtime_ns)
    if cache_key in _ROI_CACHE:
        return _ROI_CACHE[cache_key]
    data = json.loads(archives[0].read_text())
    polys: List[np.ndarray] = []
    for area in (data.get("drivable_areas") or {}).values():
        boundary = area.get("area_boundary", [])
        if len(boundary) >= 3:
            polys.append(
                np.asarray([[p["x"], p["y"]] for p in boundary], np.float64)
            )
    roi = RoiMap(polys) if polys else None
    if len(_ROI_CACHE) >= _ROI_CACHE_SIZE:
        _ROI_CACHE.pop(next(iter(_ROI_CACHE)))
    _ROI_CACHE[cache_key] = roi
    return roi
