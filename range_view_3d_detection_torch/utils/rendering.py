"""Training visualisation: BEV boxes and range-image heatmaps as PNG
(counterpart of the JAX ``utils/rendering.py``, which draws with
matplotlib; the port does not depend on it).

The same content is drawn into a numpy RGB raster: in BEV the points in
grey, ground-truth box outlines in blue and predicted outlines in green
where a prediction's best 3D IoU with a ground truth is at least 0.7,
red otherwise; the range maps as stacked panels coloured by the turbo
colour map, each scaled to its own minimum and maximum. PNGs are
written with ``zlib`` and ``struct`` (and read back by ``read_png``).
Pixel equality with matplotlib's figures is not a goal.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np

IOU_GREEN_THRESHOLD = 0.7  # tensorboard.py:314-318
_GREY, _BLUE, _GREEN, _RED = (128, 128, 128), (31, 119, 180), (44, 160, 44), (214, 39, 40)
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _box_corners_bev_np(boxes: np.ndarray) -> np.ndarray:
    x, y, l, w, yaw = boxes[:, 0], boxes[:, 1], boxes[:, 3], boxes[:, 4], boxes[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    lx = np.stack([l, l, -l, -l], -1) * 0.5
    ly = np.stack([-w, w, w, -w], -1) * 0.5
    cx = c[:, None] * lx - s[:, None] * ly + x[:, None]
    cy = s[:, None] * lx + c[:, None] * ly + y[:, None]
    return np.stack([cx, cy], axis=-1)


def _best_iou3d(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Best 3D IoU per prediction (the reference colours by mmcv
    ``boxes_iou3d`` — tensorboard.py:314-318 — not BEV-only)."""
    from range_view_3d_detection_torch.evaluation.waymo_eval import _iou3d

    if not len(pred) or not len(gt):
        return np.zeros(len(pred))
    return _iou3d(pred, gt).max(axis=1)


def _polyline(img: np.ndarray, px: np.ndarray, color) -> None:
    """Draw the closed polygon with pixel vertices ``px`` ((N, 2) x, y)."""
    h, w = img.shape[:2]
    for (x0, y0), (x1, y1) in zip(px, np.roll(px, -1, axis=0)):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        xs = np.rint(x0 + t * (x1 - x0)).astype(int)
        ys = np.rint(y0 + t * (y1 - y0)).astype(int)
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        img[ys[ok], xs[ok]] = color


def draw_bev(
    points_xy: Optional[np.ndarray],
    gt_boxes: np.ndarray,
    pred_boxes: np.ndarray,
    pred_scores: Optional[np.ndarray] = None,
    *,
    out_path: Optional[str | Path] = None,
    extent: float = 60.0,
    size: int = 800,
) -> np.ndarray:
    """Render the BEV of one sweep over [-extent, extent]^2 metres; returns
    the (size, size, 3) uint8 image and writes it to ``out_path``. x runs
    right and y up, as in the JAX figure."""
    img = np.full((size, size, 3), 255, np.uint8)
    scale = size / (2.0 * extent)

    def to_px(xy: np.ndarray) -> np.ndarray:
        return np.stack([(xy[..., 0] + extent) * scale, (extent - xy[..., 1]) * scale], -1)

    if points_xy is not None and len(points_xy):
        px = np.floor(to_px(np.asarray(points_xy, np.float64))).astype(int)
        ok = (px[:, 0] >= 0) & (px[:, 0] < size) & (px[:, 1] >= 0) & (px[:, 1] < size)
        img[px[ok, 1], px[ok, 0]] = _GREY
    # A box with a non-finite value is not drawn (matplotlib drops such
    # polygons from the JAX figure too).
    gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 7)
    gt_boxes = gt_boxes[np.isfinite(gt_boxes).all(-1)]
    pred_boxes = np.asarray(pred_boxes, np.float64).reshape(-1, 7)
    pred_boxes = pred_boxes[np.isfinite(pred_boxes).all(-1)]
    for corners in _box_corners_bev_np(gt_boxes):
        _polyline(img, to_px(corners), _BLUE)
    ious = _best_iou3d(pred_boxes, gt_boxes)
    for corners, iou in zip(_box_corners_bev_np(pred_boxes), ious):
        _polyline(img, to_px(corners), _GREEN if iou >= IOU_GREEN_THRESHOLD else _RED)
    if out_path is not None:
        write_png(out_path, img)
    return img


def turbo(x: np.ndarray) -> np.ndarray:
    """The turbo colour map of values in [0, 1], as uint8 RGB (the
    polynomial fit published with the map)."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    kr = (0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943)
    kg = (0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604)
    kb = (0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973)
    powers = x[..., None] ** np.arange(6)
    rgb = np.stack([powers @ np.asarray(k) for k in (kr, kg, kb)], -1)
    return np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint8)


def draw_range_maps(
    maps: Dict[str, np.ndarray],
    *,
    out_path: Optional[str | Path] = None,
    panel_height: int = 96,
    gap: int = 4,
) -> np.ndarray:
    """Stacked range-image heatmaps (score, likelihood or loss maps), the
    per-stride panels of ``tensorboard.py:354-387``: each map scaled to
    its own range, rows repeated to ``panel_height``; returns the image
    and writes it to ``out_path``."""
    panels = []
    for img in maps.values():
        img = np.asarray(img, np.float64)
        lo, hi = float(img.min()), float(img.max())
        norm = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
        rows = max(panel_height // max(img.shape[0], 1), 1)
        panels.append(np.repeat(turbo(norm), rows, axis=0))
    width = max(p.shape[1] for p in panels)
    height = sum(p.shape[0] for p in panels) + gap * (len(panels) - 1)
    out = np.full((height, width, 3), 255, np.uint8)
    y = 0
    for p in panels:
        out[y : y + p.shape[0], : p.shape[1]] = p
        y += p.shape[0] + gap
    if out_path is not None:
        write_png(out_path, out)
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str | Path, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3) images, got {img.shape}")
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 (None) a row
    raw[:, 1:] = img.reshape(h, 3 * w)
    data = (
        _PNG_MAGIC
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
    Path(path).write_bytes(data)


def read_png(path: str | Path) -> np.ndarray:
    """Decode a PNG as ``write_png`` writes them (8-bit RGB or RGBA,
    not interlaced, every row unfiltered) into (H, W, C) uint8, checking
    every chunk's CRC; other PNGs raise."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8 : pos + 8 + n]
        if struct.unpack_from(">I", data, pos + 8 + n)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are read")
    c = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than None are not read")
    return raw[:, 1:].reshape(h, w, c).copy()
