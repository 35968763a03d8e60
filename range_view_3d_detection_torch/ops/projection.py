"""Spherical projection and z-buffer rasterization (counterpart of the JAX
``ops/projection.py``): raw LiDAR points -> the range image the detector
takes, nearest return first.

- :func:`range_view_coordinates` and :func:`z_buffer_numpy` run on the
  host (the synthetic data generator projects through them);
- :func:`z_buffer_winner_map`, :func:`z_buffer_sorted`, :func:`z_buffer`
  and :func:`range_view_coordinates_t` are their tensor twins;
- :func:`rasterize_points` turns batched clouds into ``(features, cart,
  mask)``, the inputs of ``serving.Predictor``: the device twin of the
  data layer's sweep loading and width padding.

The JAX package has no kernel here: this module is torch ops. Three of its
forms are chosen so that the CPU equals jitted JAX bit for bit and the
card equals the CPU:

- the column is ``(az + pi) * (W / 2pi)`` with ``W / 2pi`` one float32
  constant, the product XLA's simplifier makes of JAX's ``(az + pi) /
  (2pi) * W``;
- the range is ``sqrt(fma(z, z, fma(y, y, x * x)))`` with the square root
  rounded once (taken in fp64), which is what XLA's CPU norm computes;
  ``addcmul`` is one fused multiply-add on the CPU and on the card;
- the winners come from one stable sort of the int64 key ``pixel << 32 |
  float32 bits of the range`` (for non-negative floats and ``+inf`` the
  bits order as the values), so the smallest point index wins a tie, as
  ``lax.sort``'s stability gives in JAX. Batched clouds share that sort
  with their pixel ids offset by ``b * H * W``.

``atan2`` on the card may differ from the CPU's by an ulp, so a point on
a column boundary can land in the neighbouring column there.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

MIN_DISTANCE = 1.0  # reference z_buffer min_distance (conversions.py:113)


def range_view_coordinates(
    xyz: np.ndarray,
    laser_numbers: np.ndarray,
    *,
    height: int,
    width: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Points -> (row, col, range) image coordinates (host side).

    Rows come from the laser index, columns from azimuth binning over
    [-pi, pi).
    """
    az = np.arctan2(xyz[:, 1], xyz[:, 0])
    rng = np.linalg.norm(xyz, axis=-1)
    col = ((az + np.pi) / (2 * np.pi) * width).astype(np.int64) % width
    row = np.clip(laser_numbers.astype(np.int64), 0, height - 1)
    return row, col, rng


def z_buffer_numpy(
    row: np.ndarray,
    col: np.ndarray,
    distances: np.ndarray,
    values: np.ndarray,
    *,
    height: int,
    width: int,
    min_distance: float = MIN_DISTANCE,
) -> np.ndarray:
    """Nearest-return-wins rasterization (host side).

    Args:
        row/col: (N,) pixel coordinates.
        distances: (N,) ranges used for the depth test.
        values: (N, C) per-point features to scatter.

    Returns:
        (H, W, C) image; empty pixels are zero.
    """
    keep = distances >= min_distance
    row, col, distances, values = (
        row[keep],
        col[keep],
        distances[keep],
        values[keep],
    )
    flat = row * width + col
    # Sort by (pixel, distance); the first hit per pixel is the nearest.
    order = np.lexsort((distances, flat))
    flat_sorted = flat[order]
    first = np.ones(len(flat_sorted), dtype=bool)
    first[1:] = flat_sorted[1:] != flat_sorted[:-1]
    img = np.zeros((height * width, values.shape[1]), dtype=values.dtype)
    img[flat_sorted[first]] = values[order][first]
    return img.reshape(height, width, values.shape[1])


def z_buffer_winner_map(
    row: torch.Tensor,
    col: torch.Tensor,
    distances: torch.Tensor,
    *,
    height: int,
    width: int,
    min_distance: float = MIN_DISTANCE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-resolved winners: ``(winner, has)`` per pixel.

    Takes ``(N,)`` or batched ``(B, N)`` coordinates and ranges; returns
    ``(H * W,)`` or ``(B, H * W)`` tensors: the index of the winning point
    in its cloud (undefined where ``has`` is False) and the occupancy.
    Points nearer than ``min_distance`` (zero pad rows among them) never
    win; among equal ranges the smallest index wins. For one cloud the
    winner equals the JAX function's everywhere.
    """
    batched = distances.dim() == 2
    if not batched:
        row, col, distances = row[None], col[None], distances[None]
    B, n = distances.shape
    hw = height * width
    valid = distances >= min_distance
    offset = torch.arange(B, device=distances.device)[:, None] * hw
    flat = torch.where(valid, row.long() * width + col.long() + offset, B * hw)
    dist = torch.where(valid, distances.float(), float("inf"))
    key = (flat << 32) | dist.view(torch.int32).long()
    sorted_key, order = torch.sort(key.reshape(-1), stable=True)
    flat_s = sorted_key >> 32
    pixels = torch.arange(B * hw, device=distances.device)
    start = torch.searchsorted(flat_s, pixels).clamp_max(B * n - 1)
    has = flat_s[start] == pixels
    # The index within the cloud; an empty pixel's start may lie in
    # another cloud's run, so it is clamped into range.
    winner = (order[start] - (pixels // hw) * n).clamp(0, n - 1)
    if not batched:
        return winner, has
    return winner.reshape(B, hw), has.reshape(B, hw)


def z_buffer_sorted(
    row: torch.Tensor,
    col: torch.Tensor,
    distances: torch.Tensor,
    values: torch.Tensor,
    *,
    height: int,
    width: int,
    min_distance: float = MIN_DISTANCE,
) -> torch.Tensor:
    """Sort-based z-buffer of one cloud: winners by
    :func:`z_buffer_winner_map`, then one gather of ``values (N, C)``.
    Returns (H, W, C); empty pixels are zero."""
    winner, has = z_buffer_winner_map(
        row, col, distances, height=height, width=width, min_distance=min_distance
    )
    img = torch.where(has[:, None], values[winner], torch.zeros((), dtype=values.dtype))
    return img.reshape(height, width, values.shape[1])


def z_buffer(
    row: torch.Tensor,
    col: torch.Tensor,
    distances: torch.Tensor,
    values: torch.Tensor,
    *,
    height: int,
    width: int,
    min_distance: float = MIN_DISTANCE,
) -> torch.Tensor:
    """Scatter-min z-buffer of one cloud (the JAX ``segment_min`` form):
    the per-pixel minimum range, then the smallest index among the points
    at it. Returns (H, W, C); empty pixels are zero."""
    n = distances.shape[0]
    hw = height * width
    valid = distances >= min_distance
    flat = torch.where(valid, row.long() * width + col.long(), hw)
    dist = torch.where(valid, distances, float("inf"))
    seg_min = torch.full((hw + 1,), float("inf"), dtype=dist.dtype, device=dist.device)
    seg_min = seg_min.scatter_reduce(0, flat, dist, "amin")
    is_min = valid & (distances <= seg_min[flat])
    big = torch.iinfo(torch.int64).max
    idx = torch.where(is_min, torch.arange(n, device=flat.device), big)
    winner = torch.full((hw + 1,), big, dtype=torch.int64, device=flat.device)
    winner = winner.scatter_reduce(0, flat, idx, "amin")[:hw]
    has = winner < big
    safe = torch.where(has, winner, 0)
    img = torch.where(has[:, None], values[safe], torch.zeros((), dtype=values.dtype))
    return img.reshape(height, width, values.shape[1])


def range_view_coordinates_t(
    xyz: torch.Tensor, laser_numbers: torch.Tensor, *, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tensor twin of :func:`range_view_coordinates`: ``xyz (..., 3)``
    float32 -> (row, col) int32 and range float32, in the forms the module
    docstring gives."""
    x, y, z = xyz.unbind(-1)
    az = torch.atan2(y, x)
    r2 = torch.addcmul(torch.addcmul(x * x, y, y), z, z)
    rng = torch.sqrt(r2.double()).float()
    col_scale = float(np.float32(width) / np.float32(2 * np.pi))
    col = ((az + math.pi) * col_scale).to(torch.int32) % width
    row = laser_numbers.to(torch.int32).clamp(0, height - 1)
    return row, col, rng


def rasterize_points(
    xyz: torch.Tensor,
    laser_number: torch.Tensor,
    point_features: Dict[str, torch.Tensor],
    *,
    height: int,
    width: int,
    feature_names: Sequence[str],
    dataset_name: str = "av2",
    x_stride: int = 1,
    pad: int = 0,
    padding_mode: str = "circular",
    min_distance: float = MIN_DISTANCE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw clouds -> (features, cart, mask), each cloud as the JAX
    ``rasterize_points_jax`` rasterizes it.

    Args:
        xyz: (B, N, 3) sensor-frame points; pad clouds with zero rows
            (range 0 < ``min_distance`` drops them).
        laser_number: (B, N) row index per point.
        point_features: name -> (B, N) extra channels ("intensity",
            "elongation", "timedelta_ns", ...).
        feature_names: channel order of the feature image.
        pad: per-side column padding (``data.dataset.width_padding``).

    Returns:
        features (B, H, Wp, C), cart (B, H, Wp, 3), mask (B, H, Wp), with
        Wp = (width + 2 * pad) / x_stride: the layout ``serving.Predictor``
        takes. ``view`` is 2 for lasers up to 32, 1 above and 0 where the
        pixel is empty; Waymo's intensity is ``tanh``-squashed and
        ``timedelta_ns`` scaled to seconds; empty pixels' features are 0.
    """
    xyz = xyz.float()
    B = xyz.shape[0]
    row, col, rng = range_view_coordinates_t(xyz, laser_number, height=height, width=width)
    winner, has = z_buffer_winner_map(
        row, col, rng, height=height, width=width, min_distance=min_distance
    )

    per_point = {
        "range": rng,
        "x": xyz[..., 0],
        "y": xyz[..., 1],
        "z": xyz[..., 2],
        "view": laser_number.float(),
    }
    for k, v in point_features.items():
        per_point[k] = v.float()
    # One gather for every channel: the per-point columns stacked (B, N, C').
    chan_names = ["range", "x", "y", "z"] + [
        n for n in feature_names if n not in ("range", "x", "y", "z")
    ]
    stacked = torch.stack([per_point[n] for n in chan_names], dim=-1)
    index = winner[..., None].expand(B, height * width, len(chan_names))
    gathered = torch.gather(stacked, 1, index)
    gathered = torch.where(has[..., None], gathered, 0.0).reshape(
        B, height, width, len(chan_names)
    )
    chan = {n: gathered[..., i] for i, n in enumerate(chan_names)}
    mask = chan["range"] > 0.0

    planes = []
    for name in feature_names:
        if name == "view":
            # Laser -> sensor view (loader.py:605-621): 2 for the upper
            # 32-beam LiDAR, 1 for the lower, 0 for empty pixels.
            plane = torch.where(
                mask, torch.where(chan["view"] <= 32, 2.0, 1.0), 0.0
            )
        else:
            plane = chan[name]
            if name == "intensity" and dataset_name == "waymo":
                plane = torch.tanh(plane)
            elif name == "timedelta_ns":
                plane = plane * 1e-9
        planes.append(plane)
    feats = torch.stack(planes, dim=-1) * mask[..., None]
    cart = torch.stack([chan["x"], chan["y"], chan["z"]], dim=-1)

    def pad_stride(t: torch.Tensor) -> torch.Tensor:
        if pad:
            if padding_mode == "circular":
                t = torch.cat([t[:, :, -pad:], t, t[:, :, :pad]], dim=2)
            else:
                zeros = t.new_zeros(t.shape[:2] + (pad,) + t.shape[3:])
                t = torch.cat([zeros, t, zeros], dim=2)
        return t[:, :, ::x_stride]

    return pad_stride(feats), pad_stride(cart), pad_stride(mask)
