"""Pure-numpy rotated-BEV IoU for host-side consumers (the port's copy of
the JAX ``evaluation/iou_np.py``).

Same order-free mutual edge-clipping formulation as ``ops/iou.py`` (see
its docstring), in numpy: evaluators, the GT-paste collision test, and
rendering call IoU with constantly-varying shapes, where a jitted kernel
would recompile per shape.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-8
_TOL = 1e-4


def _corners(b: np.ndarray) -> np.ndarray:
    x, y, l, w, yaw = b[..., 0], b[..., 1], b[..., 2], b[..., 3], b[..., 4]
    c, s = np.cos(yaw), np.sin(yaw)
    lx = np.stack([l, l, -l, -l], -1) * 0.5
    ly = np.stack([-w, w, w, -w], -1) * 0.5
    cx = c[..., None] * lx - s[..., None] * ly + x[..., None]
    cy = s[..., None] * lx + c[..., None] * ly + y[..., None]
    return np.stack([cx, cy], -1)


def _half_planes(b: np.ndarray):
    x, y, l, w, yaw = b[..., 0], b[..., 1], b[..., 2], b[..., 3], b[..., 4]
    c, s = np.cos(yaw), np.sin(yaw)
    u = np.stack([c, s], -1)
    v = np.stack([-s, c], -1)
    ctr = np.stack([x, y], -1)
    n = np.stack([u, -u, v, -v], -2)
    half = np.stack([l, l, w, w], -1) * 0.5
    off = (n * ctr[..., None, :]).sum(-1) + half
    return n, off


def _clipped_area(corners, normals, offsets):
    p = corners
    q = np.roll(corners, -1, axis=-2)
    g0 = (normals[..., None, :, :] * p[..., :, None, :]).sum(-1) - offsets[
        ..., None, :
    ]
    g1 = (normals[..., None, :, :] * q[..., :, None, :]).sum(-1) - offsets[
        ..., None, :
    ]
    gp = g0 - _TOL
    gq = g1 - _TOL
    denom = gp - gq
    safe = np.where(np.abs(denom) > _EPS, denom, _EPS)
    t_cross = gp / safe
    entering = (gp > 0) & (gq <= 0)
    exiting = (gp <= 0) & (gq > 0)
    empty = (gp > 0) & (gq > 0)
    t0 = np.max(np.where(entering, t_cross, 0.0), axis=-1)
    t1 = np.min(np.where(exiting, t_cross, 1.0), axis=-1)
    ok = (~empty.any(-1)) & (t0 < t1)
    # Shared-boundary (on-plane) edges at half weight: identical boxes
    # count their boundary once, tangent boxes cancel to zero (see
    # ops/iou.py::_clipped_edge_area).
    on_plane = (np.abs(g0) <= 2 * _TOL) & (np.abs(g1) <= 2 * _TOL)
    weight = np.where(on_plane.any(-1), 0.5, 1.0)
    d = q - p
    s0 = p + t0[..., None] * d
    s1 = p + t1[..., None] * d
    contrib = 0.5 * (s0[..., 0] * s1[..., 1] - s1[..., 0] * s0[..., 1])
    return (np.where(ok, contrib, 0.0) * weight).sum(-1)


def intersection_area(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection area of rotated rects ``(..., 5)`` (x, y, l, w, yaw)."""
    ca, cb = _corners(a), _corners(b)
    na, ba = _half_planes(a)
    nb, bb = _half_planes(b)
    area = _clipped_area(ca, nb, bb) + _clipped_area(cb, na, ba)
    return np.maximum(area, 0.0)


def iou_rotated_bev_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 5) x (M, 5) -> (N, M) rotated-BEV IoU matrix."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    inter = intersection_area(a[:, None], b[None, :])
    union = (
        (a[:, 2] * a[:, 3])[:, None]
        + (b[:, 2] * b[:, 3])[None]
        - inter
    )
    return np.clip(np.nan_to_num(inter / np.maximum(union, _EPS)), 0.0, 1.0)
