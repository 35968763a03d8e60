"""Geometry primitives the targets need (counterpart of the JAX
``ops/geometry.py``): angle wrapping, cuboid vertices and the
point-in-cuboid test. fp32, broadcasting over leading dimensions.
"""

from __future__ import annotations

import torch

Pi = 3.14159265358979323846
Tau = 2.0 * Pi

# Unit cube corner signs in the JAX package's (AV2) order.
_UNIT_VERTS = (
    (+1.0, +1.0, +1.0),
    (+1.0, -1.0, +1.0),
    (+1.0, -1.0, -1.0),
    (+1.0, +1.0, -1.0),
    (-1.0, +1.0, +1.0),
    (-1.0, -1.0, +1.0),
    (-1.0, -1.0, -1.0),
    (-1.0, +1.0, -1.0),
)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to ``[-pi, pi)``."""
    return theta - torch.floor(theta / Tau + 0.5) * Tau


def boxes_to_vertices(boxes: torch.Tensor) -> torch.Tensor:
    """Cuboids ``(..., 7)`` (x, y, z, l, w, h, yaw) -> vertices ``(..., 8, 3)``,
    rotated about +z by the yaw."""
    ctr = boxes[..., None, 0:3]
    half = boxes[..., None, 3:6] * 0.5
    yaw = boxes[..., 6]
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    local = boxes.new_tensor(_UNIT_VERTS) * half  # (..., 8, 3)
    lx, ly, lz = local.unbind(-1)
    wx = cos[..., None] * lx - sin[..., None] * ly
    wy = sin[..., None] * lx + cos[..., None] * ly
    return torch.stack([wx, wy, lz], dim=-1) + ctr


def points_in_boxes(
    points: torch.Tensor, boxes: torch.Tensor, *, inclusive: bool = True
) -> torch.Tensor:
    """Interior test of ``points (..., P, 3)`` against yaw-only cuboids
    ``boxes (..., K, 7)`` -> ``(..., K, P)`` bool: each point rotated into
    the box frame and compared with the half-dimensions, edges included
    unless ``inclusive`` is False."""
    ctr = boxes[..., :, None, 0:3]  # (..., K, 1, 3)
    half = boxes[..., :, None, 3:6] * 0.5
    yaw = boxes[..., :, None, 6]
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    d = points[..., None, :, :] - ctr  # (..., K, P, 3)
    dx, dy, dz = d.unbind(-1)
    local_x = cos * dx + sin * dy
    local_y = -sin * dx + cos * dy
    le = torch.le if inclusive else torch.lt
    return (
        le(local_x.abs(), half[..., 0])
        & le(local_y.abs(), half[..., 1])
        & le(dz.abs(), half[..., 2])
    )
