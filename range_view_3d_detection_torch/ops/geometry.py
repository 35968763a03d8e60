"""Geometry primitives (counterpart of the JAX ``ops/geometry.py``):
spherical and Cartesian coordinates, yaw-only quaternions, angle
wrapping, cuboid vertices and the point-in-cuboid test. fp32,
broadcasting over leading dimensions.
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


def cart_to_sph(xyz: torch.Tensor) -> torch.Tensor:
    """Cartesian ``(..., 3)`` -> spherical ``(..., 3)``: (azimuth,
    inclination, radius) with azimuth ``atan2(y, x)``, inclination
    ``atan2(z, hypot(x, y))`` and radius ``|xyz|``."""
    x, y, z = xyz.unbind(-1)
    hxy = torch.hypot(x, y)
    return torch.stack(
        [torch.atan2(y, x), torch.atan2(z, hxy), torch.hypot(hxy, z)], dim=-1
    )


def sph_to_cart(sph: torch.Tensor) -> torch.Tensor:
    """Spherical ``(..., 3)`` (azimuth, inclination, radius) -> Cartesian."""
    az, incl, r = sph.unbind(-1)
    rcos = r * torch.cos(incl)
    return torch.stack(
        [rcos * torch.cos(az), rcos * torch.sin(az), r * torch.sin(incl)], dim=-1
    )


def yaw_to_quat(yaw: torch.Tensor) -> torch.Tensor:
    """Yaw ``(...,)`` -> unit quaternion ``(..., 4)`` in wxyz order (a
    rotation about +z)."""
    half = yaw * 0.5
    w, z = torch.cos(half), torch.sin(half)
    zeros = torch.zeros_like(w)
    return torch.stack([w, zeros, zeros, z], dim=-1)


def quat_to_yaw(quat_wxyz: torch.Tensor) -> torch.Tensor:
    """Unit quaternion ``(..., 4)`` wxyz -> yaw ``(...,)`` (the zyx
    Tait-Bryan yaw)."""
    w, x, y, z = quat_wxyz.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


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
