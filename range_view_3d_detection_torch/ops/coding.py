"""Azimuth-invariant box coding (counterpart of the JAX ``ops/coding.py``).

Regressand layout (8 channels, last axis): [0:3] offset from the pixel's
return to the box centre (in the pixel-azimuth frame when
azimuth-invariant), [3:6] log(l, w, h), [6:8] sin/cos of the yaw
(relative to the pixel azimuth when azimuth-invariant). Always fp32.
"""

from __future__ import annotations

import torch


def pixel_azimuth(cart: torch.Tensor) -> torch.Tensor:
    """Azimuth of each pixel's return. ``cart (..., 3)`` -> ``(...,)``."""
    return torch.atan2(cart[..., 1], cart[..., 0])


def encode_boxes(
    boxes: torch.Tensor, cart: torch.Tensor, *, azimuth_invariant: bool = True
) -> torch.Tensor:
    """Encode one cuboid ``(..., 7)`` a pixel relative to its return
    ``cart (..., 3)`` into regression targets ``(..., 8)``; the inverse of
    :func:`decode_boxes`."""
    offset = boxes[..., 0:3] - cart
    yaw = boxes[..., 6]
    if azimuth_invariant:
        az = pixel_azimuth(cart)
        cos, sin = torch.cos(az), torch.sin(az)
        # World -> azimuth frame: R(-az) applied to the offset.
        ox = cos * offset[..., 0] + sin * offset[..., 1]
        oy = -sin * offset[..., 0] + cos * offset[..., 1]
        offset = torch.stack([ox, oy, offset[..., 2]], dim=-1)
        yaw = yaw - az
    log_dims = torch.log(torch.clamp_min(boxes[..., 3:6], 1e-6))
    return torch.cat(
        [offset, log_dims, torch.sin(yaw)[..., None], torch.cos(yaw)[..., None]],
        dim=-1,
    )


def decode_boxes(
    regressands: torch.Tensor, cart: torch.Tensor, *, azimuth_invariant: bool = True
) -> torch.Tensor:
    """Decode per-pixel regressands into cuboids ``(..., 7)``
    (x, y, z, l, w, h, yaw), in fp32."""
    regressands = regressands.float()
    cart = cart.float()
    offset = regressands[..., 0:3]
    lwh = torch.exp(regressands[..., 3:6])
    yaw = torch.atan2(regressands[..., 6], regressands[..., 7])
    if azimuth_invariant:
        az = pixel_azimuth(cart)
        cos, sin = torch.cos(az), torch.sin(az)
        ox = cos * offset[..., 0] - sin * offset[..., 1]
        oy = sin * offset[..., 0] + cos * offset[..., 1]
        offset = torch.stack([ox, oy, offset[..., 2]], dim=-1)
        yaw = yaw + az
    ctr = cart + offset
    return torch.cat([ctr, lwh, yaw[..., None]], dim=-1)
