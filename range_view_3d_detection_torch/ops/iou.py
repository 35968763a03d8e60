"""Rotated-BEV IoU (counterpart of the JAX ``ops/iou.py``), plain fp32 ops:
the pairwise matrix NMS takes and the aligned IoU the BEV affinity takes.

Order-free clipping: the boundary of the intersection of two rotated
rectangles is the parts of A's edges inside B plus the parts of B's edges
inside A, each traversed counter-clockwise, so the shoelace area sums
over independently clipped edges and no vertex sort is needed.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """``(..., 5)`` (x, y, l, w, yaw) -> counter-clockwise corners ``(..., 4, 2)``."""
    x, y, l, w, yaw = boxes.unbind(-1)
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    lx = torch.stack([l, l, -l, -l], dim=-1) * 0.5
    ly = torch.stack([-w, w, w, -w], dim=-1) * 0.5
    cx = cos[..., None] * lx - sin[..., None] * ly + x[..., None]
    cy = sin[..., None] * lx + cos[..., None] * ly + y[..., None]
    return torch.stack([cx, cy], dim=-1)


def _rect_half_planes(rect: torch.Tensor):
    """Rotated rect (..., 5) -> 4 half-planes (normals (..., 4, 2),
    offsets (..., 4)) with inside == n.x <= b."""
    x, y, l, w, yaw = rect.unbind(-1)
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    u = torch.stack([cos, sin], dim=-1)
    v = torch.stack([-sin, cos], dim=-1)
    ctr = torch.stack([x, y], dim=-1)
    normals = torch.stack([u, -u, v, -v], dim=-2)
    half = torch.stack([l, l, w, w], dim=-1) * 0.5
    offsets = (normals * ctr[..., None, :]).sum(-1) + half
    return normals, offsets


def _clipped_edge_area(
    corners: torch.Tensor, normals: torch.Tensor, offsets: torch.Tensor
) -> torch.Tensor:
    """Signed shoelace contribution of ``corners``' edges clipped to the
    half-plane set; an edge lying on a clipping plane counts half (see
    the JAX ``ops/iou.py::_clipped_edge_area``)."""
    p = corners
    q = torch.roll(corners, -1, dims=-2)
    tol = 1e-4
    g0 = (normals[..., None, :, :] * p[..., :, None, :]).sum(-1) - offsets[..., None, :]
    g1 = (normals[..., None, :, :] * q[..., :, None, :]).sum(-1) - offsets[..., None, :]
    gp = g0 - tol
    gq = g1 - tol
    denom = gp - gq
    t_cross = gp / torch.where(denom.abs() > _EPS, denom, torch.full_like(denom, _EPS))
    entering = (gp > 0) & (gq <= 0)
    exiting = (gp <= 0) & (gq > 0)
    empty = (gp > 0) & (gq > 0)
    zero = torch.zeros_like(t_cross)
    t0 = torch.where(entering, t_cross, zero).amax(dim=-1)
    t1 = torch.where(exiting, t_cross, zero + 1.0).amin(dim=-1)
    ok = (~empty.any(dim=-1)) & (t0 < t1)
    on_plane = (g0.abs() <= 2 * tol) & (g1.abs() <= 2 * tol)
    weight = torch.where(on_plane.any(dim=-1), 0.5, 1.0)
    d = q - p
    s0 = p + t0[..., None] * d
    s1 = p + t1[..., None] * d
    contrib = 0.5 * (s0[..., 0] * s1[..., 1] - s1[..., 0] * s0[..., 1])
    return (torch.where(ok, contrib, torch.zeros_like(contrib)) * weight).sum(dim=-1)


def rotated_rect_intersection_area(
    boxes_a: torch.Tensor, boxes_b: torch.Tensor
) -> torch.Tensor:
    """Intersection area of rotated rects ``(..., 5)`` (broadcasting)."""
    ca = box_corners_bev(boxes_a)
    cb = box_corners_bev(boxes_b)
    na, ba = _rect_half_planes(boxes_a)
    nb, bb = _rect_half_planes(boxes_b)
    area = _clipped_edge_area(ca, nb, bb) + _clipped_edge_area(cb, na, ba)
    return area.clamp_min(0.0)


def iou_rotated_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated-BEV IoU: ``(..., N, 5)`` x ``(..., M, 5)`` -> ``(..., N, M)``."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    inter = rotated_rect_intersection_area(a, b)
    area_a = boxes_a[..., 2] * boxes_a[..., 3]
    area_b = boxes_b[..., 2] * boxes_b[..., 3]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    iou = inter / union.clamp_min(_EPS)
    return torch.nan_to_num(iou).clamp(0.0, 1.0)


def _bev5(cuboids: torch.Tensor) -> torch.Tensor:
    """``(..., 7+)`` cuboids -> ``(..., 5)`` BEV boxes (x, y, l, w, yaw)."""
    return cuboids[..., [0, 1, 3, 4, 6]]


def iou_rotated_bev_aligned(cuboids_a: torch.Tensor, cuboids_b: torch.Tensor) -> torch.Tensor:
    """Elementwise (aligned) rotated-BEV IoU of cuboid pairs ``(..., 7)``."""
    a = _bev5(cuboids_a)
    b = _bev5(cuboids_b)
    inter = rotated_rect_intersection_area(a, b)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    iou = inter / union.clamp_min(_EPS)
    return torch.nan_to_num(iou).clamp(0.0, 1.0)
