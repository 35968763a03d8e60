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


def _points_in_rect(pts: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """``pts (..., N, 2)`` inside rotated rect ``(..., 5)`` -> ``(..., N)`` bool."""
    x, y, l, w, yaw = rect.unbind(-1)
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    dx = pts[..., 0] - x[..., None]
    dy = pts[..., 1] - y[..., None]
    px = cos[..., None] * dx + sin[..., None] * dy
    py = -sin[..., None] * dx + cos[..., None] * dy
    eps = 1e-5
    return (px.abs() <= l[..., None] * 0.5 + eps) & (py.abs() <= w[..., None] * 0.5 + eps)


def _edge_intersections(ca: torch.Tensor, cb: torch.Tensor):
    """The 16 intersection points of two quads' edges: points ``(..., 16,
    2)`` and valid ``(..., 16)``, from corners ``(..., 4, 2)``."""
    a1 = ca[..., :, None, :]
    a2 = torch.roll(ca, -1, dims=-2)[..., :, None, :]
    b1 = cb[..., None, :, :]
    b2 = torch.roll(cb, -1, dims=-2)[..., None, :, :]
    d1 = a2 - a1
    d2 = b2 - b1
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    rel = b1 - a1
    safe = torch.where(denom.abs() > _EPS, denom, torch.ones_like(denom))
    t = (rel[..., 0] * d2[..., 1] - rel[..., 1] * d2[..., 0]) / safe
    u = (rel[..., 0] * d1[..., 1] - rel[..., 1] * d1[..., 0]) / safe
    valid = (
        (denom.abs() > _EPS)
        & (t >= -1e-6) & (t <= 1.0 + 1e-6)
        & (u >= -1e-6) & (u <= 1.0 + 1e-6)
    )
    pts = a1 + t[..., None] * d1
    shape = pts.shape[:-3] + (16, 2)
    return pts.reshape(shape), valid.reshape(shape[:-1])


def _rotated_rect_intersection_area_sorted(
    boxes_a: torch.Tensor, boxes_b: torch.Tensor
) -> torch.Tensor:
    """Candidate-point + angle-sort formulation of
    :func:`rotated_rect_intersection_area` (the JAX package keeps it as a
    reference for tests): A's corners in B, B's corners in A and the 16
    edge crossings, sorted by angle about their centroid with the bitonic
    network (``ops/sorting.py``), then the shoelace formula."""
    from range_view_3d_detection_torch.ops.sorting import sort_with_payload

    ca = box_corners_bev(boxes_a)
    cb = box_corners_bev(boxes_b)
    a_in_b = _points_in_rect(ca, boxes_b)
    b_in_a = _points_in_rect(cb, boxes_a)
    inter_pts, inter_valid = _edge_intersections(ca, cb)

    batch = torch.broadcast_shapes(ca.shape[:-2], cb.shape[:-2])
    pts = torch.cat(
        [ca.expand(batch + (4, 2)), cb.expand(batch + (4, 2)), inter_pts], dim=-2
    )
    valid = torch.cat(
        [a_in_b.expand(batch + (4,)), b_in_a.expand(batch + (4,)), inter_valid], dim=-1
    )
    count = valid.sum(dim=-1, keepdim=True)
    vf = valid[..., None].to(pts.dtype)
    centroid = (pts * vf).sum(dim=-2, keepdim=True) / count[..., None].clamp_min(1).to(
        pts.dtype
    )
    rel = pts - centroid
    angle = torch.atan2(rel[..., 1], rel[..., 0])
    angle = torch.where(valid, angle, torch.full_like(angle, 1e9))  # invalid last
    _, sorted_pts = sort_with_payload(angle, pts)  # padded to 32

    # Trailing (invalid) slots repeat the first point, so the cyclic
    # shoelace closes and degenerate edges add 0.
    idx = torch.arange(sorted_pts.shape[-2], device=pts.device)
    keep = (idx < count)[..., None]
    poly = torch.where(keep, sorted_pts, sorted_pts[..., 0:1, :])
    nxt = torch.roll(poly, -1, dims=-2)
    area2 = (poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]).sum(dim=-1)
    area = 0.5 * area2.abs()
    return torch.where(count[..., 0] >= 3, area, torch.zeros_like(area))


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


def iou_3d_aligned(cuboids_a: torch.Tensor, cuboids_b: torch.Tensor) -> torch.Tensor:
    """Elementwise 3D IoU of cuboid pairs ``(..., 7)``: the rotated-BEV IoU
    turned back into a BEV overlap area, times the vertical overlap, over
    the union of the volumes."""
    iou_bev = iou_rotated_bev_aligned(cuboids_a, cuboids_b)
    area_a = cuboids_a[..., 3] * cuboids_a[..., 4]
    area_b = cuboids_b[..., 3] * cuboids_b[..., 4]
    overlaps_bev = iou_bev * (area_a + area_b) / (1.0 + iou_bev)
    top = torch.minimum(
        cuboids_a[..., 2] + cuboids_a[..., 5] * 0.5,
        cuboids_b[..., 2] + cuboids_b[..., 5] * 0.5,
    )
    btm = torch.maximum(
        cuboids_a[..., 2] - cuboids_a[..., 5] * 0.5,
        cuboids_b[..., 2] - cuboids_b[..., 5] * 0.5,
    )
    inter_3d = overlaps_bev * (top - btm).clamp_min(0.0)
    vol_a = area_a * cuboids_a[..., 5]
    vol_b = area_b * cuboids_b[..., 5]
    iou = inter_3d / (vol_a + vol_b - inter_3d).clamp_min(_EPS)
    return torch.nan_to_num(iou).clamp(0.0, 1.0)
