"""Dense per-pixel training targets (counterpart of the JAX
``ops/targets.py``), batched over the leading axis instead of ``vmap``.

Each pixel's "winner" is the box with the lowest priority key ``count * K
+ index`` among the boxes whose interior holds it: the fewest strided
interior points first, annotation order on ties. FPN assignment (None,
RANGE or POINTS) masks the keys. Everything is static-shape and fp32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from range_view_3d_detection_torch.ops import coding, geometry

_BIG = torch.iinfo(torch.int32).max


class StrideTargets(NamedTuple):
    """Targets for one (stride, task) pair over a batch (``Ws = W // stride``)."""

    labels: torch.Tensor  # (B, H, Ws) int32; C_t == background
    winner_index: torch.Tensor  # (B, H, Ws) int32; -1 == no instance
    regression_targets: torch.Tensor  # (B, H, Ws, 8) fp32
    points_per_obj: torch.Tensor  # (B, H, Ws) int32 strided count of the winner
    num_objects: torch.Tensor  # (B,) int32: boxes winning >= 1 pixel


def interior_mask(
    cart: torch.Tensor, boxes: torch.Tensor, box_valid: torch.Tensor
) -> torch.Tensor:
    """``cart (..., H, W, 3)``, ``boxes (..., K, 7)``, ``box_valid (..., K)``
    -> ``(..., K, H, W)`` bool. Pixels without a return have cart == 0 and
    may fall inside a box near the origin: callers AND the pixel mask."""
    H, W = cart.shape[-3:-1]
    pts = cart.reshape(*cart.shape[:-3], H * W, 3)
    inside = geometry.points_in_boxes(pts, boxes) & box_valid[..., None]
    return inside.reshape(*inside.shape[:-1], H, W)


def _assignment_key(counts: torch.Tensor, select: torch.Tensor) -> torch.Tensor:
    """Priority key ``(..., K)``: lower wins; unselected boxes get int32 max."""
    K = counts.shape[-1]
    idx = torch.arange(K, dtype=torch.int32, device=counts.device)
    key = counts.to(torch.int32) * K + idx
    return torch.where(select, key, _BIG)


def compute_targets_single(
    cart: torch.Tensor,
    pixel_valid: torch.Tensor,
    boxes: torch.Tensor,
    box_valid: torch.Tensor,
    box_task: torch.Tensor,
    box_offset: torch.Tensor,
    *,
    task_id: int,
    num_categories: int,
    stride: int,
    azimuth_invariant: bool = True,
    fpn_assignment_method: str | None = None,
    range_partition: Tuple[float, float] = (0.0, float("inf")),
    point_interval: Tuple[float, float] = (0.0, float("inf")),
    inside_full: torch.Tensor | None = None,
) -> StrideTargets:
    """Targets at one (stride, task) for a batch: ``cart (B, H, W, 3)``,
    ``pixel_valid (B, H, W)``, ``boxes (B, K, 7)`` and ``box_valid``,
    ``box_task``, ``box_offset (B, K)``. ``inside_full`` is the
    ``(B, K, H, W)`` interior mask already ANDed with ``pixel_valid``
    (:func:`compute_targets` computes it once for every pair)."""
    if inside_full is None:
        inside_full = interior_mask(cart, boxes, box_valid) & pixel_valid[:, None]
    full_counts = inside_full.sum(dim=(-2, -1))  # (B, K)
    inside = inside_full[..., ::stride]  # width-only striding: (B, K, H, Ws)
    cart_s = cart[:, :, ::stride]
    counts = inside.sum(dim=(-2, -1))

    select = box_valid & (box_task == task_id)
    if fpn_assignment_method == "RANGE":
        dists = torch.sqrt((boxes[..., :3] * boxes[..., :3]).sum(-1))
        lo, hi = range_partition
        select = select & (dists > lo) & (dists <= hi)
    elif fpn_assignment_method == "POINTS":
        lo, hi = point_interval
        select = select & (full_counts > lo) & (full_counts <= hi)

    key = _assignment_key(counts, select)  # (B, K)
    pixel_keys = torch.where(
        inside & select[..., None, None], key[..., None, None], _BIG
    )
    best = pixel_keys.amin(dim=1)
    has_winner = best < _BIG
    # Keys below the sentinel are unique, so the first minimum is the winner.
    winner = torch.where(has_winner, pixel_keys.argmin(dim=1).to(torch.int32), -1)

    safe = winner.clamp_min(0).long()  # (B, H, Ws)
    B, H, Ws = safe.shape
    flat = safe.reshape(B, H * Ws)
    labels = torch.where(
        has_winner,
        box_offset.gather(1, flat).reshape(B, H, Ws),
        num_categories,
    ).to(torch.int32)

    win_boxes = boxes.gather(1, flat[..., None].expand(-1, -1, 7)).reshape(B, H, Ws, 7)
    reg = coding.encode_boxes(win_boxes, cart_s, azimuth_invariant=azimuth_invariant)
    reg = torch.where(has_winner[..., None], reg, 0.0)

    points_per_obj = torch.where(
        has_winner, counts.gather(1, flat).reshape(B, H, Ws), 0
    ).to(torch.int32)

    won_pixels = torch.zeros_like(counts, dtype=torch.int32).scatter_add_(
        1, flat, has_winner.reshape(B, H * Ws).to(torch.int32)
    )
    num_objects = (won_pixels > 0).sum(-1).to(torch.int32)
    return StrideTargets(
        labels=labels,
        winner_index=winner,
        regression_targets=reg,
        points_per_obj=points_per_obj,
        num_objects=num_objects,
    )


def compute_targets(
    cart: torch.Tensor,
    pixel_valid: torch.Tensor,
    boxes: torch.Tensor,
    box_valid: torch.Tensor,
    box_task: torch.Tensor,
    box_offset: torch.Tensor,
    *,
    tasks: Dict[int, Sequence[str]],
    fpn_strides: Sequence[int],
    azimuth_invariant: bool = True,
    fpn_assignment_method: str | None = None,
    range_partitions: Dict[int, Tuple[float, float]] | None = None,
    point_intervals: Dict[int, Tuple[float, float]] | None = None,
) -> Dict[int, Dict[int, StrideTargets]]:
    """``{stride: {task_id: StrideTargets}}`` for a padded batch.

    The ``(B, K, H, W)`` interior mask depends only on the batch, so it is
    computed once, outside the (stride, task) loop.
    """
    range_partitions = range_partitions or {}
    point_intervals = point_intervals or {}
    inside_full = interior_mask(cart, boxes, box_valid) & pixel_valid[:, None]
    out: Dict[int, Dict[int, StrideTargets]] = {}
    for stride in fpn_strides:
        out[int(stride)] = {}
        for task_id, cats in tasks.items():
            out[int(stride)][int(task_id)] = compute_targets_single(
                cart, pixel_valid, boxes, box_valid, box_task, box_offset,
                inside_full=inside_full,
                task_id=int(task_id),
                num_categories=len(cats),
                stride=int(stride),
                azimuth_invariant=azimuth_invariant,
                fpn_assignment_method=fpn_assignment_method,
                range_partition=tuple(
                    range_partitions.get(int(stride), (0.0, float("inf")))
                ),
                point_interval=tuple(
                    point_intervals.get(int(stride), (0.0, float("inf")))
                ),
            )
    return out
