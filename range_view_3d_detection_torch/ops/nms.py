"""Rotated multi-class NMS, HARD and WEIGHTED (counterpart of the JAX
``ops/nms.py``), batched.

Proposals are cut to a fixed ``cap`` by score (stable descending sort,
the tie order of ``lax.top_k``: lower index first), put onto a
per-category patch of the plane so cross-class IoU is 0, and scanned
greedily in score order over their (cap, cap) rotated-IoU matrix by
``kernels/nms.py::nms_scan`` (K2 on the card). WEIGHTED mode outputs the
score-weighted mean of each kept box's cluster (IoU >= 0.5) over
(x, y, z, l, w, h, sin, cos, score); HARD mode keeps the box itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from range_view_3d_detection_torch.kernels.nms import nms_scan
from range_view_3d_detection_torch.ops.iou import iou_rotated_bev
from range_view_3d_detection_torch.results import NMSResult

_CLASS_GRID = 8
_CLASS_SPACING = 2000.0  # metres; far beyond any real box extent


def _class_offset_bev(bev: torch.Tensor, categories: torch.Tensor) -> torch.Tensor:
    """Push each category onto its own distant patch of the plane."""
    cat = categories.float()
    dx = torch.remainder(cat, _CLASS_GRID) * _CLASS_SPACING
    dy = torch.floor(cat / _CLASS_GRID) * _CLASS_SPACING
    bev = bev.clone()
    bev[..., 0] += dx
    bev[..., 1] += dy
    return bev


def _apply_post_nms_cap(
    keep: torch.Tensor, scores: torch.Tensor, num_post_nms: int
) -> torch.Tensor:
    """Keep only the top ``num_post_nms`` detections per image by score;
    ties go by rank (stable sort). 0 disables."""
    if num_post_nms <= 0 or num_post_nms >= keep.shape[-1]:
        return keep
    masked = torch.where(keep, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device).expand_as(order)
    )
    return keep & (rank < num_post_nms)


class NMSInputs(NamedTuple):
    """What the greedy scan consumes, in descending score order."""

    iou: torch.Tensor  # (B, cap, cap) rotated BEV IoU, classes apart
    scores: torch.Tensor  # (B, cap)
    valid: torch.Tensor  # (B, cap) bool
    payload: torch.Tensor  # (B, cap, 9)
    categories: torch.Tensor  # (B, cap)
    merge_threshold: float
    weighted: bool


def nms_inputs(
    cuboids: torch.Tensor,
    scores: torch.Tensor,
    categories: torch.Tensor,
    *,
    cap: int,
    block: int = 64,
    merge_threshold: float = 0.5,
    min_confidence: float = 0.1,
    mode: str = "WEIGHTED",
) -> NMSInputs:
    """Top-``cap`` selection, class offsets, payload and IoU matrix.

    ``cap`` is rounded up to a multiple of ``block`` as the JAX block scan
    does; past ``N`` the slots are padding (score -1, invalid).
    """
    B, n = scores.shape
    cap = min(cap, n)
    cap = ((cap + block - 1) // block) * block
    masked = torch.where(
        scores >= min_confidence, scores, torch.full_like(scores, -1.0)
    )
    if cap > n:
        masked = torch.cat([masked, masked.new_full((B, cap - n), -1.0)], dim=1)
    top_scores, top_idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :cap], top_idx[:, :cap].clamp_max(n - 1)
    boxes = torch.gather(cuboids, 1, top_idx[..., None].expand(B, cap, 7))
    cats = torch.gather(categories, 1, top_idx)
    # Slices, not a list index: a list would be copied from the host, which
    # a CUDA graph's capture refuses.
    bev = _class_offset_bev(
        torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], dim=-1), cats
    )
    payload = torch.cat(
        [
            boxes[..., :6],
            torch.sin(boxes[..., 6:7]),
            torch.cos(boxes[..., 6:7]),
            top_scores[..., None],
        ],
        dim=-1,
    )
    weighted = mode.upper() == "WEIGHTED"
    return NMSInputs(
        iou=iou_rotated_bev(bev, bev),
        scores=top_scores,
        valid=top_scores >= min_confidence,
        payload=payload,
        categories=cats,
        merge_threshold=merge_threshold if weighted else 1.01,
        weighted=weighted,
    )


def nms_result(
    inputs: NMSInputs, keep: torch.Tensor, merged: torch.Tensor, num_post_nms: int
) -> NMSResult:
    """Cuboids and scores of the scan's output, then the post-NMS cap."""
    yaw = torch.atan2(merged[..., 6], merged[..., 7])
    out_cuboids = torch.cat([merged[..., :6], yaw[..., None]], dim=-1)
    out_scores = torch.where(
        keep,
        merged[..., 8] if inputs.weighted else inputs.scores,
        torch.zeros_like(inputs.scores),
    )
    keep = _apply_post_nms_cap(keep, out_scores, num_post_nms)
    return NMSResult(
        cuboids=out_cuboids, scores=out_scores, categories=inputs.categories,
        keep=keep,
    )


def batched_multiclass_nms(
    cuboids: torch.Tensor,
    scores: torch.Tensor,
    categories: torch.Tensor,
    *,
    cap: int = 2048,
    block: int = 64,
    iou_threshold: float = 0.3,
    merge_threshold: float = 0.5,
    min_confidence: float = 0.1,
    mode: str = "WEIGHTED",
    num_post_nms: int = 0,
) -> NMSResult:
    """Multi-class NMS of each image with a fixed output size.

    Args:
        cuboids: ``(B, N, 7)`` (x, y, z, l, w, h, yaw).
        scores: ``(B, N)``.
        categories: ``(B, N)`` int.
        cap: pre-NMS proposal budget (see :func:`nms_inputs`).

    Returns:
        ``NMSResult`` with ``cap`` slots per image and a ``keep`` mask.
    """
    inputs = nms_inputs(
        cuboids, scores, categories, cap=cap, block=block,
        merge_threshold=merge_threshold, min_confidence=min_confidence, mode=mode,
    )
    keep, merged = nms_scan(
        inputs.iou, inputs.scores, inputs.valid, inputs.payload,
        iou_threshold=iou_threshold, merge_threshold=inputs.merge_threshold,
    )
    return nms_result(inputs, keep, merged, num_post_nms)


def multiclass_nms(
    cuboids: torch.Tensor, scores: torch.Tensor, categories: torch.Tensor, **kwargs
) -> NMSResult:
    """Single-image form of :func:`batched_multiclass_nms`: ``(N, 7)``,
    ``(N,)``, ``(N,)`` in, ``(cap, ...)`` out."""
    r = batched_multiclass_nms(cuboids[None], scores[None], categories[None], **kwargs)
    return NMSResult(*(t[0] for t in r))
