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
# ``iou_rotated_bev``'s largest intermediates, (..., rows, cap, 4, 4, 2)
# fp32, hold 128 bytes a pair; a row block keeps each under about 1 GB.
_PAIR_BYTES = 128
_BLOCK_BYTES = 1 << 30


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


def block_rows(B: int, cap: int) -> int:
    """Rows of a block of the IoU matrix whose intermediates stay under
    about 1 GB."""
    return max(1, _BLOCK_BYTES // (_PAIR_BYTES * B * cap))


def blocked_iou(bev: torch.Tensor, rows: int) -> torch.Tensor:
    """The (B, cap, cap) rotated IoU of ``bev`` (B, cap, 5) with itself,
    ``rows`` rows at a time (the JAX ``_block_iou``): the same formula in
    the same op order as :func:`iou_rotated_bev` on the whole matrix, so
    each row equals it bit for bit. One block is the whole matrix."""
    B, cap, _ = bev.shape
    if rows >= cap:
        return iou_rotated_bev(bev, bev)
    out = bev.new_empty((B, cap, cap))
    for r0 in range(0, cap, rows):
        out[:, r0 : r0 + rows] = iou_rotated_bev(bev[:, r0 : r0 + rows], bev)
    return out


def iou_matrix(bev: torch.Tensor) -> torch.Tensor:
    """The scan's IoU matrix in row blocks of :func:`block_rows` (whole at
    the served cap 1024 and B=2; at cap 9216 and B=2 whole, its (B, cap,
    cap, 4, 4) intermediates would each take 10.9 GB), as the JAX package
    builds it past cap 4096 (``ops/nms.py:56-58``)."""
    B, cap, _ = bev.shape
    return blocked_iou(bev, block_rows(B, cap))


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
    does; past ``N`` the slots are padding (score -1, invalid). Any cap:
    the IoU matrix is built in row blocks (:func:`iou_matrix`).
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
        iou=iou_matrix(bev),
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
