"""Affinity-aware soft classification targets (counterpart of the JAX
``ops/assignment.py``).

The affinity compares the decoded prediction with the decoded target at
the same pixel, so with ``k = inf`` and no normalisation the whole
computation is pointwise. Finite ``k`` (keep the top-k pixels of each
instance) and ``normalize_affinities`` use segment reductions over the
winner-index image, with segment ``max_boxes`` as the padding segment.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from range_view_3d_detection_torch.ops import coding
from range_view_3d_detection_torch.ops.iou import iou_rotated_bev_aligned


class ClassificationTargets(NamedTuple):
    affinities: torch.Tensor  # (B, H, W, C) soft targets
    foreground_mask: torch.Tensor  # (B, H, W) bool
    background_mask: torch.Tensor  # (B, H, W) bool
    regression_weights: torch.Tensor  # (B, H, W) bool


def gaussian_affinity(
    pred_boxes: torch.Tensor, target_boxes: torch.Tensor, sigma: float
) -> torch.Tensor:
    """``exp(-||d ctr|| / sigma^2)``."""
    d = pred_boxes[..., :3] - target_boxes[..., :3]
    return torch.exp(-torch.sqrt((d * d).sum(-1)) / (sigma**2))


def bev_affinity(pred_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
    """Aligned rotated-BEV IoU."""
    return iou_rotated_bev_aligned(pred_boxes, target_boxes)


def compute_classification_targets(
    regressands: torch.Tensor,
    regression_targets: torch.Tensor,
    labels: torch.Tensor,
    winner_index: torch.Tensor,
    cart: torch.Tensor,
    pixel_valid: torch.Tensor,
    *,
    num_categories: int,
    affinity_fn: str = "GAUSSIAN",
    sigma: float = 1.0,
    k: float = float("inf"),
    normalize_affinities: bool = False,
    azimuth_invariant: bool = True,
    max_boxes: int = 0,
) -> ClassificationTargets:
    """Soft classification targets from the prediction/target affinity.

    ``regressands (B, H, W, 8)`` is detached: no gradient flows through
    the targets. ``max_boxes`` (the K of the padded box set) is needed
    only for finite ``k`` or normalisation.
    """
    regressands = regressands.detach()
    # Kept on purpose, as in the JAX package and its reference: the
    # prediction is always decoded azimuth-invariant, the target with the
    # configured flag.
    pred = coding.decode_boxes(regressands, cart, azimuth_invariant=True)
    tgt = coding.decode_boxes(regression_targets, cart, azimuth_invariant=azimuth_invariant)

    name = affinity_fn.upper()
    if name == "GAUSSIAN":
        aff = gaussian_affinity(pred, tgt, sigma)
    elif name == "BEV":
        aff = bev_affinity(pred, tgt)
    else:
        raise NotImplementedError(f"affinity_fn={affinity_fn}")

    aff = torch.where(winner_index >= 0, aff, 0.0)
    if normalize_affinities or math.isfinite(k):
        if max_boxes <= 0:
            raise ValueError("max_boxes required for finite-k / normalization")
        aff = _per_instance_postprocess(
            aff, winner_index, k=k, normalize=normalize_affinities, max_boxes=max_boxes
        )

    onehot = torch.nn.functional.one_hot(labels.long(), num_categories + 1)
    onehot = onehot[..., :-1].to(aff.dtype)
    foreground_mask = aff > 0.0
    return ClassificationTargets(
        affinities=aff[..., None] * onehot,
        foreground_mask=foreground_mask,
        background_mask=(~foreground_mask) & pixel_valid,
        regression_weights=onehot.sum(-1) > 0.0,
    )


def _per_instance_postprocess(
    aff: torch.Tensor, winner_index: torch.Tensor, *, k: float, normalize: bool,
    max_boxes: int,
) -> torch.Tensor:
    """Per-instance max-normalisation and/or top-k gating, each image's
    segments kept apart by an offset of ``max_boxes + 1`` a batch row."""
    B = aff.shape[0]
    nseg = max_boxes + 1
    flat_aff = aff.reshape(B, -1)
    P = flat_aff.shape[1]
    seg = torch.where(winner_index >= 0, winner_index, max_boxes).reshape(B, P).long()
    seg = (seg + torch.arange(B, device=seg.device)[:, None] * nseg).reshape(-1)
    flat_aff = flat_aff.reshape(-1)

    if normalize:
        seg_max = flat_aff.new_zeros(B * nseg).scatter_reduce(
            0, seg, flat_aff, "amax", include_self=False
        )
        flat_aff = flat_aff / torch.clamp_min(seg_max[seg], 1e-8)

    if math.isfinite(k):
        # Rank within the instance by affinity, descending, ties by flat
        # index: jnp.lexsort((arange, -aff, seg)) as stable sorts, the
        # least significant key first.
        order = torch.argsort(-flat_aff, stable=True)
        order = order[torch.argsort(seg[order], stable=True)]
        seg_sorted = seg[order]
        pos = torch.arange(seg.shape[0], device=seg.device)
        first_pos = pos.new_zeros(B * nseg).scatter_reduce(
            0, seg_sorted, pos, "amin", include_self=False
        )
        ranks = torch.empty_like(pos)
        ranks[order] = pos - first_pos[seg_sorted]
        flat_aff = torch.where(ranks < int(k), flat_aff, 0.0)

    return flat_aff.reshape(aff.shape)
