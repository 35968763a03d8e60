"""Inference decoding: per-pixel boxes -> range-subsampled proposals -> NMS
(counterpart of the JAX ``models/decoder.py``). Band masks zero scores
instead of gathering, so the proposal set has a fixed length per
(H, W, rates). Decode stays fp32."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from range_view_3d_detection_torch.ops import coding
from range_view_3d_detection_torch.ops.nms import NMSResult, batched_multiclass_nms
from range_view_3d_detection_torch.results import Proposals


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """The JAX ``DecoderConfig`` (``conf/model/range_view.yaml``
    ``_decoder`` + ``post_processing_config``) without ``num_pre_nms``,
    which the static ``nms_cap`` replaces there too."""

    enable_azimuth_invariant_targets: bool = True
    enable_sample_by_range: bool = True
    lower_bounds: Tuple[float, ...] = (0.0, 15.0, 30.0)
    upper_bounds: Tuple[float, ...] = (15.0, 30.0, float("inf"))
    subsampling_rates: Tuple[int, ...] = (8, 2, 1)
    num_post_nms: int = 1000
    nms_threshold: float = 0.3
    min_confidence: float = 0.1
    nms_mode: str = "WEIGHTED"
    nms_cap: int = 1024


def sample_by_range(
    scores: torch.Tensor,
    categories: torch.Tensor,
    cuboids: torch.Tensor,
    cart: torch.Tensor,
    cfg: DecoderConfig,
) -> Proposals:
    """Range-banded column subsampling: band i keeps every ``rates[i]``-th
    column; proposals outside the band get score 0."""
    dists = torch.sqrt((cart * cart).sum(-1))
    B = scores.shape[0]
    parts_s, parts_c, parts_b = [], [], []
    for lo, hi, rate in zip(cfg.lower_bounds, cfg.upper_bounds, cfg.subsampling_rates):
        band = (dists > lo) & (dists <= hi)
        parts_s.append((scores * band)[:, :, ::rate].reshape(B, -1))
        parts_c.append(categories[:, :, ::rate].reshape(B, -1))
        parts_b.append(cuboids[:, :, ::rate].reshape(B, -1, cuboids.shape[-1]))
    return Proposals(
        cuboids=torch.cat(parts_b, dim=1),
        scores=torch.cat(parts_s, dim=1),
        categories=torch.cat(parts_c, dim=1),
    )


def decode(
    outputs: Dict[str, Any],
    cfg: DecoderConfig,
    tasks: Dict[int, Tuple[str, ...]],
    *,
    use_nms: bool = True,
) -> NMSResult | Proposals:
    """Decode the Detector's outputs into detections.

    Category indices are offset by the preceding tasks' sizes. Returns an
    ``NMSResult`` (``min(nms_cap, N)`` slots per image, rounded up to the
    scan block, with keep masks) when ``use_nms``, else raw ``Proposals``.
    """
    all_parts = []
    for stride, head_s in outputs["head"].items():
        cart = outputs["strided"][stride]["cart"].float()
        mask = outputs["strided"][stride]["mask"]
        task_offset = 0
        for task_id, cats in tasks.items():
            out = head_s[task_id]
            probs = torch.sigmoid(out["logits"].float()) * mask[..., None]
            scores = probs.amax(dim=-1)
            categories = probs.argmax(dim=-1).to(torch.int32)
            cuboids = coding.decode_boxes(
                out["regressands"], cart,
                azimuth_invariant=cfg.enable_azimuth_invariant_targets,
            )
            if cfg.enable_sample_by_range:
                part = sample_by_range(scores, categories, cuboids, cart, cfg)
            else:
                B = scores.shape[0]
                part = Proposals(
                    cuboids=cuboids.reshape(B, -1, 7),
                    scores=scores.reshape(B, -1),
                    categories=categories.reshape(B, -1),
                )
            all_parts.append(part._replace(categories=part.categories + task_offset))
            task_offset += len(cats)

    proposals = Proposals(*(torch.cat(list(t), dim=1) for t in zip(*all_parts)))
    if not use_nms:
        return proposals
    return batched_multiclass_nms(
        proposals.cuboids,
        proposals.scores,
        proposals.categories,
        cap=min(cfg.nms_cap, proposals.scores.shape[1]),
        iou_threshold=cfg.nms_threshold,
        min_confidence=cfg.min_confidence,
        mode=cfg.nms_mode,
        num_post_nms=cfg.num_post_nms,
    )
