"""Classification and regression losses (counterpart of the JAX
``ops/losses.py``): unreduced, elementwise, in the dtype of their inputs
(the heads give fp32 logits and regressands)."""

from __future__ import annotations

import torch


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits: ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    return (
        torch.clamp_min(logits, 0.0)
        - logits * targets
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def varifocal_loss(
    logits: torch.Tensor, targets: torch.Tensor, *, alpha: float = 0.75, gamma: float = 2.0
) -> torch.Tensor:
    """Varifocal loss: target-weighted BCE on the foreground (target > 0),
    BCE weighted by ``alpha * p^gamma`` on the background (target == 0)."""
    bce = sigmoid_bce(logits, targets)
    p = torch.sigmoid(logits)
    fg = (targets > 0.0).to(bce.dtype)
    bg = (targets == 0.0).to(bce.dtype)
    return fg * targets * bce + alpha * bg * torch.pow(p, gamma) * bce


def focal_loss(
    logits: torch.Tensor, targets: torch.Tensor, *, alpha: float = 0.25, gamma: float = 2.0
) -> torch.Tensor:
    """Sigmoid focal loss (RetinaNet); ``alpha < 0`` drops the class weight."""
    bce = sigmoid_bce(logits, targets)
    p = torch.sigmoid(logits)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = bce * torch.pow(1.0 - p_t, gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def penalty_reduced_focal_loss(
    logits: torch.Tensor, targets: torch.Tensor, *, alpha: float, gamma: float
) -> torch.Tensor:
    """CenterNet-style penalty-reduced focal loss, with the JAX package's
    (and its reference's) soft-target BCE in the background term."""
    bce = sigmoid_bce(logits, targets)
    p = torch.sigmoid(logits)
    fg = (targets == 1.0).to(bce.dtype)
    bg_penalty = torch.pow(1.0 - targets, 4.0)
    fg_loss = fg * torch.pow(1.0 - p, gamma) * bce
    bg_loss = alpha * bg_penalty * torch.pow(p, gamma) * bce
    return fg_loss + bg_loss


def l1_loss(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise L1."""
    return torch.abs(inputs - targets)
