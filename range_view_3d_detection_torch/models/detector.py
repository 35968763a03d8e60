"""The range-view detector's eval forward (counterpart of the JAX
``models/detector.py``; targets and the training loss are not ported yet).

Batch layout (channel-last, as in the JAX package):
    features (B, H, W, C), cart (B, H, W, 3), mask (B, H, W) bool.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from range_view_3d_detection_torch.models.backbone import RangeNet, out_channels
from range_view_3d_detection_torch.models.heads import (
    FOCAL_PRIOR_PROB,
    DenseHead,
    DetectionHead,
)
from range_view_3d_detection_torch.models.stems import MetaKernel


@dataclasses.dataclass(frozen=True)
class TargetsConfig:
    """The part of the JAX ``TargetsConfig`` the eval forward reads."""

    fpn_assignment_method: str | None = None
    range_partitions: Tuple[Tuple[int, Tuple[float, float]], ...] = (
        (1, (0.0, float("inf"))),
    )


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static configuration of the detector: the fields of the JAX
    ``DetectorConfig`` that the eval forward reads (the loss, target and
    rematerialisation fields come with the training slice)."""

    tasks: Tuple[Tuple[int, Tuple[str, ...]], ...]
    in_channels: int = 5
    layers: Tuple[int, ...] = (64, 64, 128, 128, 128)
    stage_blocks: Tuple[int, ...] = (2, 3, 3, 5, 5)
    stem_type: str = "BASIC"
    num_neighbors: int = 3
    num_stem_layers: int = 2
    projection_kernel_size: int = 1
    fpn: Tuple[Tuple[int, int], ...] = ((1, 128),)
    fpn_kernel_sizes: Tuple[Tuple[int, Tuple[int, int]], ...] = ((1, (3, 3)),)
    classification_head_channels: int = 128
    regression_head_channels: int = 128
    num_classification_blocks: int = 4
    num_regression_blocks: int = 4
    final_kernel_size: int = 1
    targets: TargetsConfig = TargetsConfig()
    dtype: str = "bfloat16"
    # The META eval stem through the fused kernel (K1, fp32 sum of the nine
    # neighbours), as the JAX ``stem_pallas`` picks its Pallas kernel; False
    # takes the accumulate path (bf16 terms summed in the compute dtype).
    stem_pallas: bool = False

    @property
    def tasks_dict(self) -> Dict[int, Tuple[str, ...]]:
        return {int(k): tuple(v) for k, v in self.tasks}

    @property
    def fpn_strides(self) -> Tuple[int, ...]:
        return tuple(int(k) for k, _ in self.fpn)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


class Detector(nn.Module):
    """Backbone + multi-scale detection head, eval forward.

    Built on ``device`` (``"cuda"`` unless the caller asks for the CPU)
    with weights drawn from ``generator`` (a CPU ``torch.Generator``, so a
    seed gives the same weights on every device); load trained or
    transplanted weights with ``load_state_dict``.
    """

    def __init__(
        self,
        config: DetectorConfig,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.config = config
        dt = config.compute_dtype
        ms_channels = out_channels(config.layers)
        with torch.device("meta"):
            self.RangeNet_0 = RangeNet(
                config.in_channels,
                config.layers,
                config.stage_blocks,
                config.stem_type,
                config.num_neighbors,
                config.num_stem_layers,
                config.projection_kernel_size,
                stem_pallas=config.stem_pallas,
                dtype=dt,
            )
            self.DetectionHead_0 = DetectionHead(
                {s: ms_channels[s] for s in config.fpn_strides},
                {int(k): tuple(v) for k, v in config.fpn_kernel_sizes},
                config.tasks_dict,
                config.classification_head_channels,
                config.regression_head_channels,
                config.num_classification_blocks,
                config.num_regression_blocks,
                config.final_kernel_size,
                dtype=dt,
            )
        self.to_empty(device=device)
        init_weights(
            self, generator if generator is not None else torch.Generator().manual_seed(0)
        )
        self.eval()

    def forward(
        self, features: torch.Tensor, cart: torch.Tensor, mask: torch.Tensor
    ) -> Dict[str, Any]:
        if self.training:
            raise NotImplementedError("the detector's train forward is not ported")
        # (B, H, W, C) -> NCHW view with channels_last strides: no copy.
        multiscale = self.RangeNet_0(features.permute(0, 3, 1, 2), cart)
        head = self.DetectionHead_0(multiscale)
        return {"head": head, "strided": strided_views(cart, mask, self.config)}


def strided_views(
    cart: torch.Tensor, mask: torch.Tensor, cfg: DetectorConfig
) -> Dict[int, Dict[str, torch.Tensor]]:
    """Width-only column slicing of the geometric inputs per FPN stride,
    plus the RANGE partition gate on the mask when configured."""
    strided: Dict[int, Dict[str, torch.Tensor]] = {}
    rp = dict(cfg.targets.range_partitions)
    for stride in cfg.fpn_strides:
        cart_s = cart[:, :, ::stride]
        mask_s = mask[:, :, ::stride]
        if cfg.targets.fpn_assignment_method == "RANGE":
            lo, hi = rp.get(stride, (0.0, float("inf")))
            d = torch.sqrt((cart_s * cart_s).sum(-1))
            mask_s = mask_s & (d > lo) & (d <= hi)
        strided[stride] = {"cart": cart_s, "mask": mask_s}
    return strided


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights in the JAX package's init scheme, drawn on the CPU
    from ``generator``: lecun-normal convs and stem kernels, identity
    BatchNorms, normal(0.01) head convs, the focal-prior bias on each
    classification head's final conv."""

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, nn.ConvTranspose2d):
            normal_(m.weight, 1.0 / math.sqrt(m.weight[:, 0].numel()))
        elif isinstance(m, nn.Conv2d):
            normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MetaKernel):
            for i in range(m.num_layers):
                w = getattr(m, f"pos_{i}_conv_kernel")
                normal_(w, 1.0 / math.sqrt(w.shape[0]))
                getattr(m, f"pos_{i}_bn_scale").fill_(1.0)
                getattr(m, f"pos_{i}_bn_bias").zero_()
                getattr(m, f"pos_{i}_bn_mean").zero_()
                getattr(m, f"pos_{i}_bn_var").fill_(1.0)
            normal_(m.fusion1_kernel, 1.0 / math.sqrt(m.fusion1_kernel.shape[1]))
    prior = -math.log((1.0 - FOCAL_PRIOR_PROB) / FOCAL_PRIOR_PROB)
    for name, m in model.named_modules():
        if isinstance(m, DenseHead):
            for conv in m.modules():
                if isinstance(conv, nn.Conv2d):
                    normal_(conv.weight, 0.01)
            if name.rsplit(".", 1)[-1].startswith("cls_"):
                m.final.Conv_0.bias.fill_(prior)
