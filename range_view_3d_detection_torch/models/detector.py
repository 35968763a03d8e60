"""The range-view detector: forward pass, targets and training loss
(counterpart of the JAX ``models/detector.py``).

Batch layout (channel-last, as in the JAX package):
    features   (B, H, W, C)   input channels
    cart       (B, H, W, 3)   per-pixel Cartesian returns
    mask       (B, H, W)      bool validity
    boxes      (B, K, 7)      padded cuboids (x, y, z, l, w, h, yaw)
    box_valid  (B, K)         bool
    box_task   (B, K)         int32 task id
    box_offset (B, K)         int32 category offset within the task
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
from range_view_3d_detection_torch.ops import assignment, losses
from range_view_3d_detection_torch.ops import targets as targets_ops
from range_view_3d_detection_torch.parallel import mesh, spatial


@dataclasses.dataclass(frozen=True)
class TargetsConfig:
    """The JAX ``TargetsConfig`` (``conf/model/range_view.yaml``
    ``targets_config``)."""

    enable_azimuth_invariant_targets: bool = True
    fpn_assignment_method: str | None = None
    range_partitions: Tuple[Tuple[int, Tuple[float, float]], ...] = (
        (1, (0.0, float("inf"))),
    )
    point_intervals: Tuple[Tuple[int, Tuple[float, float]], ...] = ()
    affinity_fn: str = "GAUSSIAN"
    sigma: float = 0.75
    normalize_affinities: bool = False
    k: float = float("inf")


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static configuration of the detector (the JAX ``DetectorConfig``).

    ``remat`` checkpoints the groups named in ``remat_scope`` during
    training: ``stem``, ``stages`` (each residual stage and aggregation
    node), ``heads`` (each tower) and ``loss`` (``training/state.py``). It
    trades a recompute for activation memory and changes no value.
    """

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
    classification_weight: float = 1.0
    regression_weight: float = 1.0
    coding_weights: Tuple[float, ...] = (1.0,) * 8
    additive_smoothing: float = 1.0
    vfl_alpha: float = 0.75
    vfl_gamma: float = 2.0
    targets: TargetsConfig = TargetsConfig()
    max_boxes: int = 256
    dtype: str = "bfloat16"
    remat: bool = False
    remat_scope: Tuple[str, ...] = ("stem", "stages", "heads", "loss")
    # The META eval stem through the fused kernel (K1, fp32 sum of the nine
    # neighbours), as the JAX ``stem_pallas`` picks its Pallas kernel; False
    # takes the accumulate path (bf16 terms summed in the compute dtype).
    stem_pallas: bool = False

    @property
    def tasks_dict(self) -> Dict[int, Tuple[str, ...]]:
        return {int(k): tuple(v) for k, v in self.tasks}

    @property
    def fpn_dict(self) -> Dict[int, int]:
        return {int(k): int(v) for k, v in self.fpn}

    @property
    def fpn_strides(self) -> Tuple[int, ...]:
        return tuple(int(k) for k, _ in self.fpn)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


class Detector(nn.Module):
    """Backbone + multi-scale detection head.

    Built on ``device`` (``"cuda"`` unless the caller asks for the CPU)
    with weights drawn from ``generator`` (a CPU ``torch.Generator``, so a
    seed gives the same weights on every device); load trained or
    transplanted weights with ``load_state_dict``. It starts in eval
    mode; ``train()`` gives the train forward (batch-statistics
    BatchNorm, the stem's stacked path).
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
        scope = set(config.remat_scope) if config.remat else set()
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
                remat_stem="stem" in scope,
                remat_stages="stages" in scope,
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
                remat="heads" in scope,
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
        # (B, H, W, C) -> NCHW view with channels_last strides: no copy.
        multiscale = self.RangeNet_0(features.permute(0, 3, 1, 2), cart, mask)
        head = self.DetectionHead_0(multiscale)
        return {"head": head, "strided": strided_views(cart, mask, self.config)}


def strided_views(
    cart: torch.Tensor, mask: torch.Tensor, cfg: DetectorConfig
) -> Dict[int, Dict[str, torch.Tensor]]:
    """Width-only column slicing of the geometric inputs per FPN stride,
    plus the RANGE partition gate on the mask when configured. A width
    shard's slice starts on the global grid only if its width is a
    multiple of the stride, which is checked."""
    strided: Dict[int, Dict[str, torch.Tensor]] = {}
    rp = dict(cfg.targets.range_partitions)
    sharded = spatial.context() is not None
    for stride in cfg.fpn_strides:
        if sharded and cart.shape[2] % stride:
            raise ValueError(
                f"strided_views: shard width {cart.shape[2]} is not a multiple of "
                f"stride {stride}"
            )
        cart_s = cart[:, :, ::stride]
        mask_s = mask[:, :, ::stride]
        if cfg.targets.fpn_assignment_method == "RANGE":
            lo, hi = rp.get(stride, (0.0, float("inf")))
            d = torch.sqrt((cart_s * cart_s).sum(-1))
            mask_s = mask_s & (d > lo) & (d <= hi)
        strided[stride] = {"cart": cart_s, "mask": mask_s}
    return strided


def compute_batch_targets(
    batch: Dict[str, torch.Tensor], cfg: DetectorConfig
) -> Dict[int, Dict[int, targets_ops.StrideTargets]]:
    """Geometric targets of a batch (independent of the parameters)."""
    tc = cfg.targets
    return targets_ops.compute_targets(
        batch["cart"],
        batch["mask"],
        batch["boxes"],
        batch["box_valid"],
        batch["box_task"],
        batch["box_offset"],
        tasks=cfg.tasks_dict,
        fpn_strides=cfg.fpn_strides,
        azimuth_invariant=tc.enable_azimuth_invariant_targets,
        fpn_assignment_method=tc.fpn_assignment_method,
        range_partitions=dict(tc.range_partitions),
        point_intervals=dict(tc.point_intervals),
    )


_AGG_KEYS = (
    "classification_loss",
    "foreground_loss",
    "background_loss",
    "regression_loss",
    "coordinate_loss",
    "dimension_loss",
    "rotation_loss",
)


def detection_loss(
    outputs: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    cfg: DetectorConfig,
    tgts: Dict[int, Dict[int, targets_ops.StrideTargets]] | None = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total training loss and its metrics, as the JAX ``detection_loss``.

    Classification is normalised by the foreground count (plus the
    additive smoothing) over every stride and task; regression by the
    count of resolved objects, each pixel weighted by ``1 / (points_per_obj
    + smoothing)``. Under a process group both counts are the global
    batch's (the smoothing added once), so each rank's loss is its rows'
    share of the global loss, and the global loss is their sum
    (:func:`global_metrics`).
    """
    tasks = cfg.tasks_dict
    strides = cfg.fpn_strides
    tc = cfg.targets
    if tgts is None:
        tgts = compute_batch_targets(batch, cfg)
    device = batch["cart"].device

    n_objects = torch.zeros((), dtype=torch.float32, device=device)
    for stride in strides:
        for task_id in tasks:
            n_objects = n_objects + tgts[stride][task_id].num_objects.sum()

    cls_targets: Dict[int, Dict[int, assignment.ClassificationTargets]] = {}
    n_fg = torch.zeros((), dtype=torch.float32, device=device)
    for stride in strides:
        cart_s = outputs["strided"][stride]["cart"]
        mask_s = outputs["strided"][stride]["mask"]
        cls_targets[stride] = {}
        for task_id, cats in tasks.items():
            t = tgts[stride][task_id]
            ct = assignment.compute_classification_targets(
                outputs["head"][stride][task_id]["regressands"],
                t.regression_targets,
                t.labels,
                t.winner_index,
                cart_s,
                mask_s,
                num_categories=len(cats),
                affinity_fn=tc.affinity_fn,
                sigma=tc.sigma,
                k=tc.k,
                normalize_affinities=tc.normalize_affinities,
                azimuth_invariant=tc.enable_azimuth_invariant_targets,
                max_boxes=cfg.max_boxes,
            )
            cls_targets[stride][task_id] = ct
            n_fg = n_fg + ct.foreground_mask.sum()
    # Integer counts: exact in fp32 in any order of summation.
    n_objects, n_fg = mesh.all_sum(torch.stack([n_objects, n_fg]))
    total_objects = torch.clamp_min(n_objects, 1.0)
    total_fg = cfg.additive_smoothing + n_fg

    coding_w = torch.tensor(cfg.coding_weights, dtype=torch.float32, device=device)
    num_coding = coding_w.shape[0]
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=device)
    agg = dict.fromkeys(_AGG_KEYS, 0.0)
    for stride in strides:
        mask_s = outputs["strided"][stride]["mask"].float()
        s_cls = s_reg = 0.0
        for task_id in tasks:
            out = outputs["head"][stride][task_id]
            t = tgts[stride][task_id]
            ct = cls_targets[stride][task_id]

            vfl = (
                losses.varifocal_loss(
                    out["logits"], ct.affinities, alpha=cfg.vfl_alpha, gamma=cfg.vfl_gamma
                )
                * cfg.classification_weight
                * mask_s[..., None]
            ) / total_fg
            fg = ct.foreground_mask.float()[..., None]
            bg = ct.background_mask.float()[..., None]
            cls_loss = vfl.sum()
            fg_loss = (vfl * fg).sum()
            bg_loss = (vfl * bg).sum()

            per_obj_norm = 1.0 / (t.points_per_obj.float() + cfg.additive_smoothing)
            reg_elem = (
                losses.l1_loss(out["regressands"], t.regression_targets)
                * cfg.regression_weight
                * ct.regression_weights.float()[..., None]
                * per_obj_norm[..., None]
                * mask_s[..., None]
                * coding_w
                / num_coding
            ) / total_objects
            coord = reg_elem[..., 0:3].sum()
            dim = reg_elem[..., 3:6].sum()
            rot = reg_elem[..., 6:8].sum()
            reg_loss = coord + dim + rot

            total = total + (cls_loss + reg_loss)
            s_cls = s_cls + cls_loss
            s_reg = s_reg + reg_loss
            for key, value in zip(
                _AGG_KEYS, (cls_loss, fg_loss, bg_loss, reg_loss, coord, dim, rot)
            ):
                agg[key] = agg[key] + value
        metrics[f"classification_loss/s{stride}"] = torch.as_tensor(s_cls)
        metrics[f"regression_loss/s{stride}"] = torch.as_tensor(s_reg)

    metrics.update({k: torch.as_tensor(v) for k, v in agg.items()})
    metrics["loss"] = total
    metrics["total_fg"] = total_fg
    metrics["total_objects"] = total_objects
    return total, metrics


_GLOBAL_KEYS = ("total_fg", "total_objects")


def global_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``detection_loss``'s metrics of the global batch, detached: each
    rank's loss terms summed over the ranks in one all-reduce (the counts
    are global already); the metrics themselves without a process group."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if not mesh.active() or mesh.replicated():
        return metrics
    keys = [k for k in metrics if k not in _GLOBAL_KEYS]
    summed = mesh.all_sum(torch.stack([metrics[k].float() for k in keys]))
    metrics.update(zip(keys, summed.unbind()))
    return metrics


# Standard deviation of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: a normal truncated at two standard deviations,
    scaled so that the sample's standard deviation is ``1 / sqrt(fan_in)``
    (sigma = ``1 / sqrt(fan_in) / 0.87962566``), drawn on the CPU."""
    sigma = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    w = torch.empty(t.shape)
    nn.init.trunc_normal_(w, 0.0, sigma, -2.0 * sigma, 2.0 * sigma, generator=generator)
    t.copy_(w)



@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights in the JAX package's init scheme, drawn on the CPU
    from ``generator``: lecun-normal (truncated) convs and stem kernels,
    identity BatchNorms, normal(0.01) head convs, the focal-prior bias on
    each classification head's final conv."""

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, nn.ConvTranspose2d):
            lecun_normal_(m.weight, m.weight[:, 0].numel(), generator)
        elif isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MetaKernel):
            for i in range(m.num_layers):
                w = getattr(m, f"pos_{i}_conv_kernel")
                lecun_normal_(w, w.shape[0], generator)
                getattr(m, f"pos_{i}_bn_scale").fill_(1.0)
                getattr(m, f"pos_{i}_bn_bias").zero_()
                getattr(m, f"pos_{i}_bn_mean").zero_()
                getattr(m, f"pos_{i}_bn_var").fill_(1.0)
            lecun_normal_(m.fusion1_kernel, m.fusion1_kernel.shape[1], generator)
    prior = -math.log((1.0 - FOCAL_PRIOR_PROB) / FOCAL_PRIOR_PROB)
    for name, m in model.named_modules():
        if isinstance(m, DenseHead):
            for conv in m.modules():
                if isinstance(conv, nn.Conv2d):
                    normal_(conv.weight, 0.01)
            if name.rsplit(".", 1)[-1].startswith("cls_"):
                m.final.Conv_0.bias.fill_(prior)
