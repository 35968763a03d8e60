"""Width-strided DLA-style range backbone (counterpart of the JAX
``models/backbone.py``): five residual stages strided only along width,
four transposed-conv aggregation nodes, multi-scale output
``{1: concat(stem, agg3), 2: agg2a, 4: agg2, 16: res3}`` (NCHW).

Remat, as the JAX ``nn.remat`` wraps them: ``RangeBackbone(remat=True)``
checkpoints each residual stage and each aggregation node,
``RangeNet(remat_stem=True)`` the stem (``MetaKernel_0``,
``RangePartition_0`` or ``BasicBlock_0``). The modules and their names do
not change, so the ``state_dict`` is the same with remat on or off."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from range_view_3d_detection_torch.models.blocks import (
    AggregationBlock,
    BasicBlock,
    ResidualBlock,
    checkpoint,
)
from range_view_3d_detection_torch.models.stems import MetaKernel, RangePartition


def out_channels(layers: Sequence[int]) -> Dict[int, int]:
    """Channels of each multi-scale output of :class:`RangeBackbone`."""
    return {1: 2 * layers[0], 2: layers[1], 4: layers[2], 16: layers[4]}


class RangeBackbone(nn.Module):
    """DLA-style backbone over stem features (eval forward)."""

    def __init__(
        self,
        layers: Sequence[int],
        stage_blocks: Sequence[int] = (2, 3, 3, 5, 5),
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.remat = remat
        ch, nb = list(layers), list(stage_blocks)
        ins = [ch[0]] + ch[:4]
        # The product of the stages' width strides: a width shard must be a
        # multiple of it (parallel/spatial.py::check_width).
        self.width_stride = 2**4
        for i in range(5):
            self.add_module(
                f"ResidualBlock_{i}",
                ResidualBlock(
                    ins[i], ch[i], nb[i], strides=(1, 1) if i == 0 else (1, 2),
                    dtype=dtype,
                ),
            )
        # flax creation order: agg2, agg1, agg2a, agg3.
        aggs = [
            (ch[4], ch[2], (3, 8), (1, 4), (1, 2), 2),  # agg2 <- res3
            (ch[2], ch[0], (3, 8), (1, 4), (1, 2), 2),  # agg1 <- res2
            (ch[2], ch[1], (3, 4), (1, 2), (1, 1), 1),  # agg2a <- agg2
            (ch[1], ch[0], (3, 4), (1, 2), (1, 1), 2),  # agg3 <- agg2a
        ]
        for i, (cin, cout, k, s, p, n) in enumerate(aggs):
            self.add_module(
                f"AggregationBlock_{i}",
                AggregationBlock(cin, cout, k, s, p, n, dtype=dtype),
            )

    def _run(self, module: torch.nn.Module, *args: torch.Tensor) -> torch.Tensor:
        return checkpoint(module, *args) if self.remat and self.training else module(*args)

    def forward(self, features: torch.Tensor) -> Dict[int, torch.Tensor]:
        run = self._run
        res1 = run(self.ResidualBlock_0, features)
        res2a = run(self.ResidualBlock_1, res1)
        res2 = run(self.ResidualBlock_2, res2a)
        res3a = run(self.ResidualBlock_3, res2)
        res3 = run(self.ResidualBlock_4, res3a)
        agg2 = run(self.AggregationBlock_0, res2, res3)
        agg1 = run(self.AggregationBlock_1, res1, res2)
        agg2a = run(self.AggregationBlock_2, res2a, agg2)
        agg3 = run(self.AggregationBlock_3, agg1, agg2a)
        agg3 = torch.cat([features, agg3], dim=1)
        return {1: agg3, 2: agg2a, 4: agg2, 16: res3}


class RangeNet(nn.Module):
    """Stem selector (META, RANGE_PARTITION or BASIC) + backbone."""

    def __init__(
        self,
        in_channels: int,
        layers: Sequence[int],
        stage_blocks: Sequence[int] = (2, 3, 3, 5, 5),
        stem_type: str = "META",
        num_neighbors: int = 3,
        num_layers: int = 2,
        projection_kernel_size: int = 1,
        stem_pallas: bool = False,
        remat_stem: bool = False,
        remat_stages: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.remat_stem = remat_stem
        self.stem_type = stem_type.upper()
        if self.stem_type == "META":
            self.MetaKernel_0 = MetaKernel(
                in_channels, layers[0], num_neighbors, num_layers,
                use_fused_kernel=stem_pallas, dtype=dtype,
            )
        elif self.stem_type == "RANGE_PARTITION":
            self.RangePartition_0 = RangePartition(
                in_channels, layers[0], projection_kernel_size, dtype=dtype
            )
        elif self.stem_type == "BASIC":
            pk = projection_kernel_size
            self.BasicBlock_0 = BasicBlock(
                in_channels, layers[0], (pk, pk), project=True, dtype=dtype
            )
        else:
            raise ValueError(f"unknown stem_type={stem_type}")
        self.RangeBackbone_0 = RangeBackbone(
            layers, stage_blocks, remat=remat_stages, dtype=dtype
        )

    def forward(
        self, features: torch.Tensor, cart: torch.Tensor, mask: torch.Tensor | None = None
    ) -> Dict[int, torch.Tensor]:
        """``features`` NCHW, ``cart`` (B, H, W, 3), ``mask`` (B, H, W) (the
        RANGE_PARTITION stem's)."""
        features = features.to(self.dtype)
        if self.stem_type == "META":
            stem_args = (self.MetaKernel_0, features, cart)
        elif self.stem_type == "RANGE_PARTITION":
            if mask is None:
                raise ValueError("the RANGE_PARTITION stem takes the mask")
            stem_args = (self.RangePartition_0, features, cart, mask.to(self.dtype))
        else:
            stem_args = (self.BasicBlock_0, features)
        if self.remat_stem and self.training:
            stem = checkpoint(*stem_args)
        else:
            stem = stem_args[0](*stem_args[1:])
        return self.RangeBackbone_0(stem)
