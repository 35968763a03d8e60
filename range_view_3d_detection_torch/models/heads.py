"""Detection heads (counterpart of the JAX ``models/heads.py``)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from range_view_3d_detection_torch.models.blocks import ConvNormAct, checkpoint

FOCAL_PRIOR_PROB = 0.01


class DenseHead(nn.Sequential):
    """Conv tower + a final conv with bias and no BN; fp32 output."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_outputs: int,
        kernel_size: Tuple[int, int] = (3, 3),
        final_kernel_size: Tuple[int, int] = (1, 1),
        num_blocks: int = 4,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        cin = in_channels
        for i in range(num_blocks):
            self.add_module(
                f"ConvNormAct_{i}",
                ConvNormAct(cin, out_channels, kernel_size, dtype=dtype),
            )
            cin = out_channels
        self.add_module(
            f"ConvNormAct_{num_blocks}",
            ConvNormAct(
                cin, num_outputs, final_kernel_size, norm=False, act=False,
                dtype=dtype,
            ),
        )

    @property
    def final(self) -> ConvNormAct:
        return self[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).float()


class DetectionHead(nn.Module):
    """Per-(FPN stride, task) classification + regression towers.

    Returns ``{stride: {task_id: {"logits": (B, H, Ws, C_t),
    "regressands": (B, H, Ws, 8)}}}`` channel-last fp32. With ``remat``
    each tower is checkpointed in train mode (the JAX ``nn.remat(DenseHead)``).
    """

    def __init__(
        self,
        fpn_in_channels: Dict[int, int],
        fpn_kernel_sizes: Dict[int, Sequence[int]],
        tasks: Dict[int, Sequence[str]],
        classification_head_channels: int = 128,
        regression_head_channels: int = 128,
        num_classification_blocks: int = 4,
        num_regression_blocks: int = 4,
        final_kernel_size: int = 1,
        num_regressands: int = 8,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.remat = remat
        self.head_keys = []
        fk = (final_kernel_size,) * 2
        for stride, cin in fpn_in_channels.items():
            ks = tuple(fpn_kernel_sizes[stride])
            for task_id, cats in tasks.items():
                self.add_module(
                    f"cls_s{stride}_t{task_id}",
                    DenseHead(
                        cin, classification_head_channels, len(cats), ks, fk,
                        num_classification_blocks, dtype=dtype,
                    ),
                )
                self.add_module(
                    f"reg_s{stride}_t{task_id}",
                    DenseHead(
                        cin, regression_head_channels, num_regressands, ks, fk,
                        num_regression_blocks, dtype=dtype,
                    ),
                )
                self.head_keys.append((stride, task_id))

    def forward(
        self, multiscale: Dict[int, torch.Tensor]
    ) -> Dict[int, Dict[int, Dict[str, torch.Tensor]]]:
        out: Dict[int, Dict[int, Dict[str, torch.Tensor]]] = {}
        remat = self.remat and self.training
        for stride, task_id in self.head_keys:
            feats = multiscale[stride]
            cls = getattr(self, f"cls_s{stride}_t{task_id}")
            reg = getattr(self, f"reg_s{stride}_t{task_id}")
            if remat:
                logits, regressands = checkpoint(cls, feats), checkpoint(reg, feats)
            else:
                logits, regressands = cls(feats), reg(feats)
            out.setdefault(stride, {})[task_id] = {
                "logits": logits.permute(0, 2, 3, 1),
                "regressands": regressands.permute(0, 2, 3, 1),
            }
        return out
