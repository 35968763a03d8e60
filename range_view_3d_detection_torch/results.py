"""The served program's result types, registered as ``torch.export``
pytrees (``rv3d.NMSResult``, ``rv3d.Proposals``) so that an exported
predict program saves and loads with its named outputs.

Imported by ``range_view_3d_detection_torch.kernels``: loading an AOT
artifact (``export.load_aot``) needs that package and nothing of the
model.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils._pytree as pytree


class NMSResult(NamedTuple):
    cuboids: torch.Tensor  # (B, cap, 7)
    scores: torch.Tensor  # (B, cap)
    categories: torch.Tensor  # (B, cap) int32
    keep: torch.Tensor  # (B, cap) bool


class Proposals(NamedTuple):
    cuboids: torch.Tensor  # (B, N, 7)
    scores: torch.Tensor  # (B, N)
    categories: torch.Tensor  # (B, N) int32


for _cls in (NMSResult, Proposals):
    pytree._register_namedtuple(_cls, serialized_type_name=f"rv3d.{_cls.__name__}")
