"""Convolutional building blocks (counterpart of the JAX ``models/blocks.py``).

Modules take NCHW tensors (``torch.channels_last`` memory keeps the
channel-last layout of the public functions without copies). Parameters
are fp32; each conv casts its input and weight to the compute ``dtype``
(the flax ``dtype``/``param_dtype`` split). BatchNorm runs in fp32 on the
conv output and casts back to the compute dtype.

Submodules carry the flax auto-names (``Conv_0``, ``BatchNorm_0``,
``ConvNormAct_1``, ...) so ``transplant.py`` maps a flax variable path to
a ``state_dict`` key one to one.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

IntPair = Union[int, Sequence[int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def batch_norm(features: int) -> nn.BatchNorm2d:
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)``: torch momentum 0.1."""
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


class ConvNormAct(nn.Module):
    """Conv + BatchNorm + ReLU with torch-style padding.

    The padding is a fixed ``(k-1)//2`` on each side, independent of the
    stride, as in the JAX block (``blocks.py:305-314``). Kernel sizes are
    odd (every configuration's are); an even one, which the JAX block pads
    asymmetrically, is refused.
    """

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: IntPair = (3, 3),
        strides: IntPair = (1, 1),
        norm: bool = True,
        act: bool = True,
        use_bias: bool | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        kh, kw = _pair(kernel_size)
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError(f"ConvNormAct: even kernel size {(kh, kw)}")
        self.norm = norm
        self.act = act
        self.dtype = dtype
        use_bias = (not norm) if use_bias is None else use_bias
        self.Conv_0 = nn.Conv2d(
            in_channels, features, (kh, kw), stride=_pair(strides),
            padding=((kh - 1) // 2, (kw - 1) // 2), bias=use_bias,
        )
        if norm:
            self.BatchNorm_0 = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        conv = self.Conv_0
        bias = None if conv.bias is None else conv.bias.to(dt)
        y = F.conv2d(x.to(dt), conv.weight.to(dt), bias, conv.stride, conv.padding)
        if self.norm:
            y = self.BatchNorm_0(y.float()).to(dt)
        if self.act:
            y = torch.relu(y)
        return y


class TorchConvTranspose(nn.ConvTranspose2d):
    """Transposed conv, fp path of the JAX ``TorchConvTranspose``.

    The JAX module cross-correlates the stride-dilated input with its
    stored HWIO kernel; ``ConvTranspose2d`` does the same with the kernel
    flipped in space, and its output size ``(in-1)*s + k - 2p`` matches.
    ``transplant.py`` flips the kernel.
    """

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: IntPair,
        strides: IntPair,
        padding: IntPair,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(
            in_channels,
            features,
            _pair(kernel_size),
            stride=_pair(strides),
            padding=_pair(padding),
            bias=False,
        )
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), None, self.stride, self.padding
        )


class BasicBlock(nn.Module):
    """conv-BN-ReLU-conv(stride)-BN + (projected) residual, ReLU after add."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: IntPair = (3, 3),
        strides: IntPair = (1, 1),
        project: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(
            in_channels, features, kernel_size, dtype=dtype
        )
        self.ConvNormAct_1 = ConvNormAct(
            features, features, kernel_size, strides, act=False, dtype=dtype
        )
        self.project = project
        if project:
            self.ConvNormAct_2 = ConvNormAct(
                in_channels, features, (1, 1), strides, act=False, dtype=dtype
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvNormAct_1(self.ConvNormAct_0(x))
        residual = self.ConvNormAct_2(x) if self.project else x
        return torch.relu(y + residual)


class ResidualBlock(nn.Sequential):
    """N chained BasicBlocks; the first one projects and strides."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        num_blocks: int,
        strides: IntPair = (1, 1),
        kernel_size: IntPair = (3, 3),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.add_module(
            "BasicBlock_0",
            BasicBlock(
                in_channels, features, kernel_size, strides, project=True,
                dtype=dtype,
            ),
        )
        for i in range(1, num_blocks):
            self.add_module(
                f"BasicBlock_{i}",
                BasicBlock(features, features, kernel_size, dtype=dtype),
            )


class AggregationBlock(nn.Module):
    """Upscale ``x2`` (transposed conv + BN + ReLU), add ``x1``, refine."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: IntPair,
        strides: IntPair,
        padding: IntPair,
        num_blocks: int,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.TorchConvTranspose_0 = TorchConvTranspose(
            in_channels, features, kernel_size, strides, padding, dtype=dtype
        )
        self.BatchNorm_0 = batch_norm(features)
        self.ResidualBlock_0 = ResidualBlock(
            features, features, num_blocks, dtype=dtype
        )

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        y = self.BatchNorm_0(self.TorchConvTranspose_0(x2).float())
        y = x1 + torch.relu(y.to(self.dtype))
        return self.ResidualBlock_0(y)
