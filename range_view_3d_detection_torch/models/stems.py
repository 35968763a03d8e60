"""Input stems (counterpart of the JAX ``models/stems.py``): MetaKernel, eval.

The eval MetaKernel goes through the fused stem kernel
(``kernels/stem.py::meta_kernel_fused``, K1), whose plain twin is the
JAX accumulate formulation with the Pallas kernel's rounding points. The
stacked train path (batch-statistics BatchNorm over all neighbours) and
``RangePartition`` are not ported yet; the BASIC stem is a
:class:`~range_view_3d_detection_torch.models.blocks.BasicBlock`.
"""

from __future__ import annotations

import torch
from torch import nn

from range_view_3d_detection_torch.kernels.stem import meta_kernel_fused
from range_view_3d_detection_torch.models.blocks import (
    BasicBlock,
    ConvNormAct,
    batch_norm,
)

BN_EPS = 1e-5


class MetaKernel(nn.Module):
    """RangeDet-style meta-kernel stem, eval path.

    Parameters keep the flax layout: the pos-MLP kernels are (I, O) matmul
    weights with explicit BatchNorm tensors (``pos_{i}_bn_scale/bias``
    parameters, ``pos_{i}_bn_mean/var`` buffers), and ``fusion1_kernel``
    is the blocked (n*n, C, C) kernel that K1 consumes directly.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_neighbors: int = 3,
        num_layers: int = 2,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if num_neighbors != 3 or num_layers != 2:
            raise NotImplementedError(
                "the fused stem kernel takes a 3x3 neighbourhood and a "
                "two-layer positional MLP"
            )
        C = out_channels
        self.dtype = dtype
        self.num_layers = num_layers
        self.BasicBlock_0 = BasicBlock(
            in_channels, C, kernel_size=(1, 1), project=True, dtype=dtype
        )
        for i in range(num_layers):
            self.register_parameter(
                f"pos_{i}_conv_kernel",
                nn.Parameter(torch.empty(3 if i == 0 else C, C)),
            )
            self.register_parameter(
                f"pos_{i}_bn_scale", nn.Parameter(torch.ones(C))
            )
            self.register_parameter(
                f"pos_{i}_bn_bias", nn.Parameter(torch.zeros(C))
            )
            self.register_buffer(f"pos_{i}_bn_mean", torch.zeros(C))
            self.register_buffer(f"pos_{i}_bn_var", torch.ones(C))
        self.fusion1_kernel = nn.Parameter(
            torch.empty(num_neighbors**2, C, C)
        )
        self.fusion1_bn = batch_norm(C)
        for i in range(1, num_layers):
            self.add_module(
                f"fusion_{i}", ConvNormAct(C, C, (1, 1), dtype=dtype)
            )

    def bn_eval_affine(self, i: int):
        """(a, b) fp32 with eval BN_i(x) == a * x + b."""
        scale = getattr(self, f"pos_{i}_bn_scale")
        bias = getattr(self, f"pos_{i}_bn_bias")
        mean = getattr(self, f"pos_{i}_bn_mean")
        var = getattr(self, f"pos_{i}_bn_var")
        a = scale * torch.rsqrt(var + BN_EPS)
        return a, bias - mean * a

    def forward(self, features: torch.Tensor, cart: torch.Tensor) -> torch.Tensor:
        """``features`` NCHW, ``cart`` (B, H, W, 3) -> NCHW stem output."""
        if self.training:
            raise NotImplementedError(
                "MetaKernel's train path (stacked neighbours) is not ported"
            )
        dt = self.dtype
        feats = self.BasicBlock_0(features).permute(0, 2, 3, 1)  # NHWC
        # conv0 is linear and bias-free: pos0(rel_n) = shift_n(g) - g.
        g = cart.to(dt) @ self.pos_0_conv_kernel.to(dt)
        a0, b0 = self.bn_eval_affine(0)
        a1, b1 = self.bn_eval_affine(1)
        geo = meta_kernel_fused(
            g,
            feats,
            self.pos_1_conv_kernel.to(dt),
            self.fusion1_kernel.to(dt),
            a0, b0, a1, b1,
        ).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        geo = torch.relu(self.fusion1_bn(geo).to(dt))
        for i in range(1, self.num_layers):
            geo = getattr(self, f"fusion_{i}")(geo)
        return geo
