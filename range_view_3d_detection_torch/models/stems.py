"""Input stems (counterpart of the JAX ``models/stems.py``): MetaKernel,
RangePartition; the BASIC stem is a
:class:`~range_view_3d_detection_torch.models.blocks.BasicBlock`.

The eval MetaKernel routes as the JAX package does. With
``use_fused_kernel`` (the config's ``stem_pallas``) at a 3x3
neighbourhood and a two-layer positional MLP it goes through the fused
stem kernel (``kernels/stem.py::meta_kernel_fused``, K1), whose plain
twin is the JAX formulation with the Pallas kernel's rounding points;
otherwise it takes the JAX accumulate path, which sums the neighbours'
terms in the compute dtype, at any odd ``num_neighbors`` and any depth.
After ``quantize_stem`` it goes through the int8 kernel
(``meta_kernel_fused_i8``, K4) instead; while the model is calibrated
(``models/quantized.py::calibrate_scales``) it takes the accumulate path,
which records the absmax of ``hh`` and ``p * feats`` (3x3, two layers),
as the JAX package does. Under width sharding (``parallel/spatial.py``)
neither kernel runs: they are device-local, and the JAX package gates its
Pallas stem off there too (``models/stems.py:272``), so the eval stem
takes the accumulate path, whose width padding is the neighbours'
columns.

In train mode (and in eval with ``inference_accumulate=False``) it takes
the JAX stacked path: the neighbours ride the batch axis through the
positional MLP, whose BatchNorms pool over (B*n*n, H, W) in train mode
(and over every width shard under a train-mode width context), and
``geo`` is one einsum over the stacked neighbours.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from range_view_3d_detection_torch.kernels.stem import (
    meta_kernel_fused,
    meta_kernel_fused_i8,
)
from range_view_3d_detection_torch.models.blocks import (
    BasicBlock,
    BatchNorm,
    ConvNormAct,
    batch_moments,
    recomputing,
)
from range_view_3d_detection_torch.models.quantized import (
    INT8_MAX,
    quantize_to_int8,
    weight_scale_per_channel,
)
from range_view_3d_detection_torch.parallel import spatial

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
_I8_BUFFERS = ("i8_w1", "i8_k", "i8_a0", "i8_b0", "i8_a1", "i8_b1", "i8_kdq")


def padded_image(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``(B, H, W, ...)`` padded by ``pad`` on both spatial axes: the width
    by zeros, or under width sharding by the neighbour shards' columns
    (the JAX ``_width_padded``), the height by zeros."""
    ctx = spatial.context()
    rest = [0, 0] * (x.dim() - 3)
    if ctx is None:
        return F.pad(x, rest + [pad, pad, pad, pad])
    xp = spatial.exchange_halo_lr(x, pad, pad, ctx.group, w_axis=2, circular=ctx.circular)
    return F.pad(xp, rest + [0, 0, pad, pad])


def extract_neighbors(x: torch.Tensor, num_neighbors: int) -> torch.Tensor:
    """``(B, H, W, C)`` -> ``(B, n*n, H, W, C)`` neighbourhoods, zero-padded
    (width halos under width sharding), row-major over (dy, dx), so the
    centre sits at ``n*n // 2``."""
    pad = num_neighbors // 2
    H, W = x.shape[1:3]
    xp = padded_image(x, pad)
    views = [
        xp[:, dy : dy + H, dx : dx + W]
        for dy in range(num_neighbors)
        for dx in range(num_neighbors)
    ]
    return torch.stack(views, dim=1)


class MetaKernel(nn.Module):
    """RangeDet-style meta-kernel stem.

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
        use_fused_kernel: bool = False,
        inference_accumulate: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if num_neighbors % 2 == 0 or num_layers < 1:
            raise ValueError(
                f"MetaKernel: num_neighbors={num_neighbors} must be odd and "
                f"num_layers={num_layers} at least 1"
            )
        C = out_channels
        self.dtype = dtype
        self.num_neighbors = num_neighbors
        self.num_layers = num_layers
        self.use_fused_kernel = use_fused_kernel
        self.inference_accumulate = inference_accumulate
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
        self.fusion1_bn = BatchNorm(C)
        for i in range(1, num_layers):
            self.add_module(
                f"fusion_{i}", ConvNormAct(C, C, (1, 1), dtype=dtype)
            )
        # Int8 stem operands (quantize_stem), not part of the state_dict.
        for name in _I8_BUFFERS:
            self.register_buffer(name, None, persistent=False)
        # While calibrating: callable(key, tensor) recording an absmax.
        self.calib_sink = None
        self.stem_scales: tuple[float, float] | None = None

    def quant_scales(self) -> dict:
        if self.stem_scales is None:
            return {}
        return dict(zip(("stem_hh_scale", "stem_pf_scale"), self.stem_scales))

    @torch.no_grad()
    def quantize_stem(
        self, s_hh: float | None, s_pf: float | None, use_kernel: bool = True
    ) -> None:
        """Keep the calibrated ``hh`` and ``p * feats`` scales and, with
        ``use_kernel``, run the stem through K4 (None: back to K1).

        ``W1`` is quantized per output column and ``fusion1_kernel`` per
        neighbour and output channel; the scales fold into the BN affines
        in the JAX package's order of operations: ``a0/s_hh``, ``b0/s_hh``,
        ``a1*(s_hh*w1_s)/s_pf``, ``b1/s_pf``, ``kdq = s_pf*k_s``.
        """
        for name in _I8_BUFFERS:
            setattr(self, name, None)
        self.stem_scales = None if s_hh is None or s_pf is None else (s_hh, s_pf)
        if self.stem_scales is None or not use_kernel:
            return
        dev = self.fusion1_kernel.device
        s_hh = torch.tensor(s_hh, dtype=torch.float32, device=dev)
        s_pf = torch.tensor(s_pf, dtype=torch.float32, device=dev)
        w1 = self.pos_1_conv_kernel.detach().float()
        w1_s = weight_scale_per_channel(w1, out_dim=1)
        w1_i8 = quantize_to_int8(w1, w1_s)
        kf = self.fusion1_kernel.detach().float()
        k_s = torch.clamp(kf.abs().amax(dim=1) / INT8_MAX, min=1e-12)  # (9, C)
        k_i8 = quantize_to_int8(kf, k_s[:, None, :])
        a0, b0 = self.bn_eval_affine(0)
        a1, b1 = self.bn_eval_affine(1)
        # Transposed views of [n][k] memory: the kernel's operand layout.
        self.i8_w1 = w1_i8.t().contiguous().t()
        self.i8_k = k_i8.transpose(1, 2).contiguous().transpose(1, 2)
        self.i8_a0 = a0 / s_hh
        self.i8_b0 = b0 / s_hh
        self.i8_a1 = a1 * (s_hh * w1_s) / s_pf
        self.i8_b1 = b1 / s_pf
        self.i8_kdq = s_pf * k_s

    def _pos_bn(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """BN_i of the positional MLP in the JAX form, fp32, channel-last.

        In train mode it normalises with the batch statistics over every
        axis but the last (every rank's rows under a process group),
        ``E[x^2] - m^2`` unclamped as in the JAX stem, and moves the
        running statistics to ``0.9 r + 0.1 batch`` (not in a checkpoint's
        recompute). The int8 and calibration paths are eval-only: train
        mode takes the stacked path whatever the stem's scales.
        """
        scale = getattr(self, f"pos_{i}_bn_scale")
        bias = getattr(self, f"pos_{i}_bn_bias")
        mean = getattr(self, f"pos_{i}_bn_mean")
        var = getattr(self, f"pos_{i}_bn_var")
        xf = x.float()
        if self.training:
            m, sq = batch_moments(xf, tuple(range(x.ndim - 1)))
            v = sq - m * m
            if not recomputing():
                with torch.no_grad():
                    mean.copy_(BN_MOMENTUM * mean + (1 - BN_MOMENTUM) * m)
                    var.copy_(BN_MOMENTUM * var + (1 - BN_MOMENTUM) * v)
            mean, var = m, v
        return (xf - mean) * torch.rsqrt(var + BN_EPS) * scale + bias

    @property
    def fits_kernel(self) -> bool:
        """The fused kernels' neighbourhood and depth: 3x3, two layers (the
        JAX Pallas gate, ``stems.py:269-271``)."""
        return self.num_neighbors == 3 and self.num_layers == 2

    def _pos_mlp(self, x0: torch.Tensor):
        """BN + ReLU of the first positional layer's product ``x0``, then
        the remaining layers (the JAX ``pos_tail(x, 0)``). Returns the
        last layer's output and the first's (``hh``)."""
        dt = self.dtype
        hh = h = torch.relu(self._pos_bn(x0, 0).to(dt))
        for i in range(1, self.num_layers):
            w = getattr(self, f"pos_{i}_conv_kernel").to(dt)
            h = torch.relu(self._pos_bn(h @ w, i).to(dt))
        return h, hh

    def _stacked(self, feats: torch.Tensor, cart: torch.Tensor) -> torch.Tensor:
        """The JAX stacked path (``stems.py:232-262``): ``geo`` (B, H, W, C)
        in the compute dtype. The neighbours fold into the batch for the
        positional MLP; a neighbour outside the image has coordinates 0."""
        dt = self.dtype
        n = self.num_neighbors
        B, H, W, C = feats.shape
        cart = cart.to(dt)
        neighbors = extract_neighbors(feats, n)  # (B, n*n, H, W, C)
        rel = extract_neighbors(cart, n) - cart[:, None]  # (B, n*n, H, W, 3)
        pos = rel.reshape(B * n * n, H, W, 3) @ self.pos_0_conv_kernel.to(dt)
        pos = self._pos_mlp(pos)[0].reshape(B, n * n, H, W, C)
        return torch.einsum(
            "bnhwc,nco->bhwo", pos * neighbors, self.fusion1_kernel.to(dt)
        )

    def _accumulate(self, g: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        """The JAX eval accumulate path (``stems.py:353-395``), recording
        ``stem_hh`` and ``stem_pf`` absmaxes into ``calib_sink`` when set
        (3x3, two layers, as in JAX). Returns ``geo`` (B, H, W, C) in the
        compute dtype."""
        dt = self.dtype
        n = self.num_neighbors
        H, W = g.shape[1:3]
        gp = padded_image(g, n // 2)
        fp = padded_image(feats, n // 2)
        kernel = self.fusion1_kernel.to(dt)
        calib = self.calib_sink is not None and self.fits_kernel
        geo = None
        for dy in range(n):
            for dx in range(n):
                x0 = gp[:, dy : dy + H, dx : dx + W] - g
                pos, hh = self._pos_mlp(x0)
                pf = pos * fp[:, dy : dy + H, dx : dx + W]
                if calib:
                    self.calib_sink("stem_hh", hh)
                    self.calib_sink("stem_pf", pf)
                term = pf @ kernel[n * dy + dx]
                geo = term if geo is None else geo + term
        return geo

    def _eval_geo(self, feats: torch.Tensor, cart: torch.Tensor) -> torch.Tensor:
        """``geo`` of the eval paths: the accumulate path while calibrating
        or width-sharded, K4 after ``quantize_stem``, K1 with
        ``use_fused_kernel``, else the accumulate path (K1 and K4 at 3x3
        and two layers only)."""
        dt = self.dtype
        # conv0 is linear and bias-free: pos0(rel_n) = shift_n(g) - g.
        g = cart.to(dt) @ self.pos_0_conv_kernel.to(dt)
        if self.calib_sink is not None or spatial.context() is not None:
            return self._accumulate(g, feats)
        if self.i8_w1 is not None and self.fits_kernel:
            return meta_kernel_fused_i8(
                g, feats, self.i8_w1, self.i8_k, self.i8_a0, self.i8_b0,
                self.i8_a1, self.i8_b1, self.i8_kdq,
            )
        if self.use_fused_kernel and self.fits_kernel:
            a0, b0 = self.bn_eval_affine(0)
            a1, b1 = self.bn_eval_affine(1)
            return meta_kernel_fused(
                g, feats, self.pos_1_conv_kernel.to(dt), self.fusion1_kernel.to(dt),
                a0, b0, a1, b1,
            )
        return self._accumulate(g, feats)

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
        dt = self.dtype
        feats = self.BasicBlock_0(features).permute(0, 2, 3, 1)  # NHWC
        if self.training or not self.inference_accumulate:
            geo = self._stacked(feats, cart)
        else:
            geo = self._eval_geo(feats, cart)
        geo = geo.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        geo = self.fusion1_bn(geo, dt, act=True)
        for i in range(1, self.num_layers):
            geo = getattr(self, f"fusion_{i}")(geo)
        return geo


class RangePartition(nn.Module):
    """Range-band partition stem (the JAX ``RangePartition``,
    ``stems.py:404-437``): the features replicated into six overlapping
    range bands, zero outside each band and at invalid pixels, projected
    by a ``BasicBlock``."""

    lower_bounds = (0.0, 10.0, 15.0, 20.0, 30.0, 45.0)
    upper_bounds = (15.0, 20.0, 30.0, 40.0, 60.0, float("inf"))

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        projection_kernel_size: int = 1,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        pk = projection_kernel_size
        self.BasicBlock_0 = BasicBlock(
            len(self.lower_bounds) * in_channels, out_channels, (pk, pk),
            project=True, dtype=dtype,
        )

    def forward(
        self, features: torch.Tensor, cart: torch.Tensor, mask: torch.Tensor
    ) -> torch.Tensor:
        """``features`` NCHW, ``cart`` (B, H, W, 3), ``mask`` (B, H, W) in the
        compute dtype -> NCHW."""
        dt = self.dtype
        d = torch.sqrt((cart * cart).sum(-1, keepdim=True))  # (B, H, W, 1)
        lo = d.new_tensor(self.lower_bounds)
        hi = d.new_tensor(self.upper_bounds)
        bands = ((d >= lo) & (d <= hi)).to(dt)  # (B, H, W, 6)
        f = features.permute(0, 2, 3, 1)  # NHWC
        B, H, W, C = f.shape
        banded = (bands[..., :, None] * f[..., None, :]).reshape(B, H, W, -1)
        banded = banded * mask.to(dt)[..., None]
        x = banded.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.BasicBlock_0(x)
