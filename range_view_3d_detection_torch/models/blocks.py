"""Convolutional building blocks (counterpart of the JAX ``models/blocks.py``).

Modules take NCHW tensors (``torch.channels_last`` memory keeps the
channel-last layout of the public functions without copies). Parameters
are fp32; each conv casts its input and weight to the compute ``dtype``
(the flax ``dtype``/``param_dtype`` split). The eval BatchNorm runs in fp32
on the conv output in flax's rounding order and casts to the compute dtype
once (:class:`BatchNorm`).

Submodules carry the flax auto-names (``Conv_0``, ``BatchNorm_0``,
``ConvNormAct_1``, ...) so ``transplant.py`` maps a flax variable path to
a ``state_dict`` key one to one.

Int8 serving (``models/quantized.py``): ``quantize(in_scale)`` switches a
BN-bearing ``ConvNormAct`` or a ``TorchConvTranspose`` to int8 operands
with int32 accumulation (``quantize(None)`` switches it back; as in the
JAX blocks, a ``ConvNormAct`` in train mode runs its fp conv, the
transposed conv does not look at the mode); both record their input
absmax while the model is calibrated. QAT: ``qat_scale`` (set
by ``quantized.qat``) runs the same blocks on STE fake-quantized fp32
operands, in train or eval mode.

Width sharding (``parallel/spatial.py``): under its context a k-wide
``ConvNormAct`` fetches ``(k-1)//2`` columns from its left neighbour and
``k-1-(k-1)//2`` from its right one and runs VALID over width, and a
``TorchConvTranspose`` fetches the columns its kernel footprint reads and
slices the exact local output (the fp phase decomposition takes a (1, 1)
halo and needs no slice); train-mode BatchNorm moments are reduced over
the context's group. The int8 operands run there too, as in the JAX
blocks: on the halo'd shard through the general int8 route
(``quantized.int8_conv_nhwc``), with a width padding of 0. (The
width-sharded artifact loader, ``export.load_artifact_width_sharded``,
is fp only, as the JAX package's is.)

Remat (``checkpoint``): a block run under ``torch.utils.checkpoint``
recomputes its forward during the backward; the recompute writes no
BatchNorm running statistics (``recomputing``), so a step updates them
once, as flax's functional ``batch_stats`` do. Under a process group
(``parallel/mesh.py``) the train-mode statistics are the global batch's.
"""

from __future__ import annotations

import contextvars
import os
from typing import Callable, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from range_view_3d_detection_torch.kernels.conv import conv3x3_i8_fused
from range_view_3d_detection_torch.models.quantized import (
    Int8Conv,
    int8_conv_nhwc,
    qat_conv,
    quantize_to_int8,
    weight_rows_i8,
    weight_scale_per_channel,
)
from range_view_3d_detection_torch.parallel import spatial

IntPair = Union[int, Sequence[int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


_RECOMPUTING = contextvars.ContextVar("recomputing", default=False)


def recomputing() -> bool:
    """Whether the forward running now is a checkpoint's recompute."""
    return _RECOMPUTING.get()


def checkpoint(fn: Callable, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    activations inside are dropped after the forward and recomputed in
    the backward (the JAX ``nn.remat(..., prevent_cse=False)``). Every
    call after the first is a recompute, during which
    :func:`recomputing` is true. Outside a differentiated train forward it
    is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        token = _RECOMPUTING.set(True)
        try:
            return fn(*a)
        finally:
            _RECOMPUTING.reset(token)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False
    )


def batch_moments(yf: torch.Tensor, dims: Tuple[int, ...]):
    """Per-channel ``E[y]`` and ``E[y^2]`` of fp32 ``yf`` over ``dims``,
    the global batch's under a process group (and every width shard's
    under a train-mode width context)."""
    return spatial.bn_mean(yf.mean(dim=dims), (yf * yf).mean(dim=dims), spatial.context())


class BatchNorm(nn.BatchNorm2d):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` (torch momentum 0.1)
    on NCHW, with the fp32 result cast to a compute dtype and an optional
    ReLU: ``bn(y, dtype, act)``.

    Eval computes ``fma(y - mean, mul, bias)`` with ``mul = rsqrt(var +
    eps) * scale``, which is what jitted XLA emits for flax's ``(y - mean)
    * mul + bias``; ``y - mean`` promotes a bf16 ``y`` to fp32, and the
    fp32 result rounds to ``dtype`` once. Three passes over the tensor: the
    subtraction, ``addcmul`` into ``dtype`` and an in-place ReLU.

    Train mode is flax's (``use_fast_variance``): the batch mean and
    ``max(0, E[y^2] - mean^2)`` in fp32 over (N, H, W) (over every rank's
    rows under a process group), normalised in the eval form's order,
    ``addcmul(bias, y - mean, rsqrt(var + eps) * scale)``; the running
    statistics become ``0.9 r + 0.1 batch`` with the biased variance,
    written in place under ``no_grad``, except in a checkpoint's
    recompute. The parameter and buffer names are ``BatchNorm2d``'s.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def eval_mul(self) -> torch.Tensor:
        """fp32 ``rsqrt(var + eps) * scale``, the rsqrt rounded once from fp64.

        Cached until ``weight`` or ``running_var`` is written in place
        (their version counters) or moved (their storage); computed afresh
        while ``torch.export`` traces (its tensors have no storage).
        """
        w, v = self.weight, self.running_var
        if torch.compiler.is_compiling() or torch.compiler.is_exporting():
            return torch.rsqrt((v + self.eps).double()).float() * w
        key = (w._version, v._version, w.data_ptr(), v.data_ptr())
        cached = self.__dict__.get("_eval_mul")
        if cached is None or cached[0] != key:
            with torch.no_grad():
                mul = torch.rsqrt((v + self.eps).double()).float() * w
            cached = self.__dict__["_eval_mul"] = (key, mul)
        return cached[1]

    def forward(
        self, y: torch.Tensor, dtype: torch.dtype = torch.float32, act: bool = False
    ) -> torch.Tensor:
        if self.training:
            yf = y.float()
            mean, sq_mean = batch_moments(yf, (0, 2, 3))
            var = torch.clamp_min(sq_mean - mean * mean, 0.0)
            if not recomputing():
                with torch.no_grad():
                    self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                    self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
            mul = torch.rsqrt(var + self.eps) * self.weight
            out = torch.addcmul(
                self.bias[:, None, None], yf - mean[:, None, None], mul[:, None, None]
            ).to(dtype)
            return torch.relu(out) if act else out
        d = torch.sub(y, self.running_mean[:, None, None])
        bias = self.bias.detach()[:, None, None]
        mul = self.eval_mul()[:, None, None]
        if d.requires_grad:  # autograd takes no out=
            out = torch.addcmul(bias, d, mul).to(dtype)
        else:
            out = torch.addcmul(bias, d, mul, out=torch.empty_like(d, dtype=dtype))
        return out.relu_() if act else out


def torch_padding(k: int) -> Tuple[int, int]:
    """Torch-style 'same' padding of a k-wide kernel: a fixed ``k-1`` in
    all, ``(k-1)//2`` low and the rest high, independent of the stride."""
    return (k - 1) // 2, k - 1 - (k - 1) // 2


class ConvNormAct(nn.Module):
    """Conv + BatchNorm + ReLU with torch-style padding.

    The padding (:func:`torch_padding`) is a fixed ``k-1`` per dimension,
    ``(k-1)//2`` low and the rest high, independent of the stride, as in
    the JAX block (``blocks.py:303-314``). An odd kernel's is symmetric and
    ``Conv_0`` (``nn.Conv2d``) pads it itself; an even kernel's input is
    padded with ``F.pad`` and ``Conv_0`` pads 0, on every branch (fp, QAT,
    int8; ``fake_quant(0) == 0``, so padding before the fake-quant is
    exact).
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
        self.padding = (torch_padding(kh), torch_padding(kw))
        symmetric = kh % 2 == 1 and kw % 2 == 1
        self.norm = norm
        self.act = act
        self.dtype = dtype
        use_bias = (not norm) if use_bias is None else use_bias
        self.Conv_0 = nn.Conv2d(
            in_channels, features, (kh, kw), stride=_pair(strides),
            padding=((kh - 1) // 2, (kw - 1) // 2) if symmetric else 0, bias=use_bias,
        )
        if norm:
            self.BatchNorm_0 = BatchNorm(features)
        self.int8: Int8Conv | None = None
        self.qat_scale: torch.Tensor | None = None

    @property
    def calibrates_input(self) -> bool:
        """BN-bearing blocks take a calibrated input scale (JAX sows them)."""
        return self.norm

    def calib_input(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def quant_scales(self) -> dict:
        return {} if self.int8 is None else {"in_scale": float(self.int8.in_scale)}

    def quantize(self, in_scale: float | None) -> None:
        """Run ``Conv_0`` on int8 operands with ``in_scale`` (None: fp)."""
        self.int8 = None if in_scale is None else Int8Conv(
            self.Conv_0, in_scale, self.dtype, self.padding
        )

    def set_qat(self, in_scale: torch.Tensor | None) -> None:
        """Run ``Conv_0`` on fake-quantized operands (None: off)."""
        self.qat_scale = in_scale if self.norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        conv = self.Conv_0
        int8 = self.int8 is not None and self.qat_scale is None and not self.training
        (pt, pb), (pl, pr) = self.padding
        ctx = spatial.context()
        if ctx is not None and conv.kernel_size[1] > 1:
            # The width padding comes from the ring neighbours; VALID over
            # width keeps the output exactly shard-wide.
            x = spatial.exchange_halo_lr(
                x, pl, pr, ctx.group, w_axis=3, circular=ctx.circular
            )
            pl = pr = 0
        if int8:
            y = self.int8(x, ((pt, pb), (pl, pr)))
        else:
            if pt == pb and pl == pr:
                padding = (pt, pl)
            else:
                x, padding = F.pad(x, (pl, pr, pt, pb)), (0, 0)
            stride = conv.stride
            if conv.kernel_size == (1, 1) and stride != (1, 1) and x.device.type == "cpu":
                # A strided 1x1 conv is the 1x1 conv of the strided view.
                # PyTorch's CPU weight gradient of the strided form corrupts
                # the heap in channels_last memory at narrow widths (C = W =
                # 8, torch 2.13); the view's does not.
                x, stride = x[:, :, :: stride[0], :: stride[1]], (1, 1)
            if self.qat_scale is not None:
                y = qat_conv(
                    F.conv2d, x, conv.weight, conv.bias, self.qat_scale, 0,
                    stride=stride, padding=padding,
                ).to(dt)
            else:
                bias = None if conv.bias is None else conv.bias.to(dt)
                y = F.conv2d(x.to(dt), conv.weight.to(dt), bias, stride, padding)
        if self.norm:
            return self.BatchNorm_0(y, dt, self.act)
        return torch.relu(y) if self.act else y


def phase_merged_kernel(kernel: torch.Tensor, sw: int) -> torch.Tensor:
    """Merge a ``(kh, 2*sw, ci, co)`` transposed-conv kernel (flax HWIO,
    cross-correlation over the dilated input) into the ``(kh, 3, ci,
    sw*co)`` kernel of its exact subpixel decomposition: a copy of the JAX
    ``blocks.py::_phase_merged_kernel``.

    For width stride ``sw``, kernel width ``2*sw`` and padding ``sw//2``,
    output column ``x = sw*q + r`` reads two taps ``kw = (c - r) mod sw``
    (``c = 2*sw-1-sw//2``) at input columns ``q-1``/``q``/``q+1``, so each
    phase ``r`` is a stride-1 conv with a 3-wide window, and the phases
    interleave (r-major output blocks) into the transposed conv's output.
    """
    kh, kwt, ci, co = kernel.shape
    c = kwt - 1 - sw // 2
    merged = kernel.new_zeros((kh, 3, ci, sw * co))
    for kw in range(kwt):
        r = (c - kw) % sw
        j = (r + kw - c) // sw + 1  # input-column offset {-1,0,+1} -> {0,1,2}
        merged[:, j, :, r * co : (r + 1) * co] = kernel[:, kw]
    return merged


def phase_shape_ok(kernel_size, stride, padding) -> bool:
    """Whether a transposed conv has the aggregation nodes' shape, which the
    phase decomposition (:func:`phase_merged_kernel`) computes exactly:
    height stride 1, width stride ``sw >= 2``, kernel width ``2*sw``,
    padding ``sw//2`` and an odd kernel height ``2*ph + 1``."""
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    return sh == 1 and sw >= 2 and kw == 2 * sw and 2 * pw == sw and kh == 2 * ph + 1


def phase_deconv_enabled() -> bool:
    """``RV3D_DECONV_PHASE=1`` (the JAX package's switch) routes the fp
    transposed convs of the aggregation shape through the phase
    decomposition."""
    return os.environ.get("RV3D_DECONV_PHASE", "0") == "1"


class TorchConvTranspose(nn.ConvTranspose2d):
    """Transposed conv, counterpart of the JAX ``TorchConvTranspose``.

    The JAX module cross-correlates the stride-dilated input with its
    stored HWIO kernel; ``ConvTranspose2d`` does the same with the kernel
    flipped in space, and its output size ``(in-1)*s + k - 2p`` matches.
    ``transplant.py`` flips the kernel. ``use_bias`` (default False, as in
    JAX) adds the bias in the compute dtype after the conv (and after the
    int8 dequantize).

    Int8 (after ``quantize``): the input is quantized per tensor and the
    weight per output channel, the int32 sum dequantized as ``(acc.float()
    * in_scale * w_scale).to(dtype)``, as the JAX package's
    ``lhs_dilation`` lowering on int8 operands does; integer sums are
    exact, so both routes below equal it bit for bit.

    - The aggregation nodes' shape (height stride 1, kernel ``(2*ph+1,
      2*sw)`` with ``kh == 3``, padding ``(ph, sw//2)``): the int8 weights
      are merged into the phase decomposition's stride-1 3x3 kernel with
      ``sw * co`` outputs, which the int8 conv kernel (K3) runs on the
      activation and ``in_scale``, quantizing as it stages the input; its
      output ``(B, H, W, sw*co)`` interleaves into ``(B, H, W*sw, co)`` as
      a view.
    - Any other shape: the general int8 route (``quantized.
      int8_conv_nhwc``) on the zero-inserted input with the flipped HWIO
      kernel, padding ``kh-1-ph``, ``kw-1-pw`` a side (a negative one
      crops) and stride 1 (symmetric int8 holds the inserted zeros
      exactly).

    fp with ``RV3D_DECONV_PHASE=1`` (the JAX ``_phase_deconv``): the same
    merged kernel, in the compute dtype, as a stride-1 conv with a 3-wide
    window, its ``sw`` phases interleaved. Off by default, as in JAX.

    Under width sharding (``parallel/spatial.py``) it fetches the
    ``(halo_l, halo_r)`` input columns its footprint reads across the
    shard's edges, runs on the widened shard and slices the exact local
    output; the fp phase form consumes that (1, 1) halo with VALID width.
    The int8 operands take the general route there, every shape.
    """

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: IntPair,
        strides: IntPair,
        padding: IntPair,
        dtype: torch.dtype = torch.float32,
        use_bias: bool = False,
    ):
        super().__init__(
            in_channels,
            features,
            _pair(kernel_size),
            stride=_pair(strides),
            padding=_pair(padding),
            bias=use_bias,
        )
        self.dtype = dtype
        for name in ("int8_scale", "int8_taps", "int8_dq", "int8_rows"):
            self.register_buffer(name, None, persistent=False)
        self.qat_scale: torch.Tensor | None = None

    def set_qat(self, in_scale: torch.Tensor | None) -> None:
        """Run on fake-quantized operands (None: off)."""
        self.qat_scale = in_scale

    calibrates_input = True

    def calib_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def quant_scales(self) -> dict:
        return {} if self.int8_scale is None else {"in_scale": float(self.int8_scale)}

    @torch.no_grad()
    def quantize(self, in_scale: float | None) -> None:
        """Run on int8 operands with ``in_scale`` (None: fp)."""
        self.int8_scale = self.int8_taps = self.int8_dq = self.int8_rows = None
        if in_scale is None:
            return
        w = self.hwio_kernel().detach().float()
        w_scale = weight_scale_per_channel(w, out_dim=3)
        w_i8 = quantize_to_int8(w, w_scale)
        scale = torch.as_tensor(in_scale, dtype=torch.float32, device=w.device)
        self.int8_scale = scale.reshape(())
        self.int8_dq = scale * w_scale
        self.int8_rows = weight_rows_i8(w_i8)
        sw = self.stride[1]
        if self.kernel_size[0] == 3 and phase_shape_ok(
            self.kernel_size, self.stride, self.padding
        ):
            merged = phase_merged_kernel(w_i8, sw)  # (3, 3, ci, sw*co)
            ci, sco = merged.shape[2:]
            taps = merged.reshape(9, ci, sco).transpose(1, 2).contiguous()
            self.int8_taps = taps.transpose(1, 2)  # (9, ci, sw*co), [n][k] memory
            self.int8_dq = self.int8_dq.repeat(sw)  # the sw phases' outputs

    def hwio_kernel(self) -> torch.Tensor:
        """The flax HWIO kernel: ``(I, O, kh, kw)`` flipped in space back."""
        return self.weight.flip(2, 3).permute(2, 3, 0, 1)

    def _dilated(self, x: torch.Tensor) -> torch.Tensor:
        if self.qat_scale is not None:
            # The weight is (Cin, Cout, kh, kw): output channels on axis 1.
            return qat_conv(
                F.conv_transpose2d, x, self.weight, None, self.qat_scale, 1,
                stride=self.stride, padding=self.padding,
            ).to(self.dtype)
        if self.int8_scale is not None:
            (kh, kw), (ph, pw) = self.kernel_size, self.padding
            y = int8_conv_nhwc(
                quantize_to_int8(x.to(self.dtype), self.int8_scale).permute(0, 2, 3, 1),
                self.int8_rows, self.out_channels, (kh, kw), (1, 1),
                ((kh - 1 - ph,) * 2, (kw - 1 - pw,) * 2),
                self.int8_dq[: self.out_channels], None,
                self.dtype, dilation=self.stride,
            )
            return y.permute(0, 3, 1, 2)
        return F.conv_transpose2d(
            x.to(self.dtype), self.weight.to(self.dtype), None, self.stride, self.padding
        )

    def _phase(self, x: torch.Tensor, pad_w: int) -> torch.Tensor:
        """The phase decomposition in the compute dtype: a stride-1 conv of
        the merged kernel (``pad_w`` zero columns a side, 0 on a halo'd
        shard), its ``sw*co`` channels interleaved into ``sw`` columns."""
        dt, sw, ph = self.dtype, self.stride[1], self.padding[0]
        merged = phase_merged_kernel(self.hwio_kernel().to(dt), sw)  # (kh, 3, ci, sw*co)
        y = F.conv2d(x.to(dt), merged.permute(3, 2, 0, 1), None, 1, (ph, pad_w))
        B, sco, H, W = y.shape
        co = sco // sw
        y = y.reshape(B, sw, co, H, W).permute(0, 2, 3, 4, 1)
        return y.reshape(B, co, H, W * sw)

    def _k3_phase(self, x: torch.Tensor) -> torch.Tensor:
        """The int8 phase decomposition on K3, which quantizes the NHWC
        view of the activation as it stages it."""
        dt, sw = self.dtype, self.stride[1]
        y = conv3x3_i8_fused(
            x.to(dt).permute(0, 2, 3, 1), self.int8_taps, self.int8_dq,
            stride_w=1, out_dtype=dt, in_scale=self.int8_scale,
        )
        B, H, W, sco = y.shape
        return y.reshape(B, H, W * sw, sco // sw).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kw, sw, pw = self.kernel_size[1], self.stride[1], self.padding[1]
        fp = self.qat_scale is not None or self.int8_scale is None
        phase = (
            fp
            and phase_deconv_enabled()
            and phase_shape_ok(self.kernel_size, self.stride, self.padding)
        )
        ctx = spatial.context()
        # Input columns the footprint reads across a shard's edges (exact for
        # any sw >= 1; sw == 1 is the regular conv's kw-1-pw / pw).
        halo_l = max(0, (kw - 1 - pw) // sw)
        halo_r = max(0, (pw + sw - 1) // sw)
        if ctx is not None and (halo_l or halo_r):
            Wl = x.shape[3]
            x = spatial.exchange_halo_lr(
                x, halo_l, halo_r, ctx.group, w_axis=3, circular=ctx.circular
            )
            if phase and halo_l == 1 and halo_r == 1:
                y = self._phase(x, 0)
            else:
                y = self._dilated(x).narrow(3, halo_l * sw, Wl * sw)
        elif phase:
            y = self._phase(x, 1)
        elif fp or self.int8_taps is None:
            y = self._dilated(x)
        else:
            y = self._k3_phase(x)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


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
        self.BatchNorm_0 = BatchNorm(features)
        self.ResidualBlock_0 = ResidualBlock(
            features, features, num_blocks, dtype=dtype
        )

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        y = self.BatchNorm_0(self.TorchConvTranspose_0(x2), self.dtype, act=True)
        return self.ResidualBlock_0(x1 + y)
