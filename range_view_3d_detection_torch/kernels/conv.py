"""Fused int8 3x3 conv + dequant (K3): CUDA kernel wrapper and its plain twin.

Replaces ``range_view_3d_detection_tpu/kernels/conv_pallas.py::
conv3x3_i8_fused`` (``_conv_kernel``, ``_conv_kernel_s2``). The kernel is
``csrc/conv3x3_i8.cu`` (wgmma, TMA weights, warp-specialized); its header
says what bounds it on the H100 (the int8 tensor-core rate at the
512-channel head towers) and how its design follows from that. Every int8
3x3 conv of the serving path runs it, and so does every int8 transposed
conv after its phase decomposition (``models/blocks.py``).

Two operand forms: int8 ``x`` (the TPU kernel's), or the bf16/fp32
activation with its per-tensor ``in_scale``, which the kernel quantizes
(:func:`quantize_to_int8`) while it stages the input, so no quantized copy
of the activation is made.

The kernel is the ``torch.library`` custom op ``rv3d::conv3x3_i8``: the
plain twin on the CPU, the ctypes launch on the card (built at its first
launch), a fake kernel for ``torch.export`` and CUDA-graph capture.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from range_view_3d_detection_torch.kernels import _build


INT8_MAX = 127.0
CIN_CHUNK = 32  # input channels a pipeline stage of the kernel takes


class ConvPlan(NamedTuple):
    """How K3 runs one call on the card.

    ``in_kind``: the operand form the entry point instantiates, 0 for an
    int8 input, 1 / 2 for a bf16 / fp32 activation quantized as it is
    staged (the template instance is this and the width stride).
    ``cin_pad``: the zero input channels the wrapper adds (one copy of
    ``x`` and of the weights a call) so that Cin is a multiple of 32;
    q(0) = 0, so the int32 sums do not change. A Cout that is not a
    multiple of the kernel's 128-channel tile is masked on the store, with
    no copy.
    """

    in_kind: int
    cin_pad: int


_IN_KINDS = {torch.bfloat16: 1, torch.float32: 2}


def k3_plan(Cin: int, Cout: int, stride_w: int, x_dtype: torch.dtype,
            quantized_in_kernel: bool) -> ConvPlan:
    """K3's launch for ``x`` of Cin channels in ``x_dtype`` (int8, or
    bf16/fp32 with ``in_scale``: ``quantized_in_kernel``), Cout outputs
    and width stride 1 or 2."""
    if Cin < 1 or Cout < 1:
        raise ValueError(f"conv3x3_i8_fused: Cin={Cin}, Cout={Cout}")
    if stride_w not in (1, 2):
        raise ValueError(f"conv3x3_i8_fused: stride_w={stride_w}")
    if quantized_in_kernel:
        in_kind = _IN_KINDS.get(x_dtype)
    else:
        in_kind = 0 if x_dtype == torch.int8 else None
    if in_kind is None:
        raise TypeError(
            f"conv3x3_i8_fused: input {x_dtype} (in_scale "
            f"{'given' if quantized_in_kernel else 'None'})"
        )
    return ConvPlan(in_kind, -Cin % CIN_CHUNK)


def _out_width(W: int, stride_w: int) -> int:
    return (W - 1) // stride_w + 1


def quantize_to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), ±127)`` as int8 (round half to even; a
    division, not a product by the reciprocal, as in the JAX package)."""
    return torch.clamp(torch.round(x.float() / scale), -INT8_MAX, INT8_MAX).to(
        torch.int8
    )


def conv3x3_i8_fused_plain(
    x_i8: torch.Tensor,
    w_i8: torch.Tensor,
    dq: torch.Tensor,
    *,
    stride_w: int = 1,
    out_dtype: torch.dtype = torch.bfloat16,
    in_scale: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin: the same function, computed exactly.

    With ``in_scale``, ``x_i8`` is the bf16/fp32 activation and is first
    quantized with :func:`quantize_to_int8`.

    Each of the 9 taps is one fp64 matrix product of the shifted int8
    input and the tap's int8 weights; every partial sum is an integer
    below 2**53, so the fp64 sum equals the int32 one. It is converted to
    fp32 once (round to nearest), multiplied by ``dq`` in fp32 and cast
    to ``out_dtype``: ``(acc.astype(f32) * dq).astype(out_dtype)``.

    Args:
        x_i8: (B, H, W, Cin) int8, symmetric (zero padding is exact).
        w_i8: (9, Cin, Cout) int8, dy-major taps (HWIO reshaped).
        dq: (Cout,) fp32 dequant scale (``in_scale * w_scale``).
        stride_w: width stride, 1 or 2 ('same' padding of 1 on each side,
            so ``Wo = (W - 1) // stride_w + 1``).

    Returns:
        (B, H, Wo, Cout) ``out_dtype``.
    """
    if in_scale is not None:
        x_i8 = quantize_to_int8(x_i8, torch.as_tensor(in_scale, dtype=torch.float32))
    B, H, W, Cin = x_i8.shape
    Wo = _out_width(W, stride_w)
    xp = F.pad(x_i8.double(), (0, 0, 1, 1, 1, 1))
    wd = w_i8.double()
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy : dy + H, dx : dx + stride_w * (Wo - 1) + 1 : stride_w]
            term = tap.reshape(-1, Cin) @ wd[3 * dy + dx]
            acc = term if acc is None else acc + term
    y = acc.float() * dq.float()
    return y.to(out_dtype).reshape(B, H, Wo, -1)


def conv3x3_i8_fused(
    x_i8: torch.Tensor,
    w_i8: torch.Tensor,
    dq: torch.Tensor,
    *,
    stride_w: int = 1,
    out_dtype: torch.dtype = torch.bfloat16,
    in_scale: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """int8 3x3 'same' conv, int32 accumulation, per-Cout fp32 dequant
    (see :func:`conv3x3_i8_fused_plain` for the arguments).

    ``x_i8`` is int8, or, with ``in_scale`` (an fp32 scalar, best a 0-dim
    tensor on the input's device), the bf16/fp32 activation that the
    kernel quantizes as it stages it. A CPU tensor takes the plain twin. A
    CUDA tensor launches the kernel as :func:`k3_plan` says (any Cin and
    Cout) or raises: ``out_dtype`` must be bf16 or fp32, and the kernel's
    entry point rejects a shape beyond its grid's limits. ``x_i8`` should be
    NHWC-contiguous (channels_last memory seen through a permute); another
    layout is copied. ``w_i8`` is best a transposed view of a contiguous
    (9, Cout, Cin) tensor (the kernel's operand layout); any other layout
    is copied. ``conv3x3_i8_fused.launches`` counts the kernel launches.
    """
    scale = None
    if in_scale is not None:
        scale = torch.as_tensor(in_scale, dtype=torch.float32, device=x_i8.device)
    if x_i8.device.type == "cuda":
        _check_k3(x_i8, w_i8, dq, stride_w, out_dtype, scale)
    elif x_i8.device.type not in ("cpu", "meta"):
        raise ValueError(f"conv3x3_i8_fused: unsupported device {x_i8.device}")
    return torch.ops.rv3d.conv3x3_i8(x_i8, w_i8, dq, scale, stride_w, out_dtype)


def _check_k3(x_i8, w_i8, dq, stride_w, out_dtype, scale) -> None:
    """What the CUDA kernel takes (shapes and dtypes only)."""
    B, H, W, Cin = x_i8.shape
    if w_i8.dtype != torch.int8:
        raise TypeError(f"conv3x3_i8_fused: weights {w_i8.dtype}")
    if w_i8.dim() != 3 or w_i8.shape[:2] != (9, Cin):
        raise ValueError(
            f"conv3x3_i8_fused: weights {tuple(w_i8.shape)} for Cin={Cin}"
        )
    Cout = w_i8.shape[2]
    k3_plan(Cin, Cout, stride_w, x_i8.dtype, scale is not None)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3_i8_fused: out_dtype {out_dtype}")
    if dq.shape != (Cout,):
        raise ValueError(f"conv3x3_i8_fused: dq shape {tuple(dq.shape)}")
    if w_i8.device != x_i8.device or dq.device != x_i8.device:
        raise ValueError("conv3x3_i8_fused: inputs on different devices")
    if scale is not None and scale.numel() != 1:
        raise ValueError(f"conv3x3_i8_fused: in_scale shape {tuple(scale.shape)}")


@torch.library.custom_op("rv3d::conv3x3_i8", mutates_args=(), device_types="cpu")
def _k3_op(
    x_i8: torch.Tensor, w_i8: torch.Tensor, dq: torch.Tensor,
    in_scale: Optional[torch.Tensor], stride_w: int, out_dtype: torch.dtype,
) -> torch.Tensor:
    return conv3x3_i8_fused_plain(
        x_i8, w_i8, dq, stride_w=stride_w, out_dtype=out_dtype, in_scale=in_scale
    )


@_k3_op.register_fake
def _(x_i8, w_i8, dq, in_scale, stride_w, out_dtype):
    B, H, W, _ = x_i8.shape
    return x_i8.new_empty((B, H, _out_width(W, stride_w), w_i8.shape[2]), dtype=out_dtype)


@_k3_op.register_kernel("cuda")
def _k3_cuda(x_i8, w_i8, dq, in_scale, stride_w, out_dtype):
    B, H, W, Cin = x_i8.shape
    Cout = w_i8.shape[2]
    plan = k3_plan(Cin, Cout, stride_w, x_i8.dtype, in_scale is not None)
    wt = w_i8.transpose(1, 2)  # (9, Cout, Cin): [n][k]
    if plan.cin_pad:
        x_i8 = F.pad(x_i8, (0, plan.cin_pad))
        wt = F.pad(wt, (0, plan.cin_pad))
        Cin += plan.cin_pad
    x_i8 = x_i8.contiguous()
    wt = wt.contiguous()
    dq = dq.float().contiguous()
    if x_i8.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("conv3x3_i8_fused: operands must be 16-byte aligned")
    out = torch.empty(
        (B, H, _out_width(W, stride_w), Cout), dtype=out_dtype, device=x_i8.device
    )
    lib = _build.library()
    with torch.cuda.device(x_i8.device):
        err = lib.rv3d_conv3x3_i8(
            x_i8.data_ptr(), wt.data_ptr(), dq.data_ptr(),
            None if in_scale is None else in_scale.data_ptr(), out.data_ptr(),
            B, H, W, Cin, Cout, stride_w, plan.in_kind,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rv3d_conv3x3_i8")
    conv3x3_i8_fused.launches += 1
    return out


conv3x3_i8_fused.launches = 0
