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

from typing import Optional

import torch
import torch.nn.functional as F

from range_view_3d_detection_torch.kernels import _build


INT8_MAX = 127.0


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
    CUDA tensor launches the kernel or raises: Cin must be a multiple of
    32, Cout of 16, ``out_dtype`` bf16 or fp32; the kernel's entry point
    rejects a shape beyond its grid's limits. ``x_i8`` should be
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
    in_kinds = _IN_KINDS if scale is not None else {torch.int8: 0}
    if x_i8.dtype not in in_kinds or w_i8.dtype != torch.int8:
        raise TypeError(
            f"conv3x3_i8_fused: input {x_i8.dtype} (in_scale "
            f"{'given' if scale is not None else 'None'}), weights {w_i8.dtype}"
        )
    if w_i8.dim() != 3 or w_i8.shape[:2] != (9, Cin):
        raise ValueError(
            f"conv3x3_i8_fused: weights {tuple(w_i8.shape)} for Cin={Cin}"
        )
    Cout = w_i8.shape[2]
    if Cin % 32 or Cout % 16:
        raise ValueError(
            f"conv3x3_i8_fused: Cin={Cin} must be a multiple of 32 and "
            f"Cout={Cout} of 16"
        )
    if stride_w not in (1, 2):
        raise ValueError(f"conv3x3_i8_fused: stride_w={stride_w}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3_i8_fused: out_dtype {out_dtype}")
    if dq.shape != (Cout,):
        raise ValueError(f"conv3x3_i8_fused: dq shape {tuple(dq.shape)}")
    if w_i8.device != x_i8.device or dq.device != x_i8.device:
        raise ValueError("conv3x3_i8_fused: inputs on different devices")
    if scale is not None and scale.numel() != 1:
        raise ValueError(f"conv3x3_i8_fused: in_scale shape {tuple(scale.shape)}")


_IN_KINDS = {torch.bfloat16: 1, torch.float32: 2}


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
    in_kind = _IN_KINDS[x_i8.dtype] if in_scale is not None else 0
    x_i8 = x_i8.contiguous()
    wt = w_i8.transpose(1, 2).contiguous()  # (9, Cout, Cin): [n][k]
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
            B, H, W, Cin, Cout, stride_w, in_kind,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rv3d_conv3x3_i8")
    conv3x3_i8_fused.launches += 1
    return out


conv3x3_i8_fused.launches = 0
