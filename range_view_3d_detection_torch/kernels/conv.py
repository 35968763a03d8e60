"""Fused int8 3x3 conv + dequant (K3): CUDA kernel wrapper and its plain twin.

Replaces ``range_view_3d_detection_tpu/kernels/conv_pallas.py::
conv3x3_i8_fused`` (``_conv_kernel``, ``_conv_kernel_s2``). The kernel is
``csrc/conv3x3_i8.cu``; its header says what bounds it on the H100 (the
int8 tensor-core rate at the 512-channel head towers) and how its design
follows from that. Every int8 3x3 conv of the serving path runs it, and
so does every int8 transposed conv after its phase decomposition
(``models/blocks.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from range_view_3d_detection_torch.kernels import _build


def _out_width(W: int, stride_w: int) -> int:
    return (W - 1) // stride_w + 1


def conv3x3_i8_fused_plain(
    x_i8: torch.Tensor,
    w_i8: torch.Tensor,
    dq: torch.Tensor,
    *,
    stride_w: int = 1,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch twin: the same function, computed exactly.

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
) -> torch.Tensor:
    """int8 3x3 'same' conv, int32 accumulation, per-Cout fp32 dequant
    (see :func:`conv3x3_i8_fused_plain` for the arguments).

    A CPU tensor takes the plain twin. A CUDA tensor launches the kernel
    or raises: Cin must be a multiple of 32, Cout of 16, ``out_dtype``
    bf16 or fp32. ``w_i8`` is best a transposed view of a contiguous
    (9, Cout, Cin) tensor (the kernel's operand layout); any other layout
    is copied. ``conv3x3_i8_fused.launches`` counts the kernel launches.
    """
    if x_i8.device.type == "cpu":
        return conv3x3_i8_fused_plain(
            x_i8, w_i8, dq, stride_w=stride_w, out_dtype=out_dtype
        )
    if x_i8.device.type != "cuda":
        raise ValueError(f"conv3x3_i8_fused: unsupported device {x_i8.device}")
    B, H, W, Cin = x_i8.shape
    if x_i8.dtype != torch.int8 or w_i8.dtype != torch.int8:
        raise TypeError(
            f"conv3x3_i8_fused: int8 operands, got {x_i8.dtype}, {w_i8.dtype}"
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
    if B * H > 65535:
        raise ValueError(f"conv3x3_i8_fused: B*H={B * H} > 65535")
    x_i8 = x_i8.contiguous()
    wt = w_i8.transpose(1, 2).contiguous()  # (9, Cout, Cin): [n][k]
    dq = dq.float().contiguous()
    if x_i8.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("conv3x3_i8_fused: operands must be 16-byte aligned")
    Wo = _out_width(W, stride_w)
    out = torch.empty((B, H, Wo, Cout), dtype=out_dtype, device=x_i8.device)
    lib = _build.library()
    with torch.cuda.device(x_i8.device):
        err = lib.rv3d_conv3x3_i8(
            x_i8.data_ptr(), wt.data_ptr(), dq.data_ptr(), out.data_ptr(),
            B, H, W, Cin, Cout, stride_w, int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rv3d_conv3x3_i8")
    conv3x3_i8_fused.launches += 1
    return out


conv3x3_i8_fused.launches = 0
