"""Fused eval MetaKernel stem: CUDA kernel wrappers and their plain twins.

- K1 ``meta_kernel_fused`` replaces ``range_view_3d_detection_tpu/kernels/
  stem_pallas.py::meta_kernel_fused`` (``_stem_kernel``); the kernel is
  ``csrc/meta_kernel_fused.cu``.
- K4 ``meta_kernel_fused_i8``, its int8 twin, replaces ``stem_pallas.py::
  meta_kernel_fused_i8`` (``_stem_kernel_i8``); the kernel is
  ``csrc/meta_kernel_fused_i8.cu``.

Each kernel's header says what bounds it on the H100 (the two 256x256
GEMMs per neighbour: compute, at B=2 and the flagship 64x1808 image) and
how its design follows from that.

Both are ``torch.library`` custom ops, ``rv3d::meta_kernel_fused`` and
``rv3d::meta_kernel_fused_i8``: the CPU kernel is the plain twin, the
CUDA kernel launches the ctypes entry point (built at its first launch),
and a fake kernel gives the output's shape and dtype, so ``torch.export``
and CUDA-graph capture see one opaque op. The wrappers check their
arguments and call the op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from range_view_3d_detection_torch.kernels import _build

NUM_NEIGHBORS = 3


def meta_kernel_fused_plain(
    g: torch.Tensor,
    feats: torch.Tensor,
    w1: torch.Tensor,
    k: torch.Tensor,
    a0: torch.Tensor,
    b0: torch.Tensor,
    a1: torch.Tensor,
    b1: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, with its bf16 rounding points.

    ``x0 = g(p+d) - g(p)`` is taken in the compute dtype (that of ``g``),
    ``hh`` is cast to it before the ``W1`` product, ``p`` is cast to it
    and multiplied by the shifted feats in it, and both products sum in
    fp32. Neighbours outside the image are zeros.

    Args:
        g: (B, H, W, C) conv0(cart) in the compute dtype.
        feats: (B, H, W, C) projected features.
        w1: (C, C) second pos-conv kernel (x @ w1).
        k: (9, C, C) fusion1 blocked kernel, dy-major neighbours.
        a0, b0, a1, b1: (C,) fp32 eval-BN affines.

    Returns:
        (B, H, W, C) fp32 ``geo`` before fusion1_bn.
    """
    B, H, W, C = g.shape
    cdt = g.dtype
    feats = feats.to(cdt)
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    fp = F.pad(feats, (0, 0, 1, 1, 1, 1))
    w1f = w1.to(cdt).float()
    kf = k.to(cdt).float()
    a0, b0, a1, b1 = (v.float() for v in (a0, b0, a1, b1))
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
    for dy in range(NUM_NEIGHBORS):
        for dx in range(NUM_NEIGHBORS):
            x0 = (gp[:, dy : dy + H, dx : dx + W] - g).float()
            hh = torch.relu(x0 * a0 + b0)
            z = hh.to(cdt).float() @ w1f
            p = torch.relu(z * a1 + b1)
            pf = p.to(cdt) * fp[:, dy : dy + H, dx : dx + W]
            acc = acc + pf.float() @ kf[dy * NUM_NEIGHBORS + dx]
    return acc


def meta_kernel_fused(
    g: torch.Tensor,
    feats: torch.Tensor,
    w1: torch.Tensor,
    k: torch.Tensor,
    a0: torch.Tensor,
    b0: torch.Tensor,
    a1: torch.Tensor,
    b1: torch.Tensor,
) -> torch.Tensor:
    """Fused 9-neighbour stem accumulation (see :func:`meta_kernel_fused_plain`).

    A CPU tensor takes the plain twin, at any C. A CUDA tensor launches the
    kernel (bf16 ``g``/``feats``, C a multiple of 32 up to 256: the
    configs' META stems are 256, 128 and 32 wide) or raises; the kernel's
    entry point refuses any other C. ``meta_kernel_fused.launches`` counts
    the kernel launches.
    """
    if g.device.type == "cuda":
        B, H, W, C = g.shape
        if g.dtype != torch.bfloat16:
            raise TypeError(f"meta_kernel_fused: the kernel takes bf16, got {g.dtype}")
        if feats.shape != g.shape or w1.shape != (C, C) or k.shape != (9, C, C):
            raise ValueError(
                f"meta_kernel_fused: shapes g{tuple(g.shape)} feats"
                f"{tuple(feats.shape)} w1{tuple(w1.shape)} k{tuple(k.shape)}"
            )
        tensors = (g, feats, w1, k, a0, b0, a1, b1)
        if any(t.device != g.device for t in tensors):
            raise ValueError("meta_kernel_fused: inputs on different devices")
        for v in (a0, b0, a1, b1):
            if v.shape != (C,):
                raise ValueError(f"meta_kernel_fused: affine shape {tuple(v.shape)}")
    elif g.device.type not in ("cpu", "meta"):
        raise ValueError(f"meta_kernel_fused: unsupported device {g.device}")
    return torch.ops.rv3d.meta_kernel_fused(g, feats, w1, k, a0, b0, a1, b1)


@torch.library.custom_op("rv3d::meta_kernel_fused", mutates_args=(), device_types="cpu")
def _k1_op(
    g: torch.Tensor, feats: torch.Tensor, w1: torch.Tensor, k: torch.Tensor,
    a0: torch.Tensor, b0: torch.Tensor, a1: torch.Tensor, b1: torch.Tensor,
) -> torch.Tensor:
    return meta_kernel_fused_plain(g, feats, w1, k, a0, b0, a1, b1)


@_k1_op.register_fake
def _(g, feats, w1, k, a0, b0, a1, b1):
    return g.new_empty(g.shape, dtype=torch.float32)


@_k1_op.register_kernel("cuda")
def _k1_cuda(g, feats, w1, k, a0, b0, a1, b1):
    B, H, W, C = g.shape
    g = g.contiguous()
    feats = feats.to(torch.bfloat16).contiguous()
    # Transposed weights, [n][k]: the kernel's TMA boxes are K-major.
    w1t = w1.to(torch.bfloat16).t().contiguous()
    kt = k.to(torch.bfloat16).transpose(1, 2).contiguous()
    a0, b0, a1, b1 = (v.float().contiguous() for v in (a0, b0, a1, b1))
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=g.device)
    lib = _build.library()
    with torch.cuda.device(g.device):
        err = lib.rv3d_meta_kernel_fused(
            g.data_ptr(), feats.data_ptr(), w1t.data_ptr(), kt.data_ptr(),
            a0.data_ptr(), b0.data_ptr(), a1.data_ptr(), b1.data_ptr(),
            out.data_ptr(), B, H, W, C,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rv3d_meta_kernel_fused")
    meta_kernel_fused.launches += 1
    return out


meta_kernel_fused.launches = 0


def meta_kernel_fused_i8_plain(
    g: torch.Tensor,
    feats: torch.Tensor,
    w1_i8: torch.Tensor,
    k_i8: torch.Tensor,
    a0: torch.Tensor,
    b0: torch.Tensor,
    a1: torch.Tensor,
    b1: torch.Tensor,
    kdq: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch twin of the int8 kernel, step for step.

    Per neighbour ``n = 3 dy + dx``: ``x0 = g(p+d) - g(p)`` in the dtype
    of ``g``, then fp32; ``hq = min(round(relu(x0 a0 + b0)), 127)``;
    ``z = hq @ W1``; ``p = relu(z a1 + b1)``; ``pq = clip(round(p * fs),
    ±127)`` with the product in fp32; ``acc += (pq @ K_n) * kdq[n]``. The
    integer products run in fp64, which is exact for them, and convert to
    fp32 once. Neighbours outside the image are zeros.

    Args:
        g: (B, H, W, C) conv0(cart) in the compute dtype.
        feats: (B, H, W, C) projected features.
        w1_i8: (C, C) int8 pos-conv kernel (x @ w1), per-column scales.
        k_i8: (9, C, C) int8 fusion1 blocks, dy-major neighbours.
        a0, b0: (C,) fp32 BN0 affine divided by the ``hh`` scale.
        a1, b1: (C,) fp32 BN1 affine carrying ``s_hh * s_w1`` and divided
            by the ``p * feats`` scale.
        kdq: (9, C) fp32 per-neighbour dequant ``s_pf * s_k[n]``.

    Returns:
        (B, H, W, C) fp32 ``geo`` before fusion1_bn.
    """
    B, H, W, C = g.shape
    feats = feats.to(g.dtype)
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    fp = F.pad(feats, (0, 0, 1, 1, 1, 1))
    w1d = w1_i8.double()
    kd = k_i8.double()
    a0, b0, a1, b1, kdq = (v.float() for v in (a0, b0, a1, b1, kdq))
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
    for dy in range(NUM_NEIGHBORS):
        for dx in range(NUM_NEIGHBORS):
            n = dy * NUM_NEIGHBORS + dx
            x0 = (gp[:, dy : dy + H, dx : dx + W] - g).float()
            hq = torch.clamp(torch.round(torch.relu(x0 * a0 + b0)), max=127.0)
            z = (hq.double() @ w1d).float()
            p = torch.relu(z * a1 + b1)
            fs = fp[:, dy : dy + H, dx : dx + W].float()
            pq = torch.clamp(torch.round(p * fs), -127.0, 127.0)
            acc = acc + (pq.double() @ kd[n]).float() * kdq[n]
    return acc


def meta_kernel_fused_i8(
    g: torch.Tensor,
    feats: torch.Tensor,
    w1_i8: torch.Tensor,
    k_i8: torch.Tensor,
    a0: torch.Tensor,
    b0: torch.Tensor,
    a1: torch.Tensor,
    b1: torch.Tensor,
    kdq: torch.Tensor,
) -> torch.Tensor:
    """int8 fused stem (see :func:`meta_kernel_fused_i8_plain`).

    A CPU tensor takes the plain twin, at any C. A CUDA tensor launches the
    kernel (bf16 ``g``/``feats``, int8 weights, C a multiple of 32 up to
    256, as K1) or raises; the kernel's entry point refuses any other C.
    Weights stored as transposed views of their [n][k] layout (``w1_i8 =
    w1t.t()``, as ``MetaKernel.quantize_stem`` keeps them) pass without a
    copy. ``meta_kernel_fused_i8.launches`` counts the kernel launches.
    """
    if g.device.type == "cuda":
        B, H, W, C = g.shape
        if g.dtype != torch.bfloat16:
            raise TypeError(f"meta_kernel_fused_i8: the kernel takes bf16, got {g.dtype}")
        if w1_i8.dtype != torch.int8 or k_i8.dtype != torch.int8:
            raise TypeError("meta_kernel_fused_i8: int8 weights expected")
        if feats.shape != g.shape or w1_i8.shape != (C, C) or k_i8.shape != (9, C, C):
            raise ValueError(
                f"meta_kernel_fused_i8: shapes g{tuple(g.shape)} feats"
                f"{tuple(feats.shape)} w1{tuple(w1_i8.shape)} k{tuple(k_i8.shape)}"
            )
        if kdq.shape != (9, C):
            raise ValueError(f"meta_kernel_fused_i8: kdq shape {tuple(kdq.shape)}")
        tensors = (g, feats, w1_i8, k_i8, a0, b0, a1, b1, kdq)
        if any(t.device != g.device for t in tensors):
            raise ValueError("meta_kernel_fused_i8: inputs on different devices")
        for v in (a0, b0, a1, b1):
            if v.shape != (C,):
                raise ValueError(f"meta_kernel_fused_i8: affine shape {tuple(v.shape)}")
    elif g.device.type not in ("cpu", "meta"):
        raise ValueError(f"meta_kernel_fused_i8: unsupported device {g.device}")
    return torch.ops.rv3d.meta_kernel_fused_i8(g, feats, w1_i8, k_i8, a0, b0, a1, b1, kdq)


@torch.library.custom_op("rv3d::meta_kernel_fused_i8", mutates_args=(), device_types="cpu")
def _k4_op(
    g: torch.Tensor, feats: torch.Tensor, w1_i8: torch.Tensor, k_i8: torch.Tensor,
    a0: torch.Tensor, b0: torch.Tensor, a1: torch.Tensor, b1: torch.Tensor,
    kdq: torch.Tensor,
) -> torch.Tensor:
    return meta_kernel_fused_i8_plain(g, feats, w1_i8, k_i8, a0, b0, a1, b1, kdq)


@_k4_op.register_fake
def _(g, feats, w1_i8, k_i8, a0, b0, a1, b1, kdq):
    return g.new_empty(g.shape, dtype=torch.float32)


@_k4_op.register_kernel("cuda")
def _k4_cuda(g, feats, w1_i8, k_i8, a0, b0, a1, b1, kdq):
    B, H, W, C = g.shape
    g = g.contiguous()
    feats = feats.to(torch.bfloat16).contiguous()
    # [n][k]: the kernel's TMA boxes are K-major (s8 wgmma takes K-major A
    # and B).
    w1t = w1_i8.t().contiguous()
    kt = k_i8.transpose(1, 2).contiguous()
    a0, b0, a1, b1, kdq = (v.float().contiguous() for v in (a0, b0, a1, b1, kdq))
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=g.device)
    lib = _build.library()
    with torch.cuda.device(g.device):
        err = lib.rv3d_meta_kernel_fused_i8(
            g.data_ptr(), feats.data_ptr(), w1t.data_ptr(), kt.data_ptr(),
            a0.data_ptr(), b0.data_ptr(), a1.data_ptr(), b1.data_ptr(),
            kdq.data_ptr(), out.data_ptr(), B, H, W, C,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rv3d_meta_kernel_fused_i8")
    meta_kernel_fused_i8.launches += 1
    return out


meta_kernel_fused_i8.launches = 0
