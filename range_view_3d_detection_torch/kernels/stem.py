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

On the card each takes what its Pallas counterpart takes: ``g`` and
``feats`` in bf16 or fp32, any C. :func:`k1_plan` and :func:`k4_plan` say
which entry point of a source a call launches and what the wrapper pads
(zero channels, with one copy of each input and of the output's crop;
zero channels are exact: their ``hh``, ``p`` and ``p * feats`` are 0).
K1 runs on the tensor cores at every dtype and C: bf16 up to C = 256 on
its wgmma kernel (the configs' stems are 256, 128 and 32 wide; C padded
to a multiple of 8, the TMA's), fp32 as 3xTF32 (:func:`split_tf32`) and
bf16 past C = 256 on its register-A kernel, output-tiled (C padded to 16
in fp32, 32 in bf16: a group of two k-steps). K4 runs on the int8 tensor
cores at every dtype and C: bf16 up to C = 256 on
its wgmma kernel, fp32 ``g`` up to C = 256 and either dtype past it on
its output-tiled kernel (both forms of one entry point), C padded to a
multiple of 16 (the int8 weights' TMA strides) in each.

Both are ``torch.library`` custom ops, ``rv3d::meta_kernel_fused`` and
``rv3d::meta_kernel_fused_i8``: the CPU kernel is the plain twin, the
CUDA kernel launches the ctypes entry point (built at its first launch),
and a fake kernel gives the output's shape and dtype, so ``torch.export``
and CUDA-graph capture see one opaque op. The wrappers check their
arguments and call the op.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from range_view_3d_detection_torch.kernels import _build

NUM_NEIGHBORS = 3
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)  # "bf16 or f32", as in JAX


class StemPlan(NamedTuple):
    """How a stem kernel runs one call on the card.

    ``kernel``: ``"wgmma"`` (the bf16 tensor-core entry point, which picks
    its 128- or 256-wide template from C); for K1 ``"tf32x3"`` (fp32 as
    3xTF32) or ``"wgmma_tiled"`` (bf16 past C = 256), the two forms of its
    register-A entry point; for K4 ``"wgmma_fp32"`` (fp32 ``g`` up to C =
    256) or ``"wgmma_tiled"`` (past C = 256, bf16 or fp32 as ``g`` is), the
    two forms of its output-tiled entry point. ``pad``: the zero channels
    the wrapper adds to C by copying the inputs (and crops from the
    output).
    """

    kernel: str
    pad: int


def _check_stem_args(C: int, dtype: torch.dtype, name: str) -> None:
    if C < 1:
        raise ValueError(f"{name}: C={C}")
    if dtype not in COMPUTE_DTYPES:
        raise TypeError(f"{name}: g in {dtype}; the kernel takes bf16 or fp32")


def k1_plan(C: int, dtype: torch.dtype) -> StemPlan:
    """K1's launch for C channels of ``g`` in ``dtype``, all on the tensor
    cores: bf16 up to C = 256 on the wgmma kernel, C padded to a multiple
    of 8 (the TMA's 16-byte strides); fp32 on the register-A kernel as
    3xTF32, C padded to a multiple of 16; bf16 past C = 256 on the
    register-A kernel's output tiles, C padded to a multiple of 32 (16 and
    32: one group of two k-steps, 64 bytes of a pixel row)."""
    _check_stem_args(C, dtype, "meta_kernel_fused")
    if dtype == torch.float32:
        return StemPlan("tf32x3", -C % 16)
    if C <= 256:
        return StemPlan("wgmma", -C % 8)
    return StemPlan("wgmma_tiled", -C % 32)


def k4_plan(C: int, dtype: torch.dtype) -> StemPlan:
    """K4's launch for C channels of ``g`` in ``dtype``, all on the int8
    tensor cores with C padded to a multiple of 16 (the int8 weights' TMA
    strides): bf16 up to C = 256 on the wgmma kernel, fp32 up to C = 256
    on the output-tiled kernel's one-tile form, and either dtype past C =
    256 on its 256-wide output tiles."""
    _check_stem_args(C, dtype, "meta_kernel_fused_i8")
    if C <= 256:
        return StemPlan("wgmma" if dtype == torch.bfloat16 else "wgmma_fp32", -C % 16)
    return StemPlan("wgmma_tiled", -C % 16)


def padded_operands(pad: int, g, feats, w1, k, *vectors) -> tuple:
    """A stem kernel's operands with ``pad`` zero channels past C, as the
    CUDA wrappers launch them: ``g`` and ``feats`` (..., C), the weights
    ``w1`` (C, C) and ``k`` (9, C, C) in both of their last two dims, and
    the per-channel ``vectors`` (affines, kdq) in their last."""
    if not pad:
        return (g, feats, w1, k, *vectors)
    return (F.pad(g, (0, pad)), F.pad(feats, (0, pad)),
            F.pad(w1, (0, pad, 0, pad)), F.pad(k, (0, pad, 0, pad)),
            *(F.pad(v, (0, pad)) for v in vectors))


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` as ``hi + lo``, two TF32 values in fp32 (their 13 low
    mantissa bits zero): ``hi`` is ``x`` rounded to TF32, ``lo`` the
    rounded rest ``x - hi`` (exact in fp32), both to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds (the register-A kernel
    splits its A operand so); ``hi + lo`` is ``x`` within 2^-22 |x|, or
    2^-137 where that is larger (TF32's subnormal step bounds ``lo``). NaN
    stays NaN."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        out = ((bits + 0x1000) & -0x2000).view(torch.float32)
        return torch.where(torch.isnan(v), v, out)

    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def k_order(C: int, elem: int, device=None) -> torch.Tensor:
    """The register-A kernel's order of the k axis: entry ``l`` is the
    channel that logical k ``l`` reads, for C channels of ``elem`` bytes
    (4 in fp32, 2 in bf16). Within each group of 64 bytes (two k-steps),
    A fragment word (step s, half h) of thread t is physical word 4 t + 2 s
    + h, so that a thread's words of both steps are one 16-byte load; it
    is logical word 8 s + 4 h + t (a word holds 4 / elem channels, in
    order)."""
    per_word = 4 // elem
    group = 64 // elem
    idx = torch.arange(C, device=device)
    word, e = (idx % group) // per_word, idx % per_word
    s, h, t = word // 8, (word // 4) % 2, word % 4
    return idx - idx % group + (4 * t + 2 * s + h) * per_word + e


def k1_operands(plan: StemPlan, g, feats, w1, k, a0, b0, a1, b1) -> tuple:
    """What K1's entry point for ``plan`` takes (the output aside), from
    the wrapper's arguments: the operands padded by ``plan.pad``; for
    ``"wgmma"`` ``(g, feats, W1^T, K^T, a0, b0, a1, b1)`` (the weights
    [n][k], K-major for the TMA boxes); for the register-A kernel ``(g,
    feats, w1t, kt, w1t_lo, kt_lo, aff)``: W1^T and K_n^T with their k
    axis in :func:`k_order`, in fp32 split by :func:`split_tf32` into hi
    (``w1t``, ``kt``) and lo parts (None in bf16: the entry takes null
    pointers), and the four affines stacked as ``aff`` (4, C). All
    contiguous, in ``g``'s dtype but the fp32 affines."""
    cdt = g.dtype
    g, feats, w1, k, a0, b0, a1, b1 = padded_operands(
        plan.pad, g, feats.to(cdt), w1.to(cdt), k.to(cdt),
        *(v.float() for v in (a0, b0, a1, b1)))
    g, feats = g.contiguous(), feats.contiguous()
    if plan.kernel == "wgmma":
        return (g, feats, w1.t().contiguous(), k.transpose(1, 2).contiguous(),
                *(v.contiguous() for v in (a0, b0, a1, b1)))
    order = k_order(w1.shape[0], g.element_size(), device=g.device)
    w1t = w1.index_select(0, order).t().contiguous()
    kt = k.index_select(1, order).transpose(1, 2).contiguous()
    if plan.kernel == "tf32x3":
        (w1t, w1t_lo), (kt, kt_lo) = split_tf32(w1t), split_tf32(kt)
    else:
        w1t_lo = kt_lo = None
    return (g, feats, w1t, kt, w1t_lo, kt_lo, torch.stack([a0, b0, a1, b1]))


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

    A CPU tensor takes the plain twin. A CUDA tensor launches the kernel
    that :func:`k1_plan` names (``g`` in bf16 or fp32, any C) or raises.
    ``meta_kernel_fused.launches`` counts the kernel launches.
    """
    if g.device.type == "cuda":
        B, H, W, C = g.shape
        k1_plan(C, g.dtype)
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
    plan = k1_plan(C, g.dtype)
    ops = k1_operands(plan, g, feats, w1, k, a0, b0, a1, b1)
    Cp = C + plan.pad
    out = torch.empty((B, H, W, Cp), dtype=torch.float32, device=g.device)
    lib = _build.library()
    ptrs = (*(0 if t is None else t.data_ptr() for t in ops), out.data_ptr())
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.kernel == "wgmma":
            name = "rv3d_meta_kernel_fused"
            err = lib.rv3d_meta_kernel_fused(*ptrs, B, H, W, Cp, stream)
        else:
            name = "rv3d_meta_kernel_fused_rs"
            err = lib.rv3d_meta_kernel_fused_rs(
                *ptrs, B, H, W, Cp, int(plan.kernel == "tf32x3"), stream)
    _build.check(err, name)
    meta_kernel_fused.launches += 1
    return out[..., :C].contiguous() if plan.pad else out


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

    A CPU tensor takes the plain twin. A CUDA tensor launches the kernel
    that :func:`k4_plan` names (``g`` in bf16 or fp32, int8 weights, any
    C) or raises. Weights stored as transposed views of their [n][k]
    layout (``w1_i8 = w1t.t()``, as ``MetaKernel.quantize_stem`` keeps
    them) pass without a copy. ``meta_kernel_fused_i8.launches`` counts
    the kernel launches.
    """
    if g.device.type == "cuda":
        B, H, W, C = g.shape
        k4_plan(C, g.dtype)
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
    cdt = g.dtype
    plan = k4_plan(C, cdt)
    feats = feats.to(cdt)
    # [n][k]: both kernels' TMA boxes are K-major (s8 wgmma takes K-major
    # A and B).
    g, feats, w1t, kt, a0, b0, a1, b1, kdq = padded_operands(
        plan.pad, g, feats, w1_i8.t(), k_i8.transpose(1, 2),
        *(v.float() for v in (a0, b0, a1, b1, kdq)))
    Cp = C + plan.pad
    g, feats, w1t, kt = (t.contiguous() for t in (g, feats, w1t, kt))
    a0, b0, a1, b1, kdq = (v.contiguous() for v in (a0, b0, a1, b1, kdq))
    out = torch.empty((B, H, W, Cp), dtype=torch.float32, device=g.device)
    lib = _build.library()
    ptrs = (g.data_ptr(), feats.data_ptr(), w1t.data_ptr(), kt.data_ptr(),
            a0.data_ptr(), b0.data_ptr(), a1.data_ptr(), b1.data_ptr(),
            kdq.data_ptr(), out.data_ptr())
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.kernel == "wgmma":
            name = "rv3d_meta_kernel_fused_i8"
            err = lib.rv3d_meta_kernel_fused_i8(*ptrs, B, H, W, Cp, stream)
        else:
            name = "rv3d_meta_kernel_fused_i8_tiles"
            err = lib.rv3d_meta_kernel_fused_i8_tiles(
                *ptrs, B, H, W, Cp, int(cdt == torch.float32),
                int(plan.kernel == "wgmma_tiled"), stream)
    _build.check(err, name)
    meta_kernel_fused_i8.launches += 1
    return out[..., :C].contiguous() if plan.pad else out


meta_kernel_fused_i8.launches = 0
