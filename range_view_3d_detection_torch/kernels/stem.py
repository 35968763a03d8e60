"""Fused eval MetaKernel stem (K1): CUDA kernel wrapper and its plain twin.

Replaces ``range_view_3d_detection_tpu/kernels/stem_pallas.py::
meta_kernel_fused`` (``_stem_kernel``). The kernel is
``csrc/meta_kernel_fused.cu``; its header says what bounds it on the H100
(the two 256x256 GEMMs per neighbour: compute, 0.55 ms at B=2 and the
flagship 64x1808 image) and how its design follows from that.
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

    A CPU tensor takes the plain twin. A CUDA tensor launches the kernel
    (bf16 ``g``/``feats``, C a multiple of 32 up to 256) or raises.
    ``meta_kernel_fused.launches`` counts the kernel launches.
    """
    if g.device.type == "cpu":
        return meta_kernel_fused_plain(g, feats, w1, k, a0, b0, a1, b1)
    if g.device.type != "cuda":
        raise ValueError(f"meta_kernel_fused: unsupported device {g.device}")
    B, H, W, C = g.shape
    if g.dtype != torch.bfloat16:
        raise TypeError(f"meta_kernel_fused: the kernel takes bf16, got {g.dtype}")
    if C % 32 or C > 256:
        raise ValueError(f"meta_kernel_fused: C={C} must be a multiple of 32, <= 256")
    if feats.shape != g.shape or w1.shape != (C, C) or k.shape != (9, C, C):
        raise ValueError(
            f"meta_kernel_fused: shapes g{tuple(g.shape)} feats"
            f"{tuple(feats.shape)} w1{tuple(w1.shape)} k{tuple(k.shape)}"
        )
    tensors = (g, feats, w1, k, a0, b0, a1, b1)
    if any(t.device != g.device for t in tensors):
        raise ValueError("meta_kernel_fused: inputs on different devices")
    g = g.contiguous()
    feats = feats.to(torch.bfloat16).contiguous()
    # Transposed weights: each mma B fragment is then two 32-bit loads.
    w1t = w1.to(torch.bfloat16).t().contiguous()
    kt = k.to(torch.bfloat16).transpose(1, 2).contiguous()
    a0, b0, a1, b1 = (v.float().contiguous() for v in (a0, b0, a1, b1))
    for v in (a0, b0, a1, b1):
        if v.shape != (C,):
            raise ValueError(f"meta_kernel_fused: affine shape {tuple(v.shape)}")
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
