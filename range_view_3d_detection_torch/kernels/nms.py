"""Greedy NMS scan (K2): CUDA kernel wrapper and its plain twin.

Replaces ``range_view_3d_detection_tpu/kernels/nms_pallas.py::
nms_scan_pallas`` (``_nms_scan_kernel``). The kernel is
``csrc/nms_scan.cu``; its header says what bounds it on the H100 (the
chain of ``cap`` dependent steps; the IoU bytes take 2.5 us at B=2,
cap=1024) and how its design follows from that. The plain twin is the
JAX package's lax block scan (``ops/nms.py:177-214``) with the batch
dimension written out.
"""

from __future__ import annotations

from typing import Tuple

import torch

from range_view_3d_detection_torch.kernels import _build

PAYLOAD = 9  # x, y, z, l, w, h, sin(yaw), cos(yaw), score


def nms_scan_plain(
    iou: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    payload: torch.Tensor,
    *,
    iou_threshold: float,
    merge_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the scan, batched.

    Args:
        iou: (B, cap, cap) fp32 rotated IoU in descending score order.
        scores: (B, cap) sorted scores.
        valid: (B, cap) bool.
        payload: (B, cap, P) fp32 merge payload.

    Returns:
        keep (B, cap) bool, merged (B, cap, P) fp32.
    """
    iou = iou.float()
    scores = scores.float()
    payload = payload.float()
    B, cap = scores.shape
    alive = valid.clone()
    keep = torch.zeros_like(valid)
    merged = torch.zeros_like(payload)
    for i in range(cap):
        row = iou[:, i]
        active = alive[:, i]
        w = scores * alive.float() * (row >= merge_threshold).float()
        w[:, i] = torch.maximum(w[:, i], scores[:, i])
        wsum = w.sum(-1).clamp_min(1e-8)
        m = (w[:, :, None] * payload).sum(1) / wsum[:, None]
        keep[:, i] = active
        merged[:, i] = torch.where(active[:, None], m, payload[:, i])
        alive = torch.where(active[:, None], alive & ~(row > iou_threshold), alive)
    return keep, merged


def nms_scan(
    iou: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    payload: torch.Tensor,
    *,
    iou_threshold: float,
    merge_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy (weighted) NMS scan over a precomputed IoU matrix.

    A CPU tensor takes :func:`nms_scan_plain`. A CUDA tensor launches the
    kernel (one block per image, P == 9, cap <= 4096) or raises.
    ``nms_scan.launches`` counts the kernel launches.
    """
    if iou.device.type == "cpu":
        return nms_scan_plain(
            iou, scores, valid, payload,
            iou_threshold=iou_threshold, merge_threshold=merge_threshold,
        )
    if iou.device.type != "cuda":
        raise ValueError(f"nms_scan: unsupported device {iou.device}")
    B, cap = scores.shape
    if (
        iou.shape != (B, cap, cap)
        or valid.shape != (B, cap)
        or payload.shape != (B, cap, PAYLOAD)
    ):
        raise ValueError(
            f"nms_scan: shapes iou{tuple(iou.shape)} scores{tuple(scores.shape)}"
            f" valid{tuple(valid.shape)} payload{tuple(payload.shape)}"
        )
    if cap > 4096:
        raise ValueError(f"nms_scan: cap={cap} > 4096 does not fit shared memory")
    tensors = (iou, scores, valid, payload)
    if any(t.device != iou.device for t in tensors):
        raise ValueError("nms_scan: inputs on different devices")
    iou = iou.float().contiguous()
    scores = scores.float().contiguous()
    valid = valid.to(torch.bool).contiguous()
    payload = payload.float().contiguous()
    keep = torch.empty((B, cap), dtype=torch.bool, device=iou.device)
    merged = torch.empty((B, cap, PAYLOAD), dtype=torch.float32, device=iou.device)
    lib = _build.library()
    with torch.cuda.device(iou.device):
        err = lib.rv3d_nms_scan(
            iou.data_ptr(), scores.data_ptr(), valid.data_ptr(),
            payload.data_ptr(), keep.data_ptr(), merged.data_ptr(),
            B, cap, PAYLOAD, float(iou_threshold), float(merge_threshold),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rv3d_nms_scan")
    nms_scan.launches += 1
    return keep, merged


nms_scan.launches = 0
