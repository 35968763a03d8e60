"""Greedy NMS scan (K2): CUDA kernel wrapper and its plain twin.

Replaces ``range_view_3d_detection_tpu/kernels/nms_pallas.py::
nms_scan_pallas`` (``_nms_scan_kernel``). The kernel is
``csrc/nms_scan.cu``; its header says what bounds it on the H100 (the
IoU bytes take 2.5 us at B=2, cap=1024; the greedy keep is a chain of
dependent steps) and how its three phases follow from that: suppression
bitmasks over all SMs, the greedy keep in one warp per image (past cap
4096 in a block per image, the removed set in shared memory), the
weighted merge over all SMs. The plain twin is the JAX package's lax
block scan (``ops/nms.py:177-214``) with the batch dimension written out;
:func:`nms_scan_bitmask_plain` is the kernel's three phases in torch ops,
for the tests.

The scan is the ``torch.library`` custom op ``rv3d::nms_scan``: the plain
twin on the CPU, the three launches on the card (built at the first), a
fake kernel for ``torch.export`` and CUDA-graph capture.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from range_view_3d_detection_torch.kernels import _build

PAYLOAD = 9  # x, y, z, l, w, h, sin(yaw), cos(yaw), score
REGISTER_CAP = 4096  # the largest cap whose removed set the keep warp holds in registers


class NmsPlan(NamedTuple):
    """How K2 runs one call on the card: ``keep`` is ``"register"`` (the
    keep warp, cap <= 4096) or ``"shared"`` (the block keep past it);
    ``merge`` is ``"p9"`` (the box payload's instance) or ``"passes"``
    (any other P, in ``ceil(P / 8)`` passes over each kept row). The
    launch hands both to the entry point, which runs what they name."""

    keep: str
    merge: str


def k2_plan(cap: int, P: int) -> NmsPlan:
    """K2's launch at ``cap`` boxes of a ``P``-wide payload."""
    if cap < 1 or P < 1:
        raise ValueError(f"nms_scan: cap={cap}, P={P}")
    return NmsPlan("register" if cap <= REGISTER_CAP else "shared",
                   "p9" if P == PAYLOAD else "passes")


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


def nms_scan_bitmask_plain(
    iou: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    payload: torch.Tensor,
    *,
    iou_threshold: float,
    merge_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel's three phases in torch ops (for the tests).

    1. Suppression words: bit t of ``mask[b, i, w]`` is
       ``iou[b, i, 32 w + t] > iou_threshold``.
    2. The greedy keep over 32-row slabs: a slab's diagonal word decides
       which of its rows are kept, then each kept row i, in ascending
       order, leaves the removed set it saw (``R_i``, initially
       ``~valid``) in ``seen`` and ORs its words into the set.
    3. The weighted merge of each kept row i over the boxes j alive at
       step i: those not in ``R_i``.

    Returns:
        keep (B, cap) bool, merged (B, cap, P) fp32, and killed_at (B,
        cap) int32, the kept row that removed each box (``cap`` if none or
        if the box is invalid): j not in ``R_i`` is ``valid[j]`` and
        ``killed_at[j] >= i``, which the tests hold it to.
    """
    iou = iou.float()
    scores = scores.float()
    payload = payload.float()
    B, cap = scores.shape
    nwords = (cap + 31) // 32
    pad = nwords * 32 - cap
    weights = 2 ** torch.arange(32, dtype=torch.int64, device=iou.device)

    def words(bits):  # (..., cap) bool -> (..., nwords) int64 of 32 bits
        bits = bits.view(*bits.shape[:-1], nwords, 32).long()
        return (bits * weights).sum(-1)

    mask = words(F.pad(iou > iou_threshold, (0, pad))).tolist()
    removed = words(F.pad(~valid.bool(), (0, pad), value=True)).tolist()
    keep = torch.zeros((B, cap), dtype=torch.bool)
    seen = torch.zeros((B, cap, nwords), dtype=torch.int64)
    killed_at = torch.full((B, cap), cap, dtype=torch.int32)
    for b in range(B):
        rem, m = removed[b], mask[b]
        for s in range(nwords):
            diag, kept = rem[s], []
            for i in range(32 * s, min(32 * s + 32, cap)):
                if not (diag >> (i - 32 * s)) & 1:
                    kept.append(i)
                    diag |= m[i][s]
            for i in kept:
                keep[b, i] = True
                seen[b, i] = torch.tensor(rem)
                for w in range(nwords):
                    fresh = m[i][w] & ~rem[w]
                    rem[w] |= m[i][w]
                    for t in range(32):
                        if (fresh >> t) & 1:
                            killed_at[b, 32 * w + t] = i
    keep, killed_at = keep.to(iou.device), killed_at.to(iou.device)
    shifts = torch.arange(32, dtype=torch.int64)
    in_seen = ((seen[..., None] >> shifts) & 1).view(B, cap, 32 * nwords)[..., :cap]
    alive = in_seen.to(iou.device) == 0
    w = torch.where(alive & (iou >= merge_threshold), scores[:, None, :], 0.0)
    eye = torch.eye(cap, dtype=torch.bool, device=iou.device)
    w = torch.where(eye, torch.maximum(w, scores[:, None, :]), w)
    m = (w @ payload) / w.sum(-1).clamp_min(1e-8)[..., None]
    merged = torch.where(keep[..., None], m, payload)
    return keep, merged, killed_at


def mask_shape(B: int, cap: int) -> Tuple[int, int, int]:
    """The kernel's scratch of suppression words: (B, 32 W, L), W =
    ceil(cap / 32) words a row, L = W up to cap 4096 (the register keep)
    and W rounded up to a multiple of 4 past it (the shared-memory keep
    copies column chunks of rows that start on 16-byte boundaries). The
    kernel takes L from here and refuses one that breaks this rule."""
    nwords = (cap + 31) // 32
    ld = nwords if k2_plan(cap, PAYLOAD).keep == "register" else (nwords + 3) // 4 * 4
    return B, 32 * nwords, ld


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
    kernel's three phases as :func:`k2_plan` says (any B >= 1, any cap,
    any payload width P >= 1) or raises. What bounds the cap is the (B,
    cap, cap) IoU matrix's allocation. ``nms_scan.launches`` counts the
    calls that launch them.
    """
    if iou.device.type == "cuda":
        B, cap = scores.shape
        if (
            iou.shape != (B, cap, cap)
            or valid.shape != (B, cap)
            or payload.dim() != 3
            or payload.shape[:2] != (B, cap)
        ):
            raise ValueError(
                f"nms_scan: shapes iou{tuple(iou.shape)} scores{tuple(scores.shape)}"
                f" valid{tuple(valid.shape)} payload{tuple(payload.shape)}"
            )
        k2_plan(cap, payload.shape[2])
        tensors = (iou, scores, valid, payload)
        if any(t.device != iou.device for t in tensors):
            raise ValueError("nms_scan: inputs on different devices")
    elif iou.device.type not in ("cpu", "meta"):
        raise ValueError(f"nms_scan: unsupported device {iou.device}")
    return torch.ops.rv3d.nms_scan(
        iou, scores, valid, payload, float(iou_threshold), float(merge_threshold)
    )


@torch.library.custom_op("rv3d::nms_scan", mutates_args=(), device_types="cpu")
def _k2_op(
    iou: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, payload: torch.Tensor,
    iou_threshold: float, merge_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return nms_scan_plain(
        iou, scores, valid, payload,
        iou_threshold=iou_threshold, merge_threshold=merge_threshold,
    )


@_k2_op.register_fake
def _(iou, scores, valid, payload, iou_threshold, merge_threshold):
    return (
        valid.new_empty(scores.shape, dtype=torch.bool),
        payload.new_empty(payload.shape, dtype=torch.float32),
    )


@_k2_op.register_kernel("cuda")
def _k2_cuda(iou, scores, valid, payload, iou_threshold, merge_threshold):
    B, cap = scores.shape
    iou = iou.float().contiguous()
    scores = scores.float().contiguous()
    valid = valid.to(torch.bool).contiguous()
    payload = payload.float().contiguous()
    P = payload.shape[2]
    plan = k2_plan(cap, P)
    keep = torch.empty((B, cap), dtype=torch.bool, device=iou.device)
    merged = torch.empty((B, cap, P), dtype=torch.float32, device=iou.device)
    _, rows, ld = mask_shape(B, cap)
    mask = torch.empty((B, rows, ld), dtype=torch.int32, device=iou.device)
    seen = torch.empty((B, cap, rows // 32), dtype=torch.int32, device=iou.device)
    lib = _build.library()
    with torch.cuda.device(iou.device):
        err = lib.rv3d_nms_scan(
            iou.data_ptr(), scores.data_ptr(), valid.data_ptr(),
            payload.data_ptr(), keep.data_ptr(), merged.data_ptr(),
            mask.data_ptr(), seen.data_ptr(),
            B, cap, ld, P, int(plan.keep == "shared"), int(plan.merge == "p9"),
            float(iou_threshold), float(merge_threshold),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rv3d_nms_scan")
    nms_scan.launches += 1
    return keep, merged


nms_scan.launches = 0
