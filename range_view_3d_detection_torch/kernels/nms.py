"""Greedy NMS scan (K2): CUDA kernel wrapper and its plain twin.

Replaces ``range_view_3d_detection_tpu/kernels/nms_pallas.py::
nms_scan_pallas`` (``_nms_scan_kernel``). The kernel is
``csrc/nms_scan.cu``; its header says what bounds it on the H100 (the
IoU bytes take 2.5 us at B=2, cap=1024; the greedy keep is a chain of
dependent steps) and how its phases follow from that: suppression
bitmasks over all SMs, the greedy keep in one warp per image, the
weighted merge over all SMs. Past cap 4096 the keep is a block per image
whose chain warp runs ahead of updater warps fed by TMA, and a pass over
all SMs turns the kept rows into ``killed_at``, which the merge reads in
place of the removed sets (``seen``). The plain twin is the JAX package's
lax block scan (``ops/nms.py:177-214``) with the batch dimension written
out; :func:`nms_scan_bitmask_plain` is the kernel's phases up to cap 4096
in torch ops and :func:`nms_scan_ahead_plain` those past it, for the
tests and the card's checks.

The scan is the ``torch.library`` custom op ``rv3d::nms_scan``: the plain
twin on the CPU, the three launches on the card (built at the first), a
fake kernel for ``torch.export`` and CUDA-graph capture.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from range_view_3d_detection_torch.kernels import _build

PAYLOAD = 9  # x, y, z, l, w, h, sin(yaw), cos(yaw), score
REGISTER_CAP = 4096  # the largest cap whose removed set the keep warp holds in registers
KILL_ROWS = 32  # rows a thread of the killed_at pass scans, a slab (csrc/nms_scan.cu: kKillRows)


class NmsPlan(NamedTuple):
    """How K2 runs one call on the card: ``keep`` is ``"register"`` (the
    keep warp, cap <= 4096, its removed sets in ``seen``) or ``"ahead"``
    (past it: the chain warp ahead of the updaters, then ``killed_at``);
    ``merge`` is ``"p9"`` (the box payload's instance) or ``"passes"``
    (any other P, in ``ceil(P / 8)`` passes over each kept row). The
    launch hands both to the entry point, which runs what they name."""

    keep: str
    merge: str


def k2_plan(cap: int, P: int) -> NmsPlan:
    """K2's launch at ``cap`` boxes of a ``P``-wide payload."""
    if cap < 1 or P < 1:
        raise ValueError(f"nms_scan: cap={cap}, P={P}")
    return NmsPlan("register" if cap <= REGISTER_CAP else "ahead",
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
                    while fresh:
                        t = (fresh & -fresh).bit_length() - 1
                        killed_at[b, 32 * w + t] = i
                        fresh &= fresh - 1
    keep, killed_at = keep.to(iou.device), killed_at.to(iou.device)
    shifts = torch.arange(32, dtype=torch.int64)
    in_seen = ((seen[..., None] >> shifts) & 1).view(B, cap, 32 * nwords)[..., :cap]
    alive = in_seen.to(iou.device) == 0
    return keep, _merge_plain(iou, scores, payload, keep, alive, merge_threshold), killed_at


def _merge_plain(iou, scores, payload, keep, alive, merge_threshold):
    """The merge of each kept row i over the boxes j with ``alive[b, i, j]``
    (not in R_i) and ``iou[b, i, j] >= merge_threshold``, box i weighing at
    least its own score; rows not kept keep their payload. As the kernel
    forms it: sums over the terms of nonzero weight only, their infinite
    and NaN values taken as IEEE sums take them, and NaN in a column where
    the image holds more non-finite values than those terms (the
    reference's dense sum meets 0 x inf there)."""
    w = torch.where(alive & (iou >= merge_threshold), scores[:, None, :], 0.0)
    eye = torch.eye(iou.shape[-1], dtype=torch.bool, device=iou.device)
    w = torch.where(eye, torch.maximum(w, scores[:, None, :]), w)
    finite = torch.isfinite(payload)
    m = (w @ torch.where(finite, payload, 0.0)) / w.sum(-1).clamp_min(1e-8)[..., None]
    member = (w != 0).float()

    def count(flag):  # (B, cap, P): the terms of nonzero weight with ``flag``
        return member @ flag.float()

    nan, pos, neg = count(payload.isnan()), count(payload == math.inf), count(
        payload == -math.inf)
    m = torch.where(pos > 0, math.inf, m)
    m = torch.where(neg > 0, -math.inf, m)
    fewer = (nan + pos + neg) < (~finite).sum(1, keepdim=True)
    m = torch.where((nan > 0) | ((pos > 0) & (neg > 0)) | fewer, math.nan, m)
    return torch.where(keep[..., None], m, payload)


def nms_scan_ahead_plain(
    iou: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    payload: torch.Tensor,
    *,
    iou_threshold: float,
    merge_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's phases past cap 4096 in torch ops (for the tests, and
    the card's check of ``killed_at``); any cap, on any device.

    1. Suppression words, as :func:`nms_scan_bitmask_plain`'s.
    2. The lookahead keep: for slab s the chain reads word s of the
       removed set as the updaters left it (every kept row of slab s - 2
       and before), ORs in slab s - 1's kept rows' words s (the fold),
       and decides the slab's rows in order; the updaters then OR the
       slab's kept rows into the words above s + 1 only.
    3. ``killed_at`` by chunks of ``KILL_ROWS`` rows: each chunk's first
       kept row that sets bit j of valid box j, the least over chunks
       (the kernel's ``atomicMin``), ``cap`` if none or if j is invalid.
    4. The weighted merge of each kept row i over the boxes j with
       ``valid[j]`` and ``killed_at[j] >= i``.

    Returns:
        keep (B, cap) bool, merged (B, cap, P) fp32, killed_at (B, cap)
        int32.
    """
    iou = iou.float()
    scores = scores.float()
    payload = payload.float()
    valid = valid.bool()
    B, cap = scores.shape
    dev = iou.device
    nwords = (cap + 31) // 32
    pad = nwords * 32 - cap
    weights = 2 ** torch.arange(32, dtype=torch.int64, device=dev)
    bits = F.pad(iou > iou_threshold, (0, pad, 0, pad))  # (B, 32 W, 32 W)
    # Slab s's rows' words s (the diagonal) and s + 1 (the fold's).
    row = torch.arange(32 * nwords, device=dev)
    by_word = bits.view(B, 32 * nwords, nwords, 32)
    diag_words = (by_word[:, row, row // 32].long() * weights).sum(-1)
    next_words = (by_word[:, row, (row // 32 + 1).clamp(max=nwords - 1)].long()
                  * weights).sum(-1)
    keep = torch.zeros((B, 32 * nwords), dtype=torch.bool, device=dev)
    for b in range(B):
        removed = F.pad(~valid[b], (0, pad), value=True)  # the updaters' words, as bits
        d_b = diag_words[b].view(nwords, 32).tolist()
        n_b = next_words[b].view(nwords, 32).tolist()
        fold = 0  # slab s - 1's kept rows in word s
        for s in range(nwords):
            diag = int((removed[32 * s:32 * s + 32].long() * weights).sum()) | fold
            kept = []
            for r in range(32):
                if not (diag >> r) & 1:
                    kept.append(r)
                    diag |= d_b[s][r]
            fold = 0
            for r in kept:
                fold |= n_b[s][r]
            if kept:
                rows = torch.tensor(kept, device=dev) + 32 * s
                keep[b, rows] = True
                if s + 2 < nwords:
                    removed[32 * (s + 2):] |= bits[b, rows, 32 * (s + 2):].any(0)
    keep = keep[:, :cap]
    # killed_at: chunks of KILL_ROWS rows, their first hits, the least.
    chunks = -(-cap // KILL_ROWS)
    hit = bits[:, :cap, :cap] & keep[:, :, None] & valid[:, None, :]
    hit = F.pad(hit, (0, 0, 0, chunks * KILL_ROWS - cap)).view(B, chunks, KILL_ROWS, cap)
    first = hit.to(torch.uint8).argmax(2) + torch.arange(
        0, chunks * KILL_ROWS, KILL_ROWS, device=dev)[None, :, None]
    killed_at = torch.where(hit.any(2), first, cap).amin(1).to(torch.int32)
    # The merge on killed_at.
    step = torch.arange(cap, device=dev)
    alive = valid[:, None, :] & (killed_at[:, None, :] >= step[None, :, None])
    return keep, _merge_plain(iou, scores, payload, keep, alive, merge_threshold), killed_at


def mask_shape(B: int, cap: int) -> Tuple[int, int, int]:
    """The kernel's scratch of suppression words: (B, 32 W, L), W =
    ceil(cap / 32) words a row, L = W up to cap 4096 (the register keep)
    and W rounded up to a multiple of 4 past it (the keep past 4096 reads
    rows by TMA, whose row strides are multiples of 16 bytes). The kernel
    takes L from here and refuses one that breaks this rule."""
    nwords = (cap + 31) // 32
    ld = nwords if k2_plan(cap, PAYLOAD).keep == "register" else (nwords + 3) // 4 * 4
    return B, 32 * nwords, ld


def scratch_shape(B: int, cap: int) -> Tuple[int, ...]:
    """The kernel's scratch of removed sets: ``seen`` (B, cap, W), the set
    each kept row saw, up to cap 4096; ``killed_at`` (B, cap) past it."""
    if k2_plan(cap, PAYLOAD).keep == "register":
        return B, cap, (cap + 31) // 32
    return B, cap


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


def _launch(iou, scores, valid, payload, iou_threshold, merge_threshold):
    """The kernel's launches as :func:`k2_plan` says: (keep, merged, the
    removed sets' scratch)."""
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
    scratch = torch.empty(scratch_shape(B, cap), dtype=torch.int32, device=iou.device)
    nonfinite = torch.empty((B, P), dtype=torch.int32, device=iou.device)  # zeroed there
    lib = _build.library()
    with torch.cuda.device(iou.device):
        err = lib.rv3d_nms_scan(
            iou.data_ptr(), scores.data_ptr(), valid.data_ptr(),
            payload.data_ptr(), keep.data_ptr(), merged.data_ptr(),
            mask.data_ptr(), scratch.data_ptr(),
            B, cap, ld, P, int(plan.keep == "ahead"), int(plan.merge == "p9"),
            float(iou_threshold), float(merge_threshold),
            torch.cuda.current_stream().cuda_stream, nonfinite.data_ptr(),
        )
    _build.check(err, "rv3d_nms_scan")
    return keep, merged, scratch


def nms_scan_with_scratch(
    iou: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    payload: torch.Tensor,
    *,
    iou_threshold: float,
    merge_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For the card's checks only: the kernel on CUDA tensors, returning
    keep, merged and its removed sets' scratch (``killed_at`` past cap
    4096, :func:`scratch_shape`). Not counted in ``nms_scan.launches``."""
    if iou.device.type != "cuda":
        raise ValueError(f"nms_scan_with_scratch: needs CUDA tensors, got {iou.device}")
    return _launch(iou, scores, valid, payload, iou_threshold, merge_threshold)


@_k2_op.register_kernel("cuda")
def _k2_cuda(iou, scores, valid, payload, iou_threshold, merge_threshold):
    keep, merged, _ = _launch(iou, scores, valid, payload, iou_threshold, merge_threshold)
    nms_scan.launches += 1
    return keep, merged


nms_scan.launches = 0
