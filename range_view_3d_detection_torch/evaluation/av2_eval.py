"""AV2-protocol 3D detection metrics, dependency-free numpy (the port's
copy of the JAX ``evaluation/av2_eval.py``, reading shards with the
port's ``utils/feather.py``).

The reference delegates AV2 evaluation to the external ``av2`` package
(``nn/arch/detector.py:19,472``; config via ``datasets/__init__.py:15-47``).
That package is not installable in this image (zero egress), so the
protocol is reimplemented here from the AV2 sensor benchmark definition:

- Assignment (per sweep x category): detections sorted by descending
  score; each detection is assigned its *nearest* ground-truth cuboid by
  3D center distance; each GT is then claimed by the single
  highest-scoring detection assigned to it (the devkit's
  ``np.unique(idx_gts, return_index=True)``, applied ONCE over all
  detections, before thresholding — a GT is claimed even when its winner
  is outside every threshold). At each affinity threshold (0.5, 1.0,
  2.0, 4.0) m a detection is a true positive iff it is its GT's winner
  AND within the threshold; all other detections — duplicates to a
  claimed GT (even closer ones) or whose nearest GT is farther — are
  false positives. NOT greedy bipartite matching.
- AP: interpolated precision (monotone non-increasing envelope) sampled
  on a uniform 100-point recall grid over [0, 1], zero beyond the maximum
  achieved recall; averaged over the four thresholds.
- True-positive errors at the 2.0 m threshold: ATE (center distance),
  ASE (1 - aligned 3D IoU of dims), AOE (wrapped yaw difference in
  [0, pi]). When a category has no true positives the errors take their
  maxima (2.0 m, 1.0, pi).
- CDS = AP * mean(1 - ATE/2.0, 1 - ASE, 1 - AOE/pi).
- GT filtering: range <= 150 m, num_interior_pts > 0, and — when ROI
  evaluation is enabled, as it is for AV2
  (``datasets/__init__.py:27-34``) — only instances inside the mapped
  region of interest. The official devkit rasterizes the log map; this
  image has no map data, so ROI membership is carried as a precomputed
  ``is_within_roi`` column written by the converter and applied to both
  detections and ground truth when present.
- Shard-file entry (``evaluate_predictions``) mirrors the reference's
  ``prepare_for_evaluation`` (``nn/arch/detector.py:547-616``):
  range-filter, sort by descending score, drop exact duplicate rows, and
  inner-join BOTH predictions and GT on the valid-uuid set (sweeps that
  have GT annotations), so sweeps without GT never contribute raw FPs.

Exact numerical parity with the ``av2`` package cannot be certified in
this image (the package cannot be installed to record fixtures); instead
``tests/test_eval_parity.py`` cross-checks this vectorized implementation
against an independently written brute-force oracle of the same protocol.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from range_view_3d_detection_torch.utils.feather import read_feather

AFFINITY_THRESHOLDS_M = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD_M = 2.0
MAX_RANGE_M = 150.0
MAX_NORMALIZED_ATE = 2.0
MAX_NORMALIZED_AOE = np.pi
N_RECALL_SAMPLES = 100


def _quat_to_yaw(qw, qx, qy, qz):
    return np.arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy**2 + qz**2))


def _wrap_pi(a):
    return np.abs(np.arctan2(np.sin(a), np.cos(a)))


def _aligned_scale_iou(dims_a: np.ndarray, dims_b: np.ndarray) -> np.ndarray:
    """3D IoU of dimension-aligned, co-centered boxes."""
    mins = np.minimum(dims_a, dims_b).prod(axis=-1)
    va = dims_a.prod(axis=-1)
    vb = dims_b.prod(axis=-1)
    return mins / np.maximum(va + vb - mins, 1e-8)


def assign_sweep(
    dt_xyz: np.ndarray,
    gt_xyz: np.ndarray,
    thresholds: Sequence[float] = AFFINITY_THRESHOLDS_M,
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-GT assignment with per-GT dedupe (official devkit rule).

    ``dt_xyz`` MUST already be sorted by descending score.

    Returns:
        tp: (N_dt, len(thresholds)) bool.
        gt_idx: (N_dt,) nearest gt index (or -1 when there are no GTs).
    """
    n_dt, n_gt = len(dt_xyz), len(gt_xyz)
    tp = np.zeros((n_dt, len(thresholds)), bool)
    if n_gt == 0 or n_dt == 0:
        return tp, np.full(n_dt, -1, np.int64)
    dist = np.linalg.norm(dt_xyz[:, None] - gt_xyz[None], axis=-1)
    gt_idx = dist.argmin(axis=1)
    near_d = dist[np.arange(n_dt), gt_idx]
    # Devkit rule: the per-GT dedupe happens ONCE over ALL detections
    # (``np.unique(idx_gts, return_index=True)``), BEFORE thresholding —
    # a GT is claimed by its highest-scoring assigned detection even when
    # that detection is outside every threshold, and the closer, lower-
    # scoring duplicates are FPs at every threshold.
    _, winners = np.unique(gt_idx, return_index=True)
    for ti, t in enumerate(thresholds):
        ok = winners[near_d[winners] < t]
        tp[ok, ti] = True
    return tp, gt_idx


def _interp_ap(tp_sorted: np.ndarray, num_gts: int) -> float:
    """Interpolated AP over a uniform recall grid (100 samples over [0,1])."""
    if num_gts == 0 or len(tp_sorted) == 0:
        return 0.0
    cum_tp = np.cumsum(tp_sorted)
    cum_fp = np.cumsum(~tp_sorted)
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    recall = cum_tp / num_gts
    # Monotone non-increasing interpolated precision.
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    grid = np.linspace(0, 1, N_RECALL_SAMPLES)
    interp = np.interp(grid, recall, precision, right=0.0)
    return float(interp.mean())


def _roi_mask(frame: Dict[str, np.ndarray], n: int) -> np.ndarray:
    roi = frame.get("is_within_roi")
    if roi is None:
        return np.ones(n, bool)
    return np.asarray(roi).astype(bool)


def evaluate(
    dts: Dict[str, np.ndarray],
    gts: Dict[str, np.ndarray],
    categories: Sequence[str],
    *,
    max_range_m: float = MAX_RANGE_M,
    eval_only_roi_instances: bool = True,
) -> Dict[str, Dict[str, float]]:
    """Evaluate flat prediction columns against flat GT columns.

    Both dicts carry columns: tx_m ty_m tz_m length_m width_m height_m
    qw qx qy qz category log_id timestamp_ns (+ dts: score,
    gts: num_interior_pts; optionally is_within_roi on either).

    Returns per-category metrics + ``AVERAGE_METRICS``.
    """
    gt_rng = np.linalg.norm(
        np.stack([gts["tx_m"], gts["ty_m"], gts["tz_m"]], -1), axis=-1
    )
    gt_keep = gt_rng <= max_range_m
    if "num_interior_pts" in gts:
        gt_keep &= gts["num_interior_pts"] > 0
    if eval_only_roi_instances:
        gt_keep &= _roi_mask(gts, len(gt_keep))
    gts = {k: np.asarray(v)[gt_keep] for k, v in gts.items()}

    if len(dts.get("tx_m", [])) > 0:
        dt_rng = np.linalg.norm(
            np.stack([dts["tx_m"], dts["ty_m"], dts["tz_m"]], -1), axis=-1
        )
        dt_keep = dt_rng <= max_range_m
        if eval_only_roi_instances:
            dt_keep &= _roi_mask(dts, len(dt_keep))
        dts = {k: np.asarray(v)[dt_keep] for k, v in dts.items()}

    dt_uuid = _uuid_codes(dts)
    gt_uuid = _uuid_codes(gts)
    # Encode sweep uuids to integers ONCE: per-sweep grouping below is
    # argsort + split on codes, not an O(n_sweeps * N) string-equality
    # scan (hours at real val scale).
    uuid_universe = np.unique(np.concatenate([dt_uuid, gt_uuid]))
    dt_code = np.searchsorted(uuid_universe, dt_uuid)
    gt_code = np.searchsorted(uuid_universe, gt_uuid)

    results: Dict[str, Dict[str, float]] = {}
    for cat in categories:
        dm = dts["category"] == cat if len(dt_uuid) else np.zeros(0, bool)
        gm = gts["category"] == cat
        num_gts = int(gm.sum())

        cat_scores: List[np.ndarray] = []
        cat_tp: List[np.ndarray] = []  # (n, n_thresholds) per sweep
        ate_l, ase_l, aoe_l = [], [], []
        tp_col = AFFINITY_THRESHOLDS_M.index(TP_THRESHOLD_M)

        d_groups = _group_by_code(np.flatnonzero(dm), dt_code)
        g_groups = _group_by_code(np.flatnonzero(gm), gt_code)
        for sid in sorted(set(d_groups) | set(g_groups)):
            dsel = d_groups.get(sid, np.zeros(0, np.int64))
            gsel = g_groups.get(sid, np.zeros(0, np.int64))
            scores = dts["score"][dsel]
            # Official rule requires score-descending order within a sweep.
            order = np.argsort(-scores, kind="stable")
            dsel = dsel[order]
            scores = scores[order]
            d_xyz = np.stack(
                [dts["tx_m"][dsel], dts["ty_m"][dsel], dts["tz_m"][dsel]], -1
            )
            g_xyz = np.stack(
                [gts["tx_m"][gsel], gts["ty_m"][gsel], gts["tz_m"][gsel]], -1
            )
            cat_scores.append(scores)
            tp, gi = assign_sweep(d_xyz, g_xyz)
            cat_tp.append(tp)
            mi = tp[:, tp_col]
            if mi.any():
                gi_m = gi[mi]
                gsel_m = gsel[gi_m]
                ate_l.append(
                    np.linalg.norm(d_xyz[mi] - g_xyz[gi_m], axis=-1)
                )
                d_dims = np.stack(
                    [
                        dts["length_m"][dsel][mi],
                        dts["width_m"][dsel][mi],
                        dts["height_m"][dsel][mi],
                    ],
                    -1,
                )
                g_dims = np.stack(
                    [
                        gts["length_m"][gsel_m],
                        gts["width_m"][gsel_m],
                        gts["height_m"][gsel_m],
                    ],
                    -1,
                )
                ase_l.append(1.0 - _aligned_scale_iou(d_dims, g_dims))
                d_yaw = _quat_to_yaw(
                    dts["qw"][dsel][mi],
                    dts["qx"][dsel][mi],
                    dts["qy"][dsel][mi],
                    dts["qz"][dsel][mi],
                )
                g_yaw = _quat_to_yaw(
                    gts["qw"][gsel_m],
                    gts["qx"][gsel_m],
                    gts["qy"][gsel_m],
                    gts["qz"][gsel_m],
                )
                aoe_l.append(_wrap_pi(d_yaw - g_yaw))

        if cat_scores:
            all_scores = np.concatenate(cat_scores)
            all_tp = np.concatenate(cat_tp, axis=0) if cat_tp else np.zeros(
                (0, len(AFFINITY_THRESHOLDS_M)), bool
            )
            order = np.argsort(-all_scores, kind="stable")
            aps = [
                _interp_ap(all_tp[order, ti], num_gts)
                for ti in range(len(AFFINITY_THRESHOLDS_M))
            ]
            ap = float(np.mean(aps))
        else:
            ap = 0.0

        ate = float(np.concatenate(ate_l).mean()) if ate_l else MAX_NORMALIZED_ATE
        ase = float(np.concatenate(ase_l).mean()) if ase_l else 1.0
        aoe = float(np.concatenate(aoe_l).mean()) if aoe_l else MAX_NORMALIZED_AOE

        cds = ap * float(
            np.mean(
                [
                    1.0 - min(ate / MAX_NORMALIZED_ATE, 1.0),
                    1.0 - min(ase, 1.0),
                    1.0 - min(aoe / MAX_NORMALIZED_AOE, 1.0),
                ]
            )
        )
        results[cat] = {
            "AP": ap,
            "ATE": ate,
            "ASE": ase,
            "AOE": aoe,
            "CDS": cds,
            "num_gts": float(num_gts),
        }

    present = [c for c in categories if results[c]["num_gts"] > 0]
    avg = {
        k: float(np.mean([results[c][k] for c in present])) if present else 0.0
        for k in ("AP", "ATE", "ASE", "AOE", "CDS")
    }
    results["AVERAGE_METRICS"] = avg
    return results


def _group_by_code(
    idx: np.ndarray, codes: np.ndarray
) -> Dict[int, np.ndarray]:
    """{code: row indices} for the selected rows, via argsort + split."""
    if len(idx) == 0:
        return {}
    sub = codes[idx]
    order = np.argsort(sub, kind="stable")
    sorted_idx = idx[order]
    sorted_codes = sub[order]
    cuts = np.flatnonzero(np.diff(sorted_codes)) + 1
    groups = np.split(sorted_idx, cuts)
    keys = sorted_codes[np.concatenate([[0], cuts])] if len(cuts) else [
        sorted_codes[0]
    ]
    return {int(k): g for k, g in zip(keys, groups)}


def _uuid_codes(frame: Dict[str, np.ndarray]) -> np.ndarray:
    if len(frame.get("log_id", [])) == 0:
        return np.zeros(0, dtype="<U64")
    return np.char.add(
        np.asarray(frame["log_id"], dtype=str),
        np.char.add("_", np.asarray(frame["timestamp_ns"], dtype=str)),
    )


def dedupe_predictions(dts: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Sort by descending score and drop exact duplicate rows.

    Mirrors the reference's ``.sort('score', descending).unique()``
    (``nn/arch/detector.py:576-581``) guarding against shard re-writes
    (e.g. a preempted+resumed validation writing a sweep twice).
    """
    n = len(dts.get("score", []))
    if n == 0:
        return dts
    order = np.argsort(-dts["score"], kind="stable")
    dts = {k: np.asarray(v)[order] for k, v in dts.items()}
    keys = np.stack(
        [np.asarray(dts[k], str) for k in sorted(dts)], axis=-1
    )
    row_keys = np.array(["\x1f".join(r) for r in keys])
    _, first = np.unique(row_keys, return_index=True)
    keep = np.zeros(n, bool)
    keep[first] = True
    return {k: v[keep] for k, v in dts.items()}


def _join_valid_uuids(
    dts: Dict[str, np.ndarray], gts: Dict[str, np.ndarray]
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Keep only rows whose (log_id, timestamp_ns) appear in the GT set.

    Reference: ``valid_uuids = gts.select(UUID_COLUMNS).unique()`` then
    inner-join on both frames (``nn/arch/detector.py:607-614``). The GT
    side of that join is an identity here (the valid set is derived from
    the GT itself — the reference's extra metadata join is what could
    shrink it there), so only predictions are filtered.
    """
    valid = np.unique(_uuid_codes(gts))
    dt_keep = np.isin(_uuid_codes(dts), valid)
    return ({k: np.asarray(v)[dt_keep] for k, v in dts.items()}, gts)


def annotate_detection_roi(
    dts: Dict[str, np.ndarray], split_dir: Path
) -> Dict[str, np.ndarray]:
    """Add ``is_within_roi`` to predictions from the converted logs' maps.

    The official devkit filters *both* detections and ground truth to the
    mapped ROI (``compute_objects_in_roi_mask``); GT flags are written by
    the converter, detection flags are computed here at eval time:
    det centers go ego -> city via the log's pose track, then query the
    same rasterized drivable-area+5m ROI. Logs without a map dir keep
    all detections (flag True).
    """
    n = len(dts.get("tx_m", []))
    if n == 0:
        return dts
    from range_view_3d_detection_torch.evaluation.roi import (
        load_roi_map,
        slerp_poses,
    )

    flags = np.ones(n, bool)
    log_ids = np.asarray(dts["log_id"], str)
    for log_id in np.unique(log_ids):
        log_dir = Path(split_dir) / str(log_id)
        roi_map = load_roi_map(log_dir)
        pose_path = log_dir / "city_SE3_egovehicle.feather"
        if roi_map is None or not pose_path.is_file():
            continue
        poses = read_feather(pose_path)
        sel = np.flatnonzero(log_ids == log_id)
        ts = np.asarray(dts["timestamp_ns"])[sel].astype(np.int64)
        city_from_ego = slerp_poses(poses, ts)
        xy_ego = np.stack(
            [np.asarray(dts["tx_m"])[sel], np.asarray(dts["ty_m"])[sel]], -1
        )
        xy_city = (
            np.einsum("nij,nj->ni", city_from_ego[:, :2, :2], xy_ego)
            + city_from_ego[:, :2, 3]
        )
        flags[sel] = roi_map.contains(xy_city)
    out = dict(dts)
    out["is_within_roi"] = flags
    return out


def load_ground_truth(split_dir: Path) -> Dict[str, np.ndarray]:
    """Load and concatenate all logs' annotations with log_id columns."""
    cols: Dict[str, List[np.ndarray]] = {}
    for log_path in sorted(Path(split_dir).glob("*")):
        ann_path = log_path / "annotations.feather"
        if not ann_path.is_file():
            continue
        ann = read_feather(ann_path)
        n = len(ann["timestamp_ns"])
        ann["log_id"] = np.asarray([log_path.stem] * n)
        for k, v in ann.items():
            cols.setdefault(k, []).append(v)
    return {k: np.concatenate(v) for k, v in cols.items()}


def load_predictions(pred_dir: Path) -> Dict[str, np.ndarray]:
    cols: Dict[str, List[np.ndarray]] = {}
    for shard in sorted(Path(pred_dir).glob("*.feather")):
        data = read_feather(shard)
        for k, v in data.items():
            cols.setdefault(k, []).append(v)
    if not cols:
        return {}
    return {k: np.concatenate(v) for k, v in cols.items()}


def evaluate_predictions(
    pred_dir: Path,
    gt_split_dir: Path,
    categories: Sequence[str],
    *,
    max_range_m: float = MAX_RANGE_M,
    eval_only_roi_instances: bool = True,
    dataset_name: str = "av2",
) -> Dict[str, Dict[str, float]]:
    """Shard-file evaluation entry (``on_validation_end`` flow,
    detector.py:407-535): dedupe predictions, restrict both sides to the
    valid-uuid set, then run the dataset's protocol — AV2 center-distance
    metrics, or the WOD evaluator for ``waymo`` (the reference dispatches
    the same way, detector.py:457-535)."""
    dts = load_predictions(pred_dir)
    gts = load_ground_truth(gt_split_dir)
    if not dts:
        dts = {
            k: np.zeros(0)
            for k in (
                "tx_m",
                "ty_m",
                "tz_m",
                "length_m",
                "width_m",
                "height_m",
                "qw",
                "qx",
                "qy",
                "qz",
                "score",
            )
        }
        dts["category"] = np.zeros(0, dtype=str)
        dts["log_id"] = np.zeros(0, dtype=str)
        dts["timestamp_ns"] = np.zeros(0, np.int64)
    dts = dedupe_predictions(dts)
    dts, gts = _join_valid_uuids(dts, gts)
    if dataset_name == "waymo":
        from range_view_3d_detection_torch.evaluation.waymo_eval import (
            evaluate_waymo,
            mean_ap,
        )

        results = evaluate_waymo(dts, gts, categories)
        # Nest per-category so callers can iterate uniformly.
        out: Dict[str, Dict[str, float]] = {}
        for key, v in results.items():
            cat, rest = key.split("/", 1)
            out.setdefault(cat, {})[rest] = v
        out["AVERAGE_METRICS"] = {
            "mAP_L1": mean_ap(results, level=1),
            "mAP_L2": mean_ap(results, level=2),
        }
        return out
    if eval_only_roi_instances:
        dts = annotate_detection_roi(dts, gt_split_dir)
    return evaluate(
        dts,
        gts,
        categories,
        max_range_m=max_range_m,
        eval_only_roi_instances=eval_only_roi_instances,
    )
