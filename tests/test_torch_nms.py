"""Port parity for rotated IoU and NMS (the plain twin of K2), CPU.

- ``iou_rotated_bev`` against the JAX ``ops.iou``: atol 1e-5.
- The plain scan against the JAX Pallas scan in interpret mode on the
  same IoU matrix: ``keep`` equal, ``merged`` within 1e-5.
- The kernel's phases in torch ops (``nms_scan_bitmask_plain`` and,
  past cap 4096, ``nms_scan_ahead_plain``) against the plain scan and
  the JAX Pallas scan in interpret mode, on edge cases (WEIGHTED and
  HARD, cap 64 and the ragged 100): ``keep`` equal, ``killed_at`` equal
  to the first kept row above the threshold, ``merged`` within 1e-5.
  One case puts infinities and a NaN in the payload: where JAX's dense
  dot product meets 0 x inf the merged value is NaN, and the port's
  must be NaN there too (the same infinity, or NaN, in both).
- The port's batched multi-class NMS against the JAX ``multiclass_nms``
  (lax block scan and Pallas interpret) for WEIGHTED, HARD, duplicated
  boxes (exact ties), a post-NMS cap and cap > n: ``keep`` equal, kept
  cuboids within atol 1e-4 and scores within 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.kernels.nms import (
    nms_scan,
    nms_scan_ahead_plain,
    nms_scan_bitmask_plain,
    nms_scan_plain,
)
from range_view_3d_detection_torch.ops import iou as tiou
from range_view_3d_detection_torch.ops.nms import (
    batched_multiclass_nms,
    multiclass_nms as port_multiclass_nms,
)
from range_view_3d_detection_tpu.kernels.nms_pallas import nms_scan_pallas
from range_view_3d_detection_tpu.ops import iou as jiou
from range_view_3d_detection_tpu.ops.nms import multiclass_nms

torch.set_num_threads(2)


def _random_boxes(n, seed=0, spread=12.0):
    rng = np.random.default_rng(seed)
    boxes = np.stack(
        [
            rng.uniform(-spread, spread, n),
            rng.uniform(-spread, spread, n),
            rng.uniform(-2, 2, n),
            rng.uniform(2, 6, n),
            rng.uniform(1, 3, n),
            rng.uniform(1, 2, n),
            rng.uniform(-np.pi, np.pi, n),
        ],
        axis=-1,
    ).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    cats = rng.integers(0, 3, n).astype(np.int32)
    return boxes, scores, cats


def test_iou_matches_jax():
    boxes, _, _ = _random_boxes(48, seed=1, spread=5.0)
    bev = boxes[:, [0, 1, 3, 4, 6]]
    # Identical and axis-aligned tangent pairs: the half-weight edge rule.
    bev[1] = bev[0]
    bev[2] = [0.0, 0.0, 4.0, 2.0, 0.0]
    bev[3] = [4.0, 0.0, 4.0, 2.0, 0.0]
    want = np.asarray(jiou.iou_rotated_bev(jnp.asarray(bev), jnp.asarray(bev[:30])))
    got = tiou.iou_rotated_bev(torch.from_numpy(bev), torch.from_numpy(bev[:30]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    batched = tiou.iou_rotated_bev(
        torch.from_numpy(np.stack([bev, bev[::-1].copy()])),
        torch.from_numpy(np.stack([bev, bev[::-1].copy()])),
    )
    np.testing.assert_array_equal(batched[0].numpy(), tiou.iou_rotated_bev(
        torch.from_numpy(bev), torch.from_numpy(bev)).numpy())


@pytest.mark.parametrize("merge_threshold", [0.5, 1.01])
def test_plain_scan_matches_pallas_interpret(merge_threshold):
    boxes, scores, _ = _random_boxes(128, seed=4)
    order = np.argsort(-scores, kind="stable")
    boxes, scores = boxes[order], scores[order]
    bev = boxes[:, [0, 1, 3, 4, 6]]
    iou = np.array(jiou.iou_rotated_bev(jnp.asarray(bev), jnp.asarray(bev)))
    valid = scores >= 0.1
    payload = np.concatenate(
        [boxes[:, :6], np.sin(boxes[:, 6:]), np.cos(boxes[:, 6:]), scores[:, None]],
        axis=-1,
    ).astype(np.float32)
    kw = dict(iou_threshold=0.3, merge_threshold=merge_threshold)
    want_keep, want_merged = nms_scan_pallas(
        iou, scores, valid, payload, interpret=True, **kw
    )
    launches = nms_scan.launches
    keep, merged = nms_scan(
        *(torch.from_numpy(a[None]) for a in (iou, scores, valid, payload)), **kw
    )
    assert nms_scan.launches == launches  # CPU: the twin
    assert 0 < int(keep.sum()) < int(valid.sum())  # something was suppressed
    np.testing.assert_array_equal(keep[0].numpy(), np.asarray(want_keep))
    np.testing.assert_allclose(merged[0].numpy(), np.asarray(want_merged), atol=1e-5)
    keep_p, merged_p = nms_scan_plain(
        *(torch.from_numpy(a[None]) for a in (iou, scores, valid, payload)), **kw
    )
    assert torch.equal(keep_p, keep) and torch.equal(merged_p, merged)


def _scan_inputs(case, cap, seed):
    """Two images of sorted scores, validity, payload and an IoU matrix
    for one edge case of the scan, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    images = []
    for b in range(2):
        boxes, scores, _ = _random_boxes(cap, seed=seed * 10 + b, spread=4.0)
        if case == "duplicated":  # each box twice, same score: exact ties
            half = cap // 2
            boxes[half:] = boxes[: cap - half]
            scores[half:] = scores[: cap - half]
        order = np.argsort(-scores, kind="stable")
        boxes, scores = boxes[order], scores[order]
        bev = boxes[:, [0, 1, 3, 4, 6]]
        iou = np.array(jiou.iou_rotated_bev(jnp.asarray(bev), jnp.asarray(bev)))
        valid = scores >= 0.1
        if case == "zero_diagonal":
            # Boxes that never kill (themselves included), as the class
            # offset's fp32 fragility makes them: kept, they stay alive
            # and join later clusters.
            idx = rng.choice(cap - 1, cap // 4, replace=False)
            iou[idx, idx] = 0.0
            for j in idx[: cap // 8]:
                iou[j] = 0.0
                iou[rng.integers(j + 1, cap), j] = 0.8
        elif case == "asymmetric":  # the diagonal too, zeros included
            iou = rng.uniform(0.0, 1.0, (cap, cap)).astype(np.float32)
            iou *= rng.uniform(size=(cap, cap)) < 0.08
        elif case == "invalid_middle":
            valid[cap // 4 : cap // 2] = False
            valid[rng.choice(cap, cap // 8, replace=False)] = False
        elif case == "all_suppressed":
            iou = np.ones((cap, cap), np.float32)
        payload = np.concatenate(
            [boxes[:, :6], np.sin(boxes[:, 6:]), np.cos(boxes[:, 6:]), scores[:, None]],
            axis=-1,
        ).astype(np.float32)
        if case == "nonfinite_payload":
            # As a model a step from random weights decodes box sizes:
            # column 3 +inf at the first box alone, column 4 at a quarter
            # of the boxes, column 0 -inf and +inf at boxes 1 and 2, and
            # one NaN in column 6.
            payload[0, 3] = np.inf
            payload[rng.choice(cap, cap // 4, replace=False), 4] = np.inf
            payload[1, 0], payload[2, 0] = -np.inf, np.inf
            payload[rng.integers(cap), 6] = np.nan
        images.append((iou, scores, valid, payload))
    return [np.stack(a) for a in zip(*images)]


def _first_killer(iou, valid, keep, threshold):
    """killed_at as defined: the first kept row whose IoU with box j
    exceeds the threshold, ``cap`` if none or if j is invalid."""
    cap = len(valid)
    out = np.full(cap, cap)
    for j in np.flatnonzero(valid):
        rows = np.flatnonzero(keep & (iou[:, j] > threshold))
        if len(rows):
            out[j] = rows[0]
    return out


SCAN_CASES = ["random", "zero_diagonal", "asymmetric", "invalid_middle",
              "all_suppressed", "duplicated", "nonfinite_payload"]


@pytest.mark.parametrize("cap", [64, 100])
@pytest.mark.parametrize("merge_threshold", [0.5, 1.01], ids=["weighted", "hard"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_bitmask_decomposition_matches_scan(case, merge_threshold, cap):
    arrays = _scan_inputs(case, cap, seed=SCAN_CASES.index(case) + 20)
    iou, scores, valid, payload = arrays
    kw = dict(iou_threshold=0.3, merge_threshold=merge_threshold)
    keep, merged, killed_at = nms_scan_bitmask_plain(
        *(torch.from_numpy(a) for a in arrays), **kw
    )
    keep_p, merged_p = nms_scan_plain(*(torch.from_numpy(a) for a in arrays), **kw)
    keep_a, merged_a, killed_a = nms_scan_ahead_plain(
        *(torch.from_numpy(a) for a in arrays), **kw
    )
    assert torch.equal(keep, keep_p) and torch.equal(keep_a, keep)
    assert torch.equal(killed_a, killed_at)
    # assert_allclose holds infinities equal and NaNs equal (equal_nan).
    np.testing.assert_allclose(merged.numpy(), merged_p.numpy(), atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(merged_a.numpy(), merged_p.numpy(), atol=1e-5, equal_nan=True)
    for b in range(2):
        want_keep, want_merged = nms_scan_pallas(
            iou[b], scores[b], valid[b], payload[b], interpret=True, **kw
        )
        want_merged = np.asarray(want_merged)
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(want_keep))
        for got in (merged, merged_p, merged_a):
            np.testing.assert_allclose(got[b].numpy(), want_merged, atol=1e-5, equal_nan=True)
        if case == "nonfinite_payload":
            # JAX's dense sum meets 0 x inf in every kept row of columns 0,
            # 3, 4 and 6, and sums the infinity itself only at box 0's row.
            kept = np.asarray(want_keep)
            assert np.isnan(want_merged[kept][:, [0, 4, 6]]).all()
            assert np.isnan(want_merged[kept][1:, 3]).all()
            assert want_merged[0, 3] == np.inf and kept[0]
        k = keep[b].numpy()
        np.testing.assert_array_equal(
            killed_at[b].numpy(), _first_killer(iou[b], valid[b], k, 0.3)
        )
        assert (k == (valid[b] & (killed_at[b].numpy() >= np.arange(cap)))).all()
    n_keep = int(keep.sum())
    if case == "all_suppressed":
        assert n_keep == 2  # the first valid box of each image
    else:
        assert 0 < n_keep < int(valid.sum())  # something was suppressed


def _duplicated(n, seed):
    """Each box twice, with the same score: exact ties in the sort and in
    the weighted merge. One category: the class-offset grid moves
    category k >= 1 to 2000 m multiples, where fp32 spacing (~2.4e-4 m)
    exceeds the IoU clipping tolerance (1e-4 m) and the self-IoU of a
    duplicate pair is ulp-sensitive in both packages (ROADMAP Queue 3)."""
    boxes, scores, _ = _random_boxes(n // 2, seed=seed)
    return (
        np.concatenate([boxes, boxes]),
        np.concatenate([scores, scores]),
        np.zeros(n, np.int32),
    )


NMS_CASES = {
    "weighted": (lambda s: _random_boxes(128, seed=s), dict(cap=128, block=32)),
    "hard": (lambda s: _random_boxes(64, seed=s), dict(cap=64, block=16, mode="HARD")),
    "duplicated_ties": (lambda s: _duplicated(96, s), dict(cap=96, block=32)),
    "post_nms_cap": (
        lambda s: _random_boxes(128, seed=s), dict(cap=128, block=32, num_post_nms=10)
    ),
    "cap_above_n": (lambda s: _random_boxes(100, seed=s), dict(cap=128, block=64)),
}


@pytest.mark.parametrize("backend", ["lax", "pallas_interpret"])
@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_multiclass_nms_matches_jax(case, backend):
    make, kw = NMS_CASES[case]
    images = [make(seed) for seed in (9, 10)]
    got = batched_multiclass_nms(
        *(torch.from_numpy(np.stack(a)) for a in zip(*images)),
        iou_threshold=0.3, min_confidence=0.1, **kw,
    )
    for b, (boxes, scores, cats) in enumerate(images):
        ref = multiclass_nms(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cats),
            backend=backend, iou_threshold=0.3, min_confidence=0.1, **kw,
        )
        keep = np.asarray(ref.keep)
        np.testing.assert_array_equal(got.keep[b].numpy(), keep)
        np.testing.assert_array_equal(
            got.categories[b].numpy(), np.asarray(ref.categories)
        )
        np.testing.assert_allclose(
            got.cuboids[b].numpy()[keep], np.asarray(ref.cuboids)[keep], atol=1e-4
        )
        np.testing.assert_allclose(
            got.scores[b].numpy()[keep], np.asarray(ref.scores)[keep], atol=1e-5
        )
        if kw.get("num_post_nms"):
            assert keep.sum() == kw["num_post_nms"]
    single = port_multiclass_nms(
        *(torch.from_numpy(a) for a in images[1]),
        iou_threshold=0.3, min_confidence=0.1, **kw,
    )
    for got_b, single_b in zip(got, single):
        assert torch.equal(got_b[1], single_b)
