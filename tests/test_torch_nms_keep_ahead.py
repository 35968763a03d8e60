"""K2's path past cap 4096 on the CPU: the lookahead keep, the
``killed_at`` pass and the merge on ``killed_at``
(``kernels/nms.py::nms_scan_ahead_plain``, the plain mirror of
``csrc/nms_scan.cu``'s ``nms_keep_ahead_kernel``, ``nms_killed_at_kernel``
and the merge's ``killed_at`` instances).

- The mirror against ``nms_scan_bitmask_plain`` (``keep`` and
  ``killed_at`` equal) and ``nms_scan_plain`` (``merged`` within 1e-5,
  the tolerance of ``test_torch_nms.py``): at caps 4097 (B=1) and 4160
  (B=2), and at small caps (37 and 100 off a multiple of 32, 64 on one)
  with ``REGISTER_CAP`` lowered so that the plan takes the new path; on
  an image whose every box is invalid, duplicated boxes with equal
  scores, and (cap 100) slabs whose rows are all removed; WEIGHTED and
  HARD.
- The mirror against the JAX Pallas scan in interpret mode on the same
  IoU matrix, and the port's whole NMS on the new path (the plan and the
  CPU op patched onto the mirror) against the JAX ``multiclass_nms`` on
  its lax backend at cap 256, WEIGHTED (HARD is held above): ``keep``
  equal, kept cuboids within 1e-4, scores within 1e-5.
- The plan and the scratch: ``"ahead"`` past 4096, the mask's rows,
  ``killed_at`` (B, cap) in place of ``seen`` (B, cap, W), the wrapper at
  caps 9216 and 16384 on meta tensors, and the test-only launch helper's
  refusal of CPU tensors.

IoU matrices are those of random intervals on a line (numpy, a few
milliseconds at cap 4160), so the file stays within seconds.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.kernels import nms as knms
from range_view_3d_detection_torch.ops import nms as tnms
from range_view_3d_detection_torch.tools import validate_nms
from range_view_3d_detection_tpu.kernels.nms_pallas import nms_scan_pallas
from range_view_3d_detection_tpu.ops.nms import multiclass_nms

torch.set_num_threads(2)

MODES = {"weighted": 0.5, "hard": 1.01}


def _intervals_iou(lo, length):
    """IoU of the intervals [lo, lo + length) (float32, (n, n))."""
    hi = lo + length
    inter = np.clip(np.minimum(hi[:, None], hi[None]) - np.maximum(lo[:, None], lo[None]),
                    0, None)
    return (inter / (length[:, None] + length[None] - inter)).astype(np.float32)


def _case(B, cap, seed, kind="random"):
    """``B`` images of ``cap`` boxes in descending score order: IoU,
    scores, valid, a 9-wide payload (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    images = []
    for b in range(B):
        lo = rng.uniform(0, 0.6 * cap, cap).astype(np.float32)
        length = rng.uniform(1, 3, cap).astype(np.float32)
        scores = rng.uniform(0, 1, cap).astype(np.float32)
        if kind == "duplicated":  # each box twice with the same score: exact ties
            half = cap // 2
            lo[half:], length[half:], scores[half:] = (
                lo[: cap - half], length[: cap - half], scores[: cap - half])
        order = np.argsort(-scores, kind="stable")
        lo, length, scores = lo[order], length[order], scores[order]
        iou = _intervals_iou(lo, length)
        valid = scores >= 0.1
        if kind == "invalid_image" and b == B - 1:
            valid[:] = False
        elif kind == "removed_slab":
            # Row 0 is kept and removes every row of slab 1; slab 2 is
            # invalid; the last slab's rows all overlap its first row.
            valid[0] = True
            iou[0, 32:64] = 0.9
            valid[64:96] = False
            last = (cap - 1) // 32 * 32
            iou[last, last:] = 0.95
        payload = rng.normal(size=(cap, 9)).astype(np.float32)
        images.append((iou, scores, valid, payload))
    return [np.stack(a) for a in zip(*images)]


def _check_against_references(arrays, merge_threshold):
    kw = dict(iou_threshold=0.3, merge_threshold=merge_threshold)
    tensors = [torch.from_numpy(a) for a in arrays]
    keep, merged, killed_at = knms.nms_scan_ahead_plain(*tensors, **kw)
    keep_b, _, killed_b = knms.nms_scan_bitmask_plain(*tensors, **kw)
    keep_p, merged_p = knms.nms_scan_plain(*tensors, **kw)
    assert keep.dtype == torch.bool and killed_at.dtype == torch.int32
    assert torch.equal(keep, keep_b) and torch.equal(keep, keep_p)
    assert torch.equal(killed_at, killed_b)
    np.testing.assert_allclose(merged.numpy(), merged_p.numpy(), atol=1e-5)
    valid = tensors[2]
    cap = valid.shape[1]
    # killed_at's identity: box i is kept iff it is valid and killed at or after i.
    assert torch.equal(keep, valid & (killed_at >= torch.arange(cap)))
    return keep, killed_at


@pytest.mark.parametrize("B,cap,mode", [(1, 4097, "weighted"), (2, 4160, "hard")])
def test_ahead_mirror_past_4096(B, cap, mode):
    assert knms.k2_plan(cap, knms.PAYLOAD).keep == "ahead"
    keep, _ = _check_against_references(_case(B, cap, seed=cap), MODES[mode])
    n = int(keep.sum())
    assert B * cap // 20 < n < B * cap // 2  # clusters were suppressed, most slabs keep rows


SMALL = [(cap, kind) for cap in (37, 64, 100)
         for kind in ("random", "invalid_image", "duplicated")] + [(100, "removed_slab")]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("cap,kind", SMALL)
def test_ahead_mirror_at_small_caps(monkeypatch, cap, kind, mode):
    monkeypatch.setattr(knms, "REGISTER_CAP", 16)
    assert knms.k2_plan(cap, knms.PAYLOAD).keep == "ahead"
    assert knms.scratch_shape(2, cap) == (2, cap)
    arrays = _case(2, cap, seed=cap * 7 + len(kind), kind=kind)
    keep, killed_at = _check_against_references(arrays, MODES[mode])
    if kind == "invalid_image":
        assert not keep[1].any() and (killed_at[1] == cap).all()
    if kind == "removed_slab":
        assert keep[:, 0].all() and not keep[:, 32:96].any()
        last = (cap - 1) // 32 * 32
        assert (keep[:, last + 1:] == 0).all()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ahead_mirror_matches_pallas_interpret(mode):
    iou, scores, valid, payload = _case(2, 100, seed=5)
    kw = dict(iou_threshold=0.3, merge_threshold=MODES[mode])
    keep, merged, _ = knms.nms_scan_ahead_plain(
        *(torch.from_numpy(a) for a in (iou, scores, valid, payload)), **kw)
    for b in range(2):
        want_keep, want_merged = nms_scan_pallas(iou[b], scores[b], valid[b], payload[b],
                                                 interpret=True, **kw)
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(want_keep))
        np.testing.assert_allclose(merged[b].numpy(), np.asarray(want_merged), atol=1e-5)
    assert 0 < int(keep.sum()) < int(valid.sum())


def test_nms_on_the_ahead_path_matches_jax_lax(monkeypatch):
    # The plan past REGISTER_CAP, and the CPU op on the new path's mirror.
    monkeypatch.setattr(knms, "REGISTER_CAP", 64)
    calls = []

    def ahead(iou, scores, valid, payload, **kw):
        calls.append(knms.k2_plan(scores.shape[1], payload.shape[2]).keep)
        return knms.nms_scan_ahead_plain(iou, scores, valid, payload, **kw)[:2]

    monkeypatch.setattr(knms, "nms_scan_plain", ahead)
    images = [validate_nms.random_boxes(300, seed=s, spread=12.0, num_classes=1)
              for s in (3, 4)]
    kw = dict(cap=256, block=64, iou_threshold=0.3, min_confidence=0.1, mode="WEIGHTED")
    got = tnms.batched_multiclass_nms(*(torch.from_numpy(np.stack(a)) for a in zip(*images)),
                                      **kw)
    assert calls == ["ahead"]
    # One image against JAX (each lax call takes seconds); both ran batched.
    for b, (boxes, scores, cats) in enumerate(images[:1]):
        ref = multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cats),
                             backend="lax", **kw)
        keep = np.asarray(ref.keep)
        assert keep.sum() > 10
        np.testing.assert_array_equal(got.keep[b].numpy(), keep)
        np.testing.assert_allclose(got.cuboids[b].numpy()[keep],
                                   np.asarray(ref.cuboids)[keep], atol=1e-4)
        np.testing.assert_allclose(got.scores[b].numpy()[keep],
                                   np.asarray(ref.scores)[keep], atol=1e-5)


def test_plan_and_scratch_past_4096():
    assert knms.k2_plan(4096, knms.PAYLOAD) == ("register", "p9")
    assert knms.k2_plan(4097, 5) == ("ahead", "passes")
    assert knms.mask_shape(2, 4160) == (2, 4160, 132)
    assert knms.scratch_shape(2, 4096) == (2, 4096, 128)
    assert knms.scratch_shape(2, 4097) == (2, 4097)
    assert knms.scratch_shape(1, 16384) == (1, 16384)
    for B, cap in ((2, 9216), (1, 16384)):
        keep, merged = knms.nms_scan(
            torch.empty(B, cap, cap, device="meta"), torch.empty(B, cap, device="meta"),
            torch.empty(B, cap, dtype=torch.bool, device="meta"),
            torch.empty(B, cap, 9, device="meta"), iou_threshold=0.3, merge_threshold=0.5)
        assert keep.shape == (B, cap) and merged.shape == (B, cap, 9)
    with pytest.raises(ValueError, match="CUDA"):
        knms.nms_scan_with_scratch(*(torch.from_numpy(a) for a in _case(1, 40, seed=1)),
                                   iou_threshold=0.3, merge_threshold=0.5)


def test_kernel_source_names_the_new_path():
    src = (knms._build.CSRC / "nms_scan.cu").read_text()
    assert "nms_keep_big_kernel" not in src
    for name in ("nms_keep_ahead_kernel", "nms_killed_at_kernel", "__reduce_or_sync",
                 "tma_load_2d", "cuTensorMapEncodeTiled"):
        assert name in src
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kKillRows"]) == knms.KILL_ROWS
    assert int(consts["kRegCap"]) == knms.REGISTER_CAP
