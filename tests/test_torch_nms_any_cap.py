"""NMS at any cap in the port (``ops/nms.py``, ``kernels/nms.py``), and
``tools/validate_nms.py``, on the CPU.

- The row-blocked IoU matrix (``blocked_iou``) equals the whole-matrix
  ``iou_rotated_bev`` bit for bit: row blocks of 64, and of a ragged 37,
  over cap 256 in two images, with categories on the class-offset grid.
- ``iou_matrix`` takes row blocks whose intermediates stay under about
  1 GB (``block_rows``: 455 rows at cap 9216 and B=2, 256 at cap 4096
  and B=8), one block, the whole matrix, at the served cap 1024 and B=2.
- The port's NMS with the blocked matrix (blocks of 48 rows)
  equals the JAX ``multiclass_nms`` on its lax block scan (the path the
  JAX package takes past cap 4096) at cap 256, WEIGHTED and HARD: ``keep``
  equal, kept cuboids within atol 1e-4, scores within 1e-5 (the
  tolerances of ``test_torch_nms.py``), on one category, as that file's
  tie case (the class-offset grid is fp32-fragile in both packages,
  ROADMAP Queue 3).
- The K2 scratch follows the kernel's layout: rows of W words up to cap
  4096, W rounded up to 4 past it; the wrapper no longer refuses a cap
  past 4096 (a meta tensor at cap 9216 reaches the op's fake).
- ``tools.validate_nms``'s proposals are the JAX tool's ``random_boxes``
  draw for draw, and its CLI runs on the CPU (the twin on both sides) and
  exits 0.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.kernels import nms as knms
from range_view_3d_detection_torch.ops import nms as tnms
from range_view_3d_detection_torch.ops.iou import iou_rotated_bev
from range_view_3d_detection_torch.tools import validate_nms
from range_view_3d_detection_tpu.ops.nms import multiclass_nms
from tools import validate_nms_tpu

torch.set_num_threads(2)


def _bev(B, cap, seed=0):
    rng = np.random.default_rng(seed)
    bev = np.concatenate([rng.uniform(-20, 20, (B, cap, 2)), rng.uniform(1, 6, (B, cap, 2)),
                          rng.uniform(-np.pi, np.pi, (B, cap, 1))], -1).astype(np.float32)
    cats = rng.integers(0, 3, (B, cap))
    bev[..., 0] += (cats % 8) * 2000.0
    return torch.from_numpy(bev)


@pytest.mark.parametrize("rows", [64, 37])
def test_blocked_iou_equals_whole_matrix(rows):
    bev = _bev(2, 256)
    whole = iou_rotated_bev(bev, bev)
    blocked = tnms.blocked_iou(bev, rows)
    assert torch.equal(blocked, whole)
    assert int((whole > 0.3).sum()) > 2 * 256  # overlaps beyond the diagonal


def test_iou_matrix_switches_to_row_blocks_past_4096(monkeypatch):
    assert tnms.block_rows(2, 9216) == 455 and tnms.block_rows(1, 16384) == 512
    assert tnms.block_rows(8, 4096) == 256 and tnms.block_rows(2, 1024) >= 1024
    assert 128 * 2 * 9216 * tnms.block_rows(2, 9216) <= 1 << 30
    whole = []
    monkeypatch.setattr(tnms, "iou_rotated_bev", lambda a, b: whole.append(a.shape[1]) or
                        iou_rotated_bev(a, b))
    bev = _bev(1, 64)
    assert torch.equal(tnms.iou_matrix(bev), iou_rotated_bev(bev, bev))
    assert whole == [64]
    monkeypatch.setattr(tnms, "block_rows", lambda B, cap: 24)
    assert torch.equal(tnms.iou_matrix(bev), iou_rotated_bev(bev, bev))
    assert whole == [64, 24, 24, 16]


@pytest.mark.parametrize("mode", ["WEIGHTED", "HARD"])
def test_nms_on_row_blocks_matches_jax_lax(monkeypatch, mode):
    monkeypatch.setattr(tnms, "block_rows", lambda B, cap: 48)
    images = [validate_nms.random_boxes(300, seed=s, spread=12.0, num_classes=1)
              for s in (3, 4)]
    kw = dict(cap=256, block=64, iou_threshold=0.3, min_confidence=0.1, mode=mode)
    inputs = tnms.nms_inputs(*(torch.from_numpy(np.stack(a)) for a in zip(*images)),
                             **{k: kw[k] for k in ("cap", "block", "min_confidence", "mode")})
    bev_rows = inputs.iou.shape[1]
    assert bev_rows == 256
    got = tnms.batched_multiclass_nms(*(torch.from_numpy(np.stack(a)) for a in zip(*images)),
                                      **kw)
    for b, (boxes, scores, cats) in enumerate(images):
        ref = multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cats),
                             backend="lax", **kw)
        keep = np.asarray(ref.keep)
        assert keep.sum() > 10
        np.testing.assert_array_equal(got.keep[b].numpy(), keep)
        np.testing.assert_allclose(got.cuboids[b].numpy()[keep],
                                   np.asarray(ref.cuboids)[keep], atol=1e-4)
        np.testing.assert_allclose(got.scores[b].numpy()[keep],
                                   np.asarray(ref.scores)[keep], atol=1e-5)


def test_k2_scratch_layout_and_no_cap_refusal():
    assert knms.mask_shape(2, 1024) == (2, 1024, 32)
    assert knms.mask_shape(1, 4096) == (1, 4096, 128)
    assert knms.mask_shape(2, 4097) == (2, 4128, 132)
    assert knms.mask_shape(2, 9216) == (2, 9216, 288)
    assert knms.mask_shape(1, 16384) == (1, 16384, 512)
    B, cap = 2, 9216
    keep, merged = knms.nms_scan(
        torch.empty(B, cap, cap, device="meta"), torch.empty(B, cap, device="meta"),
        torch.empty(B, cap, dtype=torch.bool, device="meta"),
        torch.empty(B, cap, 9, device="meta"), iou_threshold=0.3, merge_threshold=0.5)
    assert keep.shape == (B, cap) and merged.shape == (B, cap, 9)


def test_validate_nms_boxes_are_the_jax_tools():
    for n, seed, spread in ((9216, 1024, 60.0), (37, 5, 12.0)):
        got = validate_nms.random_boxes(n, seed, spread)
        want = validate_nms_tpu.random_boxes(n, seed, spread)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_validate_nms_runs_on_the_cpu(capsys):
    assert validate_nms.main(["--caps", "64,128", "--n", "300", "--mode", "HARD",
                              "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["tool"] == "validate_nms" and line["ok"] and line["device"] == "cpu"
    assert [r["cap"] for r in line["rows"]] == [64, 128]
    assert all(r["keep_equal"] and r["kept"] > 0 for r in line["rows"])
