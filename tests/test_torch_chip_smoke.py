"""Parts of ``chip_smoke.py`` that run without a card.

- The zero-spill gate reads ptxas's report of every K1 instance. K1 is a
  template (a 128- and a 256-wide instance), so the gate must see each
  instance's spill line, and fail when the kernel is not in the report at
  all (a build whose log was lost would otherwise pass unchecked).
- The edge-case IoU matrices on which it holds K2 against its twin have
  the property each is named for, and the kernel's decomposition
  (``nms_scan_bitmask_plain``) agrees with the plain scan on them, at
  cap 100 and at caps that are not a multiple of 4; its misaligned copies
  start 4 bytes past a 16-byte boundary.
- The K4 edge case (``k4_edge_case``) binds what it is named for: ``hq``
  saturates at 127, ``pq`` clamps at +127 and -127, and both ``rint``
  steps meet .5 ties that round down and up; on it K4's plain twin equals
  the JAX Pallas kernel in interpret mode bit for bit, so the card's check
  of K4 against the twin rests on a case known to be right.
- The BN epilogue's fused multiply-add reference (``check_addcmul_fma``)
  accepts a fused ``addcmul`` and refuses a multiply and an add rounded
  apart.
- The training phases' batch (``flagship_train_batch``) has what it is
  named for, and the card-against-CPU step check (``train_card_vs_cpu``)
  passes when both sides are the CPU (tiny config).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from range_view_3d_detection_torch.kernels.stem import meta_kernel_fused_i8_plain
from range_view_3d_detection_tpu.kernels.stem_pallas import meta_kernel_fused_i8
from range_view_3d_detection_torch.kernels.nms import (
    nms_scan_bitmask_plain,
    nms_scan_plain,
)

LOG = """\
ptxas info    : Compiling entry function '_Z7k3_convv' for 'sm_90a'
ptxas info    : Function properties for _Z7k3_convv
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Function properties for _ZN4_GN_23meta_kernel_fused_wgmmaILi256EEEvii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
ptxas info    : Function properties for _ZN4_GN_23meta_kernel_fused_wgmmaILi128EEEvii
    32 bytes stack frame, 32 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
"""


def test_ptxas_spills_reads_every_instance():
    got = chip_smoke.ptxas_spills(LOG, "meta_kernel_fused_wgmma")
    assert got == {
        "_ZN4_GN_23meta_kernel_fused_wgmmaILi256EEEvii": 0,
        "_ZN4_GN_23meta_kernel_fused_wgmmaILi128EEEvii": 80,
    }


def test_ptxas_spills_fails_without_the_kernel():
    with pytest.raises(RuntimeError, match="not in the ptxas log"):
        chip_smoke.ptxas_spills("", "meta_kernel_fused_wgmma")


@pytest.mark.parametrize("case", chip_smoke.NMS_EDGE_CASES)
def test_nms_edge_cases(case):
    gen = torch.Generator().manual_seed(1)
    iou, scores, valid, payload = chip_smoke.nms_edge_case(case, 2, 100, gen, "cpu")
    diag = iou.diagonal(dim1=1, dim2=2)
    if case == "zero_diagonal":
        assert (diag == 0).sum() >= 2 * 25 and (iou.sum(-1) == 0).sum() >= 2 * 12
    elif case == "asymmetric":
        assert not torch.equal(iou, iou.transpose(1, 2))
    elif case == "invalid_middle":
        assert not valid[:, 25:50].any()
    elif case == "all_suppressed":
        assert (iou == 1).all()
    elif case == "duplicated":
        assert (scores[:, 1:] == scores[:, :-1]).sum() >= 2 * 40
    _decomposition_matches_plain(iou, scores, valid, payload)


def _decomposition_matches_plain(*inputs):
    for merge in (0.5, 1.01):
        kw = dict(iou_threshold=0.3, merge_threshold=merge)
        keep, merged, _ = nms_scan_bitmask_plain(*inputs, **kw)
        keep_p, merged_p = nms_scan_plain(*inputs, **kw)
        assert torch.equal(keep, keep_p)
        torch.testing.assert_close(merged, merged_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", chip_smoke.NMS_EDGE_CASES)
def test_nms_edge_cases_cap_37(case):
    """The edge cases at a cap that is not a multiple of 4, which phase 4
    holds on the card's scalar kernel instances."""
    gen = torch.Generator().manual_seed(2)
    _decomposition_matches_plain(*chip_smoke.nms_edge_case(case, 2, 37, gen, "cpu"))


@pytest.mark.parametrize("cap", [1, 37])
def test_nms_case_ragged_caps(cap):
    gen = torch.Generator().manual_seed(3)
    _decomposition_matches_plain(*chip_smoke.nms_case(3, cap, gen, "cpu"))


def test_misaligned_copy():
    t = torch.arange(24.0).view(2, 3, 4)
    got = chip_smoke.misaligned(t)
    assert torch.equal(got, t) and got.is_contiguous()
    assert got.data_ptr() % 16 == 4


def _k4_before_rounding(x):
    """Per neighbour, what the twin rounds: ``h = x0 a0 + b0`` (hq's rint
    and clamp) and ``p * fs`` (pq's)."""
    g, feats = x["g"], x["feats"]
    H, W = g.shape[1:3]
    gp = torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1))
    fp = torch.nn.functional.pad(feats, (0, 0, 1, 1, 1, 1))
    hs, pfs = [], []
    for dy in range(3):
        for dx in range(3):
            x0 = (gp[:, dy : dy + H, dx : dx + W] - g).float()
            h = x0 * x["a0"] + x["b0"]
            hq = torch.clamp(torch.round(torch.relu(h)), max=127.0)
            z = (hq.double() @ x["w1_i8"].double()).float()
            p = torch.relu(z * x["a1"] + x["b1"])
            hs.append(h)
            pfs.append(p * fp[:, dy : dy + H, dx : dx + W].float())
    return torch.stack(hs), torch.stack(pfs)


@pytest.mark.parametrize("shape", [(1, 4, 37, 32), (2, 3, 20, 64)])
def test_k4_edge_case_twin_equals_pallas_interpret(shape):
    gen = torch.Generator().manual_seed(4)
    x = chip_smoke.k4_edge_case(*shape, gen, "cpu")
    h, pf = _k4_before_rounding(x)
    half = lambda v: v - v.floor() == 0.5  # noqa: E731
    assert (h > 127).any()  # hq saturates
    tie_h = half(h) & (h > 0) & (h < 127)
    assert (tie_h & (h.floor() % 2 == 0)).any() and (tie_h & (h.floor() % 2 == 1)).any()
    assert (pf > 127).any() and (pf < -127).any()  # pq clamps both ways
    tie_p = half(pf) & (pf.abs() < 127)
    assert (tie_p & (pf.floor() % 2 == 0)).any() and (tie_p & (pf.floor() % 2 == 1)).any()
    jx = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) if v.dtype == torch.bfloat16
          else jnp.asarray(v.numpy()) for k, v in x.items()}
    want = np.asarray(meta_kernel_fused_i8(**jx, interpret=True))
    got = meta_kernel_fused_i8_plain(**x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_addcmul_fma_reference(monkeypatch):
    gen = torch.Generator().manual_seed(5)
    chip_smoke.check_addcmul_fma("cpu", gen, n=1 << 16)  # CPU addcmul is fused too
    monkeypatch.setattr(torch, "addcmul", lambda b, d, m: d * m + b)
    with pytest.raises(RuntimeError, match="not one fused multiply-add"):
        chip_smoke.check_addcmul_fma("cpu", gen, n=1 << 16)


def test_flagship_train_batch():
    from range_view_3d_detection_torch import serving

    cfg = serving._flagship_config()
    b = chip_smoke.flagship_train_batch(cfg, 2, 8, 256, seed=3, n_boxes=64)
    assert b["boxes"].shape == (2, 256, 7) and b["box_valid"].sum(-1).tolist() == [64, 64]
    valid = b["boxes"][b["box_valid"]]
    assert (valid[:, 3:6] >= 0.5).all() and (valid[:, 3:6] <= 6.0).all()
    assert (np.abs(valid[:, 6]) <= np.pi).all()
    assert b["box_offset"].min() >= 0 and b["box_offset"].max() < 26
    for i in range(2):  # each centre is the return of a valid pixel
        ctr = b["boxes"][i, :64, None, :3]
        hit = (b["cart"][i][b["mask"][i]][None] == ctr).all(-1).any(-1)
        assert hit.all()


def test_train_card_vs_cpu_on_the_cpu(capsys):
    from range_view_3d_detection_torch import serving

    chip_smoke.train_card_vs_cpu(serving._flagship_config(tiny=True), "cpu")
    assert "train card vs CPU" in capsys.readouterr().out


@pytest.mark.parametrize("stride", [1, 2])
def test_projection_gate_explains_moved_columns(stride):
    """Phase 19's gate: a pixel may differ between two rasterizations only
    where a point changed column. One winning point turned by one column
    changes pixels that the moved set explains, and nothing else does;
    a tanh plane may differ by a few ulps, and only a plane so named."""
    from range_view_3d_detection_torch.data.dataset import AV2_FEATURES, width_padding
    from range_view_3d_detection_torch.export import _sample_points
    from range_view_3d_detection_torch.ops.projection import (
        range_view_coordinates_t,
        rasterize_points,
    )

    H, W = 8, 56
    xyz, laser, inten = _sample_points(1, 600, H, W, seed=5)
    kw = dict(height=H, width=W, feature_names=AV2_FEATURES, x_stride=stride,
              pad=width_padding(W, stride), padding_mode="circular")
    args = [torch.from_numpy(laser), {"intensity": torch.from_numpy(inten)}]
    want = rasterize_points(torch.from_numpy(xyz), *args, **kw)
    row, col, _ = range_view_coordinates_t(torch.from_numpy(xyz[0]),
                                           torch.from_numpy(laser[0]), height=H, width=W)
    gate = dict(feature_names=AV2_FEATURES, pad=kw["pad"], x_stride=stride, width=W)
    a = stride * 2 * np.pi / W  # turned by `stride` columns: still in a kept one
    for i in range(20):  # the first point whose move shows in the image
        moved_xyz = xyz.copy()
        x, y = xyz[0, i, 0], xyz[0, i, 1]
        moved_xyz[0, i, :2] = [x * np.cos(a) - y * np.sin(a), x * np.sin(a) + y * np.cos(a)]
        got = rasterize_points(torch.from_numpy(moved_xyz), *args, **kw)
        _, col2, _ = range_view_coordinates_t(torch.from_numpy(moved_xyz[0]),
                                              torch.from_numpy(laser[0]), height=H,
                                              width=W)
        assert int(col2[i]) != int(col[i])
        moved = {(0, int(row[i]), int(col[i])), (0, int(row[i]), int(col2[i]))}
        n_diff, n_bad = chip_smoke.unexplained_pixels(got, want, moved, ulp_names=(),
                                                      **gate)
        if n_diff:
            break
    assert n_diff > 0 and n_bad == 0
    assert chip_smoke.unexplained_pixels(got, want, set(), ulp_names=(), **gate)[1] > 0
    # A few ulps in the intensity plane pass only where it is named.
    i = AV2_FEATURES.index("intensity")
    nudged = want[0].clone()
    bits = nudged[..., i].contiguous().view(torch.int32)
    nudged[..., i] = torch.where(want[2], bits + chip_smoke.TANH_ULPS, bits).view(
        torch.float32)
    near = (nudged, want[1], want[2])
    assert chip_smoke.unexplained_pixels(near, want, set(), ulp_names=("intensity",),
                                         **gate) == (0, 0)
    assert chip_smoke.unexplained_pixels(near, want, set(), ulp_names=(), **gate)[1] > 0
