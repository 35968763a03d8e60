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
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
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
