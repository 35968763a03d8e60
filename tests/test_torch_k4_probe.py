"""``chip_probe_k4.py``'s ablations of K4's output-tiled kernel, made by
patching the source at fixed anchors: each applies to a synthetic source
that holds its anchors, and a variant whose anchor is missing is skipped
with a line that says so. Also the probe's timing counts, and that no
dp4a kernel is left for it to time in the source as it is.
"""

from __future__ import annotations

import pytest

import chip_probe_k4 as probe
from range_view_3d_detection_torch.kernels import _build

ANCHORS = (
    "*reinterpret_cast<uint2*>(dst + sw128(p, ch)) = hq8<T>(gc, gs, sa0, sb0);\n"
    "*reinterpret_cast<uint2*>(dst + sw128(p, 8 * cg)) = hq8<T>(gc, gs, sa0, sb0);\n"
    "gc[v] = c_ok ? __ldg(cp + v) : z;\n"
    "gs[v] = s_ok ? __ldg(sp + v) : z;\n"
    "dst[gi][r] = fok[r] && col < C ? Fs::load(q) : Fs::zero();\n"
    "        mbar_arrive_tx(&full[s], bytes);\n"
    "        tma_load_3d(ring + s * L::kSlot, map, &full[s], c0, c1, c2);\n"
)


@pytest.mark.parametrize("name", [n for n, _ in probe.ABLATIONS])
def test_ablation_patches_apply(name):
    make = dict(probe.ABLATIONS)[name]
    assert make(ANCHORS) != ANCHORS


def test_variants_without_their_anchors_are_skipped():
    variants, skipped = probe.make_variants(ANCHORS.replace("Fs::load(q)", "load(q)"), True)
    assert list(variants) == ["no-build", "no-g", "w-once"]
    assert len(skipped) == 1 and skipped[0].startswith("no-fs: skipped")
    assert probe.make_variants(ANCHORS, False) == ({}, [])


@pytest.mark.parametrize("first_ms,counts", [(1.6, (10, 10)), (20.0, (10, 10)),
                                             (20.5, (3, 1)), (2800.0, (3, 1))])
def test_timing_counts_fall_past_20_ms(first_ms, counts):
    assert probe.timing_counts(first_ms) == counts


def test_no_dp4a_kernel_is_left():
    assert "rv3d_meta_kernel_fused_i8_tiled" not in _build.SIGNATURES
    assert "__dp4a" not in probe.SOURCE.read_text()
