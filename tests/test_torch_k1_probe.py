"""``chip_probe_k1.py`` makes its K1 variants by patching the kernel source.

The probe edits the source at fixed anchors (register split, activation
and weight ablations, phase trace) and skips a variant whose anchor the
source does not hold, so the kernel stays free to change. These tests
hold the patches and the skipping on small synthetic sources, not on the
kernel's text.
"""

from __future__ import annotations

import pytest

import chip_probe_k1 as probe

REGS = "constexpr int kProducerRegs = 80;\nconstexpr int kConsumerRegs = 208;\n"
ABLATION_ANCHORS = (
    "if (p < kTileP && w < W && ch_ok) {\n"
    "fs[j][r] = ok && col_ok ? __ldg(x) : 0u;\n"
    "        mbar_arrive_tx(&full[s], kBoxBytes);\n"
)


def test_register_split_patch():
    got = probe.with_regs(REGS, 88, 200)
    assert "constexpr int kProducerRegs = 88;" in got
    assert "constexpr int kConsumerRegs = 200;" in got


@pytest.mark.parametrize("make", [probe.without_activations, probe.weights_once])
def test_ablation_patches_apply(make):
    assert make(ABLATION_ANCHORS) != ABLATION_ANCHORS


def test_variants_without_their_anchors_are_skipped():
    variants, skipped = probe.make_variants(REGS + ABLATION_ANCHORS, regs="88/200",
                                            ablate=True, trace=True)
    assert list(variants) == ["as is", "regs 88/200", "no-act", "w-once"]
    assert variants["as is"] == (REGS + ABLATION_ANCHORS, True)
    assert not variants["no-act"][1] and variants["regs 88/200"][1]
    assert len(skipped) == 1 and skipped[0].startswith("trace: skipped")


def test_patch_refuses_a_missing_anchor():
    with pytest.raises(probe.MissingAnchor, match="anchor found 0 times"):
        probe.patch(REGS, "no such line", "")
