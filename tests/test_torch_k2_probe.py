"""``chip_probe_k2.py`` on the CPU: its arguments, its trace patches (every
anchor of the lookahead keep's trace is in ``csrc/nms_scan.cu`` as it is;
the shared-memory keep's, on a synthetic source that holds them), the
trace's slot count and its report on synthetic stamps.
"""

from __future__ import annotations

import numpy as np
import pytest

import chip_probe_k2 as probe

# The anchors of the shared-memory keep that the lookahead keep replaced
# (``nms_keep_big_kernel``), as its source held them.
BIG_ANCHORS = (
    "namespace {\n\nconstexpr int kP = 9;\n"
    "__global__ void nms_keep_big_kernel() {\n"
    "  for (int t = 0; t < kStages - 1; ++t) prefetch(t);\n\n  uint32_t kept = 0;\n"
    "    prefetch(t + kStages - 1);  // refills the buffer step t - 1 left\n"
    "    cp_async_wait<kStages - 1>();\n"
    "    __syncthreads();  // every thread's copies of step t are in; rem is current\n"
    "      __syncthreads();  // rem[s] read by every thread before its owner ORs\n"
    "          const bool take = (kept >> r) & 1u;  // the same in every thread\n"
    "          if (take) seen_w[(size_t)r * nwords] = r_k;\n"
    "    if (j == nchunks - 1 && tid < 32) {\n"
    "    __syncthreads();  // step t's buffer read before it is refilled\n  }\n"
    "  cp_async_wait<0>();\n}\n"
)


def test_arguments():
    args = probe.parse_args([])
    assert (args.cap, args.batch, args.trace, args.reps, args.source) == (9216, 2, False, 10,
                                                                          [])
    args = probe.parse_args(["--cap", "16384", "--batch", "1", "--trace", "--source", "old.cu",
                             "--source", "older.cu", "--reps", "5"])
    assert (args.cap, args.batch, args.trace, args.reps) == (16384, 1, True, 5)
    assert [str(p) for p in args.source] == ["old.cu", "older.cu"]
    for bad in (["--cap", "0"], ["--batch", "-1"], ["--reps", "0"], ["--mode", "HARD"]):
        with pytest.raises(SystemExit):
            probe.parse_args(bad)


def test_every_trace_anchor_is_in_the_kernel_source():
    src = probe.SOURCE.read_text()
    variants, skipped = probe.make_variants(src, True)
    assert skipped == [] and list(variants) == ["as is", "as is, trace"]
    traced, kind = variants["as is, trace"]
    assert kind == "ahead" and variants["as is"] == (src, None)
    # Five chain stamps and four updater stamps a slab, and the ends.
    for k in range(9):
        assert f"K2_AT(8 + {probe.SLOTS} * {'s' if k < 5 else 't'} + {k})" in traced
    assert "rv3d_k2_set_trace" in traced and "K2_AT(4) = clock64()" in traced
    assert probe.make_variants(src, False) == ({"as is": (src, None)}, [])


def test_the_shared_memory_keeps_trace_patches():
    variants, skipped = probe.make_variants(BIG_ANCHORS, True, tag="old.cu")
    assert skipped == []
    assert [(n, k) for n, (_, k) in variants.items()] == [
        ("old.cu", None), ("old.cu, trace", "big"), ("old.cu, trace no-seen", "big")]
    assert "seen_w" in variants["old.cu, trace"][0]
    assert "seen_w" not in variants["old.cu, trace no-seen"][0]
    for k in range(7):
        assert f"K2_AT(8 + {probe.SLOTS} * t + {k})" in variants["old.cu, trace"][0]
    # A variant whose anchor is missing is skipped with a line that says so.
    variants, skipped = probe.make_variants(
        BIG_ANCHORS.replace("tid < 32", "tid < 64"), True, tag="old.cu")
    assert list(variants) == ["old.cu"] and len(skipped) == 2
    assert all(": skipped, anchor found 0 times" in line for line in skipped)


@pytest.mark.parametrize("cap,slots", [(4097, 8 + 10 * 129), (9216, 8 + 10 * 288 * 2),
                                       (16384, 8 + 10 * 512 * 2)])
def test_trace_slots_hold_every_step(cap, slots):
    assert probe.trace_slots(cap) == slots


@pytest.mark.parametrize("kind", ["big", "ahead"])
def test_trace_report_on_synthetic_stamps(kind, capsys):
    B, steps, cycles = 2, 6, 2000.0
    t = np.zeros((B, 8 + probe.SLOTS * 10))
    t[:, 0], t[:, 1] = 1000.0, 0.0
    t[:, 2], t[:, 3] = 1000.0 + steps * cycles, steps * cycles / 2.0  # 2 GHz
    for s in range(steps):
        base = 8 + probe.SLOTS * s
        t[:, base:base + probe.SLOTS] = 1000.0 + s * cycles + np.arange(probe.SLOTS) * 100
    probe.report_trace("synthetic", kind, t.ravel(), B, "card")
    out = capsys.readouterr().out
    assert "SM clock 2.000 GHz" in out and f"{steps} steps" in out
    # A step: the slab to slab time (the lookahead keep), stamps 0 to 6 (the other).
    assert ("step: 1.0000 us" if kind == "ahead" else "step: 0.3000 us") in out
    assert ("chain: the 32-row chain: 0.0500 us" if kind == "ahead"
            else "OR pass (and seen stores): 0.0500 us") in out
