"""K4's output-tiled kernel on the CPU: its launch plan, the wrapper's
padding, its integer-to-float conversion and its loop order, before the
card runs it (``chip_smoke.py`` phases 10 and 44 hold the kernel itself
against the twin there, with no element differing).

- ``k4_plan`` at every C in 1..599 in bf16 and fp32: bf16 up to 256 keeps
  the shipped wgmma instances with their pads; fp32 up to 256 names the
  output-tiled entry's one-tile form (``"wgmma_fp32"``) and every C past
  256 its 256-wide tiles (``"wgmma_tiled"``), each with the pad that makes
  C a multiple of 16 (the int8 weights' and the fp32 row map's TMA
  strides); no route is the CUDA-core kernel, and nothing is refused
  (past C = 2304 the kernel builds hq in slabs of k).
- ``padded_operands`` with each route's pad leaves the twin's first C
  channels equal bit for bit (exact integer sums), at C = 12, 36, 100 and
  300 in fp32 and bf16.
- The kernel's conversions of z and d to fp32, emulated in numpy bit for
  bit: ``int_to_float_rn`` (form 2: i = 4096 hi + lo, one fused
  multiply-add) equals ``np.float32(np.int64(i))`` (the twin's correctly
  rounded conversion) at every integer with |i| <= 512 x 127 x 128, at
  the 2^22 and 2^24 edges and across the int32 range; the one-subtraction
  form (form 1 and the bf16 instances) is exact below 2^22, which holds at
  C <= 256 (|i| <= 256 x 127 x 128), and not past it.
- Form 2's loop order (128-wide chunks of z, each chunk's pq_j into one
  int32 d a neighbour, 256-wide output tiles, W1 repeated per tile; and
  z_j summed over slabs of k, as past C = 2304), emulated in torch on the
  wrapper's padded operands, equals the twin bit for bit at C = 300 in
  fp32 and bf16.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from range_view_3d_detection_torch.kernels import stem as tstem

torch.set_num_threads(2)

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_k4_plan_routes_every_c_to_the_int8_tensor_cores(dtype):
    for C in range(1, 600):
        got = tstem.k4_plan(C, dtype)
        if C <= 256:
            want = "wgmma" if dtype == torch.bfloat16 else "wgmma_fp32"
        else:
            want = "wgmma_tiled"
        assert got == (want, -C % 16), (C, got)
        assert (C + got.pad) % 16 == 0 and 0 <= got.pad < 16
    for C in (32, 128, 256):  # the configs' bf16 stems: the shipped instances, no copy
        assert tstem.k4_plan(C, torch.bfloat16) == ("wgmma", 0)
    assert tstem.k4_plan(256, torch.float32) == ("wgmma_fp32", 0)  # the fp32 flagship stem
    for C in (1152, 2304, 2305, 4097):  # past the hq tile's shared memory: slabs of k
        assert tstem.k4_plan(C, dtype) == ("wgmma_tiled", -C % 16)


def _k4_args(rng, B, H, W, C, dtype):
    """K4 operands at the scales the calibrated stem gives them
    (``chip_smoke.k4_inputs``'s): hq spans 0-127, p * feats about +-50."""
    g = torch.from_numpy(rng.standard_normal((B, H, W, C), np.float32)).to(dtype)
    feats = torch.from_numpy(rng.standard_normal((B, H, W, C), np.float32)).to(dtype)
    w1 = torch.from_numpy(rng.integers(-127, 128, (C, C), np.int8))
    k = torch.from_numpy(rng.integers(-127, 128, (9, C, C), np.int8))

    def u(lo, hi, *shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    a0, b0 = u(15, 45, C), torch.from_numpy(rng.standard_normal(C).astype(np.float32) * 30)
    a1, b1 = u(5e-4, 1.5e-3, C), torch.from_numpy(rng.standard_normal(C).astype(np.float32))
    return (g, feats, w1, k, a0, b0, a1, b1, u(5e-4, 1.5e-3, 9, C))


@pytest.mark.parametrize("C", [12, 36, 100, 300])
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_k4_route_padding_is_exact(dtype, C):
    plan = tstem.k4_plan(C, dtype)
    assert plan.pad > 0
    args = _k4_args(np.random.default_rng(C), 1, 3, 11, C, dtype)
    want = tstem.meta_kernel_fused_i8_plain(*args)
    got = tstem.meta_kernel_fused_i8_plain(*tstem.padded_operands(plan.pad, *args))
    assert got.shape[-1] == C + plan.pad and not got[..., C:].any()
    assert torch.equal(got[..., :C], want)


# The kernel's conversions, on int32 bit patterns as the card computes them.
def _as_f32(bits: np.ndarray) -> np.ndarray:
    return bits.astype(np.int32).view(np.float32)


def small_int_to_float(i: np.ndarray) -> np.ndarray:
    """``small_int_to_float``: (i + 0x4B400000) as float, less 1.5 x 2^23
    (one fp32 subtraction, exact)."""
    return _as_f32(i.astype(np.int64) + 0x4B400000) - np.float32(12582912.0)


def int_to_float_rn(i: np.ndarray) -> np.ndarray:
    """``int_to_float_rn``: hi = small_int_to_float(i >> 12), lo = float(2^23
    + (i & 0xFFF)) - 2^23, then fma(hi, 4096, lo), whose product and sum are
    exact in float64 before its one rounding to fp32."""
    i = i.astype(np.int64)
    hi = small_int_to_float(i >> 12)
    lo = _as_f32((i & 0xFFF) | 0x4B000000) - np.float32(8388608.0)
    return (hi.astype(np.float64) * 4096.0 + lo.astype(np.float64)).astype(np.float32)


def _edges(span: int) -> np.ndarray:
    """Integers within ``span`` of +-2^22, +-2^24, +-2^25 and the ends of
    int32."""
    centres = [2**22, 2**24, 2**25, 2**31 - 1 - span, -(2**31) + span]
    out = [np.arange(c - span, c + span + 1) for c in centres]
    out += [-a for a in out[:3]]
    return np.concatenate(out)


@pytest.mark.parametrize("part", range(4))
def test_int_to_float_rn_is_the_twins_conversion(part):
    """Every integer with |i| <= 512 x 127 x 128 (the range of z and d at C =
    512), a quarter a case, and the edges past 2^22 and 2^24 (where fp32
    stops holding every integer, and rounds half to even)."""
    top = 512 * 127 * 128
    lo = -top + part * (2 * top + 1) // 4
    hi = -top + (part + 1) * (2 * top + 1) // 4
    for start in range(lo, hi, 1 << 21):
        i = np.arange(start, min(start + (1 << 21), hi), dtype=np.int64)
        got = int_to_float_rn(i)
        assert np.array_equal(got.view(np.int32), i.astype(np.float32).view(np.int32)), start
    i = _edges(4096 + 3)
    assert np.array_equal(int_to_float_rn(i).view(np.int32), i.astype(np.float32).view(np.int32))


def test_small_int_to_float_is_exact_only_below_2_to_22():
    """Form 1 and the bf16 instances convert with one subtraction: exact for
    |i| < 2^22, which |z| and |d| stay below at C <= 256; past 2^22 it is
    not, which is why form 2 (C > 256) converts with ``int_to_float_rn``."""
    assert 256 * 127 * 128 < 2**22 < 512 * 127 * 127
    i = np.arange(-(2**22) + 1, 2**22, 7, dtype=np.int64)
    assert np.array_equal(small_int_to_float(i), i.astype(np.float32))
    past = np.array([2**22 + 1, 2**22 + 3, 512 * 127 * 127], dtype=np.int64)
    assert not np.array_equal(small_int_to_float(past), past.astype(np.float32))


def emulate_tiles(g, feats, w1_i8, k_i8, a0, b0, a1, b1, kdq, tile=256, chunk=128,
                  slab=None):
    """Form 2's loop order in torch on C-padded operands: each 256-wide
    output tile recomputes z in 128-wide chunks j (z_j = hq @ W1[:, j] over
    the whole K, or summed over slabs of ``slab`` channels of k; int64 sums
    of int8 products, which int32 holds), quantizes pq_j, and adds pq_j @
    K_n[j, tile] into one integer d a neighbour; then acc += float(d) *
    kdq[n], with float() as ``int_to_float_rn``."""
    B, H, W, C = g.shape
    feats = feats.to(g.dtype)
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    fp = F.pad(feats, (0, 0, 1, 1, 1, 1))
    w1l, kl = w1_i8.long(), k_i8.long()

    def to_float(x):
        return torch.from_numpy(int_to_float_rn(x.numpy()))

    out = torch.zeros((B, H, W, C), dtype=torch.float32)
    for n0 in range(0, C, tile):
        cols = slice(n0, min(n0 + tile, C))
        acc = torch.zeros((B, H, W, cols.stop - n0), dtype=torch.float32)
        for dy in range(3):
            for dx in range(3):
                n = 3 * dy + dx
                x0 = (gp[:, dy : dy + H, dx : dx + W] - g).float()
                hq = torch.clamp(torch.round(torch.relu(x0 * a0 + b0)), max=127.0).long()
                fs = fp[:, dy : dy + H, dx : dx + W].float()
                d = torch.zeros(acc.shape, dtype=torch.int64)
                for j0 in range(0, C, chunk):
                    j = slice(j0, min(j0 + chunk, C))
                    step = slab or C
                    z = to_float(sum(hq[..., s : s + step] @ w1l[s : s + step, j]
                                     for s in range(0, C, step)))
                    p = torch.relu(z * a1[j] + b1[j])
                    pq = torch.clamp(torch.round(p * fs[..., j]), -127.0, 127.0).long()
                    d += pq @ kl[n][j, cols]
                assert d.abs().max() < 2**31
                acc = acc + to_float(d) * kdq[n][cols]
        out[..., cols] = acc
    return out


@pytest.mark.parametrize("slab", [None, 128], ids=["whole", "slabs"])
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_tiled_loop_order_equals_the_twin(dtype, slab):
    C = 300
    plan = tstem.k4_plan(C, dtype)
    assert plan.kernel == "wgmma_tiled"
    args = _k4_args(np.random.default_rng(7), 1, 3, 9, C, dtype)
    want = tstem.meta_kernel_fused_i8_plain(*args)
    got = emulate_tiles(*tstem.padded_operands(plan.pad, *args), slab=slab)[..., :C]
    assert torch.equal(got, want)
