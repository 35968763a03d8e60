"""K1's register-A kernel on the CPU: its numerical design and its launch
plan, before the card runs it (``chip_smoke.py`` phases 3 and 44 hold the
kernel itself against the twin there).

- ``split_tf32`` (the wrapper's split of the weights, and the kernel's
  of its A words) against an independent float64 rounding: ``hi`` and
  ``lo`` are TF32 values (13 low mantissa bits zero), rounded to nearest
  with ties away from zero (``cvt.rna.tf32.f32``), normal and subnormal;
  ``hi + lo`` is ``x`` within 2^-22 |x|, or 2^-137 where that is larger
  (TF32's subnormal step is 2^-136, which bounds ``lo`` near 2^-126);
  zeros keep their sign.
- The kernel's k order (``k_order``) as its threads use it: a numpy
  simulation of each thread's 16-byte loads placed into the wgmma A
  fragment (word (step s, half h) of thread t at logical word 8 s + 4 h +
  t), times the weights as ``k1_operands`` lays them out, equals the
  product in channel order, in fp32 and bf16 element widths.
- The 3xTF32 arithmetic, emulated in torch from the operands the wrapper
  launches (``k1_operands``: the padded inputs, the permuted hi/lo
  weights): per GEMM hi_a hi_b + hi_a lo_b + lo_a hi_b, summed in fp32,
  at the twin's rounding points; against the JAX Pallas kernel in
  interpret mode in fp32 within 1e-4 x max|ref| (``chip_smoke.py``'s
  ``K1_FP32_TOL``) at C = 8, 36, 256 and 288 on (1, 3, 37) and (2, 4, 70).
  TF32 alone (hi_a hi_b) is about 2^-11 per product, so the bound shows
  that the compensation, not the tolerance, carries the accuracy (the
  test checks that TF32 alone misses it at C = 256).
- ``k1_plan``: fp32 at every C names the 3xTF32 entry, bf16 up to 256 the
  shipped wgmma instances with their pads, bf16 past 256 the output-tiled
  entry, and nothing is refused.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from range_view_3d_detection_torch.kernels import stem as tstem
from range_view_3d_detection_tpu.kernels.stem_pallas import meta_kernel_fused

torch.set_num_threads(2)


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, in float64 arithmetic."""
    x64 = x.astype(np.float64)
    mag = np.abs(x64)
    _, e = np.frexp(mag)  # mag in [2^(e-1), 2^e)
    step = np.where(mag >= 2.0**-126, np.ldexp(1.0, e - 11), 2.0**-136)
    q = mag / step  # exact: a power-of-two scaling
    out = np.copysign(np.floor(q + 0.5) * step, x64)
    return out.astype(np.float32)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def test_split_tf32_rounds_as_cvt_rna():
    rng = np.random.default_rng(0)
    normal = (rng.standard_normal(100_000) * np.exp2(rng.integers(-60, 60, 100_000)))
    sub = rng.integers(1, 1 << 23, 20_000).astype(np.uint32).view(np.float32)
    sub = np.where(rng.random(sub.shape) < 0.5, -sub, sub)
    # Ties: the 13 dropped bits exactly 0x1000, of both signs.
    ties = ((rng.integers(0x00800000, 0x7F000000, 2_000) & ~0x1FFF) | 0x1000)
    ties = ties.astype(np.uint32).view(np.float32)
    ties = np.concatenate([ties, -ties])
    x = np.concatenate([normal.astype(np.float32), sub, ties,
                        np.array([0.0, -0.0, 1.0, -1.0], np.float32)])
    hi, lo = tstem.split_tf32(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.float32
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    np.testing.assert_array_equal(_bits(hi), _rna_reference(x).view(np.int32))
    rest = (x.astype(np.float64) - hi.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(_bits(lo), _rna_reference(rest).view(np.int32))
    # Ties round away from zero.
    at = len(normal) + len(sub)
    hi_ties = hi.numpy()[at: at + len(ties)].astype(np.float64)
    assert (np.abs(hi_ties) > np.abs(ties.astype(np.float64))).all()
    # hi + lo reconstructs x.
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x.astype(np.float64))
    assert (err <= np.maximum(2.0**-22 * np.abs(x.astype(np.float64)), 2.0**-137)).all()
    # Zeros keep their sign; NaN stays NaN.
    z_hi, z_lo = tstem.split_tf32(torch.tensor([0.0, -0.0]))
    assert _bits(z_hi).tolist() == [0, np.int32(-(2**31))] and not z_lo.any()
    n_hi, n_lo = tstem.split_tf32(torch.tensor([float("nan"), float("inf"), -float("inf")]))
    assert torch.isnan(n_hi[0]) and n_hi[1:].tolist() == [float("inf"), -float("inf")]


@pytest.mark.parametrize("elem", [4, 2], ids=["fp32", "bf16"])
def test_k_order_matches_the_fragment_loads(elem):
    """What the kernel's consumer threads load and place in wgmma's A
    fragment, times the weights in ``k1_operands``' layout, is hh @ W1."""
    C = 96 if elem == 4 else 128  # several groups of 64 bytes
    per_word, group = 4 // elem, 64 // elem
    rng = np.random.default_rng(elem)
    hh = rng.standard_normal((64, C))
    w1 = rng.standard_normal((C, C))
    order = tstem.k_order(C, elem).numpy()
    assert sorted(order.tolist()) == list(range(C))
    w1t = w1[order].T  # [n][logical k], as k1_operands gathers it
    a = np.zeros((64, C))  # A as wgmma reads it: [row][logical k]
    for warp in range(4):
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            rows = (16 * warp + gid, 16 * warp + gid + 8)
            for grp in range(C // group):
                c0 = grp * group + tig * (16 // elem)  # the thread's 16 bytes
                words = [[hh[r, c0 + per_word * i: c0 + per_word * (i + 1)] for i in range(4)]
                         for r in rows]
                for s in range(2):
                    # a0 (row m, k = t), a1 (m + 8, t), a2 (m, t + 4), a3 (m + 8, t + 4)
                    frag = {(0, 0): words[0][2 * s], (1, 0): words[1][2 * s],
                            (0, 1): words[0][2 * s + 1], (1, 1): words[1][2 * s + 1]}
                    for (r, half), v in frag.items():
                        k0 = (grp * 16 + 8 * s + 4 * half + tig) * per_word
                        a[rows[r], k0: k0 + per_word] = v
    np.testing.assert_allclose(a @ w1t.T, hh @ w1, rtol=1e-12, atol=1e-9)


def _inputs(shape, C, seed):
    rng = np.random.default_rng(seed)
    B, H, W = shape
    return dict(
        g=rng.normal(size=(B, H, W, C)).astype(np.float32),
        feats=rng.normal(size=(B, H, W, C)).astype(np.float32),
        w1=(rng.normal(size=(C, C)) * C**-0.5).astype(np.float32),
        k=(rng.normal(size=(9, C, C)) * C**-0.5).astype(np.float32),
        a0=rng.uniform(0.5, 1.5, C).astype(np.float32),
        b0=rng.normal(size=C).astype(np.float32),
        a1=rng.uniform(0.5, 1.5, C).astype(np.float32),
        b1=rng.normal(size=C).astype(np.float32),
    )


def emulate_tf32x3(x: dict, compensate: bool = True) -> torch.Tensor:
    """K1's register-A kernel in fp32, in torch: the operands it is
    launched with, hh and pf split by ``split_tf32`` in the kernel's k
    order, three TF32 products per GEMM (one without ``compensate``)."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    C = t["g"].shape[-1]
    plan = tstem.k1_plan(C, torch.float32)
    g, feats, w1t, kt, w1t_lo, kt_lo, aff = tstem.k1_operands(plan, **t)
    a0, b0, a1, b1 = aff
    B, H, W, Cp = g.shape
    order = tstem.k_order(Cp, 4)
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    fp = F.pad(feats, (0, 0, 1, 1, 1, 1))

    def gemm(a, b_hi, b_lo):
        a_hi, a_lo = tstem.split_tf32(a[..., order])
        if not compensate:
            return a_hi @ b_hi.T
        return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T

    acc = torch.zeros((B, H, W, Cp))
    for dy in range(3):
        for dx in range(3):
            n = 3 * dy + dx
            hh = torch.relu((gp[:, dy: dy + H, dx: dx + W] - g) * a0 + b0)
            z = gemm(hh, w1t, w1t_lo)
            pf = torch.relu(z * a1 + b1) * fp[:, dy: dy + H, dx: dx + W]
            acc = acc + gemm(pf, kt[n], kt_lo[n])
    return acc[..., :C]


@pytest.mark.parametrize("shape", [(1, 3, 37), (2, 4, 70)], ids=["1x3x37", "2x4x70"])
@pytest.mark.parametrize("C", [8, 36, 256, 288])
def test_tf32x3_arithmetic_matches_pallas(C, shape):
    x = _inputs(shape, C, seed=C + shape[-1])
    want = np.asarray(meta_kernel_fused(**{k: jnp.asarray(v) for k, v in x.items()},
                                        interpret=True))
    got = emulate_tf32x3(x).numpy()
    assert got.shape == want.shape
    ref = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= chip_smoke.K1_FP32_TOL * ref, (err, ref)
    if C == 256 and shape == (2, 4, 70):
        plain_tf32 = np.abs(emulate_tf32x3(x, compensate=False).numpy() - want).max()
        assert plain_tf32 > chip_smoke.K1_FP32_TOL * ref > 10 * err, (plain_tf32, err, ref)


def test_k1_plan_routes_every_c_to_the_tensor_cores():
    for C in chip_smoke.ANY_C + (1, 16, 128, 129, 255, 256, 257, 1000):
        assert tstem.k1_plan(C, torch.float32) == ("tf32x3", -C % 16)
        bf16 = tstem.k1_plan(C, torch.bfloat16)
        if C <= 256:
            assert bf16 == ("wgmma", -C % 8)
        else:
            assert bf16 == ("wgmma_tiled", -C % 32)
    for C in (32, 128, 256):  # the configs' stems: the shipped instances, no copy
        assert tstem.k1_plan(C, torch.bfloat16) == ("wgmma", 0)
    assert tstem.k1_plan(256, torch.float32) == ("tf32x3", 0)  # the fp32 flagship stem


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k1_operands_lay_out_the_register_a_entry(dtype):
    """``k1_operands`` for the register-A entry: C padded to the group,
    W1^T and K_n^T with k in ``k_order`` (fp32: hi + lo equal to them
    within 2^-22; no lo parts in bf16), the affines stacked; the shipped
    wgmma entry keeps its transposed weights."""
    C = 20 if dtype == torch.float32 else 264
    x = {k: torch.from_numpy(v) for k, v in _inputs((1, 2, 5), C, seed=3).items()}
    x.update({k: x[k].to(dtype) for k in ("g", "feats", "w1", "k")})
    plan = tstem.k1_plan(C, dtype)
    Cp = C + plan.pad
    assert Cp % (16 if dtype == torch.float32 else 32) == 0
    g, feats, w1t, kt, w1t_lo, kt_lo, aff = tstem.k1_operands(plan, **x)
    assert g.shape[-1] == feats.shape[-1] == Cp and aff.shape == (4, Cp)
    assert all(t.is_contiguous() for t in (g, feats, w1t, kt, aff))
    assert w1t.dtype == kt.dtype == dtype and aff.dtype == torch.float32
    order = tstem.k_order(Cp, g.element_size())
    w1 = F.pad(x["w1"], (0, plan.pad, 0, plan.pad))[order].T
    k = F.pad(x["k"], (0, plan.pad, 0, plan.pad))[:, order].transpose(1, 2)
    if dtype == torch.float32:
        for hi, lo, want in ((w1t, w1t_lo, w1), (kt, kt_lo, k)):
            assert lo.is_contiguous() and not (hi.contiguous().view(torch.int32) & 0x1FFF).any()
            diff = (hi.double() + lo.double() - want.double()).abs()
            assert (diff <= 2.0**-22 * want.double().abs()).all()
    else:
        assert w1t_lo is None and kt_lo is None
        assert torch.equal(w1t, w1) and torch.equal(kt, k)
    np.testing.assert_array_equal(aff[:, :C].numpy(),
                                  torch.stack([x[v] for v in ("a0", "b0", "a1", "b1")]).numpy())
    assert not aff[:, C:].any()
    x32 = {"g": x["g"][..., :32].bfloat16(), "feats": x["feats"][..., :32].bfloat16(),
           "w1": x["w1"][:32, :32].bfloat16(), "k": x["k"][:, :32, :32].bfloat16(),
           **{v: x[v][:32] for v in ("a0", "b0", "a1", "b1")}}
    shipped = tstem.k1_operands(tstem.k1_plan(32, torch.bfloat16), **x32)
    assert len(shipped) == 8 and torch.equal(shipped[2], x32["w1"].t())
    assert torch.equal(shipped[3], x32["k"].transpose(1, 2))
