"""The hardware tools of the port (``tools/conv_ab.py``,
``tools/fold_bench.py``) against the JAX package's, on the CPU.

- conv_ab: A (K3's plain twin on the CPU), B (int8 im2col and
  ``torch._int_mm``, which runs on the CPU) and the JAX tool's
  ``make_fns`` ``lax_path`` (XLA's int8 conv with int32 accumulation, then
  ``acc.f32 * dq``; the tool's one-conv chain, which sums it in fp32,
  within 1e-6 of the sum of magnitudes of that sum in fp64) equal bit for bit at small shapes, stride 1 and 2,
  in fp32 out, and A == B in bf16 out; the tool's shape list starts with the
  JAX tool's five ``SHAPES``; its CLI runs on the tiny config's request
  (every distinct K3 shape recorded with its launches) and exits.
- fold_bench: ``_fold`` and ``_unfold`` equal the JAX tool's on the same
  array (W divisible by f and not); the CLI runs a cut ``res2`` stage in
  bf16 and int8 (the stage quantized as ``Predictor.quantize`` does), the
  stitched interior equal to the unfolded stage within the tool's 0.05
  (its fp32 gate, and the timed stage's own error on the CPU too).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.kernels.conv import conv3x3_i8_fused
from range_view_3d_detection_torch.tools import conv_ab, fold_bench
from tools import conv_ab as jconv_ab
from tools import fold_bench as jfold_bench

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(1, 5, 33, 32, 32, 1), (2, 4, 20, 32, 48, 1),
                                   (1, 3, 37, 64, 16, 2)])
def test_conv_ab_a_equals_b_equals_jax_lax(shape):
    B, H, W, Cin, Cout, sw = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-127, 128, (B, H, W, Cin), dtype=np.int8)
    w = rng.integers(-127, 128, (3, 3, Cin, Cout), dtype=np.int8)
    dq = rng.uniform(1e-3, 2e-2, Cout).astype(np.float32)
    xt, wt, dqt = torch.from_numpy(x), torch.from_numpy(w.reshape(9, Cin, Cout)), \
        torch.from_numpy(dq)
    lax_fn, _ = jconv_ab.make_fns(B, H, W, Cin, Cout, sw)
    def step(x_i8, w_hwio, dq_):  # make_fns' lax_path, outside its chain
        acc = jax.lax.conv_general_dilated(
            x_i8, w_hwio, window_strides=(1, sw), padding=((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
        return acc.astype(jnp.float32) * dq_

    want = np.asarray(jax.jit(step)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dq)))
    # The tool's own chain of one conv sums that output (fp32, its order).
    chain = float(lax_fn(jnp.asarray(x), jnp.asarray(w), None, jnp.asarray(dq), 1))
    assert abs(chain - want.astype(np.float64).sum()) <= 1e-6 * np.abs(want).sum()
    a = conv3x3_i8_fused(xt, wt, dqt, stride_w=sw, out_dtype=torch.float32)
    b = conv_ab.im2col_int_mm(xt, wt, dqt, sw, out_dtype=torch.float32)
    assert torch.equal(a, b)
    assert np.array_equal(a.numpy().view(np.uint32), want.view(np.uint32))
    a16 = conv3x3_i8_fused(xt, wt, dqt, stride_w=sw)
    b16 = conv_ab.im2col_int_mm(xt, wt, dqt, sw)
    assert a16.dtype == torch.bfloat16 and torch.equal(a16, b16)


def test_conv_ab_cli_on_the_tiny_request(capsys):
    assert conv_ab.SHAPES == jconv_ab.SHAPES
    out = conv_ab.main(["--tiny", "--reps", "1", "--chain", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["tool"] == "conv_ab" and line["device"] == "cpu"
    assert all(r["equal"] and r["per_request"] > 0 for r in line["rows"])
    assert sum(r["per_request"] for r in line["rows"]) > len(line["rows"])
    assert line["request_ms"]["a"] > 0


@pytest.mark.parametrize("w,f,r", [(113, 2, 10), (113, 4, 10), (64, 4, 6), (7, 3, 2)])
def test_fold_unfold_equal_the_jax_tools(w, f, r):
    x = np.random.default_rng(w + f).normal(size=(2, 3, w, 5)).astype(np.float32)
    got = fold_bench._fold(torch.from_numpy(x), f, r)
    want = np.asarray(jfold_bench._fold(jnp.asarray(x), f, r))
    assert np.array_equal(got.numpy(), want)
    y = want * 2.0 + 1.0
    got_u = fold_bench._unfold(torch.from_numpy(y), f, r, w)
    want_u = np.asarray(jfold_bench._unfold(jnp.asarray(y), f, r, w))
    assert np.array_equal(got_u.numpy(), want_u)
    assert np.array_equal(fold_bench._unfold(got, f, r, w).numpy(), x)
    assert fold_bench.STAGES == jfold_bench.STAGES


@pytest.mark.parametrize("int8", [False, True])
def test_fold_bench_cli_on_a_cut_stage(capsys, int8):
    args = ["--stage", "res2", "--batch", "1", "--height", "2", "--folds", "1", "2", "4",
            "--iters", "1", "--device", "cpu"] + (["--int8"] if int8 else [])
    out = fold_bench.main(args)
    assert out["int8"] is int8 and out["shape"] == [1, 2, 452, 64]
    folded = [r for r in out["rows"] if r["fold"] > 1]
    assert len(folded) == 2 and all(r["interior_err"] < 0.05 for r in folded)
    assert all(r["interior_err"] <= r["interior_tol"] for r in folded)
    assert all((r["interior_tol"] == 0) is int8 for r in folded)
    assert all(r["fp32_interior_err"] < 1e-4 for r in folded)
    assert all(r["edge_err"] > 0 for r in folded)  # zero padding at every conv
    assert '"tool": "fold_bench"' in capsys.readouterr().out
