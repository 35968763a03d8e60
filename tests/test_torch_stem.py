"""Port parity for the fused MetaKernel stem (K1), fp32 on the CPU.

- The plain twin of the CUDA kernel against the JAX Pallas kernel run in
  interpret mode (``meta_kernel_fused(..., interpret=True)``), as
  ``tests/test_stem_pallas.py`` runs it.
- The port's ``MetaKernel`` against the flax eval accumulate path with
  transplanted weights and randomised BatchNorm statistics.
- H = 1 cases, where both vertical edges hit the one row.
- In bf16, the ``stem_pallas`` switch: without it the port's stem is the
  flax accumulate path, with it the fused kernel's formulation, held
  against the flax Pallas path (tolerances in that test's docstring).

Tolerance (fp32): atol = rtol = 1e-4 (fp32 sums in different orders).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.kernels import stem as tstem
from range_view_3d_detection_torch.models import stems as tstems
from range_view_3d_detection_torch.models.stems import MetaKernel
from range_view_3d_detection_torch.transplant import load_flax_variables
from range_view_3d_detection_tpu.kernels.stem_pallas import meta_kernel_fused
from range_view_3d_detection_tpu.models import stems as jstems
from test_torch_blocks import nchw, nhwc, randomize_bn

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _stem_inputs(B, H, W, C, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        g=rng.normal(size=(B, H, W, C)).astype(np.float32),
        feats=rng.normal(size=(B, H, W, C)).astype(np.float32),
        w1=(rng.normal(size=(C, C)) * 0.2).astype(np.float32),
        k=(rng.normal(size=(9, C, C)) * 0.2).astype(np.float32),
        a0=rng.uniform(0.5, 1.5, C).astype(np.float32),
        b0=rng.normal(size=C).astype(np.float32),
        a1=rng.uniform(0.5, 1.5, C).astype(np.float32),
        b1=rng.normal(size=C).astype(np.float32),
    )


# (H, W, C): the first two are the original cases; (1, 70) and (2, 64) are
# the shapes at which chip_smoke.py holds the card's kernel against this
# twin (a single row with a ragged last 64-pixel tile, an exact tile), at
# a narrow C so the interpret-mode run stays short.
@pytest.mark.parametrize(
    "H, W, C", [(6, 16, 8), (1, 16, 8), (1, 70, 16), (2, 64, 16)],
    ids=["6", "1", "H1-W70", "H2-W64"],
)
def test_plain_twin_matches_pallas_interpret(H, W, C):
    x = _stem_inputs(1, H, W, C)
    want = np.asarray(meta_kernel_fused(**x, interpret=True))
    launches = tstem.meta_kernel_fused.launches
    got = tstem.meta_kernel_fused(**{k: torch.from_numpy(v) for k, v in x.items()})
    assert tstem.meta_kernel_fused.launches == launches  # CPU: the twin
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("H", [5, 1])
def test_meta_kernel_matches_flax_accumulate(H):
    B, W, Cin, C = 2, 16, 5, 8
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
    cart = rng.normal(scale=10.0, size=(B, H, W, 3)).astype(np.float32)
    jx = jstems.MetaKernel(C)
    v = jx.init(jax.random.PRNGKey(0), feats, cart, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=5)
    want = np.asarray(
        jx.apply({"params": params, "batch_stats": stats}, feats, cart, train=False)
    )
    assert jstems.LAST_STEM_PATH == "accumulate"
    tx = load_flax_variables(MetaKernel(Cin, C).eval(), params, stats)
    with torch.no_grad():
        got = nhwc(tx(nchw(feats), torch.from_numpy(cart)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stem_pallas", [False, True], ids=["accumulate", "fused"])
def test_meta_kernel_bf16_follows_stem_pallas(stem_pallas, monkeypatch):
    """bf16 stem, C = 32, with and without ``stem_pallas``.

    The flax side takes jnp arrays: numpy inputs would make flax run the
    bf16 ``cart @ pos_0_conv_kernel`` product in numpy's bf16 arithmetic,
    which rounds after every multiply-add.

    - Without the switch the port takes the accumulate path and matches
      the flax accumulate path: at most 1% of the elements differ, by at
      most one bf16 ulp of max|ref| (2^-8 relative); on the CPU they are
      equal. Before the switch existed the port always took the fused
      formulation, which sums the nine neighbours in fp32: it differs from
      the accumulate path in over 10% of the elements (asserted below).
    - With it the port calls the fused kernel's wrapper (its plain twin on
      the CPU) and is held to the flax Pallas path in interpret mode:
      max|diff| <= 2^-5 * max|ref| and a relative RMS <= 2^-6. The two
      round the intermediate ``p`` to bf16 at the same point, but an fp32
      difference of one ulp before a bf16 rounding flips it by a bf16 ulp
      (2^-8 relative), and the flips pass through fusion1_bn and fusion_1.
    """
    B, H, W, Cin, C = 2, 5, 16, 5, 32
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
    cart = rng.normal(scale=10.0, size=(B, H, W, 3)).astype(np.float32)
    v = jstems.MetaKernel(C, dtype=jnp.bfloat16).init(
        jax.random.PRNGKey(0), feats, cart, train=False
    )
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=5)
    variables = jax.tree_util.tree_map(
        jnp.asarray, {"params": params, "batch_stats": stats}
    )

    def flax_stem(use_pallas_kernel):
        jx = jstems.MetaKernel(C, use_pallas_kernel=use_pallas_kernel, dtype=jnp.bfloat16)
        out = jx.apply(variables, jnp.asarray(feats), jnp.asarray(cart), train=False)
        return np.asarray(out.astype(jnp.float32)), jstems.LAST_STEM_PATH

    want_acc, path = flax_stem(False)
    assert path == "accumulate"
    calls = []

    def fused(*args):
        calls.append(1)
        return tstem.meta_kernel_fused(*args)

    monkeypatch.setattr(tstems, "meta_kernel_fused", fused)
    tx = MetaKernel(Cin, C, use_fused_kernel=stem_pallas, dtype=torch.bfloat16)
    tx = load_flax_variables(tx.eval(), params, stats)
    with torch.no_grad():
        got = nhwc(tx(nchw(feats), torch.from_numpy(cart)).float())
    ref = float(np.abs(want_acc).max())
    differ = np.mean(got != want_acc)
    assert len(calls) == int(stem_pallas)
    if not stem_pallas:
        assert differ <= 0.01, differ
        np.testing.assert_allclose(got, want_acc, atol=2.0**-8 * ref, rtol=0)
        return
    assert differ > 0.1, differ  # the fused formulation, not the accumulate path
    want, path = flax_stem(True)
    assert path == "pallas_fp"
    ref = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=2.0**-5 * ref, rtol=0)
    assert np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2)) <= 2.0**-6


def test_meta_kernel_refuses_train_mode():
    """Train mode runs the stacked path (``test_torch_train_step.py``),
    also on a quantized stem: the stem's int8 path is eval-only and has
    no QAT branch, as in the JAX stem, so a quantized stem trains as the
    fp one does (until QAT was ported this raised)."""
    gen = torch.Generator().manual_seed(0)
    x, cart = torch.randn(2, 5, 3, 6, generator=gen), torch.randn(2, 3, 6, 3, generator=gen)
    plain, stem = MetaKernel(5, 8), MetaKernel(5, 8)
    with torch.no_grad():
        for p in plain.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    stem.load_state_dict(plain.state_dict())
    stem.quantize_stem(1.0, 1.0, use_kernel=False)
    assert torch.equal(stem.train()(x, cart), plain.train()(x, cart))
