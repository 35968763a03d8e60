"""Port parity for the fused MetaKernel stem (K1), fp32 on the CPU.

- The plain twin of the CUDA kernel against the JAX Pallas kernel run in
  interpret mode (``meta_kernel_fused(..., interpret=True)``), as
  ``tests/test_stem_pallas.py`` runs it.
- The port's ``MetaKernel`` against the flax eval accumulate path with
  transplanted weights and randomised BatchNorm statistics.
- H = 1 cases, where both vertical edges hit the one row.

Tolerance: atol = rtol = 1e-4 (fp32 sums in different orders).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.kernels import stem as tstem
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


def test_meta_kernel_refuses_train_mode():
    with pytest.raises(NotImplementedError):
        MetaKernel(5, 8).train()(torch.zeros(1, 5, 2, 4), torch.zeros(1, 2, 4, 3))
