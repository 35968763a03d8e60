"""Port parity for the int8 MetaKernel stem (K4), CPU.

- The plain twin of the CUDA kernel against the JAX Pallas kernel in
  interpret mode (``meta_kernel_fused_i8(..., interpret=True)``), at
  (1, 5, 16, 8) and (2, 3, 37, 32): within rtol = atol = 1e-4, the
  tolerance of ``tests/test_stem_pallas.py`` (fp32 sums of the
  dequantized neighbour terms).
- The port's MetaKernel quantized with ``stem_int8=True`` against the
  JAX MetaKernel under ``quantization("int8")`` with ``RV3D_STEM_INT8=1``,
  the same weights and the same quant tree (calibrated by JAX): the
  stem's output within 1e-4 * max|ref| (ulp differences of the eval BN
  affines can move an int8 value across a rounding boundary; a flip
  moves one output by about one dequant step, far below that bound).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.kernels import stem as tstem
from range_view_3d_detection_torch.models.quantized import quantize_model
from range_view_3d_detection_torch.models.stems import MetaKernel
from range_view_3d_detection_torch.transplant import load_flax_variables
from range_view_3d_detection_tpu.kernels.stem_pallas import meta_kernel_fused_i8
from range_view_3d_detection_tpu.models import quantized as jq
from range_view_3d_detection_tpu.models import stems as jstems
from test_torch_blocks import nchw, nhwc, randomize_bn

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _i8_inputs(B, H, W, C, seed):
    rng = np.random.default_rng(seed)
    return dict(
        g=rng.normal(size=(B, H, W, C)).astype(np.float32),
        feats=rng.normal(size=(B, H, W, C)).astype(np.float32),
        w1_i8=rng.integers(-127, 128, size=(C, C)).astype(np.int8),
        k_i8=rng.integers(-127, 128, size=(9, C, C)).astype(np.int8),
        a0=rng.uniform(0.5, 1.5, C).astype(np.float32),
        b0=rng.normal(size=C).astype(np.float32),
        a1=(rng.uniform(0.5, 1.5, C) * 1e-2).astype(np.float32),
        b1=rng.normal(size=C).astype(np.float32),
        kdq=(rng.uniform(0.5, 1.5, (9, C)) * 1e-3).astype(np.float32),
    )


@pytest.mark.parametrize("shape", [(1, 5, 16, 8), (2, 3, 37, 32)])
def test_k4_twin_matches_pallas_interpret(shape):
    x = _i8_inputs(*shape, seed=3)
    want = np.asarray(meta_kernel_fused_i8(**x, interpret=True))
    launches = tstem.meta_kernel_fused_i8.launches
    got = tstem.meta_kernel_fused_i8(**{k: torch.from_numpy(v) for k, v in x.items()})
    assert tstem.meta_kernel_fused_i8.launches == launches  # CPU: the twin
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _scales(stats):
    """JAX ``quant_stats`` absmaxes -> quant tree, as ``calibrate_scales``."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out[k] = _scales(v)
        else:
            m = float(np.asarray(v))
            out[k[: -len("_absmax")] + "_scale"] = np.asarray(
                m / 127.0 if m > 0 else 1.0, np.float32
            )
    return out


def test_int8_meta_kernel_matches_flax(monkeypatch):
    B, H, W, Cin, C = 2, 5, 16, 5, 8
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
    cart = rng.normal(scale=10.0, size=(B, H, W, 3)).astype(np.float32)
    jx = jstems.MetaKernel(C, use_pallas_kernel=True)
    v = jx.init(jax.random.PRNGKey(0), feats, cart, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=6)
    fp_vars = {"params": params, "batch_stats": stats}
    with jq.quantization("calib"):
        _, sown = jx.apply(fp_vars, feats, cart, train=False, mutable=["quant_stats"])
    tree = _scales(jax.device_get(sown["quant_stats"]))
    assert {"stem_hh_scale", "stem_pf_scale"} <= set(tree)
    monkeypatch.setenv("RV3D_STEM_INT8", "1")
    with jq.quantization("int8"):
        want = np.asarray(jx.apply({**fp_vars, "quant": tree}, feats, cart, train=False))
    assert jstems.LAST_STEM_PATH == "pallas_int8"

    tx = load_flax_variables(MetaKernel(Cin, C).eval(), params, stats)
    quantize_model(tx, tree, stem_int8=True)
    launches = tstem.meta_kernel_fused_i8.launches
    calls = []
    handle = tx.fusion1_bn.register_forward_pre_hook(lambda m, a: calls.append(1))
    with torch.no_grad():
        got = nhwc(tx(nchw(feats), torch.from_numpy(cart)))
    handle.remove()
    assert calls and tstem.meta_kernel_fused_i8.launches == launches
    assert tx.i8_w1 is not None and tx.fusion_1.int8 is not None
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()), rtol=0)


def test_stem_int8_needs_the_flag_and_both_scales():
    tx = MetaKernel(5, 8).eval()
    tree = {"stem_hh_scale": np.float32(0.1), "stem_pf_scale": np.float32(0.2)}
    quantize_model(tx, tree, stem_int8=False)
    assert tx.i8_w1 is None and tx.stem_scales == (
        float(np.float32(0.1)), float(np.float32(0.2))
    )
    quantize_model(tx, {"stem_hh_scale": np.float32(0.1)}, stem_int8=True)
    assert tx.i8_w1 is None and tx.stem_scales is None
    quantize_model(tx, tree, stem_int8=True)
    assert tx.i8_w1 is not None
