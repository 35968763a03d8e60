"""Port parity for the int8 convs (K3 and the blocks that run it), CPU.

- The plain twin of the CUDA kernel against the JAX Pallas kernel in
  interpret mode and against the lax reference (``tests/test_conv_pallas
  .py`` shapes, plus Cin 32 -> Cout 64), stride 1 and 2, fp32 and bf16
  output: equal element by element (the integer work is exact and the
  dequant is the same fp32 product).
- The port's int8 ``ConvNormAct`` against the JAX one under
  ``quantization("int8")`` with the same weights and ``in_scale``: 3x3 at
  width stride 1 and 2, 1x1 at width stride 1 and 2 (Cin 5). The int8
  conv's output is equal; the block's (BatchNorm + ReLU in fp32 after it)
  within 1e-6 (the two frameworks' BatchNorm formulas round differently).
- The port's int8 ``TorchConvTranspose`` (phase-merged, through the K3
  twin) against the JAX default ``lhs_dilation`` lowering, both
  aggregation node shapes: equal in fp32.
- K3's second operand form (the bf16/fp32 activation and ``in_scale``,
  quantized by the kernel as it stages its input) against
  ``quantize_to_int8`` + the int8 form and against the JAX ``Int8Conv``
  formula fed to the Pallas kernel (interpret mode) or the lax reference:
  equal, on values on the .5 rounding boundaries (half to even) and past
  +-127.5 scales (clamp), stride 1 and 2, odd W and H.
- The int8 ``ConvNormAct`` (K3 route) and ``TorchConvTranspose`` hand K3
  the unquantized NHWC activation and ``in_scale``, and quantize it in
  torch ops no more (the 1x1 route still does).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.kernels import conv as tconv
from range_view_3d_detection_torch.models import blocks as tb
from range_view_3d_detection_torch.models import quantized as tq
from range_view_3d_detection_torch.transplant import load_flax_variables
from range_view_3d_detection_tpu.kernels.conv_pallas import conv3x3_i8_fused
from range_view_3d_detection_tpu.models import blocks as jb
from range_view_3d_detection_tpu.models import quantized as jq
from test_torch_blocks import nchw, nhwc, randomize_bn

torch.set_num_threads(2)

K3_CASES = [
    ((2, 8, 40, 32), 24, 1),
    ((1, 5, 33, 16), 24, 1),  # odd width, odd height
    ((2, 8, 40, 32), 24, 2),
    ((1, 6, 18, 8), 24, 2),
    ((1, 4, 21, 32), 64, 1),  # the kernel's channel granularity
    ((1, 4, 21, 32), 64, 2),  # odd width at stride 2
]


def _lax_ref(x_i8, w_hwio_i8, dq, stride_w):
    acc = jax.lax.conv_general_dilated(
        x_i8, w_hwio_i8, window_strides=(1, stride_w), padding=((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32,
    )
    return acc.astype(jnp.float32) * dq


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,stride_w", K3_CASES)
def test_k3_twin_matches_pallas_and_lax(shape, cout, stride_w, out_dtype):
    rng = np.random.default_rng(0)
    B, H, W, Cin = shape
    x = rng.integers(-127, 128, size=shape, dtype=np.int8)
    w = rng.integers(-127, 128, size=(3, 3, Cin, cout), dtype=np.int8)
    dq = rng.uniform(1e-3, 2e-2, size=(cout,)).astype(np.float32)
    jdt = jnp.dtype(out_dtype)
    lax = np.asarray(
        _lax_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dq), stride_w).astype(jdt)
    ).astype(np.float32)
    launches = tconv.conv3x3_i8_fused.launches
    got = tconv.conv3x3_i8_fused(
        torch.from_numpy(x), torch.from_numpy(w.reshape(9, Cin, cout)),
        torch.from_numpy(dq), stride_w=stride_w, out_dtype=getattr(torch, out_dtype),
    )
    assert tconv.conv3x3_i8_fused.launches == launches  # CPU: the twin
    assert got.dtype == getattr(torch, out_dtype)
    got = got.float().numpy()
    assert got.shape == lax.shape == (B, H, (W - 1) // stride_w + 1, cout)
    np.testing.assert_array_equal(got, lax)
    if stride_w == 1 or W % 2 == 0:  # the Pallas kernel takes even widths at stride 2
        pallas = conv3x3_i8_fused(
            jnp.asarray(x), jnp.asarray(w).reshape(9, Cin, cout), jnp.asarray(dq),
            stride_w=stride_w, out_dtype=jdt, interpret=True,
        )
        np.testing.assert_array_equal(got, np.asarray(pallas).astype(np.float32))


def test_k3_twin_bf16_rounds_the_fp32_product():
    """bf16 output = bf16(fp32(acc) * dq), one rounding from the fp32 value."""
    rng = np.random.default_rng(1)
    x = rng.integers(-127, 128, size=(1, 3, 9, 32), dtype=np.int8)
    w = rng.integers(-127, 128, size=(9, 32, 16), dtype=np.int8)
    dq = rng.uniform(1e-3, 2e-2, size=(16,)).astype(np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dq))
    f32 = tconv.conv3x3_i8_fused(*args, out_dtype=torch.float32).numpy()
    bf16 = tconv.conv3x3_i8_fused(*args, out_dtype=torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(
        bf16, f32.astype(ml_dtypes.bfloat16).astype(np.float32)
    )


CONV_CASES = {
    "3x3_s11": ((3, 3), (1, 1), 16),
    "3x3_s12": ((3, 3), (1, 2), 16),
    "1x1_s11_cin5": ((1, 1), (1, 1), 5),
    "1x1_s12_cin5": ((1, 1), (1, 2), 5),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv_norm_act_matches_flax(case):
    kernel, strides, cin = CONV_CASES[case]
    features = 16
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 18, cin)).astype(np.float32)
    in_scale = np.float32(np.abs(x).max() / 127.0)
    jx = jb.ConvNormAct(features, kernel_size=kernel, strides=strides)
    v = jx.init(jax.random.PRNGKey(0), x)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=3)
    variables = {"params": params, "batch_stats": stats, "quant": {"in_scale": in_scale}}
    with jq.quantization("int8"):
        want, inter = jx.apply(variables, x, capture_intermediates=True)
    want_conv = np.asarray(inter["intermediates"]["Conv_0"]["__call__"][0])

    tx = tb.ConvNormAct(cin, features, kernel, strides)
    load_flax_variables(tx.eval(), params, stats)
    tx.quantize(float(in_scale))
    assert tx.int8.route == ("k3" if kernel == (3, 3) else "matmul")
    with torch.no_grad():
        got_conv = nhwc(tx.int8(nchw(x)))
        got = nhwc(tx(nchw(x)))
    np.testing.assert_array_equal(got_conv, want_conv)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


# Both aggregation node shapes (backbone.py): (kernel, stride, pad).
NODE_SHAPES = [((3, 8), (1, 4), (1, 2)), ((3, 4), (1, 2), (1, 1))]


@pytest.mark.parametrize("kernel,stride,pad", NODE_SHAPES)
def test_int8_deconv_matches_flax_dilated(kernel, stride, pad, monkeypatch):
    monkeypatch.delenv("RV3D_DECONV_PHASE", raising=False)  # JAX default path
    cin, cout = 6, 5
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 4, 10, cin)).astype(np.float32)
    in_scale = np.float32(np.abs(x).max() / 127.0)
    jx = jb.TorchConvTranspose(features=cout, kernel_size=kernel, strides=stride, padding=pad)
    params = jx.init(jax.random.PRNGKey(1), x)["params"]
    with jq.quantization("int8"):
        want = np.asarray(
            jx.apply({"params": params, "quant": {"in_scale": in_scale}}, x)
        )

    tx = tb.TorchConvTranspose(cin, cout, kernel, stride, pad)
    kernel_hwio = np.asarray(params["kernel"])
    with torch.no_grad():
        tx.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel_hwio[::-1, ::-1].transpose(2, 3, 0, 1))
        ))
    tx.quantize(float(in_scale))
    launches = tconv.conv3x3_i8_fused.launches
    with torch.no_grad():
        got = nhwc(tx(nchw(x)))
    assert tconv.conv3x3_i8_fused.launches == launches
    assert got.shape == want.shape == (2, 4, 10 * stride[1], cout)
    np.testing.assert_array_equal(got, want)


def test_int8_deconv_refuses_other_shapes():
    """A shape without the phase decomposition is no longer refused, as the
    JAX block refuses none: it takes the general int8 route (no K3 phase
    taps, no K3 launch) and equals the JAX ``lhs_dilation`` lowering."""
    cin, cout, kernel, stride, pad = 6, 5, (3, 3), (1, 2), (1, 1)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 10, cin)).astype(np.float32)
    in_scale = np.float32(np.abs(x).max() / 127.0)
    jx = jb.TorchConvTranspose(features=cout, kernel_size=kernel, strides=stride,
                               padding=pad)
    params = jx.init(jax.random.PRNGKey(1), x)["params"]
    with jq.quantization("int8"):
        want = np.asarray(jx.apply({"params": params, "quant": {"in_scale": in_scale}}, x))
    tx = tb.TorchConvTranspose(cin, cout, kernel, stride, pad)
    with torch.no_grad():
        tx.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.asarray(params["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))))
    tx.quantize(float(in_scale))
    assert tx.int8_taps is None
    launches = tconv.conv3x3_i8_fused.launches
    with torch.no_grad():
        got = nhwc(tx(nchw(x)))
    assert tconv.conv3x3_i8_fused.launches == launches
    np.testing.assert_array_equal(got, want)


# (shape, cout, stride_w): odd W and H, stride 2 at even and odd W.
FUSED_CASES = [
    ((1, 5, 33, 32), 24, 1),
    ((2, 4, 18, 32), 16, 2),
    ((1, 3, 21, 64), 32, 2),
]


def _activation(kind, shape, dtype, rng):
    """(x as numpy fp32 holding ``dtype`` values, in_scale)."""
    if kind == "ties":
        # Multiples of s/2 for s = 2^-6: every other value is a .5 tie of
        # x / s, and |x / s| reaches 150 (clamped to 127).
        s = np.float32(2.0**-6)
        x = rng.integers(-300, 301, size=shape).astype(np.float32) * (s / 2)
    else:
        x = rng.normal(size=shape).astype(np.float32) * 3
        s = np.float32(np.abs(x).max() / 127.0 * 0.8)  # the top 20% clamps
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    return x, s


@pytest.mark.parametrize("kind", ["ties", "randn"])
@pytest.mark.parametrize("in_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,cout,stride_w", FUSED_CASES)
def test_k3_in_scale_form_matches_quantize_and_jax(shape, cout, stride_w, in_dtype, kind):
    rng = np.random.default_rng(5)
    B, H, W, Cin = shape
    x, s = _activation(kind, shape, in_dtype, rng)
    w = rng.integers(-127, 128, size=(3, 3, Cin, cout), dtype=np.int8)
    dq = rng.uniform(1e-3, 2e-2, size=(cout,)).astype(np.float32)
    out_dtype = "float32" if kind == "ties" else "bfloat16"
    tdt = getattr(torch, out_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, in_dtype))
    tw, tdq = torch.from_numpy(w.reshape(9, Cin, cout)), torch.from_numpy(dq)
    launches = tconv.conv3x3_i8_fused.launches
    got = tconv.conv3x3_i8_fused(
        tx, tw, tdq, stride_w=stride_w, out_dtype=tdt, in_scale=torch.tensor(s)
    )
    assert tconv.conv3x3_i8_fused.launches == launches  # CPU: the twin
    assert got.dtype == tdt
    xq = tconv.quantize_to_int8(tx, torch.tensor(s))
    want = tconv.conv3x3_i8_fused(xq, tw, tdq, stride_w=stride_w, out_dtype=tdt)
    assert torch.equal(got, want)
    # The JAX Int8Conv formula, then its Pallas kernel (interpret) or lax.
    jdt = jnp.dtype(out_dtype)
    jx = jnp.asarray(x).astype(jnp.dtype(in_dtype))
    jxq = jnp.clip(jnp.round(jx.astype(jnp.float32) / s), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    if stride_w == 1 or W % 2 == 0:
        ref = conv3x3_i8_fused(
            jxq, jnp.asarray(w).reshape(9, Cin, cout), jnp.asarray(dq),
            stride_w=stride_w, out_dtype=jdt, interpret=True,
        )
    else:  # the Pallas kernel takes even widths at stride 2
        ref = _lax_ref(jxq, jnp.asarray(w), jnp.asarray(dq), stride_w).astype(jdt)
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(ref).astype(np.float32)
    )


def _recording(monkeypatch):
    """Record K3's calls and the torch quantize passes on activations."""
    calls = {"k3": [], "quantize": 0}
    k3, quantize = tconv.conv3x3_i8_fused, tq.quantize_to_int8

    def fused(x, w, dq, **kw):
        calls["k3"].append((x, kw))
        return k3(x, w, dq, **kw)

    def counted(x, scale):
        calls["quantize"] += 1
        return quantize(x, scale)

    for mod in (tq, tb):
        monkeypatch.setattr(mod, "conv3x3_i8_fused", fused)
        monkeypatch.setattr(mod, "quantize_to_int8", counted)
    return calls


CALL_CASES = {
    "3x3_s11": lambda: tb.ConvNormAct(32, 16, (3, 3), (1, 1)),
    "3x3_s12": lambda: tb.ConvNormAct(32, 16, (3, 3), (1, 2)),
    "deconv_s2": lambda: tb.TorchConvTranspose(32, 8, (3, 4), (1, 2), (1, 1)),
    "deconv_s4": lambda: tb.TorchConvTranspose(32, 8, (3, 8), (1, 4), (1, 2)),
    "1x1_s11": lambda: tb.ConvNormAct(32, 16, (1, 1), (1, 1)),
}


@pytest.mark.parametrize("case", sorted(CALL_CASES))
def test_int8_blocks_hand_k3_the_unquantized_activation(case, monkeypatch):
    torch.manual_seed(0)
    module = CALL_CASES[case]().eval()
    module.quantize(0.02)  # weights quantize here, before recording
    calls = _recording(monkeypatch)
    x = torch.randn(2, 32, 5, 12).to(memory_format=torch.channels_last)
    with torch.no_grad():
        module(x)
    if case.startswith("1x1"):  # the matmul route quantizes in torch ops
        assert calls["k3"] == [] and calls["quantize"] == 1
        return
    assert calls["quantize"] == 0
    [(xk, kw)] = calls["k3"]
    assert xk.dtype == torch.float32 and xk.is_contiguous()  # NHWC, no copy
    torch.testing.assert_close(xk, x.permute(0, 2, 3, 1), rtol=0, atol=0)
    assert float(kw["in_scale"]) == np.float32(0.02)
