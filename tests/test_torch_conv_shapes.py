"""Every conv shape the JAX blocks serve, in the port, on the CPU.

The JAX ``ConvNormAct`` takes any kernel (an even one padded ``(k-1)//2``
low and the rest high, at any stride), its ``Int8Conv`` any kernel,
stride, padding and bias, and its ``TorchConvTranspose`` any shape on
int8 operands (``lhs_dilation``). The port holds each against it, from
numpy-seeded inputs and flax weights transplanted by ``transplant.py``,
at small widths (C <= 16, H <= 8, W <= 32):

- fp32 ``ConvNormAct`` with kernels (4, 4), (2, 4) and (4, 3) at strides
  (1, 1), (2, 2) and (1, 2): the eval forward within 1e-5 of max|ref|;
  the train-mode forward within 1e-5 of max|ref| and its gradients
  against ``jax.grad`` within ``1e-3 * max|g_leaf| + 1e-7``
  (``test_torch_train_step.py``'s port-against-JAX tolerance);
- QAT at (4, 4), train and eval, stride 1 and 2: ``test_torch_qat.py``'s
  tolerances (outputs 1e-5 of max|ref|, weight gradient 1e-4 of max|g|);
- int8 ``Int8Conv``: a biased 5x5, a 3x3 at height stride 2, a (4, 4) and
  a strided 1x1, in fp32 and bf16, bit for bit against JAX under
  ``quantization("int8")`` (integer sums are exact; the dequantize and
  the bias follow JAX's order);
- int8 transposed convs (5, 8)/(1, 4)/(2, 2), (3, 3)/(2, 2)/(1, 1),
  (4, 4)/(2, 2)/(1, 1) and (1, 3)/(1, 2)/(1, 1) (a negative padding:
  the dilated input is cropped), with and without bias, in fp32 and
  bf16: bit for bit; the bias carried across by ``transplant.py`` in both
  directions;
- the served shapes keep their routes (K3 for the 3x3 convs and the
  aggregation deconvs' phase decomposition, one int8 product for the
  1x1 convs, never the im2col of another shape) and equal JAX bit for
  bit;
- the tiny detector (``tests/test_model.py::tiny_config``) with (4, 4)
  head towers and a 2x2 final conv, with the META stem and with the BASIC
  stem at ``projection_kernel_size=2``: fp32 heads within 1e-4
  (``test_torch_detector.py``'s tiny tolerance); int8 with one JAX quant
  tree (calibrated by JAX on its folded model): every int8 conv and
  transposed conv of the JAX forward, given the input JAX gave it,
  returns JAX's output bit for bit, and the heads are within a relative
  RMS of 1e-3 (``test_torch_quantized.py``'s: fp32 noise upstream can
  move an operand across a rounding boundary).
"""

from __future__ import annotations

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch import transplant
from range_view_3d_detection_torch.export import _detector_config_from_meta
from range_view_3d_detection_torch.models import blocks as tb
from range_view_3d_detection_torch.models import quantized as tq
from range_view_3d_detection_torch.models.detector import Detector as TDetector
from range_view_3d_detection_tpu.models import blocks as jb
from range_view_3d_detection_tpu.models import quantized as jq
from range_view_3d_detection_tpu.models.detector import Detector
from test_model import tiny_batch, tiny_config
from test_torch_blocks import nchw, nhwc, numpy_tree, randomize_bn
from test_torch_qat import _qat_pair
from test_torch_train_step import assert_trees_close
from tools.export import fold_batch_norms as jax_fold

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def host(t: torch.Tensor) -> np.ndarray:
    """NCHW tensor -> NHWC fp32 numpy (bf16 values are exact in fp32)."""
    return nhwc(t.float())


def close_to_max(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


# -- fp32 ConvNormAct with even kernels ----------------------------------------------

EVEN = [(k, s) for k in ((4, 4), (2, 4), (4, 3)) for s in ((1, 1), (2, 2), (1, 2))]


@pytest.mark.parametrize("kernel,strides", EVEN,
                         ids=[f"k{k[0]}{k[1]}-s{s[0]}{s[1]}" for k, s in EVEN])
def test_even_kernel_conv_norm_act_matches_flax(kernel, strides):
    cin, features = 6, 8
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 8, 20, cin)).astype(np.float32)
    jx = jb.ConvNormAct(features, kernel_size=kernel, strides=strides)
    v = jx.init(jax.random.PRNGKey(0), x)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=1)
    tx = tb.ConvNormAct(cin, features, kernel, strides)
    transplant.load_flax_variables(tx, params, stats)

    want = jx.apply({"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        got = nhwc(tx.eval()(nchw(x)))
    close_to_max(got, want, 1e-5, "eval")

    out_shape = np.asarray(want).shape
    proj = rng.normal(size=out_shape).astype(np.float32)

    def jax_loss(p):
        y, _ = jx.apply({"params": p, "batch_stats": stats}, x, train=True,
                        mutable=["batch_stats"])
        return (y * proj).sum(), y

    (_, want_train), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    tx.train()
    y = tx(nchw(x).contiguous(memory_format=torch.channels_last))
    names, ps = zip(*tx.named_parameters())
    grads = torch.autograd.grad((y * nchw(proj)).sum(), ps)
    close_to_max(nhwc(y), want_train, 1e-5, "train forward")
    got_grads, _ = transplant.state_dict_to_flax(dict(zip(names, grads)))
    assert_trees_close(got_grads, numpy_tree(jgrads), 1e-3, 1e-7, "grads")


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("strides", [(1, 1), (1, 2)])
def test_even_kernel_qat_matches_flax(strides, train):
    got, want, g, jg = _qat_pair(
        jb.ConvNormAct(8, kernel_size=(4, 4), strides=strides),
        tb.ConvNormAct(6, 8, (4, 4), strides), [(2, 6, 16, 6)], train,
    )
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    g = g.permute(2, 3, 1, 0).numpy()  # torch (O, I, kh, kw) -> flax HWIO
    assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()


# -- int8 Int8Conv of any shape ------------------------------------------------------

# name: (kernel, strides, use_bias, cin, route)
INT8_CONVS = {
    "5x5_bias": ((5, 5), (1, 1), True, 6, "general"),
    "3x3_s21": ((3, 3), (2, 1), False, 16, "general"),
    "4x4": ((4, 4), (1, 1), False, 5, "general"),
    "1x1_s22": ((1, 1), (2, 2), False, 5, "matmul"),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(INT8_CONVS))
def test_int8_conv_any_shape_matches_flax(case, dtype):
    kernel, strides, use_bias, cin, route = INT8_CONVS[case]
    jdt, tdt = DTYPES[dtype]
    features = 16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 19, cin)).astype(np.float32)
    in_scale = np.float32(0.8 * np.abs(x).max() / 127.0)  # the clamp binds too
    jx = jb.ConvNormAct(features, kernel_size=kernel, strides=strides, use_bias=use_bias,
                        dtype=jdt)
    v = jx.init(jax.random.PRNGKey(0), x)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=4)
    if use_bias:
        params["Conv_0"]["bias"] = rng.normal(size=features).astype(np.float32)
    variables = {"params": params, "batch_stats": stats, "quant": {"in_scale": in_scale}}
    with jq.quantization("int8"):
        want, inter = jx.apply(variables, x, capture_intermediates=True)
    want_conv = np.asarray(inter["intermediates"]["Conv_0"]["__call__"][0], np.float32)

    tx = tb.ConvNormAct(cin, features, kernel, strides, use_bias=use_bias, dtype=tdt)
    transplant.load_flax_variables(tx.eval(), params, stats)
    tx.quantize(float(in_scale))
    assert tx.int8.route == route
    with torch.no_grad():
        got_conv = host(tx.int8(nchw(x)))
        got = host(tx(nchw(x)))
    np.testing.assert_array_equal(got_conv, want_conv)
    if dtype == "f32":
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    else:
        assert got.shape == np.asarray(want).shape


# -- int8 transposed convs of any shape ----------------------------------------------

DECONVS = {
    "k58_s14_p22": ((5, 8), (1, 4), (2, 2)),
    "k33_s22_p11": ((3, 3), (2, 2), (1, 1)),
    "k44_s22_p11": ((4, 4), (2, 2), (1, 1)),
    "k13_s12_p11": ((1, 3), (1, 2), (1, 1)),  # kh-1-ph = -1: a crop
}


class _Holder(torch.nn.Module):
    """A parent scope, so that ``transplant.py`` sees the module's flax name."""

    def __init__(self, m: torch.nn.Module):
        super().__init__()
        self.TorchConvTranspose_0 = m


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", sorted(DECONVS))
def test_int8_deconv_any_shape_matches_flax(case, use_bias, dtype, monkeypatch):
    monkeypatch.delenv("RV3D_DECONV_PHASE", raising=False)
    kernel, strides, pad = DECONVS[case]
    jdt, tdt = DTYPES[dtype]
    cin, cout = 6, 5
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 9, cin)).astype(np.float32)
    in_scale = np.float32(0.8 * np.abs(x).max() / 127.0)
    jx = jb.TorchConvTranspose(features=cout, kernel_size=kernel, strides=strides,
                               padding=pad, use_bias=use_bias, dtype=jdt)
    params = numpy_tree(jx.init(jax.random.PRNGKey(2), x)["params"])
    if use_bias:
        params["bias"] = rng.normal(size=cout).astype(np.float32)
    with jq.quantization("int8"):
        want = np.asarray(
            jx.apply({"params": params, "quant": {"in_scale": in_scale}}, x), np.float32
        )

    tx = tb.TorchConvTranspose(cin, cout, kernel, strides, pad, dtype=tdt,
                               use_bias=use_bias)
    holder = _Holder(tx)
    transplant.load_flax_variables(holder, {"TorchConvTranspose_0": params}, {})
    back, _ = transplant.state_dict_to_flax(holder.state_dict())
    assert sorted(back["TorchConvTranspose_0"]) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back["TorchConvTranspose_0"][k], v)
    tx.quantize(float(in_scale))
    assert tx.int8_taps is None  # no phase decomposition: the general route
    with torch.no_grad():
        got = host(tx(nchw(x)))
    np.testing.assert_array_equal(got, want)


def test_deconv_bias_fp_matches_flax():
    """The fp transposed conv with a bias, in bf16: the bias added in the
    compute dtype after the conv, as JAX adds it."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 8, 6)).astype(np.float32)
    jx = jb.TorchConvTranspose(features=5, kernel_size=(3, 8), strides=(1, 4),
                               padding=(1, 2), use_bias=True, dtype=jnp.bfloat16)
    params = numpy_tree(jx.init(jax.random.PRNGKey(0), x)["params"])
    params["bias"] = rng.normal(size=5).astype(np.float32)
    want = np.asarray(jx.apply({"params": params}, x), np.float32)
    tx = tb.TorchConvTranspose(6, 5, (3, 8), (1, 4), (1, 2), dtype=torch.bfloat16,
                               use_bias=True)
    transplant.load_flax_variables(_Holder(tx), {"TorchConvTranspose_0": params}, {})
    with torch.no_grad():
        got = host(tx(nchw(x)))
    # bf16 operands; fp32 sums in another order, then two bf16 roundings.
    close_to_max(got, want, 2e-2)
    np.testing.assert_array_equal(got, got.astype(ml_dtypes.bfloat16).astype(np.float32))


# -- the served shapes keep their routes ---------------------------------------------

# name: (kind, kernel, strides, padding)
SERVED = {
    "conv3x3_s11": ("conv", (3, 3), (1, 1), None),
    "conv3x3_s12": ("conv", (3, 3), (1, 2), None),
    "conv1x1_s11": ("conv", (1, 1), (1, 1), None),
    "conv1x1_s12": ("conv", (1, 1), (1, 2), None),
    "deconv_k38_s14_p12": ("deconv", (3, 8), (1, 4), (1, 2)),
    "deconv_k34_s12_p11": ("deconv", (3, 4), (1, 2), (1, 1)),
}


@pytest.mark.parametrize("case", sorted(SERVED))
def test_served_shapes_keep_their_routes(case, monkeypatch):
    monkeypatch.delenv("RV3D_DECONV_PHASE", raising=False)
    kind, kernel, strides, pad = SERVED[case]
    calls = {"k3": 0, "general": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            if name == "general":  # the 1x1 route's one product, or an im2col
                one = tuple(a[3]) == (1, 1) and a[5] == ((0, 0), (0, 0)) and not kw
                name_ = "product" if one else name
            else:
                name_ = name
            calls[name_] = calls.get(name_, 0) + 1
            return fn(*a, **kw)
        return wrapped

    k3 = spy("k3", tq.conv3x3_i8_fused)
    general = spy("general", tq.int8_conv_nhwc)
    for mod in (tb, tq):
        monkeypatch.setattr(mod, "conv3x3_i8_fused", k3)
        monkeypatch.setattr(mod, "int8_conv_nhwc", general)
    cin, cout = 16, 8
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 16, cin)).astype(np.float32)
    in_scale = np.float32(np.abs(x).max() / 127.0)
    if kind == "conv":
        jx = jb.ConvNormAct(cout, kernel_size=kernel, strides=strides)
        v = jx.init(jax.random.PRNGKey(0), x)
        params, stats = randomize_bn(v["params"], v["batch_stats"], seed=2)
        with jq.quantization("int8"):
            _, inter = jx.apply({"params": params, "batch_stats": stats,
                                 "quant": {"in_scale": in_scale}}, x,
                                capture_intermediates=True)
        want = np.asarray(inter["intermediates"]["Conv_0"]["__call__"][0])
        tx = tb.ConvNormAct(cin, cout, kernel, strides)
        transplant.load_flax_variables(tx.eval(), params, stats)
        tx.quantize(float(in_scale))
        assert tx.int8.route == ("k3" if kernel == (3, 3) else "matmul")
        assert hasattr(tx.int8, "w_taps") == (kernel == (3, 3))
        run = tx.int8
    else:
        jx = jb.TorchConvTranspose(features=cout, kernel_size=kernel, strides=strides,
                                   padding=pad)
        params = numpy_tree(jx.init(jax.random.PRNGKey(1), x)["params"])
        with jq.quantization("int8"):
            want = np.asarray(jx.apply({"params": params, "quant": {"in_scale": in_scale}},
                                       x))
        tx = tb.TorchConvTranspose(cin, cout, kernel, strides, pad)
        transplant.load_flax_variables(_Holder(tx), {"TorchConvTranspose_0": params}, {})
        tx.quantize(float(in_scale))
        sw = strides[1]
        assert tuple(tx.int8_taps.shape) == (9, cin, sw * cout)
        assert tuple(tx.int8_dq.shape) == (sw * cout,)
        run = tx
    with torch.no_grad():
        got = host(run(nchw(x)))
    np.testing.assert_array_equal(got, want)
    k3_shape = kernel == (3, 3) or kind == "deconv"
    want = {"k3": int(k3_shape), "general": 0, **({} if k3_shape else {"product": 1})}
    assert calls == want, calls


# -- the tiny detector with even kernels ----------------------------------------------

DETECTORS = {
    "META": dict(stem_type="META"),
    "BASIC_pk2": dict(stem_type="BASIC", projection_kernel_size=2),
}


@pytest.fixture(scope="module", params=sorted(DETECTORS))
def even_detector(request):
    jcfg = tiny_config(fpn_kernel_sizes=((1, (4, 4)),), final_kernel_size=2,
                       **DETECTORS[request.param])
    batch = tiny_batch(B=2)
    args = tuple(jnp.asarray(batch[k]) for k in ("features", "cart", "mask"))
    model = Detector(jcfg)
    v = model.init(jax.random.PRNGKey(0), *args, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=5)
    variables = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
    ref = model.apply(variables, *args, train=False)
    tmodel = TDetector(_detector_config_from_meta(dataclasses.asdict(jcfg)), device="cpu")
    transplant.load_flax_variables(tmodel.eval(), params, stats)
    return dict(name=request.param, model=model, args=args, params=params, stats=stats,
                ref=ref, tmodel=tmodel)


def _port_heads(tmodel, args):
    with torch.inference_mode():
        return tmodel(*(torch.from_numpy(np.array(a)) for a in args))["head"][1][0]


def test_even_kernel_detector_fp32_matches_flax(even_detector):
    d = even_detector
    got = _port_heads(d["tmodel"], d["args"])
    for key in ("logits", "regressands"):
        want = np.asarray(d["ref"]["head"][1][0][key])
        assert got[key].shape == want.shape
        np.testing.assert_allclose(got[key].numpy(), want, atol=1e-4, rtol=1e-4)


def test_even_kernel_detector_int8_matches_flax(even_detector):
    d = even_detector
    folded = numpy_tree(jax_fold({"params": d["params"], "batch_stats": d["stats"]}))
    qtree = jq.calibrate_scales(d["model"], folded, [tuple(np.asarray(a) for a in d["args"])])
    calls = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        m = context.module
        if context.method_name == "__call__" and isinstance(
            m, (jq.Int8Conv, jb.TorchConvTranspose)
        ):
            calls.append((m.scope.path, np.asarray(args[0], np.float32),
                          np.asarray(out, np.float32)))
        return out

    with jq.quantization("int8"), fnn.intercept_methods(record):
        want = d["model"].apply({**folded, "quant": qtree}, *d["args"],
                                train=False)["head"][1][0]
    tmodel = TDetector(d["tmodel"].config, device="cpu")
    transplant.load_flax_variables(tmodel.eval(), folded["params"], folded["batch_stats"])
    tq.quantize_model(tmodel, qtree)
    routes = {}
    with torch.no_grad():
        for path, x, out in calls:
            if path[-1] == "Conv_0":  # an Int8Conv: its ConvNormAct's int8 twin
                run = tmodel.get_submodule(".".join(path[:-1])).int8
                routes[run.route] = routes.get(run.route, 0) + 1
            else:
                run = tmodel.get_submodule(".".join(path))
            np.testing.assert_array_equal(host(run(nchw(x))), out, err_msg="/".join(path))
    n_towers = 2 * 2  # (cls, reg) x 2 blocks, all (4, 4)
    assert routes.get("general", 0) >= n_towers + (2 if d["name"] == "BASIC_pk2" else 0)
    assert routes.get("k3", 0) > 0 and routes.get("matmul", 0) > 0, routes
    got = _port_heads(tmodel, d["args"])
    for key in ("logits", "regressands"):
        w = np.asarray(want[key])
        rel_rms = np.sqrt(np.mean((got[key].numpy() - w) ** 2) / np.mean(w**2))
        assert rel_rms < 1e-3, (key, rel_rms)
