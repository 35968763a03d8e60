"""QAT (quantization-aware training) in the port against the JAX package,
fp32 on the CPU.

JAX side: ``models/quantized.py::fake_quant`` and the "qat" context
(``quantization("qat")``: ``QATConv`` in ``ConvNormAct``, the fake-quant
operands of ``TorchConvTranspose``), and ``training/state.py::
make_train_step(quant_tree=...)``.

Held:

- ``fake_quant``'s forward equals JAX's bit for bit on values at and
  around every rounding tie and beyond the clamp (``torch.round`` and
  ``jnp.round`` both round half to even), and its gradient is the
  straight-through identity, as JAX's (``tests/test_quantized.py::
  test_fake_quant_ste``'s oracle);
- ``qat_conv`` against the int8 conv on the same input and scales (JAX's
  ``test_qat_conv_matches_int8_conv``): within fp32 accumulation noise;
- a QAT ``ConvNormAct`` (train and eval mode; stride 1 and 2; a 1x1
  projection) and a QAT ``TorchConvTranspose`` (output channels on the
  weight's axis 1, tested on its own) against flax under
  ``quantization("qat")``: outputs within 1e-5 of max|ref|, the weight
  gradient of a seeded projection within 1e-4 of the leaf's max (the
  fake-quant of the same weight and input is the same grid; fp32 sums in
  another order);
- one QAT train step of the tiny config against JAX's
  ``make_train_step(quant_tree=...)`` with the quant tree JAX calibrates
  on the BatchNorm-folded model: loss within 1e-5 relative, ``grad_norm``
  within 1e-3, parameters within 1e-5 of each leaf's max plus AdamW's
  sign-flip bound, running statistics within 1e-4
  (``test_torch_train_step.py``'s tolerances); the blocks leave QAT
  after the step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import __graft_entry__ as graft
from range_view_3d_detection_torch import serving, transplant
from range_view_3d_detection_torch.models import blocks as tb
from range_view_3d_detection_torch.models import quantized as tq
from range_view_3d_detection_torch.training import optim as toptim
from range_view_3d_detection_torch.training import state as tstate
from range_view_3d_detection_tpu.models import blocks as jb
from range_view_3d_detection_tpu.models import quantized as jq
from range_view_3d_detection_tpu.models.detector import Detector
from range_view_3d_detection_tpu.training import optim as joptim
from range_view_3d_detection_tpu.training import state as jstate
from test_torch_blocks import nchw, nhwc, randomize_bn
from test_torch_train_step import assert_trees_close
from tools.export import fold_batch_norms as jax_fold

torch.set_num_threads(2)


def test_fake_quant_matches_jax():
    rng = np.random.default_rng(0)
    s = np.float32(0.1)
    ties = (np.arange(-130, 130) + 0.5).astype(np.float32) * s
    near = np.concatenate([np.nextafter(ties, np.inf), np.nextafter(ties, -np.inf)])
    x = np.concatenate([ties, near, rng.normal(0, 6, 4096).astype(np.float32),
                        np.float32([0.03, -0.549, 2.0, -200.0, 12.7, -12.75, 0.0])])
    want = np.asarray(jq.fake_quant(jnp.asarray(x), jnp.float32(s)))
    xt = torch.from_numpy(x).requires_grad_()
    got = tq.fake_quant(xt, torch.tensor(s))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    w = rng.normal(size=x.shape).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    g = jax.grad(lambda v: (jq.fake_quant(v, jnp.float32(s)) * w).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g))
    np.testing.assert_array_equal(xt.grad.numpy(), w)


def test_qat_conv_matches_int8_conv():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(16, 16, 3, 3)).astype(np.float32) * 0.2)
    x = torch.from_numpy(rng.normal(size=(1, 16, 8, 16)).astype(np.float32) * 2.0)
    s = torch.tensor(float(x.abs().max()) / 127.0)
    conv = torch.nn.Conv2d(16, 16, 3, padding=1, bias=False)
    conv.weight.data.copy_(w)
    want = tq.Int8Conv(conv, s, torch.float32)(x.contiguous(memory_format=torch.channels_last))
    got = tq.qat_conv(F.conv2d, x, w, None, s, 0, stride=(1, 1), padding=(1, 1))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _qat_pair(jx_module, tx_module, shapes, train, seed=0):
    """Outputs and weight gradients of the flax and torch modules under
    QAT, the input scale the input's absmax / 127 times 0.7 (so the clamp
    binds too)."""
    rng = np.random.default_rng(seed)
    inputs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    scale = np.float32(0.7 * np.abs(inputs[-1]).max() / 127.0)
    kw = {"train": train} if isinstance(jx_module, jb.ConvNormAct) else {}
    v = jx_module.init(jax.random.PRNGKey(seed), *inputs, **kw)
    params, stats = randomize_bn(v["params"], v.get("batch_stats", {}), seed + 1)
    quant = {"in_scale": scale}
    out_shape = jax.eval_shape(
        lambda p: jx_module.apply({"params": p, "batch_stats": stats}, *inputs, **kw,
                                  mutable=["batch_stats"])[0], params).shape
    proj = rng.normal(size=out_shape).astype(np.float32)

    def jax_fn(p):
        with jq.quantization("qat"):
            y, _ = jx_module.apply({"params": p, "batch_stats": stats, "quant": quant},
                                   *inputs, **kw, mutable=["batch_stats"])
        return (y * proj).sum(), y

    (_, want), jgrads = jax.value_and_grad(jax_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    if isinstance(tx_module, tb.TorchConvTranspose):
        # flax HWIO -> (I, O, kh, kw) flipped in space, as transplant.py maps it.
        k = torch.from_numpy(np.asarray(params["kernel"]))
        with torch.no_grad():
            tx_module.weight.copy_(k.permute(2, 3, 0, 1).flip(2, 3))
    else:
        transplant.load_flax_variables(tx_module, params, stats)
    tx_module.train(train)
    tx_module.set_qat(torch.tensor(scale))
    xs = [nchw(x).contiguous(memory_format=torch.channels_last) for x in inputs]
    got = tx_module(*xs)
    weight = tx_module.weight if isinstance(tx_module, tb.TorchConvTranspose) \
        else tx_module.Conv_0.weight
    (g,) = torch.autograd.grad((got * nchw(proj)).sum(), [weight])
    jg = jgrads["kernel"] if "kernel" in jgrads else jgrads["Conv_0"]["kernel"]
    return nhwc(got), np.asarray(want), g, np.asarray(jg)


CASES = {
    "conv3x3": (lambda: jb.ConvNormAct(8), lambda: tb.ConvNormAct(6, 8), [(2, 4, 16, 6)]),
    "conv3x3-s12": (lambda: jb.ConvNormAct(8, strides=(1, 2)),
                    lambda: tb.ConvNormAct(6, 8, (3, 3), (1, 2)), [(2, 4, 16, 6)]),
    "conv1x1-s12": (lambda: jb.ConvNormAct(8, kernel_size=(1, 1), strides=(1, 2), act=False),
                    lambda: tb.ConvNormAct(6, 8, (1, 1), (1, 2), act=False), [(2, 4, 16, 6)]),
}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_qat_conv_norm_act_matches_flax(case, train):
    jx, tx, shapes = CASES[case]
    got, want, g, jg = _qat_pair(jx(), tx(), shapes, train)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # torch (O, I, kh, kw) against flax HWIO.
    g = g.permute(2, 3, 1, 0).numpy()
    assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()


@pytest.mark.parametrize("k,s,p", [((3, 8), (1, 4), (1, 2)), ((3, 4), (1, 2), (1, 1))])
def test_qat_deconv_matches_flax(k, s, p):
    jx = jb.TorchConvTranspose(8, k, s, p)
    tx = tb.TorchConvTranspose(6, 8, k, s, p)
    got, want, g, jg = _qat_pair(jx, tx, [(2, 4, 8, 6)], train=True)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # torch (I, O, kh, kw), flipped in space, against flax HWIO.
    g = g.flip(2, 3).permute(2, 3, 0, 1).numpy()
    assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()
    tx.set_qat(None)
    plain = tx(nchw(np.zeros((2, 4, 8, 6), np.float32)))
    assert float(plain.abs().max()) == 0.0


def test_qat_train_step_matches_jax():
    jcfg = graft._flagship_config(tiny=True)
    tcfg = serving._flagship_config(tiny=True)
    batch = serving._dryrun_batch(tcfg, 2, 8, 64, 5, seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = Detector(jcfg)
    v = model.init(jax.random.PRNGKey(0), jbatch["features"][:1], jbatch["cart"][:1],
                   jbatch["mask"][:1], train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=1)
    # Running statistics equal to this batch's (as in a trained model), so
    # that the scales calibrated on the folded eval model fit the train
    # forward's activations. With random running statistics the scales
    # miss them by orders of magnitude, whole activations quantize to
    # zero, and the BatchNorms over them (variance 0, gain 1/sqrt(eps))
    # overflow the gradients to inf and nan, in JAX as in the port.
    _, mut = model.apply({"params": params, "batch_stats": stats}, jbatch["features"],
                         jbatch["cart"], jbatch["mask"], train=True, mutable=["batch_stats"])
    stats = jax.tree_util.tree_map(
        lambda new, old: np.asarray((np.asarray(new) - 0.9 * old) / 0.1, np.float32),
        mut["batch_stats"], stats)
    folded = jax.tree_util.tree_map(
        lambda x: np.array(x, np.float32), jax_fold({"params": params, "batch_stats": stats}))
    qtree = jax.tree_util.tree_map(np.asarray, jq.calibrate_scales(
        model, folded, [(batch["features"], batch["cart"], batch["mask"])]))

    jtx, _ = joptim.make_optimizer(1e-3, 20)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                            opt_state=jtx.init(jparams))
    jst, jm = jstate.make_train_step(jcfg, jtx, quant_tree=qtree)(jst, jbatch)

    st = tstate.create_state(tcfg, toptim.make_optimizer(1e-3, 20)[0], device="cpu")
    transplant.load_flax_variables(st.model, params, stats)
    st, m = tstate.make_train_step(tcfg, quant_tree=qtree)(st, batch)
    assert np.isfinite(float(jm["grad_norm"]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    got_params, got_stats = transplant.state_dict_to_flax(st.model.state_dict())
    lr0 = toptim.onecycle_schedule(1e-3, 20)(0)
    assert_trees_close(got_params, jst.params, 1e-5, 2.0 * lr0, "params")
    assert_trees_close(got_stats, jst.batch_stats, 1e-4, what="batch_stats")
    # The step ran QAT (its loss is not the fp step's) and left it.
    fp = tstate.create_state(tcfg, toptim.make_optimizer(1e-3, 20)[0], device="cpu")
    transplant.load_flax_variables(fp.model, params, stats)
    _, fm = tstate.make_train_step(tcfg)(fp, batch)
    assert float(fm["loss"]) != float(m["loss"])
    assert all(getattr(mod, "qat_scale", None) is None for mod in st.model.modules())
