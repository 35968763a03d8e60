"""The port's eval BatchNorm epilogue against flax's BatchNorm, CPU.

flax computes ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32,
and jitted XLA emits the last two steps as one fused multiply-add. The
port's ``blocks.BatchNorm`` computes ``addcmul(bias, x - mean, mul)``
(one fused multiply-add on the CPU and the card).

- Given flax's own ``mul``, the port's fp32 output equals jitted flax
  ``nn.BatchNorm`` bit for bit, for fp32 and bf16 inputs, and so does the
  bf16 cast and ReLU after it.
- With the port's own ``mul`` (the rsqrt correctly rounded through fp64),
  outputs differ only in channels whose ``mul`` differs from XLA's: XLA's
  CPU ``rsqrt`` is not correctly rounded, and that residual is all that
  is left.
- The cached ``mul`` follows in-place writes of the statistics, as
  ``fold_batch_norms`` makes them; train mode is ``BatchNorm2d``'s own.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.models import blocks
from range_view_3d_detection_torch.models.quantized import fold_batch_norms

B, H, W, C = 2, 16, 40, 128
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, H, W, C)) * 3).astype(np.float32)
    stats = dict(
        mean=(rng.normal(size=C) * 0.1).astype(np.float32),
        var=rng.uniform(0.05, 2.0, C).astype(np.float32),
    )
    params = dict(
        scale=rng.normal(size=C).astype(np.float32),
        bias=rng.normal(size=C).astype(np.float32),
    )
    return x, params, stats


def _flax(x, params, stats, jdt):
    """Jitted flax eval BatchNorm (fp32, as the JAX blocks run it) on
    ``x`` cast to ``jdt``, and XLA's own ``mul`` for the same statistics."""
    bn = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.float32, param_dtype=jnp.float32)
    v = {"params": jax.tree.map(jnp.asarray, params),
         "batch_stats": jax.tree.map(jnp.asarray, stats)}
    xj = jnp.asarray(x).astype(jdt)
    out = np.asarray(jax.jit(bn.apply)(v, xj))
    mul = jax.jit(lambda var, s: jax.lax.rsqrt(var + 1e-5) * s)(
        jnp.asarray(stats["var"]), jnp.asarray(params["scale"]))
    xt = np.array(xj.astype(jnp.float32))
    return xt, out, np.array(mul)


def _port_bn(params, stats):
    bn = blocks.BatchNorm(C).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    return bn


def _nchw(x, tdt):
    t = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    return t.contiguous(memory_format=torch.channels_last)


def _run(bn, x, tdt, dtype=torch.float32, act=False):
    with torch.no_grad():
        out = bn(_nchw(x, tdt), dtype, act)
    return out.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_epilogue_with_flax_mul_equals_jitted_flax(dt, monkeypatch):
    jdt, tdt = DTYPES[dt]
    x, params, stats = _case(0)
    xt, want, mul = _flax(x, params, stats, jdt)
    bn = _port_bn(params, stats)
    monkeypatch.setattr(bn, "eval_mul", lambda: torch.from_numpy(mul))
    got = _run(bn, xt, tdt)
    assert (got != want).sum() == 0
    # The cast and the ReLU after it: bf16, as the blocks serve it.
    got_bf16 = _run(bn, xt, tdt, torch.bfloat16, act=True)
    want_bf16 = np.asarray(jax.nn.relu(jnp.asarray(want).astype(jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(got_bf16, want_bf16)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_epilogue_differs_only_where_xla_rsqrt_does(dt):
    jdt, tdt = DTYPES[dt]
    x, params, stats = _case(1)
    xt, want, mul_xla = _flax(x, params, stats, jdt)
    bn = _port_bn(params, stats)
    mul = bn.eval_mul().numpy()
    # The port's factor: the correctly rounded fp32 rsqrt, times scale.
    var_eps = torch.from_numpy(stats["var"]) + 1e-5
    exact = (1.0 / np.sqrt(var_eps.double().numpy())).astype(np.float32)
    np.testing.assert_array_equal(mul, exact * params["scale"])
    same = mul == mul_xla
    assert 0 < same.sum() < C  # both kinds of channel are present
    differs = _run(bn, xt, tdt) != want
    assert not differs[..., same].any()
    assert differs[..., ~same].any()


def test_eval_mul_follows_in_place_writes():
    x, params, stats = _case(2)
    bn = _port_bn(params, stats)
    before = bn.eval_mul().clone()
    assert bn.eval_mul() is bn.eval_mul()  # cached
    fold_batch_norms(bn)  # in-place: weight <- mul, var <- 1 - eps
    after = bn.eval_mul()
    assert not torch.equal(after, before)
    # On the folded statistics rsqrt(var + eps) is 1, so mul is the weight.
    torch.testing.assert_close(after, bn.weight.detach(), rtol=0, atol=0)


def test_train_mode_is_batchnorm2d():
    x, params, stats = _case(3)
    bn = _port_bn(params, stats).train()
    y = _nchw(x, torch.bfloat16)
    ref = _port_bn(params, stats).train()
    with torch.no_grad():
        got = bn(y, torch.bfloat16, act=True)
        want = torch.relu(ref(y.float()).to(torch.bfloat16))
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, ref.running_mean)
