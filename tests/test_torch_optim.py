"""Port parity for the optimizer: schedule, clip, AdamW, accumulation and
the optax state transplant, against optax on the CPU.

The parameters are a port ``ConvNormAct(3, 4)`` (a 3x3 conv kernel and a
BatchNorm scale and bias); optax sees the same values as a flax tree
(``state_dict_to_flax``), so the moments and accumulators go through the
transplant's layout conversion too. Both sides get the same seeded
gradients at every step, so the optimizer's arithmetic is held on its
own, apart from the model's gradients:

- the OneCycle schedule at every count of a 20-update run and past its
  end (its phase boundaries included): within 1e-6 relative;
- the clip at a global norm just under and just over 35: within 1e-6
  relative, the one unscaled and the other scaled;
- three AdamW updates (OneCycle, weight decay 0.01, the clip active on
  one of them): parameters and moments within 1e-5 of each leaf's max;
- accumulation over k = 2 micro-batches against ``optax.MultiSteps``:
  the same, after each of 4 micro-steps, with the accumulator and the
  counters;
- an optax state loaded into the port's optimizer and read back equal,
  and one more update from it on both sides within 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from range_view_3d_detection_torch import transplant
from range_view_3d_detection_torch.models.blocks import ConvNormAct
from range_view_3d_detection_torch.training import optim as toptim
from range_view_3d_detection_tpu.training import optim as joptim

torch.set_num_threads(2)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_close(got, want, rel, what=""):
    g, w = leaves(got), leaves(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= rel * float(np.abs(w[k]).max()) + 1e-12, (what, k, err)


def module(seed=0):
    m = ConvNormAct(3, 4)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return m


def names_of(m):
    return [n for n, _ in m.named_parameters()]


def grads_for(m, step, scale):
    gen = torch.Generator().manual_seed(100 + step)
    return [torch.randn(p.shape, generator=gen) * scale for p in m.parameters()]


def flax_tree(m, tensors):
    return jax.tree_util.tree_map(
        jnp.asarray, transplant.state_dict_to_flax(dict(zip(names_of(m), tensors)))[0]
    )


def port_params(m):
    return transplant.state_dict_to_flax(dict(m.named_parameters()))[0]


def test_schedule_matches_optax():
    _, want = joptim.make_optimizer(3e-3, 20)
    _, got = toptim.make_optimizer(3e-3, 20)
    bounds = (0, 6, 20)  # int(0.3 * 20): the peak
    for count in range(26):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, err_msg=count)
    assert got(bounds[1]) == pytest.approx(3e-3, rel=1e-6)
    assert got(bounds[2]) == pytest.approx(3e-3 / 25 / 1e4, rel=1e-6)
    assert got(0) == pytest.approx(3e-3 / 25, rel=1e-6)
    _, const = toptim.make_optimizer(3e-3, 20, debug=True)
    assert {const(c) for c in range(25)} == {3e-3}
    assert toptim.scaled_max_lr(1e-3, 4, 2, enable=True) == pytest.approx(
        joptim.scaled_max_lr(1e-3, 4, 2, enable=True)
    )


@pytest.mark.parametrize("norm", [34.99, 35.01], ids=["under", "over"])
def test_clip_matches_optax(norm):
    m = module()
    g = grads_for(m, 0, 1.0)
    total = float(toptim.global_norm(g))
    g = [x * (norm / total) for x in g]
    got = toptim.clip_by_global_norm(g, 35.0)
    want, _ = optax.clip_by_global_norm(35.0).update(flax_tree(m, g), optax.EmptyState())
    assert_trees_close(flax_tree(m, got), want, 1e-6, "clipped")
    scaled = not all(torch.equal(a, b) for a, b in zip(got, g))
    assert scaled == (norm > 35.0)
    np.testing.assert_allclose(float(toptim.global_norm(got)), min(norm, 35.0), rtol=1e-6)


def _run(accumulate, steps, scales):
    """``steps`` micro-steps of both optimizers on the same gradients."""
    m = module()
    jtx, _ = joptim.make_optimizer(1e-2, 10, accumulate_steps=accumulate)
    spec, _ = toptim.make_optimizer(1e-2, 10, accumulate_steps=accumulate)
    opt = spec.init(m.parameters())
    params = jax.tree_util.tree_map(jnp.asarray, port_params(m))
    state = jtx.init(params)
    history = []
    for t in range(steps):
        g = grads_for(m, t, scales[t])
        applied = opt.apply(g)
        updates, state = jtx.update(flax_tree(m, g), state, params)
        params = optax.apply_updates(params, updates)
        history.append((applied, port_params(m), params, state,
                        transplant.optax_state_of(m, opt)))
    return m, opt, history


def test_adamw_matches_optax():
    # The middle step's gradients have a global norm far above 35: clipped.
    _, opt, history = _run(1, 3, scales=(1.0, 40.0, 0.5))
    for applied, got, want, state, moments in history:
        assert applied
        assert_trees_close(got, want, 1e-5, "params")
        adam = state[1][0]
        assert_trees_close(moments["mu"], adam.mu, 1e-5, "mu")
        assert_trees_close(moments["nu"], adam.nu, 1e-5, "nu")
        assert moments["count"] == int(adam.count)
    assert opt.updates == 3


def test_accumulation_matches_multisteps():
    _, opt, history = _run(2, 4, scales=(1.0, 3.0, 40.0, 0.5))
    for t, (applied, got, want, state, moments) in enumerate(history):
        assert applied == (t % 2 == 1)
        assert_trees_close(got, want, 1e-5, f"params after micro-step {t}")
        assert moments["mini_step"] == int(state.mini_step)
        assert moments["gradient_step"] == int(state.gradient_step)
        assert_trees_close(moments["acc_grads"], state.acc_grads, 1e-6, "acc")
        adam = state.inner_opt_state[1][0]
        assert_trees_close(moments["mu"], adam.mu, 1e-5, "mu")
        assert_trees_close(moments["nu"], adam.nu, 1e-5, "nu")
    assert opt.updates == 2 and opt.mini_step == 0


def test_optax_state_transplants_both_ways():
    """Halfway through an accumulation (micro-step 3 of 2 x 2), the optax
    state loaded into a fresh port optimizer reads back equal, and the
    next micro-step (an update) agrees on both sides."""
    m, opt, history = _run(2, 3, scales=(1.0, 2.0, 0.7))
    _, _, params, state, _ = history[-1]
    fresh = module(seed=9)
    fresh.load_state_dict(
        transplant.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params), {}),
        strict=False,
    )
    spec, _ = toptim.make_optimizer(1e-2, 10, accumulate_steps=2)
    opt2 = spec.init(fresh.parameters())
    adam = state.inner_opt_state[1][0]
    transplant.load_optax_state(
        fresh, opt2, mu=adam.mu, nu=adam.nu, count=int(adam.count),
        acc_grads=state.acc_grads, mini_step=int(state.mini_step),
        gradient_step=int(state.gradient_step),
    )
    back = transplant.optax_state_of(fresh, opt2)
    for name, want in (("mu", adam.mu), ("nu", adam.nu), ("acc_grads", state.acc_grads)):
        assert_trees_close(back[name], want, 0.0, name)
    assert (back["count"], back["mini_step"], back["gradient_step"]) == (1, 1, 1)

    jtx, _ = joptim.make_optimizer(1e-2, 10, accumulate_steps=2)
    g = grads_for(m, 3, 1.0)
    assert opt2.apply(g)
    updates, state = jtx.update(flax_tree(fresh, g), state, params)
    assert_trees_close(port_params(fresh), optax.apply_updates(params, updates), 1e-5,
                       "params")
