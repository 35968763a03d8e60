"""Remat (``DetectorConfig.remat``) in the port, on the CPU.

The tiny config (``_flagship_config(tiny=True)``, fp32) on
``_dryrun_batch(cfg, 2, 8, 64, 5)``.

Held:

- two port train steps with remat over each ``remat_scope`` group alone
  (``stem``, ``stages``, ``heads``, ``loss``) and over all four equal the
  same steps without remat bit for bit: every metric, every gradient, the
  parameters and the running statistics after each step (a recompute
  that wrote the statistics again would apply the momentum twice);
- the state dict's keys do not depend on remat (the JAX
  ``test_remat_scope_matches_remat_off``);
- the port's remat step against the JAX ``make_train_step`` with
  ``remat=True``, two steps, with ``test_torch_train_step.py``'s
  tolerances (loss 1e-5 relative, ``grad_norm`` 1e-3, parameters within
  1e-5 of each leaf's max plus the AdamW sign-flip bound, running
  statistics 1e-4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from range_view_3d_detection_torch import serving, transplant
from range_view_3d_detection_torch.models.detector import Detector
from range_view_3d_detection_torch.training import optim as toptim
from range_view_3d_detection_torch.training import state as tstate
from range_view_3d_detection_tpu.training import optim as joptim
from range_view_3d_detection_tpu.training import state as jstate
from test_torch_train_step import _jax_state, assert_trees_close, make_setup, port_state

torch.set_num_threads(2)
SCOPES = {
    "stem": ("stem",),
    "stages": ("stages",),
    "heads": ("heads",),
    "loss": ("loss",),
    "all": ("stem", "stages", "heads", "loss"),
}


def _steps(cfg, batch, n=2):
    """``n`` port train steps from seed-0 weights: each step's metrics and
    gradients, and the final state dict."""
    tx = toptim.make_optimizer(1e-3, 20)[0]
    st = tstate.create_state(cfg, tx, device="cpu", generator=torch.Generator().manual_seed(0))
    step = tstate.make_train_step(cfg)
    out = []
    for _ in range(n):
        grads = []
        st, metrics = step(st, batch, grads_out=grads)
        out.append((metrics, grads, {k: v.clone() for k, v in st.model.state_dict().items()}))
    return out


@pytest.fixture(scope="module")
def plain():
    cfg = serving._flagship_config(tiny=True)
    batch = serving._dryrun_batch(cfg, 2, 8, 64, 5, seed=1)
    return cfg, batch, _steps(cfg, batch)


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_remat_step_equals_no_remat_bit_for_bit(plain, scope):
    cfg, batch, want = plain
    got = _steps(dataclasses.replace(cfg, remat=True, remat_scope=SCOPES[scope]), batch)
    for (gm, gg, gs), (wm, wg, ws) in zip(got, want):
        assert sorted(gm) == sorted(wm)
        for k in wm:
            assert torch.equal(gm[k], wm[k]), (scope, k)
        assert len(gg) == len(wg)
        for i, (a, b) in enumerate(zip(gg, wg)):
            assert torch.equal(a, b), (scope, "grad", i)
        assert list(gs) == list(ws)
        for k in ws:
            assert torch.equal(gs[k], ws[k]), (scope, k)


def test_remat_keeps_the_state_dict_keys():
    cfg = serving._flagship_config(tiny=True)
    off = Detector(cfg, device="cpu").state_dict()
    on = Detector(dataclasses.replace(cfg, remat=True), device="cpu").state_dict()
    assert list(off) == list(on)
    assert all(off[k].shape == on[k].shape for k in off)


def test_remat_steps_match_jax_remat():
    s = make_setup("float32")
    s["jcfg"] = dataclasses.replace(s["jcfg"], remat=True)
    s["tcfg"] = dataclasses.replace(s["tcfg"], remat=True)
    jtx, _ = joptim.make_optimizer(1e-3, 20)
    jstep = jstate.make_train_step(s["jcfg"], jtx)
    jst = _jax_state(s, jtx)
    st = port_state(s, toptim.make_optimizer(1e-3, 20)[0])
    step = tstate.make_train_step(s["tcfg"])
    for _ in range(2):
        jst, jm = jstep(jst, s["jb"])
        st, m = step(st, s["batch"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    params, stats = transplant.state_dict_to_flax(st.model.state_dict())
    moved = sum(toptim.onecycle_schedule(1e-3, 20)(t) for t in range(2))
    assert_trees_close(params, jst.params, 1e-5, 2.0 * moved, "params")
    assert_trees_close(stats, jst.batch_stats, 1e-4, what="batch_stats")
