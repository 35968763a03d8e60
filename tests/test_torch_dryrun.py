"""The port's dry run (``range_view_3d_detection_torch/dryrun.py``) on the
CPU: ``dryrun_multichip(2, device="cpu")`` runs its four phases as two
gloo ranks each (spawned processes that meet at a free localhost port),
every phase reports OK, and phase 1's loss, from the flax variables of the
JAX ``__graft_entry__._phase1_tiny_train(2)`` transplanted
(``create_state``'s init: ``PRNGKey(0)`` on the first row, train mode),
equals that function's loss within 1e-5 relative (the train-step
tolerance of ``test_torch_train_step.py``). The phase registry names the
phase functions; ``entry()`` gives the flagship on the device asked for
and refuses a host without a card by default.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from range_view_3d_detection_torch import dryrun
from range_view_3d_detection_torch.transplant import flax_to_state_dict
from range_view_3d_detection_tpu.models.detector import Detector


@pytest.fixture(scope="module")
def run():
    cfg = graft._flagship_config(tiny=True)
    batch = graft._dryrun_batch(cfg, 2, 8, 64, 5)
    variables = Detector(cfg).init(
        jax.random.PRNGKey(0), np.asarray(batch["features"])[:1],
        np.asarray(batch["cart"])[:1], np.asarray(batch["mask"])[:1], train=True)
    weights = {"_phase1_tiny_train": flax_to_state_dict(variables["params"],
                                                        variables["batch_stats"])}
    return dryrun.dryrun_multichip(2, device="cpu", weights=weights)


def test_every_phase_ok(run):
    assert sorted(run) == ["phase1", "phase2", "phase3", "phase4"]
    assert all(r["status"] == "ok" for r in run.values()), run
    assert run["phase2"]["result"]["shape"] == [2, 2, 64]
    assert np.isfinite(run["phase3"]["result"]) and run["phase4"]["result"] >= 0


def test_phase1_loss_matches_jax(run):
    want = graft._phase1_tiny_train(2)
    got = run["phase1"]["result"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_phase_registry_and_entry():
    for name in dryrun.DRYRUN_PHASES:
        assert callable(getattr(dryrun, name)), name
    model, (feats, cart, mask) = dryrun.entry("cpu")
    assert feats.shape == (1, 64, 1808, 5) and cart.shape == (1, 64, 1808, 3)
    assert model.config.stem_pallas and not model.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.entry()
