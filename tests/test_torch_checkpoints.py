"""The port's checkpoints, on the CPU: round trip, keep-N rotation and
``latest_step`` (beside the JAX package's orbax manager on the same
sequence of saves), and exact resumption: 2 steps equal 1 step, save,
restore into a fresh state, 1 step, bit for bit, with and without
gradient accumulation (the accumulator saved half full).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.training import optim as toptim
from range_view_3d_detection_torch.training import state as tstate
from range_view_3d_detection_torch.training.checkpoints import CheckpointManager
from range_view_3d_detection_tpu.training import optim as joptim
from range_view_3d_detection_tpu.training import state as jstate
from range_view_3d_detection_tpu.training.checkpoints import (
    CheckpointManager as JCheckpointManager,
)

torch.set_num_threads(2)
CFG = serving._flagship_config(tiny=True)
BATCH = serving._dryrun_batch(CFG, 2, 8, 64, 5)


def fresh_state(accumulate=1, seed=0):
    tx, _ = toptim.make_optimizer(1e-3, 10, accumulate_steps=accumulate)
    return tstate.create_state(CFG, tx, device="cpu",
                               generator=torch.Generator().manual_seed(seed))


def assert_states_equal(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.opt.state_dict(), b.opt.state_dict()
    assert (oa["updates"], oa["mini_step"]) == (ob["updates"], ob["mini_step"])
    assert (oa["acc"] is None) == (ob["acc"] is None)
    for x, y in zip(oa["acc"] or [], ob["acc"] or []):
        assert torch.equal(x, y)
    assert oa["adamw"]["param_groups"] == ob["adamw"]["param_groups"]
    assert sorted(oa["adamw"]["state"]) == sorted(ob["adamw"]["state"])
    for i, st in oa["adamw"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["adamw"]["state"][i][k]), (i, k)


def test_round_trip(tmp_path):
    st = fresh_state()
    st, _ = tstate.make_train_step(CFG)(st, BATCH)
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() is None
    mgr.save(1, st, {"run": "round-trip", "lr": 1e-3})
    mgr.wait()
    restored, config = mgr.restore(fresh_state(seed=5))
    mgr.close()
    assert config == {"run": "round-trip", "lr": 1e-3}
    assert_states_equal(restored, st)


def test_rotation_and_latest_step_match_orbax(tmp_path):
    """keep=2 over saves at steps 1, 2, 3: both managers keep 2 and 3."""
    st = fresh_state()
    mgr = CheckpointManager(tmp_path / "port", keep=2)
    jtx, _ = joptim.make_optimizer(1e-3, 10)
    jst = jstate.TrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                            params={"w": np.zeros(3, np.float32)}, batch_stats={},
                            opt_state=jtx.init({"w": np.zeros(3, np.float32)}))
    jmgr = JCheckpointManager(tmp_path / "jax", keep=2)
    for step in (1, 2, 3):
        st.step = step
        mgr.save(step, st, {"step": step})
        jmgr.save(step, jst, {"step": step})
        jmgr.wait()
    assert mgr.latest_step() == jmgr.latest_step() == 3
    assert mgr.steps() == sorted(jmgr._mgr.all_steps()) == [2, 3]
    jmgr.close()
    restored, config = mgr.restore(fresh_state(), step=2)
    assert restored.step == 2 and config == {"step": 2}
    with pytest.raises(FileNotFoundError):
        mgr.restore(fresh_state(), step=1)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(fresh_state())


@pytest.mark.parametrize("accumulate", [1, 2], ids=["k1", "k2"])
def test_resume_is_exact(tmp_path, accumulate):
    step = tstate.make_train_step(CFG)
    straight = fresh_state(accumulate)
    for _ in range(2):
        straight, _ = step(straight, BATCH)

    first = fresh_state(accumulate)
    first, _ = step(first, BATCH)
    mgr = CheckpointManager(tmp_path)
    mgr.save(first.step, first, {})
    resumed, _ = mgr.restore(fresh_state(accumulate, seed=7))
    assert_states_equal(resumed, first)
    resumed, _ = step(resumed, BATCH)
    assert_states_equal(resumed, straight)
    assert straight.opt.updates == (2 if accumulate == 1 else 1)
