"""Data parallelism in the port (``parallel/mesh.py``), on the CPU.

Two ``gloo`` ranks, started as subprocesses running this file (``python
tests/test_torch_parallel.py WORKER RANK WORLD DIR``), meet through a
``file://`` init method in the test's temporary directory (no TCP port
to collide between test workers); each uses one thread and the launch has
its own timeout. The rank processes import no JAX: the JAX reference runs
in the test process.

Held:

- two ranks, each given half of a fixed global batch of 4 (rows ``r*2 :
  (r+1)*2``), take two steps of the port's train step from the same
  weights as the JAX ``make_train_step`` on the whole batch: each step's
  loss within 1e-5 relative and ``grad_norm`` within 1e-3, the parameters
  within 1e-5 of each leaf's max plus AdamW's sign-flip bound, the
  running statistics within 1e-4 (``test_torch_train_step.py``'s
  tolerances), the same numbers on both ranks;
- ZeRO-1 over the two ranks equals the replicated optimizer bit for bit
  (parameters, metrics), and its gathered state dict equals the
  replicated one;
- ``DataLoader(process_index, process_count)`` gives the JAX loader's
  batch indices exactly, the uneven cases (31, 2, 16), (33, 2, 16) and
  (10, 3, 2) among them, and its owned indices partition the dataset;
- a two-rank ``Trainer`` (ZeRO-1) on the CPU corpus: one checkpoint file
  a save, written by rank 0 and restored by a single-process state;
  disjoint val shards (three sweeps: one rank's shard is wrap-padded)
  whose union is a one-rank run's; equal parameters on both ranks.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from range_view_3d_detection_torch import serving  # noqa: E402
from range_view_3d_detection_torch.data.dataset import DataLoader  # noqa: E402
from range_view_3d_detection_torch.parallel import mesh  # noqa: E402
from range_view_3d_detection_torch.training import optim as toptim  # noqa: E402
from range_view_3d_detection_torch.training import state as tstate  # noqa: E402

B_RANK = 2
WORLD = 2
STEPS = 2


def _launch(mode: str, work: Path, world: int = WORLD, timeout: float = 180.0) -> list:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "GLOO_SOCKET_IFNAME": "lo",
           "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, mode, str(r), str(world), str(work)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(world)]


# -- the rank processes ---------------------------------------------------------


def _worker_step(r: int, work: Path) -> dict:
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    cfg = serving._flagship_config(tiny=True)
    rows = slice(r * B_RANK, (r + 1) * B_RANK)
    local = {k: v[rows] for k, v in inputs["batch"].items()}
    out = {}
    for zero1 in (False, True):
        tx = toptim.make_optimizer(1e-3, 20, zero1=zero1)[0]
        st = tstate.create_state(cfg, tx, device="cpu")
        st.model.load_state_dict(inputs["state_dict"])
        step = tstate.make_train_step(cfg)
        metrics = []
        for _ in range(STEPS):
            st, m = step(st, local)
            metrics.append({k: float(v) for k, v in m.items()})
        out["zero1" if zero1 else "replicated"] = dict(
            metrics=metrics,
            state_dict=st.model.state_dict(),
            opt=st.opt.state_dict(),
            owners=st.opt.owners,
        )
    return out


def _worker_trainer(r: int, work: Path) -> dict:
    from range_view_3d_detection_torch.training.loop import Trainer

    cfg = json.loads((work / "config.json").read_text())
    trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    trainer.validate()
    return dict(
        world=trainer.world, rank=trainer.rank, shards=sorted(trainer.last_shards),
        state_dict=trainer.state.model.state_dict(), steps=trainer.ckpt.steps(),
        global_batch=trainer.global_batch,
    )


def _worker(mode: str, r: int, world: int, work: Path) -> None:
    torch.set_num_threads(1)
    mesh.initialize_distributed(
        "cpu", init_method=f"file://{work / 'init'}", rank=r, world_size=world
    )
    try:
        out = {"step": _worker_step, "trainer": _worker_trainer}[mode](r, work)
        torch.save(out, work / f"rank{r}.pt")
    finally:
        torch.distributed.destroy_process_group()


# -- the tests -------------------------------------------------------------------


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from range_view_3d_detection_torch import transplant
    from range_view_3d_detection_tpu.models.detector import Detector
    from range_view_3d_detection_tpu.training import optim as joptim
    from range_view_3d_detection_tpu.training import state as jstate
    from test_torch_blocks import randomize_bn

    work = tmp_path_factory.mktemp("dp_step")
    tcfg = serving._flagship_config(tiny=True)
    batch = serving._dryrun_batch(tcfg, WORLD * B_RANK, 8, 64, 5, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = Detector(graft._flagship_config(tiny=True))
    v = model.init(jax.random.PRNGKey(0), jb["features"][:1], jb["cart"][:1],
                   jb["mask"][:1], train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=1)
    st = tstate.create_state(tcfg, toptim.make_optimizer(1e-3, 20)[0], device="cpu")
    transplant.load_flax_variables(st.model, params, stats)
    torch.save({"batch": batch, "state_dict": st.model.state_dict()}, work / "inputs.pt")

    jtx = joptim.make_optimizer(1e-3, 20)[0]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats), opt_state=jtx.init(jparams),
    )
    jstep = jstate.make_train_step(graft._flagship_config(tiny=True), jtx)
    jmetrics = []
    for _ in range(STEPS):
        jst, jm = jstep(jst, jb)
        jmetrics.append({k: float(v) for k, v in jm.items()})
    return dict(ranks=_launch("step", work), jst=jst, jmetrics=jmetrics)


def test_two_ranks_match_jax_global_batch_step(steps):
    from range_view_3d_detection_torch import transplant
    from test_torch_train_step import assert_trees_close

    ranks, jst = steps["ranks"], steps["jst"]
    for got, want in zip(ranks[0]["replicated"]["metrics"], steps["jmetrics"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["total_fg"], want["total_fg"], rtol=1e-6)
        np.testing.assert_allclose(got["total_objects"], want["total_objects"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-3)
    params, stats = transplant.state_dict_to_flax(ranks[0]["replicated"]["state_dict"])
    moved = sum(toptim.onecycle_schedule(1e-3, 20)(t) for t in range(STEPS))
    assert_trees_close(params, jst.params, 1e-5, 2.0 * moved, "params")
    assert_trees_close(stats, jst.batch_stats, 1e-4, what="batch_stats")
    # Every rank holds the same global numbers and parameters.
    assert ranks[1]["replicated"]["metrics"] == ranks[0]["replicated"]["metrics"]
    for k, v in ranks[0]["replicated"]["state_dict"].items():
        assert torch.equal(ranks[1]["replicated"]["state_dict"][k], v), k


def test_zero1_equals_replicated(steps):
    for rank in steps["ranks"]:
        rep, z1 = rank["replicated"], rank["zero1"]
        assert rep["owners"] is None and sorted(set(z1["owners"])) == [0, 1]
        assert z1["metrics"] == rep["metrics"]
        for k, v in rep["state_dict"].items():
            assert torch.equal(z1["state_dict"][k], v), k
        a, b = rep["opt"]["adamw"], z1["opt"]["adamw"]
        assert a["param_groups"] == b["param_groups"]
        assert sorted(a["state"]) == sorted(b["state"])
        for i, entry in a["state"].items():
            for key, t in entry.items():
                assert torch.equal(b["state"][i][key], t), (i, key)


def test_zero1_owners_balance():
    owners = mesh.zero1_owners([10, 1, 7, 7, 3], 2)
    assert owners == [0, 0, 1, 1, 0]
    with pytest.raises(ValueError):
        mesh.zero1_owners([4], 2)


class _Index:
    def __init__(self, n):
        self.index = list(range(n))
        self.epoch = 0

    def __len__(self):
        return len(self.index)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n,nproc,bs", [(31, 2, 16), (33, 2, 16), (10, 3, 2), (8, 2, 2)])
def test_loader_shards_match_jax(n, nproc, bs, shuffle):
    from range_view_3d_detection_tpu.data.dataset import DataLoader as JLoader

    owned = []
    for drop_last in (False, True):
        for pid in range(nproc):
            kw = dict(batch_size=bs, shuffle=shuffle, drop_last=drop_last, num_workers=0,
                      process_index=pid, process_count=nproc)
            got, want = DataLoader(_Index(n), **kw), JLoader(_Index(n), **kw)
            assert len(got) == len(want)
            for _ in range(2):  # two epochs: the shuffle's seed moves
                g, w = got._batch_indices(), want._batch_indices()
                assert len(g) == len(w) and all(np.array_equal(a, b) for a, b in zip(g, w))
            if not drop_last:
                owned.append(got.owned_indices())
    flat = np.concatenate(owned)
    assert sorted(flat.tolist()) == list(range(n))


def test_distributed_step_without_a_group_is_the_single_device_step():
    assert not mesh.active() and mesh.world() == 1 and mesh.rank() == 0
    t = torch.arange(4.0)
    assert mesh.all_sum(t) is t
    assert mesh.process_sum_scalars({"a": 1.5}) == {"a": 1.5}
    assert mesh.initialize_distributed("cpu") == torch.device("cpu") and not mesh.active()


def _trainer_cfg(root, run_dir, **extra):
    from range_view_3d_detection_torch.utils import config as tconfig
    from test_torch_trainer import REPO as _REPO, tiny_overrides

    ov = tiny_overrides(root, run_dir, **{
        "model.debug": "false", "model.batch_size": 1, "trainer.max_epochs": 2,
        "trainer.devices": "auto", **extra})
    return tconfig.compose(_REPO / "conf", "rv-synthetic", ov)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    from range_view_3d_detection_torch.data.synthetic import generate_dataset
    from range_view_3d_detection_torch.training.loop import Trainer

    work = tmp_path_factory.mktemp("dp_trainer")
    root = work / "sensor"
    generate_dataset(root, splits={"train": 1, "val": 1}, sweeps_per_log=3, height=8,
                     width=56, num_boxes=4, num_bg_points=800, seed=1)
    cfg = _trainer_cfg(root, work / "run2", **{"trainer.zero1": "true"})
    (work / "config.json").write_text(json.dumps(cfg))
    ranks = _launch("trainer", work)
    single = Trainer(_trainer_cfg(root, work / "run1"), device="cpu")
    single.fit()
    single.validate()
    return dict(ranks=ranks, single=single, cfg=cfg, run=work / "run2")


def test_two_rank_trainer(trainers):
    from range_view_3d_detection_torch.training.checkpoints import CheckpointManager

    r0, r1 = trainers["ranks"]
    assert (r0["world"], r0["rank"], r1["rank"], r0["global_batch"]) == (2, 0, 1, 2)
    # Three val sweeps over two ranks: rank 1's shard is wrap-padded, and
    # each sweep is written by one rank.
    assert not set(r0["shards"]) & set(r1["shards"])
    assert len(r0["shards"]) == 2 and len(r1["shards"]) == 1
    union = set(r0["shards"]) | set(r1["shards"])
    assert union == set(trainers["single"].last_shards)
    written = {p.name for p in (trainers["run"] / "predictions").iterdir()}
    assert written == union
    for k, v in r0["state_dict"].items():
        assert torch.equal(r1["state_dict"][k], v), k
    # Two epochs of one step a rank (two train sweeps survive the train
    # filter; batch 1 a rank), a save at each epoch's end; only step files
    # in the directory.
    assert len(trainers["single"].train_ds) == 2
    ckpt_dir = trainers["run"] / "checkpoints"
    assert r0["steps"] == [1, 2]
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["step_1.pt", "step_2.pt"]
    single = trainers["single"]
    restored, saved = CheckpointManager(ckpt_dir).restore(
        tstate.create_state(single.det_cfg, single.tx, device="cpu"))
    assert restored.step == 2 and saved == json.loads(json.dumps(trainers["cfg"]))
    for k, v in restored.model.state_dict().items():
        assert torch.equal(r0["state_dict"][k], v), k
    assert restored.opt.updates == 2 and len(restored.opt.adamw.state) == len(
        restored.opt.params)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
