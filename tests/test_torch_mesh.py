"""The ``(data, model)`` mesh of the port (``parallel/mesh.py::make_mesh``)
and width-sharded training on it, on the CPU.

Four ``gloo`` ranks, started as subprocesses running this file (``python
tests/test_torch_mesh.py MODE RANK WORLD DIR``, ``test_torch_spatial.py``'s
launcher), lay themselves out as a (2, 2) mesh: rank = d * 2 + m, the
width group of a rank its row, its data group its column. Each rank takes
row d of the tiny model's B=2 8x64 batch (``tests/test_model.py``'s), its
width shard m of it, and runs one train step of the META detector under
``width_sharded_apply(model, mesh, train=True)``: BatchNorm moments over
all four ranks, the loss on the gathered outputs under
``mesh.replicated_batch(mesh.data)``, the gradients summed over the mesh.

The reference is the JAX ``width_sharded_apply(model, mesh, train=True)``
on ``make_mesh(num_data=2, num_model=2)`` over four of the eight virtual
CPU devices, from the same flax variables (transplanted), on the same
batch, its train step run in fp64 (x64 on, the JAX package's explicit
``jnp.float32`` casts read as fp64). Held, on every rank: the global loss
within 1e-5 relative and the new running statistics within 1e-4 of each
leaf's max (the tolerances of ``test_torch_spatial.py::
test_width_sharded_train_step_exact``), each gradient leaf within
``1e-3 * max|g_leaf| + 1e-7`` (``test_torch_train_step.py``'s); the rank's
place in the mesh and its groups' members are JAX's ``reshape(num_data,
num_model)``. Every rank holds the same gradients and statistics, bit for
bit.

JAX's own fp32 gradient is no referee on this batch: on some leaves of
the fourth backbone stage and the stem it sits further than that bound
from the fp64 step, on the mesh and unsharded alike, so the distance is
fp32 rounding of JAX's step and not its sharding.
"""

from __future__ import annotations

import concurrent.futures
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
if str(REPO / "tests") not in sys.path:
    sys.path.insert(0, str(REPO / "tests"))

from range_view_3d_detection_torch import dryrun  # noqa: E402
from range_view_3d_detection_torch.parallel import mesh, spatial  # noqa: E402
from test_torch_spatial import _detector, launch  # noqa: E402


def _mesh_case(inputs) -> dict:
    from range_view_3d_detection_torch import transplant
    from range_view_3d_detection_torch.models.detector import detection_loss

    cfg, state = inputs["train"]
    model = _detector(cfg, state)
    m = mesh.make_mesh(2, 2)
    d = m.data_index
    batch = {k: torch.from_numpy(v[d : d + 1]) for k, v in inputs["batch"].items()}
    local = [spatial.shard_width(batch[k], m.width) for k in ("features", "cart", "mask")]
    out = spatial.gather_width(spatial.width_sharded_apply(model, m, train=True)(*local),
                               m.width)
    with mesh.replicated_batch(m.data):
        loss, _ = detection_loss(out, batch, cfg)
        total = mesh.all_sum(loss.detach())
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    grads = mesh.all_reduce_grads([g.contiguous() for g in grads], m.group)
    params, stats = transplant.state_dict_to_flax(
        {**dict(zip(names, grads)), **{k: v for k, v in model.state_dict().items()
                                       if "running" in k or "_bn_mean" in k
                                       or "_bn_var" in k}})
    members = {k: dist.get_process_group_ranks(getattr(m, k)) for k in ("width", "data")}
    return dict(loss=float(total), grads=params, stats=stats,
                place=(m.data_index, m.model_index), members=members)


MODES = {"mesh": _mesh_case}


def _worker(mode: str, r: int, world: int, work: Path) -> None:
    torch.set_num_threads(1)
    mesh.initialize_distributed(
        "cpu", init_method=f"file://{work / 'init'}", rank=r, world_size=world
    )
    try:
        inputs = torch.load(work / "inputs.pt", weights_only=False)
        torch.save(MODES[mode](inputs), work / f"rank{r}.pt")
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    import jax

    from range_view_3d_detection_torch import transplant
    from range_view_3d_detection_tpu.models.detector import Detector
    from range_view_3d_detection_tpu.parallel import make_mesh
    from range_view_3d_detection_tpu.parallel.spatial import width_sharded_apply
    from test_model import tiny_batch, tiny_config
    from test_torch_blocks import numpy_tree
    from test_torch_spatial import port_config

    work = tmp_path_factory.mktemp("mesh22")
    batch = {k: np.asarray(v) for k, v in tiny_batch(B=2).items()}
    jcfg = tiny_config(stem_type="META")
    model = Detector(jcfg)
    args = (batch["features"], batch["cart"], batch["mask"])
    v = model.init(jax.random.PRNGKey(0), *args, train=True)
    params, stats = numpy_tree(v["params"]), numpy_tree(v["batch_stats"])
    inputs = dict(batch=batch,
                  train=(port_config(jcfg), transplant.flax_to_state_dict(params, stats)))
    torch.save(inputs, work / "inputs.pt")
    # The ranks run while JAX runs its step.
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(launch, "mesh", work, 4, script=__file__)

    jmesh = make_mesh(num_data=2, num_model=2)
    ref = _jax_float64_step(width_sharded_apply(model, jmesh, train=True), jmesh,
                            params, stats, batch, jcfg)
    ranks = ranks.result()
    pool.shutdown()
    return dict(ranks=ranks, **ref)


def _jax_float64_step(sharded, jmesh, params, stats, batch, jcfg) -> dict:
    """JAX's train step through ``sharded`` on ``jmesh``: the global
    batch's loss, its gradient and the new running statistics, every
    computation in fp64: x64 on, and ``jnp.float32``, which the JAX model
    and loss name in each of their casts, read as fp64."""
    import jax
    import jax.numpy as jnp

    from range_view_3d_detection_tpu.models.detector import detection_loss
    from range_view_3d_detection_tpu.parallel.spatial import width_shardings
    from test_torch_blocks import numpy_tree

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64 if np.asarray(a).dtype.kind == "f"
                                  else np.asarray(a).dtype), tree)

    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(True):
            mp.setattr(jnp, "float32", jnp.float64)
            b = f64(batch)
            r4, r3 = width_shardings(jmesh)
            args = (jax.device_put(b["features"], r4), jax.device_put(b["cart"], r4),
                    jax.device_put(b["mask"], r3))
            s64 = f64(stats)

            def loss_fn(p):
                out, mutated = sharded({"params": p, "batch_stats": s64}, *args)
                return detection_loss(out, b, jcfg)[0], mutated["batch_stats"]

            (loss, new), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                f64(params))
            assert loss.dtype == jnp.float64
            return dict(loss=float(loss), grads=_leaves(numpy_tree(grads)),
                        stats=numpy_tree(new))
    finally:
        mp.undo()


def _leaves(tree) -> dict:
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_mesh_places_ranks_as_jax_reshape(mesh_ranks):
    for r, rank in enumerate(mesh_ranks["ranks"]):
        d, m = divmod(r, 2)
        assert rank["place"] == (d, m)
        assert rank["members"] == {"width": [2 * d, 2 * d + 1], "data": [m, m + 2]}


def test_mesh_width_sharded_train_step_matches_jax(mesh_ranks):
    from test_torch_train_step import assert_trees_close

    want = mesh_ranks["grads"]
    for rank in mesh_ranks["ranks"]:
        np.testing.assert_allclose(rank["loss"], mesh_ranks["loss"], rtol=1e-5)
        assert_trees_close(rank["stats"], mesh_ranks["stats"], 1e-4, what="batch_stats")
        got = _leaves(rank["grads"])
        assert sorted(got) == sorted(want)
        for k in want:
            bound = 1e-3 * np.abs(want[k]).max() + 1e-7
            err = np.abs(got[k] - want[k]).max()
            assert err <= bound, (k, err, bound)


def test_mesh_ranks_hold_one_step(mesh_ranks):
    """After the mesh's all-reduce every rank holds the same loss,
    gradients and running statistics, bit for bit: the replicas of a
    data-parallel step cannot drift apart."""
    first, *rest = mesh_ranks["ranks"]
    g0, s0 = _leaves(first["grads"]), _leaves(first["stats"])
    for rank in rest:
        assert rank["loss"] == first["loss"]
        g, s = _leaves(rank["grads"]), _leaves(rank["stats"])
        assert sorted(g) == sorted(g0) and sorted(s) == sorted(s0)
        for k in g0:
            np.testing.assert_array_equal(g[k], g0[k], err_msg=k)
        for k in s0:
            np.testing.assert_array_equal(s[k], s0[k], err_msg=k)


def test_mesh_without_a_process_group():
    """Outside a process group the mesh is one rank, and a larger one is
    refused; the dry run's phase 3 takes the JAX layout ((n/4, 4), else
    (n/2, 2)) and (1, 1) on one rank."""
    assert not mesh.active()
    m = mesh.make_mesh(1, 1)
    assert (m.num_data, m.num_model, m.data_index, m.model_index) == (1, 1, 0, 0)
    assert m.width is None and m.data is None and m.group is None
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh.make_mesh(2, 2)
    layouts = {n: dryrun.mesh_layout(n) for n in (1, 2, 3, 4, 6, 8, 16)}
    assert layouts == {1: (1, 1), 2: (1, 2), 3: (1, 2), 4: (1, 4), 6: (3, 2), 8: (2, 4),
                       16: (4, 4)}


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
