"""Width sharding in the port (``parallel/spatial.py``), on the CPU.

``gloo`` ranks, started as subprocesses running this file (``python
tests/test_torch_spatial.py MODE RANK WORLD DIR``), meet through a
``file://`` init method in the test's temporary directory; each uses one
thread, and they import no JAX: the JAX references run in the test
process, on its unsharded (global) forward, which the JAX package's own
``tests/test_spatial_sharding.py`` shows equals its sharded one. Each
rank takes its width shard of the same inputs (``shard_width``), runs
the port's module under the width context and returns its shard; the
test puts the shards back together.

Held, at 2 ranks:

- the halo exchange against the globally padded image (``roll`` for
  ``circular=True``, zeros at the outer edges for ``circular=False``),
  halos (2, 2) and (1, 2), and its backward against the scatter-add of
  the halo gradients onto the columns they came from: exact;
- ``ConvNormAct`` 3x3 at width stride 1 and 2, the transposed conv at
  (3, 3)/(1, 1)/(1, 1) and (3, 2)/(1, 2)/(1, 0), the aggregation node
  (3, 8)/(1, 4)/(1, 2) with and without ``RV3D_DECONV_PHASE=1``, and the
  tiny detector (``tests/test_model.py::tiny_config``, randomised
  BatchNorm statistics) with the BASIC, META and RANGE_PARTITION stems in
  eval, ``circular=False``: within ``atol=2e-5`` of JAX's global forward
  (the JAX package's own sharded-vs-global tolerance), the strided views
  equal;
- int8 operands (JAX's global forward under ``quantization("int8")``):
  ``ConvNormAct`` 3x3 at width stride 1 and 2 and (4, 4), whose int8
  conv output is exact (the block within ``atol=2e-5``: its BatchNorm is
  fp), the aggregation transposed conv (3, 8)/(1, 4)/(1, 2), exact, and
  the tiny META detector with BatchNorms folded and one quant tree
  calibrated by JAX, within ``atol=2e-5`` (its stem is fp);
- the train-mode apply (META): the loss on the gathered outputs under
  ``mesh.replicated_batch()`` within 1e-5 relative of JAX's global
  ``detection_loss``, the gradients summed over the ranks within
  ``1e-3 * max|g_leaf| + 1e-7`` of ``jax.grad`` (``test_torch_train_step.
  py``'s port-against-JAX tolerance), and the running statistics within
  1e-4 of each leaf's max (``test_torch_parallel.py``'s), the same on
  both ranks;

and at 4 ranks the halo exchange and the three stems' detectors again.
The up-front width check refuses a shard that is not a multiple of the
width stride (1808 at 2 shards) and names the widths that work.
"""

from __future__ import annotations

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

from range_view_3d_detection_torch.parallel import mesh, spatial  # noqa: E402

H, W = 8, 64
HALOS = ((2, 2), (1, 2))
BLOCKS = (
    ("conv", dict(strides=(1, 1))),
    ("conv", dict(strides=(1, 2))),
    ("deconv", dict(kernel=(3, 3), strides=(1, 1), padding=(1, 1))),
    ("deconv", dict(kernel=(3, 2), strides=(1, 2), padding=(1, 0))),
    ("agg", dict(phase=False)),
    ("agg", dict(phase=True)),
    # int8 operands: the conv output (and the transposed conv's) exact.
    ("conv", dict(strides=(1, 1), int8=True)),
    ("conv", dict(strides=(1, 2), int8=True)),
    ("conv", dict(kernel=(4, 4), strides=(1, 1), int8=True)),
    ("deconv", dict(kernel=(3, 8), strides=(1, 4), padding=(1, 2), int8=True)),
)
STEMS = ("BASIC", "META", "RANGE_PARTITION")


def launch(mode: str, work: Path, world: int, timeout: float = 240.0,
           script: str = __file__) -> list:
    """Run ``world`` gloo ranks of ``mode`` over ``work/inputs.pt`` (each
    ``python SCRIPT MODE RANK WORLD DIR``); returns each rank's saved
    output."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "GLOO_SOCKET_IFNAME": "lo",
           "OMP_NUM_THREADS": "1"}
    env.pop("RV3D_DECONV_PHASE", None)
    procs = [
        subprocess.Popen(
            [sys.executable, script, mode, str(r), str(world), str(work)],
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


def port_config(jcfg):
    """The port's ``DetectorConfig`` of a JAX one (the artifact's reader)."""
    import dataclasses

    from range_view_3d_detection_torch.export import _detector_config_from_meta

    return _detector_config_from_meta(dataclasses.asdict(jcfg))


def unshard(parts, axis: int = 2) -> np.ndarray:
    return np.concatenate([np.asarray(p) for p in parts], axis=axis)


# -- the rank processes -----------------------------------------------------------


def _halo_cases(inputs) -> dict:
    x = torch.from_numpy(inputs["halo_x"])
    out = {}
    for lo, hi in HALOS:
        for circular in (True, False):
            xl = spatial.shard_width(x).requires_grad_(True)
            y = spatial.exchange_halo_lr(xl, lo, hi, circular=circular)
            c = torch.from_numpy(inputs["halo_c"][(lo, hi, spatial.group_rank())])
            (g,) = torch.autograd.grad((y * c).sum(), xl)
            out[(lo, hi, circular)] = (y.detach(), g)
    return out


def _port_block(kind, kw, state):
    from range_view_3d_detection_torch.models.blocks import (
        AggregationBlock,
        ConvNormAct,
        TorchConvTranspose,
    )

    if kind == "conv":
        m = ConvNormAct(3, 8, kw.get("kernel", (3, 3)), kw["strides"])
    elif kind == "deconv":
        m = TorchConvTranspose(8, 6, kw["kernel"], kw["strides"], kw["padding"])
    else:
        m = AggregationBlock(12, 8, (3, 8), (1, 4), (1, 2), 2)
    m.load_state_dict(state)
    return m.eval()


def _block_cases(inputs) -> dict:
    out = {}
    with torch.no_grad(), spatial.width_sharding():
        for i, (kind, kw) in enumerate(BLOCKS):
            case = inputs["blocks"][i]
            m = _port_block(kind, kw, case["state"])
            conv_out = []
            if kw.get("int8"):
                m.quantize(case["in_scale"])
                if kind == "conv":
                    m.int8.register_forward_hook(lambda mod, a, y: conv_out.append(y))
            xs = [spatial.shard_width(torch.from_numpy(a)).permute(0, 3, 1, 2)
                  for a in case["x"]]
            if kw.get("phase"):
                os.environ["RV3D_DECONV_PHASE"] = "1"
            try:
                out[i] = m(*xs).permute(0, 2, 3, 1)
            finally:
                os.environ.pop("RV3D_DECONV_PHASE", None)
            if conv_out:
                out[(i, "conv")] = conv_out[0].permute(0, 2, 3, 1)
    return out


def _detector(cfg, state):
    from range_view_3d_detection_torch.models.detector import Detector

    model = Detector(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def _detector_cases(inputs) -> dict:
    out = {}
    batch = [torch.from_numpy(inputs["batch"][k]) for k in ("features", "cart", "mask")]
    local = [spatial.shard_width(t) for t in batch]
    for stem in STEMS:
        cfg, state = inputs["detectors"][stem]
        apply = spatial.width_sharded_apply(_detector(cfg, state), circular=False)
        with torch.no_grad():
            res = apply(*local)
        out[stem] = {"head": res["head"], "strided": res["strided"]}
    return out


def _int8_detector_case(inputs) -> dict:
    from range_view_3d_detection_torch.models.quantized import quantize_model

    cfg, state, qtree = inputs["int8_detector"]
    model = quantize_model(_detector(cfg, state), qtree)
    batch = [torch.from_numpy(inputs["batch"][k]) for k in ("features", "cart", "mask")]
    with torch.no_grad():
        res = spatial.width_sharded_apply(model, circular=False)(
            *[spatial.shard_width(t) for t in batch])
    return {"int8 META": {"head": res["head"], "strided": res["strided"]}}


def _train_case(inputs) -> dict:
    from range_view_3d_detection_torch import transplant
    from range_view_3d_detection_torch.models.detector import detection_loss

    cfg, state = inputs["train"]
    model = _detector(cfg, state)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    local = [spatial.shard_width(batch[k]) for k in ("features", "cart", "mask")]
    out = spatial.gather_width(spatial.width_sharded_apply(model, train=True)(*local))
    with mesh.replicated_batch():
        loss, _ = detection_loss(out, batch, cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    grads = mesh.all_reduce_grads([g.contiguous() for g in grads])
    params, stats = transplant.state_dict_to_flax(
        {**dict(zip(names, grads)), **{k: v for k, v in model.state_dict().items()
                                       if "running" in k or "_bn_mean" in k
                                       or "_bn_var" in k}})
    return dict(loss=float(loss), grads=params, stats=stats)


def _serve_case(inputs) -> dict:
    from range_view_3d_detection_torch import export

    predict, place, _, _ = export.load_artifact_width_sharded(
        inputs["art"], circular=False, device="cpu")
    spatial.exchange_halo_lr.calls = 0
    res = predict(*place(*inputs["request"]))
    return dict(result=tuple(res), exchanges=spatial.exchange_halo_lr.calls)


MODES = {
    "eval2": lambda i: dict(halo=_halo_cases(i), blocks=_block_cases(i),
                            detectors={**_detector_cases(i), **_int8_detector_case(i)},
                            train=_train_case(i)),
    "eval4": lambda i: dict(halo=_halo_cases(i), detectors=_detector_cases(i)),
    "serve": _serve_case,
}


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


# -- the references -----------------------------------------------------------------


def _halo_inputs(world: int) -> dict:
    rng = np.random.default_rng(7)
    x = np.arange(1 * 2 * W * 3, dtype=np.float32).reshape(1, 2, W, 3)
    c = {(lo, hi, r): rng.normal(size=(1, 2, W // world + lo + hi, 3)).astype(np.float32)
         for lo, hi in HALOS for r in range(world)}
    return dict(halo_x=x, halo_c=c)


def _check_halo(ranks, inputs, world: int) -> None:
    x = inputs["halo_x"]
    Wl = W // world
    for lo, hi in HALOS:
        for circular in (True, False):
            grad = np.zeros_like(x)
            for r, rank in enumerate(ranks):
                y, _ = rank["halo"][(lo, hi, circular)]
                cols = np.arange(r * Wl - lo, (r + 1) * Wl + hi)
                inside = (cols >= 0) & (cols < W)
                keep = circular | inside
                want = x[:, :, cols % W] * keep[None, None, :, None]
                np.testing.assert_array_equal(y.numpy(), want)
                # Each halo column's gradient lands on the column it came from.
                np.add.at(grad, (slice(None), slice(None), cols[keep] % W),
                          inputs["halo_c"][(lo, hi, r)][:, :, keep])
            got = unshard([rank["halo"][(lo, hi, circular)][1] for rank in ranks])
            np.testing.assert_allclose(got, grad, atol=1e-4,
                                       err_msg=f"halo grad {(lo, hi, circular)}")


def _jax_block(kind, kw):
    from range_view_3d_detection_tpu.models.blocks import (
        AggregationBlock,
        ConvNormAct,
        TorchConvTranspose,
    )

    if kind == "conv":
        return (ConvNormAct(8, kernel_size=kw.get("kernel", (3, 3)), strides=kw["strides"]),
                [(1, 4, W, 3)])
    if kind == "deconv":
        return (TorchConvTranspose(features=6, kernel_size=kw["kernel"],
                                   strides=kw["strides"], padding=kw["padding"]),
                [(1, 4, 32, 8)])
    return (AggregationBlock(8, kernel_size=(3, 8), strides=(1, 4), padding=(1, 2),
                             num_blocks=2), [(1, 4, W, 8), (1, 4, W // 4, 12)])


def _block_references() -> list:
    """Each block's global forward in JAX (int8 ones under
    ``quantization("int8")``, with the conv's output beside the block's)."""
    import contextlib

    import jax

    from range_view_3d_detection_torch import transplant
    from range_view_3d_detection_tpu.models import quantized as jq
    from test_torch_blocks import numpy_tree, randomize_bn

    rng = np.random.default_rng(1)
    cases = []
    for kind, kw in BLOCKS:
        blk, shapes = _jax_block(kind, kw)
        xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
        v = blk.init(jax.random.PRNGKey(0), *xs)
        params = numpy_tree(v["params"])
        stats = numpy_tree(v.get("batch_stats", {}))
        if stats:
            params, stats = randomize_bn(params, stats, seed=2)
        if kind == "deconv":
            state = {"weight": torch.from_numpy(np.ascontiguousarray(
                params["kernel"][::-1, ::-1].transpose(2, 3, 0, 1)))}
        else:
            state = transplant.flax_to_state_dict(params, stats)
        variables = {"params": params, **({"batch_stats": stats} if stats else {})}
        case = dict(x=xs, state=state)
        quant = contextlib.nullcontext()
        if kw.get("int8"):
            # 0.8 of the input's absmax: the clamp binds too.
            case["in_scale"] = float(np.float32(0.8 * np.abs(xs[-1]).max() / 127.0))
            variables["quant"] = {"in_scale": np.float32(case["in_scale"])}
            quant = jq.quantization("int8")
        if kw.get("phase"):
            os.environ["RV3D_DECONV_PHASE"] = "1"
        try:
            with quant:
                ref, inter = blk.apply(variables, *xs, capture_intermediates=True)
        finally:
            os.environ.pop("RV3D_DECONV_PHASE", None)
        case["ref"] = np.asarray(ref)
        if kw.get("int8") and kind == "conv":
            case["ref_conv"] = np.asarray(inter["intermediates"]["Conv_0"]["__call__"][0])
        cases.append(case)
    return cases


def _detector_references(batch, stems=STEMS) -> dict:
    import jax

    from range_view_3d_detection_torch import transplant
    from range_view_3d_detection_tpu.models.detector import Detector
    from test_model import tiny_config
    from test_torch_blocks import randomize_bn

    out = {}
    for stem in stems:
        jcfg = tiny_config(stem_type=stem)
        model = Detector(jcfg)
        args = (batch["features"], batch["cart"], batch["mask"])
        v = model.init(jax.random.PRNGKey(0), *args, train=False)
        params, stats = randomize_bn(v["params"], v["batch_stats"], seed=3)
        ref = jax.jit(lambda p, s, *a: model.apply({"params": p, "batch_stats": s}, *a,
                                                   train=False))(params, stats, *args)
        out[stem] = dict(cfg=port_config(jcfg),
                         state=transplant.flax_to_state_dict(params, stats),
                         ref=jax.tree_util.tree_map(np.asarray, ref))
    return out


def _int8_detector_reference(batch) -> dict:
    """The tiny META detector's global int8 forward in JAX: BatchNorms
    folded, one quant tree calibrated by JAX on the batch."""
    import jax

    from range_view_3d_detection_torch import transplant
    from range_view_3d_detection_tpu.models import quantized as jq
    from range_view_3d_detection_tpu.models.detector import Detector
    from test_model import tiny_config
    from test_torch_blocks import numpy_tree, randomize_bn
    from tools.export import fold_batch_norms

    jcfg = tiny_config(stem_type="META")
    model = Detector(jcfg)
    args = (batch["features"], batch["cart"], batch["mask"])
    v = model.init(jax.random.PRNGKey(0), *args, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=3)
    folded = numpy_tree(fold_batch_norms({"params": params, "batch_stats": stats}))
    qtree = jax.tree_util.tree_map(np.asarray, jq.calibrate_scales(model, folded, [args]))
    with jq.quantization("int8"):
        ref = jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
            {**folded, "quant": qtree}, *args)
    return {"int8 META": dict(
        cfg=port_config(jcfg), qtree=qtree, ref=jax.tree_util.tree_map(np.asarray, ref),
        state=transplant.flax_to_state_dict(folded["params"], folded["batch_stats"]))}


def _check_detectors(ranks, refs) -> None:
    for stem, entry in refs.items():
        ref = entry["ref"]
        for s, tasks in ref["head"].items():
            for t, heads in tasks.items():
                for name, want in heads.items():
                    got = unshard([r["detectors"][stem]["head"][s][t][name] for r in ranks])
                    np.testing.assert_allclose(got, want, atol=2e-5,
                                               err_msg=f"{stem} s{s} t{t} {name}")
        for s, views in ref["strided"].items():
            for k, want in views.items():
                got = unshard([r["detectors"][stem]["strided"][s][k] for r in ranks])
                np.testing.assert_array_equal(got, want)


def _tiny_batch():
    from test_model import tiny_batch

    return {k: np.asarray(v) for k, v in tiny_batch(B=1).items()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from range_view_3d_detection_torch import transplant
    from range_view_3d_detection_tpu.models.detector import Detector, detection_loss
    from test_model import tiny_config
    from test_torch_blocks import numpy_tree

    work = tmp_path_factory.mktemp("width2")
    batch = _tiny_batch()
    blocks = _block_references()
    dets = {**_detector_references(batch), **_int8_detector_reference(batch)}
    # The train step: JAX's global forward, loss and gradients (its test's).
    jcfg = tiny_config(stem_type="META")
    model = Detector(jcfg)
    args = (batch["features"], batch["cart"], batch["mask"])
    v = model.init(jax.random.PRNGKey(0), *args, train=True)
    params, stats = numpy_tree(v["params"]), numpy_tree(v["batch_stats"])
    jb = {k: jnp.asarray(a) for k, a in batch.items()}

    def loss_global(p):
        out, mutated = model.apply({"params": p, "batch_stats": stats}, *args, train=True,
                                   mutable=["batch_stats"])
        return detection_loss(out, jb, jcfg)[0], mutated["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_global, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    inputs = dict(
        _halo_inputs(2),
        blocks=[{k: c[k] for k in ("x", "state", "in_scale") if k in c} for c in blocks],
        detectors={s: (d["cfg"], d["state"]) for s, d in dets.items() if s in STEMS},
        int8_detector=(dets["int8 META"]["cfg"], dets["int8 META"]["state"],
                       dets["int8 META"]["qtree"]),
        batch=batch,
        train=(port_config(jcfg), transplant.flax_to_state_dict(params, stats)),
    )
    torch.save(inputs, work / "inputs.pt")
    ranks = launch("eval2", work, 2)
    return dict(ranks=ranks, inputs=inputs, blocks=blocks, dets=dets,
                train=dict(loss=float(jloss), grads=numpy_tree(jgrads),
                           stats=numpy_tree(jstats)))


def test_halo_exchange_matches_roll(two_ranks):
    _check_halo(two_ranks["ranks"], two_ranks["inputs"], 2)


@pytest.mark.parametrize("i", range(len(BLOCKS)),
                         ids=[f"{k}-{'-'.join(map(str, v.values()))}" for k, v in BLOCKS])
def test_width_sharded_block_exact(two_ranks, i):
    ranks, ref = two_ranks["ranks"], two_ranks["blocks"][i]
    got = unshard([r["blocks"][i] for r in ranks])
    if BLOCKS[i][1].get("int8"):
        # The int8 conv's integer sums are exact: its output (the
        # transposed conv's, or the ConvNormAct's conv before the fp
        # BatchNorm) equals JAX's global int8 forward.
        want = ref["ref"] if BLOCKS[i][0] == "deconv" else ref["ref_conv"]
        conv = got if BLOCKS[i][0] == "deconv" else unshard(
            [r["blocks"][(i, "conv")] for r in ranks])
        np.testing.assert_array_equal(conv, want)
    np.testing.assert_allclose(got, ref["ref"], atol=2e-5)


def test_width_sharded_detector_exact(two_ranks):
    _check_detectors(two_ranks["ranks"], two_ranks["dets"])


def test_width_sharded_train_step_exact(two_ranks):
    from test_torch_train_step import assert_trees_close

    want = two_ranks["train"]
    for rank in two_ranks["ranks"]:
        got = rank["train"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert_trees_close(got["grads"], want["grads"], 1e-3, 1e-7, "grads")
        assert_trees_close(got["stats"], want["stats"], 1e-4, what="batch_stats")
    r0, r1 = (r["train"] for r in two_ranks["ranks"])
    assert r0["loss"] == r1["loss"]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, two_ranks):
    work = tmp_path_factory.mktemp("width4")
    inputs = dict(_halo_inputs(4), detectors=two_ranks["inputs"]["detectors"],
                  batch=two_ranks["inputs"]["batch"])
    torch.save(inputs, work / "inputs.pt")
    return dict(ranks=launch("eval4", work, 4), inputs=inputs)


def test_four_ranks_halo_and_detectors(four_ranks, two_ranks):
    _check_halo(four_ranks["ranks"], four_ranks["inputs"], 4)
    _check_detectors(four_ranks["ranks"], {s: two_ranks["dets"][s] for s in STEMS})


def test_width_check_names_the_widths_that_work():
    with pytest.raises(ValueError, match=r"1792, 1824"):
        spatial.check_width(1808, 2, 16)
    spatial.check_width(1792, 2, 16)
    spatial.check_width(2656, 2, 16)
    with pytest.raises(ValueError, match="2624, 2688"):
        spatial.check_width(2656, 4, 16)
    with pytest.raises(ValueError, match="exceeds local width"):
        spatial.exchange_halo_lr(torch.zeros(1, 1, 2, 1), 3, 3)


def test_single_process_context_is_local():
    """Without a process group the width context is one shard: the
    circular halo is its own far columns, the other zeros, and a detector
    under it equals its unsharded eval forward when the seam is zero-padded."""
    x = torch.arange(8.0).reshape(1, 1, 8, 1)
    assert spatial.group_size() == 1 and spatial.gather_width({"a": x})["a"] is x
    circ = spatial.exchange_halo_lr(x, 1, 2, circular=True)[0, 0, :, 0].tolist()
    assert circ == [7.0, 0, 1, 2, 3, 4, 5, 6, 7, 0, 1]
    zero = spatial.exchange_halo_lr(x, 1, 2)[0, 0, :, 0].tolist()
    assert zero == [0.0, 0, 1, 2, 3, 4, 5, 6, 7, 0, 0]


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
