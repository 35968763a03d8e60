"""Port parity for the training step, on the CPU.

The tiny config (``_flagship_config(tiny=True)``: META stem, 8-wide
stages of (2, 3, 3, 5, 5) blocks, one 8-wide block per head tower, max_boxes
8) on ``_dryrun_batch(cfg, 2, 8, 64, 5)``; flax initialises the weights,
the BatchNorm affines and running statistics are randomised
(``test_torch_blocks.randomize_bn``), and each head's final conv is
scaled to a set output spread so that the eval step keeps boxes.

Held, fp32:

- BatchNorm train mode (``ConvNormAct``, a strided projecting
  ``BasicBlock``, an ``AggregationBlock`` with its transposed conv) and
  the MetaKernel stacked path (train, and eval with
  ``inference_accumulate=False``) against flax: outputs and the updated
  running statistics within 1e-5 of max|ref|, gradients (train mode) of
  a seeded projection of the output within 1e-4 * max|g_leaf| + 1e-7.
- The detector's train forward and ``detection_loss``: the loss and
  every metric key within 1e-5 relative; the updated running statistics
  within 1e-5 of each leaf's max; the head outputs within 2e-5 of
  max|ref| (seen: 1.07e-5; JAX's fp32 forward is the noisier side, see
  below).
- Gradients, two ways. JAX's fp32 gradients of this 16-block-deep model
  are themselves up to 6.6e-4 * max|g_leaf| from the same math in fp64
  (the port's formulas run in fp64 here, ``_float64_grads``), while the
  port's fp32 gradients are within 4.6e-5 of it; batch-statistics
  BatchNorm makes the gradients of this model that sensitive (1e-6
  relative noise on the input moves the port's by up to 4e-4). So each
  leaf is held to the fp64 evaluation within 1e-4 * max|g_leaf| + 1e-7,
  and to JAX's ``jax.grad`` within 1e-3 * max|g_leaf| + 1e-7.
- Three ``make_train_step`` steps with the OneCycle schedule against the
  JAX ``make_train_step``: the loss of each step within 1e-5 relative;
  running statistics (of the updated parameters after the first step)
  within 1e-4 of each leaf's max (seen: 2.3e-5); parameters within
  1e-5 of each leaf's max plus twice the sum of the three learning rates
  (AdamW's normalised step can turn an element whose gradient is within
  the noise of 0 either way), 98% of them within 1% of that sum; the
  AdamW moments within 10% of each leaf's max, 1% in the median leaf
  (their later gradients are taken at those parameters). The optimizer's
  arithmetic on the same gradients is held to 1e-5 in
  ``test_torch_optim.py``.
- One bf16 step (tolerances in its docstring), and the eval step on the
  trained state against the JAX ``make_eval_step``: keep and categories
  equal, kept boxes within 1e-4 (plus 1e-4 relative on the sizes).

Also here: flax's truncated lecun-normal init, and the BatchNorm eval
factor's cache seeing the optimizer's and the running statistics' writes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from range_view_3d_detection_torch import serving, transplant
from range_view_3d_detection_torch.models import blocks as tblocks
from range_view_3d_detection_torch.models import detector as tdet
from range_view_3d_detection_torch.models.decoder import DecoderConfig as TDecoderConfig
from range_view_3d_detection_torch.models.stems import MetaKernel
from range_view_3d_detection_torch.training import optim as toptim
from range_view_3d_detection_torch.training import state as tstate
from range_view_3d_detection_tpu.models import blocks as jblocks
from range_view_3d_detection_tpu.models import stems as jstems
from range_view_3d_detection_tpu.models.decoder import DecoderConfig
from range_view_3d_detection_tpu.models.detector import (
    Detector,
    compute_batch_targets,
    detection_loss,
)
from range_view_3d_detection_tpu.training import optim as joptim
from range_view_3d_detection_tpu.training import state as jstate
from test_torch_blocks import nchw, nhwc, randomize_bn

torch.set_num_threads(2)
CPU = torch.device("cpu")
DEC = dict(nms_cap=256, num_post_nms=64)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_close(got, want, rel, abs_=0.0, what=""):
    """Each leaf of ``got`` within ``rel * max|want_leaf| + abs_``."""
    g, w = leaves(got), leaves(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= rel * float(np.abs(w[k]).max()) + abs_, (what, k, err)


def close_to_max(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def spread_heads(params, out_head):
    """Scale each head's final conv to a set output spread (as the served
    path test does), category 0 favoured, boxes about 8 m."""
    for name, sub in params["DetectionHead_0"].items():
        final = sub[f"ConvNormAct_{len(sub) - 1}"]["Conv_0"]
        key = "logits" if name.startswith("cls_") else "regressands"
        spread = 2.0 if key == "logits" else 0.3
        final["kernel"] *= spread / float(np.std(np.asarray(out_head[key], np.float32)))
        final["bias"][:] = 0.0
        if key == "logits":
            final["bias"][0] = 2.0
        else:
            final["bias"][3:6] = np.log(8.0)


def port_grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return transplant.state_dict_to_flax(dict(zip(names, grads)))[0]


def jax_loss_fn(model, cfg):
    def fn(params, stats, batch):
        tg = jax.lax.stop_gradient(compute_batch_targets(batch, cfg))
        out, mut = model.apply(
            {"params": params, "batch_stats": stats}, batch["features"], batch["cart"],
            batch["mask"], train=True, mutable=["batch_stats"],
        )
        loss, metrics = detection_loss(out, batch, cfg, tgts=tg)
        return loss, (metrics, mut["batch_stats"], out["head"][1][0])

    return jax.jit(jax.value_and_grad(fn, has_aux=True))


def make_setup(dtype, spread=False, seed=0):
    """The tiny config's weights, statistics and batch; ``seed`` 0 is the
    draw every test uses (``bf16_gradient_study`` takes others)."""
    jcfg = dataclasses.replace(graft._flagship_config(tiny=True), dtype=dtype)
    tcfg = dataclasses.replace(serving._flagship_config(tiny=True), dtype=dtype)
    batch = serving._dryrun_batch(tcfg, 2, 8, 64, 5, seed=1 + seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = Detector(jcfg)
    v = model.init(jax.random.PRNGKey(seed), jb["features"][:1], jb["cart"][:1],
                   jb["mask"][:1], train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=1 + seed)
    out = model.apply({"params": params, "batch_stats": stats}, jb["features"],
                      jb["cart"], jb["mask"], train=False)
    if spread:
        spread_heads(params, out["head"][1][0])
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, jb=jb, model=model, params=params,
                stats=stats)


def port_state(s, tx=None):
    tx = tx if tx is not None else toptim.make_optimizer(1e-3, 20)[0]
    st = tstate.create_state(s["tcfg"], tx, device="cpu")
    transplant.load_flax_variables(st.model, s["params"], s["stats"])
    return st


@pytest.fixture(scope="module")
def fp32():
    s = make_setup("float32")
    j = jax.tree_util.tree_map(jnp.asarray, (s["params"], s["stats"]))
    (loss, (metrics, new_stats, head)), grads = jax_loss_fn(s["model"], s["jcfg"])(
        *j, s["jb"]
    )
    s["jax"] = dict(loss=loss, metrics=metrics, stats=new_stats, head=head, grads=grads)

    st = port_state(s)
    model = st.model.train()
    b = tstate.batch_to_device(s["batch"], CPU)
    with torch.no_grad():
        tg = tdet.compute_batch_targets(b, s["tcfg"])
    out = model(b["features"], b["cart"], b["mask"])
    tloss, tmetrics = tdet.detection_loss(out, b, s["tcfg"], tgts=tg)
    s["port"] = dict(loss=tloss, metrics=tmetrics, head=out["head"][1][0],
                     grads=port_grads(model, tloss),
                     stats=transplant.state_dict_to_flax(model.state_dict())[1])
    return s


# -- modules in train mode ---------------------------------------------------

BLOCKS = {
    "conv-norm-act": (lambda: jblocks.ConvNormAct(8), lambda: tblocks.ConvNormAct(6, 8),
                      (2, 4, 16, 6)),
    "basic-block-strided": (
        lambda: jblocks.BasicBlock(8, strides=(1, 2), project=True),
        lambda: tblocks.BasicBlock(6, 8, strides=(1, 2), project=True),
        (2, 4, 16, 6),
    ),
    "aggregation": (
        lambda: jblocks.AggregationBlock(8, (3, 8), (1, 4), (1, 2), 1),
        lambda: tblocks.AggregationBlock(6, 8, (3, 8), (1, 4), (1, 2), 1),
        None,
    ),
}


def _module_pair(jx, tx, inputs, seed, **kw):
    """(port output, flax output, port grads, flax grads, port stats, flax
    stats) of one train-mode call, the gradients of sum(out * dy)."""
    v = jx.init(jax.random.PRNGKey(seed), *inputs, **kw)
    params, stats = randomize_bn(v["params"], v.get("batch_stats", {}), seed + 1)
    jout = jx.apply({"params": params, "batch_stats": stats}, *inputs, **kw,
                    mutable=["batch_stats"])[0]
    dy = np.random.default_rng(seed + 2).normal(size=jout.shape).astype(np.float32)

    def fn(p):
        out, mut = jx.apply({"params": p, "batch_stats": stats}, *inputs, **kw,
                            mutable=["batch_stats"])
        return jnp.sum(out * dy), (out, mut["batch_stats"])

    (_, (jout, jstats)), jgrads = jax.value_and_grad(fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params)
    )
    transplant.load_flax_variables(tx, params, stats)
    return jout, jstats, jgrads, dy


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_batchnorm_train_mode_matches_flax(name):
    jmake, tmake, shape = BLOCKS[name]
    rng = np.random.default_rng(0)
    if shape is None:  # AggregationBlock(x1 (2, 4, 16, 8), x2 (2, 4, 4, 6))
        inputs = (rng.normal(size=(2, 4, 16, 8)).astype(np.float32),
                  rng.normal(size=(2, 4, 4, 6)).astype(np.float32))
    else:
        inputs = (rng.normal(size=shape).astype(np.float32),)
    tx = tmake()
    jout, jstats, jgrads, dy = _module_pair(jmake(), tx, inputs, seed=3, train=True)
    tx.train()
    out = tx(*(nchw(x) for x in inputs))
    close_to_max(nhwc(out), jout, 1e-5)
    names = [n for n, _ in tx.named_parameters()]
    grads = torch.autograd.grad((out * nchw(dy)).sum(), list(tx.parameters()))
    assert_trees_close(transplant.state_dict_to_flax(dict(zip(names, grads)))[0], jgrads,
                       1e-4, 1e-7, "grads")
    assert_trees_close(transplant.state_dict_to_flax(tx.state_dict())[1], jstats, 1e-5,
                       what="running statistics")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval-stacked"])
def test_meta_kernel_stacked_path_matches_flax(train):
    """Train mode, and eval with ``inference_accumulate=False`` (the same
    stacked code with running statistics)."""
    feats, cart, _ = serving._sample_inputs(2, 8, 64, 5, seed=0)
    jx = jstems.MetaKernel(out_channels=8, inference_accumulate=False)
    tx = MetaKernel(5, 8, inference_accumulate=False)
    jout, jstats, jgrads, dy = _module_pair(jx, tx, (feats, cart), seed=5, train=train)
    assert jstems.LAST_STEM_PATH == "stacked"
    tx.train(train)
    out = tx(nchw(feats), torch.from_numpy(cart))
    close_to_max(nhwc(out), jout, 1e-5)
    if not train:  # the port's eval BatchNorm serves; it takes no gradients
        return
    names = [n for n, _ in tx.named_parameters()]
    grads = torch.autograd.grad((out * nchw(dy)).sum(), list(tx.parameters()))
    assert_trees_close(transplant.state_dict_to_flax(dict(zip(names, grads)))[0], jgrads,
                       1e-4, 1e-7, "grads")
    assert_trees_close(transplant.state_dict_to_flax(tx.state_dict())[1], jstats, 1e-5,
                       what="running statistics")


# -- the detector ------------------------------------------------------------


def test_train_forward_and_loss_match_jax(fp32):
    j, p = fp32["jax"], fp32["port"]
    assert sorted(p["metrics"]) == sorted(j["metrics"])
    for k, v in j["metrics"].items():
        np.testing.assert_allclose(float(p["metrics"][k]), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(p["loss"]), float(j["loss"]), rtol=1e-5)
    assert float(j["metrics"]["total_objects"]) == 2.0
    for key in ("logits", "regressands"):
        close_to_max(p["head"][key].detach().numpy(), j["head"][key], 2e-5)
    assert_trees_close(p["stats"], j["stats"], 1e-5, what="running statistics")


def test_gradients_match_jax(fp32):
    assert_trees_close(fp32["port"]["grads"], fp32["jax"]["grads"], 1e-3, 1e-7, "grads")


def _float64_grads(s, monkeypatch):
    """The port's loss gradients with every fp32 computation in fp64: the
    compute dtype and ``Tensor.float`` patched, parameters and batch
    promoted."""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    monkeypatch.setattr(tdet.DetectorConfig, "compute_dtype",
                        property(lambda self: torch.float64))
    model = port_state(s).model.double().train()
    b = {k: (v.double() if v.is_floating_point() else v)
         for k, v in tstate.batch_to_device(s["batch"], CPU).items()}
    with torch.no_grad():
        tg = tdet.compute_batch_targets(b, s["tcfg"])
    out = model(b["features"], b["cart"], b["mask"])
    assert out["head"][1][0]["logits"].dtype == torch.float64
    loss, _ = tdet.detection_loss(out, b, s["tcfg"], tgts=tg)
    return port_grads(model, loss)


def test_gradients_match_float64_evaluation(fp32, monkeypatch):
    want = _float64_grads(fp32, monkeypatch)
    monkeypatch.undo()
    assert_trees_close(fp32["port"]["grads"], want, 1e-4, 1e-7, "grads")


def _jax_state(s, tx):
    params = jax.tree_util.tree_map(jnp.asarray, s["params"])
    return jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, s["stats"]),
        opt_state=tx.init(params),
    )


@pytest.fixture(scope="module")
def jax_step(fp32):
    jtx, _ = joptim.make_optimizer(1e-3, 20)
    return jtx, jstate.make_train_step(fp32["jcfg"], jtx)


def _train_both(s, jax_step, steps=3):
    """``steps`` steps of each package's ``make_train_step``, OneCycle over
    20 updates from a max learning rate of 1e-3."""
    jtx, jstep = jax_step
    jst = _jax_state(s, jtx)
    st = port_state(s, toptim.make_optimizer(1e-3, 20)[0])
    step = tstate.make_train_step(s["tcfg"])
    losses = []
    for _ in range(steps):
        jst, jm = jstep(jst, s["jb"])
        st, m = step(st, s["batch"])
        losses.append((float(m["loss"]), float(jm["loss"]),
                       float(m["grad_norm"]), float(jm["grad_norm"])))
    return jst, st, losses


def test_three_train_steps_match_jax(fp32, jax_step):
    jst, st, losses = _train_both(fp32, jax_step)
    for got, want, gnorm, jnorm in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(gnorm, jnorm, rtol=1e-3)
    assert st.step == int(jst.step) == 3 and st.opt.updates == 3
    params, stats = transplant.state_dict_to_flax(st.model.state_dict())
    # AdamW moves an element by about lr a step whatever its gradient's
    # size, so an element whose gradient lies within the gradients' noise
    # of 0 can move either way: every element within the sign-flip bound
    # of 2 x the sum of the rates, and 98% of them within 1% of it (seen:
    # 98.9%, the worst 0.19 of it).
    moved = sum(toptim.onecycle_schedule(1e-3, 20)(t) for t in range(3))
    assert_trees_close(params, jst.params, 1e-5, 2.0 * moved, "params")
    got, want = leaves(params), leaves(jst.params)
    within = sum(int((np.abs(got[k] - want[k]) <= 1e-5 * np.abs(want[k]).max()
                      + 1e-2 * moved).sum()) for k in want)
    assert within >= 0.98 * sum(w.size for w in want.values()), within
    # Steps 2 and 3 take the statistics of the updated parameters.
    assert_trees_close(stats, jst.batch_stats, 1e-4, what="batch_stats")
    adam = jst.opt_state[1][0]
    moments = transplant.optax_state_of(st.model, st.opt)
    assert moments["count"] == int(adam.count) == 3
    # The moments of steps 2 and 3 are gradients at parameters that differ
    # as above, which this model's conditioning amplifies (seen: at most
    # 4.9% of a leaf's max, median 0.21% for mu and 0.15% for nu); the
    # optimizer's own arithmetic is held tightly in test_torch_optim.py.
    for name, want in (("mu", adam.mu), ("nu", adam.nu)):
        got, want = leaves(moments[name]), leaves(want)
        r = [float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()) for k in want]
        assert max(r) <= 0.1 and float(np.median(r)) <= 1e-2, (name, max(r), np.median(r))


def test_eval_step_on_trained_state_matches_jax(fp32, jax_step):
    """Heads spread so that boxes are kept; three JAX steps; the trained
    parameters and running statistics transplanted into the port; then
    each package's eval step (and the port's val step)."""
    s = make_setup("float32", spread=True)
    jst, st, _ = _train_both(s, jax_step)
    transplant.load_flax_variables(st.model, jst.params, jst.batch_stats)
    ref = jstate.make_eval_step(s["jcfg"], DecoderConfig(**DEC))(jst, s["jb"])
    got = tstate.make_eval_step(s["tcfg"], TDecoderConfig(**DEC))(st, s["batch"])
    keep = np.asarray(ref.keep)
    assert keep.sum() > 0
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal(got.categories.numpy(), np.asarray(ref.categories))
    np.testing.assert_allclose(got.cuboids.numpy()[keep], np.asarray(ref.cuboids)[keep],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.scores.numpy()[keep], np.asarray(ref.scores)[keep],
                               atol=1e-4)
    result, metrics = tstate.make_val_step(s["tcfg"], TDecoderConfig(**DEC))(st, s["batch"])
    assert torch.equal(result.keep, got.keep)
    assert "val/loss" in metrics and bool(torch.isfinite(metrics["val/loss"]))


def test_bf16_train_step_matches_jax(fp32):
    """One step of the tiny config in bf16 (bf16 convs, fp32 BatchNorm
    and loss), both packages from the same weights as the fp32 tests.

    bf16 keeps 8 significant bits and this model's gradients amplify
    input noise about 400-fold (see the module docstring), so in bf16 the
    gradients of the deep backbone layers are mostly rounding noise in
    both packages (JAX's bf16 gradients are up to 0.54 relative RMS from
    its fp32 ones). Held: the loss and every metric within 2^-6 relative
    (seen: 1.6e-3); the head outputs within 2^-4 of max|ref|, relative RMS
    within 2^-5 (seen: 3.9e-2, 1.3e-2); and for each gradient leaf, the
    port's relative RMS distance from the fp32 gradient at most 4 times
    JAX's, plus 2^-8 (seen: at most 3.1 times, in the deepest backbone
    layers, median 1.2; whether the port rounds more there is an open
    question in ROADMAP.md).
    """
    s = make_setup("bfloat16")
    j = jax.tree_util.tree_map(jnp.asarray, (s["params"], s["stats"]))
    (loss, (metrics, _, head)), grads = jax_loss_fn(s["model"], s["jcfg"])(*j, s["jb"])
    st = port_state(s)
    model = st.model.train()
    b = tstate.batch_to_device(s["batch"], CPU)
    with torch.no_grad():
        tg = tdet.compute_batch_targets(b, s["tcfg"])
    out = model(b["features"], b["cart"], b["mask"])
    assert out["head"][1][0]["logits"].dtype == torch.float32
    tloss, tmetrics = tdet.detection_loss(out, b, s["tcfg"], tgts=tg)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), float(v), rtol=2.0**-6, err_msg=k)
    for key in ("logits", "regressands"):
        have = out["head"][1][0][key].detach().numpy()
        want = np.asarray(head[key], np.float32)
        close_to_max(have, want, 2.0**-4)
        assert np.sqrt(np.mean((have - want) ** 2) / np.mean(want**2)) <= 2.0**-5
    got, want, ref = leaves(port_grads(model, tloss)), leaves(grads), leaves(fp32["jax"]["grads"])

    def rel_rms(x, k):
        return np.sqrt(np.mean((x - ref[k]) ** 2) / np.mean(ref[k] ** 2))

    for k in ref:
        assert rel_rms(got[k], k) <= 4.0 * rel_rms(want[k], k) + 2.0**-8, k


# -- init and the BatchNorm eval factor --------------------------------------


def test_init_is_truncated_lecun_normal():
    """A 3x3 conv with 256 inputs: flax's lecun_normal is a normal cut at
    two standard deviations, scaled so that the sample's std is
    1/sqrt(fan_in)."""
    conv = torch.nn.Conv2d(256, 256, 3)
    tdet.lecun_normal_(conv.weight.data, conv.weight[0].numel(), torch.Generator().manual_seed(0))
    w = conv.weight.detach()
    target = 1.0 / np.sqrt(256 * 9)
    assert abs(float(w.std()) / target - 1.0) <= 0.02
    assert float(w.abs().max()) <= 2.0 * target / 0.87962566103423978
    # The detector draws its convs so.
    model = tdet.Detector(serving._flagship_config(tiny=True), device="cpu")
    w = model.RangeNet_0.RangeBackbone_0.ResidualBlock_0.BasicBlock_0.ConvNormAct_0.Conv_0.weight
    assert float(w.abs().max()) <= 2.0 / np.sqrt(w[0].numel()) / 0.87962566103423978


def test_eval_factor_sees_training_writes():
    """``BatchNorm.eval_mul`` caches ``rsqrt(var + eps) * scale``; a train
    step writes both in place (the running variance in the forward, the
    scale in AdamW), and the next eval uses the new factor."""
    cfg = serving._flagship_config(tiny=True)
    st = tstate.create_state(cfg, toptim.make_optimizer(1e-2, 10, debug=True)[0],
                             device="cpu", generator=torch.Generator().manual_seed(2))
    bn = st.model.RangeNet_0.MetaKernel_0.fusion1_bn
    before = bn.eval_mul().clone()
    st, _ = tstate.make_train_step(cfg)(st, serving._dryrun_batch(cfg, 2, 8, 64, 5))
    fresh = torch.rsqrt((bn.running_var + bn.eps).double()).float() * bn.weight
    assert not torch.equal(bn.eval_mul(), before)
    assert torch.equal(bn.eval_mul(), fresh.detach())


# -- the bf16 gradient study (not a test) ------------------------------------


def _grads(dtype, seed):
    """(JAX gradients, port gradients) as flat leaves, one tiny step."""
    s = make_setup(dtype, seed=seed)
    j = jax.tree_util.tree_map(jnp.asarray, (s["params"], s["stats"]))
    _, jgrads = jax_loss_fn(s["model"], s["jcfg"])(*j, s["jb"])
    model = port_state(s).model.train()
    b = tstate.batch_to_device(s["batch"], CPU)
    with torch.no_grad():
        tg = tdet.compute_batch_targets(b, s["tcfg"])
    out = model(b["features"], b["cart"], b["mask"])
    tloss, _ = tdet.detection_loss(out, b, s["tcfg"], tgts=tg)
    return leaves(jgrads), leaves(port_grads(model, tloss))


def bf16_gradient_study(seeds, deepest="ResidualBlock_4"):
    """For each seed, how far each package's bf16 gradients lie from its
    own fp32 gradients (relative RMS), pooled over the leaves of the
    deepest backbone stage, and the ratio port / JAX; also the median
    per-leaf ratio over every leaf. Prints one line a seed."""
    rows = []
    for seed in seeds:
        j32, p32 = _grads("float32", seed)
        j16, p16 = _grads("bfloat16", seed)
        deep = [k for k in j32 if deepest in k]

        def pooled(x, ref):
            num = sum(float(np.sum((x[k] - ref[k]) ** 2)) for k in deep)
            return np.sqrt(num / sum(float(np.sum(ref[k] ** 2)) for k in deep))

        def rel(x, ref, k):
            return np.sqrt(np.mean((x[k] - ref[k]) ** 2) / np.mean(ref[k] ** 2))

        dj, dp = pooled(j16, j32), pooled(p16, p32)
        per_leaf = [rel(p16, p32, k) / rel(j16, j32, k) for k in j32
                    if np.any(j16[k] != j32[k])]
        rows.append((seed, dp / dj))
        print(f"seed {seed}: deepest stage ({len(deep)} leaves) JAX {dj:.4f} "
              f"port {dp:.4f} ratio {dp / dj:.3f}; median leaf ratio "
              f"{np.median(per_leaf):.3f}, max {np.max(per_leaf):.3f}", flush=True)
    return rows


if __name__ == "__main__":
    # python tests/test_torch_train_step.py [n_seeds]: the bf16 gradient
    # study on the CPU (JAX pinned to the CPU as tests/conftest.py does).
    import sys

    jax.config.update("jax_platforms", "cpu")
    bf16_gradient_study(range(int(sys.argv[1]) if len(sys.argv) > 1 else 8))
