"""The rest of the model surface, against the JAX package, on the CPU.

- The ``RangePartition`` stem alone (projection kernel 1 and 3) and in the
  tiny detector through ``transplant.load_flax_variables``, in eval with
  randomised BatchNorm statistics: within 1e-4 (``test_torch_stem.py``'s
  fp32 tolerance); with remat on, a train forward and backward equal the
  same step without it bit for bit.
- The fp phase-decomposed transposed conv (``RV3D_DECONV_PHASE=1``)
  against JAX's at the aggregation nodes' shapes, alone and in the
  aggregation block: fp32 within 1e-5 (the JAX package's own phase
  against dilated tolerance, ``tests/test_deconv_phase.py``); and the
  port's phase path against its own dilated path within the same.
- ``MetaKernel`` at 5x5 neighbourhoods and at one and three positional
  layers, eval (accumulate) and train (stacked, batch statistics) against
  flax within 1e-4, the running statistics within 1e-5 of each leaf's
  max.
- ``cart_to_sph``, ``sph_to_cart``, ``yaw_to_quat``, ``quat_to_yaw`` and
  ``iou_3d_aligned`` against the JAX functions on seeded inputs (within
  2e-6 relative plus 1e-6 for the geometry, 1e-5 for the IoU, which
  clips near-degenerate boxes the same way), and on the JAX tests'
  analytic cases; ``make_forward`` against JAX's on the tiny config
  (2e-5) and ``DetectorConfig.fpn_dict`` on both flagships.
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
from range_view_3d_detection_torch.models import stems as tstems
from range_view_3d_detection_torch.ops import geometry as tgeo
from range_view_3d_detection_torch.ops import iou as tiou
from range_view_3d_detection_tpu.models import blocks as jblocks
from range_view_3d_detection_tpu.models import stems as jstems
from range_view_3d_detection_tpu.ops import geometry as jgeo
from range_view_3d_detection_tpu.ops import iou as jiou
from test_torch_blocks import nchw, nhwc, numpy_tree, randomize_bn
from test_torch_spatial import port_config

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _feats_cart(B, H, W, Cin, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
    r = rng.uniform(3, 70, size=(B, H, W, 1)).astype(np.float32)
    d = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    cart = (d / np.linalg.norm(d, axis=-1, keepdims=True) * r).astype(np.float32)
    return feats, cart, rng.uniform(size=(B, H, W)) > 0.2


# -- RangePartition -----------------------------------------------------------------


@pytest.mark.parametrize("pk", [1, 3])
def test_range_partition_matches_flax(pk):
    B, H, W, Cin, C = 2, 4, 16, 5, 8
    feats, cart, mask = _feats_cart(B, H, W, Cin, seed=pk)
    jx = jstems.RangePartition(C, projection_kernel_size=pk)
    m = mask.astype(np.float32)
    v = jx.init(jax.random.PRNGKey(0), feats, cart, m, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=4)
    want = np.asarray(jx.apply({"params": params, "batch_stats": stats}, feats, cart, m,
                               train=False))
    tx = transplant.load_flax_variables(
        tstems.RangePartition(Cin, C, pk).eval(), params, stats)
    with torch.no_grad():
        got = nhwc(tx(nchw(feats), torch.from_numpy(cart), torch.from_numpy(m)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def rp_detector():
    from range_view_3d_detection_tpu.models.detector import Detector
    from test_model import tiny_batch, tiny_config

    jcfg = tiny_config(stem_type="RANGE_PARTITION")
    batch = {k: np.asarray(v) for k, v in tiny_batch(B=2).items()}
    args = (batch["features"], batch["cart"], batch["mask"])
    model = Detector(jcfg)
    v = model.init(jax.random.PRNGKey(0), *args, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=6)
    want = model.apply({"params": params, "batch_stats": stats}, *args, train=False)
    return dict(cfg=port_config(jcfg), params=params, stats=stats, batch=batch, args=args,
                want=jax.tree_util.tree_map(np.asarray, want), jcfg=jcfg)


def test_range_partition_detector_through_transplant(rp_detector):
    from range_view_3d_detection_torch.models.detector import Detector

    d = rp_detector
    model = Detector(d["cfg"], device="cpu")
    assert hasattr(model.RangeNet_0, "RangePartition_0")
    transplant.load_flax_variables(model, d["params"], d["stats"])
    back_params, _ = transplant.state_dict_to_flax(model.state_dict())
    assert set(back_params["RangeNet_0"]) == set(d["params"]["RangeNet_0"])
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in d["args"]))
    for name, want in d["want"]["head"][1][0].items():
        np.testing.assert_allclose(out["head"][1][0][name].numpy(), want, atol=2e-5,
                                   err_msg=name)


def test_range_partition_remat_changes_nothing(rp_detector):
    from range_view_3d_detection_torch.models.detector import (
        Detector,
        detection_loss,
    )

    d = rp_detector
    batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(d["cfg"], remat=remat)
        model = Detector(cfg, device="cpu")
        transplant.load_flax_variables(model, d["params"], d["stats"])
        model.train()
        loss, _ = detection_loss(model(batch["features"], batch["cart"], batch["mask"]),
                                 batch, cfg)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append((loss, grads, model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


# -- the fp phase deconv -------------------------------------------------------------


PHASE_SHAPES = [((3, 8), (1, 4), (1, 2)), ((3, 4), (1, 2), (1, 1))]


@pytest.mark.parametrize("kernel, stride, pad", PHASE_SHAPES, ids=["s4", "s2"])
def test_phase_deconv_matches_jax(kernel, stride, pad, monkeypatch):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 12, 8)).astype(np.float32)
    jx = jblocks.TorchConvTranspose(features=6, kernel_size=kernel, strides=stride,
                                    padding=pad)
    v = numpy_tree(jx.init(jax.random.PRNGKey(0), x)["params"])
    monkeypatch.setenv("RV3D_DECONV_PHASE", "1")
    want = np.asarray(jx.apply({"params": v}, x))
    tx = tblocks.TorchConvTranspose(8, 6, kernel, stride, pad)
    tx.weight.data = torch.from_numpy(
        np.ascontiguousarray(v["kernel"][::-1, ::-1].transpose(2, 3, 0, 1)))
    merges = []
    merge = tblocks.phase_merged_kernel
    monkeypatch.setattr(tblocks, "phase_merged_kernel",
                        lambda *a: merges.append(1) or merge(*a))
    with torch.no_grad():
        got = nhwc(tx(nchw(x)))
        np.testing.assert_allclose(got, want, atol=1e-5)
        monkeypatch.delenv("RV3D_DECONV_PHASE")
        dilated = nhwc(tx(nchw(x)))
    assert merges == [1]  # the phase path ran once, the dilated one without it
    np.testing.assert_allclose(got, dilated, atol=1e-5)


def test_phase_aggregation_block_matches_jax(monkeypatch):
    rng = np.random.default_rng(3)
    x1 = rng.normal(size=(1, 4, 64, 8)).astype(np.float32)
    x2 = rng.normal(size=(1, 4, 16, 12)).astype(np.float32)
    jx = jblocks.AggregationBlock(8, kernel_size=(3, 8), strides=(1, 4), padding=(1, 2),
                                  num_blocks=2)
    v = jx.init(jax.random.PRNGKey(0), x1, x2, False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=7)
    monkeypatch.setenv("RV3D_DECONV_PHASE", "1")
    want = np.asarray(jx.apply({"params": params, "batch_stats": stats}, x1, x2, False))
    tx = transplant.load_flax_variables(
        tblocks.AggregationBlock(12, 8, (3, 8), (1, 4), (1, 2), 2).eval(), params, stats)
    with torch.no_grad():
        got = nhwc(tx(nchw(x1), nchw(x2)))
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- MetaKernel at any neighbourhood and depth -------------------------------------


@pytest.mark.parametrize("n, layers", [(5, 2), (3, 1), (3, 3)])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_meta_kernel_any_neighbourhood_and_depth(n, layers, train):
    B, H, W, Cin, C = 2, 5, 12, 5, 8
    feats, cart, _ = _feats_cart(B, H, W, Cin, seed=n + layers)
    jx = jstems.MetaKernel(C, num_neighbors=n, num_layers=layers)
    v = jx.init(jax.random.PRNGKey(0), feats, cart, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=8)
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, mutated = jx.apply(variables, feats, cart, train=True, mutable=["batch_stats"])
    else:
        want = jx.apply(variables, feats, cart, train=False)
        assert jstems.LAST_STEM_PATH == "accumulate"
    tx = transplant.load_flax_variables(tstems.MetaKernel(Cin, C, n, layers), params, stats)
    tx.train(train)
    with torch.no_grad():
        got = nhwc(tx(nchw(feats), torch.from_numpy(cart)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if train:
        from test_torch_train_step import assert_trees_close

        _, got_stats = transplant.state_dict_to_flax(tx.state_dict())
        assert_trees_close(got_stats, numpy_tree(mutated["batch_stats"]), 1e-5,
                           what="batch_stats")


def test_meta_kernel_refuses_an_even_neighbourhood():
    with pytest.raises(ValueError, match="odd"):
        tstems.MetaKernel(5, 8, num_neighbors=4)


# -- geometry, IoU, make_forward, fpn_dict -----------------------------------------


def _close(got, want, rtol=2e-6, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_geometry_functions_match_jax():
    rng = np.random.default_rng(0)
    xyz = rng.normal(scale=30.0, size=(4, 64, 3)).astype(np.float32)
    sph = np.stack([rng.uniform(-np.pi, np.pi, 256), rng.uniform(-0.5, 0.5, 256),
                    rng.uniform(0.5, 80, 256)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (3, 50)).astype(np.float32)
    quat = rng.normal(size=(3, 50, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    t = torch.from_numpy
    _close(tgeo.cart_to_sph(t(xyz)), jgeo.cart_to_sph(jnp.asarray(xyz)))
    _close(tgeo.sph_to_cart(t(sph)), jgeo.sph_to_cart(jnp.asarray(sph)), atol=1e-5)
    _close(tgeo.yaw_to_quat(t(yaw)), jgeo.yaw_to_quat(jnp.asarray(yaw)))
    _close(tgeo.quat_to_yaw(t(quat)), jgeo.quat_to_yaw(jnp.asarray(quat)))
    # Round trips, as tests/test_geometry.py holds JAX's.
    _close(tgeo.sph_to_cart(tgeo.cart_to_sph(t(xyz))), xyz, atol=1e-4)
    _close(tgeo.quat_to_yaw(tgeo.yaw_to_quat(t(yaw))), yaw, atol=1e-5)


def test_iou_3d_aligned_matches_jax():
    rng = np.random.default_rng(1)
    n = 512
    a = np.concatenate([rng.normal(scale=2, size=(n, 3)), rng.uniform(0.5, 5, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], -1).astype(np.float32)
    b = a + np.concatenate([rng.normal(scale=0.8, size=(n, 3)),
                            rng.normal(scale=0.3, size=(n, 3)).clip(-0.4, 0.4),
                            rng.normal(scale=0.5, size=(n, 1))], -1).astype(np.float32)
    b[: n // 4] = a[: n // 4]  # identical pairs
    got = tiou.iou_3d_aligned(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jiou.iou_3d_aligned(jnp.asarray(a), jnp.asarray(b)))
    assert 0.05 < float((want > 0).mean()) and float(want.max()) > 0.99
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # tests/test_iou.py's analytic cases.
    c = torch.tensor([[0.0, 0.0, 1.0, 4.0, 2.0, 1.5, 0.4]])
    np.testing.assert_allclose(tiou.iou_3d_aligned(c, c).numpy(), [1.0], atol=1e-4)
    lo = torch.tensor([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]])
    hi = torch.tensor([[0.0, 0.0, 1.0, 2.0, 2.0, 2.0, 0.0]])
    np.testing.assert_allclose(tiou.iou_3d_aligned(lo, hi).numpy(), [4.0 / 12.0], atol=1e-3)


def test_make_forward_matches_jax(rp_detector):
    from range_view_3d_detection_torch.training.state import make_forward
    from range_view_3d_detection_tpu.training.state import make_forward as jmake_forward

    d = rp_detector
    variables = {"params": d["params"], "batch_stats": d["stats"]}
    want = jmake_forward(d["jcfg"])(variables, *d["args"])
    forward = make_forward(d["cfg"], device="cpu")
    got = forward(variables, *d["args"])
    for name, w in want["head"][1][0].items():
        np.testing.assert_allclose(got["head"][1][0][name].numpy(), np.asarray(w),
                                   atol=2e-5, err_msg=name)
    # The port's state_dict works as well.
    again = forward(transplant.flax_to_state_dict(d["params"], d["stats"]), *d["args"])
    assert torch.equal(again["head"][1][0]["logits"], got["head"][1][0]["logits"])


def test_fpn_dict_matches_jax():
    for tiny in (False, True):
        jcfg = graft._flagship_config(tiny=tiny)
        tcfg = serving._flagship_config(tiny=tiny)
        assert tcfg.fpn_dict == jcfg.fpn_dict
    cfg = dataclasses.replace(serving._flagship_config(), fpn=((1, 512), (4, 128)))
    assert cfg.fpn_dict == {1: 512, 4: 128}
