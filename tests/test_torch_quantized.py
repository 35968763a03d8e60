"""Port parity for the int8 PTQ serving pipeline, CPU, tiny config.

JAX side: ``tools/export.py::fold_batch_norms``, ``models/quantized.py::
calibrate_scales``/``filter_scope`` and the forward under
``quantization("int8")``: the pipeline ``bench.py``'s ``pipeline_q``
serves. Port side: ``models/quantized.py`` and ``Predictor.quantize``,
with the same weights (flax init, randomised BatchNorm, transplanted).

- ``fold_batch_norms``: every folded leaf equal (the same fp32 operations).
- ``calibrate_scales``: the same key set; values within rtol 2e-2 (fp32
  sums in another order move the absmaxes by noise).
- ``filter_scope("heads")``: the same key set.
- The int8 forward with the JAX quant tree loaded: head outputs within a
  relative RMS of 1e-3 (int8 operands agree except where fp32 noise moves
  a value across a rounding boundary).
- The int8 ``Predictor`` (calibrated by the port) against ``pipeline_q``:
  ``keep`` equal, kept cuboids within 1e-3 m plus 1e-3 relative and
  scores within 1e-3.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.models import quantized as tq
from range_view_3d_detection_torch.transplant import (
    load_flax_variables,
    state_dict_to_flax,
)
from range_view_3d_detection_tpu.models import quantized as jq
from range_view_3d_detection_tpu.models.decoder import DecoderConfig, decode
from range_view_3d_detection_tpu.models.detector import Detector
from test_torch_blocks import numpy_tree, randomize_bn
from tools.export import fold_batch_norms as jax_fold

torch.set_num_threads(2)
B, H, W = 2, 8, 64


@pytest.fixture(scope="module")
def tiny():
    """Flax tiny detector with randomised BN, its batch, and its variables
    with each head's final conv scaled so that NMS has real work."""
    cfg = graft._flagship_config(tiny=True)
    feats, cart, _ = serving._sample_inputs(B, H, W, cfg.in_channels, seed=0)
    mask = np.random.default_rng(1).uniform(size=(B, H, W)) < 0.3
    model = Detector(cfg)
    v = model.init(jax.random.PRNGKey(0), feats, cart, mask, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=2)
    first = model.apply({"params": params, "batch_stats": stats}, feats, cart, mask,
                        train=False)["head"][1][0]
    for name, sub in params["DetectionHead_0"].items():
        final = sub[f"ConvNormAct_{len(sub) - 1}"]["Conv_0"]
        key = "logits" if name.startswith("cls_") else "regressands"
        spread = 2.0 if key == "logits" else 0.3
        final["kernel"] *= spread / float(np.std(np.asarray(first[key])))
        final["bias"][:] = 0.0
        if key == "logits":
            final["bias"][0] = 2.0
        else:
            final["bias"][3:6] = np.log(8.0)
    folded = numpy_tree(jax_fold({"params": params, "batch_stats": stats}))
    qtree = jq.calibrate_scales(model, folded, [(feats, cart, mask)])
    return dict(cfg=cfg, model=model, batch=(feats, cart, mask), params=params,
                stats=stats, folded=folded, qtree=qtree)


def _predictor(t):
    p = serving.Predictor(serving._flagship_config(tiny=True), device="cpu")
    load_flax_variables(p.model, t["params"], t["stats"])
    return p


def _leaves(tree):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(tree)
    }


def test_fold_batch_norms_matches_export(tiny):
    p = _predictor(tiny)
    tq.fold_batch_norms(p.model)
    params, stats = state_dict_to_flax(p.model.state_dict())
    for want, got in ((tiny["folded"]["params"], params),
                      (tiny["folded"]["batch_stats"], stats)):
        want, got = _leaves(want), _leaves(got)
        assert sorted(want) == sorted(got)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_calibrate_scales_matches_flax(tiny):
    p = _predictor(tiny)
    tq.fold_batch_norms(p.model)
    with torch.inference_mode():
        got = _leaves(tq.calibrate_scales(p.model, [tiny["batch"]]))
    want = _leaves(tiny["qtree"])
    assert sorted(got) == sorted(want)
    assert any(k.endswith("stem_hh_scale") for k in want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-2, err_msg=k)


def test_filter_scope_heads_matches_flax(tiny):
    want = jq.filter_scope(tiny["qtree"], "heads")
    got = tq.filter_scope(tiny["qtree"], "heads")
    assert sorted(_leaves(got)) == sorted(_leaves(want))
    assert all(k.startswith("DetectionHead_0/") for k in _leaves(got))
    assert tq.filter_scope(tiny["qtree"], "full") is tiny["qtree"]
    with pytest.raises(ValueError):
        tq.filter_scope(tiny["qtree"], "backbone")


@pytest.mark.parametrize("scope", ["full", "heads"])
def test_int8_forward_with_jax_tree(tiny, scope):
    qtree = jq.filter_scope(tiny["qtree"], scope)
    with jq.quantization("int8"):
        want = tiny["model"].apply({**tiny["folded"], "quant": qtree},
                                   *tiny["batch"], train=False)["head"][1][0]
    p = _predictor(tiny).quantize(quant_tree=tiny["qtree"], scope=scope)
    with torch.inference_mode():
        got = p.model(*(torch.from_numpy(a) for a in tiny["batch"]))["head"][1][0]
    for key in ("logits", "regressands"):
        w = np.asarray(want[key])
        rel_rms = np.sqrt(np.mean((got[key].numpy() - w) ** 2) / np.mean(w**2))
        assert rel_rms < 1e-3, (key, rel_rms)


def test_int8_predictor_matches_bench_pipeline(tiny):
    dec = DecoderConfig()
    with jq.quantization("int8"):
        out = tiny["model"].apply({**tiny["folded"], "quant": tiny["qtree"]},
                                  *tiny["batch"], train=False)
    ref = decode(out, dec, tiny["cfg"].tasks_dict, use_nms=True)
    keep = np.asarray(ref.keep)
    assert keep.sum() > 0

    p = _predictor(tiny).quantize([tiny["batch"]])
    got = p(*tiny["batch"])
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_allclose(
        got.cuboids.numpy()[keep], np.asarray(ref.cuboids)[keep], atol=1e-3, rtol=1e-3
    )
    np.testing.assert_allclose(
        got.scores.numpy()[keep], np.asarray(ref.scores)[keep], atol=1e-3
    )


def test_predictor_quantize_takes_batches_or_a_tree(tiny):
    p = _predictor(tiny)
    with pytest.raises(ValueError):
        p.quantize()
    with pytest.raises(ValueError):
        p.quantize([tiny["batch"]], quant_tree=tiny["qtree"])
