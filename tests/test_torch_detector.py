"""Port parity for the whole served path: forward -> decode -> NMS, CPU.

JAX: ``Detector.apply(train=False)`` then ``decode(use_nms=True)`` (the
lax scan on the CPU). Port: ``serving.Predictor(device="cpu")`` with the
same weights (flax init, randomised BatchNorm statistics, transplanted).

The final classification layer is set so that scores spread over (0, 1)
and most proposals fall in category 0, and the box sizes to ~8 m, so
that NMS has real, overlapping proposals; a sparse validity mask keeps
about 30% of the pixels, so the score ranking has few near-ties for fp32
noise to swap. Category 0 keeps boxes near the origin: the class-offset
grid moves category k to k * 2000 m, where fp32 rounding of the IoU
clipping differs between the two packages (ROADMAP Queue 3).

Tolerances: head outputs within 1e-4 at tiny widths and within
1e-3 * max|ref| at flagship channel widths (fp32); ``keep`` equal; kept
cuboids within 1e-3 m plus 1e-4 relative (sizes are exponentiated
log-size regressands) and scores within 1e-5.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

import __graft_entry__ as graft
from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.models.decoder import DecoderConfig as TDecoderConfig
from range_view_3d_detection_torch.transplant import load_flax_variables
from range_view_3d_detection_tpu.models.decoder import DecoderConfig, decode
from range_view_3d_detection_tpu.models.detector import Detector
from test_torch_blocks import randomize_bn

torch.set_num_threads(2)


def _served_pair(jcfg, tcfg, B, H, W, seed):
    feats, cart, _ = serving._sample_inputs(B, H, W, jcfg.in_channels, seed=seed)
    mask = np.random.default_rng(seed + 1).uniform(size=(B, H, W)) < 0.3
    model = Detector(jcfg)
    v = model.init(jax.random.PRNGKey(seed), feats, cart, mask, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed + 2)
    # Scale each head's final conv so its outputs have a set spread: random
    # BatchNorm statistics at flagship widths grow activations by orders
    # of magnitude, which would saturate every score at 1.0.
    first = model.apply({"params": params, "batch_stats": stats}, feats, cart, mask,
                        train=False)["head"][1][0]
    for name, sub in params["DetectionHead_0"].items():
        final = sub[f"ConvNormAct_{len(sub) - 1}"]["Conv_0"]
        key = "logits" if name.startswith("cls_") else "regressands"
        spread = 2.0 if key == "logits" else 0.3
        final["kernel"] *= spread / float(np.std(np.asarray(first[key])))
        final["bias"][:] = 0.0
        if key == "logits":
            final["bias"][0] = 2.0  # most proposals in category 0
        else:
            final["bias"][3:6] = np.log(8.0)
    variables = {"params": params, "batch_stats": stats}
    out = model.apply(variables, feats, cart, mask, train=False)
    ref = decode(out, DecoderConfig(), jcfg.tasks_dict, use_nms=True)
    proposals = decode(out, DecoderConfig(), jcfg.tasks_dict, use_nms=False)
    n_valid = (np.asarray(proposals.scores) >= DecoderConfig().min_confidence).sum(-1)
    # Real NMS work: every image keeps some proposals and suppresses some.
    n_keep = np.asarray(ref.keep).sum(-1)
    assert (0 < n_keep).all() and (n_keep < n_valid).all(), (n_keep, n_valid)

    predictor = serving.Predictor(tcfg, TDecoderConfig(), device="cpu")
    load_flax_variables(predictor.model, params, stats)
    with torch.inference_mode():
        tout = predictor.model(
            torch.from_numpy(feats), torch.from_numpy(cart), torch.from_numpy(mask)
        )
    got = predictor(feats, cart, mask)
    return out, tout, ref, got


def _check_heads(out, tout, tol_of):
    for key in ("logits", "regressands"):
        want = np.asarray(out["head"][1][0][key])
        got = tout["head"][1][0][key].numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **tol_of(want))


def _check_nms(ref, got):
    keep = np.asarray(ref.keep)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal(got.categories.numpy(), np.asarray(ref.categories))
    np.testing.assert_allclose(
        got.cuboids.numpy()[keep], np.asarray(ref.cuboids)[keep], atol=1e-3, rtol=1e-4
    )
    np.testing.assert_allclose(
        got.scores.numpy()[keep], np.asarray(ref.scores)[keep], atol=1e-5
    )


def test_served_path_tiny():
    out, tout, ref, got = _served_pair(
        graft._flagship_config(tiny=True), serving._flagship_config(tiny=True),
        2, 8, 64, seed=0,
    )
    _check_heads(out, tout, lambda want: dict(atol=1e-4, rtol=1e-4))
    _check_nms(ref, got)


def test_served_path_flagship_widths():
    """Flagship channel widths (256/128 backbone, 512 towers, 26 classes)
    in fp32 on a 2x8x64 image, one block per stage and per head tower."""
    cut = dict(
        dtype="float32",
        stage_blocks=(1,) * 5,
        num_classification_blocks=1,
        num_regression_blocks=1,
    )
    jcfg = dataclasses.replace(graft._flagship_config(), stem_pallas=False, **cut)
    tcfg = dataclasses.replace(serving._flagship_config(), **cut)
    out, tout, ref, got = _served_pair(jcfg, tcfg, 2, 8, 64, seed=3)
    _check_heads(
        out, tout, lambda want: dict(atol=1e-3 * float(np.abs(want).max()), rtol=0)
    )
    _check_nms(ref, got)


def test_range_net_basic_stem_matches_flax():
    """The BASIC stem + backbone, every multi-scale output, fp32."""
    from range_view_3d_detection_torch.models.backbone import RangeNet as TRangeNet
    from range_view_3d_detection_torch.transplant import load_flax_variables as load
    from range_view_3d_detection_tpu.models.backbone import RangeNet as JRangeNet
    from test_torch_blocks import nchw, nhwc

    layers, blocks = (8, 8, 8, 8, 8), (1, 2, 1, 1, 1)
    feats, cart, mask = serving._sample_inputs(2, 4, 32, 5, seed=4)
    maskf = mask[..., None].astype(np.float32)
    jx = JRangeNet(layers=layers, stage_blocks=blocks, stem_type="BASIC")
    v = jx.init(jax.random.PRNGKey(1), feats, cart, maskf, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=6)
    want = jx.apply({"params": params, "batch_stats": stats}, feats, cart, maskf,
                    train=False)
    tx = load(TRangeNet(5, layers, blocks, stem_type="BASIC").eval(), params, stats)
    with torch.no_grad():
        got = tx(nchw(feats), torch.from_numpy(cart))
    assert sorted(got) == sorted(want) == [1, 2, 4, 16]
    for stride, w in want.items():
        np.testing.assert_allclose(nhwc(got[stride]), np.asarray(w), atol=1e-4, rtol=1e-4)
