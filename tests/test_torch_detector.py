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
log-size regressands) and scores within 1e-5. The tiny config in bf16
(the served dtype) has its own tolerances, in its test's docstring.

The flax side takes jnp arrays: with numpy parameters flax would run the
stem's bf16 ``cart @ pos_0_conv_kernel`` in numpy's bf16 arithmetic,
which rounds after every multiply-add.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.models.decoder import DecoderConfig as TDecoderConfig
from range_view_3d_detection_torch.transplant import load_flax_variables
from range_view_3d_detection_tpu.models.decoder import DecoderConfig, decode
from range_view_3d_detection_tpu.models import stems as jstems
from range_view_3d_detection_tpu.models.detector import Detector
from test_torch_blocks import randomize_bn

torch.set_num_threads(2)


def _served_pair(jcfg, tcfg, B, H, W, seed, other_classes_bias=0.0, return_inputs=False,
                 jdec=DecoderConfig(), tdec=TDecoderConfig(), pad=0, x_stride=1):
    """Both packages' served path on one seeded batch: ``(out, tout, ref,
    got)`` (JAX's head outputs, the port's, JAX's NMS result, the port's),
    and with ``return_inputs`` the weights and the batch. ``jdec`` and
    ``tdec`` are each package's decoder config. ``pad`` > 0: the image is
    ``W - 2 pad`` columns wide, padded to ``W`` as the dataset's constant
    ``padding_mode`` pads it (zero features and points, no returns);
    ``x_stride`` then keeps every ``x_stride``-th column of the padded
    image, as the dataset does, so the model sees ``W / x_stride``."""
    feats, cart, _ = serving._sample_inputs(B, H, W - 2 * pad, jcfg.in_channels, seed=seed)
    mask = np.random.default_rng(seed + 1).uniform(size=(B, H, W - 2 * pad)) < 0.3
    spec = ((0, 0), (0, 0), (pad, pad))
    feats, cart = (np.ascontiguousarray(np.pad(a, spec + ((0, 0),))[:, :, ::x_stride])
                   for a in (feats, cart))
    mask = np.ascontiguousarray(np.pad(mask, spec)[:, :, ::x_stride])
    batch = tuple(jnp.asarray(a) for a in (feats, cart, mask))
    model = Detector(jcfg)
    v = model.init(jax.random.PRNGKey(seed), *batch, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed + 2)

    def apply():
        variables = {"params": params, "batch_stats": stats}
        return model.apply(jax.tree_util.tree_map(jnp.asarray, variables), *batch,
                           train=False)

    # Scale each head's final conv so its outputs have a set spread: random
    # BatchNorm statistics at flagship widths grow activations by orders
    # of magnitude, which would saturate every score at 1.0.
    first = apply()["head"][1][0]
    for name, sub in params["DetectionHead_0"].items():
        final = sub[f"ConvNormAct_{len(sub) - 1}"]["Conv_0"]
        key = "logits" if name.startswith("cls_") else "regressands"
        spread = 2.0 if key == "logits" else 0.3
        final["kernel"] *= spread / float(np.std(np.asarray(first[key], np.float32)))
        final["bias"][:] = 0.0
        if key == "logits":
            final["bias"][1:] = other_classes_bias
            final["bias"][0] = 2.0  # most proposals in category 0
        else:
            final["bias"][3:6] = np.log(8.0)
    out = apply()
    ref = decode(out, jdec, jcfg.tasks_dict, use_nms=True)
    proposals = decode(out, jdec, jcfg.tasks_dict, use_nms=False)
    n_valid = (np.asarray(proposals.scores) >= jdec.min_confidence).sum(-1)
    # Real NMS work: every image keeps some proposals and suppresses some.
    n_keep = np.asarray(ref.keep).sum(-1)
    assert (0 < n_keep).all() and (n_keep < n_valid).all(), (n_keep, n_valid)

    predictor = serving.Predictor(tcfg, tdec, device="cpu")
    load_flax_variables(predictor.model, params, stats)
    with torch.inference_mode():
        tout = predictor.model(
            torch.from_numpy(feats), torch.from_numpy(cart), torch.from_numpy(mask)
        )
    got = predictor(feats, cart, mask)
    if return_inputs:
        return out, tout, ref, got, (params, stats), (feats, cart, mask)
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
    in fp32 on a 2x8x64 image, one block per stage and per head tower,
    the META stem on the accumulate path in both packages. Categories 1-25
    get a logit bias of -6, so the proposals stay in category 0 and every
    kept box is held to the fp32 tolerance: with 26 classes about half of
    them would otherwise land in categories whose class offset lies
    2000-10000 m out, where the two packages' IoUs differ in fp32 and can
    change a merge cluster (ROADMAP Queue 3). The unbiased run is
    :func:`test_served_path_flagship_widths_all_categories`."""
    cut = dict(
        dtype="float32",
        stage_blocks=(1,) * 5,
        num_classification_blocks=1,
        num_regression_blocks=1,
    )
    jcfg = dataclasses.replace(graft._flagship_config(), stem_pallas=False, **cut)
    tcfg = dataclasses.replace(serving._flagship_config(), stem_pallas=False, **cut)
    out, tout, ref, got = _served_pair(jcfg, tcfg, 2, 8, 64, seed=3,
                                       other_classes_bias=-6.0)
    _check_heads(
        out, tout, lambda want: dict(atol=1e-3 * float(np.abs(want).max()), rtol=0)
    )
    _check_nms(ref, got)


def test_served_path_flagship_widths_all_categories():
    """As :func:`test_served_path_flagship_widths`, without the logit bias:
    the proposals spread over the 26 categories (kept in categories 0, 1,
    2, 4, 10, 11, 17, 20 and 25 at this seed), so the NMS runs at class
    offsets up to 10000 m out.

    Held: the head outputs as there; ``keep`` and the categories equal in
    every slot; the merged cuboids and scores of every kept box in
    category 0 to the fp32 tolerance. Outside category 0 at most one kept
    box an image may differ from the reference: at the class offset the
    two packages' fp32 IoUs differ, which can move a box across
    ``merge_threshold`` and so change a cluster's weighted mean (ROADMAP
    Queue 3). Seen: one box, image 1, category 20, its cuboid up to 1.7 m
    off in z and its score 0.9893 against 0.9944; every other kept box
    within the fp32 tolerance.
    """
    cut = dict(
        dtype="float32",
        stage_blocks=(1,) * 5,
        num_classification_blocks=1,
        num_regression_blocks=1,
    )
    jcfg = dataclasses.replace(graft._flagship_config(), stem_pallas=False, **cut)
    tcfg = dataclasses.replace(serving._flagship_config(), stem_pallas=False, **cut)
    out, tout, ref, got = _served_pair(jcfg, tcfg, 2, 8, 64, seed=3)
    _check_heads(
        out, tout, lambda want: dict(atol=1e-3 * float(np.abs(want).max()), rtol=0)
    )
    keep, cats = np.asarray(ref.keep), np.asarray(ref.categories)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal(got.categories.numpy(), cats)
    assert len(np.unique(cats[keep])) >= 5
    rc, gc = np.asarray(ref.cuboids), got.cuboids.numpy()
    rs, gs = np.asarray(ref.scores), got.scores.numpy()
    close = (np.abs(gc - rc) <= 1e-3 + 1e-4 * np.abs(rc)).all(-1) & (
        np.abs(gs - rs) <= 1e-5
    )
    assert close[keep & (cats == 0)].all()
    assert ((keep & ~close).sum(-1) <= 1).all(), np.argwhere(keep & ~close)


def _check_kept_boxes(ref, got, unmatched=0, count=0):
    """The same boxes kept, slot order aside: per image the same count
    (within ``count``), and each reference box matched one to one by a
    kept box of its category whose BEV centre lies within 0.05 m, all but
    at most ``unmatched`` of an image's; matched boxes within
    0.05 m in x, y, z and 5% in l, w, h, scores within 2e-2. The yaw is
    the atan2 of the sin and cos regressands, whose (sin, cos) vectors
    are short with random weights, so a bf16 ulp in either can turn a box
    far: the median yaw difference must stay within 0.01 rad and the 90th
    percentile within 0.1 rad (seen: medians up to 3.1e-3, 90th
    percentiles up to 0.042, one box 0.49)."""
    for b in range(ref.keep.shape[0]):
        kr, kg = np.asarray(ref.keep[b]), got.keep[b].numpy()
        assert abs(int(kr.sum()) - int(kg.sum())) <= count and kr.sum() > 0 and kg.sum() > 0
        rc, gc = np.asarray(ref.cuboids[b])[kr], got.cuboids[b].numpy()[kg]
        rcat = np.asarray(ref.categories[b])[kr]
        gcat = got.categories[b].numpy()[kg]
        dist = np.linalg.norm(rc[:, None, :2] - gc[None, :, :2], axis=-1)
        dist[rcat[:, None] != gcat[None]] = np.inf
        j = dist.argmin(1)
        near = dist[np.arange(len(j)), j] <= 0.05
        assert (~near).sum() <= unmatched, np.argwhere(~near)
        j, rc = j[near], rc[near]
        assert len(set(j.tolist())) == len(j)  # one to one
        gc = gc[j]
        np.testing.assert_allclose(gc[:, :3], rc[:, :3], atol=0.05, rtol=0)
        np.testing.assert_allclose(gc[:, 3:6], rc[:, 3:6], atol=0, rtol=0.05)
        dyaw = np.angle(np.exp(1j * (gc[:, 6] - rc[:, 6])))
        median, p90 = np.quantile(np.abs(dyaw), [0.5, 0.9])
        assert median <= 0.01 and p90 <= 0.1, (median, p90)
        np.testing.assert_allclose(
            got.scores[b].numpy()[kg][j], np.asarray(ref.scores[b])[kr][near], atol=2e-2
        )


@pytest.mark.parametrize("stem_pallas", [False, True], ids=["accumulate", "fused"])
def test_served_path_tiny_bf16(stem_pallas):
    """The tiny config in bf16, the dtype the flagship serves, with the
    META stem on the accumulate path (``stem_pallas=False``) or on the
    fused kernel (JAX: the Pallas kernel in interpret mode; port: K1's
    plain twin).

    Head outputs (the bf16 head convs cast to fp32): max|diff| <= 2^-5 *
    max|ref| and a relative RMS <= 2^-6. The convolutions agree in bf16
    element for element, and the port's BatchNorm computes flax's fp32
    affine in jitted XLA's order (one fused multiply-add); what is left is
    the BN factor ``rsqrt(var + eps) * scale``, which the port rounds
    correctly and XLA's CPU ``rsqrt`` does not (in some channels the two
    factors differ by an ulp). A one-ulp fp32 difference there that lies on
    a bf16 rounding boundary flips one bf16 ulp (2^-8 relative), and the
    flips spread through the later layers; the fused stem adds its own
    (the Pallas kernel and K1's twin round the neighbour terms apart).
    Seen at seed 0: logits within 0.0625 of max|ref| 11.4 on both paths;
    accumulate: 124 of 2048 logits and 110 of 8192 regressands differ,
    relative RMS 2.2e-3 (with ``BatchNorm2d``'s ``x * a + b``: 491, 1816
    and 2.7e-3); fused: 1059 and 4205 differ, relative RMS 4.3e-3.

    ``keep``: slot for slot it differs. bf16 logits carry 8 significant
    bits, so many proposals share a score exactly, and a one-ulp flip
    reorders such ties in the score sort, which permutes the NMS slots.
    So the kept boxes are matched instead (:func:`_check_kept_boxes`).
    Seen: the same counts (102 and 87 kept), every box matched within
    0.021 m of BEV centre, scores within 2.1e-3.
    """
    bf16 = dict(dtype="bfloat16", stem_pallas=stem_pallas)
    out, tout, ref, got = _served_pair(
        dataclasses.replace(graft._flagship_config(tiny=True), **bf16),
        dataclasses.replace(serving._flagship_config(tiny=True), **bf16),
        2, 8, 64, seed=0,
    )
    assert jstems.LAST_STEM_PATH == ("pallas_fp" if stem_pallas else "accumulate")
    for key in ("logits", "regressands"):
        want = np.asarray(out["head"][1][0][key], np.float32)
        have = tout["head"][1][0][key].float().numpy()
        np.testing.assert_allclose(
            have, want, atol=2.0**-5 * float(np.abs(want).max()), rtol=0
        )
        assert np.sqrt(np.mean((have - want) ** 2) / np.mean(want**2)) <= 2.0**-6
    _check_kept_boxes(ref, got)


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
