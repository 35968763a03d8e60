"""rv-waymo, the paper's second published configuration, held against the
JAX package on the CPU at its published channel widths.

Both packages build the config from ``compose("conf", "rv-waymo")`` with
their own builders (``build_detector_config``, ``build_decoder_config``):
the META stem at 128 channels, stages of 128, FPN {1: 256} with 256-wide
class and box towers, Waymo's 3 classes and 6 input channels, nms_cap
1024. Cut: one block a stage and a tower, and a B=2 x 8 x 64 image, the
64 as 58 columns padded by 3 a side with constant padding, as
``width_padding`` pads Waymo's 2650 to 2656. Weights: flax init,
randomised BatchNorm statistics, each head's final conv scaled so that
NMS has real work, transplanted into the port
(``tests/test_torch_detector.py::_served_pair``).

- fp32 with the accumulate stem: heads within 1e-3 * max|ref|; ``keep``
  and categories equal; kept cuboids within 1e-3 m plus 1e-4 relative,
  scores within 1e-5 (``test_served_path_flagship_widths``'s tolerance).
  Categories 1-2 get a logit bias of -6 (the class-offset fragility,
  ROADMAP Queue 3).
- bf16 with the fused stem in both packages (the Pallas kernel in
  interpret mode, K1's plain twin): the tolerances of
  ``test_served_path_tiny_bf16``, with the kept-box allowance its
  docstring states.
- int8 on the same calibration tree (``Predictor.quantize(quant_tree=)``
  against the JAX forward under ``quantization("int8")``): heads within a
  relative RMS of 1e-3 (``test_int8_forward_with_jax_tree``'s), and the
  detections to the fp32 tolerance; K3's twin equal bit for bit to the
  JAX ``conv3x3_i8_fused`` in interpret mode at a 256 -> 256 tower conv.
- raw points: the port's ``export.make_points_predict`` with Waymo's
  features, ``dataset_name="waymo"`` and constant padding at a 58-column
  sensor against ``tools/export.py::make_points_predict``'s range image
  (equal; Waymo's tanh intensity plane within 4 ulps), and its detections
  against the JAX model's on that image to the fp32 tolerance.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch import export as texport
from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.kernels import conv as tconv
from range_view_3d_detection_torch.models import blocks as tblocks
from range_view_3d_detection_torch.models import quantized as tquantized
from range_view_3d_detection_torch.training import builders as tbuilders
from range_view_3d_detection_torch.transplant import load_flax_variables
from range_view_3d_detection_torch.utils.config import compose as tcompose
from range_view_3d_detection_tpu.data.dataset import WAYMO_FEATURES, width_padding
from range_view_3d_detection_tpu.kernels.conv_pallas import conv3x3_i8_fused as pallas_conv
from range_view_3d_detection_tpu.models import quantized as jq
from range_view_3d_detection_tpu.models import stems as jstems
from range_view_3d_detection_tpu.models.decoder import decode
from range_view_3d_detection_tpu.models.detector import Detector
from range_view_3d_detection_tpu.training import builders as jbuilders
from range_view_3d_detection_tpu.utils.config import compose as jcompose
from test_torch_blocks import numpy_tree
from test_torch_detector import _check_heads, _check_kept_boxes, _check_nms, _served_pair
from tools import export as jexport
from tools.export import fold_batch_norms as jax_fold

torch.set_num_threads(2)
B, H, SENSOR_W = 2, 8, 58
PAD = width_padding(SENSOR_W, 1)
W = SENSOR_W + 2 * PAD
CUT = dict(stage_blocks=(1,) * 5, num_classification_blocks=1, num_regression_blocks=1)


def _configs(**kw):
    """Each package's rv-waymo detector and decoder configs, from its own
    ``compose`` and builders, with the depth cut and ``kw`` replaced."""
    jraw, traw = jcompose("conf", "rv-waymo"), tcompose("conf", "rv-waymo")
    jcfg = dataclasses.replace(jbuilders.build_detector_config(jraw), **CUT, **kw)
    tcfg = dataclasses.replace(tbuilders.build_detector_config(traw), **CUT, **kw)
    return jcfg, tcfg, jbuilders.build_decoder_config(jraw), tbuilders.build_decoder_config(traw)


@pytest.fixture(scope="module")
def fp32():
    """The fp32 served pair (accumulate stem), its weights and batch."""
    jcfg, tcfg, jdec, tdec = _configs(dtype="float32", stem_pallas=False)
    out, tout, ref, got, (params, stats), batch = _served_pair(
        jcfg, tcfg, B, H, W, seed=3, other_classes_bias=-6.0, return_inputs=True,
        jdec=jdec, tdec=tdec, pad=PAD)
    return dict(jcfg=jcfg, tcfg=tcfg, jdec=jdec, tdec=tdec, out=out, tout=tout, ref=ref,
                got=got, params=params, stats=stats, batch=batch)


def test_configs_are_the_published_ones():
    """Both builders give rv-waymo's published widths, classes, channels,
    decoder and the served dtype, equal field for field; Waymo's 2650 pads
    3 a side to 2656."""
    jraw, traw = jcompose("conf", "rv-waymo"), tcompose("conf", "rv-waymo")
    tcfg, tdec = tbuilders.build_detector_config(traw), tbuilders.build_decoder_config(traw)
    jcfg, jdec = jbuilders.build_detector_config(jraw), jbuilders.build_decoder_config(jraw)
    assert tcfg.layers == (128,) * 5 and tcfg.stage_blocks == (2, 3, 3, 5, 5)
    assert tcfg.fpn == ((1, 256),) and tcfg.fpn_kernel_sizes == ((1, (3, 3)),)
    assert tcfg.classification_head_channels == tcfg.regression_head_channels == 256
    assert tcfg.tasks == ((0, ("CYCLIST", "PEDESTRIAN", "VEHICLE")),)
    assert tcfg.in_channels == 6 and tcfg.stem_type == "META" and tcfg.stem_pallas
    assert tcfg.dtype == "bfloat16" and tdec.nms_cap == 1024
    for name in ("tasks", "in_channels", "layers", "stage_blocks", "fpn", "fpn_kernel_sizes",
                 "classification_head_channels", "regression_head_channels",
                 "num_classification_blocks", "num_regression_blocks", "stem_type",
                 "stem_pallas", "max_boxes", "dtype"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for f in dataclasses.fields(tdec):
        assert getattr(tdec, f.name) == getattr(jdec, f.name), f.name
    assert width_padding(2650, 1) == 3 and width_padding(SENSOR_W, 1) == PAD == 3


def test_served_path_fp32(fp32):
    """fp32, accumulate stem: the module docstring's fp32 tolerance."""
    _check_heads(fp32["out"], fp32["tout"],
                 lambda want: dict(atol=1e-3 * float(np.abs(want).max()), rtol=0))
    _check_nms(fp32["ref"], fp32["got"])
    # Waymo's constant padding: the padded columns hold no return.
    assert not fp32["batch"][2][:, :, :PAD].any() and not fp32["batch"][2][:, :, -PAD:].any()


def test_served_path_bf16_fused_stem():
    """bf16, the served dtype, with ``stem_pallas`` on in both packages:
    the JAX Pallas stem in interpret mode against K1's plain twin.

    Head outputs: max|diff| <= 2^-5 * max|ref| and a relative RMS <= 2^-6
    (``test_served_path_tiny_bf16``'s). Seen at seed 0: logits 0.151 of
    max|ref| 9.62 (relative RMS 1.24e-2), regressands 0.0156 of 3.09
    (2.6e-3). JAX's own two stem paths differ more: its accumulate stem
    against its Pallas stem gives a logit relative RMS of 1.43e-2 (seed 0)
    and 1.02e-2 (seed 1), the port against JAX 1.24e-2 and 0.85e-2; the
    JAX fp32 model against its bf16 one 1.65e-2.

    Kept boxes: the same count an image, matched one to one within
    ``_check_kept_boxes``'s tolerances, all but at most 2 an image. At
    these widths a bf16 ulp moves a box across a merge cluster's edge now
    and then: JAX's accumulate stem against its Pallas stem leaves 0-1
    kept box an image unmatched at seeds 0-3 (and one image one box
    short at seed 3), the port against JAX's Pallas stem 0-2 with equal
    counts (seed 0: 1 and 0). These numbers: ``PYTHONPATH=. python
    tests/test_torch_waymo.py bf16-study 0 1 2 3`` (:func:`bf16_study`).
    """
    jcfg, tcfg, jdec, tdec = _configs()
    assert jcfg.dtype == tcfg.dtype == "bfloat16" and jcfg.stem_pallas and tcfg.stem_pallas
    out, tout, ref, got = _served_pair(jcfg, tcfg, B, H, W, seed=0, jdec=jdec, tdec=tdec,
                                       pad=PAD)
    assert jstems.LAST_STEM_PATH == "pallas_fp"
    for key in ("logits", "regressands"):
        want = np.asarray(out["head"][1][0][key], np.float32)
        have = tout["head"][1][0][key].float().numpy()
        np.testing.assert_allclose(
            have, want, atol=2.0**-5 * float(np.abs(want).max()), rtol=0
        )
        assert np.sqrt(np.mean((have - want) ** 2) / np.mean(want**2)) <= 2.0**-6
    _check_kept_boxes(ref, got, unmatched=2)


@pytest.fixture(scope="module")
def int8(fp32):
    """JAX's folded weights and calibration tree, its int8 heads and
    detections; the port's int8 predictor on that tree, its heads and
    detections, and the inputs of each K3 launch of its forward."""
    jcfg, batch = fp32["jcfg"], fp32["batch"]
    model = Detector(jcfg)
    folded = numpy_tree(jax_fold({"params": fp32["params"], "batch_stats": fp32["stats"]}))
    qtree = jq.calibrate_scales(model, folded, [batch])
    with jq.quantization("int8"):
        out = model.apply({**folded, "quant": qtree}, *batch, train=False)
    ref = decode(out, fp32["jdec"], jcfg.tasks_dict, use_nms=True)

    predictor = serving.Predictor(fp32["tcfg"], fp32["tdec"], device="cpu")
    load_flax_variables(predictor.model, fp32["params"], fp32["stats"])
    predictor.quantize(quant_tree=qtree)
    calls = []

    def capture(x, w, dq, **kw):
        calls.append((x.clone(), w, dq.clone(), kw))
        return tconv.conv3x3_i8_fused(x, w, dq, **kw)

    tblocks.conv3x3_i8_fused = tquantized.conv3x3_i8_fused = capture
    try:
        with torch.inference_mode():
            tout = predictor.model(*(torch.from_numpy(a) for a in batch))
    finally:
        tblocks.conv3x3_i8_fused = tquantized.conv3x3_i8_fused = tconv.conv3x3_i8_fused
    return dict(out=out, ref=ref, tout=tout, got=predictor(*batch), calls=calls)


def test_int8_forward_with_jax_tree(int8):
    """The port's int8 forward on JAX's calibration tree: heads within a
    relative RMS of 1e-3, in fp32, the dtype of
    ``test_int8_forward_with_jax_tree``'s tolerance (in bf16 the int8
    heads differ by the bf16 path's own rounding, as the bf16 test above
    shows for the fp heads); the detections to the fp32 tolerance."""
    for key in ("logits", "regressands"):
        want = np.asarray(int8["out"]["head"][1][0][key])
        have = int8["tout"]["head"][1][0][key].numpy()
        assert np.sqrt(np.mean((have - want) ** 2) / np.mean(want**2)) < 1e-3, key
    assert np.asarray(int8["ref"].keep).sum() > 0
    _check_nms(int8["ref"], int8["got"])


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_k3_twin_equals_pallas_at_a_tower_conv(int8, out_dtype):
    """A 256 -> 256 head-tower conv of the int8 forward, on its captured
    operands (the fp32 activation and ``in_scale``): K3's twin equals the
    JAX Pallas kernel in interpret mode on the quantized activation, and
    its int8 operand form, bit for bit."""
    towers = [c for c in int8["calls"] if c[0].shape[-1] == c[1].shape[-1] == 256]
    assert len(towers) == 2  # one a tower, class and box
    x, w, dq, kw = towers[0]
    assert tuple(x.shape) == (B, H, W, 256) and kw.get("stride_w", 1) == 1
    s_in, tdt = kw["in_scale"], getattr(torch, out_dtype)
    got = tconv.conv3x3_i8_fused(x, w, dq, out_dtype=tdt, in_scale=s_in)
    xq = tconv.quantize_to_int8(x, s_in)
    assert torch.equal(tconv.conv3x3_i8_fused(xq, w, dq, out_dtype=tdt), got)
    want = pallas_conv(jnp.asarray(xq.numpy()), jnp.asarray(w.numpy()), jnp.asarray(dq.numpy()),
                       stride_w=1, out_dtype=jnp.dtype(out_dtype), interpret=True)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


def test_points_predict(fp32):
    """Raw points: 1024 points an image at an 8 x 58 sensor with Waymo's
    six features. JAX's side is ``tools/export.py::make_points_predict``
    around a predict that returns the range image it is given, then the
    same model's forward, decode and NMS: the port's range image equal to
    JAX's (the tanh intensity plane within 4 ulps), its detections to the
    fp32 tolerance."""
    jcfg, params, stats = fp32["jcfg"], fp32["params"], fp32["stats"]
    kw = dict(sensor_width=SENSOR_W, height=H, feature_names=WAYMO_FEATURES,
              dataset_name="waymo", x_stride=1, padding_mode="constant")
    predictor = serving.Predictor(fp32["tcfg"], fp32["tdec"], device="cpu")
    load_flax_variables(predictor.model, params, stats)
    points_predict, extra = texport.make_points_predict(predictor, **kw)
    assert extra == ["elongation", "intensity"]
    assert points_predict.kw["padding_mode"] == "constant" and points_predict.kw["pad"] == PAD
    jrasterize, jextra = jexport.make_points_predict(lambda *image: image, **kw)
    assert jextra == extra
    xyz, laser, intensity = texport._sample_points(B, 1024, H, SENSOR_W, seed=5)
    elongation = np.random.default_rng(6).uniform(0, 2, laser.shape).astype(np.float32)
    clouds = (xyz, laser, elongation, intensity * 3)

    image, want = points_predict.rasterize(*clouds), jrasterize(*clouds)
    assert tuple(image[0].shape) == (B, H, W, 6)
    i = WAYMO_FEATURES.index("intensity")
    got_feats, want_feats = image[0].numpy(), np.asarray(want[0])
    np.testing.assert_array_max_ulp(got_feats[..., i], want_feats[..., i], maxulp=4)
    np.testing.assert_array_equal(np.delete(got_feats, i, -1), np.delete(want_feats, i, -1))
    for a, b in zip(image[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    variables = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
    out = Detector(jcfg).apply(variables, *want, train=False)
    ref = decode(out, fp32["jdec"], jcfg.tasks_dict, use_nms=True)
    assert np.asarray(ref.keep).sum() > 0
    _check_nms(ref, points_predict(*clouds))


def _unmatched(ref, got):
    """Per image: (kept by ``ref``, kept by ``got``, ``ref``'s kept boxes
    with no kept box of ``got`` of their category within 0.05 m)."""
    counts = []
    for b in range(ref.keep.shape[0]):
        kr, kg = np.asarray(ref.keep[b]), np.asarray(got.keep[b])
        rc, gc = np.asarray(ref.cuboids[b])[kr], np.asarray(got.cuboids[b])[kg]
        dist = np.linalg.norm(rc[:, None, :2] - gc[None, :, :2], axis=-1)
        same = np.asarray(ref.categories[b])[kr][:, None] == np.asarray(got.categories[b])[kg]
        dist[~same] = np.inf
        counts.append((int(kr.sum()), int(kg.sum()), int((dist.min(1) > 0.05).sum())))
    return counts


def bf16_study(seeds):
    """The numbers behind :func:`test_served_path_bf16_fused_stem`'s
    tolerances, per seed: the port's heads against JAX's (both on the
    fused stem); the logits' relative RMS of JAX's accumulate stem against its
    Pallas stem, and of JAX's fp32 model against its bf16 one; and the
    kept boxes an image left unmatched by the port and by JAX's accumulate
    stem, each against JAX's Pallas stem."""
    jcfg, tcfg, jdec, tdec = _configs()
    for seed in seeds:
        out, tout, ref, got, (params, stats), batch = _served_pair(
            jcfg, tcfg, B, H, W, seed=seed, return_inputs=True, jdec=jdec, tdec=tdec, pad=PAD)
        variables = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})

        def jax_run(**kw):
            cfg = dataclasses.replace(jcfg, stem_pallas=False, **kw)
            o = Detector(cfg).apply(variables, *(jnp.asarray(a) for a in batch), train=False)
            return np.asarray(o["head"][1][0]["logits"], np.float32), o

        def rel_rms(a, b):
            return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2)))

        port = []
        for key in ("logits", "regressands"):
            a = tout["head"][1][0][key].float().numpy()
            b = np.asarray(out["head"][1][0][key], np.float32)
            port.append(f"{key} max|diff| {np.abs(a - b).max():.3g} of max|ref| "
                        f"{np.abs(b).max():.3g}, relative RMS {rel_rms(a, b):.3g}")
        want = np.asarray(out["head"][1][0]["logits"], np.float32)
        acc_logits, acc_out = jax_run()
        fp32_logits, _ = jax_run(dtype="float32")
        print(f"seed {seed}: port/JAX {'; '.join(port)}; logits relative RMS, JAX "
              f"accumulate/JAX Pallas {rel_rms(acc_logits, want):.3g}, JAX fp32/JAX bf16 "
              f"{rel_rms(fp32_logits, want):.3g}; kept an image against JAX Pallas (its "
              f"count, the other's, unmatched): port {_unmatched(ref, got)}, JAX accumulate "
              f"{_unmatched(ref, decode(acc_out, jdec, jcfg.tasks_dict, use_nms=True))}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_waymo.py bf16-study SEED...
    # (about 40 s a seed, JAX on the CPU).
    import sys

    if sys.argv[1:2] != ["bf16-study"]:
        sys.exit("usage: python tests/test_torch_waymo.py bf16-study SEED...")
    bf16_study([int(s) for s in sys.argv[2:]])
