"""The paper's baseline (base-av2) and the repo's fast operating point
(rv-av2-fast), held against the JAX package on the CPU at their published
channel widths.

Both packages build each config from ``compose("conf", name)`` with their
own builders (``build_detector_config``, ``build_decoder_config``, the val
split's ``build_dataset_config``):

- base-av2: the BASIC stem (one projecting ``BasicBlock`` of 1x1 convs,
  5 -> 64), stages (64, 64, 128, 128, 128), FPN {1: 128} with 128-channel
  towers, 26 classes, bf16, nms_cap 1024, AV2's 1800 columns padded by 4
  a side (constant) to 1808.
- rv-av2-fast: the rv-av2 flagship (META stem at 256, stages of 128,
  512-channel towers) at ``x_stride`` 4: 1800 columns padded by 28 a side
  (constant) to 1856, every 4th column kept, so 464 served.

Cut: one block a stage and a tower, B=2 x 8 rows. base-av2's image is 56
columns padded by 4 a side to 64; rv-av2-fast's is 232 columns padded by
``width_padding(232, 4)`` = 12 a side to 256 and strided by 4 to 64, as
the dataset pads and strides a sweep. Weights: flax init, randomised
BatchNorm statistics, each head's final conv scaled so that NMS has real
work, transplanted into the port (``tests/test_torch_detector.py::
_served_pair``).

- fp32 (both; rv-av2-fast on the accumulate stem): heads within 1e-3 *
  max|ref|; ``keep`` and categories equal; kept cuboids within 1e-3 m
  plus 1e-4 relative, scores within 1e-5 (``test_served_path_flagship_
  widths``'s tolerance). Categories 1-25 get a logit bias of -6 (the
  class-offset fragility, ROADMAP Queue 3).
- bf16, the served dtype (base-av2's BASIC stem; rv-av2-fast with the
  fused stem in both packages, the Pallas kernel in interpret mode against
  K1's plain twin): heads within 2^-5 * max|ref| and a relative RMS of
  2^-6; kept boxes matched one to one (``_check_kept_boxes``), the counts
  an image within 3 of JAX's and all but at most 6 an image matched. That
  is the spread of JAX's own two forms: its jitted forward (BatchNorm's
  multiply and add fused) against its eager one (rounded apart) gives
  logits 6.4e-3 to 8.0e-3 apart in relative RMS at base-av2 and keeps
  counts up to 3 apart with up to 5 boxes an image unmatched (base-av2
  seeds 0-3, rv-av2-fast seeds 1-3); the port against JAX's eager forward
  4.3e-3 to 9.8e-3, counts up to 2 apart, up to 6 unmatched. At 26
  classes a bf16 ulp moves a box across a merge cluster's edge now and
  then. ``PYTHONPATH=. python tests/test_torch_published_configs.py
  bf16-study NAME SEED...`` prints these numbers. rv-av2-fast runs seed 1:
  at seed 0 one image's NMS suppresses nothing, which ``_served_pair``
  refuses (it holds real NMS work).
- base-av2 int8 on JAX's calibration tree (``Predictor.quantize(
  quant_tree=)`` against the JAX forward under ``quantization("int8")``):
  heads within a relative RMS of 1e-3 (``test_int8_forward_with_jax_
  tree``'s) of JAX's eager or of its jitted forward, the nearer, and the
  detections to the fp32 tolerance of that form's. JAX's two forms are
  themselves 3.1e-3 to 5.0e-3 apart in the logits and 1.9e-3 to 4.4e-3
  in the regressands (seeds 3-5): a BatchNorm output one fp32 ulp apart
  (the eager form rounds the multiply and the add apart, the jitted one
  fuses them) now and then rounds the next conv's int8 input the other
  way, and the stages amplify it. The port is within 6e-8 of one of them
  at each of those seeds, the jitted one at seeds 3 and 4, the eager one
  at 5 (seen at seed 3: 5.1e-8 from the jitted form, 3.1e-3 from the
  eager one). The BASIC stem's three 1x1 convs (5 -> 64, 64 -> 64 and
  the projection) are calibrated and take the int8 product of the JAX
  ``lax.conv`` (``route`` "matmul"), the backbone's 3x3 convs K3.
- base-av2, one train step (``detection_loss`` and its gradients on a
  ``_dryrun_batch``): the fp32 loss and every metric within 1e-5
  relative of JAX's (``tests/test_torch_train_step.py``'s gate); each
  gradient leaf within 1e-3 * max|g_leaf| + 1e-7 of ``jax.grad``'s (its
  gate), both packages evaluated in fp64, as ``tests/test_torch_mesh.py``
  holds its step (seen: 8.3e-9 of a leaf's max; the fp32 losses 6.5e-7
  apart). In fp32 neither package's gradient is a referee at these
  widths: against the fp64 evaluation JAX's is 1.9-3.1% of a leaf's max
  off at three of seeds 0-3 (the aggregation nodes' transposed convs and
  BatchNorms) and the port's 2.6% and 15% at two, each within 2e-5 of it
  at the others; on a 16 x 128 image both are 1.2-4.9% off.
- rv-av2-fast raw points: the port's ``export.make_points_predict`` with
  AV2's features, constant padding and ``x_stride`` 4 at a 232-column
  sensor against ``tools/export.py::make_points_predict``'s range image
  (equal), and its detections against the JAX model's on that image to
  the fp32 tolerance.
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
from range_view_3d_detection_torch.models import detector as tdet
from range_view_3d_detection_torch.models.blocks import BasicBlock as TBasicBlock
from range_view_3d_detection_torch.models.quantized import Int8Conv
from range_view_3d_detection_torch.training import builders as tbuilders
from range_view_3d_detection_torch.training import optim as toptim
from range_view_3d_detection_torch.training import state as tstate
from range_view_3d_detection_torch.transplant import load_flax_variables
from range_view_3d_detection_torch.utils.config import compose as tcompose
from range_view_3d_detection_tpu.data.dataset import AV2_FEATURES, width_padding
from range_view_3d_detection_tpu.models import quantized as jq
from range_view_3d_detection_tpu.models import stems as jstems
from range_view_3d_detection_tpu.models.decoder import decode
from range_view_3d_detection_tpu.models.detector import Detector
from range_view_3d_detection_tpu.training import builders as jbuilders
from range_view_3d_detection_tpu.utils.config import compose as jcompose
from test_torch_blocks import numpy_tree, randomize_bn
from test_torch_detector import _check_heads, _check_kept_boxes, _check_nms, _served_pair
from test_torch_train_step import _float64_grads, assert_trees_close, jax_loss_fn
from tools import export as jexport
from tools.export import fold_batch_norms as jax_fold

torch.set_num_threads(2)
B, H = 2, 8
CUT = dict(stage_blocks=(1,) * 5, num_classification_blocks=1, num_regression_blocks=1)
# Each config's cut image: (sensor columns, x_stride); served 64 wide.
IMAGES = {"base-av2": (56, 1), "rv-av2-fast": (232, 4)}


def _image(name):
    """``(sensor width, pad a side, padded width, x_stride)`` of ``name``'s
    cut image."""
    sensor, stride = IMAGES[name]
    pad = width_padding(sensor, stride)
    return sensor, pad, sensor + 2 * pad, stride


def _configs(name, **kw):
    """Each package's detector and decoder configs for ``name``, from its
    own ``compose`` and builders, with the depth cut and ``kw`` replaced."""
    jraw, traw = jcompose("conf", name), tcompose("conf", name)
    jcfg = dataclasses.replace(jbuilders.build_detector_config(jraw), **CUT, **kw)
    tcfg = dataclasses.replace(tbuilders.build_detector_config(traw), **CUT, **kw)
    return jcfg, tcfg, jbuilders.build_decoder_config(jraw), tbuilders.build_decoder_config(traw)


def _pair(name, seed, **kw):
    """The served pair of ``name`` (``_served_pair`` on its cut image)."""
    jcfg, tcfg, jdec, tdec = _configs(name, **kw)
    _, pad, padded, stride = _image(name)
    return (jcfg, tcfg, jdec, tdec), _served_pair(
        jcfg, tcfg, B, H, padded, seed=seed, jdec=jdec, tdec=tdec, pad=pad, x_stride=stride,
        other_classes_bias=-6.0 if kw.get("dtype") == "float32" else 0.0,
        return_inputs=kw.get("dtype") == "float32")


PUBLISHED = {
    # name: (stem, layers, FPN, tower width, stem_pallas, pad, served width, x_stride)
    "base-av2": ("BASIC", (64, 64, 128, 128, 128), ((1, 128),), 128, False, 4, 1808, 1),
    "rv-av2-fast": ("META", (256,) + (128,) * 4, ((1, 512),), 512, True, 28, 464, 4),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_configs_are_the_published_ones(name):
    """Both builders give the config's published widths, classes, stem,
    decoder and layout, equal field for field: AV2's 64 x 1800 sensor,
    its five features, constant padding, and the served width."""
    stem, layers, fpn, towers, pallas, pad, served, stride = PUBLISHED[name]
    jraw, traw = jcompose("conf", name), tcompose("conf", name)
    tcfg, tdec = tbuilders.build_detector_config(traw), tbuilders.build_decoder_config(traw)
    jcfg, jdec = jbuilders.build_detector_config(jraw), jbuilders.build_decoder_config(jraw)
    assert tcfg.stem_type == stem and tcfg.layers == layers and tcfg.fpn == fpn
    assert tcfg.stage_blocks == (2, 3, 3, 5, 5) and tcfg.stem_pallas == pallas
    assert tcfg.classification_head_channels == tcfg.regression_head_channels == towers
    assert tcfg.num_classification_blocks == tcfg.num_regression_blocks == 4
    assert len(tcfg.tasks_dict[0]) == 26 and tcfg.in_channels == 5
    assert tcfg.dtype == "bfloat16" and tdec.nms_cap == 1024 and tdec.nms_mode == "WEIGHTED"
    assert tcfg.projection_kernel_size == 1
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(got):  # each package's own TargetsConfig
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    for f in dataclasses.fields(tdec):
        assert getattr(tdec, f.name) == getattr(jdec, f.name), f.name
    for ds in (tbuilders.build_dataset_config(traw, "val"),
               jbuilders.build_dataset_config(jraw, "val")):
        rv = ds.range_view
        assert (rv.height, rv.width) == (64, 1800) and ds.x_stride == stride
        assert ds.padding_mode == "constant" and tuple(rv.feature_column_names) == AV2_FEATURES
        assert ds.dataset_name == "av2"
    assert tbuilders.build_dataset_config(traw, "train").x_stride == stride
    assert width_padding(1800, stride) == pad and (1800 + 2 * pad) // stride == served


# -- base-av2 ---------------------------------------------------------------


@pytest.fixture(scope="module")
def base_fp32():
    """base-av2's fp32 served pair, its weights and batch."""
    (jcfg, tcfg, jdec, tdec), (out, tout, ref, got, (params, stats), batch) = _pair(
        "base-av2", seed=3, dtype="float32")
    return dict(jcfg=jcfg, tcfg=tcfg, jdec=jdec, tdec=tdec, out=out, tout=tout, ref=ref,
                got=got, params=params, stats=stats, batch=batch)


def test_base_served_path_fp32(base_fp32):
    """fp32, the BASIC stem: the module docstring's fp32 tolerance; AV2's
    constant padding leaves the 4 padded columns a side without returns."""
    _check_heads(base_fp32["out"], base_fp32["tout"],
                 lambda want: dict(atol=1e-3 * float(np.abs(want).max()), rtol=0))
    _check_nms(base_fp32["ref"], base_fp32["got"])
    mask = base_fp32["batch"][2]
    assert mask.shape == (B, H, 64) and not mask[:, :, :4].any() and not mask[:, :, -4:].any()


def test_base_served_path_bf16():
    """bf16, base-av2's served dtype: the module docstring's bf16
    tolerance."""
    (jcfg, tcfg, _, _), (out, tout, ref, got) = _pair("base-av2", seed=0)
    assert jcfg.dtype == tcfg.dtype == "bfloat16" and tcfg.stem_type == "BASIC"
    _check_bf16(out, tout, ref, got)


def _check_bf16(out, tout, ref, got):
    """The module docstring's bf16 tolerance."""
    for key in ("logits", "regressands"):
        want = np.asarray(out["head"][1][0][key], np.float32)
        have = tout["head"][1][0][key].float().numpy()
        np.testing.assert_allclose(have, want, atol=2.0**-5 * float(np.abs(want).max()), rtol=0)
        assert np.sqrt(np.mean((have - want) ** 2) / np.mean(want**2)) <= 2.0**-6
    _check_kept_boxes(ref, got, unmatched=6, count=3)


@pytest.fixture(scope="module")
def base_int8(base_fp32):
    """JAX's folded weights and calibration tree, its int8 heads and
    detections; the port's int8 predictor on that tree and its heads."""
    jcfg, batch = base_fp32["jcfg"], base_fp32["batch"]
    model = Detector(jcfg)
    folded = numpy_tree(jax_fold({"params": base_fp32["params"],
                                  "batch_stats": base_fp32["stats"]}))
    qtree = jq.calibrate_scales(model, folded, [batch])
    variables = jax.tree_util.tree_map(jnp.asarray, {**folded, "quant": qtree})
    with jq.quantization("int8"):
        forms = {"eager": model.apply(variables, *batch, train=False),
                 "jit": jax.jit(lambda v, *b: model.apply(v, *b, train=False))(
                     variables, *(jnp.asarray(a) for a in batch))}
    predictor = serving.Predictor(base_fp32["tcfg"], base_fp32["tdec"], device="cpu")
    load_flax_variables(predictor.model, base_fp32["params"], base_fp32["stats"])
    predictor.quantize(quant_tree=qtree)
    with torch.inference_mode():
        tout = predictor.model(*(torch.from_numpy(a) for a in batch))
    return dict(qtree=qtree, forms=forms, tout=tout, got=predictor(*batch),
                predictor=predictor, jdec=base_fp32["jdec"], tasks=jcfg.tasks_dict)


def test_base_int8_forward_with_jax_tree(base_int8):
    """base-av2's int8 forward on JAX's calibration tree: heads within a
    relative RMS of 1e-3 (fp32 heads) of the nearer of JAX's eager and
    jitted forwards, the detections to the fp32 tolerance of that form's
    (the module docstring)."""

    def rel_rms(out):
        return max(float(np.sqrt(np.mean((have - want) ** 2) / np.mean(want**2)))
                   for have, want in ((base_int8["tout"]["head"][1][0][k].numpy(),
                                       np.asarray(out["head"][1][0][k]))
                                      for k in ("logits", "regressands")))

    dist = {form: rel_rms(out) for form, out in base_int8["forms"].items()}
    form = min(dist, key=dist.get)
    assert dist[form] < 1e-3, dist
    ref = decode(base_int8["forms"][form], base_int8["jdec"], base_int8["tasks"], use_nms=True)
    assert np.asarray(ref.keep).sum() > 0
    _check_nms(ref, base_int8["got"])


def test_base_int8_stem_routes_and_calibration(base_int8):
    """The BASIC stem under int8: JAX's tree calibrates its three 1x1
    convs (``BasicBlock_0``'s two and its projection), the port quantizes
    each of them with that tree's scale, and each takes the int8 product
    that JAX's ``lax.conv`` computes (route "matmul": JAX's
    ``_use_conv_pallas`` takes only 3x3 convs); every 3x3 conv of the
    backbone and heads takes K3."""
    stem_tree = base_int8["qtree"]["RangeNet_0"]["BasicBlock_0"]
    assert sorted(stem_tree) == ["ConvNormAct_0", "ConvNormAct_1", "ConvNormAct_2"]
    model = base_int8["predictor"].model
    stem = model.RangeNet_0.BasicBlock_0
    assert isinstance(stem, TBasicBlock)
    convs = {n: m for n, m in stem.named_modules() if isinstance(m, Int8Conv)}
    assert len(convs) == 3, sorted(convs)
    for name, conv in convs.items():
        assert conv.kernel_size == (1, 1) and conv.route == "matmul", name
        key = name.split(".")[0]
        np.testing.assert_array_equal(conv.in_scale.numpy(),
                                      np.asarray(stem_tree[key]["in_scale"], np.float32))
    routes = {m.route for n, m in model.named_modules()
              if isinstance(m, Int8Conv) and m.kernel_size == (3, 3)}
    assert routes == {"k3"}


@pytest.fixture(scope="module")
def base_step(base_fp32):
    """One train step of base-av2 (cut) on a ``_dryrun_batch``, flax init
    with randomised BatchNorm affines and statistics: each package's fp32
    loss and metrics, and each package's gradients with every computation
    in fp64 (the port's ``_float64_grads``; JAX under x64 with
    ``jnp.float32`` read as fp64, ``tests/test_torch_mesh.py``'s form)."""
    jcfg, tcfg = base_fp32["jcfg"], base_fp32["tcfg"]
    batch = serving._dryrun_batch(tcfg, B, H, 64, 5, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = Detector(jcfg)
    v = model.init(jax.random.PRNGKey(0), jb["features"][:1], jb["cart"][:1], jb["mask"][:1],
                   train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=1)
    j = jax.tree_util.tree_map(jnp.asarray, (params, stats))
    (loss, (metrics, _, _)), _ = jax_loss_fn(model, jcfg)(*j, jb)

    st = tstate.create_state(tcfg, toptim.make_optimizer(1e-3, 20)[0], device="cpu")
    load_flax_variables(st.model, params, stats)
    tmodel = st.model.train()
    b = tstate.batch_to_device(batch, torch.device("cpu"))
    with torch.no_grad():
        tg = tdet.compute_batch_targets(b, tcfg)
        tloss, tmetrics = tdet.detection_loss(tmodel(b["features"], b["cart"], b["mask"]), b,
                                              tcfg, tgts=tg)

    mp = pytest.MonkeyPatch()
    try:
        tgrads = _float64_grads(dict(tcfg=tcfg, params=params, stats=stats, batch=batch), mp)
        mp.undo()
        with jax.enable_x64(True):
            mp.setattr(jnp, "float32", jnp.float64)

            def f64(tree):
                return jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, jnp.float64 if np.asarray(a).dtype.kind == "f"
                                          else np.asarray(a).dtype), tree)

            (loss64, _), grads64 = jax_loss_fn(model, jcfg)(f64(params), f64(stats), f64(batch))
            assert loss64.dtype == jnp.float64
            grads64 = numpy_tree(grads64)
    finally:
        mp.undo()
    return dict(loss=float(loss), metrics={k: float(x) for k, x in metrics.items()},
                tloss=float(tloss), tmetrics={k: float(x) for k, x in tmetrics.items()},
                tgrads=tgrads, grads64=grads64, loss64=float(loss64))


def test_base_train_loss_matches_jax(base_step):
    """base-av2's fp32 train forward and ``detection_loss``: the loss and
    every metric within 1e-5 relative of JAX's (the module docstring)."""
    assert base_step["metrics"]["total_objects"] > 0
    assert sorted(base_step["tmetrics"]) == sorted(base_step["metrics"])
    for k, want in base_step["metrics"].items():
        np.testing.assert_allclose(base_step["tmetrics"][k], want, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(base_step["tloss"], base_step["loss"], rtol=1e-5)
    np.testing.assert_allclose(base_step["loss"], base_step["loss64"], rtol=1e-5)


def test_base_train_gradients_match_jax(base_step):
    """base-av2's gradients, the BASIC stem's backward among them, each
    leaf within 1e-3 * max|g_leaf| + 1e-7 of JAX's, both evaluated in
    fp64 (the module docstring says why not in fp32)."""
    assert "BasicBlock_0" in base_step["tgrads"]["RangeNet_0"]
    assert_trees_close(base_step["tgrads"], base_step["grads64"], 1e-3, 1e-7, "grads")


# -- rv-av2-fast ------------------------------------------------------------


@pytest.fixture(scope="module")
def fast_fp32():
    """rv-av2-fast's fp32 served pair (accumulate stem), weights, batch."""
    (jcfg, tcfg, jdec, tdec), (out, tout, ref, got, (params, stats), batch) = _pair(
        "rv-av2-fast", seed=3, dtype="float32", stem_pallas=False)
    return dict(jcfg=jcfg, tcfg=tcfg, jdec=jdec, tdec=tdec, out=out, tout=tout, ref=ref,
                got=got, params=params, stats=stats, batch=batch)


def test_fast_served_path_fp32(fast_fp32):
    """fp32 at x_stride 4: the module docstring's fp32 tolerance. The 12
    padded columns a side leave 3 strided columns without returns."""
    _check_heads(fast_fp32["out"], fast_fp32["tout"],
                 lambda want: dict(atol=1e-3 * float(np.abs(want).max()), rtol=0))
    _check_nms(fast_fp32["ref"], fast_fp32["got"])
    mask = fast_fp32["batch"][2]
    assert mask.shape == (B, H, 64) and not mask[:, :, :3].any() and not mask[:, :, -3:].any()
    assert mask[:, :, 3:-3].any()


def test_fast_served_path_bf16_fused_stem():
    """bf16 with ``stem_pallas`` on in both packages (the JAX Pallas stem
    in interpret mode against K1's plain twin) at x_stride 4: the module
    docstring's bf16 tolerance."""
    (jcfg, tcfg, _, _), (out, tout, ref, got) = _pair("rv-av2-fast", seed=1)
    assert jcfg.dtype == tcfg.dtype == "bfloat16" and jcfg.stem_pallas and tcfg.stem_pallas
    assert jstems.LAST_STEM_PATH == "pallas_fp"
    _check_bf16(out, tout, ref, got)


def test_fast_points_predict(fast_fp32):
    """Raw points at x_stride 4: 1024 points an image at an 8 x 232
    sensor with AV2's features and constant padding, 256 columns strided
    to 64. JAX's side is ``tools/export.py::make_points_predict`` around a
    predict that returns the range image it is given, then the same
    model's forward, decode and NMS: the range images equal, the
    detections to the fp32 tolerance."""
    sensor, pad, _, stride = _image("rv-av2-fast")
    jcfg, params, stats = fast_fp32["jcfg"], fast_fp32["params"], fast_fp32["stats"]
    kw = dict(sensor_width=sensor, height=H, feature_names=AV2_FEATURES, dataset_name="av2",
              x_stride=stride, padding_mode="constant")
    predictor = serving.Predictor(fast_fp32["tcfg"], fast_fp32["tdec"], device="cpu")
    load_flax_variables(predictor.model, params, stats)
    points_predict, extra = texport.make_points_predict(predictor, **kw)
    assert extra == ["intensity"] and points_predict.kw["pad"] == pad == 12
    assert points_predict.kw["x_stride"] == 4 and points_predict.kw["padding_mode"] == "constant"
    jrasterize, jextra = jexport.make_points_predict(lambda *image: image, **kw)
    assert jextra == extra
    xyz, laser, intensity = texport._sample_points(B, 1024, H, sensor, seed=5)
    clouds = (xyz, laser, intensity)

    image, want = points_predict.rasterize(*clouds), jrasterize(*clouds)
    assert tuple(image[0].shape) == (B, H, 64, 5)
    for a, b in zip(image, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mask = image[2].numpy()
    assert not mask[:, :, :3].any() and not mask[:, :, -3:].any() and mask.any()

    variables = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
    out = Detector(jcfg).apply(variables, *want, train=False)
    ref = decode(out, fast_fp32["jdec"], jcfg.tasks_dict, use_nms=True)
    assert np.asarray(ref.keep).sum() > 0
    _check_nms(ref, points_predict(*clouds))


def bf16_study(name, seeds):
    """The numbers behind the module docstring's bf16 tolerance, per seed:
    the port's heads against JAX's eager forward, and JAX's jitted forward
    against its eager one (relative RMS); the kept boxes an image (the
    reference's count, the other's, the reference's left unmatched) of
    each against JAX's eager forward."""
    from test_torch_waymo import _unmatched

    def rel_rms(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2)))

    jcfg, tcfg, jdec, tdec = _configs(name)
    _, pad, padded, stride = _image(name)
    for seed in seeds:
        try:
            out, tout, ref, got, (params, stats), batch = _served_pair(
                jcfg, tcfg, B, H, padded, seed=seed, jdec=jdec, tdec=tdec, pad=pad,
                x_stride=stride, return_inputs=True)
        except AssertionError as e:  # the helper holds real NMS work
            print(f"{name} seed {seed}: refused by _served_pair: {e}")
            continue
        variables = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
        jitted = jax.jit(lambda v, *b: Detector(jcfg).apply(v, *b, train=False))(
            variables, *(jnp.asarray(a) for a in batch))
        parts = []
        for key in ("logits", "regressands"):
            want = np.asarray(out["head"][1][0][key], np.float32)
            have = tout["head"][1][0][key].float().numpy()
            other = np.asarray(jitted["head"][1][0][key], np.float32)
            parts.append(f"{key} port {rel_rms(have, want):.3g}, JAX jitted "
                         f"{rel_rms(other, want):.3g}")
        print(f"{name} seed {seed}: relative RMS against JAX eager: {'; '.join(parts)}; kept "
              f"an image (JAX eager, other, unmatched): port {_unmatched(ref, got)}, JAX "
              f"jitted {_unmatched(ref, decode(jitted, jdec, jcfg.tasks_dict, use_nms=True))}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_published_configs.py bf16-study NAME SEED...
    # (about 15 s a seed, JAX on the CPU).
    import sys

    if sys.argv[1:2] != ["bf16-study"] or sys.argv[2] not in IMAGES:
        sys.exit("usage: python tests/test_torch_published_configs.py bf16-study "
                 "base-av2|rv-av2-fast SEED...")
    bf16_study(sys.argv[2], [int(s) for s in sys.argv[3:]])
