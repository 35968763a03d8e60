"""The four other published experiments as their users run them
(``chip_smoke.py`` phase 49's path), held against the JAX package on the
CPU, on corpora converted by the port's converters.

- The AV2 corpus: phase 29's raw logs (``chip_smoke.RAW_AV2_LOGS``: a
  train log of 4 sweeps and a val log of 2, 4000 points a sweep) converted
  by the port's converter at 64 rows (the AV2 converter writes 64 or 32
  rows only) and at phase 46's small sensors: 250 columns for base-av2
  (padded by 3 a side to 256) and 1000 for rv-av2-fast (padded by 12 a
  side to 1024, every 4th column kept: 256). Both packages'
  ``RangeViewDataset`` on each package's ``build_dataset_config`` of the
  config, in both splits, the train split with the config's published
  augmentations, over two epochs: every array equal bit for bit, the
  ``x_stride`` 4 decimation included.
- Both Trainers at base-av2's and rv-av2-fast's layouts on those corpora,
  cut as ``tests/test_torch_waymo_user.py`` cuts rv-waymo (stages of 8,
  FPN {1: 16}, 8-wide towers of one block, nms_cap 128, the stem on the
  accumulate path), fp32 without augmentations at the debug-overfit's
  constant rate (JAX's OneCycle is NaN at 1-3 steps: ROADMAP Queue 3),
  one epoch of two B=2 steps from the port's initial state (carried into
  the JAX Trainer by ``transplant.state_dict_to_flax``: JAX's eager init
  of the model takes 17-22 s a config on an 8-core CPU host), each step
  also taken again by the port from the JAX Trainer's state and batch:
  each step's loss and loss terms within 1e-4 relative,
  ``grad_norm`` within 1e-3 at the first step and 5e-2 after (the gates
  of ``tests/test_torch_trainer.py``).
- The AV2 evaluator with its ROI (``detection_cfg_factory("av2")``) on
  each Trainer's shards, scored by the port and by JAX: equal under ``==``.
- The artifacts of the four configs: a port run of each (``train.main``
  on the CPU at its published dtype, bf16, with the widths cut as above
  and one epoch: base-av2 and rv-av2-fast on the AV2 corpora, rv-nuscenes
  on the nuScenes scene of ``chip_smoke.write_raw_nuscenes`` converted at
  32 x 248, base-waymo on two Waymo frames converted at 8 x 250 with the
  min-points filter off, as ``tests/test_torch_waymo_user.py`` sets it for
  its small sensor), written
  by ``export.main(["--run-dir", RUN, "--out", ART, "--device", "cpu"])``
  and once more with ``--quantize``. The bf16 artifact loaded back equals
  bit for bit the port's ``Predictor`` on the run restored in memory
  (``export._restore_from_run_dir``) and folded, on B=2 requests of the
  val sweeps (``chip_smoke.corpus_requests``); JAX's ``tools/export.py``
  reads its configs back equal to JAX's own build of the run's config,
  and JAX's fold of the restored tree equals its weights bit for bit. The
  int8 artifact's weights and quant tree served in fp32 by the port
  against JAX's int8 forward on the same (``quantization("int8")``), as
  ``tests/test_torch_quantized.py::test_int8_forward_with_jax_tree`` holds
  int8 in fp32: the heads within a relative RMS of 1e-3 of JAX's eager or
  jitted forward, the nearer (the tolerance and the reason for two forms:
  ``tests/test_torch_published_configs.py``). In bf16 no such gate holds:
  JAX's own two forms of these artifacts are 2.5e-2 apart at base-av2 (the
  port 3.2e-3 from the eager one), bf16 rounding between the int8 convs.
- The corpora's own returns as raw clouds (``chip_smoke.corpus_clouds``)
  through each bf16 artifact's points front end, its x_stride, padding and
  sensor taken from ``meta.json``: equal bit for bit to the artifact on
  the clouds rasterized by hand.
- ``train.main``, ``predict.main`` and ``export.main`` take the card
  unless told otherwise: on a host without one they raise.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from range_view_3d_detection_torch import export as texport
from range_view_3d_detection_torch import predict as tpredict
from range_view_3d_detection_torch import serving, train
from range_view_3d_detection_torch.converters.av2 import export as tav2_export
from range_view_3d_detection_torch.converters.nuscenes import export as tnusc_export
from range_view_3d_detection_torch.converters.waymo import export as twaymo
from range_view_3d_detection_torch.data import dataset as td
from range_view_3d_detection_torch.evaluation import av2_eval as tav2
from range_view_3d_detection_torch.evaluation import detection_cfg_factory
from range_view_3d_detection_torch.models.quantized import fold_batch_norms
from range_view_3d_detection_torch.ops.projection import rasterize_points
from range_view_3d_detection_torch.training import builders as tbuilders
from range_view_3d_detection_torch.training import loop as tloop
from range_view_3d_detection_torch.training import state as tstate
from range_view_3d_detection_torch.transplant import load_flax_variables, state_dict_to_flax
from range_view_3d_detection_torch.utils.config import compose as tcompose
from range_view_3d_detection_torch.utils.msgpack import msgpack_restore
from range_view_3d_detection_tpu.data import dataset as jd
from range_view_3d_detection_tpu.evaluation import av2_eval as jav2
from range_view_3d_detection_tpu.models import quantized as jq
from range_view_3d_detection_tpu.models.detector import Detector
from range_view_3d_detection_tpu.training import builders as jbuilders
from range_view_3d_detection_tpu.utils.config import compose as jcompose
from test_torch_last_configs import _port_state_of
from test_torch_trainer import record
from test_torch_waymo_user import waymo_frames_on_points
from tools import export as jexport

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
AV2 = ("base-av2", "rv-av2-fast")
CONFIGS = (*AV2, "rv-nuscenes", "base-waymo")
# Each config's corpus, its sensor (rows, columns) and the split its
# requests come from (the nuScenes and Waymo corpora hold a train split
# only: the val split is pinned to it, as phase 49 pins it).
SENSORS = {"base-av2": ("av2", 64, 250, "val"), "rv-av2-fast": ("av2", 64, 1000, "val"),
           "rv-nuscenes": ("nuscenes", 32, 248, "train"),
           "base-waymo": ("waymo", 8, 250, "train")}
CUT = {"model._backbone.layers": "[8,8,8,8,8]", "model._head.fpn": "{1: 16}",
       "model._head.classification_head_channels": 8,
       "model._head.regression_head_channels": 8, "model._head.num_classification_blocks": 1,
       "model._head.num_regression_blocks": 1, "model.max_boxes": 16,
       "model.post_processing_config.nms_cap": 128, "model.batch_size": 2,
       "trainer.max_epochs": 1, "trainer.devices": 1}


def overrides(name, root, run_dir, **extra) -> list:
    """``name`` on its corpus ``root`` at its small sensor, the widths cut
    (``CUT``), one epoch of B=2 (``extra`` after)."""
    _, height, width, split = SENSORS[name]
    ov = {"dataset.root_dir": root,
          "dataset._train_dataset.range_view_config.height": height,
          "dataset._train_dataset.range_view_config.width": width, **CUT,
          "run_dir": run_dir, **extra}
    if split == "train":
        ov["dataset._val_dataset.split_name"] = "train"
    if name == "base-waymo":  # the small sensor's sweeps hold about 2000 points
        ov["dataset._train_dataset.min_points_filter"] = 0
    return [f"++{k}={v}" for k, v in ov.items()]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Each config's corpus, converted by the port's converters."""
    tmp = tmp_path_factory.mktemp("published_users")
    categories = tcompose(REPO / "conf", "rv-av2")["model"]["tasks"][0]
    for k, (split, (log_id, sweeps)) in enumerate(chip_smoke.RAW_AV2_LOGS.items()):
        chip_smoke.write_raw_av2_log(tmp / "raw_av2" / split / log_id, sweeps=sweeps,
                                     seed=chip_smoke.SEED + 290 + k, categories=categories,
                                     points=4000)
    out = {}
    for name in AV2:
        out[name] = tmp / name
        tav2_export.export_dataset(str(tmp / "raw_av2"), str(out[name]), height=64,
                                   width=SENSORS[name][2])
    version = chip_smoke.write_raw_nuscenes(tmp / "raw_nuscenes", seed=chip_smoke.SEED + 292)
    out["rv-nuscenes"] = tmp / "nuscenes"
    tnusc_export.export_dataset(str(tmp / "raw_nuscenes"), str(out["rv-nuscenes"]),
                                version=version, height=32, width=248)
    out["base-waymo"] = tmp / "waymo"
    twaymo.export_log(None, out["base-waymo"] / "train" / "segment-0",
                      frames=waymo_frames_on_points(2, seed=chip_smoke.SEED + 29, height=8,
                                                    width=250),
                      export_cameras=False)
    return out


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("name", AV2)
def test_av2_corpus_items_equal_jax(corpora, name, split):
    """Both packages' datasets on the converted AV2 corpus at ``name``'s
    layout, the train split with its published augmentations: the same
    index and every item equal bit for bit over two epochs; rv-av2-fast's
    items are every 4th column of the padded sweep."""
    ov = overrides(name, corpora[name], "unused")
    tcfg = tbuilders.build_dataset_config(tcompose(REPO / "conf", name, ov), split)
    jcfg = jbuilders.build_dataset_config(jcompose(REPO / "conf", name, ov), split)
    stride = 4 if name == "rv-av2-fast" else 1
    assert (tcfg.dataset_name, tcfg.padding_mode, tcfg.x_stride) == ("av2", "constant", stride)
    assert (tcfg.augmentations is not None) == (split == "train")
    tds, jds = td.RangeViewDataset(tcfg), jd.RangeViewDataset(jcfg)
    assert tds.index == jds.index and len(tds) == (4 if split == "train" else 2)
    sensor = SENSORS[name][2]
    pad = td.width_padding(sensor, stride)
    assert (sensor + 2 * pad) // stride == 256
    for epoch in range(2):
        tds.epoch = jds.epoch = epoch
        for i in range(len(tds)):
            t, j = tds[i], jds[i]
            assert sorted(t) == sorted(j)
            for k in j:
                if isinstance(j[k], np.ndarray):
                    assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), (i, k)
                else:
                    assert t[k] == j[k], (i, k)
            assert t["features"].shape == (64, 256, 5)
            assert t["mask"].any() and t["box_valid"].any()


# -- both Trainers on the AV2 corpus ------------------------------------------


def trainer_overrides(name, root, run_dir) -> list:
    """The Trainers' parity settings: fp32, no augmentations, the debug
    constant rate, the stem on the accumulate path, min_confidence 0.01 so
    that the shards hold detections."""
    return overrides(name, root, run_dir, **{
        "model._backbone.stem_pallas": "false", "model.precision": "float32",
        "model.augmentations_config": "null", "model.train_log_freq": 0,
        "model.debug": "true", "model.post_processing_config.min_confidence": 0.01})


def _jax_state_of(state, jt):
    """The JAX Trainer's ``TrainState`` holding the port's (its weights and
    statistics, a fresh AdamW), placed as ``Trainer._init_state`` places
    one: the two Trainers start from the same state without JAX's eager
    init of the model."""
    from range_view_3d_detection_tpu.parallel.mesh import replicated_sharding
    from range_view_3d_detection_tpu.training.state import TrainState

    params, stats = jax.tree_util.tree_map(jnp.asarray,
                                           state_dict_to_flax(state.model.state_dict()))
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                        opt_state=jt.tx.init(params))
    return jax.device_put(jstate, replicated_sharding(jt.mesh))


@pytest.fixture(scope="module", params=AV2)
def runs(request, corpora, tmp_path_factory):
    """Both Trainers fitted and validated at ``name``'s layout from the
    port's initial state (``_jax_state_of``); each JAX step taken again by
    the port from the JAX state and batch of that step."""
    from range_view_3d_detection_tpu.training.loop import Trainer as JTrainer

    name = request.param
    tmp = tmp_path_factory.mktemp(f"runs-{name}")
    jcfg = jcompose(REPO / "conf", name, trainer_overrides(name, corpora[name], tmp / "jax"))
    tcfg = tcompose(REPO / "conf", name, trainer_overrides(name, corpora[name], tmp / "port"))
    jt, tt = JTrainer(jcfg), tloop.Trainer(tcfg, device="cpu")
    assert len(tt.train_ds) == len(jt.train_ds) == 4 and len(tt.val_ds) == 2
    tt.state = tstate.create_state(tt.det_cfg, tt.tx, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    jt.state = _jax_state_of(tt.state, jt)
    jm, tm, taken = [], [], []
    jstep, tstep = jt.train_step, tt.train_step

    def jax_step(state, batch):
        # The step donates its state: keep a host copy.
        taken.append((jax.tree_util.tree_map(np.asarray, state),
                      {k: np.asarray(v) for k, v in batch.items()}))
        return jstep(state, batch)

    jt.train_step = jax_step
    record(jt, jm)
    record(tt, tm)
    jt.fit()
    tt.fit()
    forced = [{k: float(v) for k, v in tstep(_port_state_of(state, tt), batch)[1].items()}
              for state, batch in taken]
    return dict(name=name, root=corpora[name], jt=jt, tt=tt, jm=jm, tm=tm, forced=forced,
                jdir=jt.validate(), tdir=tt.validate())


def test_trainer_steps_match_jax(runs):
    """Each step's loss and loss terms within 1e-4 relative of JAX's, in
    the port's own ``fit`` and from the JAX Trainer's state; ``grad_norm``
    within 1e-3 at the first step and 5e-2 after."""
    jm, tm, forced = runs["jm"], runs["tm"], runs["forced"]
    assert len(jm) == len(tm) == len(forced) == 2
    assert jm[0]["total_objects"] > 0
    for i, j in enumerate(jm):
        for run in (tm[i], forced[i]):
            assert sorted(run) == sorted(j)
            for k in j:
                rtol = (1e-3 if i == 0 else 5e-2) if k == "grad_norm" else 1e-4
                np.testing.assert_allclose(run[k], j[k], rtol=rtol, atol=1e-7, err_msg=(i, k))
    assert runs["tt"].state.step == int(runs["jt"].state.step) == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_av2_evaluator_on_trainer_shards_equals_jax(runs, writer):
    """The AV2 evaluator with its ROI on a Trainer's shards (one a val
    sweep, detections in each): the port's numbers equal JAX's."""
    pred_dir = runs["tdir"] if writer == "port" else runs["jdir"]
    shards = sorted(pred_dir.glob("*.feather"))
    assert len(shards) == 2
    assert sorted(p.name for p in runs["tdir"].glob("*.feather")) == [p.name for p in shards]
    from range_view_3d_detection_torch.utils.feather import read_feather

    assert all(len(read_feather(p)["score"]) > 0 for p in shards)
    ev = detection_cfg_factory("av2")
    assert (ev.dataset_name, ev.eval_only_roi_instances) == ("av2", True)
    kw = dict(max_range_m=ev.max_range_m, eval_only_roi_instances=ev.eval_only_roi_instances,
              dataset_name=ev.dataset_name)
    cats = runs["tt"].categories
    assert len(cats) == 26
    gt = runs["root"] / "val"
    got = tav2.evaluate_predictions(pred_dir, gt, cats, **kw)
    want = jav2.evaluate_predictions(pred_dir, gt, cats, **kw)
    assert got == want
    assert all(np.isfinite(v) for v in got["AVERAGE_METRICS"].values())


# -- the four configs deployed from their runs ---------------------------------


@pytest.fixture(scope="module")
def deployed(corpora, tmp_path_factory):
    """Each config's port run (``train.main`` on the CPU, bf16, one epoch)
    and its artifacts by ``export.main --run-dir``, bf16 and int8."""
    tmp = tmp_path_factory.mktemp("deployed")
    out = {}
    for name in CONFIGS:
        run, art = tmp / name / "run", tmp / name / "art"
        ov = overrides(name, corpora[name], run, **{"trainer.device": "cpu"})
        train.main([f"experiment={name}", *ov])
        for tag, extra in (("bf16", []), ("int8", ["--quantize"])):
            texport.main(["--run-dir", str(run), "--out", str(art / tag), "--device", "cpu",
                          *extra])
        out[name] = dict(run=run, art=art, overrides=ov, root=corpora[name])
    return out


def _requests(d):
    cfg = json.loads((d["run"] / "config.json").read_text())
    ds = td.RangeViewDataset(tbuilders.build_dataset_config(cfg, "val"))
    return chip_smoke.corpus_requests(ds, chip_smoke.USER_PAIRS)


@pytest.mark.parametrize("name", CONFIGS)
def test_bf16_artifact_equals_the_restored_predictor(deployed, name):
    """The bf16 artifact of ``export.main --run-dir`` loaded back serves
    the val sweeps' requests equal bit for bit to the port's Predictor on
    the run restored in memory and folded; its dataset facts are the val
    split's."""
    d = deployed[name]
    model, det_cfg, dec_cfg = texport._restore_from_run_dir(d["run"], "cpu")
    assert det_cfg.dtype == "bfloat16" and det_cfg.layers == (8,) * 5
    ref = serving.Predictor(det_cfg, dec_cfg, device="cpu")
    ref.model.load_state_dict(model.state_dict())
    fold_batch_norms(ref.model)
    ref.bn_folded = True
    loaded, got_cfg, got_dec = texport.load_artifact(d["art"] / "bf16", device="cpu")
    assert (got_cfg, got_dec) == (det_cfg, dec_cfg) and loaded.quant_tree is None
    cfg = json.loads((d["run"] / "config.json").read_text())
    val = tbuilders.build_dataset_config(cfg, "val")
    meta = json.loads((d["art"] / "bf16" / "meta.json").read_text())["dataset"]
    assert meta == texport._dataset_meta_from_cfg(cfg)
    assert (meta["x_stride"], meta["padding_mode"]) == (val.x_stride, val.padding_mode)
    assert meta["x_stride"] == (4 if name == "rv-av2-fast" else 1)
    requests = _requests(d)
    _, height, _, _ = SENSORS[name]
    assert len(requests) == 2 and requests[0][0].shape == (2, height, 256, det_cfg.in_channels)
    for r in requests:
        assert chip_smoke.differing_fields(loaded(*r), ref(*r)) == []


@pytest.mark.parametrize("name", CONFIGS)
def test_bf16_artifact_reads_in_jax(deployed, name):
    """JAX's ``tools/export.py`` reads the port's artifact: its configs
    equal JAX's own build of the run's config, and its weights equal JAX's
    fold of the restored model's tree bit for bit."""
    d = deployed[name]
    meta = json.loads((d["art"] / "bf16" / "meta.json").read_text())
    jcfg = jcompose(REPO / "conf", name, d["overrides"])
    assert jexport._detector_config_from_meta(meta["detector_config"]) == (
        jbuilders.build_detector_config(jcfg))
    assert jexport._decoder_config_from_meta(meta["decoder_config"]) == (
        jbuilders.build_decoder_config(jcfg))
    model, _, _ = texport._restore_from_run_dir(d["run"], "cpu")
    params, stats = state_dict_to_flax(model.state_dict())
    folded = jexport.fold_batch_norms({"params": params, "batch_stats": stats})
    stored = msgpack_restore((d["art"] / "bf16" / "variables.msgpack").read_bytes())
    got = jax.tree_util.tree_leaves_with_path(stored)
    want = jax.tree_util.tree_leaves_with_path(folded)
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), jax.tree_util.keystr(path)


def _rel_rms(have, want) -> float:
    return float(np.sqrt(np.mean((have - want) ** 2) / np.mean(want**2)))


@pytest.mark.parametrize("name", CONFIGS)
def test_int8_artifact_forward_with_jax(deployed, name):
    """The int8 artifact (calibrated by ``export.main --quantize`` on the
    run's val items): ``load_artifact`` takes its quant tree as written;
    its weights and quant tree served in fp32 by the port (``Predictor.
    quantize(quant_tree=)``) against JAX's int8 forward on the same
    (``quantization("int8")``), as ``test_int8_forward_with_jax_tree``
    holds them: the heads within a relative RMS of 1e-3 of JAX's eager or
    jitted forward, the nearer (the jitted one run only where the eager one
    is not within it), on the first 8 rows of the first image of a val
    request (phase 46's CPU height: JAX's eager forward at 64 rows takes
    10-20 s a config on an 8-core CPU host)."""
    d = deployed[name]
    art = d["art"] / "int8"
    loaded, det_cfg, dec_cfg = texport.load_artifact(art, device="cpu")
    variables = msgpack_restore((art / "variables.msgpack").read_bytes())
    qtree = msgpack_restore((art / "quant.msgpack").read_bytes())
    assert loaded.quant_tree is not None and _leaves(loaded.quant_tree).keys() == (
        _leaves(qtree).keys())
    assert all(np.array_equal(np.asarray(v), _leaves(qtree)[k])
               for k, v in _leaves(loaded.quant_tree).items())
    fp32 = dataclasses.replace(det_cfg, dtype="float32")
    port = serving.Predictor(fp32, dec_cfg, device="cpu")
    load_flax_variables(port.model, variables["params"], variables["batch_stats"])
    port.bn_folded = True
    port.quantize(quant_tree=qtree)
    batch = tuple(np.ascontiguousarray(a[:1, :8]) for a in _requests(d)[0])
    with torch.inference_mode():
        tout = port.model(*(torch.from_numpy(a) for a in batch))["head"][1][0]
    have = {k: tout[k].numpy() for k in ("logits", "regressands")}
    meta = json.loads((art / "meta.json").read_text())
    model = Detector(dataclasses.replace(
        jexport._detector_config_from_meta(meta["detector_config"]), dtype="float32"))
    jvars = jax.tree_util.tree_map(jnp.asarray, {**variables, "quant": qtree})

    def dist(out):
        out = out["head"][1][0]
        return max(_rel_rms(have[k], np.asarray(out[k])) for k in have)

    with jq.quantization("int8"):
        seen = {"eager": dist(model.apply(jvars, *batch, train=False))}
        if seen["eager"] >= 1e-3:
            seen["jit"] = dist(jax.jit(lambda v, *b: model.apply(v, *b, train=False))(
                jvars, *(jnp.asarray(a) for a in batch)))
    assert min(seen.values()) < 1e-3, seen


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", CONFIGS)
def test_corpus_points_through_the_artifact(deployed, name):
    """The corpus's own returns as raw clouds through the bf16 artifact's
    points front end, its layout from ``meta.json`` (x_stride 4 for
    rv-av2-fast, 32 lasers and raw 0-255 intensity for rv-nuscenes): equal
    bit for bit to the artifact on the clouds rasterized by hand."""
    d = deployed[name]
    meta = json.loads((d["art"] / "bf16" / "meta.json").read_text())["dataset"]
    loaded, det_cfg, _ = texport.load_artifact(d["art"] / "bf16", device="cpu")
    points, extra = texport.make_points_predict(
        loaded, sensor_width=meta["sensor_width"], height=meta["height"],
        feature_names=meta["feature_names"], dataset_name=meta["dataset_name"],
        x_stride=meta["x_stride"], padding_mode=meta["padding_mode"])
    assert extra == chip_smoke.POINTS_EXTRA[meta["dataset_name"]]
    clouds = chip_smoke.corpus_clouds(d["root"], extra, height=meta["height"],
                                      pairs=chip_smoke.USER_PAIRS, split=SENSORS[name][3])
    assert len(clouds) == 2
    layout = dict(height=meta["height"], width=meta["sensor_width"],
                  feature_names=tuple(meta["feature_names"]),
                  dataset_name=meta["dataset_name"], x_stride=meta["x_stride"],
                  pad=td.width_padding(meta["sensor_width"], meta["x_stride"]),
                  padding_mode=meta["padding_mode"])
    for xyz, laser, *chans in clouds:
        assert xyz.shape[0] == 2 and laser.max() < meta["height"] and len(chans) == len(extra)
        image = rasterize_points(torch.as_tensor(xyz), torch.as_tensor(laser),
                                 dict(zip(extra, map(torch.as_tensor, chans))), **layout)
        assert image[0].shape == (2, meta["height"], 256, det_cfg.in_channels)
        assert int(image[2].sum()) > 0
        assert chip_smoke.differing_fields(points(xyz, laser, *chans), loaded(*image)) == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a CUDA device")
def test_user_entry_points_default_to_the_card(deployed, tmp_path):
    """``train.main``, ``predict.main`` and ``export.main`` take the card
    unless the CPU is asked for: on a host without one they raise.
    ``predict.main`` takes the run's ``trainer.device``, so it is given a
    copy of the run whose config names none, as a run on the card's
    defaults records it."""
    import shutil

    d = deployed["base-av2"]
    ov = [o for o in d["overrides"] if not o.startswith("++trainer.device=")]
    ov = [o if not o.startswith("++run_dir=") else f"++run_dir={tmp_path / 'run'}" for o in ov]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["experiment=base-av2", *ov])
    run = tmp_path / "card_run"
    shutil.copytree(d["run"], run)
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["trainer"].pop("device") == "cpu"
    (run / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredict.main(["--ckpt-dir", str(run), "--out-dir", str(tmp_path / "pred")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.main(["--run-dir", str(run), "--out", str(tmp_path / "art")])
    assert not (tmp_path / "pred").exists() and not (tmp_path / "art").exists()
