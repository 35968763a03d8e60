"""Waymo as its users run it (``chip_smoke.py`` phase 48's path), held
against the JAX package on the CPU, on a Waymo corpus converted by the
port's converter from duck-typed frames (``chip_smoke.waymo_frames`` at an
8 x 58 sensor, each label moved onto one of its frame's returns so that
the train split keeps the sweep): a train log of three frames and a val
log of two.

- The corpus as both packages' ``data/dataset.py`` read it
  (``RangeViewDataset`` on each package's ``build_dataset_config`` of
  ``compose("conf", "rv-waymo", ...)``): the six columns, 58 columns
  padded by 3 a side with zeros to 64, the tanh of the intensity, the
  annotations, the min-points filter dropping the train split's smallest
  sweep; in both splits, the train split with rv-waymo's published
  augmentations, over two epochs, every array equal bit for bit.
- Both Trainers on the corpus at rv-waymo's layout with the depth and
  widths cut (``tests/test_torch_last_configs.py``'s nuScenes Trainer
  widths: stages of 8, FPN {1: 16}, 8-wide towers of one block, nms_cap
  128), fp32 without augmentations at the debug-overfit's constant rate,
  two epochs of one B=2 step from the JAX Trainer's initial state, each
  step also taken again by the port from the JAX Trainer's state and batch
  (``transplant.py`` carries the weights, statistics and AdamW's state
  across): each step's loss and loss terms within 1e-4 relative and
  ``grad_norm`` within 1e-3 at the first step and 5e-2 after
  (``tests/test_torch_trainer.py``'s gates and the reasons given there).
- The WOD evaluator on the Trainers' shards: the port's shards (one a val
  sweep, detections in each) and the JAX Trainer's, each scored by the
  port's ``evaluate_waymo`` and by JAX's, with the recall-gap penalty and
  without: every number equal (``==`` on the whole result).
- The bf16 artifact: the port's fitted model exported at rv-waymo's
  published dtype (bf16) with the dataset facts of its run, loaded back
  by ``load_artifact``: on requests of the val sweeps its detections
  equal bit for bit the port's ``Predictor`` holding the fitted model
  folded in memory; its configs read back by JAX's ``tools/export.py``
  equal JAX's own build of the run's config, and its weights equal JAX's
  fold of the fitted model's tree bit for bit; the corpus's own raw points
  through the artifact's points front end equal the artifact on the
  clouds rasterized by hand (``chip_smoke.corpus_clouds``).
- The entry points of this path default to the card: ``overfit`` and
  ``load_artifact`` raise on a host without one.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from range_view_3d_detection_torch import export as texport
from range_view_3d_detection_torch import overfit, serving
from range_view_3d_detection_torch.converters.waymo import export as twaymo
from range_view_3d_detection_torch.data import dataset as td
from range_view_3d_detection_torch.evaluation import av2_eval as tav2
from range_view_3d_detection_torch.evaluation import waymo_eval as twe
from range_view_3d_detection_torch.models.quantized import fold_batch_norms
from range_view_3d_detection_torch.ops.projection import rasterize_points
from range_view_3d_detection_torch.training import builders as tbuilders
from range_view_3d_detection_torch.training import loop as tloop
from range_view_3d_detection_torch.training import state as tstate
from range_view_3d_detection_torch.transplant import load_flax_variables, state_dict_to_flax
from range_view_3d_detection_torch.utils.config import compose as tcompose
from range_view_3d_detection_torch.utils.feather import read_feather
from range_view_3d_detection_tpu.data import dataset as jd
from range_view_3d_detection_tpu.evaluation import av2_eval as jav2
from range_view_3d_detection_tpu.evaluation import waymo_eval as jwe
from range_view_3d_detection_tpu.training import builders as jbuilders
from range_view_3d_detection_tpu.utils.config import compose as jcompose
from test_torch_last_configs import _port_state_of
from test_torch_trainer import record

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
HEIGHT, WIDTH = 8, 58  # padded by 3 a side to 64
EPOCHS = 2
LOGS = {"train": ("segment-0", 3, 1), "val": ("segment-1", 2, 2)}  # log, frames, seed


def waymo_frames_on_points(n: int, seed: int, height: int = HEIGHT, width: int = WIDTH):
    """``chip_smoke.waymo_frames`` at a ``height`` x ``width`` sensor, each
    label's centre moved onto one of its frame's returns (the point the
    converter computes for that pixel), so that every box holds a point."""
    frames = chip_smoke.waymo_frames(n, seed=seed, height=height, width=width)
    rng = np.random.default_rng(seed)
    for frame, range_images, pose in frames:
        cols = twaymo.convert_range_image_to_cartesian(frame, range_images, pose)
        valid = np.flatnonzero(cols["range"] > 0)
        for label in frame.laser_labels:
            i = rng.choice(valid)
            label.box.center_x = float(cols["x"][i])
            label.box.center_y = float(cols["y"][i])
            label.box.center_z = float(cols["z"][i])
    return frames


def write_corpus(root: Path) -> Path:
    """``LOGS`` converted by the port's converter under ``root``."""
    for split, (log, n, seed) in LOGS.items():
        twaymo.export_log(None, root / split / log, frames=waymo_frames_on_points(n, seed),
                          export_cameras=False)
    return root


def layout_overrides(root, **extra) -> list:
    """rv-waymo on ``root`` at the small sensor (``extra`` after)."""
    ov = {"dataset.root_dir": root,
          "dataset._train_dataset.range_view_config.height": HEIGHT,
          "dataset._train_dataset.range_view_config.width": WIDTH, **extra}
    return [f"++{k}={v}" for k, v in ov.items()]


def trainer_overrides(root, run_dir) -> list:
    """The nuScenes Trainer test's widths and settings on rv-waymo
    (``tests/test_torch_last_configs.py::nuscenes_overrides``), the
    min-points filter off (the small sensor's sweeps hold about 440
    points), ``EPOCHS`` epochs."""
    return layout_overrides(root, **{
        "dataset._train_dataset.min_points_filter": 0,
        "model.batch_size": 2,
        "model.max_boxes": 16,
        "model._backbone.layers": "[8,8,8,8,8]",
        "model._backbone.stem_pallas": "false",
        "model._head.fpn": "{1: 16}",
        "model._head.classification_head_channels": 8,
        "model._head.regression_head_channels": 8,
        "model._head.num_classification_blocks": 1,
        "model._head.num_regression_blocks": 1,
        "model.post_processing_config.nms_cap": 128,
        "model.post_processing_config.min_confidence": 0.01,
        "model.precision": "float32",
        "model.augmentations_config": "null",
        "model.train_log_freq": 0,
        "model.debug": "true",
        "trainer.max_epochs": EPOCHS,
        "trainer.devices": 1,
        "run_dir": run_dir,
    })


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("waymo") / "sensor")


def _point_counts(root, split):
    log = LOGS[split][0]
    return sorted(int(n) for n in read_feather(root / split / log / "metadata.feather")["num_pts"])


@pytest.mark.parametrize("split", ["train", "val"])
def test_corpus_items_equal_jax(corpus, split):
    """Both packages' datasets on the converted corpus, rv-waymo's layout
    at the small sensor, the train split with its published augmentations
    and a min-points filter that drops its smallest sweep: the same index
    and every item equal bit for bit over two epochs."""
    counts = _point_counts(corpus, "train")
    assert counts[0] < counts[1]
    ov = layout_overrides(corpus, **{"dataset._train_dataset.min_points_filter": counts[0] + 1})
    tcfg = tbuilders.build_dataset_config(tcompose(REPO / "conf", "rv-waymo", ov), split)
    jcfg = jbuilders.build_dataset_config(jcompose(REPO / "conf", "rv-waymo", ov), split)
    assert (tcfg.dataset_name, tcfg.padding_mode, tcfg.range_view.feature_column_names) == (
        "waymo", "constant", ("elongation", "intensity", "range", "x", "y", "z"))
    assert (tcfg.augmentations is not None) == (split == "train")
    tds, jds = td.RangeViewDataset(tcfg), jd.RangeViewDataset(jcfg)
    assert tds.index == jds.index and len(tds) == 2
    pad = td.width_padding(WIDTH, 1)
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
            assert t["features"].shape == (HEIGHT, WIDTH + 2 * pad, 6) and pad == 3
            assert not t["mask"][:, :pad].any() and not t["features"][:, -pad:].any()
            assert t["box_valid"].any()
            assert np.abs(t["features"][..., 1]).max() <= 1.0  # tanh of the intensity


# -- both Trainers on the corpus ------------------------------------------------


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Both Trainers fitted and validated on the corpus from the JAX
    Trainer's initial state; each JAX step taken again by the port from
    the JAX state and batch of that step."""
    from range_view_3d_detection_tpu.data.dataset import collate
    from range_view_3d_detection_tpu.training.loop import Trainer as JTrainer

    tmp = tmp_path_factory.mktemp("runs")
    jcfg = jcompose(REPO / "conf", "rv-waymo", trainer_overrides(corpus, tmp / "jax"))
    tcfg = tcompose(REPO / "conf", "rv-waymo", trainer_overrides(corpus, tmp / "port"))
    jt, tt = JTrainer(jcfg), tloop.Trainer(tcfg, device="cpu")
    assert len(tt.train_ds) == len(jt.train_ds) == 3 and len(tt.val_ds) == 2
    sample = collate([jt.train_ds[0], jt.train_ds[1]])
    jt.state = jt._init_state({k: v for k, v in sample.items() if k != "uuids"})
    st = tstate.create_state(tt.det_cfg, tt.tx, device="cpu")
    load_flax_variables(st.model, jt.state.params, jt.state.batch_stats)
    tt.state = st
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
    return dict(jt=jt, tt=tt, jm=jm, tm=tm, forced=forced, jdir=jt.validate(),
                tdir=tt.validate(), tmp=tmp)


def test_trainer_steps_match_jax(runs):
    """Each step's loss and loss terms within 1e-4 relative of JAX's, in
    the port's own ``fit`` and from the JAX Trainer's state; ``grad_norm``
    within 1e-3 at the first step and 5e-2 after (the gates of
    ``tests/test_torch_trainer.py``)."""
    jm, tm, forced = runs["jm"], runs["tm"], runs["forced"]
    assert len(jm) == len(tm) == len(forced) == EPOCHS
    assert jm[0]["total_objects"] > 0
    for i, j in enumerate(jm):
        for run in (tm[i], forced[i]):
            assert sorted(run) == sorted(j)
            for k in j:
                rtol = (1e-3 if i == 0 else 5e-2) if k == "grad_norm" else 1e-4
                np.testing.assert_allclose(run[k], j[k], rtol=rtol, atol=1e-7, err_msg=(i, k))
    assert runs["tt"].state.step == int(runs["jt"].state.step) == EPOCHS


def _wod(av2, waymo, pred_dir, gt_dir, cats, penalty):
    dts = av2.dedupe_predictions(av2.load_predictions(pred_dir))
    dts, gts = av2._join_valid_uuids(dts, av2.load_ground_truth(gt_dir))
    res = waymo.evaluate_waymo(dts, gts, list(cats), workers=0,
                               **({} if penalty else {"max_recall_delta": None}))
    return res, {(level, metric): waymo.mean_ap(res, level=level, metric=metric)
                 for level in (1, 2) for metric in ("AP", "APH")}


@pytest.mark.parametrize("penalty", [True, False])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wod_evaluator_on_trainer_shards_equals_jax(runs, corpus, writer, penalty):
    """The port's ``evaluate_waymo`` on a Trainer's shards (one a val
    sweep, detections in each) equals JAX's, every number, with the
    recall-gap penalty and without."""
    pred_dir = runs["tdir"] if writer == "port" else runs["jdir"]
    shards = sorted(pred_dir.glob("*.feather"))
    assert len(shards) == 2
    assert sorted(p.name for p in runs["tdir"].glob("*.feather")) == [p.name for p in shards]
    assert all(len(read_feather(p)["score"]) > 0 for p in shards)
    cats = runs["tt"].categories
    assert sorted(cats) == ["CYCLIST", "PEDESTRIAN", "VEHICLE"]
    got = _wod(tav2, twe, pred_dir, corpus / "val", cats, penalty)
    want = _wod(jav2, jwe, pred_dir, corpus / "val", cats, penalty)
    assert got == want
    assert all(np.isfinite(v) for v in got[1].values())


# -- the bf16 artifact --------------------------------------------------------


@pytest.fixture(scope="module")
def artifact(runs):
    tt = runs["tt"]
    cfg = dataclasses.replace(tt.det_cfg, dtype="bfloat16")
    art = runs["tmp"] / "artifact"
    texport.export_artifact(tt.state.model, cfg, tt.dec_cfg, art,
                            dataset_meta=texport._dataset_meta_from_cfg(tt.cfg))
    ref = serving.Predictor(cfg, tt.dec_cfg, device="cpu")
    ref.model.load_state_dict(tt.state.model.state_dict())
    fold_batch_norms(ref.model)
    ref.bn_folded = True
    loaded, det_cfg, dec_cfg = texport.load_artifact(art, device="cpu")
    return dict(art=art, cfg=cfg, ref=ref, loaded=loaded, det_cfg=det_cfg, dec_cfg=dec_cfg)


def test_bf16_artifact_equals_the_predictor(runs, artifact):
    """The artifact loaded back serves the val sweeps' requests (each pair
    of ``chip_smoke.WAYMO_USER_PAIRS``) equal bit for bit to the fitted
    model's Predictor folded in memory, kept boxes among them."""
    assert artifact["det_cfg"] == artifact["cfg"] and artifact["dec_cfg"] == runs["tt"].dec_cfg
    meta = json.loads((artifact["art"] / "meta.json").read_text())["dataset"]
    assert meta == {"dataset_name": "waymo", "height": HEIGHT, "sensor_width": WIDTH,
                    "x_stride": 1, "padding_mode": "constant",
                    "feature_names": ["elongation", "intensity", "range", "x", "y", "z"]}
    requests = chip_smoke.corpus_requests(runs["tt"].val_ds)
    assert len(requests) == 4 and requests[0][0].shape == (2, HEIGHT, 64, 6)
    kept = 0
    for r in requests:
        got, want = artifact["loaded"](*r), artifact["ref"](*r)
        assert got.cuboids.dtype == torch.float32
        assert chip_smoke.differing_fields(got, want) == []
        kept += int(got.keep.sum())
    assert kept > 0


def test_bf16_artifact_reads_in_jax(runs, artifact):
    """JAX's ``tools/export.py`` reads the port's artifact: its configs equal
    JAX's own build of the run's config at bf16, and its weights equal
    JAX's fold of the fitted model's tree bit for bit."""
    from range_view_3d_detection_torch.utils.msgpack import msgpack_restore
    from tools import export as jexport

    meta = json.loads((artifact["art"] / "meta.json").read_text())
    jcfg = jcompose(REPO / "conf", "rv-waymo", trainer_overrides(runs["tmp"], runs["tmp"]))
    want = dataclasses.replace(jbuilders.build_detector_config(jcfg), dtype="bfloat16")
    assert jexport._detector_config_from_meta(meta["detector_config"]) == want
    assert jexport._decoder_config_from_meta(meta["decoder_config"]) == (
        jbuilders.build_decoder_config(jcfg))
    params, stats = state_dict_to_flax(runs["tt"].state.model.state_dict())
    folded = jexport.fold_batch_norms({"params": params, "batch_stats": stats})
    stored = msgpack_restore((artifact["art"] / "variables.msgpack").read_bytes())
    got = jax.tree_util.tree_leaves_with_path(stored)
    want = jax.tree_util.tree_leaves_with_path(folded)
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), jax.tree_util.keystr(path)


def test_corpus_points_through_the_artifact(corpus, artifact):
    """The corpus's own returns as raw clouds (``chip_smoke.corpus_clouds``)
    through the artifact's points front end, its recorded layout: equal bit
    for bit to the artifact on the clouds rasterized by hand."""
    meta = json.loads((artifact["art"] / "meta.json").read_text())["dataset"]
    loaded = artifact["loaded"]
    points, extra = texport.make_points_predict(
        loaded, sensor_width=meta["sensor_width"], height=meta["height"],
        feature_names=meta["feature_names"], dataset_name="waymo",
        padding_mode=meta["padding_mode"])
    assert extra == ["elongation", "intensity"]
    clouds = chip_smoke.corpus_clouds(corpus, extra, height=HEIGHT)
    assert len(clouds) == 4
    for xyz, laser, *chans in clouds:
        assert xyz.shape[0] == 2 and laser.max() < HEIGHT and len(chans) == 2
        image = rasterize_points(
            torch.as_tensor(xyz), torch.as_tensor(laser),
            dict(zip(extra, map(torch.as_tensor, chans))), height=HEIGHT, width=WIDTH,
            feature_names=tuple(meta["feature_names"]), dataset_name="waymo", x_stride=1,
            pad=td.width_padding(WIDTH, 1), padding_mode="constant")
        assert int(image[2].sum()) > 0
        got, want = points(xyz, laser, *chans), loaded(*image)
        assert chip_smoke.differing_fields(got, want) == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a CUDA device")
def test_waymo_entry_points_default_to_the_card(tmp_path, artifact):
    """``overfit`` and ``load_artifact`` take the card unless told
    otherwise: on a host without one they raise."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        overfit.build_trainer("waymo", 1, tmp_path / "overfit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.load_artifact(artifact["art"])
