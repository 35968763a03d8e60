"""The port's evaluators against the JAX package's, on the CPU.

- Every test of ``tests/test_eval_golden.py`` (frozen scenes and the
  hand-derived micro-scenes) runs again with its ``av2_eval`` and
  ``waymo_eval`` replaced by the port's copies.
- ``evaluate_predictions`` (AV2, and its Waymo dispatch) and
  ``evaluate_waymo`` with and without the recall-gap penalty give the JAX
  functions' numbers exactly on the same shards and ground truth: a
  synthetic corpus (``generate_dataset``) and prediction shards made from
  its boxes with seeded noise, duplicates and false positives, written by
  the port's Feather writer.
- ``flatten_detections`` gives the JAX function's columns exactly for the
  same ``NMSResult``.
"""

from __future__ import annotations

import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import test_eval_golden as golden
from range_view_3d_detection_torch.data.synthetic import generate_dataset
from range_view_3d_detection_torch.evaluation import av2_eval as tav2
from range_view_3d_detection_torch.evaluation import waymo_eval as twaymo
from range_view_3d_detection_torch.ops.nms import NMSResult
from range_view_3d_detection_torch.training.loop import flatten_detections
from range_view_3d_detection_torch.utils.feather import write_feather
from range_view_3d_detection_tpu.evaluation import av2_eval as jav2
from range_view_3d_detection_tpu.evaluation import waymo_eval as jwaymo

GOLDEN = sorted(n for n, f in vars(golden).items() if n.startswith("test_") and callable(f))


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_cases_on_the_port(name, monkeypatch, tmp_path):
    monkeypatch.setattr(golden, "av2_eval", tav2)
    monkeypatch.setattr(golden, "waymo_eval", twaymo)
    fn = getattr(golden, name)
    fn(**({"tmp_path": tmp_path} if "tmp_path" in inspect.signature(fn).parameters else {}))


def _shards(root: Path, split: str, seed: int, categories) -> Path:
    """Prediction shards for every sweep of ``split``: each box kept with
    probability 0.8, moved by 0.3 m noise, some written twice, plus false
    positives, seeded scores."""
    rng = np.random.default_rng(seed)
    gts = jav2.load_ground_truth(root / split)
    dst = root.parent / f"pred_{split}_{seed}"
    uuids = sorted(set(zip(gts["log_id"].tolist(), gts["timestamp_ns"].tolist())))
    for log_id, ts in uuids:
        sel = (gts["log_id"] == log_id) & (gts["timestamp_ns"] == ts)
        sel &= rng.uniform(size=len(sel)) < 0.8
        n = int(sel.sum())
        cols = {k: np.asarray(gts[k][sel], np.float32) for k in (
            "tx_m", "ty_m", "tz_m", "length_m", "width_m", "height_m", "qw", "qx", "qy", "qz")}
        cols["tx_m"] += rng.normal(0, 0.3, n).astype(np.float32)
        cols["ty_m"] += rng.normal(0, 0.3, n).astype(np.float32)
        cols["category"] = np.asarray(gts["category"][sel], dtype=object)
        k = rng.integers(3, 6)
        fp = {c: rng.uniform(-40, 40, k).astype(np.float32) for c in ("tx_m", "ty_m")}
        for c in cols:
            if c in fp:
                cols[c] = np.concatenate([cols[c], fp[c]])
            elif c == "category":
                cols[c] = np.concatenate([cols[c], rng.choice(list(categories), k).astype(object)])
            else:
                cols[c] = np.concatenate([cols[c], cols[c][:1].repeat(k) if n else
                                          np.ones(k, np.float32)])
        m = len(cols["tx_m"])
        cols["score"] = rng.uniform(0.1, 1.0, m).astype(np.float32)
        dup = rng.uniform(size=m) < 0.2  # rewritten rows: exact duplicates
        cols = {c: np.concatenate([v, v[dup]]) for c, v in cols.items()}
        cols["log_id"] = np.asarray([log_id] * len(cols["score"]))
        cols["timestamp_ns"] = np.full(len(cols["score"]), ts, np.int64)
        write_feather(dst / f"{log_id}_{ts}.feather", cols)
    return dst


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval")
    av2_cats = ("PEDESTRIAN", "REGULAR_VEHICLE")
    waymo_cats = ("VEHICLE", "PEDESTRIAN", "CYCLIST")
    av2 = generate_dataset(base / "av2" / "sensor", splits={"val": 2}, sweeps_per_log=3,
                           height=16, width=120, num_boxes=8, seed=5, categories=av2_cats)
    waymo = generate_dataset(base / "waymo" / "sensor", splits={"val": 1}, sweeps_per_log=4,
                             height=16, width=122, num_boxes=8, seed=6,
                             dataset_name="waymo", categories=waymo_cats)
    return {"av2": (av2, av2_cats, _shards(av2, "val", 7, av2_cats)),
            "waymo": (waymo, waymo_cats, _shards(waymo, "val", 8, waymo_cats))}


@pytest.mark.parametrize("dataset", ["av2", "waymo"])
def test_evaluate_predictions_equals_jax(corpora, dataset):
    root, cats, preds = corpora[dataset]
    kw = dict(dataset_name=dataset, eval_only_roi_instances=dataset == "av2")
    want = jav2.evaluate_predictions(preds, root / "val", list(cats), **kw)
    got = tav2.evaluate_predictions(preds, root / "val", list(cats), **kw)
    assert got == want
    key = "AP" if dataset == "av2" else "mAP_L2"
    assert 0.0 < got["AVERAGE_METRICS"][key] < 1.0


@pytest.mark.parametrize("penalty", [True, False])
def test_evaluate_waymo_equals_jax(corpora, penalty):
    root, cats, preds = corpora["waymo"]
    kw = {} if penalty else {"max_recall_delta": None}

    def run(av2, waymo):
        dts = av2.dedupe_predictions(av2.load_predictions(preds))
        dts, gts = av2._join_valid_uuids(dts, av2.load_ground_truth(root / "val"))
        res = waymo.evaluate_waymo(dts, gts, list(cats), **kw)
        return res, waymo.mean_ap(res, level=2, metric="APH")

    assert run(tav2, twaymo) == run(jav2, jwaymo)


def test_flatten_detections_equals_jax():
    from range_view_3d_detection_tpu.training.loop import flatten_detections as jflat

    rng = np.random.default_rng(0)
    B, cap = 3, 16
    cuboids = rng.normal(size=(B, cap, 7)).astype(np.float32)
    scores = rng.uniform(size=(B, cap)).astype(np.float32)
    cats = rng.integers(0, 2, (B, cap)).astype(np.int32)
    keep = rng.uniform(size=(B, cap)) < 0.5
    keep[1] = False  # an image with no kept box
    uuids = [("log_a", 10), ("log_a", 20), ("log_b", 10)]
    names = ["PEDESTRIAN", "REGULAR_VEHICLE"]
    got = flatten_detections(
        NMSResult(*(torch.from_numpy(x) for x in (cuboids, scores, cats, keep))), uuids, names)
    import jax.numpy as jnp
    from range_view_3d_detection_tpu.ops.nms import NMSResult as JNMSResult

    want = jflat(JNMSResult(**{k: jnp.asarray(v) for k, v in dict(
        cuboids=cuboids, scores=scores, categories=cats, keep=keep).items()}), uuids, names)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
