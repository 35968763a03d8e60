"""The port's entry points end to end on the CPU, as a user runs them
(``device`` asked for explicitly; their default is the card):

- ``train.main`` (the twin of ``scripts/train.py``) on the tiny config of
  ``test_torch_trainer.py``: fit, validate, evaluate, ``metrics.feather``;
  then ``evaluate.main`` (the twin of ``tools/evaluate.py``) on its
  shards, AV2 and WOD protocol with and without the recall-gap penalty;
- ``overfit.main`` (the twin of ``scripts/debug-overfit-waymo.sh``) for
  one epoch: the Waymo corpus, training, and both WOD scorings;
- ``predict.main`` (the twin of ``tools/predict.py``) on a trained tiny
  run: it restores the latest checkpoint without training and writes the
  same shards the run's own validation wrote; ``export.main --run-dir``
  (the twin of ``tools/export.py --run-dir``) exports the same run with
  int8 scales calibrated on its val data, and the artifact serves.
"""

from __future__ import annotations

import json
import math

import numpy as np

from range_view_3d_detection_torch import evaluate, export, overfit, predict, serving, train
from range_view_3d_detection_torch.data.synthetic import generate_dataset
from range_view_3d_detection_torch.utils.feather import read_feather
from test_torch_trainer import tiny_overrides


def test_train_then_evaluate(tmp_path, capsys):
    root = generate_dataset(tmp_path / "sensor", splits={"train": 1, "val": 1},
                            sweeps_per_log=2, height=8, width=56, num_boxes=4,
                            num_bg_points=800, seed=2)
    run = tmp_path / "run"
    metrics = train.main(["experiment=rv-synthetic", *tiny_overrides(root, run),
                          "++trainer.device=cpu", "++trainer.max_epochs=1"])
    assert math.isfinite(metrics["AVERAGE_METRICS"]["AP"])
    table = read_feather(run / "metrics.feather")
    assert list(table["category"]) == sorted(metrics)
    np.testing.assert_array_equal(
        table["AP"], [metrics[c].get("AP", np.nan) for c in sorted(metrics)])
    pred = str(run / "predictions")
    av2 = evaluate.main(["--pred-dir", pred, "--gt-dir", str(root / "val")])
    assert math.isfinite(av2["AVERAGE_METRICS"]["AP"])
    capsys.readouterr()
    for extra in ([], ["--no-recall-gap-penalty"]):
        wod = evaluate.main(["--pred-dir", pred, "--gt-dir", str(root / "val"),
                             "--dataset", "waymo", "--workers", "0", *extra])
        assert math.isfinite(wod["mAP_L2"]) and math.isfinite(wod["mAPH_L2"])
        assert '"mAP_L2"' in capsys.readouterr().out


def test_overfit_waymo_one_epoch(tmp_path, capsys):
    out = overfit.main(["waymo", "1", "--device", "cpu", "--work-dir", str(tmp_path)])
    for tag in ("penalty", "no_penalty"):
        assert set(out[tag]) == {"mAP_L2", "mAPH_L2"}
        assert all(math.isfinite(v) for v in out[tag].values())
    printed = capsys.readouterr().out
    assert '"steps": 8' in printed  # 16 sweeps, batch 2
    assert len(list((tmp_path / "run" / "predictions").glob("*.feather"))) == 16


def test_predict_and_export_restore_the_run(tmp_path, capsys):
    root = generate_dataset(tmp_path / "sensor", splits={"train": 1, "val": 1},
                            sweeps_per_log=2, height=8, width=56, num_boxes=4,
                            num_bg_points=800, seed=4)
    run = tmp_path / "run"
    train.main(["experiment=rv-synthetic", *tiny_overrides(root, run),
                "++trainer.device=cpu", "++trainer.max_epochs=1",
                "++model.debug=false"])  # debug runs keep no checkpoint
    assert list((run / "checkpoints").glob("step_*.pt"))
    out = predict.main(["--ckpt-dir", str(run), "--device", "cpu",
                        "--out-dir", str(tmp_path / "pred")])
    assert f"predictions written to {out}" in capsys.readouterr().out
    shards = sorted(p.name for p in (run / "predictions").glob("*.feather"))
    assert len(shards) == 2 and sorted(p.name for p in out.glob("*.feather")) == shards
    for name in shards:
        got, want = read_feather(out / name), read_feather(run / "predictions" / name)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    art = tmp_path / "art"
    export.main(["--run-dir", str(run), "--out", str(art), "--device", "cpu", "--quantize"])
    cfg = json.loads((run / "config.json").read_text())
    meta = json.loads((art / "meta.json").read_text())
    assert meta["dataset"] == export._dataset_meta_from_cfg(cfg)
    assert (art / "quant.msgpack").is_file()
    predictor, det_cfg, _ = export.load_artifact(art, device="cpu")
    assert predictor.quant_tree and det_cfg.layers == (8, 8, 8, 8, 8)
    H, Wp = export._eval_shape(cfg)
    result = predictor(*serving._sample_inputs(1, H, Wp, det_cfg.in_channels))
    assert np.isfinite(result.scores.numpy()).all()
