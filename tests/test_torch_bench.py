"""The port's bench (``range_view_3d_detection_torch/bench.py``), on the
CPU.

- The entry paths of ``tests/test_bench_entry.py``: ``python -m
  range_view_3d_detection_torch.bench --dry-parse`` exits 0 in a fresh
  interpreter, ``main`` hands the parsed batch (``--batch``,
  ``RV3D_BENCH_BATCH``, default 2), ``--fp`` and ``--points`` (or
  ``RV3D_BENCH_POINTS=1``) to ``_run`` and returns what it returns, and
  the module runs as ``__main__``.
- The bench's pipelines at the tiny config, on flax weights transplanted
  (``transplant.flax_to_state_dict``), against the JAX pipelines that the
  JAX ``bench.py`` builds: ``pipeline_q`` (BatchNorm folded by
  ``tools/export.py``, scales calibrated on the bench batch, full scope,
  the forward under ``quantization("int8")``, decode with NMS) and
  ``pipeline_fp``: ``keep`` identical, kept cuboids within 1e-3 m plus
  1e-3 relative and scores within 1e-3 (``test_torch_quantized.py``'s
  tolerance).
- ``_run``'s JSON line, on the tiny pipeline: ``metric``, ``value``,
  ``unit``, ``path``, ``inputs``, ``mode``, ``p50_ms``, ``p90_ms``,
  ``batch``, ``device``, and no ``vs_baseline``.
- A quantization that fails raises out of ``_run`` at the flagship: the
  bench does not measure bf16 instead, and prints no JSON line.
"""

from __future__ import annotations

import json
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from range_view_3d_detection_torch import bench, serving
from range_view_3d_detection_torch.transplant import flax_to_state_dict
from range_view_3d_detection_tpu.models import quantized as jq
from range_view_3d_detection_tpu.models.decoder import DecoderConfig, decode
from range_view_3d_detection_tpu.models.detector import Detector
from test_torch_blocks import numpy_tree, randomize_bn
from tools.export import fold_batch_norms as jax_fold

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
B, H, W = 2, 8, 64


def test_bench_dry_parse_in_a_fresh_interpreter():
    proc = subprocess.run(
        [sys.executable, "-m", "range_view_3d_detection_torch.bench", "--dry-parse"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr


def test_bench_main_calls_run(monkeypatch):
    calls = {}

    def fake_run(batch, *, fp, points, device):
        calls.update(batch=batch, fp=fp, points=points, device=device)
        return 123.0

    monkeypatch.setattr(bench, "_run", fake_run)
    monkeypatch.delenv("RV3D_BENCH_BATCH", raising=False)
    monkeypatch.delenv("RV3D_BENCH_POINTS", raising=False)
    assert bench.main(["--batch", "3"]) == 123.0
    assert calls == {"batch": 3, "fp": False, "points": False, "device": "cuda"}
    bench.main([])
    assert calls["batch"] == 2
    monkeypatch.setenv("RV3D_BENCH_BATCH", "5")
    monkeypatch.setenv("RV3D_BENCH_POINTS", "1")
    bench.main(["--fp", "--device", "cpu"])
    assert calls == {"batch": 5, "fp": True, "points": True, "device": "cpu"}


def test_bench_module_exec_path(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["bench", "--dry-parse"])
    runpy.run_module("range_view_3d_detection_torch.bench", run_name="__main__")


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny detector with randomised BatchNorm and each head's
    final conv scaled so that NMS has work; the bench's batch."""
    cfg = graft._flagship_config(tiny=True)
    feats, cart, mask = serving._sample_inputs(B, H, W, cfg.in_channels)
    model = Detector(cfg)
    v = model.init(jax.random.PRNGKey(0), feats, cart, mask, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=2)
    first = model.apply({"params": params, "batch_stats": stats}, feats, cart, mask,
                        train=False)["head"][1][0]
    for name, sub in params["DetectionHead_0"].items():
        final = sub[f"ConvNormAct_{len(sub) - 1}"]["Conv_0"]
        key = "logits" if name.startswith("cls_") else "regressands"
        final["kernel"] *= (2.0 if key == "logits" else 0.3) / float(np.std(np.asarray(first[key])))
        final["bias"][:] = 0.0
        if key == "logits":
            final["bias"][0] = 2.0
        else:
            final["bias"][3:6] = np.log(8.0)
    return dict(cfg=cfg, model=model, batch=(feats, cart, mask), params=params,
                stats=stats, state_dict=flax_to_state_dict(params, stats))


def _jax_pipeline(t, fp: bool):
    """``bench.py``'s ``pipeline_fp`` or ``pipeline_q`` on the tiny model."""
    dec, tasks = DecoderConfig(), t["cfg"].tasks_dict
    if fp:
        out = t["model"].apply({"params": t["params"], "batch_stats": t["stats"]},
                               *t["batch"], train=False)
        return decode(out, dec, tasks, use_nms=True)
    folded = numpy_tree(jax_fold({"params": t["params"], "batch_stats": t["stats"]}))
    vars_q = dict(folded)
    vars_q["quant"] = jq.calibrate_scales(t["model"], folded, [t["batch"]])
    with jq.quantization("int8"):
        out = t["model"].apply(vars_q, *t["batch"], train=False)
    return decode(out, dec, tasks, use_nms=True)


_BUILD = bench.build


def _build_tiny(t, **kw):
    return _BUILD(B, device="cpu", cfg=serving._flagship_config(tiny=True), height=H,
                       width=W, state_dict=t["state_dict"], **kw)


@pytest.mark.parametrize("fp", [False, True], ids=["int8", "fp"])
def test_bench_pipeline_matches_jax(tiny, fp, monkeypatch):
    monkeypatch.delenv("RV3D_STEM_INT8", raising=False)
    monkeypatch.delenv("RV3D_COMPILER_OPTIONS", raising=False)
    pipeline, args, _, path = _build_tiny(tiny, fp=fp)
    assert path == ("float32" if fp else "int8")
    for a, b in zip(args, tiny["batch"]):
        np.testing.assert_array_equal(a.numpy(), b)
    ref = _jax_pipeline(tiny, fp)
    keep = np.asarray(ref.keep)
    assert keep.sum() > 0
    got = pipeline(*args)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_allclose(got.cuboids.numpy()[keep], np.asarray(ref.cuboids)[keep],
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[keep], np.asarray(ref.scores)[keep],
                               atol=1e-3)


def test_bench_json_line(tiny, monkeypatch, capsys):
    monkeypatch.delenv("RV3D_STEM_INT8", raising=False)
    monkeypatch.delenv("RV3D_COMPILER_OPTIONS", raising=False)
    monkeypatch.setattr(bench, "build", lambda batch, device, **kw: _build_tiny(tiny, **kw))
    # The loop's depth cut for the CPU (its shape is what is held here).
    monkeypatch.setattr(bench, "ITERS", 4)
    monkeypatch.setattr(bench, "CHUNK", 2)
    monkeypatch.setattr(bench, "LATENCY_ITERS", 4)
    report = bench._run(B, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == report
    assert sorted(line) == sorted(["metric", "value", "unit", "path", "inputs", "mode",
                                   "p50_ms", "p90_ms", "batch", "device"])
    assert line["metric"] == "e2e_frames_per_sec_per_chip" and line["unit"] == "frames/s"
    assert line["value"] > 0 and line["p50_ms"] <= line["p90_ms"]
    assert line["path"] == "int8" and line["mode"] == "int8 eager"
    assert line["device"] == "cpu" and line["batch"] == B


def test_failing_quantization_raises(monkeypatch, capsys):
    def broken(self, *args, **kwargs):
        raise RuntimeError("quantization made to fail")

    monkeypatch.setattr(serving.Predictor, "quantize", broken)
    with pytest.raises(RuntimeError, match="quantization made to fail"):
        bench._run(1, device="cpu")
    assert '"metric"' not in capsys.readouterr().out
