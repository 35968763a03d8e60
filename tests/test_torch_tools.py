"""The port's measurement tools (``range_view_3d_detection_torch/tools/``)
on the CPU, held against the JAX package's tools where both compute the
same thing.

- ``benchmark --synthetic``: the staged report has the JAX tool's keys
  (and ``device``), ``nms_ms >= 0``; ``--train`` and ``--loader`` run.
- ``benchmark --loader``: the frames it times equal those of the JAX
  ``DataLoader`` over the same corpus with the JAX tool's settings (its
  own ``bench_loader`` writes under a fixed ``/tmp`` path, so the loop is
  repeated here, not called).
- ``profile_trace.summarize`` on a trace that ``torch.profiler`` wrote on
  the CPU: its per-name counts of ``cpu_op`` events equal
  ``key_averages()``'s, and with the default device categories it sums a
  kernel event added to the trace and nothing else; the CLI runs.
- ``flops --tiny``: the backbone's and heads' FLOPs against the JAX
  ``tools/flops.py``'s ``stage_cost`` (XLA's ``cost_analysis``) on the
  same stages at 8x64: the port's count is 1.0-1.10 of XLA's (measured
  with this test: backbone 1.046, heads 1.080). ``FlopCounterMode``
  counts every tap of a conv's padded window (and every input pixel times
  every tap of a transposed conv, the cropped border too), while XLA counts
  only the taps that land on the input: at 8 rows a 3x3 conv's border
  rows hold 9% of the taps. XLA also counts the elementwise ops
  (BatchNorm, ReLU, the residual adds), which ``FlopCounterMode`` counts
  as 0, so the backbone's excess is smaller than the heads'.
- The four ``rv3d::`` FLOP formulas equal ``chip_smoke.py``'s ``k1_cost``,
  ``k4_cost`` and ``k3_shape_cost`` (stride 1 and 2), and K2 counts 0.
- ``scale_drill --sweeps 8 --device cpu``: the walls line has every stage
  and quality key of ``tests/test_scale_drill.py``; its corpus and loader
  frames equal the JAX package's over the same generated corpus.
- ``quant_accuracy`` on one tiny transplanted state (``rv-synthetic`` in
  fp32 with one 16-channel block a head and ``nms_cap`` 128, randomised
  BatchNorm, heads scaled so that NMS keeps boxes)
  against the JAX tool on the same weights and val batches (each tool's
  ``_restore_from_run_dir`` patched to return them): the same number of
  detections a sweep on the fp and int8 paths, scores within 1e-3 (the
  int8 parity tolerance of ``test_torch_quantized.py``), and the same
  mean AP and CDS deltas within 1e-3.
- ``remat_grid``: a scope whose step raises ``torch.cuda.OutOfMemoryError``
  reports "infeasible" and the next scope runs; any other error raises.
- ``quant_cert_scale``: a seed's summary answers a later run unless that
  run asks for QAT or the fast point it lacks; the aggregate's means and
  spreads.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from range_view_3d_detection_torch import export as port_export
from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.tools import (
    benchmark,
    flops,
    profile_forward,
    profile_trace,
    quant_accuracy,
    quant_cert_scale,
    remat_grid,
    scale_drill,
)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def test_staged_benchmark_report_keys(tmp_path):
    rep = benchmark.main(["--synthetic", "--device", "cpu", "--work", str(tmp_path),
                          "--iters", "2"])
    for key in ("backbone_head_ms", "decode_ms", "nms_ms", "e2e_ms", "fps", "projection_ms",
                "points_e2e_ms", "points_fps", "num_points", "metrics"):
        assert key in rep, key
    assert rep["nms_ms"] >= 0 and rep["device"] == "cpu" and rep["num_points"] == 32768
    assert "AVERAGE_METRICS" in rep["metrics"]


def test_train_bench_and_profile_forward_run():
    rep = benchmark.main(["--train", "--tiny", "--device", "cpu", "--height", "8",
                          "--width", "64", "--batch", "2", "--iters", "1"])
    assert rep["remat"] and np.isfinite(rep["loss"]) and rep["train_step_ms"] > 0
    stages = profile_forward.main(["--tiny", "--device", "cpu", "--height", "8",
                                   "--width", "64", "--iters", "1"])
    assert all(stages[k] > 0 for k in ("stem_ms", "backbone_ms", "heads_ms",
                                       "full_forward_ms"))


def test_loader_bench_frames_match_jax(tmp_path):
    from range_view_3d_detection_tpu.data.dataset import (
        DataLoader,
        DatasetConfig,
        RangeViewConfig,
        RangeViewDataset,
    )

    rep = benchmark.main(["--loader", "--height", "8", "--width", "64", "--workers", "2",
                          "--work", str(tmp_path)])
    root = tmp_path / "8x64" / "sensor"
    ds = RangeViewDataset(DatasetConfig(
        root_dir=str(root), split_name="train",
        range_view=RangeViewConfig(height=8, width=64),
        tasks={0: ("REGULAR_VEHICLE", "PEDESTRIAN")},
        augmentations={"flip_azimuth": {"p": 0.5},
                       "random_rotation": {"low": -0.785, "high": 0.785, "p": 1.0},
                       "random_global_scale": {"low": 0.95, "high": 1.05}},
    ))
    loader = DataLoader(ds, batch_size=2, num_workers=2, shuffle=True)
    for _ in loader:
        pass
    timed = sum(b["features"].shape[0] for _ in range(3) for b in loader)
    assert rep["frames_timed"] == timed > 0


def test_profile_trace_summarize_cpu_trace(tmp_path):
    model = serving.Predictor(serving._flagship_config(tiny=True), device="cpu").model
    inputs = [torch.as_tensor(a) for a in serving._sample_inputs(1, 8, 64, 5)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            model(*inputs)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    got = profile_trace.summarize(tmp_path, categories=("cpu_op",))
    want = {e.key: e.count for e in prof.key_averages()}
    assert got["by_name"] and all(want[n] == v["count"] for n, v in got["by_name"].items())
    assert profile_trace.summarize(tmp_path)["events"] == 0  # no device on the CPU
    trace = json.loads((tmp_path / "trace.json").read_text())
    trace["traceEvents"].append({"ph": "X", "cat": "kernel", "name": "void k<1>(int)",
                                 "ts": 0, "dur": 250.0, "pid": 0, "tid": 7})
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    dev = profile_trace.summarize(tmp_path)
    assert dev["events"] == 1 and dev["total_ms"] == pytest.approx(0.25)
    out = tmp_path / "cli"
    summary = profile_trace.main(["--tiny", "--device", "cpu", "--height", "8", "--width",
                                  "64", "--decode", "--out", str(out)])
    assert (out / "trace.json").exists() and summary["events"] == 0


def test_flops_tiny_matches_jax_backbone_and_heads():
    import tools.flops as jax_flops
    from range_view_3d_detection_tpu.models.backbone import RangeBackbone
    from range_view_3d_detection_tpu.models.heads import DetectionHead

    import __graft_entry__ as graft

    B, H, W = 1, 8, 64
    port = flops.costs(serving._flagship_config(tiny=True), B, H, W, torch.device("cpu"),
                       dec_cfg=flops.DecoderConfig(nms_cap=256))["rows"]
    cfg = graft._flagship_config(tiny=True)
    stem_out = np.zeros((B, H, W, cfg.layers[0]), np.float32)
    bb = RangeBackbone(cfg.layers, dtype=cfg.compute_dtype)
    bv = bb.init(jax.random.PRNGKey(0), stem_out, train=False)
    want_bb = jax_flops.stage_cost(lambda v, x: bb.apply(v, x, train=False), bv, stem_out)
    ms = jax.jit(lambda v, x: bb.apply(v, x, train=False))(bv, stem_out)
    head = DetectionHead(
        fpn=cfg.fpn_dict, fpn_kernel_sizes=dict(cfg.fpn_kernel_sizes), tasks=cfg.tasks_dict,
        classification_head_channels=cfg.classification_head_channels,
        regression_head_channels=cfg.regression_head_channels,
        num_classification_blocks=cfg.num_classification_blocks,
        num_regression_blocks=cfg.num_regression_blocks, dtype=cfg.compute_dtype)
    hv = head.init(jax.random.PRNGKey(0), ms, train=False)
    want_h = jax_flops.stage_cost(lambda v, x: head.apply(v, x, train=False), hv, ms)
    ratios = {name: port[name][0] / 1e9 / want[0]
              for name, want in (("backbone", want_bb), ("heads", want_h))}
    assert all(1.0 <= r <= 1.10 for r in ratios.values()), ratios


@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_flop_formulas_match_chip_smoke(stride):
    from torch.utils.flop_counter import FlopCounterMode

    import range_view_3d_detection_torch.kernels  # noqa: F401

    flops.register_kernel_formulas()
    flops.register_kernel_formulas()  # idempotent
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    B, H, W, C = 1, 3, 5, 32
    g, f = t(B, H, W, C), t(B, H, W, C)
    w1, k, a = t(C, C), t(9, C, C), t(C)
    w1q, kq = (x.clamp(-1, 1).mul(100).to(torch.int8) for x in (w1, k))
    kdq = t(9, C).abs()
    iou = t(2, 37, 37).abs().clamp_max(1)
    scores = t(2, 37).sort(descending=True)[0]
    cases = [
        (lambda: torch.ops.rv3d.meta_kernel_fused(g, f, w1, k, a, a, a, a),
         chip_smoke.k1_cost(B, H, W, C)[0]),
        (lambda: torch.ops.rv3d.meta_kernel_fused_i8(g, f, w1q, kq, a, a, a, a, kdq),
         chip_smoke.k4_cost(B, H, W, C)[0]),
        (lambda: torch.ops.rv3d.conv3x3_i8(t(B, H, 6, C), kq, kdq[0], torch.tensor(0.02),
                                           stride, torch.bfloat16),
         chip_smoke.k3_shape_cost((C, C, 6, stride), B, H)[0]),
        (lambda: torch.ops.rv3d.nms_scan(iou, scores, torch.ones(2, 37, dtype=torch.bool),
                                         t(2, 37, 9), 0.3, 0.5), 0),
    ]
    for call, want in cases:
        mode = FlopCounterMode(display=False)
        with mode:
            call()
        assert mode.get_total_flops() == want


def test_scale_drill_cpu_matches_jax_corpus(tmp_path):
    from range_view_3d_detection_tpu.data.dataset import DataLoader, RangeViewDataset
    from range_view_3d_detection_tpu.data.synthetic import generate_dataset
    from range_view_3d_detection_tpu.training.builders import build_dataset_config
    from range_view_3d_detection_tpu.utils.config import compose

    walls = scale_drill.main(["--sweeps", "8", "--logs", "2", "--dense", "--device", "cpu",
                              "--work", str(tmp_path / "port")])
    for key in ("generate corpus", "loader_frames_per_s", "predict (device, s)",
                "flatten + shard writes (s)", "AV2 protocol eval", "av2_mAP",
                "WOD protocol eval (w=0)", "wod_mAP_L2", "wod_mAPH_L2", "num_dets", "num_gts"):
        assert key in walls, key
    assert walls["num_dets"] > 0 and walls["num_gts"] > 0 and walls["device"] == "cpu"
    root = generate_dataset(tmp_path / "jax" / "sensor", splits={"val": 2}, sweeps_per_log=4,
                            height=32, width=248, num_boxes=8, num_bg_points=4000, seed=0)
    cfg = compose(REPO / "conf", "rv-synthetic", [f"dataset.root_dir={root}"])
    ds = RangeViewDataset(build_dataset_config(cfg, "val"))
    frames = sum(len(b["uuids"]) for b in DataLoader(ds, 2, shuffle=False, drop_last=False))
    assert walls["sweeps"] == len(ds) == 8 and walls["loader_frames"] == frames == 8


@pytest.fixture(scope="module")
def quant_runs(tmp_path_factory):
    """Both tools' outputs on one transplanted state."""
    import tools.quant_accuracy as jax_qa  # puts tools/ on sys.path

    import export as _  # noqa: F401  (the JAX tool's module of that name)
    from range_view_3d_detection_torch.data.synthetic import generate_dataset
    from range_view_3d_detection_torch.models.detector import Detector as PortDetector
    from range_view_3d_detection_torch.train import CONF_DIR
    from range_view_3d_detection_torch.training import builders as port_builders
    from range_view_3d_detection_torch.transplant import load_flax_variables
    from range_view_3d_detection_torch.utils.config import compose
    from range_view_3d_detection_tpu.models.detector import Detector
    from range_view_3d_detection_tpu.training import builders as jax_builders
    from test_torch_blocks import randomize_bn

    work = tmp_path_factory.mktemp("quant")
    root = generate_dataset(work / "sensor", splits={"train": 1, "val": 1}, sweeps_per_log=2,
                            height=32, width=248, seed=0)
    cfg = compose(CONF_DIR, "rv-synthetic", [
        f"++dataset.root_dir={root}", "++model.augmentations_config=null",
        "++model.precision=float32", "++model._head.num_classification_blocks=1",
        "++model._head.num_regression_blocks=1", "++model._head.classification_head_channels=16",
        "++model._head.regression_head_channels=16",
        "++model.post_processing_config.nms_cap=128"])
    run_dir = work / "run"
    run_dir.mkdir()
    (run_dir / "config.json").write_text(json.dumps(cfg))

    det_j, dec_j = jax_builders.build_detector_config(cfg), jax_builders.build_decoder_config(cfg)
    feats, cart, mask = serving._sample_inputs(1, 32, 256, 5)
    model_j = Detector(det_j)
    v = model_j.init(jax.random.PRNGKey(0), feats, cart, mask, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=3)
    first = model_j.apply({"params": params, "batch_stats": stats}, feats, cart, mask,
                          train=False)["head"][1][0]
    for name, sub in params["DetectionHead_0"].items():
        final = sub[f"ConvNormAct_{len(sub) - 1}"]["Conv_0"]
        key = "logits" if name.startswith("cls_") else "regressands"
        final["kernel"] *= (2.0 if key == "logits" else 0.3) / float(np.std(np.asarray(first[key])))
        final["bias"][:] = 0.0
        if key == "regressands":
            final["bias"][3:6] = np.log(2.0)
    variables = {"params": params, "batch_stats": stats}

    det_p, dec_p = port_builders.build_detector_config(cfg), port_builders.build_decoder_config(cfg)
    model_p = PortDetector(det_p, device="cpu")
    load_flax_variables(model_p, params, stats)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sys.modules["export"], "_restore_from_run_dir",
                   lambda run_dir: (variables, det_j, dec_j))
        mp.setattr(port_export, "_restore_from_run_dir",
                   lambda run_dir, device="cuda": (model_p, det_p, dec_p))
        jax_qa.main(["--run-dir", str(run_dir), "--out", str(work / "jax"),
                     "--calib-batches", "1"])
        port = quant_accuracy.main(["--run-dir", str(run_dir), "--out", str(work / "port"),
                                    "--calib-batches", "1", "--device", "cpu"])
    finally:
        mp.undo()
    jax_summary = json.loads((work / "jax" / "summary.json").read_text())
    return dict(work=work, port=port, jax=jax_summary)


@pytest.mark.parametrize("name", ["fp", "int8"])
def test_quant_accuracy_matches_jax(quant_runs, name):
    from range_view_3d_detection_torch.utils.feather import read_feather

    work = quant_runs["work"]
    got_dir, want_dir = work / "port" / f"predictions_{name}", work / "jax" / f"predictions_{name}"
    files = sorted(p.name for p in want_dir.glob("*.feather"))
    assert files and files == sorted(p.name for p in got_dir.glob("*.feather"))
    total = 0
    for f in files:
        got, want = read_feather(got_dir / f), read_feather(want_dir / f)
        assert len(got["score"]) == len(want["score"]), f
        np.testing.assert_allclose(np.sort(got["score"]), np.sort(want["score"]), atol=1e-3)
        total += len(want["score"])
    assert total > 0
    port, jax_s = quant_runs["port"], quant_runs["jax"]
    if name == "int8":
        for key in ("mean_ap_delta", "mean_cds_delta"):
            assert abs(port[key] - jax_s[key]) <= 1e-3, (key, port[key], jax_s[key])


def test_remat_grid_reports_oom_and_raises_otherwise(monkeypatch):
    calls = []

    def fake(scope, batch, B, iters, device="cuda", tiny=False):
        calls.append(scope)
        if scope == ("stem",):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return 10.0

    monkeypatch.setattr(remat_grid, "measure", fake)
    rows = remat_grid.grid([("stem",), ("loss",)], 2, 1, "cpu", height=8, width=64, tiny=True)
    assert rows[0]["scope"] == "stem" and "out of memory" in rows[0]["infeasible"]
    assert rows[1] == {"scope": "loss", "ms_per_step": 10.0, "frames_per_sec": 200.0}

    def broken(*a, **k):
        raise ValueError("not a memory error")

    monkeypatch.setattr(remat_grid, "measure", broken)
    with pytest.raises(ValueError):
        remat_grid.grid([None], 2, 1, "cpu", height=8, width=64, tiny=True)
    monkeypatch.undo()
    real = remat_grid.grid([None, ("stem", "loss")], 1, 1, "cpu", height=8, width=64, tiny=True)
    assert all(r["ms_per_step"] > 0 for r in real)


def test_quant_cert_scale_resume_and_aggregate(tmp_path):
    out = tmp_path / "quant_s0"
    out.mkdir()
    ptq = {"qat_steps": 0, "mean_ap_delta": -0.01, "mean_cds_delta": -0.02}
    (out / "summary.json").write_text(json.dumps(ptq))
    assert quant_cert_scale._done(out, 0, 0) == ptq
    assert quant_cert_scale._done(out, 5, 0) is None
    assert quant_cert_scale._done(out, 0, 4) is None
    seeds = [dict(ptq, num_val_gts=500), dict(ptq, mean_ap_delta=0.03, num_val_gts=510)]
    agg = quant_cert_scale.aggregate(seeds)
    assert agg["seeds"] == 2 and agg["num_val_gts"] == [500, 510]
    assert agg["ptq_ap_delta_mean"] == pytest.approx(0.01)
    assert agg["ptq_ap_delta_spread"] == pytest.approx(0.04)
    assert agg["ptq_cds_delta_spread"] == 0.0
