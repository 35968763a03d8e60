"""End-to-end single-card benchmark of the port: forward + decode +
weighted NMS on the rv-av2 flagship (64 x 1808 x 5, ``DecoderConfig()``
with ``nms_cap`` 1024), the span of the JAX package's ``bench.py``:

    python -m range_view_3d_detection_torch.bench [--batch N] [--fp] \\
        [--points] [--device cpu] [--dry-parse]

The default is the int8 serving point: BatchNorm folded, activation scales
calibrated on the bench batch, full scope (``serving.Predictor.quantize``;
K1, K2 and K3 launch). ``--fp`` measures the compute-dtype path (bf16: K1
and K2). ``--points`` (or ``RV3D_BENCH_POINTS=1``) puts the raw-points
front end in front (``export.make_points_predict``: B x 131,072 points,
sensor width 1800, served at 1808). ``RV3D_STEM_INT8=1`` runs the int8 stem
(K4 in place of K1). ``--batch`` defaults to ``RV3D_BENCH_BATCH`` or 2.

There is no fallback: a failure to quantize or to run the int8 path raises
and the process exits non-zero; the path measured is named in the JSON
line. The pipeline runs as users run it, eagerly (or compiled under
``RV3D_COMPILER_OPTIONS``, ``utils/compile_opts.py``), and the line says
which.

Loop: 3 warm-up requests, then 24 back to back with a host readback every
6 (frames/s), then ``export.latency_bench`` over 50 requests (p50/p90).
Prints ONE JSON line last: ``metric`` (``e2e_frames_per_sec_per_chip``),
``value``, ``unit``, ``path``, ``inputs``, ``mode``, ``p50_ms``,
``p90_ms``, ``batch`` and ``device`` (``nvidia-smi``'s name and power
limit, or ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Tuple

import torch

from range_view_3d_detection_torch import export, serving
from range_view_3d_detection_torch.models.decoder import DecoderConfig, decode
from range_view_3d_detection_torch.tools import device_line, sync
from range_view_3d_detection_torch.utils.compile_opts import ENV_VAR, jit_env_options

HEIGHT, WIDTH = 64, 1808
SENSOR_WIDTH, NUM_POINTS = 1800, 131072
AV2_FEATURES = ("intensity", "range", "x", "y", "z")
WARMUP, ITERS, CHUNK, LATENCY_ITERS = 3, 24, 6, 50


def serving_point(predictor: serving.Predictor, calib, *, fp: bool, stem_int8: bool) -> str:
    """Make ``predictor`` the served pipeline and return the path's name:
    the compute dtype with ``fp``, else the int8 PTQ point calibrated on
    ``calib`` (one ``(feats, cart, mask)`` batch), full scope, with the int8
    stem when ``stem_int8``. Any failure raises."""
    if fp:
        return predictor.cfg.dtype
    predictor.quantize([calib], scope="full", stem_int8=stem_int8)
    return "int8 (K4 stem)" if stem_int8 else "int8"


def compilable(predictor: serving.Predictor) -> Callable:
    """``predictor``'s pipeline (forward, decode, NMS) on device tensors
    under ``no_grad``: what ``torch.compile`` takes, all of it, under
    ``compile_opts.EAGER_NUMERICS``. (Dynamo cannot resume a graph inside
    ``Predictor.__call__``'s ``inference_mode``.)"""

    def serve(feats, cart, mask):
        with torch.no_grad():
            out = predictor.model(feats, cart, mask)
            return decode(out, predictor.decoder_cfg, predictor.cfg.tasks_dict,
                          use_nms=predictor.use_nms)

    return serve


def build(batch: int, *, fp: bool = False, points: bool = False,
          device: str | torch.device = "cuda", seed: int = 0, cfg=None, dec=None,
          height: int = HEIGHT, width: int = WIDTH,
          state_dict=None) -> Tuple[Callable, tuple, Callable, str]:
    """The bench's pipeline: ``(pipeline, args, make_batch, path)``, ``args``
    on the device. ``cfg`` (default the flagship) and ``dec`` (default
    ``DecoderConfig()``, the flagship's), weights from ``seed`` or
    ``state_dict``, calibrated on ``serving._sample_inputs(batch, height,
    width, C)``. Eager it is the ``Predictor`` itself; under
    ``RV3D_COMPILER_OPTIONS`` it is :func:`compilable` compiled (range
    images only). ``points`` puts AV2's sensor (1800 columns, x_stride 1)
    in front; another layout's front end is ``export.make_points_predict``
    around the range-image pipeline."""
    cfg = cfg or serving._flagship_config()
    C = cfg.in_channels
    request = serving._sample_inputs(batch, height, width, C)
    predictor = serving.Predictor(cfg, dec or DecoderConfig(), device=device,
                                  generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        predictor.model.load_state_dict(state_dict, strict=True)
    stem_int8 = os.environ.get("RV3D_STEM_INT8", "") == "1"
    path = serving_point(predictor, request, fp=fp, stem_int8=stem_int8 and not fp)
    compiled = bool(os.environ.get(ENV_VAR, ""))
    if points:
        if compiled:
            raise ValueError(f"bench: {ENV_VAR} compiles the range-image pipeline only")
        pipeline, _ = export.make_points_predict(
            predictor, sensor_width=SENSOR_WIDTH, height=height, feature_names=AV2_FEATURES)

        def make_batch(s):
            return export._sample_points(batch, NUM_POINTS, height, SENSOR_WIDTH, seed=s)
    else:
        pipeline = jit_env_options(compilable(predictor)) if compiled else predictor

        def make_batch(s):
            return serving._sample_inputs(batch, height, width, C, seed=s)
    args = tuple(torch.as_tensor(a, device=predictor.device) for a in make_batch(0))
    return pipeline, args, make_batch, path


def measure(pipeline: Callable, args: tuple, make_batch: Callable,
            batch: int) -> Tuple[float, dict]:
    """The bench's loop on a built pipeline (:func:`build`'s first three
    values): ``(frames/s, export.latency_bench's percentiles)``."""
    for _ in range(WARMUP):
        sync(pipeline(*args))
    t0 = time.perf_counter()
    for i in range(ITERS):
        res = pipeline(*args)
        if (i + 1) % CHUNK == 0:
            sync(res)
    fps = batch * ITERS / (time.perf_counter() - t0)
    # H, W and C only size latency_bench's default batches; make_batch
    # replaces them.
    lat = export.latency_bench(pipeline, batch=batch, iters=LATENCY_ITERS, H=HEIGHT,
                               W=WIDTH, C=5, make_batch=make_batch)
    return fps, lat


def _run(batch: int, *, fp: bool = False, points: bool = False,
         device: str | torch.device = "cuda") -> dict:
    pipeline, args, make_batch, path = build(batch, fp=fp, points=points, device=device)
    fps, lat = measure(pipeline, args, make_batch, batch)
    spec = os.environ.get(ENV_VAR, "")
    execution = f"torch.compile({spec})" if spec else "eager"
    report = {
        "metric": "e2e_frames_per_sec_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "path": path,
        "inputs": f"points ({NUM_POINTS} a frame)" if points else "range images",
        "mode": f"{path} {execution}",
        "p50_ms": lat["latency_ms_p50"],
        "p90_ms": lat["latency_ms_p90"],
        "batch": batch,
        "device": device_line(device),
    }
    print(json.dumps(report), flush=True)
    return report


def main(argv: list[str] | None = None):
    """CLI entry point. ``--dry-parse`` exits after parsing, without
    building anything."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int,
                        default=int(os.environ.get("RV3D_BENCH_BATCH", "2")),
                        help="frames a request (default 2)")
    parser.add_argument("--fp", action="store_true", help="the compute-dtype path")
    parser.add_argument("--points", action="store_true",
                        default=os.environ.get("RV3D_BENCH_POINTS", "") == "1",
                        help="raw points in front of the forward")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dry-parse", action="store_true",
                        help="parse arguments and exit without running")
    args = parser.parse_args(argv)
    if args.dry_parse:
        return 0.0
    return _run(args.batch, fp=args.fp, points=args.points, device=args.device)


if __name__ == "__main__":
    main()
