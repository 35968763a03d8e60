"""Serving export: the deployment artifact, raw-points serving and the
stream and latency benches (the port's twin of ``tools/export.py``).

The artifact is a directory that both packages read and write:

- ``variables.msgpack``: ``{params, batch_stats}`` in flax's variable
  layout and flax's msgpack (``utils/msgpack.py``), with every BatchNorm
  folded to a bare affine (``scale' = scale / sqrt(var + eps)``, ``bias'
  = bias - mean * scale'``, stored statistics mean 0 and var 1 - eps);
- ``meta.json``: the detector and decoder configs and, optionally, the
  dataset facts the raw-points front end must reproduce;
- ``quant.msgpack`` (optional): the int8 PTQ scales in the JAX quant-tree
  layout; loading then takes the int8 path.

So a model trained by either package serves in the other. A JAX run
directory (orbax) is not readable here: exchange goes through the
artifact. The port runs eagerly, so ``tools/export.py``'s compile cache
has no counterpart; the AOT program (``predict_b{B}.pt2``,
:func:`export_aot`) is its way to serve without the model code.

Deployment modes beyond one request on one card:

- :func:`load_artifact_width_sharded`: one request split by width over
  the ranks of a process group (``parallel/spatial.py``), for latency;
- :func:`make_chunked_predict`: a chunk of requests in one dispatch, a
  CUDA graph replayed per chunk (``--chunk``);
- :func:`export_aot` / :func:`load_aot`: ``torch.export`` of the
  predictor with the four kernels as ``torch.library`` ops (``--aot``).

Usage:
    python -m range_view_3d_detection_torch.export --synthetic --out ART
    python -m range_view_3d_detection_torch.export --run-dir RUN --out ART [--quantize]
    python -m range_view_3d_detection_torch.export --load ART --latency [--points]
    python -m range_view_3d_detection_torch.export --load ART --bench [--batch N] [--chunk K]
    python -m range_view_3d_detection_torch.export --load ART --aot --batch 1,2

Every command takes ``--device`` (default ``cuda``; ``cpu`` runs the
plain kernels).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.data.dataset import (
    AV2_FEATURES,
    WAYMO_FEATURES,
    width_padding,
)
from range_view_3d_detection_torch.models.decoder import DecoderConfig, decode
from range_view_3d_detection_torch.models.detector import (
    Detector,
    DetectorConfig,
    TargetsConfig,
)
from range_view_3d_detection_torch.models.quantized import calibrate_scales, filter_scope
from range_view_3d_detection_torch.ops.projection import rasterize_points
from range_view_3d_detection_torch.parallel import spatial
from range_view_3d_detection_torch.transplant import (
    load_flax_variables,
    state_dict_to_flax,
)
from range_view_3d_detection_torch.utils.msgpack import msgpack_restore, msgpack_serialize

EPS = 1e-5  # flax BatchNorm epsilon used across the model
NUM_PRE_NMS = 50000  # the JAX DecoderConfig's field, which neither package reads


def fold_batch_norms(variables: Mapping[str, Any]) -> Dict[str, Any]:
    """Bake running statistics into the BatchNorm scales and biases of a
    flax-layout numpy tree ``{params, batch_stats}``; returns a new tree.

    Any scope with BatchNorm params ``{scale, bias}`` and statistics
    ``{mean, var}`` is folded, and so are the MetaKernel's flat
    ``<base>_scale``/``<base>_bias`` params beside ``<base>_mean``/
    ``<base>_var`` statistics (``tools/export.py::fold_batch_norms``, the
    same numpy operations).
    """
    params = copy.deepcopy(dict(variables["params"]))
    stats = copy.deepcopy(dict(variables.get("batch_stats", {})))

    def fold(p, s, scale_k, bias_k, mean_k, var_k):
        inv = np.asarray(p[scale_k]) / np.sqrt(np.asarray(s[var_k]) + EPS)
        p[bias_k] = np.asarray(p[bias_k]) - np.asarray(s[mean_k]) * inv
        p[scale_k] = inv
        s[mean_k] = np.zeros_like(np.asarray(s[mean_k]))
        s[var_k] = np.ones_like(np.asarray(s[var_k])) - EPS

    def walk(p, s):
        if not isinstance(p, dict) or not isinstance(s, dict):
            return
        if "scale" in p and "bias" in p and "mean" in s and "var" in s:
            fold(p, s, "scale", "bias", "mean", "var")
            return
        for key in list(p):
            if key.endswith("_scale"):
                base = key[: -len("_scale")]
                if f"{base}_bias" in p and f"{base}_mean" in s and f"{base}_var" in s:
                    fold(p, s, f"{base}_scale", f"{base}_bias", f"{base}_mean",
                         f"{base}_var")
        for k in p:
            if k in s:
                walk(p[k], s[k])

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


# -- config (de)serialization -------------------------------------------------


def _config_to_meta(det_cfg: DetectorConfig, dec_cfg: DecoderConfig) -> dict:
    """The ``meta.json`` configs as the JAX package writes them (its
    ``DecoderConfig`` also carries ``num_pre_nms``)."""
    dec = {}
    for k, v in dataclasses.asdict(dec_cfg).items():
        dec[k] = v
        if k == "subsampling_rates":
            dec["num_pre_nms"] = NUM_PRE_NMS
    return {"detector_config": dataclasses.asdict(det_cfg), "decoder_config": dec}


def _dataset_meta_from_cfg(cfg: Mapping[str, Any]) -> dict:
    """Serving-relevant dataset facts for the artifact (``meta.json``
    "dataset"): what the raw-points front end must reproduce so its
    inputs match what the network saw in training (notably the padding
    mode)."""
    d = cfg["dataset"]["_val_dataset"]
    rv = d["range_view_config"]
    names = rv.get("feature_column_names") or cfg["dataset"]["_train_dataset"][
        "range_view_config"
    ].get("feature_column_names", ["intensity", "range", "x", "y", "z"])
    return {
        "dataset_name": str(d["dataset_name"]),
        "height": int(rv["height"]),
        "sensor_width": int(rv["width"]),
        "x_stride": int(d.get("x_stride", 1)),
        "padding_mode": str(d.get("padding_mode", "constant")),
        "feature_names": list(names),
    }


def _detector_config_from_meta(d: Mapping[str, Any]) -> DetectorConfig:
    d = dict(d)
    d["tasks"] = tuple((int(t), tuple(cats)) for t, cats in d["tasks"])
    d["layers"] = tuple(int(x) for x in d["layers"])
    # Defaults for artifacts written before these fields existed.
    d["stage_blocks"] = tuple(int(x) for x in d.get("stage_blocks", (2, 3, 3, 5, 5)))
    d["remat_scope"] = tuple(
        str(s) for s in d.get("remat_scope", ("stem", "stages", "heads", "loss"))
    )
    d["fpn"] = tuple((int(k), int(v)) for k, v in d["fpn"])
    d["fpn_kernel_sizes"] = tuple(
        (int(k), tuple(int(x) for x in v)) for k, v in d["fpn_kernel_sizes"]
    )
    d["coding_weights"] = tuple(float(x) for x in d["coding_weights"])
    t = dict(d["targets"])
    t["range_partitions"] = tuple(
        (int(k), (float(v[0]), float(v[1]))) for k, v in t["range_partitions"]
    )
    t["point_intervals"] = tuple(
        (int(k), (float(v[0]), float(v[1]))) for k, v in t["point_intervals"]
    )
    d["targets"] = TargetsConfig(**t)
    return DetectorConfig(**d)


def _decoder_config_from_meta(d: Mapping[str, Any]) -> DecoderConfig:
    d = dict(d)
    d.pop("num_pre_nms", None)
    for k in ("lower_bounds", "upper_bounds"):
        d[k] = tuple(float(x) for x in d[k])
    d["subsampling_rates"] = tuple(int(x) for x in d["subsampling_rates"])
    return DecoderConfig(**d)


# -- export / load ------------------------------------------------------------


def export_artifact(
    model_or_tree: nn.Module | Mapping[str, Any],
    det_cfg: DetectorConfig,
    dec_cfg: DecoderConfig,
    out_dir: Path,
    *,
    quantize_batches: Optional[Sequence[Any]] = None,
    quantize_scope: str = "full",
    quantize_scales: Optional[Mapping[str, Any]] = None,
    dataset_meta: Optional[Mapping[str, Any]] = None,
    device: str | torch.device | None = None,
) -> None:
    """Write the serving artifact; optionally add int8 PTQ scales.

    ``model_or_tree``: the port's ``Detector`` (left unchanged) or a
    flax-layout numpy tree ``{params, batch_stats}``. ``quantize_batches``:
    calibration batches ``[(feats, cart, mask), ...]``; the scales are
    calibrated on the BN-folded model (``models/quantized.py``), restricted
    to ``quantize_scope`` ("full" or "heads") and shipped as
    ``quant.msgpack``. ``quantize_scales``: ship this quant tree verbatim
    instead. Calibration runs on ``device`` (default: the model's, or
    ``cuda`` for a tree).
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(model_or_tree, nn.Module):
        params, stats = state_dict_to_flax(model_or_tree.state_dict())
        tree = {"params": params, "batch_stats": stats}
        device = device or next(model_or_tree.parameters()).device
    else:
        tree = model_or_tree
    folded = fold_batch_norms(tree)
    (out_dir / "variables.msgpack").write_bytes(msgpack_serialize(folded))
    meta = _config_to_meta(det_cfg, dec_cfg)
    if dataset_meta is not None:
        meta["dataset"] = dict(dataset_meta)
    (out_dir / "meta.json").write_text(json.dumps(meta))
    if quantize_scales is not None:
        (out_dir / "quant.msgpack").write_bytes(msgpack_serialize(quantize_scales))
    elif quantize_batches is not None:
        model = Detector(det_cfg, device=device or "cuda")
        load_flax_variables(model, folded["params"], folded["batch_stats"])
        with torch.inference_mode():
            qtree = filter_scope(calibrate_scales(model, quantize_batches), quantize_scope)
        (out_dir / "quant.msgpack").write_bytes(msgpack_serialize(qtree))
    print(f"artifact written to {out_dir}")


def load_artifact(
    art_dir: Path,
    *,
    use_nms: bool = True,
    quantized: bool | str = "auto",
    device: str | torch.device = "cuda",
):
    """A ``serving.Predictor`` on ``device`` from an artifact directory.

    Returns ``(predict, det_cfg, dec_cfg)``. The weights are marked
    folded (``predict.bn_folded``), so quantizing never folds twice.
    ``quantized``: "auto" takes the int8 path iff the artifact ships
    ``quant.msgpack``, True requires it, False forces the fp path. The
    int8 stem kernel runs when ``RV3D_STEM_INT8=1``, as in the JAX
    package (``models/stems.py``); else the stem stays on K1. The port
    runs eagerly: there is no compile cache to keep.
    """
    art_dir = Path(art_dir)
    meta = json.loads((art_dir / "meta.json").read_text())
    det_cfg = _detector_config_from_meta(meta["detector_config"])
    dec_cfg = _decoder_config_from_meta(meta["decoder_config"])
    variables = msgpack_restore((art_dir / "variables.msgpack").read_bytes())
    predict = serving.Predictor(det_cfg, dec_cfg, device=device)
    load_flax_variables(predict.model, variables["params"], variables["batch_stats"])
    predict.bn_folded = True
    predict.use_nms = use_nms
    quant_path = art_dir / "quant.msgpack"
    use_q = quant_path.exists() if quantized == "auto" else bool(quantized)
    if use_q:
        predict.quantize(
            quant_tree=msgpack_restore(quant_path.read_bytes()),
            stem_int8=os.environ.get("RV3D_STEM_INT8", "") == "1",
        )
    return predict, det_cfg, dec_cfg


def load_artifact_width_sharded(
    art_dir: Path,
    group=None,
    *,
    use_nms: bool = True,
    circular: Optional[bool] = None,
    device: str | torch.device = "cuda",
):
    """Minimum-latency serving: one request's width split over the ranks
    of ``group`` (None: the default group; without a process group, one
    shard), the exact per-op halo exchange of ``parallel/spatial.py``,
    then decode and NMS (K2) on the gathered outputs on every rank.

    Returns ``(predict, place, det_cfg, dec_cfg)``: ``place(feats, cart,
    mask)`` takes one full request and returns this rank's width shards
    on ``device`` (it refuses a width whose shards are not a multiple of
    the model's width stride, 16); ``predict`` takes them and returns the
    request's ``NMSResult``, the same on every rank (``predict.apply``
    runs the sharded forward alone). fp only, as the JAX
    package's: a ``quant.msgpack`` beside the weights is ignored. The
    stem takes its accumulate path (K1 is device-local). ``circular``
    wraps the azimuth seam; it defaults to the artifact's recorded
    padding mode (circular when none is recorded).
    """
    art_dir = Path(art_dir)
    meta = json.loads((art_dir / "meta.json").read_text())
    det_cfg = _detector_config_from_meta(meta["detector_config"])
    dec_cfg = _decoder_config_from_meta(meta["decoder_config"])
    if circular is None:
        circular = meta.get("dataset", {}).get("padding_mode", "circular") == "circular"
    device = torch.device(device)
    variables = msgpack_restore((art_dir / "variables.msgpack").read_bytes())
    model = serving.Predictor(det_cfg, dec_cfg, device=device).model
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    apply = spatial.width_sharded_apply(model, group, circular=circular, train=False)
    stride = spatial.width_stride(model)
    n = spatial.group_size(group)

    def predict(feats, cart, mask):
        with torch.inference_mode():
            out = spatial.gather_width(apply(feats, cart, mask), group)
            return decode(out, dec_cfg, det_cfg.tasks_dict, use_nms=use_nms)

    def place(feats, cart, mask):
        """This rank's width shards of one request, on ``device``."""
        spatial.check_width(np.shape(feats)[2], n, stride)
        return tuple(
            spatial.shard_width(torch.as_tensor(a, dtype=dt, device=device), group)
            for a, dt in ((feats, torch.float32), (cart, torch.float32), (mask, torch.bool))
        )

    predict.device, predict.model, predict.apply = device, model, apply
    return predict, place, det_cfg, dec_cfg


# -- the chunk loop -------------------------------------------------------------


class ChunkedPredict:
    """``run_chunk(feats (K, B, H, W, C), cart (K, B, H, W, 3), mask (K, B,
    H, W))`` -> the ``K`` results stacked on a leading axis (the JAX
    ``make_chunked_predict``'s ``lax.scan``).

    On the card one call is one CUDA-graph replay: the first call at a
    shape warms ``predict`` up on a side stream (kernel builds, cuDNN
    plans, cached BatchNorm factors), then captures ``K`` calls of it
    over static input buffers; each call copies its inputs into them,
    replays, and returns copies of the outputs. The graph's private
    memory pool lets each micro-batch reuse the last one's activations,
    so activation memory peaks at one micro-batch. On the CPU it is the
    plain loop. ``predict`` must not synchronise with the host (no
    ``.item()``, no data-dependent shapes): the served path does not.
    """

    def __init__(self, predict: Callable, chunk: int):
        if chunk < 1:
            raise ValueError(f"make_chunked_predict: chunk={chunk}")
        self.predict = predict
        self.chunk = chunk
        self.device = torch.device(getattr(predict, "device", "cpu"))
        self.graphs: Dict[tuple, tuple] = {}

    def _capture(self, args):
        static = [torch.empty_like(a) for a in args]
        for dst, src in zip(static, args):
            dst.copy_(src)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.predict(*(t[0] for t in static))
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [self.predict(*(t[i] for t in static)) for i in range(self.chunk)]
            stacked = type(outs[0])(*(torch.stack(x) for x in zip(*outs)))
        return graph, static, stacked

    def __call__(self, *args):
        args = [torch.as_tensor(a, device=self.device) for a in args]
        if any(a.shape[0] != self.chunk for a in args):
            raise ValueError(
                f"ChunkedPredict: leading axes {[a.shape[0] for a in args]} != "
                f"chunk {self.chunk}"
            )
        if self.device.type != "cuda":
            outs = [self.predict(*(a[i] for a in args)) for i in range(self.chunk)]
            return type(outs[0])(*(torch.stack(x) for x in zip(*outs)))
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        if key not in self.graphs:
            self.graphs[key] = self._capture(args)
        graph, static, stacked = self.graphs[key]
        for dst, src in zip(static, args):
            dst.copy_(src)
        graph.replay()
        return type(stacked)(*(t.clone() for t in stacked))


def make_chunked_predict(predict: Callable, chunk: int) -> ChunkedPredict:
    """Device-resident serving loop: one dispatch runs a whole chunk of
    ``chunk`` stacked requests (:class:`ChunkedPredict`)."""
    return ChunkedPredict(predict, chunk)


# -- ahead of time --------------------------------------------------------------


class PredictProgram(nn.Module):
    """A ``serving.Predictor``'s forward, decode and NMS as one module, the
    program :func:`export_aot` hands to ``torch.export``."""

    def __init__(self, predict: serving.Predictor):
        super().__init__()
        self.model = predict.model
        self.decoder_cfg = predict.decoder_cfg
        self.tasks = predict.cfg.tasks_dict
        self.use_nms = predict.use_nms

    def forward(self, feats: torch.Tensor, cart: torch.Tensor, mask: torch.Tensor):
        out = self.model(feats, cart, mask)
        return decode(out, self.decoder_cfg, self.tasks, use_nms=self.use_nms)


def export_aot(
    art_dir: Path,
    *,
    batch: int,
    height: int,
    width: int,
    device: str | torch.device = "cuda",
) -> Path:
    """``torch.export`` of the artifact's predictor (weights inside) at
    ``(batch, height, width)``, saved as ``predict_b{batch}.pt2`` beside
    the artifact; the int8 path when the artifact ships scales (as
    :func:`load_artifact` loads it). The four kernels are opaque
    ``rv3d::`` custom ops in the program, so :func:`load_aot` needs their
    registrations and nothing of the model. Exported on ``device``; the
    program serves there."""
    art_dir = Path(art_dir)
    predict, det_cfg, _ = load_artifact(art_dir, device=device)
    dev = predict.device
    C = det_cfg.in_channels
    example = (
        torch.zeros((batch, height, width, C), dtype=torch.float32, device=dev),
        torch.zeros((batch, height, width, 3), dtype=torch.float32, device=dev),
        torch.zeros((batch, height, width), dtype=torch.bool, device=dev),
    )
    program = PredictProgram(predict).eval()
    with torch.no_grad():
        exported = torch.export.export(program, example, strict=False)
    out = art_dir / f"predict_b{batch}.pt2"
    torch.export.save(exported, out)
    print(f"AOT artifact written to {out} ({out.stat().st_size // 1024} KiB)")
    return out


def load_aot(path: Path, device: str | torch.device | None = None) -> Callable:
    """The program :func:`export_aot` wrote, as ``predict(feats, cart,
    mask) -> NMSResult`` (host arrays or tensors). It needs the kernels'
    op registrations (``range_view_3d_detection_torch.kernels``) and
    nothing of the model or its config. ``device`` moves the program
    (default: where it was exported)."""
    import range_view_3d_detection_torch.kernels  # noqa: F401  (rv3d:: ops)

    exported = torch.export.load(str(path))
    if device is not None:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, torch.device(device))
    module = exported.module()
    dev = next(iter(exported.state_dict.values())).device

    def predict(feats, cart, mask):
        with torch.inference_mode():
            return module(
                torch.as_tensor(feats, dtype=torch.float32, device=dev),
                torch.as_tensor(cart, dtype=torch.float32, device=dev),
                torch.as_tensor(mask, dtype=torch.bool, device=dev),
            )

    predict.device = dev
    return predict


class PointsPredict:
    """Raw clouds in, detections out: :func:`ops.projection.rasterize_points`
    on the predictor's device, then the predictor.

    ``points_predict(xyz (B, N, 3), laser (B, N), *extras)`` takes host
    arrays or tensors, one (B, N) extra channel per ``extra_names`` entry;
    pad clouds to a common N with zero rows (the z-buffer's minimum
    distance drops them)."""

    def __init__(self, predict: Callable, device: torch.device, extra_names, **kw):
        self.predict = predict
        self.device = device
        self.extra_names = list(extra_names)
        self.kw = kw

    def rasterize(self, xyz, laser, *chans):
        with torch.inference_mode():
            xyz = torch.as_tensor(xyz, dtype=torch.float32, device=self.device)
            laser = torch.as_tensor(laser, device=self.device)
            chans = {
                n: torch.as_tensor(c, dtype=torch.float32, device=self.device)
                for n, c in zip(self.extra_names, chans)
            }
            return rasterize_points(xyz, laser, chans, **self.kw)

    def __call__(self, xyz, laser, *chans):
        return self.predict(*self.rasterize(xyz, laser, *chans))


def make_points_predict(
    predict: Callable,
    *,
    sensor_width: int,
    height: int,
    feature_names: Sequence[str],
    dataset_name: str = "av2",
    x_stride: int = 1,
    padding_mode: str = "circular",
):
    """Put the raw-points front end in front of a range-image predictor
    (``tools/export.py::make_points_predict``). Returns ``(points_predict,
    extra_names)``: the non-geometric channels it takes, in order. It runs
    on ``predict.device``."""
    derived = ("range", "x", "y", "z", "view")
    extra = [n for n in feature_names if n not in derived]
    points_predict = PointsPredict(
        predict, torch.device(predict.device), extra,
        height=height, width=sensor_width, feature_names=tuple(feature_names),
        dataset_name=dataset_name, x_stride=x_stride,
        pad=width_padding(sensor_width, x_stride), padding_mode=padding_mode,
    )
    return points_predict, extra


def _sample_points(B, n, H, W_sensor, seed=0):
    """Synthetic sensor-frame clouds (the points-mode ``_sample_inputs``)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(5, 60, size=(B, n)).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, size=(B, n)).astype(np.float32)
    el = rng.uniform(-0.3, 0.1, size=(B, n)).astype(np.float32)
    xyz = np.stack(
        [r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)],
        axis=-1,
    )
    laser = rng.integers(0, H, size=(B, n)).astype(np.int32)
    intensity = rng.uniform(0, 1, size=(B, n)).astype(np.float32)
    return xyz, laser, intensity


# -- benches ------------------------------------------------------------------


def _sync(result) -> float:
    """Read the first tensor of a result (any nest of tuples, lists and
    dicts) back to the host: a request ends when its detections are on the
    host, not when its launches return."""
    leaf = next(x for x in pytree.tree_leaves(result) if isinstance(x, torch.Tensor))
    return float(leaf.float().sum())


def _device_batches(predict, make_batch, n: int = 4):
    device = torch.device(predict.device)
    return [
        tuple(torch.as_tensor(np.asarray(a), device=device) for a in make_batch(i))
        for i in range(n)
    ]


def _device_name(predict) -> str:
    device = torch.device(predict.device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def stream_bench(
    predict: Callable,
    *,
    batch: int,
    iters: int,
    H: int,
    W: int,
    C: int,
    chunk: int = 0,
    make_batch: Optional[Callable] = None,
) -> float:
    """Batched-stream throughput: ``iters`` requests back to back over 4
    distinct batches placed on the device beforehand, one host readback
    at the end. Prints one JSON line (``stream_frames_per_sec``,
    ``ms_per_batch``) and returns the frames a second.

    ``chunk > 0``: ``chunk`` distinct batches stacked on the device, one
    :func:`make_chunked_predict` call (a CUDA-graph replay on the card)
    per iteration, ``batch * chunk * iters`` frames
    (``ms_per_microbatch``)."""
    if make_batch is None:
        def make_batch(seed):
            return serving._sample_inputs(batch, H, W, C, seed=seed)

    if chunk > 0:
        device = torch.device(predict.device)
        parts = [make_batch(i) for i in range(chunk)]
        stacked = [
            torch.as_tensor(np.stack([np.asarray(p[j]) for p in parts]), device=device)
            for j in range(len(parts[0]))
        ]
        run_chunk = make_chunked_predict(predict, chunk)
        _sync(run_chunk(*stacked))  # capture + warm
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = run_chunk(*stacked)
        _sync(out)
        dt = time.perf_counter() - t0
        fps = batch * chunk * iters / dt
        print(json.dumps({
            "stream_frames_per_sec": round(fps, 2),
            "batch": batch,
            "chunk": chunk,
            "iters": iters,
            "ms_per_microbatch": round(dt / (iters * chunk) * 1e3, 2),
            "device": _device_name(predict),
        }), flush=True)
        return fps

    batches = _device_batches(predict, make_batch)
    for b in batches[:2]:
        _sync(predict(*b))
    t0 = time.perf_counter()
    out = None
    for i in range(iters):
        out = predict(*batches[i % 4])
    _sync(out)
    dt = time.perf_counter() - t0
    fps = batch * iters / dt
    print(json.dumps({
        "stream_frames_per_sec": round(fps, 2),
        "batch": batch,
        "iters": iters,
        "ms_per_batch": round(dt / iters * 1e3, 2),
        "device": _device_name(predict),
    }), flush=True)
    return fps


def latency_bench(
    predict: Callable,
    *,
    batch: int,
    iters: int,
    H: int,
    W: int,
    C: int,
    make_batch: Optional[Callable] = None,
) -> dict:
    """Per-request latency: one request, its result read back to the host,
    then the next; host wall clock around each. Prints one JSON line of
    nearest-rank p50/p90/p99 and the minimum, and returns it."""
    if make_batch is None:
        def make_batch(seed):
            return serving._sample_inputs(batch, H, W, C, seed=seed)

    batches = _device_batches(predict, make_batch)
    for b in batches[:2]:
        _sync(predict(*b))
    walls = []
    for i in range(iters):
        b = batches[i % 4]
        t0 = time.perf_counter()
        _sync(predict(*b))
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()

    def pct(p):
        # Nearest rank: ceil(p/100 * n) - 1, 0-indexed.
        n = len(walls)
        return walls[min(n - 1, max(0, -(-p * n // 100) - 1))]

    stats = {
        "latency_ms_p50": round(pct(50), 2),
        "latency_ms_p90": round(pct(90), 2),
        "latency_ms_p99": round(pct(99), 2),
        "latency_ms_min": round(walls[0], 2),
        "batch": batch,
        "iters": iters,
        "device": _device_name(predict),
    }
    print(json.dumps(stats), flush=True)
    return stats


# -- run directories ----------------------------------------------------------


def _eval_shape(cfg: Mapping[str, Any]) -> tuple:
    """(H, Wp) a run evaluates at: the configured height and the padded,
    ``x_stride``-decimated width the data layer emits."""
    rv = cfg["dataset"]["_val_dataset"]["range_view_config"]
    H, W = int(rv["height"]), int(rv["width"])
    x_stride = int(cfg["dataset"]["_val_dataset"].get("x_stride", 1))
    return H, (W + 2 * width_padding(W, x_stride)) // x_stride


def _calibration_batches_from_run(run_dir: Path, n: int = 4):
    """Up to ``n`` val items of the run's dataset as calibration batches,
    or None when its dataset is not on disk."""
    from range_view_3d_detection_torch.data.dataset import RangeViewDataset
    from range_view_3d_detection_torch.training.builders import build_dataset_config

    cfg = json.loads((Path(run_dir) / "config.json").read_text())
    try:
        ds = RangeViewDataset(build_dataset_config(cfg, "val"))
    except (OSError, KeyError, ValueError):
        return None
    if len(ds) == 0:
        return None
    batches = []
    for i in range(min(n, len(ds))):
        item = ds[i]
        batches.append((item["features"][None], item["cart"][None], item["mask"][None]))
    return batches


def _restore_from_run_dir(run_dir: Path, device: str | torch.device = "cuda"):
    """``(model, det_cfg, dec_cfg)`` from a port training run directory:
    its ``config.json`` and the latest checkpoint under ``checkpoints/``."""
    from range_view_3d_detection_torch.training import optim
    from range_view_3d_detection_torch.training.builders import (
        build_decoder_config,
        build_detector_config,
    )
    from range_view_3d_detection_torch.training.checkpoints import CheckpointManager
    from range_view_3d_detection_torch.training.state import create_state

    cfg = json.loads((Path(run_dir) / "config.json").read_text())
    det_cfg = build_detector_config(cfg)
    dec_cfg = build_decoder_config(cfg)
    tx, _ = optim.make_optimizer(1e-3, 100)
    template = create_state(det_cfg, tx, device=device)
    state, _ = CheckpointManager(Path(run_dir) / "checkpoints").restore(template)
    state.model.eval()
    return state.model, det_cfg, dec_cfg


# -- command line -------------------------------------------------------------


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir")
    ap.add_argument("--out")
    ap.add_argument("--load")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--aot", action="store_true",
                    help="with --load: torch.export the predictor (the kernels as "
                    "torch.library ops) to predict_b{B}.pt2 beside the artifact")
    ap.add_argument("--batch", default="2",
                    help="batch size; with --aot a comma list exports one program a size")
    ap.add_argument("--chunk", type=int, default=0,
                    help="with --bench: micro-batches per dispatch (a CUDA graph "
                    "replayed per chunk)")
    ap.add_argument("--latency", action="store_true",
                    help="with --load: per-request latency (p50/p90/p99) instead of "
                    "stream throughput")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=1808)
    ap.add_argument("--points", action="store_true",
                    help="with --load --bench/--latency: serve raw point clouds "
                    "(projection on the device in front of the forward)")
    ap.add_argument("--num-points", type=int, default=131072,
                    help="cloud size for --points")
    ap.add_argument("--sensor-width", type=int, default=1800,
                    help="azimuth bins before padding and striding for --points; the "
                    "artifact's dataset meta takes precedence")
    ap.add_argument("--padding-mode", default=None, choices=("circular", "constant"),
                    help="width padding for --points (default: the artifact's, else "
                    "circular)")
    ap.add_argument("--x-stride", type=int, default=None,
                    help="column decimation for --points (default: the artifact's, "
                    "else 1)")
    ap.add_argument("--nms-cap", type=int, default=1024,
                    help="the synthetic export's proposal budget")
    ap.add_argument("--quantize", nargs="?", const="full", default=None,
                    choices=("full", "heads"),
                    help="ship int8 PTQ scales (calibrated at export); loading then "
                    "takes the int8 path unless --fp")
    ap.add_argument("--fp", action="store_true",
                    help="serve an int8 artifact on the fp path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _points_frontend(args, art_dir: Path, predict, det_cfg, batch: int):
    """The --points predictor and its batch maker, from the artifact's
    dataset meta (CLI flags override the stride and padding)."""
    ds_meta = json.loads((art_dir / "meta.json").read_text()).get("dataset", {})
    names = tuple(ds_meta.get(
        "feature_names",
        AV2_FEATURES if det_cfg.in_channels == len(AV2_FEATURES) else WAYMO_FEATURES,
    ))
    sensor_w = int(ds_meta.get("sensor_width", args.sensor_width))
    height = int(ds_meta.get("height", args.height))
    x_stride = args.x_stride if args.x_stride is not None else int(ds_meta.get("x_stride", 1))
    padding_mode = args.padding_mode or ds_meta.get("padding_mode", "circular")
    served = (sensor_w + 2 * width_padding(sensor_w, x_stride)) // x_stride
    if served != args.width:
        raise SystemExit(f"sensor width {sensor_w} pads/strides to {served}, not "
                         f"--width {args.width}")
    points_predict, extra = make_points_predict(
        predict, sensor_width=sensor_w, height=height, feature_names=names,
        dataset_name=ds_meta.get("dataset_name", "av2"), x_stride=x_stride,
        padding_mode=padding_mode,
    )
    if extra and extra != ["intensity"]:
        raise SystemExit(f"synthetic points mode only fills intensity, not {extra}")

    def make_batch(seed):
        xyz, laser, inten = _sample_points(batch, args.num_points, height, sensor_w,
                                           seed=seed)
        return (xyz, laser, inten) if extra else (xyz, laser)

    return points_predict, make_batch


def main(argv: Sequence[str] | None = None):
    args = _parser().parse_args(argv)
    batch = int(str(args.batch).split(",")[0])

    if args.load:
        art_dir = Path(args.load)
        if args.aot:
            return [
                export_aot(art_dir, batch=int(b), height=args.height, width=args.width,
                           device=args.device)
                for b in str(args.batch).split(",")
            ]
        predict, det_cfg, _ = load_artifact(
            art_dir, quantized=False if args.fp else "auto", device=args.device
        )
        make_batch = None
        if args.points:
            predict, make_batch = _points_frontend(args, art_dir, predict, det_cfg, batch)
        kw = dict(batch=batch, iters=args.iters, H=args.height, W=args.width,
                  C=det_cfg.in_channels, make_batch=make_batch)
        if args.latency:
            return latency_bench(predict, **kw)
        if args.bench:
            return stream_bench(predict, chunk=args.chunk, **kw)
        return None

    if args.synthetic:
        det_cfg = serving._flagship_config()
        model = Detector(det_cfg, device=args.device,
                         generator=torch.Generator().manual_seed(0))
        dec_cfg = DecoderConfig(nms_cap=args.nms_cap)
        # The synthetic flagship is rv-av2-shaped: record its serving facts
        # when the shapes match (AV2's 64x1800 pads to 1808).
        dataset_meta = (
            {"dataset_name": "av2", "height": args.height, "sensor_width": 1800,
             "x_stride": 1, "padding_mode": "circular",
             "feature_names": list(AV2_FEATURES)}
            if (args.height, args.width) == (64, 1808) else None
        )
    else:
        if not args.run_dir:
            raise SystemExit("give --load, --synthetic or --run-dir")
        model, det_cfg, dec_cfg = _restore_from_run_dir(Path(args.run_dir), args.device)
        dataset_meta = _dataset_meta_from_cfg(
            json.loads((Path(args.run_dir) / "config.json").read_text())
        )
    if args.out is None:
        raise SystemExit("give --out for the artifact")

    quantize_batches = None
    if args.quantize:
        calib_h, calib_w = args.height, args.width
        if args.run_dir and not args.synthetic:
            # The run's own eval shape, and its val data where it is on disk.
            cfg_run = json.loads((Path(args.run_dir) / "config.json").read_text())
            calib_h, calib_w = _eval_shape(cfg_run)
            quantize_batches = _calibration_batches_from_run(Path(args.run_dir))
            if quantize_batches is None:
                print("warning: run dataset not on disk; calibrating int8 scales on "
                      f"synthetic noise at {calib_h}x{calib_w}")
        if quantize_batches is None:
            quantize_batches = [
                serving._sample_inputs(1, calib_h, calib_w, det_cfg.in_channels, seed=s)
                for s in range(4)
            ]
    export_artifact(
        model, det_cfg, dec_cfg, Path(args.out),
        quantize_batches=quantize_batches, quantize_scope=args.quantize or "full",
        dataset_meta=dataset_meta,
    )
    return None


if __name__ == "__main__":
    main(sys.argv[1:])
