"""Latency and accuracy benchmark harness (counterpart of the repo-root
``tools/benchmark.py``, parity with the reference ``tools/benchmark.py``
33-251).

    python -m range_view_3d_detection_torch.tools.benchmark --synthetic [--device cpu]
    python -m range_view_3d_detection_torch.tools.benchmark experiment=NAME [++k=v ...]
    python -m range_view_3d_detection_torch.tools.benchmark --loader [--height 64] [--width 1800]
    python -m range_view_3d_detection_torch.tools.benchmark --train [--batch 2] [--remat 1] [--iters 12]

The staged run fits the experiment (``--synthetic``: ``rv-synthetic`` on a
generated 32x248 corpus, one epoch), then at B=1 times the forward, decode
without NMS and the full pipeline (host walls that end in a readback,
after warm-up), derives ``nms_ms = full - forward - decode``, times the
projection and the raw-points pipeline, validates and scores the val split
with the AV2 protocol. ``--loader`` times the ``DataLoader`` over a
generated corpus (3 epochs after a warm one); ``--train`` the flagship train
step. ``--profile`` writes a ``torch.profiler`` trace of one full request.
Each prints a JSON report that names the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import tempfile
import time
from pathlib import Path

import torch

from range_view_3d_detection_torch import export, serving
from range_view_3d_detection_torch.tools import device_line, sync, wall_s
from range_view_3d_detection_torch.training.loop import resolve_device

logger = logging.getLogger("benchmark")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("overrides", nargs="*", help="experiment=NAME and ++key=value")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--loader", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work", default=None,
                    help="directory for generated corpora and the run "
                    "(default: under the temporary directory)")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls (default 12 a --train step, 20 a stage)")
    ap.add_argument("--remat", type=int, default=None,
                    help="--train: 1/0 (default 1 at batch >= 2)")
    ap.add_argument("--tiny", action="store_true", help="--train: the tiny config")
    ap.add_argument("--points", type=int, default=None,
                    help="points a cloud for the raw-points stages")
    return ap


def _work(args, name: str) -> Path:
    return Path(args.work) if args.work else Path(tempfile.gettempdir()) / name


def bench_loader(args) -> dict:
    """Host loader frames/s at flagship shapes: the full ``DataLoader``
    iterator (Feather decode, augment, pad/stride, collate, prefetch) over a
    generated corpus of 2 logs x 16 sweeps."""
    from range_view_3d_detection_torch.data.dataset import (
        DataLoader,
        DatasetConfig,
        RangeViewConfig,
        RangeViewDataset,
    )
    from range_view_3d_detection_torch.data.synthetic import generate_dataset

    height, width = args.height or 64, args.width or 1800
    root = _work(args, "rangebox-torch-loaderbench") / f"{height}x{width}" / "sensor"
    if not root.exists():
        generate_dataset(root, splits={"train": 2}, sweeps_per_log=16, height=height,
                         width=width, num_bg_points=40000, seed=3)
    ds = RangeViewDataset(DatasetConfig(
        root_dir=str(root),
        split_name="train",
        range_view=RangeViewConfig(height=height, width=width),
        tasks={0: ("REGULAR_VEHICLE", "PEDESTRIAN")},
        augmentations={
            "flip_azimuth": {"p": 0.5},
            "random_rotation": {"low": -0.785, "high": 0.785, "p": 1.0},
            "random_global_scale": {"low": 0.95, "high": 1.05},
        },
    ))
    loader = DataLoader(ds, batch_size=args.batch, num_workers=args.workers, shuffle=True)
    for _ in loader:  # warm epoch
        pass
    t0 = time.perf_counter()
    timed = 0
    epochs = 3
    for _ in range(epochs):
        for b in loader:
            timed += b["features"].shape[0]
    dt = time.perf_counter() - t0
    report = {
        "loader_frames_per_sec": round(timed / dt, 2),
        "shape": [height, width],
        "batch": args.batch,
        "workers": args.workers,
        "frames_timed": timed,
        "host": "the loader runs on the host CPU",
    }
    print(json.dumps(report, indent=2))
    return report


def bench_train(args) -> dict:
    """The flagship train step (targets, forward, loss, backward, AdamW
    with OneCycle) on a device-resident ``_dryrun_batch``: ms a step,
    steps/s and frames/s after 3 warm-up steps."""
    from range_view_3d_detection_torch.training import optim
    from range_view_3d_detection_torch.training import state as state_lib

    device = resolve_device(args.device)
    batch = args.batch
    height, width = args.height or 64, args.width or 1808
    remat = bool(args.remat if args.remat is not None else batch >= 2)
    cfg = dataclasses.replace(serving._flagship_config(tiny=args.tiny), remat=remat)
    host_batch = serving._dryrun_batch(cfg, batch, height, width, 5)
    device_batch = state_lib.batch_to_device(host_batch, device)
    tx, _ = optim.make_optimizer(7.5e-4, 1000, num_devices=1, batch_size=batch,
                                 use_linear_lr_scaling=True)
    state = state_lib.create_state(cfg, tx, device=device,
                                   generator=torch.Generator().manual_seed(0))
    train_step = state_lib.make_train_step(cfg)
    for _ in range(3):
        state, metrics = train_step(state, device_batch)
    sync(metrics)
    t0 = time.perf_counter()
    iters = args.iters or 12
    for _ in range(iters):
        state, metrics = train_step(state, device_batch)
    sync(metrics)
    dt = time.perf_counter() - t0
    report = {
        "train_step_ms": round(dt / iters * 1e3, 3),
        "steps_per_sec": round(iters / dt, 3),
        "train_frames_per_sec_per_chip": round(batch * iters / dt, 2),
        "batch": batch,
        "shape": [height, width],
        "remat": remat,
        "iters": iters,
        "loss": float(metrics["loss"]),
        "device": device_line(device),
    }
    print(json.dumps(report, indent=2))
    return report


def staged(args) -> dict:
    from range_view_3d_detection_torch.data.synthetic import generate_dataset
    from range_view_3d_detection_torch.evaluation.av2_eval import evaluate_predictions
    from range_view_3d_detection_torch.models.decoder import decode
    from range_view_3d_detection_torch.train import CONF_DIR
    from range_view_3d_detection_torch.training.loop import Trainer
    from range_view_3d_detection_torch.utils.config import compose

    device = resolve_device(args.device)
    overrides = [a for a in args.overrides if not a.startswith("experiment=")]
    experiment = next((a.split("=", 1)[1] for a in args.overrides
                       if a.startswith("experiment=")), None)
    if args.synthetic or experiment is None:
        experiment = "rv-synthetic"
        work = _work(args, "rangebox-torch-bench")
        root = work / "sensor"
        if not root.exists():
            generate_dataset(root, splits={"train": 1, "val": 1}, sweeps_per_log=4,
                             height=32, width=248, seed=7)
        overrides += [f"dataset.root_dir={root}", "trainer.max_epochs=1",
                      f"run_dir={work / 'run'}"]

    cfg = compose(CONF_DIR, experiment, overrides)
    trainer = Trainer(cfg, device=device)
    trainer.fit()
    predictor = serving.Predictor(trainer.det_cfg, trainer.dec_cfg, device=device)
    predictor.model.load_state_dict(trainer.state.model.state_dict())
    model, dec_cfg, tasks = predictor.model, trainer.dec_cfg, trainer.det_cfg.tasks_dict

    batch = next(iter(trainer.val_loader))
    feats, cart, mask = (torch.as_tensor(batch[k][:1], device=device)
                         for k in ("features", "cart", "mask"))

    @torch.inference_mode()
    def fwd(f, c, m):
        return model(f, c, m)

    @torch.inference_mode()
    def dec_only(out):
        return decode(out, dec_cfg, tasks, use_nms=False)

    report = {}
    if args.profile:
        from range_view_3d_detection_torch.tools.profile_trace import trace

        trace_dir = trainer.run_dir / "profile_trace"
        trace(lambda: sync(predictor(feats, cart, mask)), trace_dir, device)
        report["profile_trace"] = str(trace_dir)
        logger.info("profiler trace written to %s", trace_dir)

    kw = dict(iters=args.iters or 20, warmup=min(5, args.iters or 5))
    t_fwd = wall_s(fwd, feats, cart, mask, **kw)
    out = fwd(feats, cart, mask)
    t_dec = wall_s(dec_only, out, **kw)
    t_full = wall_s(predictor, feats, cart, mask, **kw)
    t_nms = max(t_full - t_fwd - t_dec, 0.0)
    report.update({
        "backbone_head_ms": round(t_fwd * 1e3, 3),
        "decode_ms": round(t_dec * 1e3, 3),
        "nms_ms": round(t_nms * 1e3, 3),
        "e2e_ms": round(t_full * 1e3, 3),
        "fps": round(1.0 / t_full, 2),
    })

    ds_meta = export._dataset_meta_from_cfg(cfg)
    points_predict, extra = export.make_points_predict(
        predictor, sensor_width=ds_meta["sensor_width"], height=ds_meta["height"],
        feature_names=ds_meta["feature_names"], dataset_name=ds_meta["dataset_name"],
        x_stride=ds_meta["x_stride"], padding_mode=ds_meta["padding_mode"],
    )
    if extra == ["intensity"]:
        n_pts = args.points or (131072 if ds_meta["sensor_width"] >= 1800 else 32768)
        clouds = tuple(
            torch.as_tensor(a, device=device)
            for a in export._sample_points(1, n_pts, ds_meta["height"], ds_meta["sensor_width"])
        )
        t_proj = wall_s(points_predict.rasterize, *clouds, **kw)
        t_pts = wall_s(points_predict, *clouds, **kw)
        report.update({
            "projection_ms": round(t_proj * 1e3, 3),
            "points_e2e_ms": round(t_pts * 1e3, 3),
            "points_fps": round(1.0 / t_pts, 2),
            "num_points": n_pts,
        })

    pred_dir = trainer.validate()
    metrics = evaluate_predictions(pred_dir, Path(cfg["dataset"]["root_dir"]) / "val",
                                   categories=trainer.categories)
    report["metrics"] = {
        k: {m: round(float(x), 4) for m, x in v.items()} for k, v in metrics.items()
    }
    report["device"] = device_line(device)
    print(json.dumps(report, indent=2))
    return report


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if args.train:
        return bench_train(args)
    if args.loader:
        return bench_loader(args)
    return staged(args)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main(sys.argv[1:])
