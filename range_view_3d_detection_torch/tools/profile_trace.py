"""A ``torch.profiler`` trace of the flagship forward, and its device time
by kernel (counterpart of the repo-root ``tools/profile_trace.py``):

    python -m range_view_3d_detection_torch.tools.profile_trace [--out DIR] \\
        [--decode] [--points] [--quantized full|heads] \\
        [--train [--remat-scope stem,heads,loss]] [--batch 1] [--device cpu]
    python -m range_view_3d_detection_torch.tools.profile_trace --summarize-only --out DIR

One warm-up call, then one call traced with the CPU and CUDA activities;
the Chrome trace goes to ``DIR/trace.json``. :func:`summarize` sums the
device time of every GPU event of the trace (kernels, the custom ones
among them, and memory copies and sets) by name.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re
import sys
import tempfile
from pathlib import Path
from typing import Callable

import torch

from range_view_3d_detection_torch import export, serving
from range_view_3d_detection_torch.models.decoder import DecoderConfig
from range_view_3d_detection_torch.tools import device_line, sync
from range_view_3d_detection_torch.training.loop import resolve_device

# The Chrome trace's categories of device events.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace(fn: Callable[[], object], out_dir: Path, device) -> Path:
    """Trace one call of ``fn`` (CPU and, on a card, CUDA activities) and
    write the Chrome trace to ``out_dir/trace.json``. A first, untraced
    call under the profiler warms it up: in a process that has profiled
    before, a session's first kernels can otherwise go unrecorded."""
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=activities, schedule=schedule,
                                on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(2):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.step()
    return path


def summarize(trace_dir, top: int = 30, categories=DEVICE_CATEGORIES) -> dict:
    """Device time by event name from the newest ``*.json`` trace in
    ``trace_dir``: every complete event of ``categories`` counts (device
    events do not nest). Prints the top ``top`` and a grouped view, and
    returns ``{"total_ms", "events", "by_name": {name: {"ms", "count"}}}``."""
    files = sorted(Path(trace_dir).glob("*.json"), key=lambda p: p.stat().st_mtime)
    if not files:
        print("no trace files found")
        return {"total_ms": 0.0, "events": 0, "by_name": {}}
    data = json.loads(files[-1].read_text())
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    agg: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in categories:
            agg[e["name"]] += float(e.get("dur", 0.0))
            counts[e["name"]] += 1
    total = sum(agg.values())
    print(f"device time: {total / 1e3:.3f} ms over {sum(counts.values())} events of "
          f"{len(agg)} names ({', '.join(categories)})")
    for name, dur in agg.most_common(top):
        print(f"  {dur / 1e3:9.3f} ms  {counts[name]:5d}x  {name[:110]}")
    groups: collections.Counter = collections.Counter()
    group_counts: collections.Counter = collections.Counter()
    for name, dur in agg.items():
        base = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
        base = re.split(r"[<(]", base, maxsplit=1)[0].strip().rstrip("0123456789_")
        groups[base] += dur
        group_counts[base] += counts[name]
    print("by kernel family:")
    for base, dur in groups.most_common(15):
        print(f"  {dur / 1e3:9.3f} ms  {group_counts[base]:5d}x  {base[:110]}")
    return {
        "total_ms": total / 1e3,
        "events": sum(counts.values()),
        "by_name": {n: {"ms": agg[n] / 1e3, "count": counts[n]} for n in agg},
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(Path(tempfile.gettempdir()) / "fwd_trace"))
    ap.add_argument("--summarize-only", action="store_true")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=1808)
    ap.add_argument("--decode", action="store_true", help="trace decode and NMS too")
    ap.add_argument("--points", action="store_true",
                    help="from raw clouds (rasterize_points in front; implies --decode; "
                    "AV2's sensor width 1800)")
    ap.add_argument("--num-points", type=int, default=131072)
    ap.add_argument("--quantized", nargs="?", const="full", default=None,
                    choices=("full", "heads"),
                    help="the int8 PTQ path, calibrated on the traced batch")
    ap.add_argument("--train", action="store_true",
                    help="trace one full train step instead of the forward")
    ap.add_argument("--remat-scope", default="",
                    help="--train: comma list (stem,stages,heads,loss); empty: remat off")
    ap.add_argument("--tiny", action="store_true", help="the tiny config")
    ap.add_argument("--device", default="cuda")
    return ap


def _train_call(args, device) -> Callable[[], object]:
    from range_view_3d_detection_torch.tools.profile_train import make_batch, num_categories
    from range_view_3d_detection_torch.training import optim
    from range_view_3d_detection_torch.training import state as state_lib

    K = 64
    scope = tuple(s for s in args.remat_scope.split(",") if s)
    cfg = dataclasses.replace(serving._flagship_config(tiny=args.tiny), max_boxes=K,
                              remat=bool(scope), **({"remat_scope": scope} if scope else {}))
    batch = state_lib.batch_to_device(
        make_batch(args.batch, args.height, args.width, 5, K, categories=num_categories(cfg)),
        device)
    st = state_lib.create_state(cfg, optim.make_optimizer(1e-3, 100)[0], device=device,
                                generator=torch.Generator().manual_seed(0))
    step = state_lib.make_train_step(cfg)
    holder = [st]

    def call():
        holder[0], m = step(holder[0], batch)
        return sync(m["loss"])

    return call


def _forward_call(args, device) -> Callable[[], object]:
    cfg = serving._flagship_config(tiny=args.tiny)
    request = serving._sample_inputs(args.batch, args.height, args.width, cfg.in_channels)
    predictor = serving.Predictor(cfg, DecoderConfig(), device=device,
                                  generator=torch.Generator().manual_seed(0))
    if args.quantized:
        predictor.quantize([request], scope=args.quantized)
    if args.points:
        front, _ = export.make_points_predict(
            predictor, sensor_width=1800, height=args.height,
            feature_names=("intensity", "range", "x", "y", "z"))
        clouds = tuple(torch.as_tensor(a, device=device) for a in export._sample_points(
            args.batch, args.num_points, args.height, 1800))
        return lambda: sync(front(*clouds))
    tensors = tuple(torch.as_tensor(a, device=device) for a in request)
    if args.decode:
        return lambda: sync(predictor(*tensors))

    def forward():
        with torch.inference_mode():
            return sync(predictor.model(*tensors))

    return forward


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if not args.summarize_only:
        device = resolve_device(args.device)
        call = _train_call(args, device) if args.train else _forward_call(args, device)
        call()  # warm-up (cuDNN plans, kernel builds) outside the trace
        path = trace(call, Path(args.out), device)
        print(f"trace written to {path} on {device_line(device)}")
    return summarize(args.out, args.top)


if __name__ == "__main__":
    main(sys.argv[1:])
