"""Train-step throughput on the flagship (counterpart of the repo-root
``tools/profile_train.py``): ms a step and frames/s of the full train step
(targets, forward, loss, backward, AdamW), with and without remat:

    python -m range_view_3d_detection_torch.tools.profile_train \\
        [--batches 1,2,4] [--remat 0,1] [--iters 8] [--device cpu]

At each remat setting the batches run in order until one does not fit
(``torch.cuda.OutOfMemoryError``, reported as such); any other error
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.tools import device_line, sync
from range_view_3d_detection_torch.training.loop import resolve_device


def make_batch(B, H, W, C, K, seed=0, categories=26):
    """``serving._sample_inputs`` with 24 random boxes an image, each
    centred on a pixel's return, in ``K`` slots, of ``categories`` classes
    (numpy)."""
    feats, cart, mask = serving._sample_inputs(B, H, W, C, seed=seed)
    rng = np.random.default_rng(seed)
    boxes = np.zeros((B, K, 7), np.float32)
    valid = np.zeros((B, K), bool)
    for b in range(B):
        for k in range(min(24, K)):
            y, x = rng.integers(0, H), rng.integers(0, W)
            boxes[b, k, :3] = cart[b, y, x]
            boxes[b, k, 3:6] = rng.uniform(2, 8, 3)
            boxes[b, k, 6] = rng.uniform(-np.pi, np.pi)
            valid[b, k] = True
    return {
        "features": feats,
        "cart": cart,
        "mask": mask,
        "boxes": boxes,
        "box_valid": valid,
        "box_task": np.zeros((B, K), np.int32),
        "box_offset": rng.integers(0, categories, (B, K)).astype(np.int32),
    }


def num_categories(cfg) -> int:
    return sum(len(cats) for _, cats in cfg.tasks)


def measure(cfg, batch, device, *, iters: int = 8, chunk: int = 4) -> float:
    """ms a step after one warm-up step: ``iters`` steps, a readback of
    the loss every ``chunk``."""
    from range_view_3d_detection_torch.training import optim
    from range_view_3d_detection_torch.training import state as state_lib

    st = state_lib.create_state(cfg, optim.make_optimizer(1e-3, 100)[0], device=device,
                                generator=torch.Generator().manual_seed(0))
    step = state_lib.make_train_step(cfg)
    batch = state_lib.batch_to_device(batch, device)
    st, m = step(st, batch)
    sync(m["loss"])
    t0 = time.perf_counter()
    for i in range(iters):
        st, m = step(st, batch)
        if (i + 1) % chunk == 0:
            sync(m["loss"])
    sync(m["loss"])
    return (time.perf_counter() - t0) / iters * 1e3


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="1,2,4")
    ap.add_argument("--remat", default="0,1")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=1808)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    smi = device_line(device)
    K = 64
    rows = []
    for remat in (bool(int(r)) for r in args.remat.split(",")):
        for B in (int(b) for b in args.batches.split(",")):
            cfg = dataclasses.replace(serving._flagship_config(),
                                      max_boxes=K, remat=remat)
            batch = make_batch(B, args.height, args.width, 5, K, categories=num_categories(cfg))
            row = {"remat": remat, "batch": B}
            try:
                ms = measure(cfg, batch, device, iters=args.iters)
                row.update(ms_per_step=round(ms, 3), frames_per_sec=round(B / ms * 1e3, 3))
                print(f"remat={remat} B={B}: {ms:.1f} ms/step -> {B / ms * 1e3:.2f} frames/s "
                      f"on {smi}", flush=True)
            except torch.cuda.OutOfMemoryError:
                row["oom"] = True
                print(f"remat={remat} B={B}: out of device memory on {smi}", flush=True)
            rows.append(row)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            if row.get("oom"):
                break
    print(json.dumps({"rows": rows, "device": smi}))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
