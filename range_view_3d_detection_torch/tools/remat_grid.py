"""Remat scope over the flagship train step (counterpart of the repo-root
``tools/remat_grid.py``): ms a step for each subset of
``DetectorConfig.remat_scope`` at batch 2, host walls that end in a
readback:

    python -m range_view_3d_detection_torch.tools.remat_grid [--batch 2] [--iters 12] [--device cpu]

A scope whose step does not fit on the card reports "infeasible": that row
is the tool's result (``torch.cuda.OutOfMemoryError`` only; its memory is
released before the next scope). Any other error raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import torch

from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.tools import device_line, sync
from range_view_3d_detection_torch.tools.profile_train import make_batch, num_categories
from range_view_3d_detection_torch.training.loop import resolve_device

SCOPES = (
    None,  # remat off
    ("stem", "stages", "heads", "loss"),  # all
    ("stem", "heads", "loss"),
    ("stem", "loss"),
    ("stem", "heads"),
    ("heads", "loss"),
    ("stem",),
    ("loss",),
)


def scope_name(scope) -> str:
    return "off" if scope is None else "+".join(scope)


def measure(scope, batch, B, iters, device="cuda", tiny: bool = False) -> float:
    """ms a step of the flagship at ``scope`` on ``batch`` (B rows): one
    step, two warm-up steps, then ``iters`` timed with one readback."""
    from range_view_3d_detection_torch.training import optim
    from range_view_3d_detection_torch.training import state as state_lib

    cfg = dataclasses.replace(serving._flagship_config(tiny=tiny), max_boxes=64,
                              remat=scope is not None, remat_scope=scope or ())
    device = torch.device(device)
    st = state_lib.create_state(cfg, optim.make_optimizer(1e-3, 100)[0], device=device,
                                generator=torch.Generator().manual_seed(0))
    step = state_lib.make_train_step(cfg)
    batch = state_lib.batch_to_device(batch, device)
    for _ in range(3):
        st, m = step(st, batch)
    sync(m["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        st, m = step(st, batch)
    sync(m["loss"])
    return (time.perf_counter() - t0) / iters * 1e3


def grid(scopes, B: int, iters: int, device, *, height=64, width=1808, tiny=False) -> list:
    """One row a scope: ``{"scope", "ms_per_step", "frames_per_sec"}`` or
    ``{"scope", "infeasible": message}``."""
    device = torch.device(device)
    batch = make_batch(B, height, width, 5, 64,
                       categories=num_categories(serving._flagship_config(tiny=tiny)))
    smi = device_line(device)
    rows = []
    for scope in scopes:
        name = scope_name(scope)
        try:
            ms = measure(scope, batch, B, iters, device, tiny)
            rows.append({"scope": name, "ms_per_step": round(ms, 3),
                         "frames_per_sec": round(B / ms * 1e3, 3)})
            print(f"  remat[{name:>24s}]  {ms:9.3f} ms/step ({B / ms * 1e3:.2f} fr/s) "
                  f"on {smi}", flush=True)
        except torch.cuda.OutOfMemoryError as e:
            msg = str(e).splitlines()[0][:90]
            rows.append({"scope": name, "infeasible": msg})
            print(f"  remat[{name:>24s}]  INFEASIBLE: {msg}", flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=1808)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(f"flagship train step, batch {args.batch} ({args.height}x{args.width}), "
          f"{args.iters} iters")
    rows = grid(SCOPES, args.batch, args.iters, device, height=args.height,
                width=args.width, tiny=args.tiny)
    print(json.dumps({"rows": rows, "device": device_line(device)}))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
