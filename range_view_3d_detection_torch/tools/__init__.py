"""The port's measurement tools (counterparts of the repo-root ``tools/``
scripts), each runnable as ``python -m range_view_3d_detection_torch.tools.
<name>``, and the helpers they share.

Every tool runs on ``--device`` (``cuda`` unless the caller asks for the
CPU; a host without a card raises) and names the device beside its numbers:
a time taken on the CPU is the CPU's.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

from range_view_3d_detection_torch.export import _sync as sync


def device_line(device: str | torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``"cpu"``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    index = device.index or 0
    return out[index] if index < len(out) else out[0]


def wall_s(fn: Callable, *args, iters: int = 20, warmup: int = 5) -> float:
    """Seconds a call of ``fn(*args)``: ``warmup`` calls each read back,
    then ``iters`` back to back and one readback (a host wall)."""
    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / iters


def event_ms(fn: Callable, *args, iters: int = 8, warmup: int = 2,
             device: str | torch.device = "cuda") -> float:
    """Milliseconds a call of ``fn(*args)`` after ``warmup`` calls: CUDA
    events around ``iters`` calls on a card, a synchronised host wall on the
    CPU."""
    for _ in range(warmup):
        fn(*args)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        sync(fn(*args))
    return (time.perf_counter() - t0) * 1e3 / iters
