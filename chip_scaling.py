#!/usr/bin/env python3
"""Weak scaling of the port's data-parallel training over the cards of
one machine:

    python3 chip_scaling.py [N]

Writes ``chip_smoke.py`` phase 17's AV2-layout corpus with 16 x N train
sweeps, then runs the port's train entry point under ``python -m
torch.distributed.run`` exactly as phase 23 does (rv-av2, B=4 a card,
remat, ZeRO-1, one epoch, every rank ``chip_smoke.py train-rank``) on 1
card and on N (default: every card of the machine), so that each rank
of the N-card run takes 4 steps and the 1-card run 4 x N. Prints every
rank's report, the card's name and power limit, and one JSON line: for
each world size the median ms a step (every step but the first and the
profiled one, over every rank), the SyncBN and NCCL device ms of the
profiled step and peak GiB (the largest over the ranks), and the
weak-scaling efficiency, ms(1) / ms(N). Needs at least two cards.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_scaling: needs two or more CUDA devices", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from range_view_3d_detection_torch.utils.config import compose

    n = int(argv[0]) if argv else torch.cuda.device_count()
    cs.check(2 <= n <= torch.cuda.device_count(), f"N = {n} of {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    work = Path(tempfile.mkdtemp(prefix="chip-scaling-"))
    try:
        categories = compose(REPO / "conf", "rv-av2")["model"]["tasks"][0]
        cs.write_av2_corpus(work / "sensor", 16 * n, categories)
        out = {}
        for k in (1, n):
            ranks, wall_s = cs.launch_ranks(k, work / "sensor", work / f"run-{k}")
            out[k] = {
                "steps": ranks[0]["steps"],
                "step_ms": statistics.median(x for r in ranks for x in r["step_ms"][1:]),
                "syncbn_ms": max(r["syncbn_ms"] for r in ranks),
                "nccl_ms": max(r["nccl_ms"] for r in ranks),
                "peak_gb": max(r["peak_gb"] for r in ranks),
                "launcher_s": wall_s,
            }
        out["efficiency"] = out[1]["step_ms"] / out[n]["step_ms"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.say("nvidia-smi: " + " | ".join(smi))
    cs.say(json.dumps({"world": {str(k): v for k, v in out.items() if k != "efficiency"},
                       "efficiency": out["efficiency"], "cards": n}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
