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

    python3 chip_scaling.py width [N]

serves one request split by width over 1, 2 and 4 cards (those of them up
to N, and N): the flagship config with ``chip_smoke.py`` phase 5's seeded
weights, exported as a bf16 artifact, a B=1 64x1792 request (1792 = 16 x
112; AV2's padded 1808 = 16 x 113 shards only one way),
``export.load_artifact_width_sharded`` with a zero-padded seam in every
rank of ``python -m torch.distributed.run`` (``chip_smoke.py
width-rank``, TF32 off), in bf16 and in an fp32 twin of the same
weights. Prints each rank's report and one JSON line: for each dtype and
card count the p50/p90 ms a request (host wall through a
synchronisation, the largest over the ranks), the halo exchanges a
request and their device ms, every NCCL kernel's device ms (both include
the wait for the neighbour), the heads' relative RMS and the kept-box
agreement against the 1-card sharded run (the exchange's exactness: the
fp32 heads must agree within 1e-4, bf16 roundings differ with the shard
width), whether the detections equal it bit for bit, and in bf16 the
kept-box agreement with the 1-card unsharded ``load_artifact`` predict
(whose stem is K1, where the sharded stem takes the accumulate path).
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


def width_main(n: int, smi) -> int:
    """``chip_scaling.py width [N]`` (see the module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.export import export_artifact, load_artifact
    from range_view_3d_detection_torch.models.decoder import DecoderConfig

    work = Path(tempfile.mkdtemp(prefix="chip-scaling-width-"))
    out = {}
    try:
        device = torch.device("cuda", 0)
        cfg, dec = serving._flagship_config(), DecoderConfig()
        request = serving._sample_inputs(1, 64, cs.WIDTH_W, 5, seed=cs.SEED + 25)
        predictor = cs.flagship_predictor(cfg, dec, device, torch.Generator().manual_seed(
            cs.SEED), serving._sample_inputs(2, 64, 1808, 5, seed=0))
        for dtype in DTYPES:
            export_artifact(predictor.model, dataclasses.replace(cfg, dtype=dtype), dec,
                            work / dtype, dataset_meta=cs.av2_dataset_meta())
        del predictor
        plain, _, _ = load_artifact(work / "bfloat16", device=device)
        unsharded = cs.host(plain(*request))
        del plain
        torch.cuda.empty_cache()
        np.savez(work / "request.npz", *request)
        for dtype in DTYPES:
            runs = {}
            for k in sorted({c for c in (1, 2, 4) if c <= n} | {n}):
                ranks = cs.launch_width_ranks(k, work / dtype, work / "request.npz", work)
                saved = torch.load(work / f"width_result_{k}.pt")
                runs[k] = ({
                    "p50_ms": max(r["p50_ms"] for r in ranks),
                    "p90_ms": max(r["p90_ms"] for r in ranks),
                    "exchanges": ranks[0]["exchanges"],
                    "halo_ms": max(r["halo_ms"] for r in ranks),
                    "nccl_ms": max(r["nccl_ms"] for r in ranks),
                    "kept": ranks[0]["kept"],
                }, type(unsharded)(*saved["result"]), saved["heads"])
            one, one_heads = runs[1][1], runs[1][2]
            out[dtype] = {}
            for k, (rec, result, heads) in runs.items():
                rec["heads_rms_vs_one_card"] = {
                    h: cs.rel_rms(heads[h], one_heads[h]) for h in ("logits", "regressands")}
                rec["kept_vs_one_card"] = cs.kept_match([result], [one])
                rec["equal_to_one_card"] = all(torch.equal(a, b) for a, b in zip(result, one))
                if dtype == "bfloat16":
                    rec["kept_vs_unsharded"] = cs.kept_match([result], [unsharded])
                out[dtype][k] = rec
        # In fp32 (TF32 off) the sharded network is the one-card network up
        # to the order of sums.
        worst = max(max(r["heads_rms_vs_one_card"].values()) for r in out["float32"].values())
        cs.check(worst <= 1e-4, f"fp32 width-sharded heads relative RMS {worst} against 1 card")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.say("nvidia-smi: " + " | ".join(smi))
    cs.say(json.dumps({"width": {d: {str(k): v for k, v in r.items()} for d, r in out.items()},
                       "cards": n, "request": f"B=1 64x{cs.WIDTH_W}"}))
    return 0


# The served bf16 model, and its fp32 twin for exactness across card counts.
DTYPES = ("bfloat16", "float32")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_scaling: needs two or more CUDA devices", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    width = argv[:1] == ["width"]
    argv = argv[1:] if width else argv
    from range_view_3d_detection_torch.utils.config import compose

    n = int(argv[0]) if argv else torch.cuda.device_count()
    cs.check(2 <= n <= torch.cuda.device_count(), f"N = {n} of {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if width:
        return width_main(n, smi)
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
