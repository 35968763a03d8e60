"""K2 against the plain scan at the caps users set (counterpart of the
repo-root ``tools/validate_nms_tpu.py``).

For each cap, the proposals of ``random_boxes`` (the JAX tool's numpy
draws, seeded by the cap) go through the port's NMS inputs (top-``cap``
selection, class offsets, the rotated-IoU matrix, in row blocks past cap
4096), then through K2 (``kernels/nms.py::nms_scan``) and through the
plain scan on the same IoU matrix. Printed per cap: the boxes kept,
whether ``keep`` is equal, ``merged``'s max difference (gated at 1e-4)
and K2's ms (CUDA events, eager) beside the whole NMS's. Exits non-zero
on a mismatch.

    python -m range_view_3d_detection_torch.tools.validate_nms [--caps 1024,2048,4096]
        [--n 9216] [--mode WEIGHTED|HARD] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from range_view_3d_detection_torch.kernels.nms import nms_scan, nms_scan_plain
from range_view_3d_detection_torch.ops.nms import batched_multiclass_nms, nms_inputs
from range_view_3d_detection_torch.tools import device_line, event_ms
from range_view_3d_detection_torch.training.loop import resolve_device

MERGED_TOL = 1e-4


def random_boxes(n: int, seed: int, spread: float, num_classes: int = 26):
    """The JAX tool's proposals: boxes (n, 7), scores (n,), categories (n,)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-spread, spread, (n, 2))
    z = rng.uniform(-1, 1, (n, 1))
    lw = rng.uniform(1.0, 6.0, (n, 2))
    h = rng.uniform(1.0, 2.5, (n, 1))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    boxes = np.concatenate([xy, z, lw, h, yaw], axis=-1).astype(np.float32)
    scores = rng.uniform(0.0, 1.0, n).astype(np.float32)
    cats = rng.integers(0, num_classes, n).astype(np.int32)
    return boxes, scores, cats


def validate(cap: int, n: int, mode: str, device: torch.device) -> dict:
    """K2 against the plain scan at one cap; the numbers of one line."""
    boxes, scores, cats = (torch.as_tensor(a, device=device)[None]
                           for a in random_boxes(n, seed=cap, spread=60.0))
    kw = dict(cap=cap, min_confidence=0.1, mode=mode)
    inputs = nms_inputs(boxes, scores, cats, **kw)
    scan = (inputs.iou, inputs.scores, inputs.valid, inputs.payload)
    thr = dict(iou_threshold=0.3, merge_threshold=inputs.merge_threshold)
    keep, merged = nms_scan(*scan, **thr)
    keep_p, merged_p = nms_scan_plain(*scan, **thr)
    same = bool(torch.equal(keep, keep_p))
    err = float((merged - merged_p).abs().max())
    out = dict(cap=cap, n=n, mode=mode, slots=int(inputs.scores.shape[1]),
               kept=int(keep.sum()), keep_equal=same, merged_max_diff=err,
               ok=same and err <= MERGED_TOL)
    out["k2_ms"] = event_ms(lambda: nms_scan(*scan, **thr), iters=5, device=device)
    out["nms_ms"] = event_ms(lambda: batched_multiclass_nms(boxes, scores, cats, **kw),
                             iters=1, warmup=1, device=device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--caps", default="1024,2048,4096")
    ap.add_argument("--n", type=int, default=9216)
    ap.add_argument("--mode", default="WEIGHTED", choices=("WEIGHTED", "HARD"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    smi = device_line(device)
    nms_scan.launches = 0
    rows = []
    for cap in (int(c) for c in args.caps.split(",")):
        r = validate(cap, args.n, args.mode, device)
        rows.append(r)
        print(f"cap={cap:5d} {args.mode} keep={r['kept']:5d} keep_equal={r['keep_equal']} "
              f"merged max|diff|={r['merged_max_diff']:.3g} K2 {r['k2_ms']:.4f} ms, "
              f"NMS {r['nms_ms']:.3f} ms on {smi} -> {'OK' if r['ok'] else 'MISMATCH'}",
              flush=True)
    ok = all(r["ok"] for r in rows)
    print("PASS" if ok else "FAIL")
    print(json.dumps({"tool": "validate_nms", "ok": ok, "rows": rows,
                      "launches": {"nms_scan": nms_scan.launches}, "device": smi}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
