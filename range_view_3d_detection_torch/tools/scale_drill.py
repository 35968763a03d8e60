"""End-to-end scale drill (counterpart of the repo-root
``tools/scale_drill.py``): a generated val corpus through the loader,
device predict, shard writes and both evaluation protocols, with a wall
for each stage:

    python -m range_view_3d_detection_torch.tools.scale_drill --sweeps 1000 [--logs 10] \\
        [--dense] [--eval-workers N] [--device cpu] [--work DIR] [--out FILE]

Weights are random (seeded): detection quality is irrelevant to the walls.
``--dense`` sets ``min_confidence`` 0 and a post-NMS cap of 200 a sweep, so
the evaluators get a realistic load. Prints one line a stage and appends
one JSON line to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from range_view_3d_detection_torch.tools import device_line
from range_view_3d_detection_torch.training.loop import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweeps", type=int, default=1000)
    ap.add_argument("--logs", type=int, default=10)
    ap.add_argument("--eval-workers", type=int, default=0)
    ap.add_argument("--dense", action="store_true",
                    help="min_confidence 0 and 200 detections a sweep after NMS")
    ap.add_argument("--device", default="cuda")
    work_default = Path(tempfile.gettempdir()) / "scale_drill"
    ap.add_argument("--work", default=str(work_default))
    ap.add_argument("--out", default=None, help="default: WORK/walls.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from range_view_3d_detection_torch.data.dataset import DataLoader, RangeViewDataset
    from range_view_3d_detection_torch.data.synthetic import generate_dataset
    from range_view_3d_detection_torch.evaluation.av2_eval import (
        evaluate_predictions,
        load_ground_truth,
        load_predictions,
    )
    from range_view_3d_detection_torch.evaluation.waymo_eval import evaluate_waymo, mean_ap
    from range_view_3d_detection_torch.serving import Predictor
    from range_view_3d_detection_torch.train import CONF_DIR
    from range_view_3d_detection_torch.training.builders import (
        build_dataset_config,
        build_decoder_config,
        build_detector_config,
    )
    from range_view_3d_detection_torch.training.loop import write_prediction_shards
    from range_view_3d_detection_torch.utils.config import compose

    work = Path(args.work)
    walls = {}

    class stage:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            walls[self.name] = round(time.perf_counter() - self.t0, 3)
            print(f"{self.name:28s} {walls[self.name]:9.3f} s", flush=True)

    per_log = max(1, args.sweeps // args.logs)
    with stage("generate corpus"):
        root = generate_dataset(work / "sensor", splits={"val": args.logs},
                                sweeps_per_log=per_log, height=32, width=248, num_boxes=8,
                                num_bg_points=4000, seed=0)
    cfg = compose(CONF_DIR, "rv-synthetic",
                  [f"dataset.root_dir={root}", f"run_dir={work}/run"])
    ds = RangeViewDataset(build_dataset_config(cfg, "val"))
    n = len(ds)
    print(f"corpus: {n} sweeps", flush=True)

    with stage("loader pass (no device)"):
        frames = sum(len(b["uuids"]) for b in DataLoader(ds, 2, shuffle=False, drop_last=False))
    walls["loader_frames"] = frames
    walls["loader_frames_per_s"] = round(frames / walls["loader pass (no device)"], 1)

    det_cfg = build_detector_config(cfg)
    dec_cfg = build_decoder_config(cfg)
    if args.dense:
        dec_cfg = dataclasses.replace(dec_cfg, min_confidence=0.0, num_post_nms=200)
    predict = Predictor(det_cfg, dec_cfg, device=device,
                        generator=torch.Generator().manual_seed(0))
    categories = []
    for _, cats in sorted(det_cfg.tasks, key=lambda kv: kv[0]):
        categories.extend(sorted(cats))
    b0 = next(iter(DataLoader(ds, 2, shuffle=False, drop_last=False)))
    predict(b0["features"], b0["cart"], b0["mask"])  # warm-up

    pred_dir = work / "predictions"
    pred_dir.mkdir(parents=True, exist_ok=True)
    t_pred = t_host = 0.0
    with stage("predict + shard writes"):
        for batch in DataLoader(ds, 2, shuffle=False, drop_last=False):
            t0 = time.perf_counter()
            result = predict(batch["features"], batch["cart"], batch["mask"])
            keep = result.keep.cpu()  # the readback ends the device's work
            t_pred += time.perf_counter() - t0
            t0 = time.perf_counter()
            write_prediction_shards(result._replace(keep=keep), batch["uuids"], categories,
                                    pred_dir)
            t_host += time.perf_counter() - t0
    walls["predict (device, s)"] = round(t_pred, 3)
    walls["flatten + shard writes (s)"] = round(t_host, 3)
    walls["predict_frames_per_s"] = round(frames / walls["predict + shard writes"], 1)

    with stage("AV2 protocol eval"):
        res = evaluate_predictions(pred_dir, root / "val", categories=categories)
    walls["av2_mAP"] = round(float(res["AVERAGE_METRICS"]["AP"]), 4)

    with stage("load frames for WOD"):
        dts = load_predictions(pred_dir)
        gts = load_ground_truth(root / "val")
    print(f"dets={len(dts['score'])} gts={len(gts['tx_m'])}", flush=True)
    with stage(f"WOD protocol eval (w={args.eval_workers})"):
        wod = evaluate_waymo(dts, gts, categories, workers=args.eval_workers)
    walls["wod_mAP_L2"] = round(float(mean_ap(wod, level=2)), 4)
    walls["wod_mAPH_L2"] = round(float(mean_ap(wod, level=2, metric="APH")), 4)
    walls["num_dets"] = int(len(dts["score"]))
    walls["num_gts"] = int(len(gts["tx_m"]))
    walls["sweeps"] = n
    walls["device"] = device_line(device)

    out = Path(args.out) if args.out else work / "walls.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(walls) + "\n")
    print(json.dumps(walls), flush=True)
    return walls


if __name__ == "__main__":
    main(sys.argv[1:])
