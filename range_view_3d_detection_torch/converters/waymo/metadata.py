"""Aggregate per-log point-count metadata into one metadata/waymo.feather
(the port's copy of ``tools/build_waymo_metadata.py``).

The reference training filter reads a repo-level ``metadata/waymo.feather``
with per-sweep point counts (``prototype/loader.py:350-358``). Our Waymo
converter writes per-log ``metadata.feather`` files; this tool merges them
(the dataset layer reads either form).

Usage:
    python -m range_view_3d_detection_torch.converters.waymo.metadata \\
        --root-dir .../waymo/sensor [--split train] [--out metadata/waymo.feather]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from range_view_3d_detection_torch.utils.feather import read_feather, write_feather


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root-dir", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    root = Path(args.root_dir)
    cols = {"log_id": [], "timestamp_ns": [], "num_pts": []}
    for meta_path in sorted((root / args.split).glob("*/metadata.feather")):
        meta = read_feather(meta_path)
        for k in cols:
            cols[k].append(meta[k])
    if not cols["log_id"]:
        raise SystemExit(f"no per-log metadata under {root / args.split}")
    merged = {k: np.concatenate(v) for k, v in cols.items()}
    out = Path(args.out or (root.parent / "metadata" / "waymo.feather"))
    write_feather(out, merged)
    print(f"wrote {len(merged['log_id'])} rows to {out}")


if __name__ == "__main__":
    main()
