"""Stage times of the flagship forward (counterpart of the repo-root
``tools/profile_forward.py``): the stem (the MetaKernel through K1 on a
card), the backbone, the heads and the whole forward at B=1, 64x1808, each
after warm-up, by CUDA events on a card:

    python -m range_view_3d_detection_torch.tools.profile_forward [--iters 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.models.detector import Detector
from range_view_3d_detection_torch.tools import device_line, event_ms
from range_view_3d_detection_torch.training.loop import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=1808)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = serving._flagship_config(tiny=args.tiny)
    feats, cart, mask = (
        torch.as_tensor(a, device=device)
        for a in serving._sample_inputs(args.batch, args.height, args.width, cfg.in_channels)
    )
    model = Detector(cfg, device=device, generator=torch.Generator().manual_seed(0)).eval()
    rangenet = model.RangeNet_0
    nchw = feats.permute(0, 3, 1, 2).to(rangenet.dtype)
    kw = dict(iters=args.iters, device=device)
    out = {}
    with torch.inference_mode():
        stem = rangenet.MetaKernel_0
        out["stem_ms"] = event_ms(stem, nchw, cart, **kw)
        stem_out = stem(nchw, cart)
        out["backbone_ms"] = event_ms(rangenet.RangeBackbone_0, stem_out, **kw)
        ms = rangenet.RangeBackbone_0(stem_out)
        out["heads_ms"] = event_ms(model.DetectionHead_0, ms, **kw)
        out["full_forward_ms"] = event_ms(model, feats, cart, mask, **kw)
    smi = device_line(device)
    for k, v in out.items():
        print(f"{k[:-3]}: {v:.3f} ms on {smi}")
    out = {k: round(v, 4) for k, v in out.items()}
    out.update(batch=args.batch, shape=[args.height, args.width], device=smi)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
