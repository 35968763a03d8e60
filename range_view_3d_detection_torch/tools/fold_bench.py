"""Does folding a narrow backbone stage's width into the batch pay?
(counterpart of the repo-root ``tools/fold_bench.py``).

The folded run cuts the width into ``f`` chunks, each with the stage's
full receptive-field halo (2 columns a 3x3 conv, r = 2 * num_blocks),
runs the same ``ResidualBlock`` weights on the (B f, H, W/f + 2r, C)
folded tensor, crops the halos and stitches the chunks. Before timing,
the stitched output's interior (columns r to W - r) is held against the
unfolded stage's, twice. The timed stage itself: in bf16 within
``BF16_ULPS`` bf16 ulps of its max|output| (on the H100 cuDNN picks its
conv algorithms by shape, so the folded and unfolded runs round
differently), and with ``--int8`` bit for bit (K3 accumulates in int32 and
every later step is per element). The same weights in fp32 (TF32 off):
within 0.05 (max|err|, the JAX tool's gate). The outer-edge error is
printed beside them (the unfolded stage zero-pads at every conv, the
folded one only at its input). Stage geometry: the flagship's
``STAGES`` at batch 2 (``models/backbone.py``); weights in the JAX
package's init scheme from a seed. ``--int8`` quantizes the stage as
``Predictor.quantize`` does (BatchNorm folded, activation scales
calibrated on the input), so its 3x3 convs run K3. Times are CUDA events
around ``--iters`` calls after a warm-up.

    python -m range_view_3d_detection_torch.tools.fold_bench [--stage res3]
        [--folds 1 2 4] [--int8] [--iters 20] [--batch 2] [--height 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch
import torch.nn.functional as F

from range_view_3d_detection_torch.kernels.conv import conv3x3_i8_fused
from range_view_3d_detection_torch.models.blocks import ResidualBlock
from range_view_3d_detection_torch.models.detector import init_weights
from range_view_3d_detection_torch.models.quantized import (
    calibrate_module,
    fold_batch_norms,
    quantize_model,
)
from range_view_3d_detection_torch.tools import device_line, event_ms
from range_view_3d_detection_torch.training.loop import resolve_device

STAGES = {
    # name: (H, W, C_in, C_out, num_blocks) at flagship batch 2
    "res3": (64, 113, 256, 512, 5),
    "res3a": (64, 226, 128, 256, 5),
    "res2": (64, 452, 64, 128, 3),
}
INTERIOR_TOL = 0.05  # the fp32 stage's gate, the JAX tool's
BF16_ULPS = 4  # the bf16 stage's gate, in ulps of its max|output|


def _fold(x: torch.Tensor, f: int, r: int) -> torch.Tensor:
    """(B, H, W, C) -> (B f, H, ceil(W / f) + 2r, C) overlapping chunks,
    zero edge halos; a W that f does not divide is right-padded with
    zeros, whose outputs ``_unfold`` crops."""
    b, h, w, c = x.shape
    wc = -(-w // f)
    xp = F.pad(x, (0, 0, r, r + wc * f - w))
    return torch.cat([xp[:, :, i * wc : i * wc + wc + 2 * r] for i in range(f)], dim=0)


def _unfold(y: torch.Tensor, f: int, r: int, w: int) -> torch.Tensor:
    """The chunks' cores put back side by side: (B, H, W, C)."""
    b = y.shape[0] // f
    core = y[:, :, r : y.shape[2] - r]
    return torch.cat([core[i * b : (i + 1) * b] for i in range(f)], dim=2)[:, :, :w]


def build_stage(name: str, batch: int, height: int, int8: bool, device: torch.device,
                seed: int = 0):
    """The stage's module (bf16, or int8 with ``int8``), the same weights
    in an fp32 module, and its (B, H, W, C_in) bf16 input."""
    h, w, cin, cout, nb = STAGES[name]
    h = height or h
    gen = torch.Generator().manual_seed(seed)
    stage = ResidualBlock(cin, cout, nb, strides=(1, 1), dtype=torch.bfloat16)
    with torch.no_grad():
        init_weights(stage, gen)
    fp32 = ResidualBlock(cin, cout, nb, strides=(1, 1), dtype=torch.float32)
    fp32.load_state_dict(stage.state_dict())
    stage, fp32 = stage.to(device).eval(), fp32.to(device).eval()
    x = torch.randn((batch, h, w, cin), generator=gen).to(device, torch.bfloat16)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    if int8:
        fold_batch_norms(stage)
        with torch.inference_mode():
            tree = calibrate_module(stage, lambda: (stage(nchw(x)), 1)[1])
        quantize_model(stage, tree)
    return stage, fp32, x


def fold_errors(module, x: torch.Tensor, f: int, r: int, w: int) -> tuple:
    """(interior, outer-edge) max|err| of ``module`` folded f ways against
    it unfolded, on NHWC ``x``, and the unfolded output's max|.|."""
    def run(xin):
        return module(xin.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()

    ref = run(x)
    got = _unfold(run(_fold(x, f, r)), f, r, w)
    interior = slice(r, w - r)
    return (float((got[:, :, interior] - ref[:, :, interior]).abs().max()),
            float((got - ref).abs().max()), float(ref.abs().max()))


def interior_tol(ref_max: float, int8: bool) -> float:
    """The timed stage's gate: 0 for the int8 stage, else ``BF16_ULPS``
    bf16 ulps at ``ref_max`` (an ulp of 2**e is 2**(e - 7))."""
    if int8:
        return 0.0
    return BF16_ULPS * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0**-126))) - 7)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", default="res3", choices=sorted(STAGES))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--height", type=int, default=0, help="rows (0: the stage's)")
    ap.add_argument("--folds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    smi = device_line(device)
    h, w, cin, cout, nb = STAGES[args.stage]
    r = 2 * nb  # receptive radius: two 3x3 convs a BasicBlock
    stage, fp32, x = build_stage(args.stage, args.batch, args.height, args.int8, device)

    def run(xin):
        return stage(xin.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    print(f"stage={args.stage} {tuple(x.shape[:3])} {cin}->{cout} blocks={nb} halo r={r} "
          f"int8={args.int8} on {smi}")
    conv3x3_i8_fused.launches = 0
    rows = []
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    with torch.inference_mode():
        for f in args.folds:
            row = dict(fold=f)
            if f == 1:
                row["ms"] = event_ms(run, x, iters=args.iters, device=device)
                print(f"  fold 1 (baseline): {row['ms']:8.3f} ms", flush=True)
            else:
                err, edge, ref_max = fold_errors(stage, x, f, r, w)
                tol = interior_tol(ref_max, args.int8)
                if not err <= tol:
                    raise AssertionError(f"fold {f} interior mismatch: {err} > {tol}")
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
                try:
                    gate = fold_errors(fp32, x.float(), f, r, w)[0]
                finally:
                    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
                if not gate < INTERIOR_TOL:
                    raise AssertionError(f"fold {f} interior mismatch (fp32): {gate}")

                def folded(xin, f=f):
                    return _unfold(run(_fold(xin, f, r)), f, r, w)

                row.update(ms=event_ms(folded, x, iters=args.iters, device=device),
                           fp32_interior_err=gate, interior_err=err, interior_tol=tol, edge_err=edge,
                           halo_waste=(-(-w // f) + 2 * r) * f / w - 1)
                print(f"  fold {f}: {row['ms']:8.3f} ms  (+{row['halo_waste']:.0%} halo "
                      f"compute, interior max|err| {err:.3g} <= {tol:.3g} (fp32 {gate:.3g}), outer-edge "
                      f"{edge:.3g})", flush=True)
            rows.append(row)
    base = next((row["ms"] for row in rows if row["fold"] == 1), None)
    out = {"tool": "fold_bench", "stage": args.stage, "int8": args.int8,
           "shape": list(x.shape), "rows": rows,
           "speedup": {row["fold"]: base / row["ms"] for row in rows} if base else {},
           "launches": {"conv3x3_i8_fused": conv3x3_i8_fused.launches}, "device": smi}
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
