"""K3 against the library's lowering of the same int8 conv, per shape
(counterpart of the repo-root ``tools/conv_ab.py``).

Three paths compute a 3x3 'same' conv of an int8 NHWC input with int8
(9, Cin, Cout) weights, int32 accumulation and a per-channel fp32
dequantization to bf16:

- A: K3 (``kernels/conv.py::conv3x3_i8_fused``);
- B: the library's lowering: im2col of the int8 input, one
  ``torch._int_mm`` (int32 accumulation), then ``acc.float() * dq``.
  ``F.unfold`` has no int8 kernel, so the im2col is the nine strided
  slices of the zero-padded int8 input, concatenated;
- C, for reference: cuDNN's bf16 ``F.conv2d`` at the same shape (the same
  integers as bf16 operands; another function, not compared).

Before timing, A == B bit for bit at every shape. Then the paths run in
turns, rep by rep (A B C A B C ...), each rep a chain of ``--chain``
convs with the JAX tool's re-quantize step between them
(``clip(round(out * 0.05), +-127)`` feeds the next conv where the output
can be its input: stride 1 and Cin == Cout; other shapes run one conv a
rep). Printed: each shape's median ms a conv of A, B and C (CUDA events
around a rep), B / A, and over one flagship int8 request (every K3 launch
counted) the sums of each path.

Shapes: the JAX tool's five stride-1 ``SHAPES``, then every distinct K3
shape of one flagship int8 request (``Predictor.quantize`` on the
flagship, one request with K3's launches recorded); ``--tiny`` takes the
tiny config's request alone (a size for the CPU).

    python -m range_view_3d_detection_torch.tools.conv_ab [--reps 5] [--chain 8]
        [--tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.kernels.conv import conv3x3_i8_fused
from range_view_3d_detection_torch.models.decoder import DecoderConfig
from range_view_3d_detection_torch.tools import device_line, sync
from range_view_3d_detection_torch.training.loop import resolve_device

# (B, H, W, Cin, Cout, stride_w): the JAX tool's stride-1 population.
SHAPES = [
    (2, 64, 1808, 64, 64, 1),
    (2, 64, 904, 64, 64, 1),
    (2, 64, 452, 128, 128, 1),
    (2, 64, 226, 256, 256, 1),
    (2, 64, 113, 256, 256, 1),
]

Shape = Tuple[int, int, int, int, int, int]


def im2col_int_mm(x_i8: torch.Tensor, w_i8: torch.Tensor, dq: torch.Tensor, stride_w: int,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """B: int8 im2col, ``torch._int_mm``, fp32 dequantization.

    ``x_i8`` (B, H, W, Cin) int8, ``w_i8`` (9, Cin, Cout) int8 (dy-major
    taps); returns (B, H, Wo, Cout) ``out_dtype``."""
    B, H, W, Cin = x_i8.shape
    Cout = w_i8.shape[-1]
    Wo = (W - 1) // stride_w + 1
    xp = F.pad(x_i8, (0, 0, 1, 1, 1, 1))
    # Columns (dy, dx, c): the order of the weights' (9, Cin) rows.
    a = torch.cat([xp[:, dy:dy + H, dx:dx + stride_w * (Wo - 1) + 1:stride_w]
                   for dy in range(3) for dx in range(3)], dim=-1)
    acc = torch._int_mm(a.reshape(B * H * Wo, 9 * Cin), w_i8.reshape(9 * Cin, Cout))
    return (acc.float() * dq).to(out_dtype).reshape(B, H, Wo, Cout)


def cudnn_bf16(x: torch.Tensor, w_oihw: torch.Tensor, stride_w: int) -> torch.Tensor:
    """C: the bf16 conv at the same shape (NHWC in and out)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1, stride=(1, stride_w))
    return y.permute(0, 2, 3, 1)


def requantize(out: torch.Tensor) -> torch.Tensor:
    """The JAX tool's step between chained convs."""
    return torch.clamp(torch.round(out.float() * 0.05), -127, 127).to(torch.int8)


def request_shapes(device: torch.device, *, tiny: bool = False) -> Dict[Shape, int]:
    """Every distinct K3 shape of one int8 request and its launches: the
    flagship (or tiny) predictor, quantized as the bench's serving point
    (``Predictor.quantize`` calibrated on the request), one request with
    K3's calls recorded."""
    from range_view_3d_detection_torch.models import blocks, quantized

    cfg = serving._flagship_config(tiny=tiny)
    request = serving._sample_inputs(2, 64, 1808, cfg.in_channels)
    predictor = serving.Predictor(cfg, DecoderConfig(), device=device,
                                  generator=torch.Generator().manual_seed(0))
    predictor.quantize([request], scope="full")
    shapes: Dict[Shape, int] = {}

    def recording(x, w, dq, *, stride_w=1, **kw):
        key = (*x.shape, w.shape[-1], stride_w)
        shapes[key] = shapes.get(key, 0) + 1
        return conv3x3_i8_fused(x, w, dq, stride_w=stride_w, **kw)

    blocks.conv3x3_i8_fused = quantized.conv3x3_i8_fused = recording
    try:
        predictor(*request)
    finally:
        blocks.conv3x3_i8_fused = quantized.conv3x3_i8_fused = conv3x3_i8_fused
    return shapes


def _timer(device: torch.device) -> Callable[[Callable], float]:
    """Milliseconds of one call: CUDA events on a card, a synchronised
    host wall on the CPU."""
    def timed(fn: Callable) -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        sync(fn())
        return (time.perf_counter() - t0) * 1e3
    return timed


def ab_shape(shape: Shape, *, reps: int, chain: int, device: torch.device,
             gen: torch.Generator) -> dict:
    """A, B and C at one shape: bit equality of A and B, then the medians
    of ms a conv over ``reps`` interleaved reps."""
    B, H, W, Cin, Cout, sw = shape
    x = torch.randint(-127, 128, (B, H, W, Cin), generator=gen, dtype=torch.int8).to(device)
    w = torch.randint(-127, 128, (9, Cin, Cout), generator=gen, dtype=torch.int8).to(device)
    dq = (torch.rand(Cout, generator=gen) * 1.9e-2 + 1e-3).to(device)
    w_oihw = w.reshape(3, 3, Cin, Cout).permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
    a = conv3x3_i8_fused(x, w, dq, stride_w=sw)
    b = im2col_int_mm(x, w, dq, sw)
    sync(a)
    equal = bool(torch.equal(a, b))
    if not equal:
        raise AssertionError(f"conv_ab {shape}: A (K3) and B (im2col + _int_mm) differ in "
                             f"{int((a != b).sum())} elements")
    feeds = sw == 1 and Cin == Cout
    n = chain if feeds else 1

    def run(step, x0):
        total, xin = None, x0
        for _ in range(n):
            out = step(xin)
            s = out.float().sum()
            total = s if total is None else total + s
            if feeds:
                q = requantize(out)
                xin = q if x0.dtype == torch.int8 else q.to(x0.dtype)
        return total

    paths = {
        "A": lambda: run(lambda t: conv3x3_i8_fused(t, w, dq, stride_w=sw), x),
        "B": lambda: run(lambda t: im2col_int_mm(t, w, dq, sw), x),
        "C": lambda: run(lambda t: cudnn_bf16(t, w_oihw, sw), x.to(torch.bfloat16)),
    }
    timed = _timer(device)
    for fn in paths.values():  # warm-up (cuDNN plans, the kernel's build)
        sync(fn())
    times: Dict[str, List[float]] = {k: [] for k in paths}
    for _ in range(reps):
        for k, fn in paths.items():
            times[k].append(timed(fn) / n)
    ms = {k: statistics.median(v) for k, v in times.items()}
    return dict(shape=list(shape), equal=equal, convs_a_rep=n, a_ms=ms["A"], b_ms=ms["B"],
                c_ms=ms["C"], b_over_a=ms["B"] / ms["A"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny config's request alone (for the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    smi = device_line(device)
    gen = torch.Generator().manual_seed(0)
    request = request_shapes(device, tiny=args.tiny)
    shapes = ([] if args.tiny else list(SHAPES)) + [
        s for s in sorted(request) if s not in SHAPES]
    conv3x3_i8_fused.launches = 0
    rows = []
    for shape in shapes:
        r = ab_shape(shape, reps=args.reps, chain=args.chain, device=device, gen=gen)
        r["per_request"] = request.get(shape, 0)
        rows.append(r)
        B, H, W, Cin, Cout, sw = shape
        print(f"({B},{H},{W},{Cin})->{Cout} sw={sw}: A (K3) {r['a_ms']:8.4f} ms/conv  "
              f"B (im2col+_int_mm) {r['b_ms']:8.4f}  C (cuDNN bf16) {r['c_ms']:8.4f}  "
              f"B/A {r['b_over_a']:5.2f}x  A==B  x{r['per_request']} a request on {smi}",
              flush=True)
    sums = {k: sum(r[f"{k}_ms"] * r["per_request"] for r in rows) for k in "abc"}
    losing = sorted((r for r in rows if r["b_ms"] < r["a_ms"]),
                    key=lambda r: (r["b_ms"] - r["a_ms"]) * max(r["per_request"], 1))
    print(f"one int8 request ({sum(request.values())} K3 launches): A {sums['a']:.3f} ms, "
          f"B {sums['b']:.3f} ms, C {sums['c']:.3f} ms; shapes where K3 loses to "
          f"_int_mm: {[r['shape'] for r in losing]} on {smi}")
    out = {"tool": "conv_ab", "rows": rows, "request_ms": sums,
           "k3_loses_at": [r["shape"] for r in losing],
           "launches": {"conv3x3_i8_fused": conv3x3_i8_fused.launches}, "device": smi}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
