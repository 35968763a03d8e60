#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA GPU and check its kernels.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into ``build/``;
3. K1 (fused MetaKernel stem) against its plain twin at the flagship
   shape and at a small odd shape (edges, ragged tiles):
   max|diff| <= 2e-2 * max|ref| (fp32 accumulation order, one-ulp bf16
   flips of the intermediate ``p``);
4. K2 (NMS scan) against its plain twin on the same IoU tensors, B=2,
   cap=1024, WEIGHTED and HARD: ``keep`` identical, ``merged`` within 1e-4;
5. main path: ``Predictor`` on the full rv-av2 flagship config (B=2,
   64x1808, 26 classes, 512-channel towers, bf16, random seeded weights)
   answers 4 requests; both kernels must launch, outputs must be finite
   with detections kept, and the NMS must agree with the plain scan on the
   same proposals;
6. timings (CUDA events, warm-up, median) of each kernel, its plain twin
   and its bound, ms per request of the main path, its forward and
   decode + NMS device times, and a torch.profiler table of one request's
   device time by kernel.

Prints the card's name and power limit and a ``{"kernels": [...]}`` line
before the last line, which is ``{"ok": true, "device": {...}}``. There is
no CPU path: without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense tensor-core peak (H100 SXM data sheet)
H100_FP32_FLOPS = 67e12  # outside the tensor cores
H100_BYTES_PER_S = 3.35e12
SEED = 0


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, flop_rate: float, nbytes: float):
    t_ops = flops / flop_rate * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def stem_inputs(B, H, W, C, gen, device):
    import torch

    def rn(*shape, std=1.0):
        return torch.randn(shape, generator=gen) * std

    bf16 = torch.bfloat16
    return dict(
        g=rn(B, H, W, C).to(device, bf16),
        feats=rn(B, H, W, C).to(device, bf16),
        w1=rn(C, C, std=C**-0.5).to(device, bf16),
        k=rn(9, C, C, std=C**-0.5).to(device, bf16),
        a0=(torch.rand(C, generator=gen) + 0.5).to(device),
        b0=rn(C, std=0.5).to(device),
        a1=(torch.rand(C, generator=gen) + 0.5).to(device),
        b1=rn(C, std=0.5).to(device),
    )


def nms_case(B, cap, gen, device):
    """Sorted, overlapping boxes (one category) and their IoU matrix."""
    import torch

    from range_view_3d_detection_torch.ops.iou import iou_rotated_bev

    def u(lo, hi, *shape):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    boxes = torch.stack(
        [u(-40, 40, B, cap), u(-40, 40, B, cap), u(-2, 2, B, cap),
         u(2, 6, B, cap), u(1, 3, B, cap), u(1, 2, B, cap),
         u(-math.pi, math.pi, B, cap)], dim=-1,
    ).to(device)
    scores = torch.sort(u(0, 1, B, cap), dim=-1, descending=True).values.to(device)
    payload = torch.cat(
        [boxes[..., :6], torch.sin(boxes[..., 6:]), torch.cos(boxes[..., 6:]),
         scores[..., None]], dim=-1,
    )
    iou = iou_rotated_bev(boxes[..., [0, 1, 3, 4, 6]], boxes[..., [0, 1, 3, 4, 6]])
    return iou, scores, scores >= 0.1, payload


def profile_request(predictor, request) -> None:
    """Print the device time of one request by kernel (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor(*request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(
        e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
    ) / 1e3
    say(events.table(sort_by="self_device_time_total", row_limit=25))
    say(f"profile: request wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.kernels import _build
    from range_view_3d_detection_torch.kernels.nms import nms_scan, nms_scan_plain
    from range_view_3d_detection_torch.kernels.stem import (
        meta_kernel_fused,
        meta_kernel_fused_plain,
    )
    from range_view_3d_detection_torch.models.decoder import DecoderConfig, decode
    from range_view_3d_detection_torch.models.stems import MetaKernel
    from range_view_3d_detection_torch.ops import nms as nms_ops

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    gen = torch.Generator().manual_seed(SEED)

    # 1. Device.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"nvidia-smi: {smi}")

    # 2. Build.
    lib = _build.library()
    say(f"build: {lib.path} in {lib.build_seconds:.1f} s")
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            say(f"  ptxas: {line.strip()}")

    # 3. K1 against its plain twin.
    B, H, W, C = 2, 64, 1808, 256
    k1_in = stem_inputs(B, H, W, C, gen, device)
    k1_err = 0.0
    for shape, x in (
        ((B, H, W, C), k1_in),
        ((1, 3, 37, C), stem_inputs(1, 3, 37, C, gen, device)),
    ):
        got = meta_kernel_fused(**x)
        want = meta_kernel_fused_plain(**x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        check(bool(torch.isfinite(got).all()), f"K1 non-finite at {shape}")
        check(err <= 2e-2 * ref, f"K1 {shape}: max|diff| {err} > 2e-2 * {ref}")
        say(f"K1 {shape}: max|diff| {err:.4g} (max|ref| {ref:.4g}) ok")
        k1_err = max(k1_err, err)

    # 4. K2 against its plain twin.
    cap = 1024
    k2_in = nms_case(2, cap, gen, device)
    k2_err = 0.0
    for mode, merge in (("WEIGHTED", 0.5), ("HARD", 1.01)):
        kw = dict(iou_threshold=0.3, merge_threshold=merge)
        keep, merged = nms_scan(*k2_in, **kw)
        keep_p, merged_p = nms_scan_plain(*k2_in, **kw)
        torch.cuda.synchronize()
        check(torch.equal(keep, keep_p), f"K2 {mode}: keep differs from the twin")
        err = (merged - merged_p).abs().max().item()
        check(err <= 1e-4, f"K2 {mode}: merged max|diff| {err} > 1e-4")
        say(f"K2 {mode}: keep identical ({int(keep.sum())} kept of "
            f"{int(k2_in[2].sum())} valid), merged max|diff| {err:.3g} ok")
        k2_err = max(k2_err, err)

    # 5. Main path: the flagship Predictor answers requests.
    cfg = serving._flagship_config()
    dec = DecoderConfig()
    predictor = serving.Predictor(cfg, dec, device=device, generator=gen)
    model = predictor.model
    with torch.no_grad():
        for m in model.modules():  # non-trivial BatchNorm statistics
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) * 1.5 + 0.5)
            if isinstance(m, MetaKernel):
                for i in range(m.num_layers):
                    mean = getattr(m, f"pos_{i}_bn_mean")
                    mean.copy_(torch.randn(mean.shape, generator=gen) * 0.1)
                    var = getattr(m, f"pos_{i}_bn_var")
                    var.copy_(torch.rand(var.shape, generator=gen) * 1.5 + 0.5)
    requests = [serving._sample_inputs(2, 64, 1808, 5, seed=s) for s in range(4)]
    # Scale each head's final conv to a set output spread (random deep
    # weights make the raw spread arbitrary), with the classification bias
    # at 0 so sigmoid ~ 0.5 and the NMS slots hold overlapping proposals.
    with torch.inference_mode():
        first = model(*(torch.as_tensor(a, device=device) for a in requests[0]))
    with torch.no_grad():
        for name, head in model.DetectionHead_0.named_children():
            key = "logits" if name.startswith("cls_") else "regressands"
            spread = 1.0 if key == "logits" else 0.3
            conv = head.final.Conv_0
            conv.weight.mul_(spread / first["head"][1][0][key].float().std().item())
            conv.bias.zero_()
            if key == "regressands":
                conv.bias[3:6] = math.log(3.0)
    predictor(*requests[0])  # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    meta_kernel_fused.launches = 0
    nms_scan.launches = 0
    t0 = time.perf_counter()
    results = [predictor(*r) for r in requests]
    torch.cuda.synchronize()
    ms_per_request = (time.perf_counter() - t0) * 1e3 / len(requests)
    launches = {"K1": meta_kernel_fused.launches, "K2": nms_scan.launches}
    say(f"main path: {len(requests)} requests, launches {launches}")
    check(launches["K1"] > 0 and launches["K2"] > 0, f"a kernel did not run: {launches}")
    for r in results:
        for t in (r.cuboids, r.scores):
            check(bool(torch.isfinite(t[r.keep]).all()), "non-finite detections")
        check(r.keep.shape[0] == 2, f"keep shape {tuple(r.keep.shape)}")
    kept = [int(r.keep.sum()) for r in results]
    check(min(kept) > 0, f"no detections kept: {kept}")

    # The same proposals through the plain scan.
    with torch.inference_mode():
        out = model(*(torch.as_tensor(a, device=device) for a in requests[0]))
        props = decode(out, dec, cfg.tasks_dict, use_nms=False)
        inputs = nms_ops.nms_inputs(
            *props, cap=min(dec.nms_cap, props.scores.shape[1]),
            min_confidence=dec.min_confidence, mode=dec.nms_mode,
        )
        kw = dict(iou_threshold=dec.nms_threshold, merge_threshold=inputs.merge_threshold)
        got = nms_ops.nms_result(inputs, *nms_scan(*inputs[:4], **kw), dec.num_post_nms)
        want = nms_ops.nms_result(
            inputs, *nms_scan_plain(*inputs[:4], **kw), dec.num_post_nms
        )
    check(torch.equal(got.keep, want.keep), "main-path NMS keep differs from the twin")
    k = want.keep
    nms_err = (got.cuboids[k] - want.cuboids[k]).abs().max().item()
    check(nms_err <= 1e-3, f"main-path NMS cuboids max|diff| {nms_err}")
    n_valid = int(inputs.valid.sum())
    say(f"main path: kept {kept} per request of {tuple(inputs.valid.shape)} "
        f"slots ({n_valid} valid in request 0), "
        f"NMS == plain scan (cuboids max|diff| {nms_err:.3g}), "
        f"{ms_per_request:.2f} ms/request, "
        f"{2 * 1e3 / ms_per_request:.2f} frames/s")

    # 6. Timings at the main path's shapes.
    k1_ms = cuda_ms(lambda: meta_kernel_fused(**k1_in), reps=10)
    k1_plain_ms = cuda_ms(lambda: meta_kernel_fused_plain(**k1_in), reps=3, warmup=1)
    k1_flops = 2 * B * H * W * 9 * 2 * C * C
    k1_bytes = 2 * (2 * B * H * W * C) + 2 * 10 * C * C + 16 * C + 4 * B * H * W * C
    k1_bound, k1_by = bound_ms(k1_flops, H100_BF16_FLOPS, k1_bytes)
    nms_kw = dict(iou_threshold=0.3, merge_threshold=0.5)
    k2_ms = cuda_ms(lambda: nms_scan(*k2_in, **nms_kw), reps=20)
    k2_plain_ms = cuda_ms(lambda: nms_scan_plain(*k2_in, **nms_kw), reps=3, warmup=1)
    live = int(nms_scan(*k2_in, **nms_kw)[0].sum())
    k2_flops = live * cap * 2 * (1 + 9) * 2  # weights + dot products, per image-live step
    k2_bytes = 2 * cap * cap * 4 + 2 * cap * (4 + 1 + 9 * 4) + 2 * cap * (1 + 9 * 4)
    k2_bound, k2_by = bound_ms(k2_flops, H100_FP32_FLOPS, k2_bytes)
    say(f"K1 flagship: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms, "
        f"bound {k1_bound:.3f} ms ({k1_by}) on {smi}")
    say(f"K2 cap {cap} B 2: kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms, "
        f"bound {k2_bound * 1e3:.2f} us ({k2_by}), {live} live steps on {smi}")
    kernels = [
        {
            "name": "meta_kernel_fused", "route": "cuda",
            "source": "range_view_3d_detection_torch/csrc/meta_kernel_fused.cu",
            "replaces": "range_view_3d_detection_tpu/kernels/stem_pallas.py:269",
            "launches": launches["K1"], "max_abs_err": k1_err,
            "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
            "bound_by": k1_by, "library_ms": None,
        },
        {
            "name": "nms_scan", "route": "cuda",
            "source": "range_view_3d_detection_torch/csrc/nms_scan.cu",
            "replaces": "range_view_3d_detection_tpu/kernels/nms_pallas.py:121",
            "launches": launches["K2"], "max_abs_err": k2_err,
            "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
            "bound_by": k2_by, "library_ms": None,
        },
    ]
    # Where a request's time goes: the forward, then decode + NMS.
    tensors = [torch.as_tensor(a, device=device) for a in requests[0]]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(*tensors), reps=5)
        out = model(*tensors)
        dec_ms = cuda_ms(lambda: decode(out, dec, cfg.tasks_dict, use_nms=True), reps=5)
        profile_request(predictor, requests[1])
    say(f"main path: {ms_per_request:.3f} ms/request (B=2), "
        f"{2 * 1e3 / ms_per_request:.2f} frames/s; forward {fwd_ms:.3f} ms, "
        f"decode+NMS {dec_ms:.3f} ms (device) on {smi}; "
        f"total {time.perf_counter() - t_start:.0f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
