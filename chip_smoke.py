#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA GPU and
check its kernels.

    python3 chip_smoke.py

(``python -m torch.distributed.run ... chip_smoke.py train-rank ARGS`` is
phase 23's rank process, ``... chip_smoke.py width-rank ARGS`` the
width-sharded serving rank of phase 25 and ``chip_scaling.py width``, and
``chip_smoke.py convert WORK`` phase 29's conversion process; the script
starts them itself. ``chip_smoke.py tools`` runs phases 30-38 alone.)

Phases, each of which raises (non-zero exit) on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into ``build/``;
   ptxas's register and spill lines (kept beside the library, so a reused
   build is checked too), and zero spills in both instances of K1 and of
   K4 and in the six of K3;
3. K1 (fused MetaKernel stem) against its plain twin at the flagship
   shape, at a small odd shape (edges, ragged tiles), at a single row
   with a ragged last 64-pixel tile (1, 1, 70) and at exact tiles (2, 2,
   64), all at C = 256; at the Waymo and nuScenes stem width C = 128
   (Waymo's padded 64x2656 image) and the synthetic configs' C = 32; and
   at C = 96 and 160, which the kernel pads to its 128- and 256-wide
   instances: max|diff| <= 2e-2 * max|ref| (fp32 accumulation order,
   one-ulp bf16 flips of the intermediate ``p``); a C the kernel does not
   take (48, 288) raises;
4. K2 (NMS scan) against its plain twin on the same IoU tensors, WEIGHTED
   and HARD, at B in {1, 2, 3} x cap in ``NMS_CAPS`` (1, 37 and 1023
   among them, which take the scalar instances) and on edge-case
   matrices (zeros on the diagonal, asymmetric, invalid boxes in the
   middle, every box suppressed, duplicated boxes) at cap 37, 100 and
   1024, and with the IoU and scores 4 bytes off a 16-byte boundary at
   cap 1024: ``keep`` identical, ``merged`` within 1e-4; cap 4097 and a
   payload of 8 are refused;
5. main path: ATen's CUDA ``addcmul``, on which the BatchNorm epilogue
   rests, must be one fused multiply-add (equal to a correctly rounded
   fp64 reference on 4M values); ``Predictor`` on the full rv-av2 flagship
   config (B=2, 64x1808, 26 classes, 512-channel towers, bf16, random
   seeded weights) answers 4 requests; both kernels must launch, outputs
   must be finite with detections kept, and the NMS must agree with the
   plain scan on the same proposals;
6. timings (CUDA events around eager launches, warm-up, median) of each
   kernel, its plain twin and its bound (K1 and K2 also by CUDA-graph
   replay; K1 with its L2 weight bytes a call, and at the Waymo stem
   shape; K2 with its chain floor, a model printed beside its times and
   not in the kernels line, and the device time of each of its three
   kernels), ms per request of the main path, its forward and
   decode + NMS device times, decode + NMS split by stage (CUDA events)
   and by op (torch.profiler), every BatchNorm epilogue of a request in
   flax's order beside ``BatchNorm2d``'s own form (eager and graph
   replay, summed), and a torch.profiler table of one request's device
   time by kernel;
7. K3 (int8 3x3 conv) against its plain twin at small odd shapes, stride
   1 and 2, bf16 and fp32 output, in both operand forms
   (int8, and bf16/fp32 activations with ``in_scale`` on rounding ties and
   beyond the clamp): ``torch.equal`` (integer work is exact); and the
   fused quantizer alone against ``quantize_to_int8`` on every finite
   bf16 value and on fp32 values around every rounding boundary, at
   scales inside and outside the range of its Markstein division;
8. int8 path: the phase-5 model is folded, calibrated on request 0 and
   quantized (full scope, ``Predictor.quantize``); one request captures
   every K3 launch's inputs (each must be the unquantized, NHWC-contiguous
   activation with its ``in_scale``), then 4 requests must launch K1, K2
   and K3 and not K4, give finite outputs with detections kept, and the
   NMS must equal the plain scan; the head outputs' relative RMS to the
   bf16 path and the kept-box agreement are printed (not gated);
9. K3 against its twin on every distinct shape that request launched, in
   both operand forms, bf16 and fp32 output: ``torch.equal``; each shape's
   time (CUDA events around eager launches, as every kernel is timed, and
   device time by CUDA-graph replay beside it), launches per request,
   bound (2 bytes per bf16 input element) and share of bound, their sums
   over a request, a bf16 cuDNN conv at the
   tower shape for context, and how many ``div``/``round``/``clamp``/
   ``copy_`` ops one request runs on each path;
10. the int8 path with ``stem_int8=True``: K4 must launch and K1 not; K4
   against its twin on the captured flagship inputs, a ragged crop of
   them, the Waymo stem (2, 64, 2656, 128), (2, 32, 256, 32), (1, 3, 37,
   96), (1, 3, 37, 160) and on edge cases that bind every clamp and
   rounding tie (``k4_edge_case``) at C = 256 and 128: max|diff| <= 1e-4 *
   max|ref|, the count of differing elements printed (expected 0: the
   kernel's arithmetic is its twin's); a C it does not take (48, 288)
   raises; K4's time (eager and graph replay), bound and twin's time,
   and a profiler table of one request with the K4 stem;
11. ms per request of both int8 paths;
12. training, card against CPU: one train step (``training.state.
    make_train_step``) at the flagship's channel widths and depth in fp32
    (TF32 off) on ``_dryrun_batch`` at (2, 4, 64), on the card and on the
    CPU from the same weights: loss and every metric within 1e-4
    relative, running statistics within 1e-5, parameters after the AdamW
    step within the sign-flip bound, gradients gated against the CPU's
    own sensitivity to a 1e-7 input change (``train_card_vs_cpu``);
13. six train steps of the full flagship (bf16, ``stem_pallas``, 256 box
    slots, B=2 64x1808, 64 seeded boxes an image, constant learning
    rate 1e-3): finite losses and ``grad_norm`` > 0 each step, every
    parameter leaf and every running statistic changed; peak memory;
14. the eval and val steps on the trained state: K1 and K2 launch, K1
    against its twin on the trained affines (phase 3's tolerance), the
    NMS against the plain scan, finite outputs and val losses;
15. a checkpoint of the trained state saved and restored on the card,
    equal bit for bit;
16. timings: ms a train step (CUDA events, 2 warm-up, median of 7) split
    into targets, forward, loss, backward and optimizer; ms an eval
    step; a torch.profiler table of one step by kernel;
17. the Trainer at the flagship: ``generate_dataset`` writes a 64x1800
    AV2-layout corpus with rv-av2's 26 categories (one train log of 16
    sweeps, one val log of 4, 24 boxes a sweep) into a temporary
    directory; ``compose("conf", "rv-av2")`` with the root there, one
    epoch, baseline.yaml's B=4 with ``model.remat=true`` (every group of
    ``remat_scope``) and ``train_log_freq`` 2, augmentations on;
    ``Trainer.fit`` takes 4 steps:
    finite losses, step 4, its checkpoint restored bit for bit,
    ``metrics.jsonl`` and the 4 PNGs decode; ``validate()`` must launch
    K1 and K2 and write one shard per val sweep, read back; the
    evaluator's ``AVERAGE_METRICS`` finite. Printed: wall ms per step
    (steps 2-4) beside its device ms (CUDA events), the loader's host ms
    a batch by stage, ms a validate batch, the evaluator's seconds, peak
    memory. The launch counts are reset before the fit and read after
    validate (``trainer_launches`` in the kernels line);
18. the AV2 debug overfit (``overfit.run("av2", 40)``: the corpus and
    overrides of ``scripts/debug-overfit.sh``): the mean loss of the last
    10 steps at most half the first step's, a finite mAP (the gate's
    source: ``OVERFIT_EPOCHS``); then the int8 PTQ predictor of the same
    weights (full scope, calibrated on the train batches) must launch K3
    and K2, and its mAP is printed beside the bf16 one (not gated);
19. projection on the card (``ops/projection.py::rasterize_points``):
    B=2 clouds of 131,072 points (``export._sample_points``) at AV2's
    64x1800, padded to 1808 (circular), at Waymo's 64x2650 (its features
    and ``view``, tanh intensity, constant padding) and at AV2 x_stride 4
    (464 columns), each held against the port's own CPU run of the same
    points: every point's range equal, and a pixel may differ only where
    a point's azimuth column differs between card and CPU (the card's
    ``atan2``; Waymo's tanh plane may also differ by 4 ulps); the counts
    printed; the projection's time (CUDA events, median);
20. artifacts on the card: the phase-5 model, exported right after phase 5
    (bf16, and int8 calibrated on request 0, full scope), loaded with
    ``export.load_artifact``: the bf16 artifact serves the 4 requests
    (K1 and K2 launch, finite, detections kept, NMS equal to the plain
    scan; kept-box agreement and head relative RMS against phase 5's
    predictor printed, not gated); the int8 artifact's loaded quant tree
    is the written one byte for byte and it launches K3, K1 and K2 and not
    K4; loaded under ``RV3D_STEM_INT8=1`` it launches K4 and not K1;
21. raw points to detections at flagship width: the bf16 artifact behind
    ``export.make_points_predict`` serves 4 requests of B=2 x 131,072
    points (sensor width 1800, served at 64x1808): K1 and K2 launch,
    finite, detections kept, equal to the predictor on the same clouds
    rasterized on the card by hand (keep and categories equal, values
    within 1e-6); ``latency_bench`` (50 requests: p50/p90/p99) and
    ``stream_bench`` (20 iterations) on range images in bf16 and int8 and
    on points in bf16; projection's share of a points request; and the
    export CLI as a user types it, in a subprocess (``--synthetic --out
    D``, then ``--load D --points --latency --iters 50``), its JSON line
    parsed;
22. remat: the flagship train step (bf16, B=2 64x1808, 64 boxes an
    image) without remat and with every group of ``remat_scope``, from the
    same weights: the loss and the running statistics equal bit for bit,
    the gradients within ``train_card_vs_cpu``'s form of tolerance (the
    median leaf within 2e-3 of its max, the worst within 1e-3 plus twice
    the card's own run-to-run move); then each of B=2 without remat, B=2
    with it and B=4 with it: ms a step (CUDA events, 2 warm-up, median of
    5) split into targets, forward, loss, backward and optimizer, and
    peak memory, which must stay inside the card's;
23. distributed: in this process, the phase-22 step as rank 0 of a NCCL
    group of one (``parallel/mesh.py``'s collectives all run) against the
    same step without a group: loss and running statistics equal bit for
    bit, gradients as in phase 22; then ``python -m torch.distributed.run
    --nproc_per_node=<cards>`` over the port's ``train`` entry point at
    rv-av2 on the phase-17 corpus, B=4 a rank, remat on,
    ``trainer.zero1=true``, one epoch (fit, validate, evaluation), each
    rank instrumented by ``chip_smoke.py train-rank``: world size,
    backend, step ms (CUDA events), the device ms of a step's SyncBN
    all-reduces (torch.profiler: the ``mesh.global_moments`` ranges and
    their ``_AllReduceBackward``) beside all of its NCCL kernels, peak
    memory, and K1 and K2 launches; the subprocess failing fails the
    script. World size 1 on a one-card machine proves the NCCL path and
    the launcher, not scaling;
24. QAT: phase 18's trained model, with the scales phase 18 calibrated
    (fold, calibrate on the train batches, full scope), fine-tuned under
    QAT (``make_train_step(quant_tree=...)``) for ``QAT_STEPS`` steps at
    1e-4 (``tools/quant_accuracy.py``'s ``--qat-lr``), then served int8
    with those scales (K3, K2 launch) and scored: fp, PTQ and QAT mAP
    printed; one K3 conv of the fine-tuned model, on its captured input:
    the QAT forward (``qat_conv``, fp32 with TF32 off) equals the int8
    serving value (K3) within 2e-5 of max|ref| (fp32 sums in another
    order), printed beside the same conv with TF32 on.

25. width sharding (``parallel/spatial.py``) at world size = the card
    count: on one card, in this process, a NCCL group of one serves the
    phase-20 bf16 artifact through ``export.load_artifact_width_sharded``
    on a B=1 64x1792 request (1792 = 16 x 112: AV2's padded 1808 = 16 x 113
    cannot be split in two, which ``spatial.check_width`` must refuse),
    with ``circular`` False and True: K2 launches and K1 does not (the
    stem takes its accumulate path under width sharding), finite
    detections kept; the heads' relative RMS against the unsharded
    forward on the same accumulate stem at most 1e-2 (zero-padded seam),
    and printed against the K1 stem's forward with the kept-box
    agreements, the halo exchanges a request and ms a request beside
    ``load_artifact``'s. One card has no neighbour: this checks the hooks,
    not the exchange (the CPU tests hold 2 and 4 gloo ranks against JAX;
    ``chip_scaling.py width N`` times N cards). On more cards the same
    request is served by ``torch.distributed.run`` over ``chip_smoke.py
    width-rank``;
26. the chunk loop: ``export.make_chunked_predict`` of the bf16 artifact's
    predictor over the 4 requests of phase 5 stacked (4 x B=2): the CUDA
    graph's replay equals 4 eager calls bit for bit, twice; K1 and K2
    launch while it is captured; ``stream_bench`` frames/s and peak memory
    at chunk 0 and chunk 4;
27. AOT: ``export.export_aot`` of the bf16 and the int8 artifacts at
    (2, 64, 1808), ``load_aot`` of each: its outputs on the 4 requests
    equal ``load_artifact``'s bit for bit, K1 and K2 (and K3 for int8)
    launch through the ``rv3d::`` ops, ms a request beside
    ``load_artifact``'s; and the bf16 program loaded and served in a
    subprocess that imports only the kernels package, equal bit for bit;
28. the RANGE_PARTITION stem: the flagship config with
    ``stem_type=RANGE_PARTITION`` (bf16, seeded weights) on the card
    against the same model on the CPU at B=1 8x256: heads within phase
    3's 2e-2 x max|ref|; its B=2 64x1808 forward finite and timed.
29. the offline data path: raw logs at full size written with the
    port's ``write_feather`` (AV2: a train log of 4 sweeps and a val log of
    2, each sweep 100,000 points of two 32-beam lasers in AV2's schema,
    x/y/z ``float16``, ``offset_ns`` over the 100 ms spin, poses at 10 Hz,
    annotations without ``num_interior_pts``, a map with drivable
    polygons; an LZ4-compressed copy of the AV2 logs, ``write_feather_lz4``;
    a nuScenes mini layout; Waymo frames at 64 x 2650), converted by the
    port's converters in a subprocess (``chip_smoke.py convert``) where
    JAX, pyarrow, the JAX package, ``converters/`` and ``tools/`` cannot
    be imported: every AV2 output file equal bit for bit to the same
    conversion on ``z_buffer_numpy`` and to the conversion of the LZ4
    copy, boxes counted and flagged, finite columns of the expected
    shapes; seconds a sweep and points a second.
    The native LZ4 frame decoder against its pure-Python twin and the
    original bytes on frames of a sweep's size from the greedy encoder
    here (``lz4_frame_compress``: linked blocks with matches into the
    previous block, overlapping matches, raw blocks; and independent
    blocks with every checksum), and its MB/s. The AV2 corpus converted
    from the LZ4 copy through the port's ``DataLoader``: ``Trainer.fit``
    2 steps at B=2 on rv-av2, ``validate`` and the AV2 evaluator (which
    reads the copied poses and map); one val batch served by the flagship
    ``Predictor``.
    K1 and K2 must launch (``converted_launches`` in the kernels line).
30. the bench: ``python -m range_view_3d_detection_torch.bench`` in a
    subprocess as a user runs it, int8 (the default), ``--fp``,
    ``--points`` and with ``RV3D_STEM_INT8=1``, at the flagship (B=2,
    64x1808, ``nms_cap`` 1024): each JSON line has frames/s above 0, p50 <=
    p90, ``eager`` in its mode and the card's ``nvidia-smi`` line; the same
    four modes through ``bench.main`` in this process, counts reset before
    and read after: K1, K2 and K3 in int8 and points, K1 and K2 (no K3) in
    bf16, K4 and not K1 under the int8 stem (``bench_*_launches`` in the
    kernels line); the bench's int8 pipeline on one request equals a
    ``Predictor.quantize`` built from the same seeded weights and batch
    (``keep`` identical, cuboids within 1e-3); a bench whose
    ``Predictor.quantize`` raises exits non-zero with no JSON line;
31. ``tools.benchmark``: ``--synthetic`` (rv-synthetic fitted one epoch,
    the staged report's keys, ``nms_ms >= 0``, metrics; ``--iters 10``),
    ``--loader`` at 64x1800 (frames/s of the host loader) and ``--train``
    at B=2 (remat on, its default there) for 4 steps, printed beside
    phases 16's and 22's ms a step;
32. ``tools.profile_trace --decode --batch 2``: the top kernels of a
    request by device time, K1's kernel and K2's three among them by name,
    the trace's summed device time beside phase 6's forward plus decode;
    ``tools.profile_forward``'s stage times at B=1;
33. ``tools.flops --train`` at the flagship, B=1: GFLOP and GB per stage
    and of a train step, K1's FLOPs equal to ``k1_cost``, and the
    forward's achieved TFLOP/s from phase 6's forward ms;
34. ``tools.remat_grid``: ``grid()`` at B=2 with 2 timed steps for 3 of
    its 8 scopes (off, all, stem+loss: a cut); ``tools.profile_train`` at
    B=2, 4 steps, remat off and on (a cut from B = 1, 2, 4 and 8 steps);
35. ``tools.quant_accuracy`` on phase 18's run (its state saved as a
    checkpoint of the run): the tool's scoring of phase 18's predictions
    equals phase 18's fp mAP; then calibrated on 2 val batches, fp and int8
    tables and deltas, once with the K1 stem's config (rv-synthetic's
    accumulate stem), once with ``RV3D_STEM_INT8=1`` (K4 launches), once
    with ``--qat-steps 20``; K3 and K2 launch in each; the int8 mAP beside
    phase 18's PTQ;
36. ``tools.quant_cert_scale --seeds 1 --epochs 2 --sweeps-per-log 8``
    (training and scoring in subprocesses) and ``tools.scale_drill
    --sweeps 100 --logs 2 --dense``, each a cut in depth, printed as such;
    the launches of phases 31-36 (``tools_launches``): all four kernels;
37. ``utils.compile_opts``: the pipeline of the tiny config at 32
    channels in bf16 with the K1 stem (B=1 16x256) under
    ``RV3D_COMPILER_OPTIONS=max_autotune=False`` (``torch.compile``):
    ``keep`` equal to eager's and not empty, heads within 2e-2 x max|ref|,
    K1 and K2 launched by the compiled program (``compile_launches``); the
    bench's compiled pipeline keep-equal to its eager one; an unknown
    option raises. The flagship is not compiled (a cut);
38. ``dryrun.entry()`` once (finite heads), then
    ``dryrun.dryrun_multichip(<cards>)``: its four phases as NCCL ranks in
    spawned processes, each reporting OK (none skipped for time).

``python3 chip_smoke.py tools`` runs the build and phases 30-38 alone
(phase 18's run and phase 6's times made for them; phases 16's and 22's
step times not measured).

Prints the card's name and power limit and a ``{"kernels": [...]}`` line
before the last line, which is ``{"ok": true, "device": {...}}``. There is
no CPU path: without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense tensor-core peak (H100 SXM data sheet)
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak
H100_FP32_FLOPS = 67e12  # outside the tensor cores
H100_BYTES_PER_S = 3.35e12
# A model, not a measurement: one dependent shared-memory round trip
# (about 30 cycles) at the H100 SXM's 1.98 GHz boost clock. K2's greedy
# keep needs one a live step; the chain floor it gives is printed with
# K2's times and kept out of the kernels line.
SMEM_STEP_S = 30 / 1.98e9
SEED = 0
NMS_EDGE_CASES = ("zero_diagonal", "asymmetric", "invalid_middle", "all_suppressed",
                  "duplicated")
# Caps K2 is held at: those not a multiple of 4 (1, 37, 1023) take the
# kernels' scalar instances, the others their 16-byte loads.
NMS_CAPS = (1, 37, 100, 512, 1023, 1024, 2048, 4096)


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


def graph_ms(fn, calls: int = 10) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in a
    CUDA graph and replayed (no host launch gaps), median of 3 replays."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, reps=3, warmup=1) / calls
    del graph
    return ms


def count_ops(predictor, request, names) -> dict:
    """How many times each ATen op in ``names`` ran in one request."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predictor(*request)
        torch.cuda.synchronize()
    counts = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.key in counts:
            counts[e.key] += e.count
    return counts


def ptxas_spills(log: str, kernel: str) -> dict:
    """Bytes of spill stores and loads that ``ptxas -v`` reports for each
    kernel (template instance) whose mangled name contains ``kernel``."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                               lines[i + 1])
            check(spills is not None, f"no spill line for {kernel}")
            found[line.split()[-1]] = int(spills[1]) + int(spills[2])
    check(bool(found), f"{kernel} not in the ptxas log")
    return found


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


def k4_inputs(B, H, W, C, gen, device):
    """Random K4 operands at the scales the calibrated stem gives them:
    ``hq`` spans 0-127 and ``p * feats`` about +-50 before the clamp."""
    import torch

    def rn(*shape):
        return torch.randn(shape, generator=gen)

    def u(lo, hi, *shape):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)

    bf16 = torch.bfloat16
    return dict(
        g=rn(B, H, W, C).to(device, bf16), feats=rn(B, H, W, C).to(device, bf16),
        w1_i8=i8(C, C).to(device), k_i8=i8(9, C, C).to(device),
        a0=u(15, 45, C).to(device), b0=(rn(C) * 30).to(device),
        a1=u(5e-4, 1.5e-3, C).to(device), b1=rn(C).to(device),
        kdq=u(5e-4, 1.5e-3, 9, C).to(device),
    )


def k4_edge_case(B, H, W, C, gen, device):
    """K4 operands on which every clamp and rounding tie binds: ``hq``
    saturates at 127, ``pq`` clamps at +127 and -127, and both ``rint``
    steps meet exact .5 ties (half to even). Integral ``g``, unit or
    halved affine scales, half-integral biases and power-of-two ``feats``
    and ``kdq`` keep every product exact, so a multiply and an add fused
    into one rounding (as XLA may fuse them) give the same result."""
    import torch

    def pick(values, *shape):
        v = torch.tensor(values, dtype=torch.float32)
        return v[torch.randint(len(values), shape, generator=gen)]

    g = torch.randint(-160, 161, (B, H, W, C), generator=gen).float()
    feats = pick((1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 0.25), B, H, W, C)
    # Two +-1 taps a column of W1, so |z| <= 254 and p * feats spans the clamp.
    w1 = torch.zeros(C, C, dtype=torch.int8)
    cols = torch.arange(C)
    for _ in range(2):
        w1[torch.randint(C, (C,), generator=gen), cols] += pick((1.0, -1.0), C).to(torch.int8)
    bf16 = torch.bfloat16
    return dict(
        g=g.to(device, bf16), feats=feats.to(device, bf16), w1_i8=w1.to(device),
        k_i8=torch.randint(-127, 128, (9, C, C), generator=gen, dtype=torch.int8).to(device),
        a0=torch.ones(C, device=device), b0=pick((0.5, -0.5, 0.25, 0.0), C).to(device),
        a1=pick((1.0, 0.5), C).to(device), b1=pick((0.5, -0.5, 0.0), C).to(device),
        kdq=pick((2.0**-10, 2.0**-12), 9, C).to(device),
    )


def check_addcmul_fma(device, gen, n: int = 1 << 22) -> None:
    """ATen's ``addcmul(b, d, m)`` on the card is one fused multiply-add:
    equal to ``b + d m`` rounded once to fp32, on ``n`` values where two
    roundings (``d * m + b``) differ. The reference: the product is exact
    in fp64; the fp64 sum's own error comes from TwoSum, and it settles
    the one case in which rounding the fp64 sum to fp32 is not the same
    as rounding the exact sum: an fp64 sum exactly halfway between two
    fp32 values."""
    import torch

    d, m, b = (torch.randn(n, generator=gen).to(device) * s for s in (3.0, 1.0, 2.0))
    got = torch.addcmul(b, d, m)
    p, bd = d.double() * m.double(), b.double()
    s = p + bd
    bv = s - p
    err = (p - (s - bv)) + (bd - bv)
    r = s.float()
    toward = torch.where(s > r.double(), torch.inf, -torch.inf).float()
    other = torch.nextafter(r, toward)
    tie = (s == (r.double() + other.double()) / 2) & (err != 0)
    want = torch.where(tie, torch.where(err > 0, torch.maximum(r, other),
                                        torch.minimum(r, other)), r)
    n_diff = int((got != want).sum())
    n_two = int((d * m + b != want).sum())
    check(n_diff == 0, f"addcmul is not one fused multiply-add: {n_diff} of {n} differ")
    check(n_two > 0, "the fused multiply-add check cannot tell fused from unfused")
    say(f"BN epilogue: CUDA addcmul equals the fused multiply-add on {n} values "
        f"({int(tie.sum())} fp64 ties settled by TwoSum); a separate multiply and add "
        f"differ in {n_two}")


def bn_epilogue_times(model, tensors, smi) -> None:
    """Device time of every eval BatchNorm epilogue of one request, one
    input of each distinct shape timed and counted: this tree's (flax's
    order: ``sub``, ``addcmul`` into the compute dtype, in-place ReLU)
    beside ``BatchNorm2d``'s own form (its ``x * a + b`` on an fp32 copy,
    a cast, a ReLU), by CUDA events around eager launches and by CUDA-graph replay,
    summed over the request; and how many outputs the two forms round
    apart."""
    import torch
    import torch.nn.functional as F

    from range_view_3d_detection_torch.models.blocks import BatchNorm

    shapes = {}
    forward = BatchNorm.forward

    def capture(self, y, dtype=torch.float32, act=False):
        key = (tuple(y.shape), y.dtype, dtype, act)
        entry = shapes.setdefault(key, dict(args=(self, y.clone(), dtype, act), n=0))
        entry["n"] += 1
        return forward(self, y, dtype, act)

    def batchnorm2d_form(bn, y, dtype, act):
        out = F.batch_norm(y.float(), bn.running_mean, bn.running_var, bn.weight,
                           bn.bias, False, 0.0, bn.eps).to(dtype)
        return torch.relu(out) if act else out

    BatchNorm.forward = capture
    try:
        with torch.inference_mode():
            model(*tensors)
    finally:
        BatchNorm.forward = forward
    sums = dict.fromkeys(("flax", "flax_graph", "bn2d", "bn2d_graph"), 0.0)
    n_calls = n_out = n_diff = 0
    with torch.inference_mode():
        for e in shapes.values():
            args, n = e["args"], e["n"]
            sums["flax"] += n * cuda_ms(lambda: forward(*args), reps=10)
            sums["bn2d"] += n * cuda_ms(lambda: batchnorm2d_form(*args), reps=10)
            sums["flax_graph"] += n * graph_ms(lambda: forward(*args))
            sums["bn2d_graph"] += n * graph_ms(lambda: batchnorm2d_form(*args))
            got, old = forward(*args), batchnorm2d_form(*args)
            n_calls += n
            n_out += n * got.numel()
            n_diff += n * int((got != old).sum())
    say(f"BN epilogue of one request ({n_calls} calls, {len(shapes)} shapes): flax's "
        f"order {sums['flax']:.3f} ms eager, {sums['flax_graph']:.3f} ms graph replay; "
        f"BatchNorm2d's form {sums['bn2d']:.3f} ms eager, "
        f"{sums['bn2d_graph']:.3f} ms graph replay; {n_diff} of {n_out} outputs "
        f"rounded apart, on {smi}")


def k1_cost(B, H, W, C):
    """(flop, bytes) of one K1 call: two C x C GEMMs per neighbour and
    pixel; g and feats read once, the weights and affines, fp32 out."""
    flops = 2 * B * H * W * 9 * 2 * C * C
    nbytes = 2 * (2 * B * H * W * C) + 2 * 10 * C * C + 16 * C + 4 * B * H * W * C
    return flops, nbytes


def k4_cost(B, H, W, C):
    """(operations, rate, bytes) of one K4 call: two C x C int8 GEMMs per
    neighbour and pixel at the int8 peak; g and feats (bf16) read once, the
    int8 weights, the affines and kdq, fp32 out."""
    ops = 2 * B * H * W * 9 * 2 * C * C
    nbytes = 2 * (2 * B * H * W * C) + 10 * C * C + 4 * 13 * C + 4 * B * H * W * C
    return ops, H100_INT8_OPS, nbytes


def nms_case(B, cap, gen, device, duplicated=False):
    """Sorted, overlapping boxes (one category) and their IoU matrix, one
    image at a time; ``duplicated``: each box twice with the same score."""
    import torch

    from range_view_3d_detection_torch.ops.iou import iou_rotated_bev

    def u(lo, hi, *shape):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    boxes = torch.stack(
        [u(-40, 40, B, cap), u(-40, 40, B, cap), u(-2, 2, B, cap),
         u(2, 6, B, cap), u(1, 3, B, cap), u(1, 2, B, cap),
         u(-math.pi, math.pi, B, cap)], dim=-1,
    )
    raw = u(0, 1, B, cap)
    if duplicated:
        half = cap // 2
        boxes[:, half:] = boxes[:, : cap - half]
        raw[:, half:] = raw[:, : cap - half]
        order = torch.sort(raw, dim=-1, descending=True, stable=True).indices
        boxes = torch.gather(boxes, 1, order[..., None].expand_as(boxes))
    boxes = boxes.to(device)
    scores = torch.sort(raw, dim=-1, descending=True).values.to(device)
    payload = torch.cat(
        [boxes[..., :6], torch.sin(boxes[..., 6:]), torch.cos(boxes[..., 6:]),
         scores[..., None]], dim=-1,
    )
    bev = boxes[..., [0, 1, 3, 4, 6]]
    iou = torch.stack([iou_rotated_bev(bev[b], bev[b]) for b in range(B)])
    return iou, scores, scores >= 0.1, payload


def nms_edge_case(case, B, cap, gen, device):
    """One of the CPU test's edge cases of the scan (``NMS_EDGE_CASES``)."""
    import torch

    iou, scores, valid, payload = nms_case(B, cap, gen, device,
                                           duplicated=case == "duplicated")
    if case == "zero_diagonal":
        # Boxes that never kill (themselves included), each overlapping a
        # later box that sees it: kept, they join that box's cluster.
        for b in range(B):
            idx = torch.randperm(cap - 1, generator=gen)[: cap // 4]
            iou[b, idx, idx] = 0.0
            for j in idx[: cap // 8].tolist():
                iou[b, j] = 0.0
                iou[b, int(torch.randint(j + 1, cap, (1,), generator=gen)), j] = 0.8
    elif case == "asymmetric":  # the diagonal too, zeros included
        r = torch.rand((B, cap, cap), generator=gen)
        iou = (r * (torch.rand((B, cap, cap), generator=gen) < 0.08)).to(device)
    elif case == "invalid_middle":
        valid[:, cap // 4 : cap // 2] = False
        valid[:, torch.randperm(cap, generator=gen)[: cap // 8].to(device)] = False
    elif case == "all_suppressed":
        iou = torch.ones_like(iou)
    return iou, scores, valid, payload


def misaligned(t):
    """A contiguous copy of ``t`` that starts one element past the start of
    its allocation (4 bytes past a 16-byte boundary for fp32)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_k2(tag, inputs) -> float:
    """K2 against its plain twin, WEIGHTED and HARD: ``keep`` identical,
    ``merged`` within 1e-4. Returns max|merged diff|."""
    import torch

    from range_view_3d_detection_torch.kernels.nms import nms_scan, nms_scan_plain

    worst, kept = 0.0, []
    for mode, merge in (("WEIGHTED", 0.5), ("HARD", 1.01)):
        kw = dict(iou_threshold=0.3, merge_threshold=merge)
        keep, merged = nms_scan(*inputs, **kw)
        keep_p, merged_p = nms_scan_plain(*inputs, **kw)
        torch.cuda.synchronize()
        check(torch.equal(keep, keep_p), f"K2 {tag} {mode}: keep differs from the "
              f"twin in {int((keep != keep_p).sum())} slots")
        err = (merged - merged_p).abs().max().item()
        check(err <= 1e-4, f"K2 {tag} {mode}: merged max|diff| {err} > 1e-4")
        worst = max(worst, err)
        kept.append(int(keep.sum()))
    say(f"K2 {tag}: keep identical (kept {kept[0]} WEIGHTED, {kept[1]} HARD of "
        f"{int(inputs[2].sum())} valid), merged max|diff| {worst:.3g} ok")
    return worst


def kernel_device_us(fn, names, calls: int = 5) -> dict:
    """Device microseconds a call of ``fn`` spends in each kernel whose
    name contains one of ``names`` (torch.profiler, ``calls`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                found[n] += e.self_device_time_total / calls
    return found


def decode_split(out, dec, cfg, smi) -> None:
    """Where decode + NMS spends its time: each stage by CUDA events around
    eager launches, then one call's device time by op (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.models.decoder import decode
    from range_view_3d_detection_torch.ops import nms as nms_ops

    props = decode(out, dec, cfg.tasks_dict, use_nms=False)
    sel = dict(cap=min(dec.nms_cap, props.scores.shape[1]),
               min_confidence=dec.min_confidence, mode=dec.nms_mode)
    seen = {}
    iou_fn = nms_ops.iou_rotated_bev

    def capture(a, b):  # the class-offset boxes that the IoU matrix is of
        seen["bev"] = a
        return iou_fn(a, b)

    nms_ops.iou_rotated_bev = capture
    try:
        inputs = nms_ops.nms_inputs(*props, **sel)
    finally:
        nms_ops.iou_rotated_bev = iou_fn
    bev = seen["bev"]
    kw = dict(iou_threshold=dec.nms_threshold, merge_threshold=inputs.merge_threshold)
    keep, merged = nms_scan(*inputs[:4], **kw)
    ms = {
        "decode + NMS": cuda_ms(lambda: decode(out, dec, cfg.tasks_dict, use_nms=True),
                                reps=5),
        "proposals (sigmoid, box decode, range thinning, reductions)": cuda_ms(
            lambda: decode(out, dec, cfg.tasks_dict, use_nms=False), reps=5),
        "top-cap selection + IoU (nms_inputs)": cuda_ms(
            lambda: nms_ops.nms_inputs(*props, **sel), reps=5),
        "IoU matrix (iou_rotated_bev)": cuda_ms(lambda: iou_fn(bev, bev), reps=5),
        "K2 (nms_scan)": cuda_ms(lambda: nms_scan(*inputs[:4], **kw), reps=5),
        "output and post-NMS cap (nms_result)": cuda_ms(
            lambda: nms_ops.nms_result(inputs, keep, merged, dec.num_post_nms), reps=5),
    }
    ms["sort, gathers, class offsets, payload"] = (
        ms["top-cap selection + IoU (nms_inputs)"] - ms["IoU matrix (iou_rotated_bev)"])
    say(f"decode + NMS by stage (CUDA events, B={bev.shape[0]}, cap {bev.shape[1]}, "
        f"{smi}): " + "; ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode(out, dec, cfg.tasks_dict, use_nms=True)
        torch.cuda.synchronize()
    say("decode + NMS, one call, device time by op:")
    say(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))


def check_nms_against_plain(model, request, cfg, dec, device) -> float:
    """The main path's NMS on request's proposals equals the plain scan."""
    import torch

    from range_view_3d_detection_torch.kernels.nms import nms_scan, nms_scan_plain
    from range_view_3d_detection_torch.models.decoder import decode
    from range_view_3d_detection_torch.ops import nms as nms_ops

    with torch.inference_mode():
        out = model(*(torch.as_tensor(a, device=device) for a in request))
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
    return nms_err


def check_results(results) -> list:
    """Finite kept detections in every request; the kept counts."""
    import torch

    for r in results:
        for t in (r.cuboids, r.scores):
            check(bool(torch.isfinite(t[r.keep]).all()), "non-finite detections")
        check(r.keep.shape[0] == 2, f"keep shape {tuple(r.keep.shape)}")
    kept = [int(r.keep.sum()) for r in results]
    check(min(kept) > 0, f"no detections kept: {kept}")
    return kept


def rel_rms(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).pow(2).mean() / want.pow(2).mean()).sqrt().item()


def kept_match(results, refs) -> float:
    """Share of the reference's kept boxes that a kept box of ``results``
    matches (same category, BEV centre within 1 m)."""
    import torch

    matched = total = 0
    for r, ref in zip(results, refs):
        for i in range(ref.keep.shape[0]):
            kr, kg = ref.keep[i], r.keep[i]
            if not kr.any():
                continue
            d = torch.cdist(ref.cuboids[i][kr][:, :2], r.cuboids[i][kg][:, :2])
            same = ref.categories[i][kr][:, None] == r.categories[i][kg][None]
            matched += int(((d < 1.0) & same).any(1).sum()) if kg.any() else 0
            total += int(kr.sum())
    return matched / max(total, 1)


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


def k3_shape_cost(key, B, H, in_bytes=1, out_bytes=2):
    """(operations, bytes) of one K3 launch at (Cin, Cout, W, stride): the
    input read once at ``in_bytes`` an element (2 for the bf16 activation
    that the fused form quantizes, 1 for int8), weights, dq and the scale,
    and the output written once."""
    cin, cout, W, stride = key
    wo = (W - 1) // stride + 1
    ops = 2 * B * H * wo * 9 * cin * cout
    nbytes = (in_bytes * B * H * W * cin + 9 * cin * cout + 4 * cout + 4
              + out_bytes * B * H * wo * cout)
    return ops, nbytes


def int8_phases(predictor, requests, bf16_results, bf16_heads, cfg, dec, device,
                gen, smi) -> list:
    """Phases 7-11: K3 at odd shapes, the int8 path with the K1 stem and
    with the K4 stem, K3/K4 against their twins on the path's inputs, and
    timings. Returns the K3 and K4 entries of the kernels line."""
    import torch
    import torch.nn.functional as F

    from range_view_3d_detection_torch.kernels.conv import (
        conv3x3_i8_fused,
        conv3x3_i8_fused_plain,
        quantize_to_int8,
    )
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.kernels.stem import (
        meta_kernel_fused,
        meta_kernel_fused_i8,
        meta_kernel_fused_i8_plain,
    )
    from range_view_3d_detection_torch.models import blocks, quantized, stems

    def rand_i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(device)

    def k3_equal(x, w, dq, stride, tag, in_scale=None) -> float:
        """K3 == its twin (torch.equal) in bf16 and fp32 output."""
        err = 0.0
        for dt in (torch.bfloat16, torch.float32):
            kw = dict(stride_w=stride, out_dtype=dt, in_scale=in_scale)
            got = conv3x3_i8_fused(x, w, dq, **kw)
            want = conv3x3_i8_fused_plain(x, w, dq, **kw)
            torch.cuda.synchronize()
            n_diff = int((got != want).sum())
            check(torch.equal(got, want), f"K3 {tag} {dt}: {n_diff} elements differ")
            err = max(err, (got.float() - want.float()).abs().max().item())
        form = "int8" if in_scale is None else f"{x.dtype} + in_scale"
        say(f"K3 {tag} ({form}): bf16 and fp32 outputs equal to the twin")
        return err

    # 7. K3 against its twin at small odd shapes, in both operand forms: odd
    # H (4 rows a block), W below and above the 64-pixel tile, Cin 32/64,
    # Cout 16/32/48 (one ragged 128-channel tile) and 256/512 (several);
    # activations on the .5 rounding boundaries (scale 2^-6) and beyond
    # +-127.5 scales (clamp).
    for shape, cout, stride in (((1, 5, 33, 32), 32, 1), ((1, 6, 18, 32), 32, 2),
                                ((2, 7, 37, 64), 48, 1), ((1, 5, 131, 32), 16, 2),
                                ((1, 3, 70, 64), 48, 1), ((1, 5, 70, 32), 512, 1),
                                ((2, 3, 37, 64), 256, 2)):
        dq = torch.rand(cout, generator=gen).to(device) * 1e-3 + 1e-4
        w = rand_i8(9, shape[-1], cout)
        tag = f"{shape}->{cout} stride {stride}"
        k3_equal(rand_i8(*shape), w, dq, stride, tag)
        ties = torch.randint(-300, 301, shape, generator=gen).float() / 2 / 64
        for dt in (torch.bfloat16, torch.float32):
            k3_equal(ties.to(device, dt), w, dq, stride, tag + " ties/clamp",
                     in_scale=torch.tensor(2.0**-6, device=device))
            xr = torch.randn(shape, generator=gen) * 0.9
            k3_equal(xr.to(device, dt), w, dq, stride, tag + " randn",
                     in_scale=torch.tensor(0.0173, device=device))
    # The fused quantizer alone (centre tap = identity, dq = 1, fp32 out)
    # equals quantize_to_int8 on every finite bf16 value and on fp32 values
    # within 3 ulps of every half-integer multiple of the scale.
    eye = torch.zeros(9, 32, 32, dtype=torch.int8)
    eye[4] = torch.eye(32, dtype=torch.int8)
    eye, ones = eye.to(device), torch.ones(32, device=device)
    bits = torch.arange(65536, dtype=torch.int32)
    all_bf16 = bits[((bits >> 7) & 0xFF) != 0xFF].to(torch.int16).view(torch.bfloat16)
    # 2^-70 and 2^70 lie outside the Markstein division's range and take
    # the kernel's div.rn path.
    n_checked = 0
    scales = (2.0**-6, 0.0173, 1 / 3, 3.7, 123.456, 2.0**-70, 2.0**70)
    for sc in scales:
        base = ((torch.randint(-130, 130, (100000,), generator=gen).double() + 0.5)
                * sc).float()
        near = [base]
        for step in (float("inf"), float("-inf")):
            v = base
            for _ in range(3):
                v = torch.nextafter(v, torch.tensor(step))
                near.append(v)
        for vals in (all_bf16, torch.cat(near)):
            vals = vals[: vals.numel() // 32 * 32].reshape(1, 1, -1, 32).to(device)
            scale = torch.tensor(sc, device=device)
            got = conv3x3_i8_fused(vals, eye, ones, out_dtype=torch.float32,
                                   in_scale=scale)
            want = quantize_to_int8(vals, scale).float()
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"K3 quantizer s={sc} {vals.dtype}: "
                  f"{int((got != want).sum())} values differ")
            n_checked += vals.numel()
    say(f"K3 fused quantizer: {n_checked} values (every finite bf16, fp32 near "
        f"every rounding boundary) at {len(scales)} scales equal quantize_to_int8")

    # 8. The int8 path: fold, calibrate on request 0, quantize (full scope).
    model = predictor.model
    op_names = ("aten::div", "aten::round", "aten::clamp", "aten::copy_")
    bf16_ops = count_ops(predictor, requests[1], op_names)
    t0 = time.perf_counter()
    predictor.quantize([requests[0]], scope="full")
    torch.cuda.synchronize()
    say(f"int8: folded, calibrated on request 0 and quantized "
        f"in {time.perf_counter() - t0:.1f} s")
    captured = {}
    k3_in = dict(launches=0, unquantized=0, nhwc_contiguous=0)

    def capturing(x, w, dq, *, stride_w=1, out_dtype=torch.bfloat16, in_scale=None):
        key = (x.shape[-1], w.shape[-1], x.shape[2], stride_w)
        entry = captured.setdefault(key, dict(
            inputs=(x.clone(), w, dq.clone(), in_scale), out_dtype=out_dtype,
            per_request=0))
        entry["per_request"] += 1
        k3_in["launches"] += 1
        k3_in["unquantized"] += int(in_scale is not None and x.dtype != torch.int8)
        k3_in["nhwc_contiguous"] += int(x.is_contiguous())
        return conv3x3_i8_fused(x, w, dq, stride_w=stride_w, out_dtype=out_dtype,
                                in_scale=in_scale)

    blocks.conv3x3_i8_fused = quantized.conv3x3_i8_fused = capturing
    try:
        predictor(*requests[0])  # warm-up, and one request's K3 inputs
    finally:
        blocks.conv3x3_i8_fused = quantized.conv3x3_i8_fused = conv3x3_i8_fused
    torch.cuda.synchronize()
    dtypes = sorted({str(e["inputs"][0].dtype) for e in captured.values()})
    say(f"K3 inputs of one int8 request: {k3_in['launches']} launches, "
        f"{k3_in['unquantized']} given the unquantized activation ({', '.join(dtypes)}) "
        f"and in_scale, {k3_in['nhwc_contiguous']} NHWC-contiguous (no copy)")
    check(k3_in["unquantized"] == k3_in["launches"] == k3_in["nhwc_contiguous"],
          f"a K3 input was quantized or copied before the launch: {k3_in}")

    def serve(tag):
        for fn in (meta_kernel_fused, meta_kernel_fused_i8, nms_scan, conv3x3_i8_fused):
            fn.launches = 0
        t0 = time.perf_counter()
        results = [predictor(*r) for r in requests]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(requests)
        launches = {"K1": meta_kernel_fused.launches, "K2": nms_scan.launches,
                    "K3": conv3x3_i8_fused.launches, "K4": meta_kernel_fused_i8.launches}
        kept = check_results(results)
        nms_err = check_nms_against_plain(model, requests[0], cfg, dec, device)
        with torch.inference_mode():
            head = model(*(torch.as_tensor(a, device=device) for a in requests[0]))
        rms = {k: rel_rms(head["head"][1][0][k], v) for k, v in bf16_heads.items()}
        say(f"{tag}: {len(requests)} requests, launches {launches}, kept {kept}, "
            f"NMS == plain scan (cuboids max|diff| {nms_err:.3g}); head relative "
            f"RMS to bf16 " + ", ".join(f"{k} {v:.4g}" for k, v in rms.items())
            + f"; bf16 kept boxes matched {kept_match(results, bf16_results):.3f}, "
            f"int8 kept boxes matched by bf16 {kept_match(bf16_results, results):.3f}; "
            f"{ms:.3f} ms/request, {2 * 1e3 / ms:.2f} frames/s on {smi}")
        return launches, ms

    launches, int8_ms = serve("int8 path (K1 stem)")
    check(launches["K1"] > 0 and launches["K2"] > 0 and launches["K3"] > 0,
          f"a kernel of the int8 path did not run: {launches}")
    check(launches["K4"] == 0, f"K4 ran with stem_int8=False: {launches}")
    k3_launches = launches["K3"]
    per_request = sum(e["per_request"] for e in captured.values())
    check(k3_launches == per_request * len(requests),
          f"K3 launches {k3_launches} != {per_request} per request x {len(requests)}")

    # 9. K3 against its twin on every distinct shape of the request, in both
    # operand forms; times (CUDA events around eager launches, as for the
    # other kernels, and CUDA-graph replay beside them), bounds, shares.
    B, H = requests[0][0].shape[:2]
    sums = dict(eager=0.0, graph=0.0, i8=0.0, plain=0.0, ops_ms=0.0, bytes_ms=0.0,
                bound=0.0)
    k3_err = 0.0
    for key in sorted(captured):
        e = captured[key]
        x, w, dq, s_in = e["inputs"]
        cin, cout, W, stride = key
        tag = f"Cin {cin} Cout {cout} W {W} stride {stride}"
        xq = quantize_to_int8(x, s_in)
        k3_err = max(k3_err, k3_equal(x, w, dq, stride, tag, in_scale=s_in),
                     k3_equal(xq, w, dq, stride, tag))
        run = dict(stride_w=stride, out_dtype=e["out_dtype"])
        fused = dict(run, in_scale=s_in)
        eager = cuda_ms(lambda: conv3x3_i8_fused(x, w, dq, **fused), reps=10)
        graph = graph_ms(lambda: conv3x3_i8_fused(x, w, dq, **fused))
        i8_ms = graph_ms(lambda: conv3x3_i8_fused(xq, w, dq, **run))
        plain = cuda_ms(lambda: conv3x3_i8_fused_plain(x, w, dq, **fused), reps=2, warmup=1)
        out_bytes = 2 if e["out_dtype"] == torch.bfloat16 else 4
        ops, nbytes = k3_shape_cost(key, B, H, x.element_size(), out_bytes)
        bound, by = bound_ms(ops, H100_INT8_OPS, nbytes)
        i8_bound = bound_ms(ops, H100_INT8_OPS,
                            k3_shape_cost(key, B, H, 1, out_bytes)[1])[0]
        n = e["per_request"]
        sums["eager"] += n * eager
        sums["graph"] += n * graph
        sums["i8"] += n * i8_ms
        sums["plain"] += n * plain
        sums["bound"] += n * bound
        sums["ops_ms"] += n * ops / H100_INT8_OPS * 1e3
        sums["bytes_ms"] += n * nbytes / H100_BYTES_PER_S * 1e3
        say(f"K3 {tag}: {n} launches/request; {x.dtype} + in_scale: kernel "
            f"{eager:.4f} ms eager ({100 * bound / eager:.1f}% of bound), "
            f"{graph:.4f} ms graph replay ({100 * bound / graph:.1f}%, "
            f"{ops / graph / 1e9:.1f} TOP/s), bound {bound:.4f} ms ({by}); int8 form "
            f"{i8_ms:.4f} ms graph replay ({100 * i8_bound / i8_ms:.1f}% of its "
            f"bound); plain {plain:.3f} ms on {smi}")
    k3_by = "operations" if sums["ops_ms"] >= sums["bytes_ms"] else "bytes"
    say(f"K3 per request: {per_request} launches, kernel {sums['eager']:.3f} ms eager "
        f"({100 * sums['bound'] / sums['eager']:.1f}% of bound), {sums['graph']:.3f} ms "
        f"graph replay ({100 * sums['bound'] / sums['graph']:.1f}%; int8 form "
        f"{sums['i8']:.3f}), plain {sums['plain']:.3f} ms, bound {sums['bound']:.3f} ms "
        f"({k3_by}) on {smi}")
    # Context: a bf16 conv (cuDNN) at the costliest shape, the head towers.
    top = max(captured, key=lambda k: k3_shape_cost(k, B, H)[0])
    cin, cout, W, stride = top
    xc = torch.randn((B, cin, H, W), generator=gen).to(
        device, torch.bfloat16, memory_format=torch.channels_last)
    wc = (torch.randn((cout, cin, 3, 3), generator=gen) * 0.02).to(
        device, torch.bfloat16, memory_format=torch.channels_last)
    cudnn_ms = cuda_ms(lambda: F.conv2d(xc, wc, stride=(1, stride), padding=1), reps=10)
    say(f"context: bf16 cuDNN conv {cin}->{cout} 3x3 stride {stride} at "
        f"{B}x{H}x{W}: {cudnn_ms:.4f} ms (bound "
        f"{k3_shape_cost(top, B, H)[0] / H100_BF16_FLOPS * 1e3:.4f} ms at the bf16 "
        f"peak) on {smi}")
    del xc, wc, captured
    with torch.inference_mode():
        profile_request(predictor, requests[1])
    int8_ops = count_ops(predictor, requests[1], op_names)
    n_1x1 = sum(isinstance(m, quantized.Int8Conv) and m.route == "matmul"
                for m in model.modules())
    say("ops in one request, bf16 path -> int8 path (K1 stem): "
        + ", ".join(f"{k} {bf16_ops[k]} -> {int8_ops[k]}" for k in op_names)
        + f"; the int8 path's 1x1 convs quantize in torch ops ({n_1x1} of them), "
        f"K3's {per_request} launches quantize in the kernel")

    # 10. The int8 path with the int8 stem (K4).
    predictor.quantize(quant_tree=predictor.quant_tree, stem_int8=True)
    k4_cap = {}

    def capturing_k4(*args):
        k4_cap.setdefault("args", [a.clone() for a in args])
        return meta_kernel_fused_i8(*args)

    stems.meta_kernel_fused_i8 = capturing_k4
    try:
        predictor(*requests[0])  # warm-up, and the stem's K4 inputs
    finally:
        stems.meta_kernel_fused_i8 = meta_kernel_fused_i8
    launches, int8_stem_ms = serve("int8 path (K4 stem)")
    check(launches["K4"] > 0 and launches["K1"] == 0,
          f"stem_int8=True: K4 must run and K1 not: {launches}")
    k4_launches = launches["K4"]
    k4_args = k4_cap["args"]
    names = ("g", "feats", "w1_i8", "k_i8", "a0", "b0", "a1", "b1", "kdq")
    k4_flagship = dict(zip(names, k4_args))
    # A small ragged crop of the same inputs: edges and a partial tile.
    crop = dict(k4_flagship, g=k4_args[0][:1, :3, :37].contiguous(),
                feats=k4_args[1][:1, :3, :37].contiguous())
    gen_k4 = torch.Generator().manual_seed(SEED + 4)
    waymo = (2, 64, 2656, 128)
    k4_waymo = k4_inputs(*waymo, gen_k4, device)
    cases = [("flagship (captured)", k4_flagship), ("crop", crop), ("Waymo stem", k4_waymo)]
    cases += [(f"{shape}", k4_inputs(*shape, gen_k4, device))
              for shape in ((2, 32, 256, 32), (1, 3, 37, 96), (1, 3, 37, 160))]
    cases += [(f"edge case {shape}", k4_edge_case(*shape, gen_k4, device))
              for shape in ((2, 4, 100, 256), (1, 3, 70, 128))]
    k4_err = 0.0
    for tag, args in cases:
        got = meta_kernel_fused_i8(**args)
        want = meta_kernel_fused_i8_plain(**args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        n_diff = int((got != want).sum())
        check(bool(torch.isfinite(got).all()), f"K4 non-finite at {tag}")
        check(err <= 1e-4 * ref, f"K4 {tag}: max|diff| {err} > 1e-4 * {ref}")
        say(f"K4 {tag} {tuple(args['g'].shape)}: max|diff| {err:.4g} (max|ref| "
            f"{ref:.4g}), {n_diff} of {got.numel()} elements differ; ok")
        k4_err = max(k4_err, err)
    for bad in (48, 288):
        try:
            meta_kernel_fused_i8(**k4_inputs(1, 1, 64, bad, gen_k4, device))
        except RuntimeError as e:
            say(f"K4 C={bad}: refused ({e})")
        else:
            check(False, f"K4 C={bad}: the kernel accepted it")
    k4_ms = cuda_ms(lambda: meta_kernel_fused_i8(*k4_args), reps=10)
    k4_graph_ms = graph_ms(lambda: meta_kernel_fused_i8(*k4_args))
    k4_plain_ms = cuda_ms(lambda: meta_kernel_fused_i8_plain(*k4_args), reps=2, warmup=1)
    k4_waymo_ms = cuda_ms(lambda: meta_kernel_fused_i8(**k4_waymo), reps=10)
    k4_waymo_graph_ms = graph_ms(lambda: meta_kernel_fused_i8(**k4_waymo))
    k4_bound, k4_by = bound_ms(*k4_cost(*k4_args[0].shape))
    waymo_bound = bound_ms(*k4_cost(*waymo))[0]
    say(f"K4 flagship: kernel {k4_ms:.4f} ms eager ({100 * k4_bound / k4_ms:.1f}% of "
        f"bound), {k4_graph_ms:.4f} ms graph replay ({100 * k4_bound / k4_graph_ms:.1f}%), "
        f"plain {k4_plain_ms:.3f} ms, bound {k4_bound:.4f} ms ({k4_by}); Waymo stem "
        f"{waymo}: {k4_waymo_ms:.4f} ms eager, {k4_waymo_graph_ms:.4f} ms graph replay, "
        f"bound {waymo_bound:.4f} ms on {smi}")

    with torch.inference_mode():
        profile_request(predictor, requests[1])

    # 11. Summary of the int8 paths.
    say(f"int8 path: K1 stem {int8_ms:.3f} ms/request ({2e3 / int8_ms:.2f} frames/s), "
        f"K4 stem {int8_stem_ms:.3f} ms/request ({2e3 / int8_stem_ms:.2f} frames/s), "
        f"B=2 on {smi}")
    return [
        {
            "name": "conv3x3_i8_fused", "route": "cuda",
            "source": "range_view_3d_detection_torch/csrc/conv3x3_i8.cu",
            "replaces": "range_view_3d_detection_tpu/kernels/conv_pallas.py:150",
            "launches": k3_launches, "max_abs_err": k3_err,
            "ms": sums["eager"], "graph_ms": sums["graph"], "plain_ms": sums["plain"],
            "bound_ms": sums["bound"], "bound_by": k3_by, "library_ms": None,
        },
        {
            "name": "meta_kernel_fused_i8", "route": "cuda",
            "source": "range_view_3d_detection_torch/csrc/meta_kernel_fused_i8.cu",
            "replaces": "range_view_3d_detection_tpu/kernels/stem_pallas.py:176",
            "launches": k4_launches, "max_abs_err": k4_err,
            "ms": k4_ms, "graph_ms": k4_graph_ms, "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None,
        },
    ]


def flagship_train_batch(cfg, B, H, W, seed, n_boxes=64):
    """A flagship training batch: ``_sample_inputs`` and ``n_boxes`` valid
    boxes of ``cfg.max_boxes`` slots an image, centred on seeded valid
    returns, l, w, h in [0.5, 6] m, yaw in [-pi, pi), categories seeded."""
    import numpy as np

    from range_view_3d_detection_torch import serving

    rng = np.random.default_rng(seed)
    feats, cart, mask = serving._sample_inputs(B, H, W, cfg.in_channels, seed=seed)
    K = cfg.max_boxes
    boxes = np.zeros((B, K, 7), np.float32)
    valid = np.zeros((B, K), bool)
    for b in range(B):
        ys, xs = np.nonzero(mask[b])
        pick = rng.choice(len(ys), n_boxes, replace=False)
        boxes[b, :n_boxes, :3] = cart[b, ys[pick], xs[pick]]
        boxes[b, :n_boxes, 3:6] = rng.uniform(0.5, 6.0, (n_boxes, 3))
        boxes[b, :n_boxes, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
        valid[b, :n_boxes] = True
    n_cats = len(cfg.tasks_dict[0])
    return {
        "features": feats, "cart": cart, "mask": mask, "boxes": boxes,
        "box_valid": valid, "box_task": np.zeros((B, K), np.int32),
        "box_offset": rng.integers(0, n_cats, (B, K)).astype(np.int32),
    }


def running_stats(model) -> dict:
    """Every BatchNorm running statistic of ``model``, by name."""
    ends = ("running_mean", "running_var", "_bn_mean", "_bn_var")
    return {n: b for n, b in model.named_buffers() if n.endswith(ends)}


def train_card_vs_cpu(cfg, device) -> None:
    """Phase 12: one train step at the flagship's channel widths and depth
    in fp32 on (2, 4, 64), on the card and on the CPU from the same
    weights.

    Gates: the loss and every metric (``grad_norm`` among them) within
    1e-4 relative; running statistics within 1e-5 of each leaf's max;
    parameters within 1e-5 of each leaf's max plus twice the step's
    learning rate (AdamW's first step is about lr * sign(g), so an element
    whose gradient is within the devices' rounding of 0 can move either
    way), 98% of the elements within 1e-5 of the max plus 1% of lr.
    Gradient leaves: this randomly initialised model amplifies rounding
    (a 1e-7 relative change of the input features moves some leaves of
    the CPU's own gradient by about 1% of their max), so a leaf is not
    held to 1e-3 of its max; instead the median leaf must be within 2e-3
    of its max, and the worst within 1e-3 plus twice the worst move of
    the CPU's gradient under that input change (a third step, on the CPU).
    """
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.training import optim, state as state_lib

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = serving._dryrun_batch(cfg32, 2, 4, 64, cfg32.in_channels)
    noisy = dict(batch)
    rng = np.random.default_rng(SEED + 14)
    noisy["features"] = batch["features"] * (
        1 + 1e-7 * rng.standard_normal(batch["features"].shape)
    ).astype(np.float32)
    tx, schedule = optim.make_optimizer(1e-3, 10)
    lr = schedule(0)
    runs = []
    for dev, b in (("cpu", batch), (device, batch), ("cpu", noisy)):
        st = state_lib.create_state(
            cfg32, tx, device=dev, generator=torch.Generator().manual_seed(SEED + 10)
        )
        grads = []
        st, metrics = state_lib.make_train_step(cfg32)(st, b, grads_out=grads)
        runs.append((st, metrics, grads))
    (cpu, m_cpu, g_cpu), (card, m_card, g_card), (_, _, g_noise) = runs
    worst_metric = 0.0
    for k, v in m_cpu.items():
        want, got = float(v), float(m_card[k])
        check(abs(got - want) <= 1e-4 * abs(want), f"train card vs CPU: {k} {got} != {want}")
        worst_metric = max(worst_metric, abs(got - want) / max(abs(want), 1e-30))
    e_card, e_noise = [], []
    for a, b, c in zip(g_card, g_cpu, g_noise):
        scale = max(b.abs().max().item(), 1e-30)
        e_card.append((a.cpu() - b).abs().max().item() / scale)
        e_noise.append((c - b).abs().max().item() / scale)
    med = statistics.median(e_card)
    check(med <= 2e-3, f"train card vs CPU: median gradient leaf off by {med:.3g} of its max")
    check(max(e_card) <= 1e-3 + 2 * max(e_noise),
          f"train card vs CPU: a gradient leaf off by {max(e_card):.3g} of its max, "
          f"the CPU's own under input noise {max(e_noise):.3g}")
    worst_stat = 0.0
    card_stats = running_stats(card.model)
    for n, b in running_stats(cpu.model).items():
        err = (card_stats[n].cpu() - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        check(err <= 1e-5, f"train card vs CPU: running statistic {n} off by {err:.3g}")
        worst_stat = max(worst_stat, err)
    within = total = 0
    worst_param = 0.0
    card_params = dict(card.model.named_parameters())
    for n, p in cpu.model.named_parameters():
        d = (card_params[n].detach().cpu() - p.detach()).abs()
        scale = p.detach().abs().max().item()
        check(d.max().item() <= 1e-5 * scale + 2 * lr,
              f"train card vs CPU: parameter {n} off by {d.max().item():.3g}")
        within += int((d <= 1e-5 * scale + 1e-2 * lr).sum())
        total += d.numel()
        worst_param = max(worst_param, d.max().item() / lr)
    check(within >= 0.98 * total, f"train card vs CPU: {within} of {total} parameters close")
    say(f"train card vs CPU (flagship widths and depth, fp32, (2, 4, 64)): loss "
        f"{float(m_card['loss']):.7f} vs {float(m_cpu['loss']):.7f}, grad_norm "
        f"{float(m_card['grad_norm']):.6f} vs {float(m_cpu['grad_norm']):.6f}; worst metric "
        f"{worst_metric:.3g} relative; gradient leaves off by {statistics.median(e_card):.3g} "
        f"of their max in the median, {max(e_card):.3g} at worst (the CPU's own under 1e-7 "
        f"input noise: {statistics.median(e_noise):.3g}, {max(e_noise):.3g}); running "
        f"statistics {worst_stat:.3g}; parameters {worst_param:.3g} lr at worst, {within} "
        f"of {total} within 1e-5 of the max + 0.01 lr; ok")


def trained_stem_args(model, batch) -> dict:
    """K1's operands as the trained model's eval stem builds them."""
    import torch

    stem = model.RangeNet_0.MetaKernel_0
    dt = stem.dtype
    with torch.inference_mode():
        f = batch["features"].permute(0, 3, 1, 2).to(dt)
        feats = stem.BasicBlock_0(f).permute(0, 2, 3, 1)
        g = batch["cart"].to(dt) @ stem.pos_0_conv_kernel.to(dt)
        a0, b0 = stem.bn_eval_affine(0)
        a1, b1 = stem.bn_eval_affine(1)
        return dict(g=g, feats=feats, w1=stem.pos_1_conv_kernel.to(dt),
                    k=stem.fusion1_kernel.to(dt), a0=a0, b0=b0, a1=a1, b1=b1)


def profile_train_step(step, state, batch) -> None:
    """Print the device time of one train step by kernel (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(
        e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
    ) / 1e3
    say(events.table(sort_by="self_device_time_total", row_limit=30))
    say(f"profile: train step wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")


def training_phases(device, smi) -> float:
    """Phases 12-16: the training step (see the module docstring). Returns
    phase 16's ms a step."""
    import statistics
    import tempfile

    import torch

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.kernels.stem import (
        meta_kernel_fused,
        meta_kernel_fused_plain,
    )
    from range_view_3d_detection_torch.models.decoder import DecoderConfig
    from range_view_3d_detection_torch.training import optim, state as state_lib
    from range_view_3d_detection_torch.training.checkpoints import CheckpointManager

    cfg = serving._flagship_config()
    # 12. The step on the card against the step on the CPU.
    train_card_vs_cpu(cfg, device)

    # 13. Six flagship steps: bf16, K1's config, 256 box slots, B=2 64x1808.
    batch = state_lib.batch_to_device(
        flagship_train_batch(cfg, 2, 64, 1808, seed=SEED + 11), device
    )
    tx, _ = optim.make_optimizer(1e-3, 10, debug=True)
    gen = torch.Generator().manual_seed(SEED + 12)
    st = state_lib.create_state(cfg, tx, device=device, generator=gen)
    params0 = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    stats0 = {n: b.clone() for n, b in running_stats(st.model).items()}
    step = state_lib.make_train_step(cfg)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    for i in range(6):
        st, metrics = step(st, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        say(f"train step {i + 1}: loss {loss:.6f}, grad_norm {gnorm:.4f}, "
            f"classification {float(metrics['classification_loss']):.6f}, "
            f"regression {float(metrics['regression_loss']):.6f}, "
            f"foreground pixels {float(metrics['total_fg']):.0f}, "
            f"objects {float(metrics['total_objects']):.0f}")
        check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
              f"train step {i + 1}: loss {loss}, grad_norm {gnorm}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    still = [n for n, p in st.model.named_parameters() if torch.equal(p.detach(), params0[n])]
    check(not still, f"parameters unchanged after 6 steps: {still[:5]}")
    still = [n for n, b in running_stats(st.model).items() if torch.equal(b, stats0[n])]
    check(not still, f"running statistics unchanged after 6 steps: {still[:5]}")
    say(f"train: 6 flagship steps (bf16, B=2, 64x1808, 64 boxes of 256 an image); all "
        f"{len(params0)} parameter leaves and {len(stats0)} running statistics changed; "
        f"peak memory {peak_gb:.2f} GiB (allocated before the steps {base_gb:.2f} GiB) "
        f"on {smi}")

    # 14. Eval and val steps on the trained state: K1 and K2 launch, K1 agrees
    # with its twin on the trained affines, the NMS with the plain scan.
    dec = DecoderConfig()
    eval_step = state_lib.make_eval_step(cfg, dec)
    val_step = state_lib.make_val_step(cfg, dec)
    meta_kernel_fused.launches = 0
    nms_scan.launches = 0
    result = eval_step(st, batch)
    val_result, val_metrics = val_step(st, batch)
    torch.cuda.synchronize()
    launches = {"K1": meta_kernel_fused.launches, "K2": nms_scan.launches}
    check(launches["K1"] > 0 and launches["K2"] > 0, f"eval/val launches {launches}")
    for r in (result, val_result):
        for t in (r.cuboids, r.scores):
            check(bool(torch.isfinite(t[r.keep]).all()), "eval: non-finite detections")
    bad = [k for k, v in val_metrics.items() if not math.isfinite(float(v))]
    check(not bad, f"val metrics not finite: {bad}")
    x = trained_stem_args(st.model, batch)
    with torch.inference_mode():
        got, want = meta_kernel_fused(**x), meta_kernel_fused_plain(**x)
    torch.cuda.synchronize()
    k1_err, k1_ref = (got - want).abs().max().item(), want.abs().max().item()
    check(k1_err <= 2e-2 * k1_ref, f"K1 trained affines: max|diff| {k1_err} > 2e-2 * {k1_ref}")
    request = (batch["features"], batch["cart"], batch["mask"])
    nms_err = check_nms_against_plain(st.model, request, cfg, dec, device)
    dec_all = DecoderConfig(min_confidence=0.0)
    nms_err_all = check_nms_against_plain(st.model, request, cfg, dec_all, device)
    say(f"eval/val on the trained state: launches {launches}, kept "
        f"{[int(k) for k in result.keep.sum(-1)]}, val/loss "
        f"{float(val_metrics['val/loss']):.6f}; K1 on the trained affines max|diff| "
        f"{k1_err:.4g} (max|ref| {k1_ref:.4g}); NMS == plain scan (min_confidence "
        f"{dec.min_confidence}: {nms_err:.3g}; 0.0: {nms_err_all:.3g}); ok")

    # 15. Checkpoint round trip on the card, bit for bit.
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=2)
        t0 = time.perf_counter()
        mgr.save(st.step, st, {"config": "flagship", "steps": st.step})
        save_s = time.perf_counter() - t0
        other = state_lib.create_state(cfg, tx, device=device,
                                       generator=torch.Generator().manual_seed(SEED + 13))
        t0 = time.perf_counter()
        restored, config = mgr.restore(other)
        restore_s = time.perf_counter() - t0
        size_mb = sum(f.stat().st_size for f in Path(tmp).iterdir()) / 2**20
    want_sd, got_sd = st.model.state_dict(), restored.model.state_dict()
    check(sorted(want_sd) == sorted(got_sd), "checkpoint: model keys differ")
    check(all(torch.equal(want_sd[k], got_sd[k]) for k in want_sd),
          "checkpoint: a model tensor differs")
    want_opt, got_opt = st.opt.adamw.state_dict()["state"], restored.opt.adamw.state_dict()["state"]
    check(sorted(want_opt) == sorted(got_opt) and all(
        torch.equal(v.cpu(), got_opt[i][k].cpu()) for i, s in want_opt.items() for k, v in s.items()
    ), "checkpoint: an optimizer tensor differs")
    check(restored.step == st.step and restored.opt.updates == st.opt.updates
          and config["steps"] == st.step, "checkpoint: step counts differ")
    say(f"checkpoint: {size_mb:.1f} MiB, saved in {save_s:.2f} s, restored in "
        f"{restore_s:.2f} s, equal bit for bit; ok")
    del other, restored

    # 16. Timings: ms a train step (2 warm-up, median of 7) split by part,
    # ms an eval step, a profile of one step.
    total, split, st = step_split(step, st, batch, n=9)
    eval_ms = cuda_ms(lambda: eval_step(st, batch), reps=5)
    profile_train_step(step, st, batch)
    say(f"train step: {total:.3f} ms (CUDA events, median of 7 after 2 warm-up) = "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" ms; eval step {eval_ms:.3f} ms; peak memory {peak_gb:.2f} GiB; B=2 64x1808 "
        f"bf16 on {smi}")
    return total


def timed_trainer(trainer) -> dict:
    """Wrap ``trainer``'s step (CUDA events around it, a synchronize after
    it, the host clock at its end) and its image logging (host clock), so
    that a step's wall time, less the image logging inside it, splits into
    device time and the data path's stall. Returns the record lists."""
    import torch

    rec = {"device_ms": [], "end_s": [], "images_s": [], "losses": []}
    step, log_images = trainer.train_step, trainer._log_images

    def timed_step(state, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        rec["end_s"].append(time.perf_counter())
        rec["device_ms"].append(start.elapsed_time(end))
        rec["losses"].append(float(metrics["loss"]))
        return state, metrics

    def timed_images(*args):
        t0 = time.perf_counter()
        log_images(*args)
        rec["images_s"].append((len(rec["end_s"]), time.perf_counter() - t0))

    trainer.train_step, trainer._log_images = timed_step, timed_images
    return rec


def loader_split(trainer) -> dict:
    """Host ms a flagship train batch spends in each stage of the data
    path, serially (the loader's threads hide it behind the step): Feather
    decode of the sweeps, the rest of ``load_sweep``, the rest of an item
    (annotations, augmentations, padding), ``collate``, and the copy to
    the card through pinned memory."""
    import torch

    from range_view_3d_detection_torch.data.dataset import collate
    from range_view_3d_detection_torch.utils.feather import read_feather

    ds, B = trainer.train_ds, trainer.batch_size
    t = {"feather": 0.0, "load_sweep": 0.0, "item": 0.0, "collate": 0.0, "h2d": 0.0}
    n_batches = len(ds) // B
    for b in range(n_batches):
        items = []
        for i in range(b * B, (b + 1) * B):
            log_id, ts = ds.index[i]
            t0 = time.perf_counter()
            read_feather(ds.sweep_path(log_id, ts))
            t1 = time.perf_counter()
            ds.load_sweep(log_id, ts)
            t2 = time.perf_counter()
            items.append(ds[i])
            t3 = time.perf_counter()
            t["feather"] += t1 - t0
            t["load_sweep"] += (t2 - t1) - (t1 - t0)
            t["item"] += (t3 - t2) - (t2 - t1)
        t0 = time.perf_counter()
        batch = collate(items)
        t1 = time.perf_counter()
        trainer._to_device(batch)
        torch.cuda.synchronize()
        t["collate"] += t1 - t0
        t["h2d"] += time.perf_counter() - t1
    return {k: v * 1e3 / n_batches for k, v in t.items()}


def write_av2_corpus(root: Path, train_sweeps: int, categories) -> None:
    """Phase 17's corpus: one train log of ``train_sweeps`` and one val log
    of 4 sweeps at 64x1800 in the AV2 layout, 24 boxes a sweep."""
    from range_view_3d_detection_torch.data.synthetic import generate_dataset

    for split, sweeps, seed in (("train", train_sweeps, SEED + 17), ("val", 4, SEED + 18)):
        generate_dataset(root, splits={split: 1}, sweeps_per_log=sweeps, height=64,
                         width=1800, categories=categories, num_boxes=24,
                         num_bg_points=60000, seed=seed)


def trainer_phase(device, smi) -> dict:
    """Phase 17: the Trainer at the flagship (see the module docstring).
    Returns the launches of K1 and K2 in its fit and validate, and its
    work directory, whose corpus phase 23 trains on."""
    import tempfile

    import numpy as np
    import torch

    from range_view_3d_detection_torch.evaluation.av2_eval import evaluate_predictions
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.kernels.stem import meta_kernel_fused
    from range_view_3d_detection_torch.training import state as state_lib
    from range_view_3d_detection_torch.training.loop import Trainer
    from range_view_3d_detection_torch.utils.config import compose
    from range_view_3d_detection_torch.utils.feather import read_feather
    from range_view_3d_detection_torch.utils.rendering import read_png

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-trainer-"))
    categories = compose(REPO / "conf", "rv-av2")["model"]["tasks"][0]
    check(len(categories) == 26, f"rv-av2 has {len(categories)} categories")
    t0 = time.perf_counter()
    write_av2_corpus(work / "sensor", 16, categories)
    gen_s = time.perf_counter() - t0
    cfg = compose(REPO / "conf", "rv-av2", [
        f"++dataset.root_dir={work / 'sensor'}", f"++run_dir={work / 'run'}",
        "++trainer.max_epochs=1", "++model.batch_size=4", "++model.remat=true",
        "++model.train_log_freq=2",
    ])
    trainer = Trainer(cfg)  # the card: the default device
    check(trainer.device.type == "cuda" and trainer.ckpt is not None,
          f"trainer on {trainer.device}, checkpoints {trainer.ckpt}")
    check(trainer.det_cfg.remat and trainer.batch_size == 4 and trainer.world == 1,
          f"trainer remat {trainer.det_cfg.remat}, batch {trainer.batch_size}")
    check(trainer.train_ds.cfg.augmentations == cfg["model"]["augmentations_config"]
          and bool(cfg["model"]["augmentations_config"]), "flagship augmentations off")
    rec = timed_trainer(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    meta_kernel_fused.launches = 0
    nms_scan.launches = 0
    t_fit = time.perf_counter()
    state = trainer.fit()
    fit_s = time.perf_counter() - t_fit
    check(state.step == 4 and len(rec["losses"]) == 4, f"trainer: step {state.step}")
    check(all(math.isfinite(x) for x in rec["losses"]), f"trainer losses {rec['losses']}")
    # Wall time of steps 2-4, each less the image logging that ran in it.
    images = dict(rec["images_s"])
    walls = [(rec["end_s"][k] - rec["end_s"][k - 1] - images.get(k, 0.0)) * 1e3
             for k in (1, 2, 3)]
    device_ms = rec["device_ms"][1:]
    fit_launches = {"K1": meta_kernel_fused.launches, "K2": nms_scan.launches}

    # Checkpoint written by the fit, restored bit for bit.
    check(trainer.ckpt.latest_step() == 4, f"checkpoints {trainer.ckpt.steps()}")
    fresh = state_lib.create_state(trainer.det_cfg, trainer.tx, device=device,
                                   generator=torch.Generator().manual_seed(SEED + 19))
    restored, saved_cfg = trainer.ckpt.restore(fresh)
    want, got = state.model.state_dict(), restored.model.state_dict()
    check(sorted(want) == sorted(got) and all(torch.equal(want[k], got[k]) for k in want),
          "trainer checkpoint: a model tensor differs")
    check(restored.step == 4 and saved_cfg["run_dir"] == cfg["run_dir"],
          "trainer checkpoint: step or config differs")
    del fresh, restored

    # Logs and images.
    run = Path(cfg["run_dir"])
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    check(any(x.get("step") == 1 and "loss" in x for x in lines), "metrics.jsonl: no step 1")
    shapes = []
    for kind in ("bev", "range"):
        pngs = sorted((run / "images").glob(f"{kind}_*.png"))
        check([p.name for p in pngs] == [f"{kind}_{k:07d}.png" for k in (2, 4)],
              f"images: {[p.name for p in pngs]}")
        for p in pngs:
            img = read_png(p)
            check(img.ndim == 3 and img.shape[2] == 3 and img.size > 0, f"{p.name}: {img.shape}")
            shapes.append(img.shape[:2])

    # Validate: K1 and K2 launch, one shard per val sweep, read back.
    meta_kernel_fused.launches = 0
    nms_scan.launches = 0
    t0 = time.perf_counter()
    pred_dir = trainer.validate()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    val_launches = {"K1": meta_kernel_fused.launches, "K2": nms_scan.launches}
    check(val_launches["K1"] > 0 and val_launches["K2"] > 0, f"validate launches {val_launches}")
    shards = sorted(pred_dir.glob("*.feather"))
    check(len(shards) == len(trainer.val_ds) == 4, f"{len(shards)} shards")
    # Four steps from random weights: the eval-mode model's boxes may hold
    # inf or nan (running statistics still near their initial values);
    # they are counted, not gated.
    kept, nonfinite = 0, {}
    for f in shards:
        cols = read_feather(f)
        check(set(cols) >= {"tx_m", "score", "category", "log_id", "timestamp_ns"},
              f"{f.name}: columns {sorted(cols)}")
        check(set(cols["log_id"]) <= {f.stem.rsplit("_", 1)[0]},
              f"{f.name}: log_id {set(cols['log_id'])}")
        kept += len(cols["score"])
        for c in ("tx_m", "length_m", "qw", "score"):
            nonfinite[c] = nonfinite.get(c, 0) + int((~np.isfinite(cols[c])).sum())
    val_loss = [x["val/loss"] for x in (json.loads(y) for y in (run / "metrics.jsonl")
                .read_text().splitlines()) if "val/loss" in x]
    check(len(val_loss) == 1, f"val losses logged: {val_loss}")
    t0 = time.perf_counter()
    metrics = evaluate_predictions(pred_dir, work / "sensor" / "val", trainer.categories)
    eval_s = time.perf_counter() - t0
    avg = metrics["AVERAGE_METRICS"]
    check(all(math.isfinite(v) for v in avg.values()), f"AVERAGE_METRICS {avg}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    split = loader_split(trainer)
    n_val_batches = len(trainer.val_loader)
    say(f"trainer (phase 17): rv-av2 at B=4 with remat, 64x1800 (padded 1808), 26 classes, "
        f"augmentations on; corpus of 16 + 4 sweeps, 24 boxes a sweep, written in {gen_s:.1f} s; "
        f"losses {[round(x, 4) for x in rec['losses']]}; checkpoint of step 4 restored bit "
        f"for bit; {len(shapes)} PNGs decode {sorted(set(shapes))}; fit {fit_s:.2f} s "
        f"(launches {fit_launches}), validate {val_s * 1e3 / n_val_batches:.1f} ms a batch "
        f"({n_val_batches} batches, launches {val_launches}, {len(shards)} shards, {kept} "
        f"boxes, non-finite {nonfinite}, val/loss {val_loss}), evaluator {eval_s:.3f} s, AVERAGE_METRICS "
        + ", ".join(f"{k} {v:.4f}" for k, v in avg.items())
        + f"; peak memory {peak_gb:.2f} GiB on {smi}")
    say(f"trainer step wall ms (steps 2-4, image logging taken out) "
        f"{[round(w, 3) for w in walls]}, mean {statistics.mean(walls):.3f}; device ms "
        f"(CUDA events) {[round(d, 3) for d in device_ms]}, mean "
        f"{statistics.mean(device_ms):.3f}; stall (wall - device) "
        f"{statistics.mean(walls) - statistics.mean(device_ms):.3f} ms; image logging "
        f"{[round(t * 1e3, 1) for _, t in rec['images_s']]} ms")
    say("loader host ms a batch (B=4, serial; the loader's 2 threads run it beside the "
        "step): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f"; total {sum(split.values()):.2f} ms; phase {time.perf_counter() - t_phase:.0f} s")
    del trainer, state
    return {"fit": fit_launches, "validate": val_launches}, work


# Phase 18's gate, from the JAX package's own run of the same overfit on
# the CPU (``python tests/test_torch_trainer.py overfit av2 40 DIR``: the
# corpus and overrides of scripts/debug-overfit.sh, bf16, 40 epochs of one
# step): loss 0.7652 at step 1, 0.3643 at step 10, 0.3421 at 20, 0.2936 at
# 30, 0.3031 at 40; the mean of the last 10 steps 0.2984 (0.39 of the
# first); mAP 0.9916. At 100 epochs it rises again to a last-10 mean of
# 0.402 (mAP 0.9938): the constant debug rate overshoots, so the gate is
# taken at 40.
OVERFIT_EPOCHS = 40


def overfit_phase(device, smi) -> tuple:
    """Phase 18: the AV2 debug overfit, then the int8 accuracy cost on its
    weights, and phase 24. Returns the K3 launches of the int8 scoring,
    phase 24's launches, and the trained run for phase 35."""
    import tempfile

    import torch

    from range_view_3d_detection_torch import overfit
    from range_view_3d_detection_torch.kernels.conv import conv3x3_i8_fused
    from range_view_3d_detection_torch.kernels.nms import nms_scan

    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-overfit-"))
    out = overfit.run("av2", OVERFIT_EPOCHS, work)
    train_s = time.perf_counter() - t0
    losses, trainer = out["losses"], out["trainer"]
    last10 = statistics.mean(losses[-10:])
    check(len(losses) == OVERFIT_EPOCHS, f"overfit ran {len(losses)} steps")
    check(last10 <= 0.5 * losses[0], f"overfit: last-10 mean loss {last10} > half of "
          f"the first {losses[0]}")
    check(math.isfinite(out["mAP"]), f"overfit mAP {out['mAP']}")
    # The int8 PTQ predictor on the trained weights, scored the same way.
    conv3x3_i8_fused.launches = 0
    nms_scan.launches = 0
    predictor = overfit.int8_predictor(trainer)
    pred_dir = overfit.write_predictor_shards(trainer, predictor, work / "int8_predictions")
    torch.cuda.synchronize()
    launches = {"K3": conv3x3_i8_fused.launches, "K2": nms_scan.launches}
    check(launches["K3"] > 0 and launches["K2"] > 0, f"int8 scoring launches {launches}")
    int8 = overfit.score(trainer, pred_dir)
    say(f"overfit (phase 18): rv-synthetic on scripts/debug-overfit.sh's corpus, "
        f"{OVERFIT_EPOCHS} steps in {train_s:.1f} s (with validate and evaluation); loss "
        f"{losses[0]:.4f} at step 1, last-10 mean {last10:.4f} "
        f"({last10 / losses[0]:.3f} of it), every 10th {[round(x, 4) for x in losses[::10]]}; "
        f"bf16 mAP {out['mAP']:.4f}, int8 (PTQ, full scope, calibrated on the train batches) "
        f"mAP {int8['mAP']:.4f}, int8 launches {launches} (synthetic data) on {smi}")
    qat_launches = qat_phase(trainer, predictor, work, out["mAP"], int8["mAP"], smi)
    phase18 = {"trainer": trainer, "work": work, "fp_map": out["mAP"], "ptq_map": int8["mAP"],
               "pred_dir": trainer.run_dir / "predictions"}
    return launches, qat_launches, phase18


# Phase 24: QAT fine-tuning steps and rate (``tools/quant_accuracy.py``'s
# ``--qat-lr``; optax's ``adamw`` default weight decay of 1e-4, the clip at 35).
QAT_STEPS = 300
QAT_LR = 1e-4


def qat_phase(trainer, ptq, work: Path, fp_map: float, ptq_map: float, smi) -> dict:
    """Phase 24 (see the module docstring). Returns the K3 and K2 launches
    of the QAT model's int8 scoring."""
    import torch
    import torch.nn.functional as F

    from range_view_3d_detection_torch import overfit
    from range_view_3d_detection_torch.models.blocks import ConvNormAct
    from range_view_3d_detection_torch.models.quantized import Int8Conv, qat_conv, quant_tree_of
    from range_view_3d_detection_torch.serving import Predictor
    from range_view_3d_detection_torch.training import optim, state as state_lib

    t_phase = time.perf_counter()
    device = trainer.device
    qtree = quant_tree_of(ptq.model)  # phase 18's scales, the ones served
    tx, _ = optim.make_optimizer(QAT_LR, QAT_STEPS, weight_decay=1e-4, grad_clip_norm=35.0,
                                 debug=True)
    st = state_lib.create_state(trainer.det_cfg, tx, device=device)
    st.model.load_state_dict(trainer.state.model.state_dict())
    step = state_lib.make_train_step(trainer.det_cfg, quant_tree=qtree)
    losses = []
    while len(losses) < QAT_STEPS:
        for batch in trainer.train_loader:
            st, metrics = step(st, batch)
            losses.append(float(metrics["loss"]))
            if len(losses) == QAT_STEPS:
                break
    check(all(math.isfinite(x) for x in losses), "QAT: a loss is not finite")
    train_s = time.perf_counter() - t_phase
    check(all(getattr(m, "qat_scale", None) is None for m in st.model.modules()),
          "QAT: a block stayed in QAT after the steps")

    # One K3 conv of the fine-tuned model on its captured input: the QAT
    # forward against the int8 serving value.
    name = "RangeNet_0.RangeBackbone_0.ResidualBlock_1.BasicBlock_0.ConvNormAct_0"
    block = st.model.get_submodule(name)
    check(isinstance(block, ConvNormAct), f"{name} is {type(block).__name__}")
    node = qtree
    for part in name.split("."):
        node = node[part]
    s = torch.tensor(float(node["in_scale"]), device=device)
    seen = []
    handle = block.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach()))
    first = next(iter(trainer.val_loader))
    with torch.inference_mode():
        st.model.eval()(*(torch.as_tensor(first[k], device=device)
                          for k in ("features", "cart", "mask")))
    handle.remove()
    x, conv = seen[0].clone(), block.Conv_0
    kw = dict(stride=conv.stride, padding=conv.padding)
    with torch.no_grad():
        want = Int8Conv(conv, s, torch.float32)(x)
        got = qat_conv(F.conv2d, x, conv.weight, None, s, 0, **kw)
        cudnn = torch.backends.cudnn
        allow = cudnn.allow_tf32
        cudnn.allow_tf32 = True
        try:
            w = conv.weight.float()
            w_s = w.abs().amax(dim=(1, 2, 3), keepdim=True).div(127.0).clamp_min(1e-12)
            tf32 = F.conv2d(torch.clamp(torch.round(x.float() / s), -127, 127) * s,
                            torch.clamp(torch.round(w / w_s), -127, 127) * w_s, None, **kw)
        finally:
            cudnn.allow_tf32 = allow
    torch.cuda.synchronize()
    ref = want.abs().max().item()
    err, err_tf32 = (got - want).abs().max().item(), (tf32 - want).abs().max().item()
    check(err <= 2e-5 * ref, f"QAT conv vs int8 serving: max|diff| {err} > 2e-5 * {ref}")

    # The fine-tuned weights served int8 with the same scales, scored.
    reset_counts()
    qat = Predictor(trainer.det_cfg, trainer.dec_cfg, device=device)
    qat.model.load_state_dict(st.model.state_dict())
    qat.quantize(quant_tree=qtree, scope="full")
    pred_dir = overfit.write_predictor_shards(trainer, qat, work / "qat_predictions")
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {"conv3x3_i8_fused": counts["conv3x3_i8_fused"], "nms_scan": counts["nms_scan"]}
    check(launches["conv3x3_i8_fused"] > 0 and launches["nms_scan"] > 0,
          f"QAT int8 scoring launches {launches}")
    qat_map = overfit.score(trainer, pred_dir)["mAP"]
    check(math.isfinite(qat_map), f"QAT mAP {qat_map}")
    say(f"QAT (phase 24): {QAT_STEPS} steps at {QAT_LR} from phase 18's model and scales in "
        f"{train_s:.1f} s, loss {losses[0]:.4f} -> last-10 mean "
        f"{statistics.mean(losses[-10:]):.4f}; mAP fp {fp_map:.4f}, int8 PTQ {ptq_map:.4f}, "
        f"int8 QAT {qat_map:.4f}; int8 launches {launches}; {name} on its captured input "
        f"{tuple(x.shape)}: QAT forward vs int8 serving max|diff| {err:.3g} (max|ref| "
        f"{ref:.4g}), with TF32 on {err_tf32:.3g}; phase {time.perf_counter() - t_phase:.0f} s "
        f"on {smi}")
    return launches


# Phase 19's clouds: AV2's sensor (64 lasers, 1800 columns, padded to
# 1808), two clouds of 131,072 points a request.
POINTS_B, POINTS_N = 2, 131072
# Waymo's intensity plane is tanh-squashed: the card's tanhf and the CPU's
# are different approximations, held within this many ulps.
TANH_ULPS = 4


def av2_dataset_meta() -> dict:
    """The rv-av2 serving facts an artifact of the flagship records."""
    return {"dataset_name": "av2", "height": 64, "sensor_width": 1800, "x_stride": 1,
            "padding_mode": "circular",
            "feature_names": ["intensity", "range", "x", "y", "z"]}


def ulp_distance(a, b):
    """Elementwise distance in float32 ulps (same-sign finite values)."""
    import torch

    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return (ia - ib).abs()


def unexplained_pixels(got, want, moved, *, feature_names, ulp_names, pad, x_stride,
                       width) -> tuple:
    """Compare two rasterizations ``(feats, cart, mask)`` (CPU tensors, the
    padded and strided images) of the same clouds. A pixel may differ only
    where a point changed its azimuth column between the two runs:
    ``moved`` is the set of (cloud, row, sensor column) pixels such points
    fall in, on either side. Planes named in ``ulp_names`` may also differ
    by up to ``TANH_ULPS`` ulps anywhere. Returns (pixels that differ,
    pixels that differ unexplained)."""
    import torch

    feats, cart, mask = got
    wfeats, wcart, wmask = want
    keep = [i for i, n in enumerate(feature_names) if n not in ulp_names]
    diff = (feats[..., keep] != wfeats[..., keep]).any(-1)
    for i, n in enumerate(feature_names):
        if n in ulp_names:
            diff |= ulp_distance(feats[..., i], wfeats[..., i]) > TANH_ULPS
    diff |= (cart != wcart).any(-1) | (mask != wmask)
    where = torch.nonzero(diff).tolist()
    bad = [(b, r, c) for b, r, c in where
           if (b, r, (c * x_stride - pad) % width) not in moved]
    return len(where), len(bad)


def check_projection(tag, clouds, kw, device, ulp_names=()) -> dict:
    """Phase 19's check at one configuration: ``rasterize_points`` on the
    card against the port's own CPU run of the same clouds. The range of
    every point must be equal (fma and one fp64 square root on both); a
    pixel may differ only where a point's azimuth column differs (the
    card's atan2); prints the counts."""
    import torch

    from range_view_3d_detection_torch.ops.projection import (
        range_view_coordinates_t,
        rasterize_points,
    )

    xyz, laser, extras = clouds
    cpu_in = (torch.from_numpy(xyz), torch.from_numpy(laser),
              {k: torch.from_numpy(v) for k, v in extras.items()})
    dev_in = (cpu_in[0].to(device), cpu_in[1].to(device),
              {k: v.to(device) for k, v in cpu_in[2].items()})
    with torch.inference_mode():
        got = [t.cpu() for t in rasterize_points(*dev_in, **kw)]
        want = rasterize_points(*cpu_in, **kw)
        coords = dict(height=kw["height"], width=kw["width"])
        _, col_d, rng_d = range_view_coordinates_t(dev_in[0], dev_in[1], **coords)
        row, col_c, rng_c = range_view_coordinates_t(cpu_in[0], cpu_in[1], **coords)
    check(torch.equal(rng_d.cpu(), rng_c), f"projection {tag}: ranges differ card/CPU")
    moved_pts = torch.nonzero(col_d.cpu() != col_c).tolist()
    moved = set()
    for b, i in moved_pts:
        moved.add((b, int(row[b, i]), int(col_c[b, i])))
        moved.add((b, int(row[b, i]), int(col_d[b, i])))
    n_diff, n_bad = unexplained_pixels(
        got, want, moved, feature_names=kw["feature_names"], ulp_names=ulp_names,
        pad=kw["pad"], x_stride=kw["x_stride"], width=kw["width"])
    shapes = [tuple(t.shape) for t in got]
    check(shapes == [tuple(t.shape) for t in want], f"projection {tag}: shapes {shapes}")
    check(all(bool(torch.isfinite(t).all()) for t in got[:2]), f"projection {tag}: "
          "non-finite values")
    check(n_bad == 0, f"projection {tag}: {n_bad} of {n_diff} differing pixels have no "
          "point whose column moved")
    occupied = int(got[2].sum())
    say(f"projection {tag}: {shapes[0]} features, {occupied} pixels occupied, card vs "
        f"CPU: ranges equal, {len(moved_pts)} points changed column, {n_diff} pixels "
        f"differ (all at those points), mask identical: {torch.equal(got[2], want[2])}")
    return {"moved": len(moved_pts), "diff": n_diff}


def host(result):
    """A result (a named tuple of tensors) with every field on the host."""
    return result._replace(**{k: getattr(result, k).cpu() for k in result._fields})


def kernel_counts() -> dict:
    """The launch counters of the four kernel wrappers."""
    from range_view_3d_detection_torch.kernels.conv import conv3x3_i8_fused
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.kernels.stem import (
        meta_kernel_fused,
        meta_kernel_fused_i8,
    )

    return {"meta_kernel_fused": meta_kernel_fused, "nms_scan": nms_scan,
            "conv3x3_i8_fused": conv3x3_i8_fused, "meta_kernel_fused_i8": meta_kernel_fused_i8}


def reset_counts() -> None:
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_counts().items()}


def export_phase5(model, cfg, dec, requests, art_dir: Path) -> None:
    """Phase 20's artifacts, written from the phase-5 model before the
    int8 phases fold it: bf16, and int8 calibrated on request 0."""
    from range_view_3d_detection_torch.export import export_artifact

    t0 = time.perf_counter()
    export_artifact(model, cfg, dec, art_dir / "bf16", dataset_meta=av2_dataset_meta())
    export_artifact(model, cfg, dec, art_dir / "int8", quantize_batches=[requests[0]],
                    dataset_meta=av2_dataset_meta())
    say(f"export (phase 20): bf16 and int8 artifacts of the phase-5 model in "
        f"{time.perf_counter() - t0:.1f} s, variables.msgpack "
        f"{(art_dir / 'bf16' / 'variables.msgpack').stat().st_size / 2**20:.1f} MiB")


def serve_artifact(predictor, requests, cfg, dec, device, tag) -> tuple:
    """Serve ``requests`` (after one warm-up request) with the counters
    reset just before; the results (finite, detections kept, NMS equal to
    the plain scan) and launches."""
    import torch

    predictor(*requests[0])  # cuDNN plans
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = [predictor(*r) for r in requests]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(requests)
    launches = read_counts()
    kept = check_results(results)
    nms_err = check_nms_against_plain(predictor.model, requests[0], cfg, dec, device)
    say(f"artifact {tag}: {len(requests)} requests, launches {launches}, kept {kept}, "
        f"NMS == plain scan (cuboids max|diff| {nms_err:.3g}), {ms:.2f} ms/request")
    return results, launches


def serving_phases(art_dir: Path, requests, bf16_results, bf16_heads, cfg, dec, device,
                   smi) -> dict:
    """Phases 19-21 (see the module docstring). Returns each kernel's
    launches on the artifact (phase 20) and points (phase 21) paths."""
    import os

    import numpy as np
    import torch

    from range_view_3d_detection_torch.data.dataset import (
        AV2_FEATURES,
        WAYMO_FEATURES,
        width_padding,
    )
    from range_view_3d_detection_torch.export import (
        _sample_points,
        latency_bench,
        load_artifact,
        make_points_predict,
        stream_bench,
    )
    from range_view_3d_detection_torch.models.quantized import quant_tree_of
    from range_view_3d_detection_torch.ops.projection import rasterize_points
    from range_view_3d_detection_torch.utils.msgpack import msgpack_serialize

    t_phase = time.perf_counter()
    # 19. Projection on the card, against the port's CPU run.
    xyz, laser, inten = _sample_points(POINTS_B, POINTS_N, 64, 1800, seed=0)
    av2 = (xyz, laser, {"intensity": inten})
    av2_kw = dict(height=64, width=1800, feature_names=AV2_FEATURES, dataset_name="av2",
                  x_stride=1, pad=width_padding(1800, 1), padding_mode="circular")
    check_projection("AV2 64x1800 -> 1808", av2, av2_kw, device)
    wxyz, wlaser, winten = _sample_points(POINTS_B, POINTS_N, 64, 2650, seed=1)
    elong = np.random.default_rng(2).uniform(0, 2, wlaser.shape).astype(np.float32)
    waymo_names = WAYMO_FEATURES + ("view",)
    check_projection(
        "Waymo 64x2650 (view, tanh, constant padding)",
        (wxyz, wlaser, {"elongation": elong, "intensity": winten * 3}),
        dict(height=64, width=2650, feature_names=waymo_names, dataset_name="waymo",
             x_stride=1, pad=width_padding(2650, 1), padding_mode="constant"),
        device, ulp_names=("intensity",))
    check_projection("AV2 x_stride 4 -> 464", av2,
                     dict(av2_kw, x_stride=4, pad=width_padding(1800, 4)), device)
    dev_args = (torch.from_numpy(xyz).to(device), torch.from_numpy(laser).to(device),
                {"intensity": torch.from_numpy(inten).to(device)})
    with torch.inference_mode():
        proj_ms = cuda_ms(lambda: rasterize_points(*dev_args, **av2_kw), reps=20, warmup=3)
    say(f"projection (phase 19): {proj_ms:.4f} ms for B={POINTS_B} x {POINTS_N} points "
        f"at 64x1800 -> 1808 (CUDA events, median of 20) on {smi}")

    # 20. Artifacts on the card.
    bf16, _, _ = load_artifact(art_dir / "bf16", device=device)
    check(bf16.bn_folded and bf16.quant_tree is None, "bf16 artifact: not folded fp")
    results, artifact_bf16 = serve_artifact(bf16, requests, cfg, dec, device, "bf16")
    check(artifact_bf16["meta_kernel_fused"] > 0 and artifact_bf16["nms_scan"] > 0,
          f"bf16 artifact launches {artifact_bf16}")
    with torch.inference_mode():
        heads = bf16.model(*(torch.as_tensor(a, device=device) for a in requests[0]))
        heads = heads["head"][1][0]
    say(f"artifact bf16 vs phase 5's predictor: kept-box agreement "
        f"{kept_match([host(r) for r in results], bf16_results):.4f}, "
        + ", ".join(f"{k} relative RMS {rel_rms(heads[k].cpu(), bf16_heads[k]):.3g}"
                    for k in ("logits", "regressands")) + " (folded BatchNorm, not gated)")
    int8, _, _ = load_artifact(art_dir / "int8", device=device)
    written = (art_dir / "int8" / "quant.msgpack").read_bytes()
    check(msgpack_serialize(int8.quant_tree) == written
          and msgpack_serialize(quant_tree_of(int8.model)) == written,
          "int8 artifact: the loaded quant tree is not the written one")
    _, artifact_int8 = serve_artifact(int8, requests, cfg, dec, device, "int8 (K1 stem)")
    check(artifact_int8["conv3x3_i8_fused"] > 0 and artifact_int8["meta_kernel_fused"] > 0
          and artifact_int8["nms_scan"] > 0 and artifact_int8["meta_kernel_fused_i8"] == 0,
          f"int8 artifact launches {artifact_int8}")
    os.environ["RV3D_STEM_INT8"] = "1"
    try:
        int8_k4, _, _ = load_artifact(art_dir / "int8", device=device)
    finally:
        del os.environ["RV3D_STEM_INT8"]
    _, artifact_k4 = serve_artifact(int8_k4, requests, cfg, dec, device,
                                    "int8 (K4 stem, RV3D_STEM_INT8=1)")
    check(artifact_k4["meta_kernel_fused_i8"] > 0 and artifact_k4["meta_kernel_fused"] == 0,
          f"int8 artifact K4 launches {artifact_k4}")
    del int8_k4

    # 21. Raw points to detections at flagship width.
    points, extra = make_points_predict(bf16, sensor_width=1800, height=64,
                                        feature_names=AV2_FEATURES)
    clouds = [_sample_points(POINTS_B, POINTS_N, 64, 1800, seed=s) for s in range(4)]
    points(*clouds[0])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    point_results = [points(*c) for c in clouds]
    torch.cuda.synchronize()
    points_ms = (time.perf_counter() - t0) * 1e3 / len(clouds)
    points_launches = read_counts()
    check(points_launches["meta_kernel_fused"] > 0 and points_launches["nms_scan"] > 0,
          f"points launches {points_launches}")
    kept = check_results(point_results)
    by_hand = bf16(*points.rasterize(*clouds[0]))
    check(torch.equal(point_results[0].keep, by_hand.keep)
          and torch.equal(point_results[0].categories, by_hand.categories),
          "points predict: keep or categories differ from rasterize-then-predict")
    pts_err = max((getattr(point_results[0], k) - getattr(by_hand, k)).abs().max().item()
                  for k in ("cuboids", "scores"))
    check(pts_err <= 1e-6, f"points predict vs rasterize-then-predict: max|diff| {pts_err}")
    say(f"points (phase 21): {len(clouds)} requests of B={POINTS_B} x {POINTS_N} points, "
        f"launches {points_launches}, kept {kept}, equal to rasterize-then-predict "
        f"(max|diff| {pts_err:.3g}), {points_ms:.2f} ms/request")

    def make_points(seed):
        return _sample_points(POINTS_B, POINTS_N, 64, 1800, seed=seed)

    bench_kw = dict(batch=2, H=64, W=1808, C=cfg.in_channels)
    benches = {}
    for tag, fn, make in (("range images, bf16", bf16, None),
                          ("range images, int8", int8, None),
                          ("points, bf16", points, make_points)):
        say(f"latency_bench ({tag}, 50 requests) on {smi}:")
        lat = latency_bench(fn, iters=50, make_batch=make, **bench_kw)
        say(f"stream_bench ({tag}, 20 iterations) on {smi}:")
        fps = stream_bench(fn, iters=20, make_batch=make, **bench_kw)
        benches[tag] = (lat, fps)
    proj_share = proj_ms / benches["points, bf16"][0]["latency_ms_p50"]
    say(f"points request: projection {proj_ms:.3f} ms of p50 "
        f"{benches['points, bf16'][0]['latency_ms_p50']} ms ({100 * proj_share:.1f}%) "
        f"on {smi}")
    del bf16, int8, points
    torch.cuda.empty_cache()

    # The CLI as a user types it.
    cli = [sys.executable, "-m", "range_view_3d_detection_torch.export"]
    out = art_dir / "cli"
    t0 = time.perf_counter()
    for args in (["--synthetic", "--out", str(out)],
                 ["--load", str(out), "--points", "--latency", "--iters", "50"]):
        proc = subprocess.run(cli + args, capture_output=True, text=True, cwd=REPO,
                              timeout=600)
        check(proc.returncode == 0, f"export CLI {args}: rc {proc.returncode}\n"
              f"{proc.stderr[-2000:]}")
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    check(stats["iters"] == 50 and stats["device"] == torch.cuda.get_device_name(0)
          and 0 < stats["latency_ms_min"] <= stats["latency_ms_p50"]
          <= stats["latency_ms_p90"] <= stats["latency_ms_p99"],
          f"export CLI latency line {stats}")
    say(f"export CLI (--synthetic, then --load --points --latency --iters 50) in "
        f"{time.perf_counter() - t0:.1f} s: {json.dumps(stats)} on {smi}")
    say(f"serving phases 19-21: {time.perf_counter() - t_phase:.0f} s")
    return {
        name: {"artifact": artifact_bf16[name] + artifact_int8[name] + artifact_k4[name],
               "points": points_launches[name]}
        for name in artifact_bf16
    }


def one_step(cfg, batch, device, seed):
    """One train step of a fresh state from ``seed``'s weights: (loss,
    gradients, running statistics, metrics)."""
    import torch

    from range_view_3d_detection_torch.training import optim, state as state_lib

    tx, _ = optim.make_optimizer(1e-3, 10, debug=True)
    st = state_lib.create_state(cfg, tx, device=device,
                                generator=torch.Generator().manual_seed(seed))
    grads = []
    st, metrics = state_lib.make_train_step(cfg)(st, batch, grads_out=grads)
    stats = {n: b.clone() for n, b in running_stats(st.model).items()}
    del st
    return float(metrics["loss"]), grads, stats, metrics


def same_step(tag, got, want, noise) -> str:
    """Phases 22 and 23's gate on two runs of ``one_step``: the loss and
    the running statistics equal bit for bit; the gradients in
    ``train_card_vs_cpu``'s form (the median leaf within 2e-3 of its max,
    the worst within 1e-3 plus twice ``noise``'s, a repeated run's, move).
    Returns the summary."""
    import statistics

    import torch

    check(got[0] == want[0], f"{tag}: loss {got[0]!r} != {want[0]!r}")
    for n, b in want[2].items():
        check(torch.equal(got[2][n], b), f"{tag}: running statistic {n} differs")
    err, err_noise = [], []
    for a, b, c in zip(got[1], want[1], noise[1]):
        scale = max(b.abs().max().item(), 1e-30)
        err.append((a - b).abs().max().item() / scale)
        err_noise.append((c - b).abs().max().item() / scale)
    med = statistics.median(err)
    check(med <= 2e-3, f"{tag}: median gradient leaf off by {med:.3g} of its max")
    check(max(err) <= 1e-3 + 2 * max(err_noise),
          f"{tag}: a gradient leaf off by {max(err):.3g} of its max, a repeated run "
          f"{max(err_noise):.3g}")
    return (f"loss {got[0]:.7f} equal, {len(want[2])} running statistics equal, gradient "
            f"leaves off by {med:.3g} of their max in the median, {max(err):.3g} at worst "
            f"(a repeated run: {max(err_noise):.3g})")


def step_split(step, st, batch, n: int, warmup: int = 2) -> tuple:
    """``n`` steps of ``st``: the median ms a step after ``warmup`` (CUDA
    events) and its split into targets, forward, loss, backward and
    optimizer. Returns (total, split, state)."""
    import torch

    parts = ("targets", "forward", "loss", "backward", "optimizer")
    runs = []
    for i in range(n):
        start, events = torch.cuda.Event(enable_timing=True), {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        start.record()
        st, metrics = step(st, batch, mark=mark)
        check(math.isfinite(float(metrics["loss"])), f"timed step: loss {metrics['loss']}")
        if i >= warmup:
            runs.append((start, events))
    torch.cuda.synchronize()
    total = statistics.median(s.elapsed_time(e["optimizer"]) for s, e in runs)
    split = {
        part: statistics.median(
            (s if j == 0 else e[parts[j - 1]]).elapsed_time(e[part]) for s, e in runs)
        for j, part in enumerate(parts)
    }
    return total, split, st


def timed_steps(cfg, batch, device, seed) -> tuple:
    """ms a train step (2 warm-up, the median of 5) split by part, and
    peak GiB, from a fresh state."""
    import torch

    from range_view_3d_detection_torch.training import optim, state as state_lib

    tx, _ = optim.make_optimizer(1e-3, 10, debug=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = state_lib.create_state(cfg, tx, device=device,
                                generator=torch.Generator().manual_seed(seed))
    total, split, st = step_split(state_lib.make_train_step(cfg), st, batch, n=7)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del st
    return total, split, peak_gb


def remat_phase(device, smi) -> dict:
    """Phase 22: remat (``DetectorConfig.remat``) on the flagship step.
    Returns ms a step by case."""
    import dataclasses

    import torch

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.training import state as state_lib

    t_phase = time.perf_counter()
    cfg = serving._flagship_config()
    remat = dataclasses.replace(cfg, remat=True)
    check(remat.remat_scope == ("stem", "stages", "heads", "loss"),
          f"remat scope {remat.remat_scope}")
    batch2 = state_lib.batch_to_device(
        flagship_train_batch(cfg, 2, 64, 1808, seed=SEED + 22), device)
    plain = one_step(cfg, batch2, device, SEED + 23)
    again = one_step(cfg, batch2, device, SEED + 23)
    got = one_step(remat, batch2, device, SEED + 23)
    say(f"remat (phase 22) B=2, full scope against no remat: "
        f"{same_step('remat B=2', got, plain, again)}; ok")
    del plain, again, got
    total_mem = torch.cuda.get_device_properties(device).total_memory / 2**30
    batch4 = state_lib.batch_to_device(
        flagship_train_batch(cfg, 4, 64, 1808, seed=SEED + 24), device)
    step_ms = {}
    for tag, c, b in (("B=2 no remat", cfg, batch2), ("B=2 remat", remat, batch2),
                      ("B=4 remat", remat, batch4)):
        total, split, peak_gb = timed_steps(c, b, device, SEED + 23)
        step_ms[tag] = total
        check(peak_gb < total_mem, f"{tag}: peak {peak_gb:.2f} GiB of {total_mem:.2f}")
        say(f"remat (phase 22) {tag}: {total:.3f} ms a step (CUDA events, median of 5 after "
            f"2 warm-up) = " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" ms; peak {peak_gb:.2f} GiB of {total_mem:.2f}; bf16 64x1808 on {smi}")
    say(f"remat phase: {time.perf_counter() - t_phase:.0f} s")
    return step_ms


def distributed_phase(device, smi, corpus_work: Path) -> dict:
    """Phase 23: the NCCL path (see the module docstring). Returns the
    kernels' launches in rank 0's fit, validate and evaluation."""
    import tempfile

    import torch
    import torch.distributed as dist

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.parallel import mesh
    from range_view_3d_detection_torch.training import state as state_lib

    t_phase = time.perf_counter()
    cfg = serving._flagship_config()
    batch = state_lib.batch_to_device(
        flagship_train_batch(cfg, 2, 64, 1808, seed=SEED + 22), device)
    plain = one_step(cfg, batch, device, SEED + 23)
    again = one_step(cfg, batch, device, SEED + 23)
    init = Path(tempfile.mkdtemp(prefix="chip-smoke-nccl-")) / "init"
    got_device = mesh.initialize_distributed(device, init_method=f"file://{init}", rank=0,
                                             world_size=1)
    try:
        check(mesh.active() and dist.get_backend() == "nccl" and got_device == device,
              f"NCCL group: backend {dist.get_backend()}, device {got_device}")
        grouped = one_step(cfg, batch, device, SEED + 23)
    finally:
        dist.destroy_process_group()
    check(not mesh.active(), "the NCCL group outlived its phase")
    say(f"distributed (phase 23): the flagship step as rank 0 of a NCCL group of 1 against "
        f"no group: {same_step('NCCL world 1', grouped, plain, again)}; ok")
    del plain, again, grouped, batch
    torch.cuda.empty_cache()

    n = torch.cuda.device_count()
    ranks, wall_s = launch_ranks(n, corpus_work / "sensor", corpus_work / "run-distributed")
    check(ranks[0]["launches"]["meta_kernel_fused"] > 0
          and ranks[0]["launches"]["nms_scan"] > 0,
          f"distributed validate launches {ranks[0]['launches']}")
    say(f"distributed (phase 23): python -m torch.distributed.run --nproc_per_node={n} over "
        f"the train entry point, world size {n} on one machine (proves the NCCL path and "
        f"the launcher, not scaling); subprocess {wall_s:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.0f} s on {smi}")
    return ranks[0]["launches"]


def launch_ranks(n: int, corpus: Path, run_dir: Path) -> tuple:
    """``python -m torch.distributed.run --nproc_per_node=n`` over the
    train entry point (each rank ``chip_smoke.py train-rank``) at rv-av2
    on ``corpus``, B=4 a rank, remat, ZeRO-1, one epoch; fails unless it
    exits 0 with a finite report from every rank. Prints and returns the
    reports (by rank) and the launcher's wall seconds."""
    import os

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", str(REPO / "chip_smoke.py"), "train-rank",
           "experiment=rv-av2", f"++dataset.root_dir={corpus}", f"++run_dir={run_dir}",
           "++trainer.max_epochs=1", "++model.batch_size=4", "++model.remat=true",
           "++trainer.zero1=true", "++model.train_log_freq=0"]
    t0 = time.perf_counter()
    # Its own process group, so that a timeout ends the launcher's ranks too.
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(REPO), start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        say(out[-6000:])
        say(err[-6000:])
    check(proc.returncode == 0, f"distributed train: exit {proc.returncode}")
    ranks = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
             if line.startswith("chip_smoke_rank ")]
    check(len(ranks) == n, f"distributed train: {len(ranks)} rank reports of {n}")
    ranks.sort(key=lambda r: r["rank"])
    for r in ranks:
        check(r["world"] == n and r["backend"] == "nccl" and r["steps"] > 0
              and all(math.isfinite(x) for x in r["losses"]), f"rank report {r}")
        say(f"distributed rank {r['rank']} of {r['world']} ({r['backend']}, {r['device']}): "
            f"{r['steps']} steps at B=4 a rank, remat, ZeRO-1; losses "
            f"{[round(x, 4) for x in r['losses']]}; step ms (CUDA events; steps "
            f"{[k for k in range(1, r['steps'] + 1) if k != PROFILED_STEP]}) "
            f"{[round(x, 3) for x in r['step_ms']]}; profiled step {r['profiled_ms']:.3f} ms: "
            f"SyncBN all-reduces {r['syncbn_ms']:.3f} ms device time (forward ranges "
            f"{r['syncbn_fwd_ms']:.3f}, backward {r['syncbn_bwd_ms']:.3f}; {r['syncbn_calls']} "
            f"ranges), every NCCL kernel {r['nccl_ms']:.3f} ms in {r['nccl_kernels']} "
            f"launches; peak {r['peak_gb']:.2f} GiB; launches {r['launches']}; AP "
            f"{r.get('ap')}")
    return ranks, wall_s


# Phase 23's rank: the step it profiles (after two warm-up steps).
PROFILED_STEP = 3


def train_rank(argv) -> int:
    """Phase 23's rank process: ``train.main(argv)`` with the Trainer's
    step timed (CUDA events) and its third step profiled; prints one
    ``chip_smoke_rank {json}`` line."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(REPO))
    from range_view_3d_detection_torch import train
    from range_view_3d_detection_torch.parallel import mesh
    from range_view_3d_detection_torch.training import loop

    rec = {"step_ms": [], "losses": []}
    init = loop.Trainer.__init__

    def instrumented(self, *args, **kwargs):
        init(self, *args, **kwargs)
        rec.update(world=mesh.world(), rank=mesh.rank(), device=str(self.device),
                   backend=dist.get_backend() if mesh.active() else None)
        step = self.train_step

        def timed(state, batch):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if len(rec["losses"]) + 1 == PROFILED_STEP:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    start.record()
                    state, metrics = step(state, batch)
                    end.record()
                    torch.cuda.synchronize()
                rec["profiled_ms"] = start.elapsed_time(end)
                syncbn_profile(prof, rec, DeviceType)
            else:
                start.record()
                state, metrics = step(state, batch)
                end.record()
                torch.cuda.synchronize()
                rec["step_ms"].append(start.elapsed_time(end))
            rec["losses"].append(float(metrics["loss"]))
            return state, metrics

        self.train_step = timed

    loop.Trainer.__init__ = instrumented
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    metrics = train.main(argv)
    rec.update(steps=len(rec["losses"]), launches=read_counts(),
               peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    if metrics:
        rec["ap"] = metrics["AVERAGE_METRICS"]["AP"]
    rec.setdefault("profiled_ms", float("nan"))
    for k in ("syncbn_ms", "syncbn_fwd_ms", "syncbn_bwd_ms", "nccl_ms"):
        rec.setdefault(k, float("nan"))
    rec.setdefault("syncbn_calls", 0)
    rec.setdefault("nccl_kernels", 0)
    print("chip_smoke_rank " + json.dumps(rec), flush=True)
    return 0


def syncbn_profile(prof, rec, DeviceType) -> None:
    """The device time of one step's SyncBN all-reduces: the
    ``mesh.global_moments`` ranges (the moments' concatenation, the
    all-reduce and the division, the recompute's among them) and autograd's
    ``_AllReduceBackward`` nodes; beside it every NCCL kernel's."""

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    events = prof.events()
    # The host-side ranges only: a profiler may mirror a range on the
    # device's timeline under the same name.
    host = [e for e in events if e.device_type == DeviceType.CPU]
    fwd = [e for e in host if e.name == "mesh.global_moments"]
    bwd = [e for e in host if e.name.startswith("autograd::engine::evaluate_function")
           and e.name.endswith("_AllReduceBackward")]
    nccl = [e for e in events if e.device_type == DeviceType.CUDA and "nccl" in e.name.lower()]
    rec["syncbn_fwd_ms"] = sum(device_us(e) for e in fwd) / 1e3
    rec["syncbn_bwd_ms"] = sum(device_us(e) for e in bwd) / 1e3
    rec["syncbn_ms"] = rec["syncbn_fwd_ms"] + rec["syncbn_bwd_ms"]
    rec["syncbn_calls"] = len(fwd) + len(bwd)
    rec["nccl_ms"] = sum(e.time_range.elapsed_us() for e in nccl) / 1e3
    rec["nccl_kernels"] = len(nccl)


# Phases 25-28: width sharding, the chunk loop, AOT, the RangePartition stem.
# The width-sharded request is 64 x 1792 (a multiple of 16 x 4): AV2's padded
# 1808 = 16 x 113 shards only one way (ROADMAP.md Queue 3).
WIDTH_W = 1792


def width_phase(art: Path, device, smi) -> dict:
    """Phase 25 (see the module docstring). Returns the launches of the
    width-sharded requests."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.export import load_artifact, load_artifact_width_sharded
    from range_view_3d_detection_torch.parallel import mesh, spatial

    t_phase = time.perf_counter()
    try:
        spatial.check_width(1808, 2, 16)
    except ValueError as e:
        say(f"width sharding (phase 25): 1808 at 2 shards refused ({e})")
    else:
        check(False, "width sharding accepted 1808 at 2 shards")
    request = serving._sample_inputs(1, 64, WIDTH_W, 5, seed=SEED + 25)
    n = torch.cuda.device_count()
    if n > 1:
        work = Path(tempfile.mkdtemp(prefix="chip-smoke-width-"))
        try:
            np.savez(work / "request.npz", *request)
            ranks = launch_width_ranks(n, art, work / "request.npz", work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        say(f"width sharding (phase 25): {n} cards, rank reports above, phase "
            f"{time.perf_counter() - t_phase:.0f} s on {smi}")
        return ranks[0]["launches"]
    init = Path(tempfile.mkdtemp(prefix="chip-smoke-width-")) / "init"
    mesh.initialize_distributed(device, init_method=f"file://{init}", rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        check(spatial.group_size() == 1 and backend == {"cuda": "nccl"}.get(
            torch.device(device).type, "gloo"), f"width sharding: a {backend} group")
        plain, _, _ = load_artifact(art, device=device)
        accumulate, _, _ = load_artifact(art, device=device)
        accumulate.model.RangeNet_0.MetaKernel_0.use_fused_kernel = False
        tensors = tuple(torch.as_tensor(a, device=device) for a in request)
        with torch.inference_mode():
            heads = {tag: p.model(*tensors)["head"][1][0]
                     for tag, p in (("K1", plain), ("accumulate", accumulate))}
        refs = {"K1": plain(*tensors), "accumulate": accumulate(*tensors)}
        out, launches = {}, None
        for circular in (False, True):
            predict, place, _, _ = load_artifact_width_sharded(art, circular=circular,
                                                               device=device)
            local = place(*request)
            predict(*local)  # warm-up (cuDNN plans)
            torch.cuda.synchronize()
            reset_counts()
            spatial.exchange_halo_lr.calls = 0
            result = predict(*local)
            torch.cuda.synchronize()
            got_launches, exchanges = read_counts(), spatial.exchange_halo_lr.calls
            with torch.inference_mode():
                got = spatial.gather_width(predict.apply(*local))["head"][1][0]
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                predict(*local)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            check(got_launches["nms_scan"] > 0 and got_launches["meta_kernel_fused"] == 0,
                  f"width-sharded launches {got_launches}")
            check(bool(torch.isfinite(result.cuboids[result.keep]).all())
                  and int(result.keep.sum()) > 0, "width-sharded: no finite detections")
            rms = {tag: {k: rel_rms(got[k], h[k]) for k in ("logits", "regressands")}
                   for tag, h in heads.items()}
            kept = {tag: kept_match([result], [r]) for tag, r in refs.items()}
            out[circular] = dict(ms=statistics.median(walls), rms=rms, kept=kept,
                                 exchanges=exchanges, heads=got)
            if launches is None:
                launches = got_launches
            say(f"width sharding (phase 25), world size 1 ({backend}), circular={circular}: "
                f"B=1 64x{WIDTH_W}, {exchanges} halo exchanges a request (local: one "
                f"card has no neighbour), launches {got_launches}, kept "
                f"{int(result.keep.sum())}; heads relative RMS against the unsharded "
                f"forward: {rms}; kept-box agreement {kept}; "
                f"{out[circular]['ms']:.3f} ms/request (median of 10) on {smi}")
        # Zero-padded at world size 1 the sharded forward is the unsharded
        # one on the same (accumulate) stem: VALID convs of pre-padded shards.
        worst = max(out[False]["rms"]["accumulate"].values())
        check(worst <= 1e-2, f"width sharding: heads relative RMS {worst} against the "
              "unsharded accumulate-stem forward")
        seam = {k: rel_rms(out[True]["heads"][k], out[False]["heads"][k])
                for k in ("logits", "regressands")}
        plain_ms = statistics.median(
            cuda_sync_wall(lambda: plain(*tensors)) for _ in range(10))
        say(f"width sharding (phase 25): circular against zero-padded seam, heads "
            f"relative RMS {seam}; unsharded load_artifact {plain_ms:.3f} ms/request; "
            f"world size 1 checks the hooks, not the exchange (the CPU tests hold 2 and 4 "
            f"ranks; chip_scaling.py width N times N cards); phase "
            f"{time.perf_counter() - t_phase:.0f} s on {smi}")
    finally:
        dist.destroy_process_group()
    return launches


def cuda_sync_wall(fn) -> float:
    """Host milliseconds of ``fn()`` through a device synchronisation."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def launch_width_ranks(n: int, art: Path, request: Path, out_dir: Path) -> list:
    """``python -m torch.distributed.run --nproc_per_node=n`` over
    ``chip_smoke.py width-rank``: the artifact served width-sharded over
    ``n`` cards (zero-padded seam, TF32 off) on the saved request; returns
    every rank's report (rank 0 also saves its result and gathered heads
    under ``out_dir``)."""
    import os

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", str(REPO / "chip_smoke.py"), "width-rank", str(art),
           str(request), str(out_dir)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(REPO), start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
    if proc.returncode != 0:
        say(out[-6000:])
        say(err[-6000:])
    check(proc.returncode == 0, f"width-sharded serving on {n} cards: exit {proc.returncode}")
    ranks = sorted((json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
                    if line.startswith("chip_smoke_width_rank ")), key=lambda r: r["rank"])
    check(len(ranks) == n, f"width ranks: {len(ranks)} reports of {n}")
    for r in ranks:
        check(r["world"] == n and r["kept"] > 0, f"width rank report {r}")
        say(f"width rank {r['rank']} of {r['world']}: p50 {r['p50_ms']:.3f} ms, p90 "
            f"{r['p90_ms']:.3f} ms a request (B=1 {r['height']}x{r['width']}, host wall "
            f"through a "
            f"synchronisation, {r['iters']} requests); {r['exchanges']} halo exchanges a "
            f"request, {r['halo_ms']:.3f} ms of device time in them, every NCCL kernel "
            f"{r['nccl_ms']:.3f} ms; launches {r['launches']}; kept {r['kept']}")
    return ranks


def width_rank(argv) -> int:
    """A rank of :func:`launch_width_ranks`: prints one
    ``chip_smoke_width_rank {json}`` line."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(REPO))
    from range_view_3d_detection_torch.export import load_artifact_width_sharded
    from range_view_3d_detection_torch.parallel import mesh, spatial

    art, request, out_dir = argv
    # fp32 artifacts are compared across card counts at fp32 precision.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mesh.initialize_distributed("cuda")
    try:
        predict, place, _, _ = load_artifact_width_sharded(art, circular=False, device=device)
        req = np.load(request)
        local = place(*(req[f"arr_{i}"] for i in range(3)))
        for _ in range(3):
            predict(*local)
        torch.cuda.synchronize()
        reset_counts()
        spatial.exchange_halo_lr.calls = 0
        result = predict(*local)
        torch.cuda.synchronize()
        rec = dict(rank=mesh.rank(), world=mesh.world(), height=int(req["arr_0"].shape[1]),
                   width=int(req["arr_0"].shape[2]),
                   launches=read_counts(), exchanges=spatial.exchange_halo_lr.calls,
                   kept=int(result.keep.sum()))
        dist.barrier()
        walls = []
        for _ in range(30):
            t0 = time.perf_counter()
            predict(*local)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        # Nearest rank: ceil(p n) - 1, 0-indexed.
        rec.update(iters=len(walls), p50_ms=walls[math.ceil(0.5 * len(walls)) - 1],
                   p90_ms=walls[math.ceil(0.9 * len(walls)) - 1])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            predict(*local)
            torch.cuda.synchronize()

        def device_us(e):
            return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

        events = prof.events()
        halo = [e for e in events
                if e.device_type == DeviceType.CPU and e.name == "spatial.exchange_halo"]
        nccl = [e for e in events
                if e.device_type == DeviceType.CUDA and "nccl" in e.name.lower()]
        rec.update(halo_ms=sum(device_us(e) for e in halo) / 1e3,
                   nccl_ms=sum(e.time_range.elapsed_us() for e in nccl) / 1e3)
        with torch.inference_mode():
            heads = spatial.gather_width(predict.apply(*local))["head"][1][0]
        if mesh.rank() == 0:
            torch.save({"result": tuple(t.cpu() for t in result),
                        "heads": {k: v.float().cpu() for k, v in heads.items()}},
                       Path(out_dir) / f"width_result_{mesh.world()}.pt")
        print("chip_smoke_width_rank " + json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def chunk_phase(art: Path, requests, device, smi) -> dict:
    """Phase 26 (see the module docstring). Returns the launches while
    the chunk's graph was captured."""
    import torch

    from range_view_3d_detection_torch.export import (
        load_artifact,
        make_chunked_predict,
        stream_bench,
    )

    t_phase = time.perf_counter()
    predict, _, _ = load_artifact(art, device=device)
    reqs = [tuple(torch.as_tensor(a, device=device) for a in r) for r in requests]
    eager = [predict(*r) for r in reqs]
    stacked = [torch.stack([r[j] for r in reqs]) for j in range(3)]
    torch.cuda.synchronize()
    reset_counts()
    run = make_chunked_predict(predict, len(reqs))
    first = run(*stacked)
    torch.cuda.synchronize()
    launches = read_counts()
    again = run(*stacked)
    for got in (first, again):
        for i, want in enumerate(eager):
            for name, a, b in zip(want._fields, got, want):
                check(torch.equal(a[i], b), f"chunk loop: request {i} {name} differs from "
                      "the eager call")
    check(launches["meta_kernel_fused"] > 0 and launches["nms_scan"] > 0,
          f"chunk loop launches {launches}")
    bench = {}
    B, H, W, C = requests[0][0].shape
    for chunk, iters in ((0, 20), (len(reqs), 5)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        say(f"stream_bench (chunk {chunk}, {iters} iterations) on {smi}:")
        fps = stream_bench(predict, batch=B, iters=iters, H=H, W=W, C=C, chunk=chunk)
        bench[chunk] = (fps, (torch.cuda.max_memory_allocated(device) - base) / 2**30)
    say(f"chunk loop (phase 26): a chunk of {len(reqs)} B=2 requests as one CUDA-graph "
        f"replay equals {len(reqs)} eager calls bit for bit (twice); launches while "
        f"captured {launches}; stream_bench frames/s chunk 0 {bench[0][0]:.2f} (peak "
        f"{bench[0][1]:.2f} GiB above the weights), chunk {len(reqs)} "
        f"{bench[len(reqs)][0]:.2f} (peak {bench[len(reqs)][1]:.2f} GiB); phase "
        f"{time.perf_counter() - t_phase:.0f} s on {smi}")
    del run
    torch.cuda.empty_cache()
    return launches


AOT_CHILD = """
import sys, numpy as np, torch
sys.path.insert(0, {repo!r})
import range_view_3d_detection_torch.kernels
r = np.load({req!r})
program = torch.export.load({path!r})
device = next(iter(program.state_dict.values())).device
args = [torch.from_numpy(r[f"arr_{{i}}"]).to(device) for i in range(3)]
with torch.inference_mode():
    out = program.module()(*args)
torch.save(tuple(t.cpu() for t in out), {out!r})
bad = [m for m in sys.modules if m.startswith(("range_view_3d_detection_torch.models",
       "range_view_3d_detection_torch.export", "range_view_3d_detection_torch.serving"))]
assert not bad, bad
print("aot child ok", range_view_3d_detection_torch.kernels.stem.meta_kernel_fused.launches,
      range_view_3d_detection_torch.kernels.nms.nms_scan.launches)
"""


def aot_phase(art_dir: Path, requests, device, smi) -> dict:
    """Phase 27 (see the module docstring). Returns the launches of the
    AOT programs' requests."""
    import numpy as np
    import torch

    from range_view_3d_detection_torch.export import export_aot, load_aot, load_artifact

    t_phase = time.perf_counter()
    total = dict.fromkeys(read_counts(), 0)
    paths, child = {}, None
    np.savez(art_dir / "request.npz", *requests[0])
    B, H, W = requests[0][0].shape[:3]
    try:
        for tag in ("bf16", "int8"):
            t0 = time.perf_counter()
            path = paths[tag] = export_aot(art_dir / tag, batch=B, height=H, width=W,
                                           device=device)
            export_s = time.perf_counter() - t0
            if child is not None:
                # The bf16 program's child ran beside this export; it ends
                # before anything here is timed.
                out, err = child.communicate(timeout=600)
                check(child.returncode == 0, f"AOT child: rc {child.returncode}\n"
                      f"{err[-3000:]}")
                for field, a, b in zip(child_want._fields, torch.load(child_out),
                                       child_want):
                    check(torch.equal(a, b.cpu()), f"AOT child: {field} differs")
                say(f"AOT (phase 27): a process that imports only the kernels package "
                    f"loads and serves {paths['bf16'].name} (bf16) equal bit for bit "
                    f"({out.strip()}; {time.perf_counter() - t_child:.1f} s beside the "
                    f"int8 export)")
            ref, _, _ = load_artifact(art_dir / tag, device=device)
            want = [ref(*r) for r in requests]
            aot = load_aot(path)
            aot(*requests[0])
            torch.cuda.synchronize()
            reset_counts()
            got = [aot(*r) for r in requests]
            torch.cuda.synchronize()
            launches = read_counts()
            for name in total:
                total[name] += launches[name]
            for g, w in zip(got, want):
                for field, a, b in zip(w._fields, g, w):
                    check(torch.equal(a, b), f"AOT {tag}: {field} differs from "
                          "load_artifact's")
            need = ("meta_kernel_fused", "nms_scan") + (
                ("conv3x3_i8_fused",) if tag == "int8" else ())
            check(all(launches[k] > 0 for k in need), f"AOT {tag} launches {launches}")
            ms_aot = statistics.median(
                cuda_sync_wall(lambda: aot(*requests[1])) for _ in range(10))
            ms_ref = statistics.median(
                cuda_sync_wall(lambda: ref(*requests[1])) for _ in range(10))
            say(f"AOT (phase 27) {tag}: export_aot {export_s:.1f} s, {path.name} "
                f"{path.stat().st_size / 2**20:.1f} MiB; load_aot's outputs equal "
                f"load_artifact's bit for bit on {len(requests)} B={B} requests; launches "
                f"{launches}; {ms_aot:.3f} ms/request beside load_artifact's {ms_ref:.3f} "
                f"(median of 10, host wall through a synchronisation) on {smi}")
            if tag == "bf16":
                child_out, child_want = art_dir / "aot_child.pt", want[0]
                code = AOT_CHILD.format(repo=str(REPO), req=str(art_dir / "request.npz"),
                                        path=str(path), out=str(child_out))
                t_child = time.perf_counter()
                child = subprocess.Popen([sys.executable, "-c", code],
                                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True)
            del aot, ref
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
    for path in paths.values():
        path.unlink()
    torch.cuda.empty_cache()
    say(f"AOT (phase 27): {time.perf_counter() - t_phase:.0f} s")
    return total


def range_partition_phase(device, smi) -> None:
    """Phase 28 (see the module docstring)."""
    import dataclasses

    import torch

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.models.detector import Detector

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(serving._flagship_config(), stem_type="RANGE_PARTITION",
                              stem_pallas=False)
    cpu = Detector(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED + 28))
    card = Detector(cfg, device=device)
    card.load_state_dict(cpu.state_dict())
    small = serving._sample_inputs(1, 8, 256, 5, seed=SEED + 28)
    with torch.inference_mode():
        want = cpu(*(torch.as_tensor(a) for a in small))["head"][1][0]
        got = card(*(torch.as_tensor(a, device=device) for a in small))["head"][1][0]
        errs = {}
        for k in ("logits", "regressands"):
            err = (got[k].cpu() - want[k]).abs().max().item()
            ref = want[k].abs().max().item()
            check(err <= 2e-2 * ref, f"RANGE_PARTITION {k}: max|diff| {err} > 2e-2 * {ref}")
            errs[k] = (err, ref)
        full = tuple(torch.as_tensor(a, device=device)
                     for a in serving._sample_inputs(2, 64, 1808, 5, seed=SEED + 28))
        ms = cuda_ms(lambda: card(*full), reps=5)
        out = card(*full)["head"][1][0]
        check(all(bool(torch.isfinite(v).all()) for v in out.values()),
              "RANGE_PARTITION at 2 x 64x1808: non-finite heads")
    say(f"RANGE_PARTITION stem (phase 28): flagship widths, bf16, card against CPU at "
        f"B=1 8x256: " + ", ".join(f"{k} max|diff| {e:.4g} (max|ref| {r:.4g})"
                                   for k, (e, r) in errs.items())
        + f" within 2e-2 x max|ref|; B=2 64x1808 forward {ms:.3f} ms (CUDA events, median "
        f"of 5), finite; phase {time.perf_counter() - t_phase:.0f} s on {smi}")


# Phase 29: the offline data path. Raw logs at full size, converted by the
# port's converters in a process where JAX, pyarrow and the JAX package
# cannot be imported, then trained on, validated and served.
RAW_AV2_LOGS = {  # split -> (log id, sweeps); the val log is one whose laser
    # numbers the converter corrects (``log_corrections.LOG_IDS``)
    "train": ("3f1a2c84-5b6e-3d07-9c21-8e4b7a6d0f13", 4),
    "val": ("00a6ffc1-6ce9-3bc3-a060-6006e9893a1a", 2),
}
RAW_POINTS = 100_000  # a sweep of AV2's two 32-beam lasers
SWEEP_NS = 100_000_000  # 10 Hz
BANNED_IN_CONVERSION = ("jax", "jaxlib", "pyarrow", "range_view_3d_detection_tpu",
                        "converters", "tools")
_LZ4_MAGIC = 0x184D2204


def lz4_block(data: bytes, start: int, end: int, table: dict, window: int,
              stats: dict) -> bytes:
    """A greedy LZ4 block of ``data[start:end]``. ``table`` maps 4-byte
    sequences to their last position (shared across the blocks of a linked
    frame); a match reaches back no further than ``window`` nor 65,535
    bytes. ``stats`` counts matches, those that reach into an earlier block
    and those that overlap their own output (offset < length). The last 5
    bytes are literals and the last match starts 12 bytes before the end,
    as the block format asks."""
    out = bytearray()
    ip = anchor = start
    limit = end - 12

    def length_bytes(n: int) -> bytes:
        return b"\xff" * (n // 255) + bytes([n % 255])

    while ip < limit:
        key = data[ip : ip + 4]
        ref = table.get(key)
        table[key] = ip
        if ref is None or ref < window or ip - ref > 65535:
            ip += 1
            continue
        n = 4
        stop = end - 5
        while ip + n + 16 <= stop and data[ref + n : ref + n + 16] == data[ip + n : ip + n + 16]:
            n += 16
        while ip + n < stop and data[ref + n] == data[ip + n]:
            n += 1
        lit = ip - anchor
        token = (min(lit, 15) << 4) | min(n - 4, 15)
        out.append(token)
        if lit >= 15:
            out += length_bytes(lit - 15)
        out += data[anchor:ip]
        out += (ip - ref).to_bytes(2, "little")
        if n - 4 >= 15:
            out += length_bytes(n - 4 - 15)
        stats["matches"] += 1
        stats["into_earlier_block"] += ref < start
        stats["overlapping"] += ip - ref < n
        ip += n
        anchor = ip
    lit = end - anchor
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        out += length_bytes(lit - 15)
    out += data[anchor:end]
    return bytes(out)


def lz4_frame_compress(data: bytes, *, block_size: int = 65536, linked: bool = True,
                       block_checksum: bool = False, content_checksum: bool = False,
                       content_size: bool = False, stats: dict | None = None) -> bytes:
    """An LZ4 frame of ``data`` (the test encoder of phase 29: the card's
    machine has no LZ4 library). Linked blocks by default, as LZ4F and
    Arrow write them; a block that does not shrink is stored raw."""
    from range_view_3d_detection_torch.utils.lz4 import xxh32

    stats = stats if stats is not None else {}
    for k in ("matches", "into_earlier_block", "overlapping", "raw_blocks", "blocks"):
        stats.setdefault(k, 0)
    bd = {1 << 16: 4, 1 << 18: 5, 1 << 20: 6, 1 << 22: 7}[block_size] << 4
    flg = (0x40 | (0 if linked else 0x20) | (0x10 if block_checksum else 0)
           | (0x08 if content_size else 0) | (0x04 if content_checksum else 0))
    desc = bytes([flg, bd]) + (len(data).to_bytes(8, "little") if content_size else b"")
    out = bytearray(_LZ4_MAGIC.to_bytes(4, "little") + desc)
    out.append((xxh32(desc) >> 8) & 0xFF)
    table: dict = {}
    for start in range(0, len(data), block_size):
        end = min(start + block_size, len(data))
        if not linked:
            table = {}
        block = lz4_block(data, start, end, table, 0 if linked else start, stats)
        stats["blocks"] += 1
        if len(block) >= end - start:
            block = data[start:end]
            out += (len(block) | 0x80000000).to_bytes(4, "little")
            stats["raw_blocks"] += 1
        else:
            out += len(block).to_bytes(4, "little")
        out += block
        if block_checksum:
            out += xxh32(block).to_bytes(4, "little")
    out += b"\0\0\0\0"
    if content_checksum:
        out += xxh32(data).to_bytes(4, "little")
    return bytes(out)


def write_feather_lz4(path: Path, columns: dict) -> dict:
    """Write ``columns`` as a Feather file whose record batch is
    LZ4_FRAME-compressed, as pyarrow writes by default: each non-empty
    buffer is its uncompressed length (int64) and an LZ4 frame of it
    (``lz4_frame_compress``), or -1 and the bytes themselves where the frame
    would not be smaller. Assembled from the port's private flatbuffer
    writer: its ``write_feather`` writes uncompressed only, as the JAX
    package's does. Returns the counts of compressed and raw buffers."""
    import struct

    import numpy as np

    from range_view_3d_detection_torch.utils import feather as f

    cols = [(str(k), *f._column_kind(str(k), np.asarray(v))) for k, v in columns.items()]
    n = len(cols[0][2]) if cols else 0
    plain, nodes, plain_buffers = f._body(cols)
    chunks, buffers, pos, counts = [], [], 0, {"lz4": 0, "raw": 0}
    for off, size in plain_buffers:
        data = plain[off : off + size]
        if size:
            frame = lz4_frame_compress(data)
            kind = "lz4" if len(frame) < size else "raw"
            data = struct.pack("<q", size if kind == "lz4" else -1) + (
                frame if kind == "lz4" else data)
            counts[kind] += 1
        buffers.append((pos, len(data)))
        chunks.append(data + b"\0" * (-len(data) % 8))
        pos += len(chunks[-1])
    body = b"".join(chunks)
    schema_msg = f._message(f._SCHEMA, lambda b: f._schema_writer(b, cols), 0)
    batch_msg = f._message(f._RECORD_BATCH, lambda b: lambda: b.table([
        ("q", n),
        ("ref", lambda: b.structs("qq", nodes)),
        ("ref", lambda: b.structs("qq", buffers)),
        ("ref", lambda: b.table([("b", 0), ("b", 0)])),  # LZ4_FRAME, BUFFER
    ]), len(body))
    head = f.MAGIC + b"\0\0"
    footer = f._Builder().finish(lambda b: b.table([
        ("h", f._V5),
        ("ref", f._schema_writer(b, cols)),
        ("ref", lambda: b.structs("qi4xq", [])),
        ("ref", lambda: b.structs("qi4xq", [(len(head) + len(schema_msg), len(batch_msg),
                                             len(body))])),
    ]))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"".join([head, schema_msg, batch_msg, body,
                               struct.pack("<Ii", 0xFFFFFFFF, 0), footer,
                               struct.pack("<i", len(footer)), f.MAGIC]))
    return counts


def lz4_copy(src: Path, dst: Path) -> dict:
    """Copy a raw log tree with every Feather file rewritten by
    ``write_feather_lz4``; returns the buffer counts summed."""
    from range_view_3d_detection_torch.utils.feather import read_feather

    shutil.copytree(src, dst)
    counts = {"lz4": 0, "raw": 0}
    for path in sorted(dst.rglob("*.feather")):
        for k, v in write_feather_lz4(path, read_feather(path)).items():
            counts[k] += v
    return counts


def lz4_test_data(sweep: bytes, seed: int) -> bytes:
    """A sweep's size of bytes that an LZ4 frame must carry every way:
    a random run repeated across a 64 KB block boundary (linked matches),
    zeros and a short period (overlapping matches), then a raw sweep."""
    import numpy as np

    rng = np.random.default_rng(seed)
    head = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    return b"".join([head, head, bytes(100_000), b"abc" * 20_000, sweep])


def _yaw_quat(yaw):
    import numpy as np

    return np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)


def write_raw_av2_log(log_dir: Path, *, sweeps: int, seed: int, categories,
                      points: int = RAW_POINTS, t0: int = 315_969_904_359_876_000) -> None:
    """A raw AV2 sensor log in the dataset's own schema, written with the
    port's ``write_feather``: ``sensors/lidar/<ts>.feather`` (x, y, z
    float16; intensity, laser_number uint8; offset_ns uint32 over the 100 ms
    spin) from two 32-beam lasers, ``city_SE3_egovehicle.feather`` at 10 Hz
    (the ego drives and turns), ``annotations.feather`` without
    ``num_interior_pts`` (the converter counts it) and a map archive with
    drivable polygons (the converter computes the ROI flags)."""
    import numpy as np

    from range_view_3d_detection_torch.converters.av2.row_mappings import ROW_MAPPING_64
    from range_view_3d_detection_torch.utils.feather import write_feather

    rng = np.random.default_rng(seed)
    lidar = log_dir / "sensors" / "lidar"
    # Elevation by image row: laser L lies on row ROW_MAPPING_64[L].
    elevation = np.deg2rad(15.0 - 40.0 * ROW_MAPPING_64 / 63.0)
    stamps = t0 + SWEEP_NS * np.arange(sweeps, dtype=np.int64)
    ann = {k: [] for k in ("timestamp_ns", "track_uuid", "category", "length_m", "width_m",
                           "height_m", "qw", "qx", "qy", "qz", "tx_m", "ty_m", "tz_m")}
    n_boxes = 16
    box_xy = rng.uniform(6, 45, n_boxes) * np.exp(1j * rng.uniform(-np.pi, np.pi, n_boxes))
    box_dims = np.stack([rng.uniform(3.5, 5.5, n_boxes), rng.uniform(1.7, 2.3, n_boxes),
                         rng.uniform(1.4, 2.0, n_boxes)], -1)
    box_yaw = rng.uniform(-np.pi, np.pi, n_boxes)
    box_cat = rng.choice(list(categories)[:8], n_boxes)
    tracks = [f"{seed:08x}-{k:04x}-4000-8000-{k:012x}" for k in range(n_boxes)]
    for ts in stamps:
        n_box_pts = 150 * n_boxes
        n_scan = points - n_box_pts
        laser = rng.integers(0, 64, n_scan)
        frac = np.sort(rng.uniform(0, 1, n_scan))  # the spin's phase
        az = np.pi - 2 * np.pi * frac
        el = elevation[laser] + rng.normal(0, 1e-3, n_scan)
        rng_m = np.where(el < -0.02, 1.8 / np.tan(np.maximum(-el, 0.02)),
                         rng.uniform(20, 80, n_scan))
        rng_m = np.minimum(rng_m, 80.0) * rng.uniform(0.97, 1.0, n_scan)
        xyz = np.stack([rng_m * np.cos(el) * np.cos(az), rng_m * np.cos(el) * np.sin(az),
                        rng_m * np.sin(el)], -1)
        # Returns inside each box, on the laser nearest their elevation.
        local = rng.uniform(-0.45, 0.45, (n_boxes, 150, 3)) * box_dims[:, None]
        c, s = np.cos(box_yaw)[:, None], np.sin(box_yaw)[:, None]
        bx = box_xy.real[:, None] + c * local[..., 0] - s * local[..., 1]
        by = box_xy.imag[:, None] + s * local[..., 0] + c * local[..., 1]
        bz = box_dims[:, None, 2] / 2 - 1.0 + local[..., 2]
        box_pts = np.stack([bx, by, bz], -1).reshape(-1, 3)
        box_el = np.arctan2(box_pts[:, 2], np.hypot(box_pts[:, 0], box_pts[:, 1]))
        box_laser = np.abs(box_el[:, None] - elevation[None]).argmin(1)
        box_frac = (np.pi - np.arctan2(box_pts[:, 1], box_pts[:, 0])) / (2 * np.pi)
        xyz = np.concatenate([xyz, box_pts])
        laser = np.concatenate([laser, box_laser])
        frac = np.clip(np.concatenate([frac, box_frac]), 0, 1)
        write_feather(lidar / f"{ts}.feather", {
            "x": xyz[:, 0].astype(np.float16),
            "y": xyz[:, 1].astype(np.float16),
            "z": xyz[:, 2].astype(np.float16),
            "intensity": rng.integers(0, 256, len(xyz)).astype(np.uint8),
            "laser_number": laser.astype(np.uint8),
            "offset_ns": (frac * (SWEEP_NS - 1)).astype(np.uint32),
        })
        qw, qx, qy, qz = _yaw_quat(box_yaw)
        for k in range(n_boxes):
            for key, v in (("timestamp_ns", int(ts)), ("track_uuid", tracks[k]),
                           ("category", str(box_cat[k])), ("length_m", box_dims[k, 0]),
                           ("width_m", box_dims[k, 1]), ("height_m", box_dims[k, 2]),
                           ("qw", qw[k]), ("qx", qx[k]), ("qy", qy[k]), ("qz", qz[k]),
                           ("tx_m", box_xy[k].real), ("ty_m", box_xy[k].imag),
                           ("tz_m", box_dims[k, 2] / 2 - 1.0)):
                ann[key].append(v)
    write_feather(log_dir / "annotations.feather", {
        k: np.asarray(v, np.int64 if k == "timestamp_ns" else None) for k, v in ann.items()})
    pose_ts = np.arange(stamps[0] - 10 * SWEEP_NS, stamps[-1] + 11 * SWEEP_NS, SWEEP_NS,
                        dtype=np.int64)
    t = (pose_ts - stamps[0]) * 1e-9
    qw, qx, qy, qz = _yaw_quat(0.3 + 0.05 * t)
    write_feather(log_dir / "city_SE3_egovehicle.feather", {
        "timestamp_ns": pose_ts, "qw": qw, "qx": qx, "qy": qy, "qz": qz,
        "tx_m": 2500.0 + 10.0 * t, "ty_m": 1200.0 + 3.0 * t, "tz_m": 20.0 + 0.0 * t})
    road = [(2420.0, 1180.0), (2600.0, 1180.0), (2600.0, 1225.0), (2420.0, 1225.0)]
    cross = [(2490.0, 1100.0), (2512.0, 1100.0), (2518.0, 1300.0), (2486.0, 1300.0)]
    archive = {"drivable_areas": {str(i): {"id": i, "area_boundary": [
        {"x": x, "y": y, "z": 20.0} for x, y in poly]} for i, poly in enumerate((road, cross))},
        "lane_segments": {}, "pedestrian_crossings": {}}
    (log_dir / "map").mkdir(parents=True, exist_ok=True)
    (log_dir / "map" / f"log_map_archive_{log_dir.name}.json").write_text(json.dumps(archive))


def write_raw_nuscenes(root: Path, *, seed: int, points: int = 34_000) -> str:
    """A nuScenes mini layout (the JSON tables and ``.pcd.bin`` sweeps of
    one scene, two keyframes 0.5 s apart) with nuScenes' 32-beam lidar's
    point count. Returns the version directory's name."""
    import numpy as np

    rng = np.random.default_rng(seed)
    version = "v1.0-mini"
    tables = root / version
    tables.mkdir(parents=True, exist_ok=True)
    (root / "samples" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)

    def dump(name, rows):
        (tables / f"{name}.json").write_text(json.dumps(rows))

    dump("scene", [{"token": "sc0", "name": "scene-0061", "first_sample_token": "s0",
                    "last_sample_token": "s1"}])
    dump("sample", [
        {"token": "s0", "timestamp": 1_532_402_927_647_951, "next": "s1", "prev": "",
         "scene_token": "sc0"},
        {"token": "s1", "timestamp": 1_532_402_928_147_847, "next": "", "prev": "s0",
         "scene_token": "sc0"}])
    dump("calibrated_sensor", [{"token": "cs0", "rotation": [0.7071, 0.0, 0.0, 0.7071],
                                "translation": [0.94, 0.0, 1.84]}])
    dump("ego_pose", [
        {"token": "ep0", "rotation": [0.57, -0.01, 0.01, -0.82],
         "translation": [411.3, 1180.9, 0.0]},
        {"token": "ep1", "rotation": [0.57, -0.01, 0.01, -0.82],
         "translation": [410.1, 1183.2, 0.0]}])
    dump("category", [{"token": "c_car", "name": "vehicle.car"},
                      {"token": "c_ped", "name": "human.pedestrian.adult"},
                      {"token": "c_rack", "name": "static_object.bicycle_rack"}])
    dump("instance", [{"token": f"i{k}", "category_token": c}
                      for k, c in enumerate(["c_car", "c_car", "c_ped", "c_rack"])])
    anns = []
    for s, (tx, ty) in enumerate(((411.3, 1180.9), (410.1, 1183.2))):
        for k, (dx, dy) in enumerate(((12.0, 3.0), (-8.0, 15.0), (5.0, -6.0), (20.0, 0.0))):
            anns.append({"token": f"a{s}{k}", "sample_token": f"s{s}", "instance_token": f"i{k}",
                         "translation": [tx + dx, ty + dy, 0.8],
                         "size": [1.9, 4.6, 1.7] if k < 2 else [0.7, 0.7, 1.8],
                         "rotation": [0.92, 0.0, 0.0, 0.39], "num_lidar_pts": 50})
    dump("sample_annotation", anns)
    rows = []
    for s in range(2):
        ring = rng.integers(0, 32, points)
        az = rng.uniform(-np.pi, np.pi, points)
        el = np.deg2rad(10.0 - 40.0 * ring / 31.0)
        r = np.where(el < -0.05, 1.84 / np.tan(np.maximum(-el, 0.05)), rng.uniform(5, 70, points))
        r = np.minimum(r, 70.0)
        pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                        r * np.sin(el), rng.uniform(0, 255, points), ring], -1)
        name = f"samples/LIDAR_TOP/n015-scene-0061__LIDAR_TOP__{s}.pcd.bin"
        pts.astype(np.float32).tofile(root / name)
        rows.append({"token": f"sd{s}", "sample_token": f"s{s}", "ego_pose_token": f"ep{s}",
                     "calibrated_sensor_token": "cs0", "filename": name,
                     "is_key_frame": True})
    dump("sample_data", rows)
    return version


def waymo_frames(n: int, *, seed: int, height: int = 64, width: int = 2650):
    """Duck-typed Waymo frames (what the SDK's parser yields: frame, range
    images, TOP pose image) at the TOP lidar's 64 x 2650, with no-label
    zones, empty pixels, a rolling-shutter pose image and laser labels."""
    from types import SimpleNamespace

    import numpy as np

    rng = np.random.default_rng(seed)
    incl = np.linspace(-0.31, 0.04, height)
    frames = []
    for i in range(n):
        ranges = rng.uniform(2.5, 75.0, (height, width)).astype(np.float32)
        ranges[rng.uniform(size=(height, width)) < 0.05] = 0.0
        nlz = np.where(rng.uniform(size=(height, width)) < 0.02, 1.0, -1.0).astype(np.float32)
        ri = SimpleNamespace(shape=SimpleNamespace(dims=[height, width, 4]), data=np.stack(
            [ranges, rng.uniform(0, 1.5, (height, width)).astype(np.float32),
             rng.uniform(0, 0.3, (height, width)).astype(np.float32), nlz], -1).reshape(-1))
        pose = np.zeros((height, width, 6))
        pose[..., 2] = 0.8 + 1e-4 * np.arange(width)[None]  # yaw across the spin
        pose[..., 3] = 1000.0 + 0.01 * i + 1e-5 * np.arange(width)[None]
        pose[..., 4] = -300.0
        pose_ri = SimpleNamespace(shape=SimpleNamespace(dims=[height, width, 6]),
                                  data=pose.reshape(-1))
        extrinsic = np.eye(4)
        extrinsic[:3, 3] = [1.43, 0.0, 2.18]
        frame_pose = np.eye(4)
        frame_pose[:2, :2] = [[np.cos(0.8), -np.sin(0.8)], [np.sin(0.8), np.cos(0.8)]]
        frame_pose[:3, 3] = [1000.0 + 0.01 * i, -300.0, 0.0]
        calib = SimpleNamespace(name=1, extrinsic=SimpleNamespace(
            transform=extrinsic.reshape(-1).tolist()), beam_inclinations=incl.tolist(),
            beam_inclination_min=float(incl[0]), beam_inclination_max=float(incl[-1]))
        labels = [SimpleNamespace(box=SimpleNamespace(
            center_x=float(x), center_y=float(y), center_z=1.0, length=4.5, width=2.0,
            height=1.7, heading=float(h)), type=int(t), detection_difficulty_level=int(d))
            for x, y, h, t, d in zip(rng.uniform(-40, 40, 12), rng.uniform(-40, 40, 12),
                                     rng.uniform(-np.pi, np.pi, 12), rng.integers(1, 5, 12),
                                     rng.integers(0, 3, 12))]
        frames.append((SimpleNamespace(
            context=SimpleNamespace(laser_calibrations=[calib]),
            pose=SimpleNamespace(transform=frame_pose.reshape(-1).tolist()),
            timestamp_micros=1_550_083_467_346_370 + 100_000 * i, laser_labels=labels),
            {1: [ri]}, pose_ri))
    return frames


def _tree_files(root: Path) -> dict:
    return {p.relative_to(root): p for p in sorted(root.rglob("*")) if p.is_file()}


def same_corpus(a: Path, b: Path) -> list:
    """The files that differ between two converted corpora: Feather files
    column by column, bit for bit (dtype and bytes), others byte for byte."""
    import numpy as np

    from range_view_3d_detection_torch.utils.feather import read_feather

    fa, fb = _tree_files(a), _tree_files(b)
    bad = [str(p) for p in set(fa) ^ set(fb)]
    for rel in sorted(set(fa) & set(fb)):
        if rel.suffix != ".feather":
            if fa[rel].read_bytes() != fb[rel].read_bytes():
                bad.append(str(rel))
            continue
        ca, cb = read_feather(fa[rel]), read_feather(fb[rel])
        same = list(ca) == list(cb) and all(
            ca[k].dtype == cb[k].dtype and (
                list(ca[k]) == list(cb[k]) if ca[k].dtype == object
                else np.array_equal(ca[k].view(np.uint8), cb[k].view(np.uint8)))
            for k in ca)
        if not same:
            bad.append(str(rel))
    return bad


def convert_rank(argv) -> int:
    """Phase 29's conversions, in a process of their own where JAX,
    pyarrow, the JAX package, ``converters/`` and ``tools/`` cannot be
    imported: ``chip_smoke.py convert WORK``. Converts WORK/raw_av2 with
    the native z-buffer and again with ``z_buffer_numpy`` in its place, its
    LZ4-compressed copy WORK/raw_av2_lz4, WORK/raw_nuscenes, and Waymo
    frames made here; prints one ``chip_smoke_convert {json}`` line."""
    import importlib.abc

    class Ban(importlib.abc.MetaPathFinder):
        # An import hook rather than ``sys.modules[name] = None``: scipy
        # probes ``sys.modules`` for jax and takes a None entry for the module.
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED_IN_CONVERSION:
                raise ImportError(f"{name} may not be imported by the conversion")

    sys.meta_path.insert(0, Ban())
    sys.path.insert(0, str(REPO))
    import numpy as np

    from range_view_3d_detection_torch.converters.av2 import export as av2_export
    from range_view_3d_detection_torch.converters.nuscenes import export as nusc_export
    from range_view_3d_detection_torch.converters.waymo import export as waymo_export
    from range_view_3d_detection_torch.converters.waymo import metadata as waymo_metadata
    from range_view_3d_detection_torch.data import native_io
    from range_view_3d_detection_torch.ops.projection import z_buffer_numpy
    from range_view_3d_detection_torch.utils.feather import read_feather

    work = Path(argv[0])
    out: dict = {}
    t0 = time.perf_counter()
    native_io.library()
    out["build_s"] = time.perf_counter() - t0
    raw = work / "raw_av2"
    sweeps = sorted(raw.rglob("sensors/lidar/*.feather"))
    n_points = sum(len(read_feather(p, ["x"])["x"]) for p in sweeps)
    t0 = time.perf_counter()
    av2_export.export_dataset(str(raw), str(work / "av2"), height=64, width=1800)
    out["av2_s"] = time.perf_counter() - t0
    av2_export.z_buffer_native = z_buffer_numpy
    t0 = time.perf_counter()
    av2_export.export_dataset(str(raw), str(work / "av2_numpy"), height=64, width=1800)
    out["av2_numpy_s"] = time.perf_counter() - t0
    out["av2_sweeps"], out["av2_points"] = len(sweeps), n_points
    out["av2_differ"] = same_corpus(work / "av2", work / "av2_numpy")
    t0 = time.perf_counter()
    av2_export.z_buffer_native = native_io.z_buffer_native
    av2_export.export_dataset(str(work / "raw_av2_lz4"), str(work / "av2_lz4"), height=64,
                              width=1800)
    out["av2_lz4_s"] = time.perf_counter() - t0
    out["av2_lz4_differ"] = same_corpus(work / "av2", work / "av2_lz4")
    out["av2_files"] = len(_tree_files(work / "av2"))
    rv = [read_feather(p) for p in sorted((work / "av2").rglob("range_view/*.feather"))]
    out["av2_valid_pixels"] = [int((c["range"] > 0).sum()) for c in rv]
    out["av2_roi_share"] = float(np.mean([c["is_within_roi"][c["range"] > 0].mean() for c in rv]))
    ann = [read_feather(p) for p in sorted((work / "av2").rglob("annotations.feather"))]
    out["av2_boxes"] = sum(len(a["num_interior_pts"]) for a in ann)
    out["av2_boxes_with_points"] = sum(int((a["num_interior_pts"] > 0).sum()) for a in ann)
    out["av2_boxes_in_roi"] = sum(int(a["is_within_roi"].sum()) for a in ann)

    t0 = time.perf_counter()
    nusc_export.export_dataset(str(work / "raw_nuscenes"), str(work / "nuscenes"),
                               version="v1.0-mini", height=32, width=1800)
    out["nuscenes_s"] = time.perf_counter() - t0
    nusc = [read_feather(p) for p in sorted((work / "nuscenes").rglob("range_view/*.feather"))]
    out["nuscenes_sweeps"] = len(nusc)
    out["nuscenes_points"] = int(sum(len(np.fromfile(p, np.float32)) // 5 for p in
                                     (work / "raw_nuscenes" / "samples").rglob("*.pcd.bin")))
    out["nuscenes_shapes"] = sorted({len(c["range"]) for c in nusc})
    out["nuscenes_valid_pixels"] = [int((c["range"] > 0).sum()) for c in nusc]

    frames = waymo_frames(2, seed=SEED + 29)
    t0 = time.perf_counter()
    n = waymo_export.export_log(None, work / "waymo" / "train" / "segment-0", frames=frames,
                                export_cameras=False)
    out["waymo_s"] = time.perf_counter() - t0
    sys.argv = ["metadata", "--root-dir", str(work / "waymo"), "--out",
                str(work / "waymo_metadata.feather")]
    waymo_metadata.main()
    meta = read_feather(work / "waymo_metadata.feather")
    wrv = [read_feather(p) for p in sorted((work / "waymo").rglob("range_view/*.feather"))]
    out["waymo_sweeps"], out["waymo_pixels"] = n, 64 * 2650 * n
    out["waymo_shapes"] = sorted({len(c["range"]) for c in wrv})
    out["waymo_num_pts"] = [int(x) for x in meta["num_pts"]]
    out["waymo_valid_pixels"] = [int((c["range"] > 0).sum()) for c in wrv]
    out["finite"] = all(bool(np.isfinite(c[k]).all()) for c in rv + nusc + wrv for k in c
                        if c[k].dtype.kind == "f")
    out["banned_imported"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in BANNED_IN_CONVERSION)
    print("chip_smoke_convert " + json.dumps(out), flush=True)
    return 0


def converted_phase(device, smi) -> dict:
    """Phase 29 (see the module docstring). Returns the launches of K1 and
    K2 while the converted corpus trains, validates and serves."""
    import numpy as np
    import torch

    from range_view_3d_detection_torch.data import native_io
    from range_view_3d_detection_torch.evaluation.av2_eval import evaluate_predictions
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.kernels.stem import meta_kernel_fused
    from range_view_3d_detection_torch.models.decoder import DecoderConfig
    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.training.loop import Trainer
    from range_view_3d_detection_torch.utils.config import compose
    from range_view_3d_detection_torch.utils.lz4 import lz4_frame_decompress_py

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-converted-"))
    try:
        categories = compose(REPO / "conf", "rv-av2")["model"]["tasks"][0]
        t0 = time.perf_counter()
        for k, (split, (log_id, sweeps)) in enumerate(RAW_AV2_LOGS.items()):
            write_raw_av2_log(work / "raw_av2" / split / log_id, sweeps=sweeps,
                              seed=SEED + 290 + k, categories=categories)
        write_raw_nuscenes(work / "raw_nuscenes", seed=SEED + 292)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lz4_buffers = lz4_copy(work / "raw_av2", work / "raw_av2_lz4")
        lz4_write_s = time.perf_counter() - t0

        # 1-2. Conversion without JAX or pyarrow; the AV2 corpus against the
        # same conversion on z_buffer_numpy.
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "convert",
                               str(work)], capture_output=True, text=True, timeout=600,
                              cwd=REPO)
        convert_wall = time.perf_counter() - t0
        lines = [x for x in proc.stdout.splitlines() if x.startswith("chip_smoke_convert ")]
        check(proc.returncode == 0 and len(lines) == 1,
              f"conversion subprocess failed (rc {proc.returncode}):\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-3000:]}")
        conv = json.loads(lines[0].split(" ", 1)[1])
        check(not conv["banned_imported"], f"conversion imported {conv['banned_imported']}")
        check(not conv["av2_differ"], f"AV2 corpus differs from the numpy z-buffer's: "
              f"{conv['av2_differ']}")
        check(not conv["av2_lz4_differ"], f"AV2 corpus from LZ4 logs differs: "
              f"{conv['av2_lz4_differ']}")
        check(conv["finite"], "a converted column holds non-finite values")
        check(conv["av2_sweeps"] == 6 and min(conv["av2_valid_pixels"]) > 30_000,
              f"AV2: {conv['av2_sweeps']} sweeps, valid pixels {conv['av2_valid_pixels']}")
        check(conv["av2_boxes_with_points"] == conv["av2_boxes"] > 0,
              f"AV2: {conv['av2_boxes_with_points']} of {conv['av2_boxes']} boxes hold points")
        check(0 < conv["av2_roi_share"] < 1 and 0 < conv["av2_boxes_in_roi"],
              f"AV2 ROI: point share {conv['av2_roi_share']}, boxes {conv['av2_boxes_in_roi']}")
        check(conv["nuscenes_sweeps"] == 2 and conv["nuscenes_shapes"] == [32 * 1800]
              and min(conv["nuscenes_valid_pixels"]) > 10_000, f"nuScenes: {conv}")
        check(conv["waymo_sweeps"] == 2 and conv["waymo_shapes"] == [64 * 2650]
              and conv["waymo_num_pts"] == conv["waymo_valid_pixels"], f"Waymo: {conv}")
        av2_per_sweep = conv["av2_s"] / conv["av2_sweeps"]
        say(f"converted (phase 29): raw logs written in {write_s:.1f} s, their LZ4 copy in "
            f"{lz4_write_s:.1f} s ({lz4_buffers} buffers); conversion process "
            f"{convert_wall:.1f} s wall without jax, pyarrow or the JAX package (native "
            f"build {conv['build_s']:.2f} s); AV2 {conv['av2_sweeps']} sweeps of "
            f"{conv['av2_points'] // conv['av2_sweeps']} points at 64x1800: "
            f"{av2_per_sweep:.3f} s a sweep, {conv['av2_points'] / conv['av2_s']:.0f} points/s "
            f"(numpy z-buffer {conv['av2_numpy_s'] / conv['av2_sweeps']:.3f} s a sweep), "
            f"{conv['av2_files']} files bit-equal to the numpy z-buffer's and to the LZ4 "
            f"logs' ({conv['av2_lz4_s'] / conv['av2_sweeps']:.3f} s a sweep), valid pixels "
            f"{conv['av2_valid_pixels']}, ROI share {conv['av2_roi_share']:.3f}, "
            f"{conv['av2_boxes']} boxes ({conv['av2_boxes_in_roi']} in the ROI); nuScenes "
            f"{conv['nuscenes_sweeps']} sweeps at 32x1800: {conv['nuscenes_s'] / 2:.3f} s a "
            f"sweep, {conv['nuscenes_points'] / conv['nuscenes_s']:.0f} points/s; Waymo "
            f"{conv['waymo_sweeps']} frames at 64x2650: {conv['waymo_s'] / 2:.3f} s a frame, "
            f"{conv['waymo_pixels'] / conv['waymo_s']:.0f} pixels/s, metadata "
            f"{conv['waymo_num_pts']} points; on {smi}")

        # 3. The native LZ4 decoder against its twin and the original bytes.
        sweep = next((work / "raw_av2").rglob("sensors/lidar/*.feather")).read_bytes()
        data = lz4_test_data(sweep, SEED + 293)
        lz4_rows = []
        for tag, kw in (("linked 64 KB blocks", {}),
                        ("independent 256 KB blocks, checksums, content size",
                         dict(block_size=1 << 18, linked=False, block_checksum=True,
                              content_checksum=True, content_size=True))):
            stats: dict = {}
            t0 = time.perf_counter()
            frame = lz4_frame_compress(data, stats=stats, **kw)
            enc_s = time.perf_counter() - t0
            got = native_io.lz4_frame_decompress(frame, len(data))
            t0 = time.perf_counter()
            twin = lz4_frame_decompress_py(frame, len(data))
            twin_s = time.perf_counter() - t0
            check(got == data and twin == data, f"LZ4 ({tag}): decoded bytes differ")
            if not kw:
                check(stats["into_earlier_block"] > 0 and stats["overlapping"] > 0
                      and stats["raw_blocks"] > 0, f"LZ4 frame lacks a case: {stats}")
            times = []
            for _ in range(7):
                t0 = time.perf_counter()
                native_io.lz4_frame_decompress(frame, len(data))
                times.append(time.perf_counter() - t0)
            native_s = statistics.median(times)
            lz4_rows.append(f"{tag}: {len(data)} -> {len(frame)} bytes, {stats}, native "
                            f"{len(data) / native_s / 1e6:.0f} MB/s (median of 7), twin "
                            f"{len(data) / twin_s / 1e6:.2f} MB/s, encoder {enc_s:.2f} s")
        say("LZ4 (phase 29), decoded equal to the twin and the original: "
            + "; ".join(lz4_rows) + f"; host of {smi}")

        # 4. The AV2 corpus converted from the LZ4 logs trains 2 steps at B=2,
        # validates and is evaluated (its copied LZ4 poses and the map: ROI
        # filtering).
        corpus = work / "av2_lz4"
        cfg = compose(REPO / "conf", "rv-av2", [
            f"++dataset.root_dir={corpus}", f"++run_dir={work / 'run'}",
            "++trainer.max_epochs=1", "++model.batch_size=2", "++model.train_log_freq=0"])
        trainer = Trainer(cfg)
        check(trainer.device.type == "cuda" and len(trainer.train_ds) == 4
              and len(trainer.val_ds) == 2,
              f"trainer on {trainer.device}, {len(trainer.train_ds)} train sweeps")
        torch.cuda.synchronize()
        meta_kernel_fused.launches = 0
        nms_scan.launches = 0
        t0 = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        check(state.step == 2, f"converted corpus: step {state.step}")
        losses = [json.loads(x).get("loss") for x in
                  (Path(cfg["run_dir"]) / "metrics.jsonl").read_text().splitlines()]
        t0 = time.perf_counter()
        pred_dir = trainer.validate()
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        shards = sorted(pred_dir.glob("*.feather"))
        check(len(shards) == 2, f"converted corpus: {len(shards)} shards")
        t0 = time.perf_counter()
        metrics = evaluate_predictions(pred_dir, corpus / "val", trainer.categories)
        eval_s = time.perf_counter() - t0
        avg = metrics["AVERAGE_METRICS"]
        check(all(math.isfinite(v) for v in avg.values()), f"AVERAGE_METRICS {avg}")
        batch = next(iter(trainer.val_loader))
        del trainer, state

        # 5. One batch of the corpus through the flagship Predictor.
        request = (batch["features"], batch["cart"], batch["mask"])
        check(request[0].shape == (2, 64, 1808, 5), f"served batch {request[0].shape}")
        predictor = flagship_predictor(serving._flagship_config(), DecoderConfig(), device,
                                       torch.Generator().manual_seed(SEED + 294), request)
        t0 = time.perf_counter()
        result = predictor(*request)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
        kept = check_results([result])
        launches = {"K1": meta_kernel_fused.launches, "K2": nms_scan.launches}
        check(launches["K1"] > 0 and launches["K2"] > 0, f"converted launches {launches}")
        say(f"converted corpus (phase 29, from the LZ4 logs): rv-av2 at B=2, 2 steps in "
            f"{fit_s:.2f} s (losses "
            f"{[round(x, 4) for x in losses if x is not None]}), validate {val_s:.2f} s "
            f"({len(shards)} shards), evaluator {eval_s:.3f} s with the copied poses and map, "
            f"AVERAGE_METRICS " + ", ".join(f"{k} {v:.4f}" for k, v in avg.items())
            + f"; one val batch served by the flagship Predictor in {serve_ms:.1f} ms (first "
            f"call), kept {kept}; launches {launches}; phase "
            f"{time.perf_counter() - t_phase:.0f} s on {smi}")
        del predictor
        return {"meta_kernel_fused": launches["K1"], "nms_scan": launches["K2"],
                "conv3x3_i8_fused": 0, "meta_kernel_fused_i8": 0}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# Phases 30-38: the bench and the measurement tools, driven as users run
# them. Cuts in depth (never in the bench's width) are printed where made.
BENCH_MODES = (  # (tag, arguments, RV3D_STEM_INT8)
    ("int8", [], False),
    ("bf16", ["--fp"], False),
    ("points", ["--points"], False),
    ("int8 K4 stem", [], True),
)
# The kernels each in-process bench mode must launch (> 0) and not (== 0).
BENCH_EXPECT = {
    "int8": ({"meta_kernel_fused", "nms_scan", "conv3x3_i8_fused"}, {"meta_kernel_fused_i8"}),
    "bf16": ({"meta_kernel_fused", "nms_scan"}, {"conv3x3_i8_fused", "meta_kernel_fused_i8"}),
    "points": ({"meta_kernel_fused", "nms_scan", "conv3x3_i8_fused"}, {"meta_kernel_fused_i8"}),
    "int8 K4 stem": ({"meta_kernel_fused_i8", "nms_scan", "conv3x3_i8_fused"},
                     {"meta_kernel_fused"}),
}
TOOLS_ENV = ("RV3D_STEM_INT8", "RV3D_BENCH_POINTS", "RV3D_BENCH_BATCH", "RV3D_COMPILER_OPTIONS")


def _env(**extra) -> dict:
    import os

    env = {k: v for k, v in os.environ.items() if k not in TOOLS_ENV}
    env.update(extra)
    return env


def _set_stem_int8(on: bool) -> None:
    import os

    if on:
        os.environ["RV3D_STEM_INT8"] = "1"
    else:
        os.environ.pop("RV3D_STEM_INT8", None)


def bench_json(stdout: str) -> dict:
    """The bench's JSON line: the last line of its output that parses as
    an object with a ``metric``."""
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "metric" in obj:
                return obj
    raise RuntimeError(f"chip_smoke: no bench JSON line in {stdout[-2000:]!r}")


def check_bench_line(tag: str, line: dict, kind: str, smi: str) -> None:
    check(line["metric"] == "e2e_frames_per_sec_per_chip" and line["unit"] == "frames/s",
          f"bench {tag}: {line}")
    check(line["value"] > 0 and line["p50_ms"] <= line["p90_ms"], f"bench {tag}: {line}")
    check(kind in line["device"] and line["device"] == smi, f"bench {tag}: device "
          f"{line['device']!r}, card {kind!r} ({smi})")
    check(line["batch"] == 2 and "eager" in line["mode"], f"bench {tag}: {line}")


def bench_phase(device, kind: str, smi: str) -> dict:
    """Phase 30 (see the module docstring). Returns the in-process launch
    counts by mode."""
    import torch

    from range_view_3d_detection_torch import bench, serving
    from range_view_3d_detection_torch.models.decoder import DecoderConfig

    t_phase = time.perf_counter()
    for tag, args, stem in BENCH_MODES:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "range_view_3d_detection_torch.bench", *args],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env=_env(**({"RV3D_STEM_INT8": "1"} if stem else {})),
        )
        check(proc.returncode == 0, f"bench {tag} exited {proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        line = bench_json(proc.stdout)
        check_bench_line(tag, line, kind, smi)
        say(f"bench (phase 30) python -m range_view_3d_detection_torch.bench {' '.join(args)}"
            f"{' with RV3D_STEM_INT8=1' if stem else ''}: {json.dumps(line)} "
            f"({time.perf_counter() - t0:.1f} s)")

    launches = {}
    for tag, args, stem in BENCH_MODES:
        _set_stem_int8(stem)
        try:
            reset_counts()
            line = bench.main(args)
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            _set_stem_int8(False)
        check_bench_line(f"{tag} in process", line, kind, smi)
        need, never = BENCH_EXPECT[tag]
        check(all(counts[k] > 0 for k in need) and all(counts[k] == 0 for k in never),
              f"bench {tag}: launches {counts}")
        launches[tag] = counts
        say(f"bench (phase 30) {tag} in process: {line['value']} frames/s, p50 "
            f"{line['p50_ms']} ms, p90 {line['p90_ms']} ms, launches {counts}")

    # The bench's int8 pipeline against Predictor.quantize from the same
    # seeded weights and batch.
    pipeline, args, _, path = bench.build(2, device=device)
    cfg = serving._flagship_config()
    ref = serving.Predictor(cfg, DecoderConfig(), device=device,
                            generator=torch.Generator().manual_seed(0))
    ref.quantize([serving._sample_inputs(2, 64, 1808, cfg.in_channels)], scope="full")
    got, want = pipeline(*args), ref(*args)
    check(path == "int8" and torch.equal(got.keep, want.keep),
          f"bench int8 pipeline: keep differs from Predictor.quantize ({path})")
    err = (got.cuboids - want.cuboids)[want.keep].abs().max().item()
    say(f"bench (phase 30) int8 pipeline == Predictor.quantize on the same seeded weights "
        f"and batch: keep equal ({int(want.keep.sum())} kept), cuboids max|diff| {err:.3g}")
    check(err <= 1e-3, f"bench int8 pipeline: cuboids differ by {err}")
    del pipeline, ref, got, want

    # A quantization that fails makes the bench fail: no bf16 fallback.
    code = ("import sys; from range_view_3d_detection_torch import bench, serving\n"
            "def broken(self, *a, **k):\n    raise RuntimeError('quantization made to fail')\n"
            "serving.Predictor.quantize = broken\nbench.main([])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env=_env())
    check(proc.returncode != 0 and '"metric"' not in proc.stdout
          and "quantization made to fail" in proc.stderr,
          f"bench with a failing quantization: rc {proc.returncode}, {proc.stdout[-500:]!r}")
    say(f"bench (phase 30): a failing quantization exits {proc.returncode} with no JSON "
        f"line; phase {time.perf_counter() - t_phase:.0f} s")
    return launches


def tools_phases(device, kind: str, smi: str, *, fwd_ms: float, dec_ms: float,
                 step_ms: float, remat_ms: float, phase18: dict) -> dict:
    """Phases 31-38 (see the module docstring). ``fwd_ms`` and ``dec_ms``
    are phase 6's device ms of a B=2 request's forward and decode + NMS,
    ``step_ms`` and ``remat_ms`` phases 16's and 22's ms a B=2 step, and
    ``phase18`` phase 18's trained run. Returns the launch counts of phases
    31-36 and of phase 37."""
    import torch

    from range_view_3d_detection_torch.tools import (
        benchmark,
        flops,
        profile_forward,
        profile_trace,
        profile_train,
        quant_accuracy,
        quant_cert_scale,
        remat_grid,
        scale_drill,
    )

    work = Path(tempfile.mkdtemp(prefix="chip-smoke-tools-"))
    try:
        reset_counts()
        # 31. The staged benchmark, the loader and the train step.
        t0 = time.perf_counter()
        rep = benchmark.main(["--synthetic", "--work", str(work / "bench"), "--iters", "10"])
        keys = ("backbone_head_ms", "decode_ms", "nms_ms", "e2e_ms", "fps", "projection_ms",
                "points_e2e_ms", "points_fps", "num_points", "metrics", "device")
        check(all(k in rep for k in keys) and rep["nms_ms"] >= 0
              and "AVERAGE_METRICS" in rep["metrics"] and rep["device"] == smi,
              f"tools.benchmark --synthetic: {sorted(rep)}")
        say(f"tools.benchmark (phase 31) --synthetic: forward {rep['backbone_head_ms']} ms, "
            f"decode {rep['decode_ms']} ms, NMS {rep['nms_ms']} ms, e2e {rep['e2e_ms']} ms, "
            f"points {rep['points_e2e_ms']} ms (projection {rep['projection_ms']} ms), mAP "
            f"{rep['metrics']['AVERAGE_METRICS']['AP']} ({time.perf_counter() - t0:.1f} s; "
            f"--iters 10, a cut from 20) on {smi}")
        t0 = time.perf_counter()
        rep = benchmark.main(["--loader", "--work", str(work / "loader")])
        check(rep["frames_timed"] > 0 and rep["frames_timed"] % 3 == 0
              and rep["shape"] == [64, 1800],
              f"tools.benchmark --loader: {rep}")
        say(f"tools.benchmark (phase 31) --loader at 64x1800: {rep['loader_frames_per_sec']} "
            f"frames/s over {rep['frames_timed']} frames, {rep['workers']} workers "
            f"({time.perf_counter() - t0:.1f} s, the card machine's host CPU)")
        rep = benchmark.main(["--train", "--batch", "2", "--iters", "4"])
        check(math.isfinite(rep["loss"]) and rep["remat"], f"tools.benchmark --train: {rep}")
        say(f"tools.benchmark (phase 31) --train B=2 (remat, the default at B=2), 4 iters: "
            f"{rep['train_step_ms']} ms a step, {rep['train_frames_per_sec_per_chip']} "
            f"frames/s; phase 16 {step_ms:.3f} ms without remat, phase 22 {remat_ms:.3f} ms "
            f"with it (CUDA events) on {smi}")

        # 32. Traces and stage times.
        t0 = time.perf_counter()
        summary = profile_trace.main(["--decode", "--batch", "2", "--out",
                                      str(work / "trace"), "--top", "15"])
        names = list(summary["by_name"])
        k1 = [n for n in names if "meta_kernel_fused" in n]
        k2 = [n for n in names if any(k in n for k in ("nms_mask", "nms_keep", "nms_merge"))]
        check(k1 and len(k2) == 3, f"profile_trace: K1 {k1}, K2 {k2} among {names[:40]}")
        say(f"tools.profile_trace (phase 32) B=2 forward + decode + NMS: device time "
            f"{summary['total_ms']:.3f} ms over {summary['events']} events (phase 6: forward "
            f"{fwd_ms:.3f} + decode/NMS {dec_ms:.3f} = {fwd_ms + dec_ms:.3f} ms, CUDA events); "
            f"K1 {k1}, K2 {k2} ({time.perf_counter() - t0:.1f} s) on {smi}")
        stages = profile_forward.main([])
        check(all(math.isfinite(stages[k]) and stages[k] > 0
                  for k in ("stem_ms", "backbone_ms", "heads_ms", "full_forward_ms")),
              f"profile_forward: {stages}")
        say(f"tools.profile_forward (phase 32) B=1: {json.dumps(stages)}")

        # 33. FLOPs and bytes per stage.
        t0 = time.perf_counter()
        rep = flops.main(["--train"])
        want_k1 = k1_cost(1, 64, 1808, 256)[0]
        got_k1 = rep["kernel_gflop"].get("meta_kernel_fused", 0.0) * 1e9
        check(abs(got_k1 - want_k1) <= 1e-6 * want_k1, f"flops: K1 {got_k1} != {want_k1}")
        rows = {k: v for k, v in rep.items() if isinstance(v, dict) and "gflop" in v}
        check(all(math.isfinite(v["gflop"]) and v["gbytes"] > 0 for v in rows.values())
              and "train_step" in rows, f"flops rows {rows}")
        fwd_tflops = 2 * rows["forward"]["gflop"] / fwd_ms  # B=2 from B=1's count
        say(f"tools.flops (phase 33) B=1 64x1808: " + "; ".join(
            f"{k} {v['gflop']} GFLOP {v['gbytes']} GB" for k, v in rows.items())
            + f"; K1 {got_k1 / 1e9:.3f} GFLOP == k1_cost; forward achieved "
            f"{fwd_tflops:.2f} TFLOP/s (2 x {rows['forward']['gflop']} GFLOP in phase 6's "
            f"{fwd_ms:.3f} ms at B=2) on {smi}; speed of light: {rep['speed_of_light']} "
            f"({time.perf_counter() - t0:.1f} s)")

        # 34. Remat grid (3 of its 8 scopes, 2 iters: a cut) and profile_train.
        t0 = time.perf_counter()
        grid = remat_grid.grid((None, remat_grid.SCOPES[1], ("stem", "loss")), 2, 2, device)
        check(len(grid) == 3 and all("ms_per_step" in r or "infeasible" in r for r in grid),
              f"remat_grid: {grid}")
        say(f"tools.remat_grid (phase 34) B=2, 2 iters, scopes off / all / stem+loss (3 of "
            f"8: a cut): {json.dumps(grid)} ({time.perf_counter() - t0:.1f} s) on {smi}")
        rows = profile_train.main(["--batches", "2", "--iters", "4"])
        check(len(rows) == 2 and all("ms_per_step" in r for r in rows),
              f"profile_train: {rows}")
        say(f"tools.profile_train (phase 34) B=2 only, 4 iters (a cut from B=1,2,4 x 8): "
            f"{json.dumps(rows)}")

        torch.cuda.synchronize()
        before = read_counts()
        # 35. quant_accuracy on phase 18's run.
        quant_counts = quant_phase(phase18, work, smi)

        # 36. quant_cert_scale and scale_drill, cut in depth.
        reset_counts()
        t0 = time.perf_counter()
        agg = quant_cert_scale.main(["--seeds", "1", "--epochs", "2", "--sweeps-per-log", "8",
                                     "--work", str(work / "cert")])
        check(agg["seeds"] == 1 and math.isfinite(agg["ptq_cds_delta_mean"]),
              f"quant_cert_scale: {agg}")
        say(f"tools.quant_cert_scale (phase 36) --seeds 1 --epochs 2 --sweeps-per-log 8 (cut "
            f"from 3 seeds x 40 epochs x 24 sweeps): {agg['num_val_gts']} val boxes, PTQ AP "
            f"delta {agg['ptq_ap_delta_mean']:.4f}, CDS delta {agg['ptq_cds_delta_mean']:.4f} "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        walls = scale_drill.main(["--sweeps", "100", "--logs", "2", "--dense",
                                  "--work", str(work / "drill")])
        check(walls["sweeps"] == 100 and walls["loader_frames"] == 100
              and walls["num_dets"] > 0, f"scale_drill: {walls}")
        say(f"tools.scale_drill (phase 36) --sweeps 100 --logs 2 --dense (cut from 1000 x "
            f"10): {json.dumps(walls)} ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.synchronize()
        tools_counts = {k: v + before[k] + quant_counts[k] for k, v in read_counts().items()}
        check(tools_counts["meta_kernel_fused"] > 0 and tools_counts["nms_scan"] > 0
              and tools_counts["conv3x3_i8_fused"] > 0
              and tools_counts["meta_kernel_fused_i8"] > 0, f"tools launches {tools_counts}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    compile_counts = compile_phase(device, smi)
    dryrun_phase(device, smi)
    return {"tools": tools_counts, "compile": compile_counts}


def quant_phase(phase18: dict, work: Path, smi: str) -> dict:
    """Phase 35: ``tools.quant_accuracy`` on phase 18's trained run.
    Returns the launch counts of its three runs together."""
    import torch

    from range_view_3d_detection_torch.tools import quant_accuracy
    from range_view_3d_detection_torch.training.checkpoints import CheckpointManager

    t0 = time.perf_counter()
    trainer = phase18["trainer"]
    CheckpointManager(trainer.run_dir / "checkpoints").save(
        trainer.state.step, trainer.state, trainer.cfg)
    fp_same = quant_accuracy.score(phase18["pred_dir"], trainer.cfg, trainer.categories)
    fp_same = fp_same["AVERAGE_METRICS"]["AP"]
    check(fp_same == phase18["fp_map"], f"quant_accuracy's scoring of phase 18's "
          f"predictions: {fp_same} != {phase18['fp_map']}")
    base = ["--run-dir", str(trainer.run_dir), "--calib-batches", "2"]
    total = dict.fromkeys(read_counts(), 0)
    for tag, extra, stem in (("PTQ", [], False), ("PTQ, K4 stem", [], True),
                             ("QAT 20 steps", ["--qat-steps", "20"], False)):
        _set_stem_int8(stem)
        try:
            reset_counts()
            out = quant_accuracy.main(base + ["--out", str(work / f"quant_{len(tag)}")] + extra)
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            _set_stem_int8(False)
        total = {k: v + counts[k] for k, v in total.items()}
        # The int8 stem runs K4; else the stem is K1 only where the config
        # sets stem_pallas (rv-synthetic does not: the accumulate stem).
        stems = {"meta_kernel_fused_i8": stem,
                 "meta_kernel_fused": not stem and trainer.det_cfg.stem_pallas}
        check(counts["conv3x3_i8_fused"] > 0 and counts["nms_scan"] > 0
              and all((counts[k] > 0) == want for k, want in stems.items()),
              f"quant_accuracy {tag}: launches {counts}")
        check(all(math.isfinite(out[f"mean_ap_{n}"]) for n in ("fp", "int8")),
              f"quant_accuracy {tag}: {out}")
        qat = (f", int8 QAT {out['mean_ap_int8_qat']:.4f} (not deterministic on a card: "
               f"cuDNN's bf16 backward)" if "mean_ap_int8_qat" in out else "")
        say(f"tools.quant_accuracy (phase 35) {tag}: mAP fp {out['mean_ap_fp']:.4f} "
            f"(artifact, BatchNorm folded), int8 {out['mean_ap_int8']:.4f}{qat}; AP delta "
            f"{out['mean_ap_delta']:.4f}, CDS delta {out['mean_cds_delta']:.4f}; phase 18: "
            f"fp {phase18['fp_map']:.4f} (the tool's scoring of its predictions: "
            f"{fp_same:.4f}), PTQ {phase18['ptq_map']:.4f}; launches {counts} on {smi}")
    say(f"tools.quant_accuracy (phase 35): {time.perf_counter() - t0:.1f} s")
    return total


def compile_config():
    """Phase 37's model: the tiny config at 32 channels in bf16 with the K1
    stem (K1 takes bf16 and C a multiple of 32)."""
    import dataclasses

    from range_view_3d_detection_torch import serving

    return dataclasses.replace(serving._flagship_config(tiny=True), layers=(32,) * 5,
                               dtype="bfloat16", stem_pallas=True)


def compile_phase(device, smi) -> dict:
    """Phase 37: the pipeline under ``RV3D_COMPILER_OPTIONS``."""
    import os

    import torch

    from range_view_3d_detection_torch import bench, serving
    from range_view_3d_detection_torch.models.decoder import DecoderConfig, decode
    from range_view_3d_detection_torch.utils import compile_opts

    t0 = time.perf_counter()
    cfg = compile_config()
    dec = DecoderConfig(nms_cap=256, min_confidence=0.0)
    predictor = serving.Predictor(cfg, dec, device=device,
                                  generator=torch.Generator().manual_seed(SEED + 37))
    model = predictor.model
    args = tuple(torch.as_tensor(a, device=device) for a in serving._sample_inputs(1, 16, 256, 5))

    def pipeline(feats, cart, mask):
        with torch.no_grad():
            out = model(feats, cart, mask)
            return out["head"][1][0], decode(out, dec, cfg.tasks_dict, use_nms=True)

    heads, want = pipeline(*args)
    option = "max_autotune=False"
    os.environ[compile_opts.ENV_VAR] = option
    try:
        compiled = compile_opts.jit_env_options(pipeline)
        check(compiled is not pipeline, "jit_env_options ignored the options")
        t1 = time.perf_counter()
        compiled(*args)
        compile_s = time.perf_counter() - t1
        reset_counts()
        got_heads, got = compiled(*args)
        torch.cuda.synchronize()
        counts = read_counts()
        os.environ[compile_opts.ENV_VAR] = "no_such_option=1"
        try:
            compile_opts.jit_env_options(pipeline)(*args)
        except RuntimeError as e:
            refused = str(e).split(",")[0]
        else:
            check(False, "an unknown compiler option was accepted")
    finally:
        os.environ.pop(compile_opts.ENV_VAR, None)
    check(counts["meta_kernel_fused"] > 0 and counts["nms_scan"] > 0,
          f"compiled pipeline launches {counts}")
    check(torch.equal(got.keep, want.keep) and bool(want.keep.any()),
          f"compiled pipeline: keep differs from eager or is empty ({int(want.keep.sum())})")
    errs = {}
    for key in ("logits", "regressands"):
        ref = heads[key].float()
        err = (got_heads[key].float() - ref).abs().max().item()
        check(err <= 2e-2 * ref.abs().max().item(), f"compiled {key}: max|diff| {err}")
        errs[key] = err
    # The bench's own compiled path on the same config.
    os.environ[compile_opts.ENV_VAR] = option
    try:
        bench_kw = dict(fp=True, device=device, cfg=cfg, height=16, width=256,
                        state_dict=model.state_dict())
        served, bench_args, _, _ = bench.build(1, **bench_kw)
    finally:
        os.environ.pop(compile_opts.ENV_VAR, None)
    eager, _, _, _ = bench.build(1, **bench_kw)
    got_b, want_b = served(*bench_args), eager(*bench_args)
    check(torch.equal(got_b.keep, want_b.keep), "the bench compiled: keep differs from eager")
    say(f"compile (phase 37) RV3D_COMPILER_OPTIONS={option}, the tiny config at 32 channels "
        f"bf16 with K1, B=1 16x256 (the flagship not compiled: a cut): compiled in "
        f"{compile_s:.1f} s, keep equal to eager ({int(want.keep.sum())} kept), heads "
        f"max|diff| {errs}, launches {counts}; the bench's compiled pipeline keep equal to "
        f"its eager one; an unknown option raises ({refused}); phase "
        f"{time.perf_counter() - t0:.0f} s on {smi}")
    return counts


def dryrun_phase(device, smi) -> None:
    """Phase 38: ``dryrun.entry()`` and ``dryrun_multichip`` over NCCL."""
    import torch

    from range_view_3d_detection_torch import dryrun

    t0 = time.perf_counter()
    model, inputs = dryrun.entry()
    with torch.inference_mode():
        out = model(*inputs)
    head = out["head"][1][0]
    check(all(bool(torch.isfinite(v).all()) for v in head.values()), "entry(): non-finite")
    del model, inputs, out, head
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    results = dryrun.dryrun_multichip(n)
    check(all(r["status"] == "ok" for r in results.values()) and len(results) == 4,
          f"dryrun_multichip({n}): {results}")
    say(f"dryrun (phase 38): entry() finite; dryrun_multichip({n}) over NCCL: "
        + "; ".join(f"{k} {v['result']}" for k, v in results.items())
        + f" ({time.perf_counter() - t0:.0f} s) on {smi}")


def flagship_predictor(cfg, dec, device, gen, request):
    """Phase 5's predictor: ``cfg`` with weights drawn from ``gen``,
    non-trivial BatchNorm statistics, and each head's final conv scaled to
    a set output spread on ``request``."""
    import torch

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.models.stems import MetaKernel

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
    # Scale each head's final conv to a set output spread (random deep
    # weights make the raw spread arbitrary), with the classification bias
    # at 0 so sigmoid ~ 0.5 and the NMS slots hold overlapping proposals.
    with torch.inference_mode():
        first = model(*(torch.as_tensor(a, device=device) for a in request))
    with torch.no_grad():
        for name, head in model.DetectionHead_0.named_children():
            key = "logits" if name.startswith("cls_") else "regressands"
            spread = 1.0 if key == "logits" else 0.3
            conv = head.final.Conv_0
            conv.weight.mul_(spread / first["head"][1][0][key].float().std().item())
            conv.bias.zero_()
            if key == "regressands":
                conv.bias[3:6] = math.log(3.0)
    return predictor


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
    for tag, kernel, n in (("K1", "meta_kernel_fused_wgmma", 2),
                           ("K4", "meta_kernel_fused_i8_wgmma", 2),
                           ("K3", "conv3x3_i8_wgmma", 6)):
        spills = ptxas_spills(lib.ptxas_log, kernel)
        check(len(spills) == n, f"{tag} instances in the ptxas log: {spills}")
        check(not any(spills.values()), f"{tag} spills: {spills}")
        say(f"{tag} ({kernel}): {len(spills)} instances, 0 bytes spilled")

    # 3. K1 against its plain twin: the flagship shape, a small odd one, a
    # single row with a ragged last tile, exact tiles; the Waymo stem
    # (C = 128, 64x2656 with Waymo's padding), the synthetic configs'
    # C = 32, and widths that the kernel pads (96 and 160).
    B, H, W, C = 2, 64, 1808, 256
    k1_in = stem_inputs(B, H, W, C, gen, device)
    waymo = (2, 64, 2656, 128)
    k1_waymo = stem_inputs(*waymo, gen, device)
    k1_err = 0.0
    made = {(B, H, W, C): k1_in, waymo: k1_waymo}
    for shape in ((B, H, W, C), (1, 3, 37, C), (1, 1, 70, C), (2, 2, 64, C), waymo,
                  (2, 32, 256, 32), (1, 3, 37, 96), (1, 3, 37, 160)):
        x = made[shape] if shape in made else stem_inputs(*shape, gen, device)
        got = meta_kernel_fused(**x)
        want = meta_kernel_fused_plain(**x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        check(bool(torch.isfinite(got).all()), f"K1 non-finite at {shape}")
        check(err <= 2e-2 * ref, f"K1 {shape}: max|diff| {err} > 2e-2 * {ref}")
        say(f"K1 {shape}: max|diff| {err:.4g} (max|ref| {ref:.4g}) ok")
        k1_err = max(k1_err, err)
    for bad in (48, 288):
        try:
            meta_kernel_fused(**stem_inputs(1, 1, 64, bad, gen, device))
        except RuntimeError as e:
            say(f"K1 C={bad}: refused ({e})")
        else:
            check(False, f"K1 C={bad}: the kernel accepted it")

    # 4. K2 against its plain twin: the timed case (B=2, cap=1024, drawn
    # from the main generator as before), every B and cap it takes, and the
    # edge cases, these from a generator of their own so the main path's
    # weights stay as they were.
    cap = 1024
    k2_in = nms_case(2, cap, gen, device)
    k2_err = check_k2(f"B 2 cap {cap}", k2_in)
    gen_k2 = torch.Generator().manual_seed(SEED + 2)
    for b_k2 in (1, 2, 3):
        for cap_k2 in NMS_CAPS:
            k2_err = max(k2_err, check_k2(f"B {b_k2} cap {cap_k2}",
                                          nms_case(b_k2, cap_k2, gen_k2, device)))
    for case in NMS_EDGE_CASES:
        for cap_k2 in (37, 100, 1024):
            k2_err = max(k2_err, check_k2(f"{case} B 2 cap {cap_k2}",
                                          nms_edge_case(case, 2, cap_k2, gen_k2, device)))
    # IoU and scores 4 bytes past a 16-byte boundary: the scalar instances
    # at a cap whose rows the vector ones would otherwise take.
    for tag, case in (("B 2 cap 1024", nms_case(2, 1024, gen_k2, device)),
                      ("zero_diagonal B 2 cap 1024",
                       nms_edge_case("zero_diagonal", 2, 1024, gen_k2, device))):
        iou_k2, scores_k2, valid_k2, payload_k2 = case
        iou_k2, scores_k2 = misaligned(iou_k2), misaligned(scores_k2)
        check(iou_k2.data_ptr() % 16 != 0 and scores_k2.data_ptr() % 16 != 0,
              "K2: the misaligned views are 16-byte aligned")
        k2_err = max(k2_err, check_k2(f"{tag}, IoU and scores misaligned",
                                      (iou_k2, scores_k2, valid_k2, payload_k2)))
    small = nms_case(1, 100, gen_k2, device)
    for tag, args in (
        ("cap 4097", (torch.zeros(1, 4097, 4097, device=device),
                      torch.zeros(1, 4097, device=device),
                      torch.ones(1, 4097, dtype=torch.bool, device=device),
                      torch.zeros(1, 4097, 9, device=device))),
        ("P = 8", (*small[:3], small[3][..., :8])),
    ):
        try:
            nms_scan(*args, iou_threshold=0.3, merge_threshold=0.5)
        except ValueError as e:
            say(f"K2 {tag}: refused ({e})")
        else:
            check(False, f"K2 {tag}: the wrapper accepted it")

    # 5. Main path: the flagship Predictor answers requests; its BatchNorm
    # epilogue rests on addcmul being one fused multiply-add.
    check_addcmul_fma(device, torch.Generator().manual_seed(SEED + 3))
    cfg = serving._flagship_config()
    dec = DecoderConfig()
    requests = [serving._sample_inputs(2, 64, 1808, 5, seed=s) for s in range(4)]
    predictor = flagship_predictor(cfg, dec, device, gen, requests[0])
    model = predictor.model
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
    kept = check_results(results)
    nms_err = check_nms_against_plain(model, requests[0], cfg, dec, device)
    say(f"main path: kept {kept} per request, "
        f"NMS == plain scan (cuboids max|diff| {nms_err:.3g}), "
        f"{ms_per_request:.2f} ms/request, "
        f"{2 * 1e3 / ms_per_request:.2f} frames/s")
    bf16_results = results
    with torch.inference_mode():
        bf16_heads = model(*(torch.as_tensor(a, device=device) for a in requests[0]))
        bf16_heads = {k: v for k, v in bf16_heads["head"][1][0].items()}
    # Phase 20 serves this model from artifacts: write them before the int8
    # phases fold it, and keep the requests' results on the host.
    art_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-artifacts-"))
    export_phase5(model, cfg, dec, requests, art_dir)
    phase5_results = [host(r) for r in results]
    phase5_heads = {k: v.cpu() for k, v in bf16_heads.items()}

    # 6. Timings at the main path's shapes.
    k1_ms = cuda_ms(lambda: meta_kernel_fused(**k1_in), reps=10)
    k1_graph_ms = graph_ms(lambda: meta_kernel_fused(**k1_in))
    k1_plain_ms = cuda_ms(lambda: meta_kernel_fused_plain(**k1_in), reps=3, warmup=1)
    waymo_ms = cuda_ms(lambda: meta_kernel_fused(**k1_waymo), reps=10)
    waymo_graph_ms = graph_ms(lambda: meta_kernel_fused(**k1_waymo))
    waymo_flops, waymo_bytes = k1_cost(*waymo)
    waymo_bound, waymo_by = bound_ms(waymo_flops, H100_BF16_FLOPS, waymo_bytes)
    k1_flops, k1_bytes = k1_cost(B, H, W, C)
    k1_bound, k1_by = bound_ms(k1_flops, H100_BF16_FLOPS, k1_bytes)
    nms_kw = dict(iou_threshold=0.3, merge_threshold=0.5)
    k2_ms = cuda_ms(lambda: nms_scan(*k2_in, **nms_kw), reps=20)
    k2_graph_ms = graph_ms(lambda: nms_scan(*k2_in, **nms_kw))
    k2_plain_ms = cuda_ms(lambda: nms_scan_plain(*k2_in, **nms_kw), reps=3, warmup=1)
    live_per_image = nms_scan(*k2_in, **nms_kw)[0].sum(-1)
    live = int(live_per_image.sum())
    k2_flops = live * cap * 2 * (1 + 9) * 2  # weights + dot products, per image-live step
    k2_bytes = 2 * cap * cap * 4 + 2 * cap * (4 + 1 + 9 * 4) + 2 * cap * (1 + 9 * 4)
    k2_bound, k2_by = bound_ms(k2_flops, H100_FP32_FLOPS, k2_bytes)
    # The greedy keep's own floor: the images run side by side, each a chain
    # of one shared-memory round trip a live step.
    k2_chain_ms = int(live_per_image.max()) * SMEM_STEP_S * 1e3
    k2_phases = kernel_device_us(lambda: nms_scan(*k2_in, **nms_kw),
                                 ("nms_mask_kernel", "nms_keep_kernel", "nms_merge_kernel"))
    # Every 64-pixel tile streams W1 and the nine K_n through L2 once per
    # neighbour: 9 x 2 C x C bf16.
    k1_l2 = math.ceil(W / 64) * H * B * 9 * 2 * C * C * 2
    say(f"K1 flagship: kernel {k1_ms:.4f} ms eager ({100 * k1_bound / k1_ms:.1f}% of "
        f"bound), {k1_graph_ms:.4f} ms graph replay "
        f"({100 * k1_bound / k1_graph_ms:.1f}%), plain {k1_plain_ms:.3f} ms, "
        f"bound {k1_bound:.4f} ms ({k1_by}), L2 weight reads {k1_l2 / 1e9:.2f} GB a "
        f"call ({k1_l2 / k1_ms / 1e9:.2f} TB/s eager) on {smi}")
    say(f"K1 Waymo stem {waymo}: kernel {waymo_ms:.4f} ms eager "
        f"({100 * waymo_bound / waymo_ms:.1f}% of bound), {waymo_graph_ms:.4f} ms "
        f"graph replay, bound {waymo_bound:.4f} ms ({waymo_by}) on {smi}")
    say(f"K2 cap {cap} B 2: kernel {k2_ms:.4f} ms eager "
        f"({100 * k2_bound / k2_ms:.1f}% of bound), {k2_graph_ms:.4f} ms graph replay; "
        f"device us by phase: " + ", ".join(f"{k} {v:.2f}" for k, v in k2_phases.items())
        + f"; plain {k2_plain_ms:.3f} ms, bound {k2_bound * 1e3:.2f} us ({k2_by}), "
        f"chain floor (model) {k2_chain_ms * 1e3:.2f} us ({live} live steps, "
        f"{int(live_per_image.max())} in the longer image) on {smi}")
    kernels = [
        {
            "name": "meta_kernel_fused", "route": "cuda",
            "source": "range_view_3d_detection_torch/csrc/meta_kernel_fused.cu",
            "replaces": "range_view_3d_detection_tpu/kernels/stem_pallas.py:269",
            "launches": launches["K1"], "max_abs_err": k1_err,
            "ms": k1_ms, "graph_ms": k1_graph_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound,
            "bound_by": k1_by, "library_ms": None,
        },
        {
            "name": "nms_scan", "route": "cuda",
            "source": "range_view_3d_detection_torch/csrc/nms_scan.cu",
            "replaces": "range_view_3d_detection_tpu/kernels/nms_pallas.py:121",
            "launches": launches["K2"], "max_abs_err": k2_err,
            "ms": k2_ms, "graph_ms": k2_graph_ms, "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
        },
    ]
    # Where a request's time goes: the forward, then decode + NMS.
    tensors = [torch.as_tensor(a, device=device) for a in requests[0]]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(*tensors), reps=5)
        out = model(*tensors)
        dec_ms = cuda_ms(lambda: decode(out, dec, cfg.tasks_dict, use_nms=True), reps=5)
        decode_split(out, dec, cfg, smi)
    bn_epilogue_times(model, tensors, smi)
    with torch.inference_mode():
        profile_request(predictor, requests[1])
    say(f"main path: {ms_per_request:.3f} ms/request (B=2), "
        f"{2 * 1e3 / ms_per_request:.2f} frames/s; forward {fwd_ms:.3f} ms, "
        f"decode+NMS {dec_ms:.3f} ms (device) on {smi}; "
        f"total {time.perf_counter() - t_start:.0f} s")
    kernels += int8_phases(predictor, requests, bf16_results, bf16_heads, cfg, dec,
                           device, gen, smi)
    del predictor, model, results, bf16_results, bf16_heads, out, made, k1_in, k1_waymo, k2_in
    torch.cuda.empty_cache()
    step_ms = training_phases(device, smi)
    torch.cuda.empty_cache()
    remat_ms = remat_phase(device, smi)
    torch.cuda.empty_cache()
    trainer_launches, trainer_work = trainer_phase(device, smi)
    torch.cuda.empty_cache()
    distributed_launches = distributed_phase(device, smi, trainer_work)
    int8_launches, qat_launches, phase18 = overfit_phase(device, smi)
    torch.cuda.empty_cache()
    try:
        serving_launches = serving_phases(art_dir, requests, phase5_results, phase5_heads,
                                          cfg, dec, device, smi)
        torch.cuda.empty_cache()
        width_launches = width_phase(art_dir / "bf16", device, smi)
        chunk_launches = chunk_phase(art_dir / "bf16", requests, device, smi)
        aot_launches = aot_phase(art_dir, requests, device, smi)
    finally:
        shutil.rmtree(art_dir, ignore_errors=True)
    range_partition_phase(device, smi)
    torch.cuda.empty_cache()
    converted_launches = converted_phase(device, smi)
    torch.cuda.empty_cache()
    bench_launches = bench_phase(device, kind, smi)
    torch.cuda.empty_cache()
    tool_launches = tools_phases(device, kind, smi, fwd_ms=fwd_ms, dec_ms=dec_ms,
                                 step_ms=step_ms, remat_ms=remat_ms["B=2 remat"],
                                 phase18=phase18)
    # The training paths (phases 17-18 and, since the remat and
    # distributed slice, 23-24), their launches beside the served path's:
    # the B=4 remat Trainer, the distributed Trainer's rank 0, and the int8
    # scoring of the PTQ (18) and QAT-fine-tuned (24) overfit models.
    trainer_path = {
        "meta_kernel_fused": sum(v["K1"] for v in trainer_launches.values()),
        "nms_scan": sum(v["K2"] for v in trainer_launches.values()),
        "conv3x3_i8_fused": int8_launches["K3"],
        "meta_kernel_fused_i8": 0,
    }
    for k in kernels:
        k["trainer_launches"] = trainer_path[k["name"]]
        k["distributed_launches"] = distributed_launches.get(k["name"], 0)
        k["qat_launches"] = qat_launches.get(k["name"], 0)
        k["artifact_launches"] = serving_launches[k["name"]]["artifact"]
        k["points_launches"] = serving_launches[k["name"]]["points"]
        k["width_launches"] = width_launches[k["name"]]
        k["chunk_launches"] = chunk_launches[k["name"]]
        k["aot_launches"] = aot_launches[k["name"]]
        k["converted_launches"] = converted_launches[k["name"]]
        for tag, counts in bench_launches.items():
            k[f"bench_{tag.replace(' ', '_')}_launches"] = counts[k["name"]]
        k["tools_launches"] = tool_launches["tools"][k["name"]]
        k["compile_launches"] = tool_launches["compile"][k["name"]]
    say(f"chip_smoke: total {time.perf_counter() - t_start:.0f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def phase18_light(device, smi) -> dict:
    """Phase 18's run without phase 24 (for ``chip_smoke.py tools``)."""
    from range_view_3d_detection_torch import overfit

    work = Path(tempfile.mkdtemp(prefix="chip-smoke-overfit-"))
    out = overfit.run("av2", OVERFIT_EPOCHS, work)
    trainer = out["trainer"]
    predictor = overfit.int8_predictor(trainer)
    int8 = overfit.score(trainer, overfit.write_predictor_shards(
        trainer, predictor, work / "int8_predictions"))
    say(f"overfit (phase 18, for the tools): bf16 mAP {out['mAP']:.4f}, int8 mAP "
        f"{int8['mAP']:.4f} on {smi}")
    return {"trainer": trainer, "work": work, "fp_map": out["mAP"], "ptq_map": int8["mAP"],
            "pred_dir": trainer.run_dir / "predictions"}


def tools_main() -> int:
    """``chip_smoke.py tools``: the build, then phases 30-38 alone (phase 18's
    run and phase 6's forward and decode times made here; phases 16's and
    22's step times not measured)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.kernels import _build
    from range_view_3d_detection_torch.models.decoder import DecoderConfig, decode

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    lib = _build.library()
    say(f"build: {lib.path} in {lib.build_seconds:.1f} s")
    cfg, dec = serving._flagship_config(), DecoderConfig()
    request = serving._sample_inputs(2, 64, 1808, 5)
    predictor = flagship_predictor(cfg, dec, device, torch.Generator().manual_seed(SEED),
                                   request)
    tensors = [torch.as_tensor(a, device=device) for a in request]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: predictor.model(*tensors), reps=5)
        out = predictor.model(*tensors)
        dec_ms = cuda_ms(lambda: decode(out, dec, cfg.tasks_dict, use_nms=True), reps=5)
    del predictor, out
    torch.cuda.empty_cache()
    phase18 = phase18_light(device, smi)
    bench_launches = bench_phase(device, kind, smi)
    torch.cuda.empty_cache()
    tool_launches = tools_phases(device, kind, smi, fwd_ms=fwd_ms, dec_ms=dec_ms,
                                 step_ms=math.nan, remat_ms=math.nan, phase18=phase18)
    say(json.dumps({"bench": bench_launches, **tool_launches}))
    say(f"chip_smoke tools: total {time.perf_counter() - t_start:.0f} s")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["tools"]:
        sys.exit(tools_main())
    if sys.argv[1:2] == ["train-rank"]:
        sys.exit(train_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["width-rank"]:
        sys.exit(width_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["convert"]:
        sys.exit(convert_rank(sys.argv[2:]))
    sys.exit(main())
