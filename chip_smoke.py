#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA GPU and
check its kernels.

    python3 chip_smoke.py

(``python -m torch.distributed.run ... chip_smoke.py train-rank ARGS`` is
phase 23's rank process, ``... chip_smoke.py width-rank ARGS`` the
width-sharded serving rank of phase 25 and ``chip_scaling.py width``, and
``chip_smoke.py convert WORK`` phase 29's conversion process; the script
starts them itself. ``chip_smoke.py tools`` runs phases 30-42 alone,
``chip_smoke.py kernel-shapes`` the kernels' checks past the configs'
shapes and phase 44, ``chip_smoke.py waymo`` phases 1-2 and 45,
``chip_smoke.py configs [PHASE]`` phases 1-2 and 46 (or 45 or 47),
``chip_smoke.py waymo-user`` phases 1-2 and 48,
``chip_smoke.py users`` phases 1-2 and 49,
``chip_smoke.py shipped-times PARENT`` the shipped
shapes' kernel times beside those of another checkout, each round a
``chip_smoke.py shipped-round TREE`` process.)

Phases, each of which raises (non-zero exit) on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into ``build/``;
   ptxas's registers and spills for every function (kept beside the
   library, so a reused build is checked too), and zero spills in both
   wgmma instances of K1 and of K4, in the four of K1's register-A kernel
   (fp32 as 3xTF32 64-, 128- and 256-wide, bf16 output-tiled), in the four
   of K4's output-tiled kernel (fp32 128- and 256-wide, and the 256-wide
   tiles past C = 256 in bf16 and fp32), in the six of K3, and in K2's
   keep past cap 4096, its ``killed_at`` pass and its eight merge
   instances;
3. K1 (fused MetaKernel stem) against its plain twin at the flagship
   shape, at a small odd shape (edges, ragged tiles), at a single row
   with a ragged last 64-pixel tile (1, 1, 70) and at exact tiles (2, 2,
   64), all at C = 256; at the Waymo and nuScenes stem width C = 128
   (Waymo's padded 64x2656 image) and the synthetic configs' C = 32; and
   at C = 96 and 160, which the kernel pads to its 128- and 256-wide
   instances: max|diff| <= 2e-2 * max|ref| (fp32 accumulation order,
   one-ulp bf16 flips of the intermediate ``p``); then in bf16 and fp32 at
   every C of ``ANY_C`` (8, 36, 48, 100, 200, 208, 288, 512: in bf16 both
   wgmma instances, C padded by the wrapper off their multiple, and the
   register-A kernel's output tiles past 256; in fp32 the register-A
   kernel as 3xTF32, C padded to 16), at (1, 3, 37) and (2, 4, 70),
   bf16 within the same bound, fp32 within ``K1_FP32_TOL`` (1e-4) *
   max|ref| (the same products summed in another order, TF32 off);
4. K2 (NMS scan) against its plain twin on the same IoU tensors, WEIGHTED
   and HARD, at B in {1, 2, 3} x cap in ``NMS_CAPS`` (1, 37 and 1023
   among them, which take the scalar instances) and on edge-case
   matrices (zeros on the diagonal, asymmetric, invalid boxes in the
   middle, every box suppressed, duplicated boxes, infinite and NaN
   payload values) at cap 37, 100 and 1024, and with the IoU and scores 4
   bytes off a 16-byte boundary at cap 1024: ``keep`` identical,
   ``merged`` within 1e-4 where finite and equal where not (the same
   infinity, or NaN in both: the twin's dense sum); and at payload
   widths P = 5 and 12 (the any-P merge) at caps 37 and 1024 (caps past
   4096: phase 39);
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
   beyond the clamp): ``torch.equal`` (integer work is exact), also at the
   channel counts of ``K3_TAIL_SHAPES`` (Cin 3, 8, 24, 40, 48, 100, padded
   to 32 by the wrapper; Cout 5, 8, 24, 37, 40, 136 stored under a mask);
   and the
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
   max|ref|, and no element differing (the kernel's arithmetic is its
   twin's; the count is printed); then with bf16 and fp32 ``g`` at every C
   of ``ANY_C``, at ``K4_WIDE_C`` (hq in one buffer, and in slabs of k)
   and on the edge case at C = 40, 288 and 2320 (fp32 to 256 and every C
   past it on the output-tiled kernel), within the same bound and with no
   element differing; K4's time (eager and graph replay), bound and twin's
   time,
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
    on points in bf16; projection's share of a points request; and
    (beside phase 37) the export CLI as a user types it, in a subprocess
    (``--synthetic --out D``, then ``--load D --points --latency --iters
    50``), its JSON line parsed;
22. remat: the flagship train step (bf16, B=2 64x1808, 64 boxes an
    image) without remat and with every group of ``remat_scope``, from the
    same weights: the loss and the running statistics equal bit for bit,
    the gradients within ``train_card_vs_cpu``'s form of tolerance (the
    median leaf within 2e-3 of its max, the worst within 1e-3 plus twice
    the card's own run-to-run move); then each of B=2 without remat, B=2
    with it and B=4 with it: ms a step (CUDA events, 2 warm-up, median of
    3, a cut from 5) split into targets, forward, loss, backward and optimizer, and
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
    ``Predictor``. The nuScenes corpus converted above through the
    rv-nuscenes ``Trainer`` at its published widths (``nuscenes_trainer_
    run``: 32 x 1800 padded to 1808, circular in the train split, the val
    split pinned to train as the JAX package's smoke test pins it), one
    epoch of one step at B=2 on the card, ``validate`` to its two shards,
    ``evaluate_predictions`` under ``detection_cfg_factory("nuscenes")``
    (55 m, every instance), every average finite.
    K1 and K2 must launch in each (``converted_launches`` in the kernels
    line: both Trainers' and the served batch's). The converted AV2,
    nuScenes and Waymo corpora go on to phases 48 and 49.
30. the bench: ``python -m range_view_3d_detection_torch.bench`` in a
    subprocess as a user runs it, int8 (the default; the other three
    modes' subprocesses are a cut: their flags take the same entry point
    in this process below), at the flagship (B=2, 64x1808, ``nms_cap``
    1024), beside phase 37 (its frames/s are not clean): its JSON line
    has frames/s above 0, p50 <= p90, ``eager`` in
    its mode and the card's ``nvidia-smi`` line; the four modes, int8,
    ``--fp``, ``--points`` and with ``RV3D_STEM_INT8=1``, through
    ``bench.main`` in this process (each line gated alike), counts reset before
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
36. ``tools.quant_cert_scale --seeds 1 --epochs 1 --sweeps-per-log 8``
    (training and scoring in subprocesses; beside phase 37) and
    ``tools.scale_drill --sweeps 100 --logs 2 --dense``, each a cut in
    depth, printed as such; the launches of phases 31-36
    (``tools_launches``): all four kernels;
37. ``utils.compile_opts``: the pipeline of the tiny config (widths 8,
    fp32: K1's 3xTF32 kernel) and of the tiny config at 32 channels in bf16
    (K1's wgmma kernel), each with the K1 stem (B=1 16x256) under
    ``RV3D_COMPILER_OPTIONS=max_autotune=False`` (``torch.compile``, over
    the port's ``compile_opts.EAGER_NUMERICS``): the whole pipeline,
    decode and NMS included, ``keep`` equal to eager's and not empty,
    heads within 2e-2 x max|ref|, K1 and K2 launched by the compiled program (``compile_launches``); the
    bench's compiled pipeline on the bf16 config keep-equal to its eager
    one; an unknown option raises. The flagship is not compiled (a cut).
    Beside its compiles, in processes of their own and checked when they
    end (``BESIDE_COMPILE``): phases 21's and 30's CLI runs, phase 36's
    ``quant_cert_scale``, phase 38's ``dryrun_multichip`` and phase 42's
    two ``validate_nms`` runs, none of which times anything kept;
38. ``dryrun.entry()`` once (finite heads), then (beside phase 37)
    ``dryrun.dryrun_multichip(<cards>)``: its four phases as NCCL ranks in
    spawned processes, each reporting OK (none skipped for time);
39. K2 past cap 4096 (the chain warp ahead of TMA-fed updaters, then the
    ``killed_at`` pass and the merge on it): against its twin, WEIGHTED
    and HARD (``keep`` equal, ``merged`` within 1e-4), at B 1 and 2 x cap
    4097, 4160, 8192 and 9216 (B 1: the B 2 case's first image, held to the
    same twin run, which scans each image apart) and at B 1 x cap 16384
    (WEIGHTED: ``keep`` does not depend on the mode, and the twin takes
    seconds a call there), the IoU matrices built in row blocks; the
    non-finite payload case at B 2 x cap 4160 (WEIGHTED); at cap
    4160, B 2 the kernel's ``killed_at`` scratch
    (``nms_scan_with_scratch``) equal to the plain mirror's
    (``nms_scan_ahead_plain``); the JAX package's dense scene
    (``tests/test_nms_cap.py::_dense_scene``'s draws) through
    ``batched_multiclass_nms`` at cap 9216, its kept set equal to the plain
    scan on the same IoU matrix; K2's time at cap 9216, B=2 (eager and
    graph replay) beside its byte bound, chain floor (a model) and the
    twin's time (its WEIGHTED call in the B 2 check), and the device time
    of each of its four kernels, mask, keep, ``killed_at`` and merge
    (taken in phase 6: late in the process the profiler records no
    kernels; the keep's goes into the kernels line as
    ``keep_device_us_cap_9216``) (``anycap_launches`` in the kernels line
    counts the checks' launches);
40. phase 38's dry-run phase 3 trained on the JAX ``(data, model)``
    layout (``dryrun.mesh_layout``: (1, 1) on one card);
41. Feather with ZSTD bodies on a machine without pyarrow: the fixture
    that pyarrow wrote at levels 1 and 19 (``FEATHER_ZSTD``, base64) read by
    ``utils/feather.py``, every column equal to its digest taken here
    (nulls as NaN and None); every ZSTD frame of it decoded by the native
    library equal to the pure-Python twin; MB/s of both;
42. the hardware tools as subprocesses, each exiting 0:
    ``tools.validate_nms`` in WEIGHTED and HARD at caps 1024, 2048, 4096 and
    9216 (N = 9216 proposals; K2 against the plain scan; the two modes
    beside phase 37, so their times are not clean), ``tools.conv_ab --reps 2`` (K3
    against ``_int_mm``'s lowering, bit for bit, then per shape and per
    request) and ``tools.fold_bench --stage res3`` with and without
    ``--int8``, each alone (``hw_tools_launches``: their launches);
43. every conv shape the JAX blocks serve: the served int8 flagship
    request still makes 62 K3 launches and no general-route call; the
    flagship with (4, 4) head towers (``fpn_kernel_sizes ((1, (4, 4)),)``)
    served at B=2, 64x1808 in bf16 (the towers' asymmetric pad) and, after
    ``Predictor.quantize`` (full scope), in int8 (the 8 tower convs on the
    general int8 route, the other 54 convs on K3), each 4 requests by p50
    with the general route's ms a request (CUDA events) and its share;
    the general route on the card against its CPU twin (fp64 product), bit
    for bit: a (4, 4) head-tower conv, a biased 5x5, a height-stride-2
    3x3 (and a 2x4 image, M < 17), a (5, 8)/(1, 4)/(2, 2) transposed conv
    with bias; an int8 3x3 ``ConvNormAct`` and an aggregation transposed
    conv under a one-rank width context equal to their runs without it
    (``conv_shapes_launches``: the kernels' launches in its requests).

44. the kernels past the configs' shapes on the main paths: the tiny
    config (widths 8, B=2 16x256) served on the card in fp32 with the K1
    stem (K1's 3xTF32 kernel), in bf16 (K1's 128-wide instance) and in
    int8 quantized from fp32 with the K4 stem (K4's output-tiled kernel
    in fp32, K3 at Cin 8), each against the same weights served on the
    CPU (heads at the CPU tests' tolerances: ``gate_heads``) and timed (ms
    a request, host clock); one fp32 rv-av2 request
    with the K1 stem at B=2 64x1808 (3 requests timed, K1 and K2 launches:
    the K1 fp32 entry's ``launches``), the same model against its CPU run
    at B=1 8x256 (heads within 1e-3 * max|ref|); K1 fp32 at the flagship
    stem against its twin (``K1_FP32_TOL``), timed (eager, graph replay,
    twin, and the wrapper's gather and hi/lo split of the weights alone) beside its
    3xTF32 bound (three TF32 products per fp32 product at the dense TF32
    peak) and the earlier CUDA-core limit (the same work as FFMA): the
    kernels line's ``meta_kernel_fused_fp32`` entry; K1 bf16 at the
    flagship stem on the register-A kernel's entry, beside the shipped
    wgmma instance; K4 with fp32 ``g`` at the flagship stem (the
    output-tiled kernel's one-tile form; an int8 model quantized from
    fp32) against its twin, no element differing, timed (eager, graph
    replay) beside twin and int8 tensor-core bound: the kernels line's
    ``meta_kernel_fused_i8_fp32`` entry (its launches: the tiny int8
    request's); K1 and K4 at C = 36, 48, 288 and 512 in bf16 and fp32
    against their twins (K4 with no element differing), each timed beside
    its twin and bound (K1 fp32: also the earlier CUDA-core limit; K4 also
    by graph replay and, past 256, at its own count of operations, W1
    repeated per output tile), with the wrappers' pad copies at C = 36 in
    bf16 timed alone;
    K3 at a tail shape (2, 64, 1808, 48) -> 40 equal to its twin and
    timed, with the wrapper's Cin pad copy timed alone.
45. rv-waymo, the paper's second published configuration, at its
    published width (``config_phase``; ``experiment_configs``:
    ``conf/experiment/rv-waymo.yaml`` through ``compose`` and the port's
    builders; 128-channel stem and stages, FPN 256, 256-channel towers, 3
    classes, 6 channels, bf16, nms_cap 1024), seeded weights
    (``flagship_predictor``), requests of B=2 x 64 x 2650 padded by 3 a
    side with constant padding to 2656 (``padded_request``): 4 bf16
    requests launch K1 and K2 (once a request) and not K3 or K4, finite
    detections kept, the NMS equal to the plain scan; the same weights on
    the card against the CPU at B=1 8x256, full widths and depth, in fp32
    (heads within 1e-3 * max|ref|) and bf16 (``gate_heads``' bf16 form);
    forward and decode + NMS device ms, a request traced by
    ``tools.profile_trace`` (device time by kernel) beside its untraced
    wall; K1 and K2 on the request's own inputs against their twins, timed eager
    and by graph replay beside their bounds; raw points (B=2 x 131,072 a
    request, Waymo's channels, ``points_front_end``) served 4 times as
    above, equal to the predictor on the clouds rasterized by hand; int8
    (fold, calibrate on request 0, full scope): every K3 input unquantized
    and NHWC-contiguous, 4 requests launch K1, K2 and K3 and not K4, K3
    bit-equal to its twin on every shape a request launches, in both
    operand forms, each shape timed beside its bound
    (``k3_request_shapes``); the int8 stem: K4 and not K1, K4 on the
    request's own stem inputs with no element differing from its twin,
    timed eager and by graph replay beside its bound; then through
    ``bench.build`` (the config's own decoder) and ``bench.measure`` one
    mode at a time (bf16, int8, int8 K4 stem, int8 points; 12 requests for
    frames/s and 25 for the percentiles, half the bench's:
    ``CONFIG_BENCH_ITERS``): p50, p90 and frames/s, the bench's kernels
    launched; 5 bf16 train steps at B=2
    64x2656 (64 seeded boxes an image): ms a step split by part, every
    parameter leaf changed, peak memory. Its launches are printed in its
    own line.
46. the paper's baseline and the fast operating point, each as phase 45
    runs rv-waymo (``configs_phase``), from ``conf/experiment/``: base-av2
    (the BASIC stem, one projecting ``BasicBlock`` of 1x1 convs; stages
    (64, 64, 128, 128, 128), FPN 128, 128-channel towers, 26 classes,
    bf16, nms_cap 1024) at B=2 x 64 x 1800 padded by 4 a side to 1808,
    and rv-av2-fast (rv-av2 at ``x_stride`` 4) at 64 x 1800 padded by 28 a
    side to 1856 and every 4th column kept, 464 served; the card against
    the CPU at B=1 8x256 (250 columns padded to 256 for base-av2, 1000
    padded to 1024 and strided to 256 for rv-av2-fast). base-av2 launches
    no stem kernel: bf16 and its points K2 alone, int8 K2 and K3, and its
    three 1x1 stem convs calibrated on the int8 product (route
    "matmul"); no int8 stem mode. rv-av2-fast launches as rv-waymo. Train
    steps at each config's batch_size, 4. ``{name}_launches`` in the
    kernels line: each config's served launches.
47. the last two experiments of ``conf/``, each as phase 45 runs rv-waymo:
    rv-nuscenes (the META stem at 128, stages of 128, FPN 256,
    256-channel towers, nuScenes' 10 classes, AV2's five features, bf16,
    nms_cap 1024) at B=2 x 32 x 1800 padded by 4 a side to 1808, its
    points at nuScenes' raw 0-255 intensity on 32 lasers, its train steps
    on sweeps padded circularly as its train split pads them
    (``train_padding``; the val split pads with constants); and base-waymo
    (the BASIC stem on Waymo's six features, stages (64, 64, 128, 128,
    128), FPN 128, 128-channel towers, 3 classes) at B=2 x 64 x 2650
    padded by 3 a side to 2656. The card against the CPU at B=1 8x256 (248
    columns padded by 4, 250 by 3). rv-nuscenes launches as rv-waymo;
    base-waymo as base-av2 (no stem kernel, its three 1x1 stem convs on
    the int8 product). Train steps at each config's batch_size, 4.
48. Waymo as its users run it, on phase 29's converted Waymo corpus (one
    log of two frames at 64 x 2650; converted again when the phase runs
    alone): the rv-waymo ``Trainer`` from ``conf/`` at its published
    widths on the card by default, one epoch at B=2 with the val split
    pinned to train (``waymo_trainer_run``), ``validate`` to one shard a
    sweep, the shards scored by the WOD evaluator (``evaluate_waymo``,
    with the recall-gap penalty and without) under
    ``detection_cfg_factory("waymo")``, every average finite, K1 and K2
    launched; the fitted rv-waymo exported as bf16 and int8 artifacts
    (int8 calibrated on its train batches) and served
    (``waymo_deploy``, then ``deploy_artifacts``), each mode's requests
    equal bit for bit to their reference, NaNs included
    (``bit_equal``): the artifacts against the fitted model folded (and
    quantized) in memory on 4 B=2 requests of the corpus's padded sweeps,
    with K1 and K2 held against their twins on a request's own inputs and
    K3 on every shape of an int8 request (``k3_request_shapes``); the
    int8 stem (K4) once, no element differing from its twin; the corpus's
    own raw points through the bf16 artifact's points front end against
    the artifact on the clouds rasterized by hand; the 4 requests as one
    CUDA-graph replay against the eager calls; the AOT programs against
    ``load_artifact`` (``aot_phase``), the bf16 one also in a process
    that imports only the kernels package. Each mode prints its launches
    and ms a request (host clock, median). Last, the WOD overfit oracle
    (``overfit.run("waymo", E)`` on the card, ``waymo_oracle``): the loss
    by epoch, bf16 and int8 PTQ mAP and mAPH, gated on the last-10 loss
    and the mAP without the penalty. ``waymo_user_launches`` in the
    kernels line: the phase's launches. Its cuts are printed
    (``waymo_user_cuts``).
49. the four other published experiments as their users run them, each
    at its published widths and dtype (bf16) on one of phase 29's
    converted corpora (``PUBLISHED_USERS``; converted again when the phase
    runs alone, ``convert_user_corpora``): base-av2 and rv-av2-fast on the
    AV2 corpus (4 train and 2 val sweeps, B=4, the published batch_size;
    rv-av2-fast at x_stride 4), rv-nuscenes on the nuScenes corpus and
    base-waymo on the Waymo corpus (2 sweeps each, B=2, the val split
    pinned to train). For each: ``train.main(["experiment=NAME", ...])``
    in this process on the card by default, one epoch with checkpointing
    on (``user_train``: one step, every loss finite, a checkpoint, one
    shard a val sweep, every average of the dataset's protocol finite
    under ``evaluate_run``, and for base-waymo the WOD evaluator with the
    recall-gap penalty and without); ``predict.main --ckpt-dir RUN
    --out-dir OUT`` (``user_predict``: its shards equal byte for byte to
    the Trainer's validate shards); ``export.main --run-dir RUN --out
    ART`` bf16 and ``--quantize`` (``user_export``: ``meta.json``'s
    dataset facts, x_stride and padding mode the val split's, the
    published min_confidence); the artifacts through ``deploy_artifacts``
    against the run restored in memory (``_restore_from_run_dir``) folded,
    and quantized on the run's calibration batches, on 2 B=2 requests of
    the val sweeps (``corpus_requests``), each mode bit-equal to its
    reference: bf16, int8 (K3 on every shape of a request), the int8 stem
    once (META configs: K4 with no element differing), the corpus's own
    returns through the bf16 artifact's points front end (x_stride 4 for
    rv-av2-fast, raw 0-255 intensity on 32 lasers for rv-nuscenes), the
    chunk loop; K1 (META) and K2 against their twins on a request's own
    inputs; K2 again on a non-empty matrix, one request of the bf16
    artifact with only the decoder's ``min_confidence`` lowered to 0 in
    memory (``lowered_confidence_predictor``; ``meta.json`` keeps the
    published value). The AOT programs at B=2 of the configs of
    ``USER_AOT`` (base-av2 and rv-av2-fast) are exported by the export
    CLI (``--load ART --aot``, ``aot_export_job``) in processes beside the
    later configs' runs, and each is checked against ``load_artifact``
    (``aot_check``, ``published_user_aot``) once every export has ended,
    base-av2's bf16 program also in a process that imports only the
    kernels package (started beside the runs, serving once the program
    is written). Nothing is timed per request while a process of the
    phase runs beside it. Every mode prints its launches and ms a request
    (host clock, median); ``published_user_launches`` in the kernels
    line: the phase's launches. Its cuts are printed
    (``published_user_cuts``).

``python3 chip_smoke.py tools`` runs the build and phases 30-42 alone
(phase 18's run and phase 6's times made for them; phases 16's and 22's
step times not measured); ``python3 chip_smoke.py conv-shapes`` the build
and phase 43; ``python3 chip_smoke.py kernel-shapes`` the build, the
checks of phases 3, 4, 7 and 10 past the configs' shapes and phase 44;
``python3 chip_smoke.py waymo`` the build and its spill gate, and phase 45;
``python3 chip_smoke.py configs [PHASE]`` the build and its spill gate,
and phase 46 (or the phase named: ``configs 47`` runs phase 47);
``python3 chip_smoke.py waymo-user`` the build and its spill gate, and
phase 48 on a corpus it converts; ``python3 chip_smoke.py users`` the
build and its spill gate, and phase 49 on corpora it converts;
``python3 chip_smoke.py compile-decode`` the build and the decode's
stages compiled one at a time against eager (``compile_decode_phase``).

Prints the card's name and power limit and a ``{"kernels": [...]}`` line
before the last line, which is ``{"ok": true, "device": {...}}``. There is
no CPU path: without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak
H100_BYTES_PER_S = 3.35e12
# A model, not a measurement: one dependent shared-memory round trip
# (about 30 cycles) at the H100 SXM's 1.98 GHz boost clock. K2's greedy
# keep needs one a live step; the chain floor it gives is printed with
# K2's times and kept out of the kernels line.
SMEM_STEP_S = 30 / 1.98e9
SEED = 0
NMS_EDGE_CASES = ("zero_diagonal", "asymmetric", "invalid_middle", "all_suppressed",
                  "duplicated", "nonfinite_payload")
# Caps K2 is held at: those not a multiple of 4 (1, 37, 1023) take the
# kernels' scalar instances, the others their 16-byte loads.
NMS_CAPS = (1, 37, 100, 512, 1023, 1024, 2048, 4096)
# Channel counts at which K1 and K4 are held against their twins past the
# configs' widths (phases 3 and 10), in bf16 and fp32: in bf16 the wgmma
# kernels' 128-wide instance (8, 36 and 100 padded by the wrapper where
# they are off its multiple, 48) and their 256-wide one (200, 208), past
# 256 (288, 512) K1's register-A kernel and K4's output-tiled one; in fp32
# K1's 3xTF32 kernel (its 64- and 128-wide instances to 64 and 128, then
# 256-wide tiles) and K4's output-tiled kernel (its one-tile 128- and
# 256-wide form to 256, then 256-wide tiles).
ANY_C = (8, 36, 48, 100, 200, 208, 288, 512)
# K4 past the hq tile's shared-memory room (phase 10): one hq buffer (1168)
# and hq built in slabs of k, once a chunk (2320).
K4_WIDE_C = (1168, 2320)
# K1 in fp32 against its fp32 twin (TF32 off): the same products summed in
# another order.
K1_FP32_TOL = 1e-4
# K3 at channel counts off the kernel's multiples (phase 7): (x shape,
# Cout, stride); Cin padded to 32 by the wrapper, odd Cout and Cout past
# one 128-channel tile stored under a mask.
K3_TAIL_SHAPES = (((1, 5, 33, 8), 8, 1), ((1, 6, 18, 8), 8, 2), ((2, 3, 37, 24), 40, 1),
                  ((1, 6, 18, 24), 40, 2), ((1, 5, 70, 48), 24, 1), ((2, 3, 37, 48), 24, 2),
                  ((1, 3, 37, 100), 37, 2), ((1, 4, 20, 3), 5, 1), ((1, 3, 70, 40), 136, 1))
# K2's payload widths besides the box's 9 (phase 4).
NMS_PAYLOADS = (5, 12)


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


class Laps:
    """Seconds between marks: ``laps("part")`` closes the part that began at
    the last mark; ``str(laps)`` lists them."""

    def __init__(self):
        self.t, self.s = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = round(now - self.t, 1)
        self.t = now

    def __str__(self) -> str:
        return ", ".join(f"{k} {v} s" for k, v in self.s.items())


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


# The kernels' template instances that phase 2 reads in ptxas's report:
# (tag, name in the mangled symbol, instances, held to zero spills).
SPILL_CHECKED = (("K1", "meta_kernel_fused_wgmma", 2, True),
                 ("K1 register-A", "meta_kernel_fused_rs", 4, True),
                 ("K4", "meta_kernel_fused_i8_wgmma", 2, True),
                 ("K4 output-tiled", "meta_kernel_fused_i8_tiles", 4, True),
                 ("K3", "conv3x3_i8_wgmma", 6, True),
                 ("K2 keep past cap 4096", "nms_keep_ahead_kernel", 1, True),
                 ("K2 killed_at", "nms_killed_at_kernel", 1, True),
                 ("K2 merge", "nms_merge_kernel", 8, True))


def check_spills(lib) -> None:
    """Phase 2: ptxas's registers and spills for every function of the
    build, and no spills in the instances of ``SPILL_CHECKED`` held to
    none."""
    lines = lib.ptxas_log.splitlines()
    for i, line in enumerate(lines):
        if "error" in line:
            say(f"  ptxas: {line.strip()}")
        if "Function properties for" in line and i + 2 < len(lines):
            used = re.search(r"Used (\d+) registers", lines[i + 2])
            say(f"  ptxas: {line.split()[-1]}: {lines[i + 1].strip()}"
                + (f", {used[1]} registers" if used else ""))
    for tag, kernel, n, gated in SPILL_CHECKED:
        spills = ptxas_spills(lib.ptxas_log, kernel)
        check(len(spills) == n, f"{tag} instances in the ptxas log: {spills}")
        if gated:
            check(not any(spills.values()), f"{tag} spills: {spills}")
        say(f"{tag} ({kernel}): {len(spills)} instances, "
            f"{sum(spills.values())} bytes spilled")


def bound_ms(flops: float, flop_rate: float, nbytes: float):
    t_ops = flops / flop_rate * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def stem_inputs(B, H, W, C, gen, device, dtype=None):
    """Random K1 operands, ``g``, ``feats`` and the weights in ``dtype``
    (bf16 by default)."""
    import torch

    def rn(*shape, std=1.0):
        return torch.randn(shape, generator=gen) * std

    dt = dtype or torch.bfloat16
    return dict(
        g=rn(B, H, W, C).to(device, dt),
        feats=rn(B, H, W, C).to(device, dt),
        w1=rn(C, C, std=C**-0.5).to(device, dt),
        k=rn(9, C, C, std=C**-0.5).to(device, dt),
        a0=(torch.rand(C, generator=gen) + 0.5).to(device),
        b0=rn(C, std=0.5).to(device),
        a1=(torch.rand(C, generator=gen) + 0.5).to(device),
        b1=rn(C, std=0.5).to(device),
    )


def k4_inputs(B, H, W, C, gen, device, dtype=None):
    """Random K4 operands at the scales the calibrated stem gives them:
    ``hq`` spans 0-127 and ``p * feats`` about +-50 before the clamp;
    ``g`` and ``feats`` in ``dtype`` (bf16 by default)."""
    import torch

    def rn(*shape):
        return torch.randn(shape, generator=gen)

    def u(lo, hi, *shape):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)

    dt = dtype or torch.bfloat16
    return dict(
        g=rn(B, H, W, C).to(device, dt), feats=rn(B, H, W, C).to(device, dt),
        w1_i8=i8(C, C).to(device), k_i8=i8(9, C, C).to(device),
        a0=u(15, 45, C).to(device), b0=(rn(C) * 30).to(device),
        a1=u(5e-4, 1.5e-3, C).to(device), b1=rn(C).to(device),
        kdq=u(5e-4, 1.5e-3, 9, C).to(device),
    )


def k4_edge_case(B, H, W, C, gen, device, dtype=None):
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
    dt = dtype or torch.bfloat16
    return dict(
        g=g.to(device, dt), feats=feats.to(device, dt), w1_i8=w1.to(device),
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


def k1_cost(B, H, W, C, elem=2):
    """(flop, bytes) of one K1 call: two C x C GEMMs per neighbour and
    pixel; g and feats (``elem`` bytes an element: 2 in bf16, 4 in fp32)
    read once, the weights in their dtype and the affines, fp32 out."""
    flops = 2 * B * H * W * 9 * 2 * C * C
    nbytes = elem * (2 * B * H * W * C) + elem * 10 * C * C + 16 * C + 4 * B * H * W * C
    return flops, nbytes


def k1_fp32_bound(flops, nbytes):
    """K1 fp32's bound as the kernel computes it, 3xTF32: three TF32
    products (hi hi, hi lo, lo hi) per fp32 product at the dense TF32 peak,
    or the bytes; (ms, "operations" or "bytes")."""
    return bound_ms(3 * flops, H100_TF32_FLOPS, nbytes)


def k4_cost(B, H, W, C, elem=2):
    """(operations, rate, bytes) of one K4 call: two C x C int8 GEMMs per
    neighbour and pixel at the int8 peak; g and feats (``elem`` bytes an
    element) read once, the int8 weights, the affines and kdq, fp32 out."""
    ops = 2 * B * H * W * 9 * 2 * C * C
    nbytes = elem * (2 * B * H * W * C) + 10 * C * C + 4 * 13 * C + 4 * B * H * W * C
    return ops, H100_INT8_OPS, nbytes


def k2_cost(B, cap, live, P=9):
    """(flop, bytes) of one K2 call at ``cap`` slots: the merge's weights
    and dot products over the payload's ``P`` columns for each of ``live``
    kept rows (summed over the images); the IoU matrix, scores, valid and
    payload read once, keep and merged written once."""
    flops = live * cap * 2 * (1 + P) * 2
    nbytes = B * cap * cap * 4 + B * cap * (4 + 1 + P * 4) + B * cap * (1 + P * 4)
    return flops, nbytes


def nms_case(B, cap, gen, device, duplicated=False):
    """Sorted, overlapping boxes (one category) and their IoU matrix, one
    image at a time; ``duplicated``: each box twice with the same score."""
    import torch

    from range_view_3d_detection_torch.ops.nms import iou_matrix

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
    # One image at a time; past cap 4096 in row blocks (equal bit for bit).
    iou = torch.cat([iou_matrix(bev[b : b + 1]) for b in range(B)])
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
    elif case == "nonfinite_payload":
        # Infinite and NaN values, as a model a step from random weights
        # decodes box sizes: column 3 infinite at the first box alone (kept:
        # its row sums the infinity, every other row meets 0 x inf), column 4
        # at a quarter of the boxes, column 0 -inf at box 1 and +inf at box
        # 2, column 6 NaN at one box.
        payload = payload.clone()
        payload[:, 0, 3] = math.inf
        quarter = torch.randperm(cap, generator=gen)[: max(cap // 4, 1)].to(device)
        payload[:, quarter, 4] = math.inf
        payload[:, min(1, cap - 1), 0] = -math.inf
        payload[:, min(2, cap - 1), 0] = math.inf
        payload[:, int(torch.randint(cap, (1,), generator=gen)), 6] = math.nan
    return iou, scores, valid, payload


def misaligned(t):
    """A contiguous copy of ``t`` that starts one element past the start of
    its allocation (4 bytes past a 16-byte boundary for fp32)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


K2_MODES = (("WEIGHTED", 0.5), ("HARD", 1.01))


def check_k2(tag, inputs, modes=K2_MODES) -> float:
    """K2 against its plain twin in ``modes`` (WEIGHTED and HARD):
    ``keep`` identical, ``merged`` within 1e-4 where the twin's is finite
    and equal where it is not (the same infinity, or NaN in both: a model
    fitted one step from random weights decodes infinite box sizes).
    Returns max|merged diff| over the finite values."""
    import torch

    from range_view_3d_detection_torch.kernels.nms import nms_scan, nms_scan_plain

    worst, kept, odd = 0.0, [], 0
    for mode, merge in modes:
        kw = dict(iou_threshold=0.3, merge_threshold=merge)
        keep, merged = nms_scan(*inputs, **kw)
        keep_p, merged_p = nms_scan_plain(*inputs, **kw)
        torch.cuda.synchronize()
        check(torch.equal(keep, keep_p), f"K2 {tag} {mode}: keep differs from the "
              f"twin in {int((keep != keep_p).sum())} slots")
        finite = torch.isfinite(merged_p)
        same = (merged == merged_p) | (merged.isnan() & merged_p.isnan())
        check(bool(same[~finite].all()), f"K2 {tag} {mode}: "
              f"{int((~same[~finite]).sum())} non-finite merged values differ from the twin's")
        odd = max(odd, int((~finite).sum()))
        err = (merged - merged_p)[finite].abs().max().item() if finite.any() else 0.0
        check(err <= 1e-4, f"K2 {tag} {mode}: merged max|diff| {err} > 1e-4")
        worst = max(worst, err)
        kept.append(int(keep.sum()))
    say(f"K2 {tag}: keep identical (kept "
        + ", ".join(f"{n} {mode}" for n, (mode, _) in zip(kept, modes))
        + f" of {int(inputs[2].sum())} valid), merged max|diff| {worst:.3g}"
        + (f" ({odd} non-finite merged values equal to the twin's)" if odd else "") + " ok")
    return worst


def kernel_device_us(fn, names, calls: int = 5) -> dict:
    """Device microseconds a call of ``fn`` spends in each kernel whose
    name contains one of ``names`` (torch.profiler, ``calls`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A first, untraced step warms the profiler: in a process that has
    # profiled before, a session's first kernels can go unrecorded.
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
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


def k3_equal(x, w, dq, stride, tag, in_scale=None) -> float:
    """K3 == its twin (torch.equal) in bf16 and fp32 output."""
    import torch

    from range_view_3d_detection_torch.kernels.conv import (
        conv3x3_i8_fused,
        conv3x3_i8_fused_plain,
    )

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


def k3_odd_shapes(cases, gen, device) -> float:
    """Phase 7: K3 against its twin on ``cases`` of (x shape, Cout,
    stride), int8 input and the bf16/fp32 activation with ``in_scale``:
    activations on the .5 rounding boundaries (scale 2^-6) and beyond
    +-127.5 scales (the clamp), and random ones. Returns max|diff| (0)."""
    import torch

    from range_view_3d_detection_torch.kernels.conv import k3_plan

    def rand_i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(device)

    err = 0.0
    for shape, cout, stride in cases:
        dq = torch.rand(cout, generator=gen).to(device) * 1e-3 + 1e-4
        w = rand_i8(9, shape[-1], cout)
        pad = k3_plan(shape[-1], cout, stride, torch.int8, False).cin_pad
        tag = f"{shape}->{cout} stride {stride}" + (f" (Cin padded by {pad})" if pad else "")
        err = max(err, k3_equal(rand_i8(*shape), w, dq, stride, tag))
        ties = torch.randint(-300, 301, shape, generator=gen).float() / 2 / 64
        for dt in (torch.bfloat16, torch.float32):
            err = max(err, k3_equal(ties.to(device, dt), w, dq, stride, tag + " ties/clamp",
                                    in_scale=torch.tensor(2.0**-6, device=device)))
            xr = torch.randn(shape, generator=gen) * 0.9
            err = max(err, k3_equal(xr.to(device, dt), w, dq, stride, tag + " randn",
                                    in_scale=torch.tensor(0.0173, device=device)))
    return err


def check_k1_any_c(gen, device) -> dict:
    """Phase 3's K1 past the configs' widths: bf16 and fp32 ``g`` at every
    C of ``ANY_C`` (the wgmma instances or the register-A kernel, as ``k1_plan``
    says), at (1, 3, 37) and (2, 4, 70) (image edges, ragged pixel tiles),
    against the twin: bf16 within 2e-2 x max|ref|, fp32 within
    ``K1_FP32_TOL`` x max|ref| (fp32 sums in another order; TF32 off).
    Returns max|diff| by dtype name."""
    import torch

    from range_view_3d_detection_torch.kernels.stem import (
        k1_plan,
        meta_kernel_fused,
        meta_kernel_fused_plain,
    )

    errs = {}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, K1_FP32_TOL)):
        for C in ANY_C:
            plan = k1_plan(C, dt)
            for shape in ((1, 3, 37), (2, 4, 70)):
                x = stem_inputs(*shape, C, gen, device, dtype=dt)
                got = meta_kernel_fused(**x)
                want = meta_kernel_fused_plain(**x)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                ref = want.abs().max().item()
                check(bool(torch.isfinite(got).all()), f"K1 {dt} C={C} non-finite")
                check(err <= tol * ref, f"K1 {dt} {shape} C={C}: max|diff| {err} > "
                      f"{tol} * {ref}")
                say(f"K1 {dt} {shape + (C,)} ({plan.kernel}, {plan.pad} channels padded): "
                    f"max|diff| {err:.4g} (max|ref| {ref:.4g}) ok")
                errs[str(dt)] = max(errs.get(str(dt), 0.0), err)
    return errs


def check_k4_any_c(gen, device) -> float:
    """Phase 10's K4 past the configs' widths: bf16 and fp32 ``g`` at every
    C of ``ANY_C`` (``k4_plan``), at (1, 3, 37) and (2, 4, 70), at
    ``K4_WIDE_C`` on (1, 3, 37), and the edge case that binds every clamp
    and rounding tie at C = 40, 288 and 2320, against the twin: within 1e-4
    x max|ref|, and no element differing (the kernels' arithmetic is the
    twin's). Returns max|diff|."""
    import torch

    from range_view_3d_detection_torch.kernels.stem import (
        k4_plan,
        meta_kernel_fused_i8,
        meta_kernel_fused_i8_plain,
    )

    worst = 0.0
    laps = Laps()
    for dt in (torch.bfloat16, torch.float32):
        # (tag, shape, maker), made in this order from ``gen`` as they run.
        cases = [(f"{shape + (C,)}", shape + (C,), k4_inputs)
                 for C in ANY_C for shape in ((1, 3, 37), (2, 4, 70))]
        cases += [(f"{(1, 3, 37, C)}", (1, 3, 37, C), k4_inputs) for C in K4_WIDE_C]
        cases += [(f"edge case {shape}", shape, k4_edge_case)
                  for shape in ((1, 3, 37, 40), (1, 2, 70, 288), (1, 2, 37, 2320))]
        for i, (tag, shape, make) in enumerate(cases):
            if i == len(ANY_C) * 2:
                laps(f"{dt} to C = {ANY_C[-1]}")
            args = make(*shape, gen, device, dtype=dt)
            plan = k4_plan(args["g"].shape[-1], dt)
            got = meta_kernel_fused_i8(**args)
            want = meta_kernel_fused_i8_plain(**args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ref = want.abs().max().item()
            n_diff = int((got != want).sum())
            check(bool(torch.isfinite(got).all()), f"K4 {dt} {tag} non-finite")
            check(err <= 1e-4 * ref, f"K4 {dt} {tag}: max|diff| {err} > 1e-4 * {ref}")
            check(n_diff == 0, f"K4 {dt} {tag}: {n_diff} elements differ from the twin")
            say(f"K4 {dt} {tag} ({plan.kernel}, {plan.pad} channels padded): max|diff| "
                f"{err:.4g} (max|ref| {ref:.4g}), {n_diff} of {got.numel()} elements "
                f"differ; ok")
            worst = max(worst, err)
        laps(f"{dt} at C = {', '.join(map(str, K4_WIDE_C))} and the edge cases")
    say(f"K4 any C (phase 10): {laps}")
    return worst


def check_k2_any_p(gen, device) -> float:
    """Phase 4's K2 at payload widths other than the box's 9
    (``NMS_PAYLOADS``), on the scalar (cap 37) and vector (cap 1024)
    instances, WEIGHTED and HARD (``check_k2``). Returns max|diff|."""
    import torch

    worst = 0.0
    for P in NMS_PAYLOADS:
        for cap in (37, 1024):
            iou, scores, valid, _ = nms_case(2, cap, gen, device)
            payload = (torch.rand((2, cap, P), generator=gen) * 80 - 40).to(device)
            worst = max(worst, check_k2(f"B 2 cap {cap} P {P}", (iou, scores, valid, payload)))
    return worst


def k3_request_shapes(captured, B, H, smi, config="") -> tuple:
    """K3 against its twin on every distinct shape of one int8 request
    (``capture_k3``'s record), in both operand forms (``k3_equal``); each
    shape's time (CUDA events around eager launches, as for the other
    kernels, and CUDA-graph replay beside them), bound and share of bound,
    the int8 form's time and the twin's, and their sums over a request.
    ``config`` names the config in the lines printed. Returns ``(sums,
    max|diff|, bound_by)``."""
    import torch

    from range_view_3d_detection_torch.kernels.conv import (
        conv3x3_i8_fused,
        conv3x3_i8_fused_plain,
        quantize_to_int8,
    )

    label = f"{config} K3" if config else "K3"
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
        say(f"{label} {tag}: {n} launches/request; {x.dtype} + in_scale: kernel "
            f"{eager:.4f} ms eager ({100 * bound / eager:.1f}% of bound), "
            f"{graph:.4f} ms graph replay ({100 * bound / graph:.1f}%, "
            f"{ops / graph / 1e9:.1f} TOP/s), bound {bound:.4f} ms ({by}); int8 form "
            f"{i8_ms:.4f} ms graph replay ({100 * i8_bound / i8_ms:.1f}% of its "
            f"bound); plain {plain:.3f} ms on {smi}")
    k3_by = "operations" if sums["ops_ms"] >= sums["bytes_ms"] else "bytes"
    per_request = sum(e["per_request"] for e in captured.values())
    say(f"{label} per request: {per_request} launches, kernel {sums['eager']:.3f} ms eager "
        f"({100 * sums['bound'] / sums['eager']:.1f}% of bound), {sums['graph']:.3f} ms "
        f"graph replay ({100 * sums['bound'] / sums['graph']:.1f}%; int8 form "
        f"{sums['i8']:.3f}), plain {sums['plain']:.3f} ms, bound {sums['bound']:.3f} ms "
        f"({k3_by}) on {smi}")
    return sums, k3_err, k3_by


def int8_phases(predictor, requests, bf16_results, bf16_heads, cfg, dec, device,
                gen, smi) -> list:
    """Phases 7-11: K3 at odd shapes, the int8 path with the K1 stem and
    with the K4 stem, K3/K4 against their twins on the path's inputs, and
    timings. Returns the K3 and K4 entries of the kernels line."""
    import torch
    import torch.nn.functional as F

    from range_view_3d_detection_torch.kernels.conv import conv3x3_i8_fused, quantize_to_int8
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.kernels.stem import (
        meta_kernel_fused,
        meta_kernel_fused_i8,
        meta_kernel_fused_i8_plain,
    )
    from range_view_3d_detection_torch.models import quantized, stems

    # 7. K3 against its twin at small odd shapes, in both operand forms: odd
    # H (4 rows a block), W below and above the 64-pixel tile, Cin 32/64,
    # Cout 16/32/48 (one ragged 128-channel tile) and 256/512 (several);
    # then Cin and Cout off those multiples (K3_TAIL_SHAPES).
    k3_odd_shapes((((1, 5, 33, 32), 32, 1), ((1, 6, 18, 32), 32, 2),
                   ((2, 7, 37, 64), 48, 1), ((1, 5, 131, 32), 16, 2),
                   ((1, 3, 70, 64), 48, 1), ((1, 5, 70, 32), 512, 1),
                   ((2, 3, 37, 64), 256, 2)) + K3_TAIL_SHAPES, gen, device)
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
    captured, k3_in = capture_k3(predictor, requests[0])  # warm-up, and its K3 inputs
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
    # operand forms; times, bounds, shares.
    B, H = requests[0][0].shape[:2]
    sums, k3_err, k3_by = k3_request_shapes(captured, B, H, smi)
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
        check(n_diff == 0, f"K4 {tag}: {n_diff} elements differ from the twin")
        say(f"K4 {tag} {tuple(args['g'].shape)}: max|diff| {err:.4g} (max|ref| "
            f"{ref:.4g}), {n_diff} of {got.numel()} elements differ; ok")
        k4_err = max(k4_err, err)
    k4_err = max(k4_err, check_k4_any_c(gen_k4, device))
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


def flagship_train_batch(cfg, B, H, W, seed, n_boxes=64, inputs=None):
    """A flagship training batch: ``_sample_inputs`` (or ``inputs``, a
    range image ``(features, cart, mask)`` of that shape) and ``n_boxes``
    valid boxes of ``cfg.max_boxes`` slots an image, centred on seeded
    valid returns, l, w, h in [0.5, 6] m, yaw in [-pi, pi), categories
    seeded."""
    import numpy as np

    from range_view_3d_detection_torch import serving

    rng = np.random.default_rng(seed)
    if inputs is None:
        inputs = serving._sample_inputs(B, H, W, cfg.in_channels, seed=seed)
    feats, cart, mask = inputs
    check(feats.shape == (B, H, W, cfg.in_channels), f"train batch of {feats.shape}")
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
QAT_STEPS = 100  # a cut from 300, for phase 46's time
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

    # The CLI as a user types it goes beside phase 37 (``BESIDE_COMPILE``).
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
    """ms a train step (2 warm-up, the median of 3) split by part, and
    peak GiB, from a fresh state."""
    import torch

    from range_view_3d_detection_torch.training import optim, state as state_lib

    tx, _ = optim.make_optimizer(1e-3, 10, debug=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = state_lib.create_state(cfg, tx, device=device,
                                generator=torch.Generator().manual_seed(seed))
    total, split, st = step_split(state_lib.make_train_step(cfg), st, batch, n=5)
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
        say(f"remat (phase 22) {tag}: {total:.3f} ms a step (CUDA events, median of 3 after "
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
import os, sys, time, numpy as np, torch
sys.path.insert(0, {repo!r})
import range_view_3d_detection_torch.kernels
while not os.path.exists({ready!r}):
    time.sleep(0.1)
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


def aot_phase(art_dir: Path, requests, device, smi, label="phase 27") -> dict:
    """Phase 27 (see the module docstring); ``label`` names the phase in
    the lines printed. Returns the launches of the AOT programs'
    requests."""
    import numpy as np
    import torch

    from range_view_3d_detection_torch.export import export_aot

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
                aot_child_finish(child, child_want, label, "beside the int8 export")
            launches, want = aot_check(art_dir, tag, path, requests, device, smi, label,
                                       f"export_aot {export_s:.1f} s")
            for name in total:
                total[name] += launches[name]
            if tag == "bf16":
                child, child_want = aot_child_start(art_dir, path), want
    finally:
        if child is not None and child["proc"].poll() is None:
            child["proc"].kill()
            child["proc"].wait()
    for path in paths.values():
        path.unlink()
    torch.cuda.empty_cache()
    say(f"AOT ({label}): {time.perf_counter() - t_phase:.0f} s")
    return total


def aot_check(art_dir: Path, tag, path: Path, requests, device, smi, label, made,
              reps: int = 10) -> tuple:
    """The AOT program ``path`` (exported from ``art_dir / tag``; ``made``
    says how, for the printed line) against ``load_artifact`` on
    ``requests``: every output equal bit for bit, K2 (and K1 with a META
    stem, K3 in int8) launched, each one's ms a request (median of
    ``reps``). Returns ``(launches, load_artifact's first result)``."""
    import torch

    from range_view_3d_detection_torch.export import load_aot, load_artifact

    B = requests[0][0].shape[0]
    ref, _, _ = load_artifact(art_dir / tag, device=device)
    want = [ref(*r) for r in requests]
    aot = load_aot(path)
    aot(*requests[0])
    torch.cuda.synchronize()
    reset_counts()
    got = [aot(*r) for r in requests]
    torch.cuda.synchronize()
    launches = read_counts()
    for g, w in zip(got, want):
        for field, a, b in zip(w._fields, g, w):
            check(bit_equal(a, b), f"AOT {tag}: {field} differs from load_artifact's")
    need = ("nms_scan",) + (("meta_kernel_fused",) if ref.cfg.stem_type == "META" else ()) + (
        ("conv3x3_i8_fused",) if tag == "int8" else ())
    check(all(launches[k] > 0 for k in need), f"AOT {tag} launches {launches}")
    ms_aot = statistics.median(cuda_sync_wall(lambda: aot(*requests[1])) for _ in range(reps))
    ms_ref = statistics.median(cuda_sync_wall(lambda: ref(*requests[1])) for _ in range(reps))
    say(f"AOT ({label}) {tag}: {made}, {path.name} "
        f"{path.stat().st_size / 2**20:.1f} MiB; load_aot's outputs equal "
        f"load_artifact's bit for bit on {len(requests)} B={B} requests; launches "
        f"{launches}; {ms_aot:.3f} ms/request beside load_artifact's {ms_ref:.3f} "
        f"(median of {reps}, host wall through a synchronisation) on {smi}")
    return launches, want[0]


def aot_child_start(art_dir: Path, path: Path, ready: Path | None = None) -> dict:
    """A process that imports only the kernels package and, once ``ready``
    exists (default: ``path``, already written), serves the program
    ``path`` on ``art_dir/request.npz``."""
    out = art_dir / "aot_child.pt"
    code = AOT_CHILD.format(repo=str(REPO), req=str(art_dir / "request.npz"),
                            path=str(path), out=str(out), ready=str(ready or path))
    return dict(proc=subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True),
                out=out, path=path, t0=time.perf_counter())


def aot_child_wait(child: dict) -> None:
    """Wait for ``aot_child_start``'s process to end; its output and
    seconds are kept in ``child``."""
    if "stdout" not in child:
        child["stdout"], child["stderr"] = child["proc"].communicate(timeout=600)
        child["s"] = time.perf_counter() - child["t0"]


def aot_child_finish(child: dict, want, label, beside) -> None:
    """``aot_child_start``'s process ended (``aot_child_wait``): exit 0
    and every output equal bit for bit to ``want``, ``load_artifact``'s
    result on the request."""
    import torch

    aot_child_wait(child)
    check(child["proc"].returncode == 0, f"AOT child: rc {child['proc'].returncode}\n"
          f"{child['stderr'][-3000:]}")
    for field, a, b in zip(want._fields, torch.load(child["out"]), want):
        check(bit_equal(a, b.cpu()), f"AOT child: {field} differs")
    say(f"AOT ({label}): a process that imports only the kernels package loads and serves "
        f"{child['path'].name} (bf16) equal bit for bit ({child['stdout'].strip()}; "
        f"{child['s']:.1f} s {beside})")


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


def converted_phase(device, smi, keep: Path | None = None) -> dict:
    """Phase 29 (see the module docstring). Returns the launches of K1 and
    K2 while the converted corpus trains, validates and serves.
    ``keep``: where the converted corpora are moved for phases 48 and 49,
    ``keep/NAME`` for each of ``USER_CORPORA`` (else they go with the
    phase's work directory)."""
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

        # 6. The nuScenes corpus converted above through the rv-nuscenes
        # Trainer at its published widths, validated and scored.
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        meta_kernel_fused.launches = 0
        nms_scan.launches = 0
        nusc = nuscenes_trainer_run(work / "nuscenes", work / "run_nuscenes", device)
        check(nusc["layers"] == (128,) * 5 and nusc["shape"] == (32, 1808, 5),
              f"nuScenes Trainer: layers {nusc['layers']}, sweep {nusc['shape']}")
        nusc_launches = {"K1": meta_kernel_fused.launches, "K2": nms_scan.launches}
        check(nusc_launches["K1"] > 0 and nusc_launches["K2"] > 0,
              f"nuScenes Trainer launches {nusc_launches}")
        say(f"converted nuScenes corpus (phase 29): rv-nuscenes at its published widths, B=2 "
            f"{nusc['shape']}, 1 step in {nusc['fit_s']:.2f} s (loss {nusc['loss']:.4f}), "
            f"validate {nusc['val_s']:.2f} s ({nusc['shards']} shards), evaluator "
            f"{nusc['eval_s']:.3f} s at {nusc['max_range_m']} m, ROI instances only: "
            f"{nusc['eval_only_roi_instances']}, AVERAGE_METRICS "
            + ", ".join(f"{k} {v:.4f}" for k, v in nusc["average"].items())
            + f"; launches {nusc_launches} on {smi}")
        if keep is not None:
            for name in USER_CORPORA:
                shutil.move(str(work / name), str(keep / name))
        return {"meta_kernel_fused": launches["K1"] + nusc_launches["K1"],
                "nms_scan": launches["K2"] + nusc_launches["K2"],
                "conv3x3_i8_fused": 0, "meta_kernel_fused_i8": 0}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def nuscenes_trainer_run(corpus: Path, run_dir: Path, device, overrides=()) -> dict:
    """Phase 29's nuScenes corpus (converted from ``write_raw_nuscenes``'
    one scene of two sweeps, in its train split) through the rv-nuscenes
    ``Trainer`` on ``device`` with the val split pinned to train, as the
    JAX package's ``test_rv_nuscenes_train_smoke`` pins it: one epoch at
    B=2 (``overrides`` after those), ``validate`` to one shard a sweep,
    and the shards scored by ``evaluate_predictions`` under
    ``detection_cfg_factory("nuscenes")``'s settings (55 m, every
    instance), every average finite."""
    import torch

    from range_view_3d_detection_torch.evaluation import detection_cfg_factory
    from range_view_3d_detection_torch.evaluation.av2_eval import evaluate_predictions
    from range_view_3d_detection_torch.training.loop import Trainer
    from range_view_3d_detection_torch.utils.config import compose

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    cfg = compose(REPO / "conf", "rv-nuscenes", [
        f"++dataset.root_dir={corpus}", "++dataset._val_dataset.split_name=train",
        f"++run_dir={run_dir}", "++trainer.max_epochs=1", "++model.batch_size=2",
        "++model.train_log_freq=0", *overrides])
    trainer = Trainer(cfg, device=device)
    check(trainer.device.type == torch.device(device).type and len(trainer.train_ds) == 2
          and len(trainer.val_ds) == 2,
          f"nuScenes trainer on {trainer.device}, {len(trainer.train_ds)} train and "
          f"{len(trainer.val_ds)} val sweeps")
    item = trainer.train_ds[0]
    t0 = time.perf_counter()
    state = trainer.fit()
    sync()
    fit_s = time.perf_counter() - t0
    check(state.step == 1, f"nuScenes corpus: step {state.step}")
    losses = [json.loads(x).get("loss") for x in
              (Path(cfg["run_dir"]) / "metrics.jsonl").read_text().splitlines()]
    losses = [x for x in losses if x is not None]
    check(len(losses) == 1 and math.isfinite(losses[0]), f"nuScenes losses {losses}")
    t0 = time.perf_counter()
    pred_dir = trainer.validate()
    sync()
    val_s = time.perf_counter() - t0
    shards = sorted(pred_dir.glob("*.feather"))
    check(len(shards) == 2, f"nuScenes corpus: {len(shards)} shards")
    eval_cfg = detection_cfg_factory("nuscenes")
    t0 = time.perf_counter()
    metrics = evaluate_predictions(
        pred_dir, corpus / "train", trainer.categories, max_range_m=eval_cfg.max_range_m,
        eval_only_roi_instances=eval_cfg.eval_only_roi_instances,
        dataset_name=eval_cfg.dataset_name)
    eval_s = time.perf_counter() - t0
    avg = metrics["AVERAGE_METRICS"]
    check(bool(avg) and all(math.isfinite(v) for v in avg.values()),
          f"nuScenes AVERAGE_METRICS {avg}")
    return dict(fit_s=fit_s, val_s=val_s, eval_s=eval_s, loss=losses[0], shards=len(shards),
                average=avg, shape=tuple(item["features"].shape), layers=trainer.det_cfg.layers,
                max_range_m=eval_cfg.max_range_m,
                eval_only_roi_instances=eval_cfg.eval_only_roi_instances)


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
    # The CLI as a user runs it goes beside phase 37 (``BESIDE_COMPILE``);
    # here the four modes' flags go through its entry point, bench.main,
    # each mode alone.

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

        # 36. scale_drill, cut in depth (quant_cert_scale goes beside
        # phase 37).
        reset_counts()
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

    dryrun_entry(smi)
    beside = {}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(BESIDE_COMPILE)) as pool:
        jobs = {tag: pool.submit(fn) for tag, fn in BESIDE_COMPILE.items()}
        compile_counts = compile_phase(device, smi)
        for tag, job in jobs.items():
            beside[tag] = job.result()
    say(f"phases 21, 30, 36, 38 and 42's check-only runs beside phase 37: "
        f"{time.perf_counter() - t0:.0f} s")
    export_cli_line(beside.pop("export CLI"), kind, smi)
    bench_cli_line(beside.pop("bench CLI"), kind, smi)
    cert_line(beside.pop("quant_cert_scale"))
    dryrun = dryrun_line(beside.pop("dryrun"), smi)
    return {"tools": tools_counts, "compile": compile_counts, "dryrun": dryrun,
            "hw_beside": list(beside.values())}


def run_cli(tag, args, env=None) -> tuple:
    """``python -m`` ``args`` from the checkout, its output captured:
    ``(tag, args, returncode, stdout, stderr, wall s)``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=900, env=env or _env())
    return tag, args, proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t0


def export_cli_run() -> tuple:
    """Phase 21's export CLI as a user types it, in a directory of its own:
    ``--synthetic --out D``, then ``--load D --points --latency --iters
    50``. Returns each step's ``run_cli`` record."""
    out = Path(tempfile.mkdtemp(prefix="chip-smoke-export-cli-"))
    try:
        return tuple(run_cli("export", ["range_view_3d_detection_torch.export", *args])
                     for args in (["--synthetic", "--out", str(out / "art")],
                                  ["--load", str(out / "art"), "--points", "--latency",
                                   "--iters", "50"]))
    finally:
        shutil.rmtree(out, ignore_errors=True)


def export_cli_line(runs, kind: str, smi: str) -> None:
    """Phase 21's export CLI (``export_cli_run``'s records): both steps
    exit 0, the latency line's 50 requests on the card, percentiles in
    order."""
    for _, args, rc, _, stderr, _ in runs:
        check(rc == 0, f"export CLI {args[1:]}: rc {rc}\n{stderr[-2000:]}")
    stats = json.loads(runs[-1][3].strip().splitlines()[-1])
    check(stats["iters"] == 50 and stats["device"] == kind
          and 0 < stats["latency_ms_min"] <= stats["latency_ms_p50"]
          <= stats["latency_ms_p90"] <= stats["latency_ms_p99"],
          f"export CLI latency line {stats}")
    say(f"export CLI (phase 21: --synthetic, then --load --points --latency --iters 50) in "
        f"{sum(r[5] for r in runs):.1f} s, beside phase 37 (its latencies are not clean): "
        f"{json.dumps(stats)} on {smi}")


def bench_cli_line(run, kind: str, smi: str) -> None:
    """Phase 30's CLI run (``run_cli``'s record): exit 0 and a gated JSON
    line."""
    _, _, rc, stdout, stderr, wall = run
    check(rc == 0, f"bench exited {rc}: {stderr[-3000:]}")
    line = bench_json(stdout)
    check_bench_line("int8", line, kind, smi)
    say(f"bench (phase 30) python -m range_view_3d_detection_torch.bench: {json.dumps(line)} "
        f"({wall:.1f} s, beside phase 37: its frames/s are not clean)")


def cert_run() -> tuple:
    """Phase 36's ``tools.quant_cert_scale``, cut in depth, in a work
    directory of its own: ``(aggregate, wall s)``."""
    from range_view_3d_detection_torch.tools import quant_cert_scale

    work = Path(tempfile.mkdtemp(prefix="chip-smoke-cert-"))
    t0 = time.perf_counter()
    try:
        agg = quant_cert_scale.main(["--seeds", "1", "--epochs", "1", "--sweeps-per-log", "8",
                                     "--work", str(work)])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return agg, time.perf_counter() - t0


def cert_line(run) -> None:
    agg, wall = run
    check(agg["seeds"] == 1 and math.isfinite(agg["ptq_cds_delta_mean"]),
          f"quant_cert_scale: {agg}")
    say(f"tools.quant_cert_scale (phase 36) --seeds 1 --epochs 1 --sweeps-per-log 8 (cut "
        f"from 3 seeds x 40 epochs x 24 sweeps): {agg['num_val_gts']} val boxes, PTQ AP "
        f"delta {agg['ptq_ap_delta_mean']:.4f}, CDS delta {agg['ptq_cds_delta_mean']:.4f} "
        f"({wall:.1f} s, beside phase 37)")


def dryrun_run() -> tuple:
    """Phase 38's ``dryrun_multichip`` over NCCL on every card (its ranks
    are processes of their own): ``(results, n, wall s)``."""
    import torch

    from range_view_3d_detection_torch import dryrun

    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    return dryrun.dryrun_multichip(n), n, time.perf_counter() - t0


# Check-only runs in processes of their own, which go beside phase 37's
# compiles (this process's GPU work then is the compiled pipelines' few
# calls): none of them times what it runs for a number kept, and each
# counts its own launches. The CLIs are phases 21's and 30's, the two
# validate_nms runs phase 42's.
BESIDE_COMPILE = {
    "bench CLI": lambda: run_cli("bench", ["range_view_3d_detection_torch.bench"]),
    "export CLI": export_cli_run,
    "quant_cert_scale": cert_run,
    "dryrun": dryrun_run,
    "validate_nms WEIGHTED": lambda: run_cli(
        "validate_nms", ["range_view_3d_detection_torch.tools.validate_nms",
                         "--mode", "WEIGHTED", "--caps", "1024,2048,4096,9216"]),
    "validate_nms HARD": lambda: run_cli(
        "validate_nms", ["range_view_3d_detection_torch.tools.validate_nms",
                         "--mode", "HARD", "--caps", "1024,2048,4096,9216"]),
}


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


def compile_configs() -> dict:
    """Phase 37's models, each with the K1 stem: the tiny config as it is
    (widths 8, fp32: K1's 3xTF32 kernel) and the tiny config at 32 channels
    in bf16, the dtype the configs serve (K1's wgmma kernel)."""
    import dataclasses

    from range_view_3d_detection_torch import serving

    tiny = dataclasses.replace(serving._flagship_config(tiny=True), stem_pallas=True)
    return {"tiny fp32": tiny,
            "tiny at 32 channels bf16": dataclasses.replace(tiny, layers=(32,) * 5,
                                                            dtype="bfloat16")}


def compile_pipeline(model, dec, cfg):
    """Phase 37's pipeline: ``model``'s heads and their decode with NMS."""
    import torch

    from range_view_3d_detection_torch.models.decoder import decode

    def pipeline(feats, cart, mask):
        with torch.no_grad():
            out = model(feats, cart, mask)
            return out["head"][1][0], decode(out, dec, cfg.tasks_dict, use_nms=True)

    return pipeline


def compile_phase(device, smi) -> dict:
    """Phase 37: the pipeline under ``RV3D_COMPILER_OPTIONS``, for each of
    ``compile_configs``; the bench's compiled pipeline on the bf16 one."""
    import os

    import torch

    from range_view_3d_detection_torch import bench, serving
    from range_view_3d_detection_torch.models.decoder import DecoderConfig
    from range_view_3d_detection_torch.utils import compile_opts

    t0 = time.perf_counter()
    dec = DecoderConfig(nms_cap=256, min_confidence=0.0)
    args = tuple(torch.as_tensor(a, device=device) for a in serving._sample_inputs(1, 16, 256, 5))
    option = "max_autotune=False"
    total = {}
    for tag, cfg in compile_configs().items():
        torch._dynamo.reset()  # each config compiled afresh, not past Dynamo's recompile limit
        predictor = serving.Predictor(cfg, dec, device=device,
                                      generator=torch.Generator().manual_seed(SEED + 37))
        model = predictor.model
        pipeline = compile_pipeline(model, dec, cfg)
        heads, want = pipeline(*args)
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
        finally:
            os.environ.pop(compile_opts.ENV_VAR, None)
        check(counts["meta_kernel_fused"] > 0 and counts["nms_scan"] > 0,
              f"compiled pipeline ({tag}) launches {counts}")
        check(torch.equal(got.keep, want.keep) and bool(want.keep.any()),
              f"compiled pipeline ({tag}): keep differs from eager or is empty "
              f"({int(want.keep.sum())})")
        errs = {}
        for key in ("logits", "regressands"):
            ref = heads[key].float()
            err = (got_heads[key].float() - ref).abs().max().item()
            check(err <= 2e-2 * ref.abs().max().item(), f"compiled {tag} {key}: max|diff| {err}")
            errs[key] = err
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        scores = (got.scores - want.scores).abs().max().item()
        say(f"compile (phase 37) RV3D_COMPILER_OPTIONS={option} over "
            f"{compile_opts.EAGER_NUMERICS}, {tag} with K1, B=1 16x256: "
            f"compiled in {compile_s:.1f} s, keep equal to eager ({int(want.keep.sum())} "
            f"kept), heads max|diff| {errs}, decoded scores max|diff| {scores:.3g}, launches "
            f"{counts}")
    os.environ[compile_opts.ENV_VAR] = "no_such_option=1"
    try:
        compile_opts.jit_env_options(pipeline)(*args)
    except RuntimeError as e:
        refused = str(e).split(",")[0]
    else:
        check(False, "an unknown compiler option was accepted")
    finally:
        os.environ.pop(compile_opts.ENV_VAR, None)
    # The bench's own compiled path on the bf16 config (the last above).
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
    say(f"compile (phase 37): the bench's compiled pipeline ({tag}) keep equal to its eager "
        f"one; an unknown option raises ({refused}); the flagship not compiled (a cut); phase "
        f"{time.perf_counter() - t0:.0f} s on {smi}")
    return total


# ``chip_smoke.py compile-decode``: inductor option sets the whole decode is
# compiled under (the last is ``compile_opts.EAGER_NUMERICS``), and the
# environment's options that give the port's compiled programs and
# inductor's defaults.
DECODE_OPTION_SETS = {
    "inductor's defaults": {},
    "no fp fusion": {"emulate_precision_casts": True},
    "div_rn": {"eager_numerics.division_rounding": True},
    "eager numerics (no fp fusion, div_rn)": {"emulate_precision_casts": True,
                                              "eager_numerics.division_rounding": True},
}
PORT_SPEC = "max_autotune=False"
DEFAULTS_SPEC = ("max_autotune=False,emulate_precision_casts=False,"
                 "eager_numerics.division_rounding=False")


def tensor_diff(got, want) -> str:
    """Unequal elements of two tensors (NaN equal to NaN) and the largest
    difference, as text."""
    import torch

    if got.dtype == torch.bool or not got.is_floating_point():
        return f"{int((got != want).sum())} of {want.numel()} unequal"
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = (got.double() - want.double()).abs().nan_to_num(0.0).max().item()
    return f"{int((~same).sum())} of {want.numel()} unequal, max|diff| {diff:.3g}"


def compile_decode_phase(device, smi) -> dict:
    """Phase 37's models and input, the decode alone: which of its stages,
    compiled by inductor, gives values that differ from eager's, and which
    of those alone change the NMS keep. Each stage is compiled
    (``torch.compile``, ``dynamic=False``) on eager's inputs, compared with
    eager's output element by element, then put in place of eager's in an
    otherwise eager decode. The whole decode is compiled under each of
    ``DECODE_OPTION_SETS``; the pipeline (forward and decode) is timed
    compiled whole and compiled with the decode run eagerly (a graph
    break), under the port's options (``compile_opts.EAGER_NUMERICS``) and
    inductor's defaults; the flagship through the bench's compiled
    pipeline too."""
    import os

    import torch

    from range_view_3d_detection_torch import bench, serving
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.models import decoder
    from range_view_3d_detection_torch.models.decoder import DecoderConfig
    from range_view_3d_detection_torch.ops import nms as nms_ops
    from range_view_3d_detection_torch.utils import compile_opts

    check(DECODE_OPTION_SETS["eager numerics (no fp fusion, div_rn)"]
          == compile_opts.EAGER_NUMERICS, "compile-decode: EAGER_NUMERICS changed")
    dec = DecoderConfig(nms_cap=256, min_confidence=0.0)
    args = tuple(torch.as_tensor(a, device=device) for a in serving._sample_inputs(1, 16, 256, 5))
    iou_matrix = nms_ops.iou_matrix
    config = torch._inductor.config
    summary = {}
    for tag, cfg in compile_configs().items():
        torch._dynamo.reset()
        predictor = serving.Predictor(cfg, dec, device=device,
                                      generator=torch.Generator().manual_seed(SEED + 37))
        model, tasks = predictor.model, cfg.tasks_dict
        with torch.no_grad():
            out = model(*args)

        def proposals(out):
            return decoder.decode(out, dec, tasks, use_nms=False)

        def inputs_of(p):
            cap = min(dec.nms_cap, p.scores.shape[1])
            return nms_ops.nms_inputs(p.cuboids, p.scores, p.categories, cap=cap,
                                      min_confidence=dec.min_confidence, mode=dec.nms_mode)

        def scan(i):
            return nms_scan(i.iou, i.scores, i.valid, i.payload,
                            iou_threshold=dec.nms_threshold, merge_threshold=i.merge_threshold)

        def result(i, keep, merged):
            return nms_ops.nms_result(i, keep, merged, dec.num_post_nms)

        def chain(stages):
            p = stages.get("proposals", proposals)(out)
            i = stages.get("nms_inputs", inputs_of)(p)
            keep, merged = scan(i)
            return stages.get("nms_result", result)(i, keep, merged)

        want = decoder.decode(out, dec, tasks, use_nms=True)
        check(torch.equal(chain({}).keep, want.keep), "compile-decode: chain != decode")
        bev = {}

        def capture(b):
            bev["bev"] = b
            return iou_matrix(b)

        nms_ops.iou_matrix = capture
        try:
            p0 = proposals(out)
            i0 = inputs_of(p0)
        finally:
            nms_ops.iou_matrix = iou_matrix
        k0, m0 = scan(i0)
        r0 = result(i0, k0, m0)

        def compiled(fn, options=None):
            return torch.compile(fn, options=options or None, dynamic=False)

        lines = []
        # The IoU matrix alone: its values and the thresholds they cross.
        iou_c = compiled(iou_matrix)(bev["bev"])
        flips = {t: int(((iou_c > t) != (i0.iou > t)).sum()) for t in (0.3, 0.5)}
        nms_ops.iou_matrix = compiled(iou_matrix)
        try:
            with_iou = chain({})
        finally:
            nms_ops.iou_matrix = iou_matrix
        lines.append(f"IoU matrix (iou_rotated_bev): {tensor_diff(iou_c, i0.iou)}; pairs "
                     f"across 0.3 / 0.5: {flips[0.3]} / {flips[0.5]}; keep "
                     f"{'equal' if torch.equal(with_iou.keep, want.keep) else 'differs'}")
        # Each stage compiled whole, in an otherwise eager decode.
        p_c = compiled(proposals)(out)
        lines.append("proposals (sigmoid, amax, argmax, decode_boxes, sample_by_range): "
                     + "; ".join(f"{f} {tensor_diff(getattr(p_c, f), getattr(p0, f))}"
                                 for f in ("scores", "categories", "cuboids")))
        i_c = compiled(inputs_of)(p0)
        lines.append("nms_inputs (sort, gather, class offsets, sin/cos, IoU): "
                     + "; ".join(f"{f} {tensor_diff(getattr(i_c, f), getattr(i0, f))}"
                                 for f in ("scores", "valid", "payload", "iou")))
        r_c = compiled(result)(i0, k0, m0)
        lines.append("nms_result (atan2, post-NMS cap): "
                     + "; ".join(f"{f} {tensor_diff(getattr(r_c, f), getattr(r0, f))}"
                                 for f in ("cuboids", "scores", "keep")))
        for name, fn in (("proposals", proposals), ("nms_inputs", inputs_of),
                         ("nms_result", result)):
            got = chain({name: compiled(fn)})
            lines.append(f"only {name} compiled: keep "
                         f"{'equal' if torch.equal(got.keep, want.keep) else 'differs'}")
        # The whole decode under each option set.
        whole = {}
        for opt_tag, options in DECODE_OPTION_SETS.items():
            if any(k not in config.get_config_copy() for k in options):
                lines.append(f"decode compiled ({opt_tag}): this torch has no such option")
                continue
            torch._dynamo.reset()
            got = compiled(lambda o: decoder.decode(o, dec, tasks, use_nms=True),
                           {**options, "max_autotune": False})(out)
            moved = torch.nonzero(got.keep != want.keep).tolist()
            whole[opt_tag] = not moved
            torch._dynamo.reset()
            iou_o = compiled(iou_matrix, {**options, "max_autotune": False})(bev["bev"])
            lines.append(
                f"decode compiled ({opt_tag}): keep {'equal' if not moved else 'differs'} "
                f"({int(want.keep.sum())} kept eager, {int(got.keep.sum())} compiled), "
                f"scores {tensor_diff(got.scores, want.scores)}; IoU matrix alone "
                f"{tensor_diff(iou_o, i0.iou)}; slots that differ (eager / "
                f"compiled score): "
                + (", ".join(f"{s} ({want.scores[b, s].item():.4g} / "
                             f"{got.scores[b, s].item():.4g})" for b, s in moved[:8])
                   or "none"))
        # The pipeline as compile_opts compiles it: under the port's
        # options, under inductor's defaults, and with the decode eager.
        def pipeline(decode_fn):
            def run(feats, cart, mask):
                with torch.no_grad():
                    return decode_fn(model(feats, cart, mask), dec, tasks, use_nms=True)
            return run

        times = {}
        variants = (("eager numerics", PORT_SPEC, decoder.decode),
                    ("inductor's defaults", DEFAULTS_SPEC, decoder.decode),
                    ("decode eager", PORT_SPEC, torch.compiler.disable(decoder.decode)))
        for name, spec, fn in variants:
            torch._dynamo.reset()
            os.environ[compile_opts.ENV_VAR] = spec
            try:
                prog = compile_opts.jit_env_options(pipeline(fn))
                got = prog(*args)
                times[name] = cuda_ms(lambda: prog(*args), reps=50, warmup=5)
            finally:
                os.environ.pop(compile_opts.ENV_VAR, None)
            lines.append(f"pipeline compiled ({name}): keep "
                         f"{'equal' if torch.equal(got.keep, want.keep) else 'differs'}")
        torch._dynamo.reset()
        with torch.no_grad():
            times["eager"] = cuda_ms(lambda: pipeline(decoder.decode)(*args), reps=50,
                                     warmup=5)
        for line in lines:
            say(f"compile-decode {tag}: {line}")
        say(f"compile-decode {tag}: B=1 16x256 pipeline ms "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + f" on {smi}")
        summary[tag] = {"whole": whole, "ms": times}
        del predictor, model, out
    # The flagship (bf16, B=2 64x1808) through the bench's compiled
    # pipeline, beside the eager Predictor with the same weights.
    eager, bench_args, _, _ = bench.build(2, fp=True, device=device)
    want = eager(*bench_args)
    times = {"eager": cuda_ms(lambda: eager(*bench_args), reps=10)}
    del eager
    for name, spec in (("eager numerics", PORT_SPEC), ("inductor's defaults", DEFAULTS_SPEC)):
        torch._dynamo.reset()
        os.environ[compile_opts.ENV_VAR] = spec
        try:
            served, bench_args, _, _ = bench.build(2, fp=True, device=device)
        finally:
            os.environ.pop(compile_opts.ENV_VAR, None)
        t1 = time.perf_counter()
        got = served(*bench_args)
        compile_s = time.perf_counter() - t1
        times[name] = cuda_ms(lambda: served(*bench_args), reps=10)
        say(f"compile-decode flagship bf16 B=2 64x1808, the bench's compiled pipeline "
            f"({name}): compiled in {compile_s:.1f} s, keep "
            f"{'equal' if torch.equal(got.keep, want.keep) else 'differs'} "
            f"({int(want.keep.sum())} kept eager, {int(got.keep.sum())} compiled), scores "
            f"{tensor_diff(got.scores, want.scores)}")
        del served
        torch.cuda.empty_cache()
    say("compile-decode flagship bf16 B=2 64x1808 pipeline ms "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + f" on {smi}")
    summary["flagship bf16"] = {"ms": times}
    return summary


def compile_decode_main() -> int:
    """``chip_smoke.py compile-decode``: the build, then
    :func:`compile_decode_phase`."""
    import inspect

    import torch

    t_start = time.perf_counter()
    start = card_start()
    if start is None:
        return 1
    device, smi = start
    from torch._inductor.codegen import triton as inductor_triton

    say("compile-decode: inductor's emulate_precision_casts turns off fp fusion here: "
        f"{'enable_fp_fusion' in inspect.getsource(inductor_triton)}; torch "
        f"{torch.__version__}")
    say(json.dumps({"compile_decode": compile_decode_phase(device, smi)}))
    say(f"chip_smoke compile-decode: total {time.perf_counter() - t_start:.0f} s")
    return 0


def dryrun_entry(smi) -> None:
    """Phase 38's in-process part: ``dryrun.entry()``'s forward, finite."""
    import torch

    from range_view_3d_detection_torch import dryrun

    model, inputs = dryrun.entry()
    with torch.inference_mode():
        out = model(*inputs)
    head = out["head"][1][0]
    check(all(bool(torch.isfinite(v).all()) for v in head.values()), "entry(): non-finite")
    del model, inputs, out, head
    torch.cuda.empty_cache()


def dryrun_line(run, smi) -> dict:
    """Phase 38's ``dryrun_multichip`` (``dryrun_run``'s record): its four
    phases ok; returns its results (phase 40 reads phase 3's)."""
    results, n, wall = run
    check(all(r["status"] == "ok" for r in results.values()) and len(results) == 4,
          f"dryrun_multichip({n}): {results}")
    say(f"dryrun (phase 38): entry() finite; dryrun_multichip({n}) over NCCL: "
        + "; ".join(f"{k} {v['result']}" for k, v in results.items())
        + f" ({wall:.0f} s, beside phase 37) on {smi}")
    return results


# Phase 39: K2 past the register keep's cap 4096.
NMS_BIG_CAPS = (4097, 4160, 8192, 9216)
# Phase 41: a Feather file pyarrow 25.0.0 wrote with ZSTD bodies at level 1
# (two record batches) and 19 (one), from the same 200-row table: float32
# with nulls, uint8 with nulls, int16, bool with nulls, a dictionary of
# strings with null indices, strings with nulls, binary with nulls, int64
# (tests/test_torch_feather_zstd.py writes it again and holds the port's
# reading of these bytes to pyarrow's). The card's machine has no pyarrow.
FEATHER_ZSTD = {
    1: (
        "QVJST1cxAAD/////AAIAABAAAAAAAAoADAAGAAUACAAKAAAAAAEEAAQAAAAQ////BAAAAAgAAACsAQAAZAEA"
        "ACgBAAD4AAAAqAAAAGwAAABAAAAABAAAAIT+//8AAAECEAAAACAAAAAEAAAAAAAAAAwAAAB0aW1lc3RhbXBf"
        "bnMAAAAA+P7//wAAAAFAAAAAvP7//wAAAQQQAAAAGAAAAAQAAAAAAAAABAAAAGJsb2IAAAAAVP///+T+//8A"
        "AAEFEAAAABgAAAAEAAAAAAAAAAYAAABsb2dfaWQAAHz///8QABgACAAGAAcADAAQABQAEAAAAAAAAQUUAAAA"
        "PAAAACQAAAAEAAAAAAAAAAgAAABjYXRlZ29yeQAAAAAIAAgAAAAEAAgAAAAEAAAAoP///wAAAAEgAAAA2P//"
        "/2j///8AAAEGEAAAABwAAAAEAAAAAAAAAAUAAAB2YWxpZAAAAAQABAAEAAAAlP///wAAAQIQAAAAIAAAAAQA"
        "AAAAAAAABQAAAGxhc2VyAAAACAAMAAgABwAIAAAAAAAAARAAAADM////AAABAhAAAAAgAAAABAAAAAAAAAAJ"
        "AAAAaW50ZW5zaXR5AAYACAAEAAYAAAAIAAAAEAAUAAgABgAHAAwAAAAQABAAAAAAAAEDEAAAABgAAAAEAAAA"
        "AAAAAAEAAAB4AAYACAAGAAYAAAAAAAEA/////8AAAAAUAAAAAAAAAAwAGAAGAAUACAAMAAwAAAAAAgQAGAAA"
        "AGAAAAAAAAAAAAAAAAgACAAAAAQACAAAABAAAAAMAB4AEAAEAAgADAAMAAAAYAAAACQAAAAYAAAAAwAAAAAA"
        "AAAAAAAAAAAGAAgABwAGAAAAAAAAAQMAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAhAAAAAAAAACgAAAAA"
        "AAAAMQAAAAAAAAAAAAAAAQAAAAMAAAAAAAAAAAAAAAAAAAAQAAAAAAAAACi1L/0gEIEAAAAAAAAPAAAAGQAA"
        "ACAAAAAAAAAAAAAAIAAAAAAAAAAotS/9ICABAQBSRUdVTEFSX1ZFSElDTEVQRURFU1RSSUFOQk9MTEFSRAAA"
        "AAAAAAD/////EAIAABQAAAAAAAAADAAYAAYABQAIAAwADAAAAAADBAAcAAAAkAcAAAAAAAAAAAAADAAeABAA"
        "BAAIAAwADAAAAFABAAAkAAAAGAAAAGQAAAAAAAAAAAAAAAAABgAIAAcABgAAAAAAAAESAAAAAAAAAAAAAAAq"
        "AAAAAAAAADAAAAAAAAAAgAEAAAAAAACwAQAAAAAAACoAAAAAAAAA4AEAAAAAAAB5AAAAAAAAAGACAAAAAAAA"
        "AAAAAAAAAABgAgAAAAAAAGQAAAAAAAAAyAIAAAAAAAAqAAAAAAAAAPgCAAAAAAAAKgAAAAAAAAAoAwAAAAAA"
        "ACoAAAAAAAAAWAMAAAAAAABKAAAAAAAAAKgDAAAAAAAAKgAAAAAAAADYAwAAAAAAAOQAAAAAAAAAwAQAAAAA"
        "AAAqAAAAAAAAAPAEAAAAAAAAKgAAAAAAAAAgBQAAAAAAAKkAAAAAAAAA0AUAAAAAAABeAAAAAAAAADAGAAAA"
        "AAAAAAAAAAAAAAAwBgAAAAAAAGABAAAAAAAAAAAAAAgAAABkAAAAAAAAAAkAAAAAAAAAZAAAAAAAAAAEAAAA"
        "AAAAAGQAAAAAAAAAAAAAAAAAAABkAAAAAAAAAAgAAAAAAAAAZAAAAAAAAAAJAAAAAAAAAGQAAAAAAAAAFAAA"
        "AAAAAABkAAAAAAAAABgAAAAAAAAAZAAAAAAAAAAAAAAAAAAAABkAAAAAAAAAKLUv/SAZyQAA97///763///r"
        "//v//+//+9//3///v////wAAAAAAAJABAAAAAAAAKLUv/WCQAHULAMbXVz8gc5o1TtPcCxD/CcK87sc9rUr2"
        "fN4I4wHevq6hFLcQGHVkBwBoSDAjThpJAqYvEY+mQOG5Tp75mDOsMccalAFIAEQARQASXmwukcYDWOIYqG0P"
        "H3snrI4wNQ+Q8gNTs/Wxa9jmGUi4rkcGnmQgdMJZYrep0yIQXQSi3Y4VT6cyNV0ODjNEsW5GnTqUbQaX8L5V"
        "puYb3rcJxeYscRXSuI46vSIDT6HYPzLhPqjthtjoWsLqgtTplLAyCatRWCKOS7sGtf1d2iwy4SMy4Ru87wI2"
        "OoO4tD9I4wJO50xYbYHDXOHS7pCBl0jjHE5nDpd2A2r7gY12QLEnWOIhOMwmMnAaUu7CRqNAdBs2OoYlLoPD"
        "XMumTmKbAVdm4A0BoQtgxXMFXNolcLkY8L47QrHLoE6X2uaFII03wcdeBVJeBHW60/vmUadbQPQUNhoGCbfn"
        "cvnEpi4iA78g5SNhNQVOJwQEAtMuTl7ki+0zzRkAAAAAAAAAKLUv/SAZyQAA///v/////7//7//v///9///v"
        "v/+f/////wAAAAAAAGgAAAAAAAAAKLUv/SBoQQMA1wVNw85maYU4u2DgnEii3zO8B5BuoaRA5y2cGR6Zw/6a"
        "81eotPkq0WQg2kpv8tJzrGlpbxE+vbaW7hFCURYRN3PLhiXd/xMbvJlre4EvBI6Xecho74wCsSoOAg7AUUza"
        "L28kMkoj3/oAAAAAAAAAyAAAAAAAAAAotS/9IMidAgACSBIIEPhsBh+rTAF7eXd1c3FvbWtpZ2VjYV9dW1lX"
        "VVNRT01LSUdFQ0E/PTs5NzUzMS8tKyknJSMhHx0bGRcVExEPDQsJBwUDAb8DAQCAGqBGCgAAAAAZAAAAAAAA"
        "ACi1L/0gGckAAP3+ff//vf//9/v//+/37/p++/ev/W////cAAAAAAAAZAAAAAAAAACi1L/0gGckAAC3/J05/"
        "fH33v3Oenv691p/t/X599t/+890AAAAAAAAZAAAAAAAAACi1L/0gGckAAP/3df+/////97//++23f+XZ/+1/"
        "7/9v/98AAAAAAACQAQAAAAAAACi1L/1gkADFAQCQAAAAAAEAAAACAAICAAEAAgIBEgCAAASAQDrwAVYgIA+s"
        "AC8A4oANYGMwIOAB7EAIQMALAwNAAgAAAAAAABkAAAAAAAAAKLUv/SAZyQAAX3/67X+6//P/s/f39W9+1+m/"
        "fV//v+3/7wAAAAAAAJQBAAAAAAAAKLUv/WCUAJUGAMaRKy8wVTKMAVhpvTxWjJjJwlp2Uw+PFSNmsrCW3dTD"
        "Y8WImSycSNwyL1vMncFsTNsyBRwAHQAeAFVQbnKSixzkHhwax7jFKS5xiDswJNzgAwf46QMK7+ARvICHeiWk"
        "G51ICOg+57nOcW5zmssc5i4sB/fyWt7KS3knr+SNvJD38Trexst4FxVv4kW8h9fwAq/qVS28EF4FL4FXaple"
        "0jt6RW/oBb2fnrfzct5NzZuJGQ8AQV6CMYL8QdYFDAwwBWQJsigwD2QdZAb5BswAWTxzTAAAAABAAgAAAAAA"
        "ACi1L/1gQAHFAACIbG9nLTAwMDFsb2ctMDAxbG8BACxUFSMAAAAAAAAZAAAAAAAAACi1L/0gGckAANLbv6ut"
        "792Tv////nYv/1330PPWn/6+238AAAAAAACUAQAAAAAAACi1L/1glAC9BACSShcYQL0bDjyy0W677bbbzhht"
        "A9tgiUqm2dcUf3/f6Z477jdb7bTZZY8d9rrrrbNWVz111Omml04aXRQ66ON5h/PNNZljfrFUKJNLIpDHHQ3G"
        "F1c8gTjcUDjhgwsCgAMcAMA8yAzkF+QP5A/kD+QPMg2qAseAeyBKECVwAtyByIB7wAlwF0QFjgXugWPAvcA9"
        "cGwXBQawAAAAAAAAAMAAAAAAAAAAKLUv/SDAbQIAogUJhREREW1LcguAP/8Lkk1/S+mfXJL8tklC25LcBAAt"
        "JSkJMEkmDwBaSQABbIy7Rh42DOw8gAbacKMGB1QhIEK0EIef0EZU4lzeFBQAACADAAAAAAAAKLUv/WAgAnUK"
        "AIQTABAJpSGMYgQA8f6q0vSws+q2lOC8ddbCVszIN8LOGLjU+a3a2qPgu5nmnI/sfYXyXnv4P3H+IGcEIgFd"
        "CuJSEMNIFqQ+HIU0ImYqKEcgLigWNAkMOuoBQMv3RaztS43jUW7ZV0/PXTDFYxG7afKwb9OmdbSce5WSgXaI"
        "h1d+jTh0kxlqmfpfn9tVpbxLq51BsX43t18tvUAjwyEZyQIPz+ME1cT62qXw4Ibm5mfc7EjS8inI+Aq+/uuz"
        "BCPMqQqtnxCOlRZvixxQgSIxdygSbS7zYjTUWDq1TkCWREZ3OkxYMFI5JlgaHF77EWTcB2q9/W+e83V/6Xtg"
        "34FB1Yciy40DwZPktpnFrJ+moqWHmKtojrFJhLcqer0LcMPsZcnNW8+uUdWPR9twPeFRM+cyKe0TH/MjjGIE"
        "YqgQ/OwZ4NcQED97W+CqA4P5lAL/////EAIAABQAAAAAAAAADAAYAAYABQAIAAwADAAAAAADBAAcAAAA+AYA"
        "AAAAAAAAAAAADAAeABAABAAIAAwADAAAAFABAAAkAAAAGAAAAGQAAAAAAAAAAAAAAAAABgAIAAcABgAAAAAA"
        "AAESAAAAAAAAAAAAAAAeAAAAAAAAACAAAAAAAAAAdQEAAAAAAACYAQAAAAAAAB4AAAAAAAAAuAEAAAAAAAB1"
        "AAAAAAAAADACAAAAAAAAAAAAAAAAAAAwAgAAAAAAAGQAAAAAAAAAmAIAAAAAAAAeAAAAAAAAALgCAAAAAAAA"
        "HgAAAAAAAADYAgAAAAAAAB4AAAAAAAAA+AIAAAAAAABMAAAAAAAAAEgDAAAAAAAAHgAAAAAAAABoAwAAAAAA"
        "AOUAAAAAAAAAUAQAAAAAAAAgAAAAAAAAAHAEAAAAAAAAHgAAAAAAAACQBAAAAAAAAKUAAAAAAAAAOAUAAAAA"
        "AABWAAAAAAAAAJAFAAAAAAAAAAAAAAAAAACQBQAAAAAAAGIBAAAAAAAAAAAAAAgAAABkAAAAAAAAAAUAAAAA"
        "AAAAZAAAAAAAAAAFAAAAAAAAAGQAAAAAAAAAAAAAAAAAAABkAAAAAAAAAA8AAAAAAAAAZAAAAAAAAAARAAAA"
        "AAAAAGQAAAAAAAAAEgAAAAAAAABkAAAAAAAAABoAAAAAAAAAZAAAAAAAAAAAAAAAAAAAAA0AAAAAAAAAKLUv"
        "/SANaQAA//6///3//f//+///DwAAkAEAAAAAAAAotS/9YJAAHQsAdhZSPUBNqzH8gu7ciAO+snAcxO+WfPQ2"
        "fy77lg6VeegNWTeXKT+NipE1pWFPGJVyfXSitAPRnN4N6iEnbKL/QXdAAEIAQwCUXgGlh8juGFj2A6I9g+15"
        "5gq/gLvXzPIQSg9p4Cfc+o2QwjWo8RHAyjMk688V3kBVHXKcX0jWMWR3yabjEHsJovUHe3EJsjMJ7toEpU4h"
        "WZ84jk/cahVXeALUeAqWIbCXY8jOLWr0iPc9wCzNwvsejgbcfWaWACj9RAOPIdpItKcBmy3ReqOBA2o0IgTZ"
        "WcO0ecOtzuCxYQmztIOHwxwkyxg2HfZwhc641Q9q5AvU6A5YZgjctQY1usIVWuN9nmRnC9w1iIeo8c8sE1g8"
        "bqkqjONcM8sXuPXPLC+gqp7xvkfT9gjL/EF2l3D3Fcn6RAO9Asv8QY2nTNsjV3hHA42CuxYxBQgAR8WmqTmz"
        "D9Xio6K9MXgMZ0Dzb4R5BgAAAA0AAAAAAAAAKLUv/SANaQAA/9/////++//5////DwAAZAAAAAAAAAAotS/9"
        "IGQhAwBKI9/6Lm5J/8CY27Juz/aJtfA6NRfUyMqs/XRt3J+fHzONCfrh7cFsLj0qhHmR9Ft0GV7kA5iUu97f"
        "/i/xxgPZoQ5xBVj1aKu3cf5s//qGyerPhFkskjd+aJOOB5WJ+LmUhfHPAAAAyAAAAAAAAAAotS/9IMidAgAC"
        "SBIIEPhsBh+rTAFDQT89Ozk3NTMxLy0rKSclIyEfHRsZFxUTEQ8NCwkHBQMBv/fy7urm4t7a1tLOysbCvrq2"
        "sq6qpqKempaSjooCAQCAGqBGCgAAAAANAAAAAAAAACi1L/0gDWkAAH7/ru+3f//a//b/fw8AAA0AAAAAAAAA"
        "KLUv/SANaQAA32v92d7v12f/7T/fDQAADQAAAAAAAAAotS/9IA1pAAB++1ee/d/+9/7/9v8NAACQAQAAAAAA"
        "ACi1L/1gkADVAQCQAAAAAAIAAQICAAEBAQIBAAAAEwCAAArywArwAsB5gAKwAJAHKAADEA+8AGAEXID6AApA"
        "wEu/AygCAAAAAA0AAAAAAAAAKLUv/SANaQAA/+Z3nf7b9/X/2/7/DgAAlAEAAAAAAAAotS/9YJQAnQYAxlEr"
        "LUBXYRgDRMFov8dotsowmq0yjGarDKPZKsNotsowml2mCFBQZORm8n723smWKRwAHQAgAFlUUG5yEpGD3OMc"
        "1ziGxSki7vCFI7zgAl8d9QEv4RkMPICXeqYrId2I6EIHus95rnOc25xGBuYuB3dT82Zi3streSsv5Z28kjfy"
        "Qt7H63gbL+NdVEi8h8cQr4kXxKtB4XXwIngFvFSv01t6Se/oFb2hF/R+Xs/byRkQAAkyBFmDrAtkAJkFGQQZ"
        "gPwCMgFZAHMgX5BPkBkwOmfuCQAAAD4CAAAAAAAAKLUv/WA+AXUAADhsb2ctMDAxAQA0VBUjDQAAAAAAAAAo"
        "tS/9IA1pAAD38t91Dz1v/envu/0HAACUAQAAAAAAACi1L/1glACdBAAyChcbQNtm2rvXCloNW/5eSKJF4WYF"
        "rYaNXYcin0wBf3+vnTa77LHDXne1zlqpnjrqdNNLJ41EoYP+uadzzkbzDOZyS+WUTySPHPK4o8H44orEET/c"
        "UDjhA0HggI77dhoAIH9gNDAKMgNZBuZBZiALwHyQFWQG8gNZgEyD7oB2gFGQGcgyMB/kA+aCrCCzXX4DaAMA"
        "AACbAAAAAAAAACi1L/0gmy0CACJFCIURIRF/ApK829a2SpL3UyTpB0lukwCgLbn/JMC2fdp2Uw0AN0V0XuBV"
        "6pyN6BRq1YTOC1SRW1XOSzughC11QrSdUAAAIAMAAAAAAAAotS/9YCAChQoAlBMA9BT5I4xiBADVCv+2AAUk"
        "l/YKeOwQWeIWOtgcG84i/MMo3bkuvq80n6U6gJtAYZFGQodMI31SBHNY5Whexl5kp1RqiEpwaUB2SjZ8KyyC"
        "DCKI7ReOzg2UrwOakPmfce+lUuWrM9uxFNG39ca91rzDt7LJmKjPeZ7VWpTbO4rhHIDn/XXt3mvzv2H5oFf/"
        "gU0FJWJDC0M5ESQvFwUlHeYaI8cQKagGL4n8NGryOkvoQCzeRg3UTO7JUs+/WLC1XpGrZHKhalOXcDSNdhWD"
        "fPZ4gtduiLhkjplalHpQmltGoDw8ph0yrP4nst8duMATvqEJxIL/yWP1z0Tr1SXh2wbX4efM58jC7am484qu"
        "+Wuk/0yaBSYtkAsOhhHvexfQcR2xZyOSXSlzUy9USTU1PzsWNUH3KkcmjGIEYqgQ/OwZ4NcQED8zQ1cHXR2W"
        "EykFAAAAAAAA/////wAAAAAQAAAADAAUAAYACAAMABAADAAAAAAABABkAAAAQAAAAAQAAAACAAAAOAMAAAAA"
        "AAAYAgAAAAAAAJAHAAAAAAAA4AwAAAAAAAAYAgAAAAAAAPgGAAAAAAAAAAAAAAEAAAAQAgAAAAAAAMgAAAAA"
        "AAAAYAAAAAAAAAAAAAAAEP///wQAAAAIAAAArAEAAGQBAAAoAQAA+AAAAKgAAABsAAAAQAAAAAQAAACE/v//"
        "AAABAhAAAAAgAAAABAAAAAAAAAAMAAAAdGltZXN0YW1wX25zAAAAAPj+//8AAAABQAAAALz+//8AAAEEEAAA"
        "ABgAAAAEAAAAAAAAAAQAAABibG9iAAAAAFT////k/v//AAABBRAAAAAYAAAABAAAAAAAAAAGAAAAbG9nX2lk"
        "AAB8////EAAYAAgABgAHAAwAEAAUABAAAAAAAAEFFAAAADwAAAAkAAAABAAAAAAAAAAIAAAAY2F0ZWdvcnkA"
        "AAAACAAIAAAABAAIAAAABAAAAKD///8AAAABIAAAANj///9o////AAABBhAAAAAcAAAABAAAAAAAAAAFAAAA"
        "dmFsaWQAAAAEAAQABAAAAJT///8AAAECEAAAACAAAAAEAAAAAAAAAAUAAABsYXNlcgAAAAgADAAIAAcACAAA"
        "AAAAAAEQAAAAzP///wAAAQIQAAAAIAAAAAQAAAAAAAAACQAAAGludGVuc2l0eQAGAAgABAAGAAAACAAAABAA"
        "FAAIAAYABwAMAAAAEAAQAAAAAAABAxAAAAAYAAAABAAAAAAAAAABAAAAeAAGAAgABgAGAAAAAAABAGACAABB"
        "UlJPVzE="
    ),
    19: (
        "QVJST1cxAAD/////AAIAABAAAAAAAAoADAAGAAUACAAKAAAAAAEEAAQAAAAQ////BAAAAAgAAACsAQAAZAEA"
        "ACgBAAD4AAAAqAAAAGwAAABAAAAABAAAAIT+//8AAAECEAAAACAAAAAEAAAAAAAAAAwAAAB0aW1lc3RhbXBf"
        "bnMAAAAA+P7//wAAAAFAAAAAvP7//wAAAQQQAAAAGAAAAAQAAAAAAAAABAAAAGJsb2IAAAAAVP///+T+//8A"
        "AAEFEAAAABgAAAAEAAAAAAAAAAYAAABsb2dfaWQAAHz///8QABgACAAGAAcADAAQABQAEAAAAAAAAQUUAAAA"
        "PAAAACQAAAAEAAAAAAAAAAgAAABjYXRlZ29yeQAAAAAIAAgAAAAEAAgAAAAEAAAAoP///wAAAAEgAAAA2P//"
        "/2j///8AAAEGEAAAABwAAAAEAAAAAAAAAAUAAAB2YWxpZAAAAAQABAAEAAAAlP///wAAAQIQAAAAIAAAAAQA"
        "AAAAAAAABQAAAGxhc2VyAAAACAAMAAgABwAIAAAAAAAAARAAAADM////AAABAhAAAAAgAAAABAAAAAAAAAAJ"
        "AAAAaW50ZW5zaXR5AAYACAAEAAYAAAAIAAAAEAAUAAgABgAHAAwAAAAQABAAAAAAAAEDEAAAABgAAAAEAAAA"
        "AAAAAAEAAAB4AAYACAAGAAYAAAAAAAEA/////8AAAAAUAAAAAAAAAAwAGAAGAAUACAAMAAwAAAAAAgQAGAAA"
        "AGAAAAAAAAAAAAAAAAgACAAAAAQACAAAABAAAAAMAB4AEAAEAAgADAAMAAAAYAAAACQAAAAYAAAAAwAAAAAA"
        "AAAAAAAAAAAGAAgABwAGAAAAAAAAAQMAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAhAAAAAAAAACgAAAAA"
        "AAAAMQAAAAAAAAAAAAAAAQAAAAMAAAAAAAAAAAAAAAAAAAAQAAAAAAAAACi1L/0gEIEAAAAAAAAPAAAAGQAA"
        "ACAAAAAAAAAAAAAAIAAAAAAAAAAotS/9ICABAQBSRUdVTEFSX1ZFSElDTEVQRURFU1RSSUFOQk9MTEFSRAAA"
        "AAAAAAD/////EAIAABQAAAAAAAAADAAYAAYABQAIAAwADAAAAAADBAAcAAAA+AkAAAAAAAAAAAAADAAeABAA"
        "BAAIAAwADAAAAFABAAAkAAAAGAAAAMgAAAAAAAAAAAAAAAAABgAIAAcABgAAAAAAAAESAAAAAAAAAAAAAAAq"
        "AAAAAAAAADAAAAAAAAAARAIAAAAAAAB4AgAAAAAAACMAAAAAAAAAoAIAAAAAAADZAAAAAAAAAIADAAAAAAAA"
        "AAAAAAAAAACAAwAAAAAAAGUAAAAAAAAA6AMAAAAAAAAqAAAAAAAAABgEAAAAAAAAKgAAAAAAAABIBAAAAAAA"
        "ACoAAAAAAAAAeAQAAAAAAABAAAAAAAAAALgEAAAAAAAAKgAAAAAAAADoBAAAAAAAAO4AAAAAAAAA2AUAAAAA"
        "AAAkAAAAAAAAAAAGAAAAAAAAKgAAAAAAAAAwBgAAAAAAAMAAAAAAAAAA8AYAAAAAAABuAAAAAAAAAGAHAAAA"
        "AAAAAAAAAAAAAABgBwAAAAAAAJUCAAAAAAAAAAAAAAgAAADIAAAAAAAAAA4AAAAAAAAAyAAAAAAAAAAJAAAA"
        "AAAAAMgAAAAAAAAAAAAAAAAAAADIAAAAAAAAABcAAAAAAAAAyAAAAAAAAAAaAAAAAAAAAMgAAAAAAAAAJgAA"
        "AAAAAADIAAAAAAAAADIAAAAAAAAAyAAAAAAAAAAAAAAAAAAAABkAAAAAAAAAKLUv/SAZyQAA97///763///r"
        "//v//+//+9//3///v////wAAAAAAACADAAAAAAAAKLUv/WAgApURAPQVFK7Hvylcz79xPQrAUrjev3sU7r/D"
        "9ei/PQoXwClcj7/sUbi+Ctejvtej8L+4HmXAFK5nwIXrUcB7FC7AAAAgTsBI4ZqBwK5HYcDsURjA9ih8wI/C"
        "VcAfhSvAzcxswOF6lLTApHDN0d2ousoHwUjhAsEfhQvBrkfx9MBxPcrA16Ow36y4utzunJfAXI8CwVK4zsjb"
        "x7vQoI5YSktBfcCamZmAXV56OYyNWRpgkKLAMzPDwLgexau37xTBKVwvwQAAOMGF6zHB9ihMwRSuRz/BcT0a"
        "wc3MLDMzI8GkcB3Bw/UQwQrXC8HXowADBSACGMFmZhbB4XoUIjvB7FE4UsFcj0IYA8H2KCzBj8IlJCcZwZqZ"
        "IRgzKSEICyQtexT8DAT/wBsJEPTiCOrAMzPTwI/CxciLkVUoLFQ4NXkihGouPGKoD3BxseUABMGuR/j5Cikp"
        "JA4UEsEewbgeHcHsURjBgIyoocgShCKjUpYDMIYYxsw8wD1DAIdfTT+ORdzpUN/BVKc4BA7qabbmL3n+jGRj"
        "jzg+tv9tf+DIq/Jj0JVM+Y+/X4+fw9/+6RgrVB75xCuDe96LfWNOyL0X+xN10CUHZeOP+8iaeBdu93mU2r6n"
        "0b9/tWaTNhiv85yVtHzvO7qycF/JCa/83LFHb2f3qNL030/ACSEy1zedTNt9/LV9yILxJ7yZvYusfv6PYfik"
        "tofZdyMXe/PfXL/YNt9p/zyd+vrNI8dO8sjZ1LW03gq7qAEAAAAAGQAAAAAAAAAotS/9IBmVAACSgQMH4A81"
        "5wg4J4/RWzWvAwAAAAAAAMgAAAAAAAAAKLUv/SDIQQYA1wVNw85maYU4u2DgnEii3zO8B5BuoaRA5y2cGR6Z"
        "w/6a81eotPkq0WQg2kpv8tJzrGlpbxE+vbaW7hFCURYRN3PLhiXd/xMbvJlre4EvBI6Xecho74wCsSoOAg7A"
        "UUzaL28kMkoj3/oubkn/wJjbsm7P9om18Do1F9TIyqz9dG3cn58fM40J+uHtwWwuPSqEeZH0W3QZXuQDmJS7"
        "3t/+L/HGA9mhDnEFWPVoq7dx/mz/+obJ6s+EWSySN35ok44HlYn4uZSF8c8AAAAAAAAAkAEAAAAAAAAotS/9"
        "YJAAnQIAAkgSCBD4bAYfq0wBe3l3dXNxb21raWdlY2FfXVtZV1VTUU9NS0lHRUNBPz07OTc1MzEvLSspJyUj"
        "IR8dGxkXFRMRDw0LCQcFAwG/AwEAgIaBaqQAAAAZAAAAAAAAACi1L/0gGckAAP3+ff//vf//9/v//+/37/p+"
        "+/ev/W////cAAAAAAAAZAAAAAAAAACi1L/0gGckAAC3/J05/fH33v3Oenv691p/t/X599t/+890AAAAAAAAZ"
        "AAAAAAAAACi1L/0gGckAAP/3df+/////97//++23f+XZ/+1/7/9v/98AAAAAAAAgAwAAAAAAACi1L/1gIAJ1"
        "AQCigQGBIbv/73wNAA4H1D6l4NcScjDp2Fwmc2uB8PI9pEpeafQNJ0yF350MOV6SGQAAAAAAAAAotS/9IBnJ"
        "AABff/rtf7r/8/+z9/f1b37X6b99X/+/7f/vAAAAAAAAJAMAAAAAAAAotS/9YCQC5QYANAsABw4VHCMqMTg/"
        "Rk1UW2JpcHd+hYyTmqGor7a9xMvS2eDn7vX8AwEAAAoRGB8mLTQ7QklQV15lbHN6gYiPlp2kq7K5wMfO1dzj"
        "6vH4/wYCDRQbIikwNz5FTFNaYWhvdn2Ei5KZoKeutbzDytHY3+bt9PsCAwAACRAXHiUsMzpBSE9WXWRrcnmA"
        "h46VnKOqsbi/xs3U2+Lp8Pf+BQQAAAwTGiEoLzY9REtSWWBnBAAAbgQAAICeqBD4rAHgD6CTnAN4UDJXB0Nx"
        "bdm5WEgcY8v4al2SLoPSogWuHAAAbgQAAAAAAAAotS/9YG4DlQAAQGxvZy0wMDAxAgA0QCVYqCpGAAAAABkA"
        "AAAAAAAAKLUv/SAZyQAA0tu/q63v3ZO////+di//XffQ89af/r7bfwAAAAAAACQDAAAAAAAAKLUv/WAkAnUF"
        "AAQIAAEFBggLDxASFhcZHCAhJCgqLi8xNTc7PD5BQkRHSEpOT1FUWFlbXmJjZWhsbW9ydnd5fICBg4eIio2R"
        "k5aXmZ2eoKSmqa2usLO3ubzAwcTIys3R09ba3eHi5enq7fHy9Pf7/QEBAgQHCw0QFBUYHB4hIiQnKywuMQEA"
        "ADEBAAB3qBDwB+APMYZEjZz22DNyvw5aq+F8xGCqDjLMUu7FnNJENr/1ZIcXU+dCATEBAAAAAAAAKLUv/WAx"
        "AOUCAFIGCoUhERHb8P+3lZSgbUn+wCQppS25pG03AUArSUkmyW1S/sklCYDvtiETIBAo4XIHvQNdCXhl2Aas"
        "ZdBGw0LgIhDfwHuAUQloJ2DcVR62AvjNUJ1/24XLcNgDAABABgAAAAAAACi1L/1gQAUdFAB0JgAQCaUhjGIE"
        "APH+qtL0sLPqtpTgvHXWwlbMyDfCzhi41Pmt2tqj4LuZ5pyP7H2F8l57+D9x/iBnBCIBXQriUhDDSBakPhyF"
        "NCJmKihHIC4oFjQJDDrqAUDL90Ws7UuN41Fu2VdPz10wxWMRu2nysG/TpnW0nHuVkoF2iIdXfo04dJMZapn6"
        "X5/bVaW8S6udQbF+N7dfLb1AI8MhGckCD8/jBNXE+tql8OCG5uZn3OxI0vIpyPgKvv7rswQjzKkKrZ8QjpUW"
        "b4scUIEiMXcoEm0u82I01Fg6tU5AlkRGdzpMWDBSOSZYGhxe+xFk3Adqvf1vnvN1f+l7YN+BQdWHIsuNA8GT"
        "5LaZxayfpqKlh5iraI6xSYS3Knq9C3DD7GXJzVvPrlHVj0fbcD3hUTPnMintEx/z9BT51Qr/tgAFJJf2Cnjs"
        "EFniFjrYHBvOIvzDKN25Lr6vNJ+lOoCbQGGRRkKHTCN9UgRzWOVoXsZeZKdUaohKcGlAdko2fCssggwiiO0X"
        "js4NlK8DmpD5n3HvpVLlqzPbsRTRt/XGvda8w7eyyZioz3me1VqU2zuK4RyA5/117d5r879h+aBX/4FNBSVi"
        "QwtDOREkLxcFJR3mGiPHECmoBi+J/DRq8jpL6EAs3kYN1EzuyVLPv1iwtV6Rq2RyoWpTl3A0jXYVg3z2eILX"
        "boi4ZI6ZWpR6UJpbRqA8PKYdMqz+J7LfHbjAE76hCcSC/8lj9c9E69Ul4dsG1+HnzOfIwu2puPOKrvlrpP9M"
        "mgUmLZALDoYR73sX0HEdsWcjkl0pc1MvVEk1NT87FjVB9ypHJoxiBIDGqBD87BngDxAQPzNDVwddHXh14KoD"
        "gz6lAAAA/////wAAAAAQAAAADAAUAAYACAAMABAADAAAAAAABABMAAAAKAAAAAQAAAABAAAAOAMAAAAAAAAY"
        "AgAAAAAAAPgJAAAAAAAAAAAAAAEAAAAQAgAAAAAAAMgAAAAAAAAAYAAAAAAAAAAAAAAAEP///wQAAAAIAAAA"
        "rAEAAGQBAAAoAQAA+AAAAKgAAABsAAAAQAAAAAQAAACE/v//AAABAhAAAAAgAAAABAAAAAAAAAAMAAAAdGlt"
        "ZXN0YW1wX25zAAAAAPj+//8AAAABQAAAALz+//8AAAEEEAAAABgAAAAEAAAAAAAAAAQAAABibG9iAAAAAFT/"
        "///k/v//AAABBRAAAAAYAAAABAAAAAAAAAAGAAAAbG9nX2lkAAB8////EAAYAAgABgAHAAwAEAAUABAAAAAA"
        "AAEFFAAAADwAAAAkAAAABAAAAAAAAAAIAAAAY2F0ZWdvcnkAAAAACAAIAAAABAAIAAAABAAAAKD///8AAAAB"
        "IAAAANj///9o////AAABBhAAAAAcAAAABAAAAAAAAAAFAAAAdmFsaWQAAAAEAAQABAAAAJT///8AAAECEAAA"
        "ACAAAAAEAAAAAAAAAAUAAABsYXNlcgAAAAgADAAIAAcACAAAAAAAAAEQAAAAzP///wAAAQIQAAAAIAAAAAQA"
        "AAAAAAAACQAAAGludGVuc2l0eQAGAAgABAAGAAAACAAAABAAFAAIAAYABwAMAAAAEAAQAAAAAAABAxAAAAAY"
        "AAAABAAAAAAAAAABAAAAeAAGAAgABgAGAAAAAAABAEgCAABBUlJPVzE="
    ),
}
# Each column's digest (``column_digest``) as the port reads the file here.
FEATHER_ZSTD_SUMS = {'x': '054158437561ca86', 'intensity': '01403d27cfae5db0', 'laser': '0da04764cc72d0f7', 'valid': 'd0e36b44d3204645', 'category': '6fdf4bd904a863b6', 'log_id': 'd3c63451f186760c', 'blob': '66353daac939817b', 'timestamp_ns': '143f02936dd72183'}


def column_digest(v) -> str:
    """A column's first 16 hex digits of sha256: of ``repr(list(v))`` for an
    object array, of its dtype name and bytes (NaN bits included) else."""
    import hashlib

    h = hashlib.sha256()
    if v.dtype == object:
        h.update(repr(list(v)).encode())
    else:
        h.update(str(v.dtype).encode() + v.tobytes())
    return h.hexdigest()[:16]


def dense_scene(seed=0, n_gt=250, dup_per_gt=12, n_junk=6000):
    """The JAX package's dense NMS scene (``tests/test_nms_cap.py::
    _dense_scene``, its draws in order): 250 ground-truth cars on a 10 m
    grid, 12 correlated proposals each, 6000 junk boxes scoring 0.1-0.35.
    Returns (cuboids (N, 7) fp32, scores (N,) fp32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_gt)))
    gx, gy = np.meshgrid(np.arange(side) * 10.0, np.arange(side) * 10.0)
    centers = np.stack([gx.ravel(), gy.ravel()], -1)[:n_gt] - side * 5.0
    yaw = rng.uniform(-np.pi, np.pi, n_gt)
    u = rng.uniform(0, 1, (n_gt, dup_per_gt))
    px = centers[:, 0, None] + rng.normal(0, 1, (n_gt, dup_per_gt)) * (0.1 + 0.8 * u)
    py = centers[:, 1, None] + rng.normal(0, 1, (n_gt, dup_per_gt)) * (0.1 + 0.8 * u)
    pyaw = yaw[:, None] + rng.normal(0, 0.1, (n_gt, dup_per_gt))
    pscore = np.clip(0.95 - 0.6 * u + rng.normal(0, 0.05, (n_gt, dup_per_gt)), 0.12, 0.99)
    jx = rng.uniform(centers[:, 0].min(), centers[:, 0].max(), n_junk)
    jy = rng.uniform(centers[:, 1].min(), centers[:, 1].max(), n_junk)
    jyaw = rng.uniform(-np.pi, np.pi, n_junk)
    jscore = rng.uniform(0.1, 0.35, n_junk)
    n = n_gt * dup_per_gt + n_junk
    cuboids = np.zeros((n, 7), np.float32)
    cuboids[:, 0] = np.concatenate([px.ravel(), jx])
    cuboids[:, 1] = np.concatenate([py.ravel(), jy])
    cuboids[:, 3] = 4.0
    cuboids[:, 4] = 2.0
    cuboids[:, 5] = 1.5
    cuboids[:, 6] = np.concatenate([pyaw.ravel(), jyaw])
    scores = np.concatenate([pscore.ravel(), jscore]).astype(np.float32)
    return cuboids, scores


def check_k2_b12(cap, inputs) -> tuple:
    """K2 at B=2 and on image 0 alone (B=1) against one run of its twin at
    B=2, which scans each image apart, WEIGHTED and HARD: ``keep``
    identical, ``merged`` within 1e-4. Returns max|merged diff| and the
    WEIGHTED twin's milliseconds (CUDA events, that one call)."""
    import torch

    from range_view_3d_detection_torch.kernels.nms import nms_scan, nms_scan_plain

    one = tuple(t[:1].contiguous() for t in inputs)
    worst, kept, plain_ms = 0.0, {}, {}
    for mode, merge in K2_MODES:
        kw = dict(iou_threshold=0.3, merge_threshold=merge)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        keep_p, merged_p = nms_scan_plain(*inputs, **kw)
        end.record()
        end.synchronize()
        plain_ms[mode] = start.elapsed_time(end)
        for B, args in ((2, inputs), (1, one)):
            keep, merged = nms_scan(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(keep, keep_p[:B]), f"K2 B {B} cap {cap} {mode}: keep differs "
                  f"from the twin in {int((keep != keep_p[:B]).sum())} slots")
            err = (merged - merged_p[:B]).abs().max().item()
            check(err <= 1e-4, f"K2 B {B} cap {cap} {mode}: merged max|diff| {err} > 1e-4")
            worst = max(worst, err)
            kept[(B, mode)] = int(keep.sum())
    say(f"K2 B 2 and B 1 cap {cap}: keep identical (kept {kept[(2, 'WEIGHTED')]} and "
        f"{kept[(1, 'WEIGHTED')]} WEIGHTED, {kept[(2, 'HARD')]} and {kept[(1, 'HARD')]} HARD "
        f"of {int(inputs[2].sum())} and {int(one[2].sum())} valid), merged max|diff| "
        f"{worst:.3g} ok")
    return worst, plain_ms["WEIGHTED"]


K2_BIG_KERNELS = ("nms_mask_kernel", "nms_keep_ahead_kernel", "nms_killed_at_kernel",
                  "nms_merge_kernel")
# Phase 39's check of the kernel's killed_at scratch against the mirror's.
K2_KILLED_AT_CASE = (2, 4160)


def check_k2_killed_at(inputs) -> int:
    """The kernel's ``killed_at`` scratch past cap 4096 equal to the plain
    mirror's on the same inputs, and its keep and merged to the mirror's
    (``merged`` within 1e-4). Returns how many boxes a kept row killed."""
    import torch

    from range_view_3d_detection_torch.kernels.nms import (
        nms_scan_ahead_plain,
        nms_scan_with_scratch,
    )

    kw = dict(iou_threshold=0.3, merge_threshold=0.5)
    keep, merged, killed_at = nms_scan_with_scratch(*inputs, **kw)
    keep_m, merged_m, killed_m = nms_scan_ahead_plain(*inputs, **kw)
    torch.cuda.synchronize()
    B, cap = keep.shape
    check(killed_at.shape == (B, cap), f"K2 killed_at scratch shape {tuple(killed_at.shape)}")
    check(torch.equal(killed_at, killed_m), f"K2 killed_at at cap {cap}, B {B}: "
          f"{int((killed_at != killed_m).sum())} entries differ from the mirror's")
    check(torch.equal(keep, keep_m), f"K2 at cap {cap}: keep differs from the mirror's")
    err = (merged - merged_m).abs().max().item()
    check(err <= 1e-4, f"K2 at cap {cap}: merged max|diff| {err} from the mirror's")
    return int((killed_at < cap).sum())


def k2_big_phases(device) -> dict:
    """Device microseconds of each of K2's four kernels at cap 9216, B=2
    (a case of its own generator)."""
    import torch

    from range_view_3d_detection_torch.kernels.nms import nms_scan

    case = nms_case(2, 9216, torch.Generator().manual_seed(SEED + 6), device)
    split = kernel_device_us(lambda: nms_scan(*case, iou_threshold=0.3, merge_threshold=0.5),
                             K2_BIG_KERNELS)
    del case
    torch.cuda.empty_cache()
    return split


def nms_any_cap_phase(device, smi, split=None) -> tuple:
    """Phase 39 (see the module docstring). ``split``: K2's device time by
    kernel at cap 9216 (phase 6 takes it; measured here without it).
    Returns (the launch counts of its checks, K2's cap-9216 numbers for the
    kernels line)."""
    import torch

    from range_view_3d_detection_torch.kernels.nms import nms_scan, nms_scan_plain
    from range_view_3d_detection_torch.ops.nms import batched_multiclass_nms, nms_inputs

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 39)
    reset_counts()
    worst, timed = 0.0, None
    killed = 0
    for cap in NMS_BIG_CAPS:
        case = nms_case(2, cap, gen, device)
        err, twin_ms = check_k2_b12(cap, case)
        worst = max(worst, err)
        if (2, cap) == K2_KILLED_AT_CASE:
            killed = check_k2_killed_at(case)
        if cap == 9216:
            timed, plain_ms = case, twin_ms
        del case
    # One mode at cap 16384: the twin takes seconds a call there, and
    # ``keep`` does not depend on the mode.
    worst = max(worst, check_k2("B 1 cap 16384", nms_case(1, 16384, gen, device),
                                K2_MODES[:1]))
    # Non-finite payloads on the merge's killed_at instances.
    worst = max(worst, check_k2("nonfinite_payload B 2 cap 4160",
                                nms_edge_case("nonfinite_payload", 2, 4160, gen, device),
                                K2_MODES[:1]))
    torch.cuda.empty_cache()
    cuboids, scores = dense_scene()
    cub = torch.as_tensor(cuboids, device=device)[None]
    sc = torch.as_tensor(scores, device=device)[None]
    cats = torch.zeros_like(sc, dtype=torch.int32)
    res = batched_multiclass_nms(cub, sc, cats, cap=9216)
    inputs = nms_inputs(cub, sc, cats, cap=9216)
    keep_p, _ = nms_scan_plain(inputs.iou, inputs.scores, inputs.valid, inputs.payload,
                               iou_threshold=0.3, merge_threshold=inputs.merge_threshold)
    torch.cuda.synchronize()
    check(torch.equal(res.keep, keep_p), f"dense scene at cap 9216: K2 keeps "
          f"{int(res.keep.sum())}, the plain scan {int(keep_p.sum())}")
    say(f"K2 (phase 39) the JAX dense scene ({cuboids.shape[0]} proposals, "
        f"{int((sc >= 0.1).sum())} above min_confidence) through batched_multiclass_nms at "
        f"cap 9216 ({inputs.scores.shape[1]} slots): kept {int(res.keep.sum())}, equal to the "
        f"plain scan on the same IoU matrix")
    counts = read_counts()
    kw = dict(iou_threshold=0.3, merge_threshold=0.5)
    B, cap = timed[1].shape
    ms = cuda_ms(lambda: nms_scan(*timed, **kw), reps=10)
    g_ms = graph_ms(lambda: nms_scan(*timed, **kw))
    live_per_image = nms_scan(*timed, **kw)[0].sum(-1)
    live = int(live_per_image.sum())
    flops = live * cap * 2 * (1 + 9) * 2
    nbytes = B * cap * cap * 4 + B * cap * (4 + 1 + 9 * 4) + B * cap * (1 + 9 * 4)
    bound, by = bound_ms(flops, H100_FP32_FLOPS, nbytes)
    chain = int(live_per_image.max()) * SMEM_STEP_S * 1e3
    phases = split if split is not None else kernel_device_us(
        lambda: nms_scan(*timed, **kw), K2_BIG_KERNELS)
    say(f"K2 (phase 39) cap {cap} B {B}: kernel {ms:.4f} ms eager "
        f"({100 * bound / ms:.1f}% of bound), {g_ms:.4f} ms graph replay; device us by "
        f"phase{' (phase 6)' if split is not None else ''}: "
        + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
        + f"; plain {plain_ms:.1f} ms, bound {bound:.4f} ms ({by}: the IoU matrix "
        f"{B * cap * cap * 4 / 1e6:.1f} MB), chain floor (model) {chain:.4f} ms "
        f"({int(live_per_image.max())} live steps in the longer image); caps "
        f"{', '.join(map(str, NMS_BIG_CAPS))} at B 1-2 and 16384 at B 1 (WEIGHTED) equal to "
        f"the twin (merged max|diff| {worst:.3g}); killed_at at cap {K2_KILLED_AT_CASE[1]}, "
        f"B {K2_KILLED_AT_CASE[0]} equal to the mirror's ({killed} boxes killed); "
        f"{time.perf_counter() - t0:.0f} s on {smi}")
    del timed, inputs, res
    torch.cuda.empty_cache()
    return counts, {"ms_cap_9216": ms, "graph_ms_cap_9216": g_ms,
                    "plain_ms_cap_9216": plain_ms, "bound_ms_cap_9216": bound,
                    "keep_device_us_cap_9216": phases["nms_keep_ahead_kernel"]}


def mesh_phase(dryrun_results: dict, smi) -> None:
    """Phase 40: phase 38's dry run trained its phase 3 on the JAX layout."""
    import torch

    from range_view_3d_detection_torch import dryrun

    n = torch.cuda.device_count()
    r = dryrun_results["phase3"]
    check(r["status"] == "ok" and math.isfinite(r["result"]), f"dry run phase 3: {r}")
    say(f"mesh (phase 40): dryrun_multichip({n}) phase 3 trained on the (data, model) = "
        f"{dryrun.mesh_layout(n)} mesh over NCCL (phase 38): loss {r['result']:.4f} on {smi}")


def feather_zstd_phase(smi) -> None:
    """Phase 41 (see the module docstring)."""
    import base64

    from range_view_3d_detection_torch.data import native_io
    from range_view_3d_detection_torch.utils import feather, zstd

    work = Path(tempfile.mkdtemp(prefix="chip-smoke-zstd-"))
    decode = native_io.zstd_frame_decompress
    frames = []

    def recording(data, size):
        frames.append((bytes(data), size))
        return decode(data, size)

    try:
        for level, parts in FEATHER_ZSTD.items():
            data = base64.b64decode("".join(parts))
            path = work / f"zstd{level}.feather"
            path.write_bytes(data)
            native_io.zstd_frame_decompress = recording
            try:
                cols = feather.read_feather(path)
            finally:
                native_io.zstd_frame_decompress = decode
            sums = {k: column_digest(v) for k, v in cols.items()}
            check(sums == FEATHER_ZSTD_SUMS, f"ZSTD Feather level {level}: {sums}")
            say(f"Feather (phase 41) ZSTD level {level}, {len(data)} bytes: {len(cols)} "
                f"columns of {len(next(iter(cols.values())))} rows equal to pyarrow's "
                f"(digests), nulls as NaN and None")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out_bytes = sum(size for _, size in frames)
    for data, size in frames:
        check(bytes(decode(data, size)) == zstd.zstd_frame_decompress_py(data),
              "native ZSTD differs from its twin")
    passes = 200
    t0 = time.perf_counter()
    for _ in range(passes):
        for data, size in frames:
            decode(data, size)
    native_s = (time.perf_counter() - t0) / passes
    t0 = time.perf_counter()
    for data, _ in frames:
        zstd.zstd_frame_decompress_py(data)
    twin_s = time.perf_counter() - t0
    say(f"Feather (phase 41): {len(frames)} ZSTD frames ({out_bytes} bytes out), native == "
        f"twin; native {out_bytes / native_s / 1e6:.1f} MB/s, twin "
        f"{out_bytes / twin_s / 1e6:.2f} MB/s (host CPU of {smi})")


# Phase 42's timed tools, each alone (its validate_nms runs go beside
# phase 37: ``BESIDE_COMPILE``).
HW_TOOLS = (
    ("conv_ab", ("--reps", "2")),  # of its default 5: a cut for the script's time
    ("fold_bench", ("--stage", "res3")),
    ("fold_bench", ("--stage", "res3", "--int8")),
)


def tool_json(stdout: str, tool: str) -> dict:
    """A tool's JSON line: the last that parses with ``"tool": tool``."""
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if obj.get("tool") == tool:
                return obj
    raise RuntimeError(f"chip_smoke: no {tool} JSON line in {stdout[-2000:]!r}")


def hw_tools_phase(smi, beside=()) -> dict:
    """Phase 42 (see the module docstring): ``beside``, the validate_nms
    runs made beside phase 37 (``run_cli`` records), then each timed tool
    alone. Returns the tools' launches."""
    total = {k: 0 for k in kernel_counts()}
    done = list(beside) + [run_cli(name, [f"range_view_3d_detection_torch.tools.{name}", *args])
                           for name, args in HW_TOOLS]
    for name, args, rc, stdout, stderr, wall in done:
        args = args[1:]
        check(rc == 0, f"tools.{name} {' '.join(args)} exited {rc}: {stdout[-2000:]} "
              f"{stderr[-3000:]}")
        line = tool_json(stdout, name)
        for k, v in line["launches"].items():
            total[k] += v
        check(line["device"] == smi, f"tools.{name}: device {line['device']!r}")
        for text in stdout.strip().splitlines():
            if not text.startswith("{"):
                say(f"tools.{name} (phase 42): {text}")
        say(f"tools.{name} (phase 42) {' '.join(args)}: exit 0, launches {line['launches']} "
            f"({wall:.1f} s)")
        if name == "conv_ab":
            say(f"tools.conv_ab (phase 42) JSON: {json.dumps(line)}")
    check(total["nms_scan"] > 0 and total["conv3x3_i8_fused"] > 0, f"tools launches {total}")
    return total


def slice_phases(device, smi, dryrun_results: dict, k2_split=None, hw_beside=()) -> dict:
    """Phases 39-42 (``k2_split``: phase 6's K2 split at cap 9216;
    ``hw_beside``: phase 42's runs made beside phase 37). Returns the
    launch counts of 39 and 42, and K2's cap-9216 numbers."""
    import torch

    t0 = time.perf_counter()
    anycap, k2_big = nms_any_cap_phase(device, smi, k2_split)
    mesh_phase(dryrun_results, smi)
    feather_zstd_phase(smi)
    torch.cuda.empty_cache()
    tools = hw_tools_phase(smi, hw_beside)
    say(f"phases 39-42: {time.perf_counter() - t0:.0f} s")
    return {"anycap": anycap, "hw_tools": tools, "k2_big": k2_big}


def twin_equal(tag, module, x) -> None:
    """``module(x)`` on the card equals its CPU twin's (a copy of the module
    on the CPU, whose int8 product is fp64), bit for bit."""
    import copy

    import torch

    with torch.inference_mode():
        got = module(x)
        want = copy.deepcopy(module).cpu()(x.cpu())
    torch.cuda.synchronize()
    check(got.shape == want.shape and torch.equal(got.cpu(), want),
          f"{tag}: card != CPU twin ({int((got.cpu() != want).sum())} elements differ)")
    say(f"conv shapes (phase 43) {tag}: {tuple(x.shape)} -> {tuple(got.shape)} "
        f"{got.dtype}, equal to the CPU twin bit for bit")


def general_route_checks(model, device, gen) -> None:
    """Phase 43's checks of the general int8 route on the card: small
    shapes against the CPU twin, and the width context of one rank against
    the run without it."""
    import torch

    from range_view_3d_detection_torch.models import blocks
    from range_view_3d_detection_torch.parallel import spatial

    def act(*shape):
        return torch.randn(shape, generator=gen).to(
            device, torch.bfloat16, memory_format=torch.channels_last)

    def random_int8(m, x):
        """``m`` on the card with seeded weights, quantized for ``x``."""
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        m = m.to(device).eval()
        m.quantize(float(x.float().abs().max()) / 127.0 * 0.8)
        return m

    tower = model.DetectionHead_0.cls_s1_t0.ConvNormAct_0
    check(tower.int8.route == "general", f"the (4, 4) head tower's route is "
          f"{tower.int8.route}")
    cin, cout = tower.Conv_0.in_channels, tower.Conv_0.out_channels
    twin_equal(f"(4, 4) head-tower conv {cin} -> {cout}", tower.int8, act(2, cin, 8, 64))
    x = act(2, 32, 8, 40)
    biased = random_int8(blocks.ConvNormAct(32, 48, (5, 5), use_bias=True,
                                          dtype=torch.bfloat16), x)
    twin_equal("5x5 conv with bias", biased.int8, x)
    s21 = random_int8(blocks.ConvNormAct(32, 48, (3, 3), (2, 1), dtype=torch.bfloat16), x)
    check(s21.int8.route == "general", "the height-stride-2 conv took K3")
    twin_equal("3x3 conv, height stride 2", s21.int8, x)
    twin_equal("3x3 conv, height stride 2, a 2x4 image (M = 4 < 17)", s21.int8,
               act(1, 32, 2, 4))
    deconv = random_int8(blocks.TorchConvTranspose(32, 24, (5, 8), (1, 4), (2, 2),
                                                 dtype=torch.bfloat16, use_bias=True), x)
    check(deconv.int8_taps is None, "the (5, 8) deconv took the phase route")
    twin_equal("(5, 8)/(1, 4)/(2, 2) deconv with bias", deconv, x)
    # A one-rank width context: zero halos, so the sharded forms (the
    # general route on the halo'd input) equal the served ones (K3).
    conv = next(m for m in model.modules() if isinstance(m, blocks.ConvNormAct)
                and m.int8 is not None and m.int8.route == "k3")
    agg = next(m for m in model.modules() if isinstance(m, blocks.TorchConvTranspose))
    check(agg.int8_taps is not None, "the aggregation deconv is not on K3")
    for tag, m, cin in (("3x3 ConvNormAct", conv, conv.Conv_0.in_channels),
                        ("aggregation deconv", agg, agg.in_channels)):
        xw = act(2, cin, 16, 256)
        with torch.inference_mode():
            want = m(xw)
            with spatial.width_sharding():
                got = m(xw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{tag}: the width context changed "
              f"{int((got != want).sum())} elements")
        say(f"conv shapes (phase 43) {tag} {tuple(xw.shape)} under a one-rank width "
            f"context (general int8 route): equal to the K3 run bit for bit")


def general_route_profile(tower, x, smi) -> None:
    """One (4, 4) head-tower conv on the general int8 route at the flagship
    shape: its time (CUDA events), its bound and its device time by kernel
    (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        ms = cuda_ms(lambda: tower(x), reps=5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tower(x)
            torch.cuda.synchronize()
    B, cin, H, W = x.shape
    (kh, kw), cout = tower.kernel_size, tower.cout
    ops = 2 * B * H * W * kh * kw * cin * cout
    nbytes = x.numel() * x.element_size() + kh * kw * cin * cout + 8 * cout + 4 \
        + B * H * W * cout * 2
    bound, by = bound_ms(ops, H100_INT8_OPS, nbytes)
    events = prof.key_averages()
    say(events.table(sort_by="self_device_time_total", row_limit=12))
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    say(f"conv shapes (phase 43) general int8 route, one (4, 4) tower conv "
        f"{cin} -> {cout} at {tuple(x.shape)}: {ms:.3f} ms (CUDA events; device busy "
        f"{busy:.3f} ms in the profile), bound {bound:.3f} ms ({by}, "
        f"{100 * bound / ms:.1f}%), im2col {B * H * W * kh * kw * cin / 1e9:.2f} GB "
        f"on {smi}")


def conv_shapes_phase(device, smi) -> dict:
    """Phase 43: the flagship with (4, 4) head towers in bf16 and int8, the
    general int8 route against its CPU twin and under the width context,
    and the served shapes' 62 K3 launches a request. Returns the kernels'
    launches in the (4, 4) requests."""
    import dataclasses

    import torch

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.models import blocks, quantized
    from range_view_3d_detection_torch.models.decoder import DecoderConfig

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 43)
    dec = DecoderConfig()
    requests = [serving._sample_inputs(2, 64, 1808, 5, seed=s) for s in range(4)]
    general = dict(calls=0, events=[])
    plain_general = quantized.int8_conv_nhwc

    def timed_general(*args, **kw):
        """``int8_conv_nhwc``, timed where it runs the general route (any
        shape but the unpadded 1x1 convs' single product)."""
        if tuple(args[3]) == (1, 1) and "dilation" not in kw:
            return plain_general(*args, **kw)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = plain_general(*args, **kw)
        end.record()
        general["calls"] += 1
        general["events"].append((start, end))
        return out

    def serve(predictor, tag):
        predictor(*requests[0])  # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        reset_counts()
        general.update(calls=0, events=[])
        blocks.int8_conv_nhwc = quantized.int8_conv_nhwc = timed_general
        results, times = [], []
        try:
            for r in requests:
                t = time.perf_counter()
                results.append(predictor(*r))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
        finally:
            blocks.int8_conv_nhwc = quantized.int8_conv_nhwc = plain_general
        counts = read_counts()
        kept = check_results(results)
        p50 = statistics.median(times)
        general_ms = sum(a.elapsed_time(b) for a, b in general["events"]) / len(requests)
        say(f"conv shapes (phase 43) {tag}: {len(requests)} requests, p50 {p50:.3f} ms "
            f"(min {min(times):.3f}, max {max(times):.3f}), {2e3 / p50:.2f} frames/s, "
            f"launches {counts}, general int8 route {general['calls'] // len(requests)} "
            f"calls a request, {general_ms:.3f} ms a request (CUDA events, "
            f"{100 * general_ms / p50:.1f}% of p50); kept {kept} on {smi}")
        return counts, general["calls"] // len(requests)

    # The served shapes: the flagship's int8 request keeps K3 on every conv.
    base = serving._flagship_config()
    predictor = flagship_predictor(base, dec, device, gen, requests[0])
    predictor.quantize([requests[0]], scope="full")
    launches, n_general = serve(predictor, "served flagship (3x3 towers) int8")
    k3 = launches["conv3x3_i8_fused"] / len(requests)
    check(k3 == 62 and n_general == 0, f"a served int8 request made {k3} K3 launches "
          f"and {n_general} general-route calls, not 62 and 0")
    del predictor
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(base, fpn_kernel_sizes=((1, (4, 4)),))
    predictor = flagship_predictor(cfg, dec, device, gen, requests[0])
    counts, n_general = serve(predictor, "flagship (4, 4) towers bf16")
    check(counts["meta_kernel_fused"] > 0 and counts["nms_scan"] > 0,
          f"a kernel of the bf16 path did not run: {counts}")
    check(n_general == 0 and counts["conv3x3_i8_fused"] == 0,
          f"the bf16 path ran int8 convs: {counts}, general {n_general}")
    launches = {k: launches[k] + counts[k] for k in launches}
    predictor.quantize([requests[0]], scope="full")
    counts, n_general = serve(predictor, "flagship (4, 4) towers int8")
    n_towers = sum(isinstance(m, quantized.Int8Conv) and m.route == "general"
                   for m in predictor.model.modules())
    check(n_towers == 8 and n_general == 8, f"general route: {n_towers} convs, "
          f"{n_general} calls a request (want the 8 head-tower convs)")
    per_request = counts["conv3x3_i8_fused"] / len(requests)
    check(per_request == 62 - 8 and counts["meta_kernel_fused"] > 0
          and counts["nms_scan"] > 0 and counts["meta_kernel_fused_i8"] == 0,
          f"int8 (4, 4) request launches {counts}: want K3 at 62 - 8 a request")
    launches = {k: launches[k] + counts[k] for k in launches}
    general_route_checks(predictor.model, device, gen)
    tower = predictor.model.DetectionHead_0.cls_s1_t0.ConvNormAct_0
    general_route_profile(tower.int8, torch.randn(
        (2, tower.Conv_0.in_channels, 64, 1808), generator=gen).to(
        device, torch.bfloat16, memory_format=torch.channels_last), smi)
    del predictor
    torch.cuda.empty_cache()
    say(f"phase 43: {time.perf_counter() - t0:.0f} s")
    return launches


def model_heads(predictor, request) -> dict:
    """The head outputs of ``predictor.model`` on ``request``, fp32 on the
    host."""
    import torch

    with torch.inference_mode():
        out = predictor.model(*(torch.as_tensor(a, device=predictor.device)
                                for a in request))
    return {k: v.float().cpu() for k, v in out["head"][1][0].items()}


def gate_heads(tag, got, want, form) -> str:
    """Card heads against the CPU run's at the CPU tests' tolerance for the
    dtype (``form``): fp32 allclose at atol = rtol = 1e-4 (``test_torch_
    detector.py::test_served_path_tiny``), bf16 max|diff| <= 2^-5 max|ref|
    and relative RMS <= 2^-6 (``test_served_path_tiny_bf16``), int8
    relative RMS <= 1e-3 (``test_torch_quantized.py``), flagship widths
    in fp32 max|diff| <= 1e-3 max|ref| (``test_served_path_flagship_widths``).
    Returns the printed comparison."""
    import torch

    parts = []
    for key, ref in want.items():
        have = got[key]
        err = (have - ref).abs().max().item()
        top = ref.abs().max().item()
        rms = rel_rms(have, ref)
        if form == "fp32":
            ok = torch.allclose(have, ref, atol=1e-4, rtol=1e-4)
        elif form == "bf16":
            ok = err <= 2.0**-5 * top and rms <= 2.0**-6
        elif form == "int8":
            ok = rms <= 1e-3
        else:
            ok = err <= 1e-3 * top
        check(ok, f"{tag} {key}: max|diff| {err} (max|ref| {top}), relative RMS {rms}")
        parts.append(f"{key} max|diff| {err:.3g} (max|ref| {top:.3g}), rel RMS {rms:.3g}")
    return "; ".join(parts)


def tiny_card_vs_cpu(device, smi) -> tuple:
    """Phase 44's tiny config (widths 8) served on the card in fp32 (K1
    stem), bf16 (K1 stem) and int8 (K4 stem, quantized from the fp32
    model: K4's output-tiled kernel in fp32), each against the same model
    on the CPU. Returns the launches of each card request and the card's
    ms for the int8 request (median of 5, host clock after a synchronize),
    the one the kernels line's K4 fp32 entry counts."""
    import dataclasses

    import torch

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.models.decoder import DecoderConfig
    from range_view_3d_detection_torch.models.quantized import fold_batch_norms

    dec = DecoderConfig()
    request = serving._sample_inputs(2, 16, 256, 5, seed=44)
    tiny = dataclasses.replace(serving._flagship_config(tiny=True), stem_pallas=True)
    launches = {}
    wall = []

    def pair(cfg):
        cpu = flagship_predictor(cfg, dec, "cpu", torch.Generator().manual_seed(SEED + 44),
                                 request)
        card = serving.Predictor(cfg, dec, device=device)
        card.model.load_state_dict(cpu.model.state_dict())
        return cpu, card

    def serve(tag, cpu, card, form):
        reset_counts()
        result = card(*request)
        torch.cuda.synchronize()
        launches[tag] = read_counts()
        kept = check_results([result])
        text = gate_heads(f"tiny {tag}", model_heads(card, request),
                          model_heads(cpu, request), form)
        timed = ""
        if tag == "int8":
            times = []
            for _ in range(5):
                t1 = time.perf_counter()
                card(*request)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            wall.append(statistics.median(times))
            timed = f", {wall[0]:.3f} ms a request"
        say(f"tiny config {tag} (widths {card.cfg.layers}, B=2 16x256): launches "
            f"{launches[tag]}, kept {kept}{timed} on {smi}; heads against the CPU run: "
            f"{text}")
        return launches[tag]

    cpu32, card32 = pair(tiny)
    n = serve("fp32", cpu32, card32, "fp32")
    check(n["meta_kernel_fused"] > 0 and n["nms_scan"] > 0, f"tiny fp32 launches {n}")
    cpu16, card16 = pair(dataclasses.replace(tiny, dtype="bfloat16"))
    n = serve("bf16", cpu16, card16, "bf16")
    check(n["meta_kernel_fused"] > 0 and n["nms_scan"] > 0, f"tiny bf16 launches {n}")
    # int8: both fold the same fp32 weights (folded once, on the CPU), the
    # card takes the CPU's calibrated scales.
    fold_batch_norms(cpu32.model)
    cpu32.bn_folded = card32.bn_folded = True
    card32.model.load_state_dict(cpu32.model.state_dict())
    cpu32.quantize([request], stem_int8=True)
    card32.quantize(quant_tree=cpu32.quant_tree, stem_int8=True)
    n = serve("int8", cpu32, card32, "int8")
    check(n["meta_kernel_fused_i8"] > 0 and n["conv3x3_i8_fused"] > 0 and n["nms_scan"] > 0
          and n["meta_kernel_fused"] == 0, f"tiny int8 launches {n}")
    return launches, wall[0]


def kernel_shapes_phase(device, smi) -> list:
    """Phase 44: what the kernels take past the configs' shapes, on the main
    paths (see the module docstring). Returns K1 fp32's and K4 fp32's
    entries of the kernels line."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.kernels import _build
    from range_view_3d_detection_torch.kernels.conv import conv3x3_i8_fused, k3_plan
    from range_view_3d_detection_torch.kernels.stem import (
        StemPlan,
        k1_operands,
        k1_plan,
        k4_plan,
        meta_kernel_fused,
        meta_kernel_fused_i8,
        meta_kernel_fused_i8_plain,
        meta_kernel_fused_plain,
        padded_operands,
    )
    from range_view_3d_detection_torch.models.decoder import DecoderConfig

    t0 = time.perf_counter()
    laps = Laps()
    tiny_launches, tiny_ms = tiny_card_vs_cpu(device, smi)
    laps("tiny requests")

    # One fp32 rv-av2 request with the K1 stem at B=2 64x1808; the same
    # model at a small size against its CPU run.
    cfg = dataclasses.replace(serving._flagship_config(), dtype="float32")
    dec = DecoderConfig()
    request = serving._sample_inputs(2, 64, 1808, 5, seed=0)
    predictor = flagship_predictor(cfg, dec, device, torch.Generator().manual_seed(SEED + 45),
                                   request)
    predictor(*request)  # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    reset_counts()
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        result = predictor(*request)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    counts = read_counts()
    kept = check_results([result])
    check(counts["meta_kernel_fused"] == 3 and counts["nms_scan"] == 3,
          f"fp32 flagship launches {counts}")
    small = serving._sample_inputs(1, 8, 256, 5, seed=1)
    cpu = serving.Predictor(cfg, dec, device="cpu")
    cpu.model.load_state_dict(predictor.model.state_dict())
    text = gate_heads("fp32 flagship widths 8x256", model_heads(predictor, small),
                      model_heads(cpu, small), "flagship")
    del cpu
    say(f"fp32 rv-av2 (K1 stem, {k1_plan(256, torch.float32).kernel}) B=2 64x1808: "
        f"{statistics.median(walls):.2f} ms a request (median of 3, host clock), launches "
        f"{counts}, kept {kept}; at B=1 8x256 the card against the CPU: {text} on {smi}")
    del predictor, result
    torch.cuda.empty_cache()
    laps("fp32 rv-av2 request")

    # K1 in fp32 at the flagship stem: the kernels line's entry.
    gen = torch.Generator().manual_seed(SEED + 46)
    x32 = stem_inputs(2, 64, 1808, 256, gen, device, dtype=torch.float32)
    got = meta_kernel_fused(**x32)
    want = meta_kernel_fused_plain(**x32)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    check(err <= K1_FP32_TOL * ref, f"K1 fp32 flagship: max|diff| {err} > {K1_FP32_TOL} * {ref}")
    del got, want
    ms = cuda_ms(lambda: meta_kernel_fused(**x32), reps=5, warmup=1)
    g_ms = graph_ms(lambda: meta_kernel_fused(**x32), calls=3)
    plain_ms = cuda_ms(lambda: meta_kernel_fused_plain(**x32), reps=2, warmup=1)
    plan = k1_plan(256, torch.float32)
    ops_ms = cuda_ms(lambda: k1_operands(plan, **x32), reps=5)
    flops, nbytes = k1_cost(2, 64, 1808, 256, elem=4)
    bound, by = k1_fp32_bound(flops, nbytes)
    ffma, _ = bound_ms(flops, H100_FP32_FLOPS, nbytes)
    say(f"K1 fp32 (2, 64, 1808, 256) ({plan.kernel}): max|diff| {err:.4g} (max|ref| "
        f"{ref:.4g}); kernel {ms:.4f} ms eager ({100 * bound / ms:.1f}% of its 3xTF32 bound), "
        f"{g_ms:.4f} ms graph replay, of the eager call the wrapper's operands (the weights "
        f"gathered into the kernel's k order and split into TF32 hi and lo) {ops_ms:.4f} ms; "
        f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}: 3 x {flops / 1e9:.1f} GFLOP at "
        f"{H100_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32); the earlier CUDA-core limit (the same "
        f"work as FFMA at {H100_FP32_FLOPS / 1e12:.0f} TFLOP/s fp32) {ffma:.4f} ms on {smi}")
    del x32
    laps("K1 fp32 flagship")

    # The register-A kernel's bf16 instance at the flagship stem, launched
    # through its entry point directly (k1_plan sends bf16 at C <= 256 to
    # the wgmma instance), beside the wgmma instance on the same inputs.
    xb = stem_inputs(2, 64, 1808, 256, gen, device)
    lib = _build.library()
    rs_plan = StemPlan("wgmma_tiled", 0)

    def k1_rs_bf16():
        ops = k1_operands(rs_plan, **xb)
        out = torch.empty(xb["g"].shape, dtype=torch.float32, device=device)
        ptrs = (*(0 if t is None else t.data_ptr() for t in ops), out.data_ptr())
        err = lib.rv3d_meta_kernel_fused_rs(*ptrs, 2, 64, 1808, 256, 0,
                                            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "rv3d_meta_kernel_fused_rs")
        return out

    want = meta_kernel_fused_plain(**xb)
    rs_err = (k1_rs_bf16() - want).abs().max().item()
    ref = want.abs().max().item()
    check(rs_err <= 2e-2 * ref, f"K1 register-A bf16 flagship: max|diff| {rs_err} > 2e-2 * {ref}")
    del want
    rows = {}
    for name, fn in (("wgmma (shipped)", lambda: meta_kernel_fused(**xb)),
                     ("register-A", k1_rs_bf16)):
        rows[name] = (cuda_ms(fn, reps=10), graph_ms(fn))
    say("K1 bf16 (2, 64, 1808, 256), the two tensor-core kernels on the same inputs: "
        + "; ".join(f"{k} {e:.4f} ms eager, {g:.4f} ms graph replay"
                    for k, (e, g) in rows.items())
        + f"; register-A max|diff| {rs_err:.4g} (max|ref| {ref:.4g}) on {smi}")
    del xb
    laps("K1 register-A bf16")
    entry = {
        "name": "meta_kernel_fused_fp32", "route": "cuda",
        "source": "range_view_3d_detection_torch/csrc/meta_kernel_fused.cu",
        "replaces": "range_view_3d_detection_tpu/kernels/stem_pallas.py:269",
        "launches": counts["meta_kernel_fused"], "max_abs_err": err,
        "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": by, "library_ms": None,
    }

    # K4 with fp32 g at the flagship stem, the shape an int8 model quantized
    # from fp32 gives it (the output-tiled kernel's one-tile form): the
    # kernels line's entry, its launches those of the tiny int8 request
    # quantized from fp32 above (the path this form serves).
    x = k4_inputs(2, 64, 1808, 256, gen, device, dtype=torch.float32)
    got, want = meta_kernel_fused_i8(**x), meta_kernel_fused_i8_plain(**x)
    torch.cuda.synchronize()
    err, ref = (got - want).abs().max().item(), want.abs().max().item()
    n_diff = int((got != want).sum())
    check(err <= 1e-4 * ref, f"K4 fp32 flagship: max|diff| {err} > 1e-4 * {ref}")
    check(n_diff == 0, f"K4 fp32 flagship: {n_diff} elements differ from the twin")
    del got, want
    k4 = cuda_ms(lambda: meta_kernel_fused_i8(**x), reps=10)
    k4_graph = graph_ms(lambda: meta_kernel_fused_i8(**x))
    k4_plain = cuda_ms(lambda: meta_kernel_fused_i8_plain(**x), reps=2, warmup=1)
    b4 = bound_ms(*k4_cost(2, 64, 1808, 256, elem=4))
    say(f"K4 fp32 (2, 64, 1808, 256) ({k4_plan(256, torch.float32).kernel}): max|diff| "
        f"{err:.4g} (max|ref| {ref:.4g}), {n_diff} of {x['g'].numel()} elements differ; "
        f"kernel {k4:.4f} ms eager ({100 * b4[0] / k4:.1f}% of its int8 tensor-core bound), "
        f"{k4_graph:.4f} ms graph replay ({100 * b4[0] / k4_graph:.1f}%), plain "
        f"{k4_plain:.3f} ms, bound {b4[0]:.4f} ms ({b4[1]}); the tiny int8 request "
        f"quantized from fp32 (its K4 launches: {tiny_launches['int8']['meta_kernel_fused_i8']}) "
        f"{tiny_ms:.3f} ms on {smi}")
    del x
    laps("K4 fp32 flagship")
    k4_entry = {
        "name": "meta_kernel_fused_i8_fp32", "route": "cuda",
        "source": "range_view_3d_detection_torch/csrc/meta_kernel_fused_i8.cu",
        "replaces": "range_view_3d_detection_tpu/kernels/stem_pallas.py:176",
        "launches": tiny_launches["int8"]["meta_kernel_fused_i8"], "max_abs_err": err,
        "ms": k4, "graph_ms": k4_graph, "plain_ms": k4_plain, "bound_ms": b4[0],
        "bound_by": b4[1], "library_ms": None,
    }

    # K1 and K4 at C = 36, 48, 288 and 512, bf16 and fp32, against their
    # twins (K4 with no element differing), each timed beside its twin
    # (bound at the dtype's peak, K1 fp32's as 3xTF32 with its FFMA bound
    # beside it; past C = 256 the kernels repeat the W1 product for each
    # 256-wide output tile, 1.5x the operations at C = 512, and the bound
    # counts the function's; K4's is also given at the kernel's own count),
    # K4 also by graph replay. At C = 36 in bf16 the wrappers pad C (K1 to
    # 40, K4 to 48) with one copy of the inputs and the output's crop, timed
    # on their own.
    for C, shape in ((36, (2, 64, 1808)), (48, (2, 64, 1808)), (288, (1, 64, 1808)),
                     (512, (1, 64, 1808))):
        for dt in (torch.bfloat16, torch.float32):
            elem = 2 if dt == torch.bfloat16 else 4
            flops, nbytes = k1_cost(*shape, C, elem=elem)
            if dt == torch.bfloat16:
                k1_bound = bound_ms(flops, H100_BF16_FLOPS, nbytes)
            else:
                k1_bound = k1_fp32_bound(flops, nbytes)
            text = []
            for name, make, fn, plain, plan, cost, tol in (
                ("K1", stem_inputs, meta_kernel_fused, meta_kernel_fused_plain,
                 k1_plan(C, dt), k1_bound,
                 2e-2 if dt == torch.bfloat16 else K1_FP32_TOL),
                ("K4", k4_inputs, meta_kernel_fused_i8, meta_kernel_fused_i8_plain,
                 k4_plan(C, dt), bound_ms(*k4_cost(*shape, C, elem=elem)), 1e-4),
            ):
                x = make(*shape, C, gen, device, dtype=dt)
                got, want = fn(**x), plain(**x)
                torch.cuda.synchronize()
                err, ref = (got - want).abs().max().item(), want.abs().max().item()
                n_diff = int((got != want).sum())
                check(err <= tol * ref, f"{name} {dt} {shape + (C,)}: max|diff| {err} > "
                      f"{tol} * {ref}")
                check(name == "K1" or n_diff == 0,
                      f"K4 {dt} {shape + (C,)}: {n_diff} elements differ from the twin")
                del got, want
                ms = cuda_ms(lambda: fn(**x), reps=3, warmup=1)
                plain_ms = cuda_ms(lambda: plain(**x), reps=2, warmup=1)
                part = (f"{name} ({plan.kernel}) {ms:.4f} ms eager, plain {plain_ms:.3f} ms, "
                        f"bound {cost[0]:.4f} ms ({cost[1]}), max|diff| {err:.4g} (max|ref| "
                        f"{ref:.4g}, {n_diff} elements differ)")
                if name == "K4":
                    tiles = -(-C // 256)
                    part += (f", {graph_ms(lambda: fn(**x), calls=3):.4f} ms graph replay, "
                             f"{100 * cost[0] / ms:.1f}% of its bound eager"
                             + (f"; the kernel's own work (W1 repeated for each of {tiles} "
                                f"output tiles, {(tiles + 1) / 2:.2f}x) "
                                f"{cost[0] * (tiles + 1) / 2:.4f} ms" if C > 256 else ""))
                if name == "K1" and dt == torch.float32:
                    part += (f", the earlier CUDA-core limit (FFMA) "
                             f"{bound_ms(flops, H100_FP32_FLOPS, nbytes)[0]:.4f} ms")
                if plan.pad:
                    out = torch.empty(shape + (C + plan.pad,), device=device)
                    copy_ms = cuda_ms(lambda: (padded_operands(plan.pad, *x.values()),
                                               out[..., :C].contiguous()), reps=5)
                    part += f", of it the wrapper's pad (+{plan.pad}) copies {copy_ms:.4f} ms"
                    del out
                text.append(part)
                del x
            say(f"stems at {shape + (C,)} {dt}: " + "; ".join(text) + f" on {smi}")
        laps(f"stems at C = {C}")

    # K3 at a tail shape: Cin 48 (padded to 64 by one copy of x) -> Cout 40.
    key = (48, 40, 1808, 1)
    x = torch.randn((2, 64, 1808, 48), generator=gen).to(device, torch.bfloat16)
    w = torch.randint(-127, 128, (9, 48, 40), generator=gen, dtype=torch.int8).to(device)
    dq = (torch.rand(40, generator=gen) * 1e-3 + 1e-4).to(device)
    s_in = torch.tensor(0.0173, device=device)
    k3_equal(x, w, dq, 1, "(2, 64, 1808, 48)->40 stride 1", in_scale=s_in)
    kw = dict(stride_w=1, out_dtype=torch.bfloat16, in_scale=s_in)
    k3 = cuda_ms(lambda: conv3x3_i8_fused(x, w, dq, **kw), reps=10)
    k3_graph = graph_ms(lambda: conv3x3_i8_fused(x, w, dq, **kw))
    pad = k3_plan(48, 40, 1, torch.bfloat16, True).cin_pad
    pad_ms = cuda_ms(lambda: F.pad(x, (0, pad)), reps=10)
    ops, nbytes = k3_shape_cost(key, 2, 64, 2, 2)
    b3 = bound_ms(ops, H100_INT8_OPS, nbytes)
    say(f"K3 tail shape (2, 64, 1808, 48)->40 stride 1, bf16 + in_scale: {k3:.4f} ms eager "
        f"({100 * b3[0] / k3:.1f}% of bound), {k3_graph:.4f} ms graph replay, of it the "
        f"wrapper's Cin pad copy (+{pad} channels) {pad_ms:.4f} ms; bound {b3[0]:.4f} ms "
        f"({b3[1]}) on {smi}")
    laps("K3 tail shape")
    say(f"phase 44: {time.perf_counter() - t0:.0f} s ({laps})")
    return [entry, k4_entry]


def experiment_configs(name: str, x_stride: int, padding_mode: str = "constant") -> tuple:
    """The experiment ``name`` as the port builds it from
    ``conf/experiment/NAME.yaml`` (``compose``, then
    ``build_detector_config``, ``build_decoder_config`` and the val split's
    ``build_dataset_config``): ``(cfg, dec, layout)``, after checking that
    the val split strides columns by ``x_stride`` and pads with
    ``padding_mode``. ``layout`` is what the range image and the points
    front end take: the height, the sensor's width, the pad a side
    (``width_padding``) and the served width (the padded width over
    ``x_stride``), the feature names, the dataset's name, ``x_stride`` and
    ``padding_mode``."""
    from range_view_3d_detection_torch.data.dataset import width_padding
    from range_view_3d_detection_torch.training.builders import (
        build_dataset_config,
        build_decoder_config,
        build_detector_config,
    )
    from range_view_3d_detection_torch.utils.config import compose

    raw = compose(REPO / "conf", name)
    ds = build_dataset_config(raw, "val")
    rv = ds.range_view
    check(ds.x_stride == x_stride and ds.padding_mode == padding_mode,
          f"{name}'s layout: x_stride {ds.x_stride}, {ds.padding_mode} padding")
    pad = width_padding(rv.width, ds.x_stride)
    layout = dict(height=rv.height, sensor_width=rv.width, pad=pad,
                  width=(rv.width + 2 * pad) // ds.x_stride,
                  feature_names=rv.feature_column_names, dataset_name=ds.dataset_name,
                  x_stride=ds.x_stride, padding_mode=ds.padding_mode)
    return build_detector_config(raw), build_decoder_config(raw), layout


def train_padding(name: str) -> str:
    """The padding mode of the experiment ``name``'s train split (its val
    split's is ``experiment_configs``' check): rv-nuscenes pads its train
    sweeps circularly and its val sweeps with constants, as
    ``conf/model/range_view.yaml`` sets ``padding_mode`` on
    ``_train_dataset`` alone and ``conf/dataset/nuscenes.yaml`` sets none."""
    from range_view_3d_detection_torch.training.builders import build_dataset_config
    from range_view_3d_detection_torch.utils.config import compose

    return build_dataset_config(compose(REPO / "conf", name), "train").padding_mode


def padded_request(B, H, sensor_width, C, seed, x_stride=1, padding_mode="constant"):
    """``serving._sample_inputs`` at the sensor's width, padded a side by
    ``width_padding`` as the dataset's ``padding_mode`` pads a sweep
    (constant: zero features and points, no returns; circular: the far
    columns), then every ``x_stride``-th column, as the dataset keeps
    them."""
    import numpy as np

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.data.dataset import width_padding

    pad = width_padding(sensor_width, x_stride)
    spec = ((0, 0), (0, 0), (pad, pad))
    mode = "wrap" if padding_mode == "circular" else "constant"
    feats, cart, mask = serving._sample_inputs(B, H, sensor_width, C, seed=seed)
    padded = (np.pad(a, spec + ((0, 0),) * (a.ndim - 3), mode=mode) for a in (feats, cart, mask))
    return tuple(np.ascontiguousarray(a[:, :, ::x_stride]) for a in padded)


def points_front_end(predictor, layout):
    """The raw-points front end in front of ``predictor`` with ``layout``'s
    sensor (``export.make_points_predict``): ``(points_predict, extra)``."""
    from range_view_3d_detection_torch.export import make_points_predict

    return make_points_predict(
        predictor, sensor_width=layout["sensor_width"], height=layout["height"],
        feature_names=layout["feature_names"], dataset_name=layout["dataset_name"],
        x_stride=layout["x_stride"], padding_mode=layout["padding_mode"])


def sensor_points(B, n, layout, extra, seed):
    """B synthetic clouds of ``n`` points (``export._sample_points``) at
    ``layout``'s height and sensor width, with one channel per name of
    ``extra``, in its order: intensity in [0, 1) (AV2's, as the bench's
    points mode draws it), in [0, 3) for Waymo (raw Waymo intensity,
    which the projection's tanh plane takes) or in [0, 255) for nuScenes
    (the raw ``.pcd.bin`` value, which the converter and the projection
    keep as is), elongation in [0, 2). The lasers are the rows of
    ``layout``'s sensor: 32 for nuScenes."""
    import numpy as np

    from range_view_3d_detection_torch.export import _sample_points

    xyz, laser, intensity = _sample_points(B, n, layout["height"], layout["sensor_width"],
                                           seed=seed)
    scale = INTENSITY_SCALE.get(layout["dataset_name"], 1)
    chans = {"intensity": intensity * scale,
             "elongation": np.random.default_rng(seed + 1).uniform(0, 2, laser.shape)
             .astype(np.float32)}
    return (xyz, laser, *(chans[name] for name in extra))


# The kernels each mode of phases 45 and 46 must launch (> 0) and not
# (== 0), by stem: with the MetaKernel the bench's (``BENCH_EXPECT``); the
# BASIC stem launches neither stem kernel. The bench's points mode is
# int8; the served points go through the bf16 predictor.
BASIC_BENCH_EXPECT = {
    "bf16": ({"nms_scan"}, {"meta_kernel_fused", "conv3x3_i8_fused", "meta_kernel_fused_i8"}),
    "int8": ({"nms_scan", "conv3x3_i8_fused"}, {"meta_kernel_fused", "meta_kernel_fused_i8"}),
    "points": ({"nms_scan", "conv3x3_i8_fused"}, {"meta_kernel_fused", "meta_kernel_fused_i8"}),
}
CONFIG_BENCH_EXPECT = {"META": BENCH_EXPECT, "BASIC": BASIC_BENCH_EXPECT}
CONFIG_EXPECT = {stem: dict(modes, points=modes["bf16"])
                 for stem, modes in CONFIG_BENCH_EXPECT.items()}
# The points front end's channels by dataset, and the scale of its raw
# intensity over the bench's [0, 1) (``sensor_points``).
POINTS_EXTRA = {"waymo": ["elongation", "intensity"], "av2": ["intensity"],
                "nuscenes": ["intensity"]}
INTENSITY_SCALE = {"waymo": 3, "nuscenes": 255}
# Phases 45-47's bench loop (``bench.measure``) on half the bench's
# requests, its ``ITERS`` and ``LATENCY_ITERS`` set so for the call
# (``bench_cut``): a cut for the script's time (PERF.md section 4).
CONFIG_BENCH_ITERS = dict(ITERS=12, LATENCY_ITERS=25)


@contextlib.contextmanager
def bench_cut():
    """``bench``'s request counts set to ``CONFIG_BENCH_ITERS`` inside the
    block, and restored after it."""
    from range_view_3d_detection_torch import bench

    saved = {k: getattr(bench, k) for k in CONFIG_BENCH_ITERS}
    for k, v in CONFIG_BENCH_ITERS.items():
        setattr(bench, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(bench, k, v)

# The published configurations phases 45-47 run: name -> (phase, x_stride,
# the small request's sensor width, padded and strided to 256 served
# columns, seed, train batch). rv-waymo trains at B=2 (phase 45 as it
# was), the others at their batch_size, 4.
PUBLISHED_CONFIGS = {
    "rv-waymo": (45, 1, 250, 45, 2),
    "base-av2": (46, 1, 250, 46, 4),
    "rv-av2-fast": (46, 4, 1000, 48, 4),
    "rv-nuscenes": (47, 1, 248, 47, 4),
    "base-waymo": (47, 1, 250, 49, 4),
}


def config_phase(name, phase, device, smi, *, x_stride, small_sensor, seed,
                 train_batch) -> dict:
    """The experiment ``name`` at its published width (phases 45-47; see
    the module docstring), built by ``experiment_configs`` with seeded
    weights (``SEED + seed``), requests of B=2 at the sensor's width,
    padded and strided as the val split does (``padded_request``); the
    card against the CPU on a 1 x 8 request of ``small_sensor`` columns;
    the train steps at B = ``train_batch`` on a batch padded as the train
    split pads (``train_padding``). Returns each mode's launches."""
    import dataclasses

    import torch

    from range_view_3d_detection_torch import bench, serving
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.kernels.stem import (
        meta_kernel_fused,
        meta_kernel_fused_i8,
        meta_kernel_fused_i8_plain,
        meta_kernel_fused_plain,
    )
    from range_view_3d_detection_torch.models import stems
    from range_view_3d_detection_torch.models.decoder import decode
    from range_view_3d_detection_torch.models.quantized import Int8Conv
    from range_view_3d_detection_torch.ops import nms as nms_ops
    from range_view_3d_detection_torch.tools import profile_trace
    from range_view_3d_detection_torch.training import optim, state as state_lib

    t0 = time.perf_counter()
    laps = Laps()
    cfg, dec, layout = experiment_configs(name, x_stride)
    meta = cfg.stem_type == "META"
    expect, bench_expect = CONFIG_EXPECT[cfg.stem_type], CONFIG_BENCH_EXPECT[cfg.stem_type]
    B, H, W, C = 2, layout["height"], layout["width"], cfg.in_channels
    strided = dict(x_stride=layout["x_stride"], padding_mode=layout["padding_mode"])
    requests = [padded_request(B, H, layout["sensor_width"], C, seed=s, **strided)
                for s in range(4)]
    check(requests[0][0].shape == (B, H, W, C), f"{name} request {requests[0][0].shape}")
    padded = layout["sensor_width"] + 2 * layout["pad"]
    every = f", every {x_stride}th column: {H}x{W}" if x_stride > 1 else ""
    say(f"{name} (phase {phase}): {cfg.stem_type} stem, layers {cfg.layers}, stages "
        f"{cfg.stage_blocks}, FPN {cfg.fpn}, towers {cfg.classification_head_channels}/"
        f"{cfg.regression_head_channels} x {cfg.num_classification_blocks}, "
        f"{len(cfg.tasks_dict[0])} classes, {C} channels {layout['feature_names']}, "
        f"{cfg.dtype}, nms_cap {dec.nms_cap}; requests B={B} {H}x{layout['sensor_width']} "
        f"padded ({layout['padding_mode']}) to {H}x{padded}{every}")
    launches = {}

    def serve(tag, predict, model, inputs, nms_request):
        """4 requests: the mode's kernels launch and no other, K2 once a
        request, finite detections kept in every image, the NMS on
        ``nms_request`` equal to the plain scan."""
        reset_counts()
        t1 = time.perf_counter()
        results = [predict(*r) for r in inputs]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / len(inputs)
        counts = launches[tag] = read_counts()
        need, never = expect[tag]
        check(all(counts[k] > 0 for k in need) and all(counts[k] == 0 for k in never)
              and counts["nms_scan"] == len(inputs), f"{name} {tag}: launches {counts}")
        check_results(results)
        per_image = [r.keep.sum(-1).tolist() for r in results]
        check(min(min(n) for n in per_image) > 0, f"{name} {tag}: an image kept nothing: "
              f"{per_image}")
        nms_err = check_nms_against_plain(model, nms_request, cfg, dec, device)
        say(f"{name} {tag}: {len(inputs)} requests, launches {counts}, kept {per_image}, NMS == "
            f"plain scan (cuboids max|diff| {nms_err:.3g}); {ms:.3f} ms a request (host "
            f"clock, first calls) on {smi}")
        return results

    # bf16: the served config, seeded weights (flagship_predictor's).
    predictor = flagship_predictor(cfg, dec, device, torch.Generator().manual_seed(SEED + seed),
                                   requests[0])
    model = predictor.model
    predictor(*requests[0])  # warm-up (cuDNN plans)
    serve("bf16", predictor, model, requests, requests[0])
    laps("bf16 requests")

    # The card against the CPU on the same weights at B=1 8x256, full
    # widths and depth, fp32 and bf16.
    small = padded_request(1, 8, small_sensor, C, seed=45, **strided)
    texts = []
    for dtype, form in (("float32", "flagship"), ("bfloat16", "bf16")):
        c = dataclasses.replace(cfg, dtype=dtype)
        cpu = serving.Predictor(c, dec, device="cpu")
        cpu.model.load_state_dict(model.state_dict())
        card = predictor
        if dtype != cfg.dtype:
            card = serving.Predictor(c, dec, device=device)
            card.model.load_state_dict(model.state_dict())
        text = gate_heads(f"{name} {dtype} 1x8x{small[0].shape[2]}", model_heads(card, small),
                          model_heads(cpu, small), form)
        texts.append(f"{dtype}: {text}")
        del cpu, card
    say(f"{name} heads, the card against the CPU at B=1 8x{small[0].shape[2]} "
        f"({small_sensor} columns padded{' and strided' if x_stride > 1 else ''}): "
        f"{'; '.join(texts)}")
    laps("card against CPU")

    # Where a request's time goes (tools.profile_trace's trace of one
    # request beside its untraced wall), and K1 and K2 on the request's
    # own inputs.
    tensors = [torch.as_tensor(a, device=device) for a in requests[0]]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(*tensors), reps=5)
        out = model(*tensors)
        dec_ms = cuda_ms(lambda: decode(out, dec, cfg.tasks_dict, use_nms=True), reps=5)
    del out
    trace_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-trace-"))
    try:
        profile_trace.trace(lambda: predictor(*requests[1]), trace_dir, device)
        traced = profile_trace.summarize(trace_dir, top=20)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    wall = statistics.median(cuda_sync_wall(lambda: predictor(*requests[1])) for _ in range(3))
    say(f"{name} bf16 request traced (tools.profile_trace): device time "
        f"{traced['total_ms']:.3f} ms over {traced['events']} events; untraced wall "
        f"{wall:.3f} ms (host clock, median of 3), device busy "
        f"{100 * traced['total_ms'] / wall:.1f}% on {smi}")
    seen = {}

    def capture_k1(*args):
        seen.setdefault("K1", tuple(a.clone() for a in args))
        return meta_kernel_fused(*args)

    def capture_k2(*args, **kw):
        seen.setdefault("K2", (tuple(a.clone() for a in args), kw))
        return nms_scan(*args, **kw)

    stems.meta_kernel_fused, nms_ops.nms_scan = capture_k1, capture_k2
    try:
        predictor(*requests[0])
    finally:
        stems.meta_kernel_fused, nms_ops.nms_scan = meta_kernel_fused, nms_scan
    k2_args, k2_kw = seen["K2"]
    if meta:
        k1_args = seen["K1"]
        got, want = meta_kernel_fused(*k1_args), meta_kernel_fused_plain(*k1_args)
        torch.cuda.synchronize()
        k1_err, k1_ref = (got - want).abs().max().item(), want.abs().max().item()
        check(k1_err <= 2e-2 * k1_ref, f"{name} K1: max|diff| {k1_err} > 2e-2 * {k1_ref}")
        del got, want
        k1_ms = cuda_ms(lambda: meta_kernel_fused(*k1_args), reps=10)
        k1_graph = graph_ms(lambda: meta_kernel_fused(*k1_args))
        k1_flops, k1_bytes = k1_cost(*k1_args[0].shape)
        k1_bound = bound_ms(k1_flops, H100_BF16_FLOPS, k1_bytes)
        say(f"{name} K1 {tuple(k1_args[0].shape)} (the request's own stem inputs): max|diff| "
            f"{k1_err:.4g} (max|ref| {k1_ref:.4g}); {k1_ms:.4f} ms eager, {k1_graph:.4f} ms "
            f"graph replay, bound {k1_bound[0]:.4f} ms ({k1_bound[1]}) on {smi}")
        del k1_args
    else:
        check("K1" not in seen, f"{name}: the {cfg.stem_type} stem called K1")
    k2_err = check_k2(f"{name} request", k2_args)
    k2_ms = cuda_ms(lambda: nms_scan(*k2_args, **k2_kw), reps=20)
    k2_graph = graph_ms(lambda: nms_scan(*k2_args, **k2_kw))
    cap = k2_args[0].shape[-1]
    live = int(nms_scan(*k2_args, **k2_kw)[0].sum())
    k2_flops, k2_bytes = k2_cost(B, cap, live, k2_args[3].shape[-1])
    k2_bound = bound_ms(k2_flops, H100_FP32_FLOPS, k2_bytes)
    say(f"{name} K2 B {B} cap {cap} (the request's own IoU matrix, {live} kept): merged "
        f"max|diff| {k2_err:.3g}; {k2_ms:.4f} ms eager, {k2_graph:.4f} ms graph replay, bound "
        f"{k2_bound[0] * 1e3:.2f} us ({k2_bound[1]}) on {smi}")
    say(f"{name} bf16 request (B={B}, {H}x{W}): forward {fwd_ms:.3f} ms, decode + NMS "
        f"{dec_ms:.3f} ms (device, CUDA events, median of 5) on {smi}")
    del k2_args, seen, tensors
    laps("times, K1 and K2")

    # Raw points to detections: B=2 x 131,072 points a request at the
    # sensor, projected, padded and strided as above.
    points_predict, extra = points_front_end(predictor, layout)
    check(list(extra) == POINTS_EXTRA[layout["dataset_name"]],
          f"{name} points channels {extra}")
    clouds = [sensor_points(B, POINTS_N, layout, extra, seed=s) for s in range(4)]
    rasterized = points_predict.rasterize(*clouds[0])
    check(tuple(rasterized[0].shape) == (B, H, W, C), f"{name} points {rasterized[0].shape}")
    points_predict(*clouds[0])  # warm-up
    results = serve("points", points_predict, model, clouds, rasterized)
    by_hand = predictor(*rasterized)
    check(torch.equal(results[0].keep, by_hand.keep)
          and torch.equal(results[0].cuboids, by_hand.cuboids),
          f"{name} points: detections differ from the predictor on the same rasterized clouds")
    del results, by_hand, rasterized
    laps("points")

    # int8: fold, calibrate on request 0, quantize (full scope); K3 on every
    # shape a request launches; then the int8 stem (K4).
    predictor.quantize([requests[0]], scope="full")
    if not meta:  # the BASIC stem's 1x1 convs: calibrated, one int8 product each
        convs = {n: m for n, m in model.RangeNet_0.BasicBlock_0.named_modules()
                 if isinstance(m, Int8Conv)}
        calibrated = sorted(predictor.quant_tree["RangeNet_0"]["BasicBlock_0"])
        check(len(convs) == 3 and len(calibrated) == 3
              and all(m.route == "matmul" for m in convs.values()),
              f"{name}: the stem's int8 convs {({n: m.route for n, m in convs.items()})}, "
              f"calibrated {calibrated}")
        say(f"{name} int8 stem: {len(convs)} 1x1 convs calibrated ({', '.join(calibrated)}) "
            f"on the int8 product (route 'matmul', the JAX lax.conv's): "
            + ", ".join(f"{n} -> {m.cout} channels" for n, m in convs.items()))
    captured, k3_in = capture_k3(predictor, requests[0])  # warm-up, and its K3 inputs
    check(k3_in["unquantized"] == k3_in["launches"] == k3_in["nhwc_contiguous"],
          f"{name}: a K3 input was quantized or copied before the launch: {k3_in}")
    per_request = sum(e["per_request"] for e in captured.values())
    serve("int8", predictor, model, requests, requests[0])
    check(launches["int8"]["conv3x3_i8_fused"] == per_request * len(requests),
          f"{name} int8: K3 launches {launches['int8']} != {per_request} a request x 4")
    say(f"{name} int8: {per_request} K3 launches a request at {len(captured)} shapes: "
        + ", ".join(f"(Cin {k[0]}, Cout {k[1]}, W {k[2]}, stride {k[3]}) x {e['per_request']}"
                    for k, e in sorted(captured.items())))
    k3_request_shapes(captured, B, H, smi, config=name)
    del captured
    laps("int8")
    if "int8 K4 stem" in expect:
        predictor.quantize(quant_tree=predictor.quant_tree, stem_int8=True)

        def capture_k4(*args):
            seen.setdefault("K4", tuple(a.clone() for a in args))
            return meta_kernel_fused_i8(*args)

        seen = {}
        stems.meta_kernel_fused_i8 = capture_k4
        try:
            predictor(*requests[0])  # warm-up, and its K4 inputs
        finally:
            stems.meta_kernel_fused_i8 = meta_kernel_fused_i8
        serve("int8 K4 stem", predictor, model, requests, requests[0])
        k4_args = seen.pop("K4")
        got, want = meta_kernel_fused_i8(*k4_args), meta_kernel_fused_i8_plain(*k4_args)
        torch.cuda.synchronize()
        k4_err, k4_ref = (got - want).abs().max().item(), want.abs().max().item()
        n_diff = int((got != want).sum())
        check(n_diff == 0 and k4_err <= 1e-4 * k4_ref,
              f"{name} K4: {n_diff} elements differ, max|diff| {k4_err}")
        del got, want
        k4_ms = cuda_ms(lambda: meta_kernel_fused_i8(*k4_args), reps=10)
        k4_graph = graph_ms(lambda: meta_kernel_fused_i8(*k4_args))
        k4_bound = bound_ms(*k4_cost(*k4_args[0].shape))
        say(f"{name} K4 {tuple(k4_args[0].shape)} (the int8 request's own stem inputs): "
            f"{n_diff} elements differ from the twin (max|ref| {k4_ref:.4g}); {k4_ms:.4f} ms "
            f"eager, {k4_graph:.4f} ms graph replay, bound {k4_bound[0]:.4f} ms "
            f"({k4_bound[1]}) on {smi}")
        del k4_args
        laps("int8 stem")
    del predictor, model
    torch.cuda.empty_cache()

    # The bench's span (forward, decode, NMS at the config's cap) through
    # bench.build and bench.measure, one mode at a time.
    rows = []
    for tag, fp, stem in (("bf16", True, False), ("int8", False, False),
                          ("int8 K4 stem", False, True), ("points", False, False)):
        if tag not in bench_expect:
            continue
        _set_stem_int8(stem)
        try:
            pipeline, args, make_batch, path = bench.build(B, fp=fp, device=device, cfg=cfg,
                                                           dec=dec, height=H, width=W)
        finally:
            _set_stem_int8(False)
        if tag == "points":
            pipeline, extra = points_front_end(pipeline, layout)

            def make_batch(s, extra=extra):
                return sensor_points(B, POINTS_N, layout, extra, seed=s)

            args = tuple(torch.as_tensor(a, device=device) for a in make_batch(0))
        reset_counts()
        with bench_cut():
            fps, lat = bench.measure(pipeline, args, make_batch, B)
        torch.cuda.synchronize()
        counts = launches[f"bench {tag}"] = read_counts()
        need, never = bench_expect[tag]
        check(all(counts[k] > 0 for k in need) and all(counts[k] == 0 for k in never),
              f"{name} bench {tag}: launches {counts}")
        rows.append(f"{tag} ({path}{', points' if tag == 'points' else ''}) p50 "
                    f"{lat['latency_ms_p50']} ms, p90 {lat['latency_ms_p90']} ms, "
                    f"{fps:.2f} frames/s")
        del pipeline, args
        torch.cuda.empty_cache()
    say(f"{name} bench (bench.build + bench.measure, B={B} {H}x{W}, one mode at a time, "
        f"{CONFIG_BENCH_ITERS['ITERS']} requests for frames/s and "
        f"{CONFIG_BENCH_ITERS['LATENCY_ITERS']} for p50/p90, a cut from the bench's "
        f"{bench.ITERS} and {bench.LATENCY_ITERS}): "
        + "; ".join(rows) + f" on {smi}")
    laps("bench modes")

    # Train steps: bf16 at the served width, 64 seeded boxes of 256 an image,
    # on sweeps padded and strided as the train split does.
    pad_train = train_padding(name)
    inputs = padded_request(train_batch, H, layout["sensor_width"], C, seed=SEED + seed,
                            x_stride=layout["x_stride"], padding_mode=pad_train)
    batch = state_lib.batch_to_device(
        flagship_train_batch(cfg, train_batch, H, W, seed=SEED + seed, inputs=inputs), device)
    tx, _ = optim.make_optimizer(1e-3, 10, debug=True)
    torch.cuda.reset_peak_memory_stats()
    st = state_lib.create_state(cfg, tx, device=device,
                                generator=torch.Generator().manual_seed(SEED + seed + 1))
    params0 = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    total, split, st = step_split(state_lib.make_train_step(cfg), st, batch, n=5)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    still = [n for n, p in st.model.named_parameters() if torch.equal(p.detach(), params0[n])]
    check(not still, f"{name}: parameters unchanged after 5 train steps: {still[:5]}")
    say(f"{name} train step (bf16, B={train_batch} {H}x{W}, {pad_train} padding, 64 boxes an "
        f"image): {total:.3f} ms "
        f"(CUDA events, median of 3 after 2 warm-up) = "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" ms; all {len(params0)} parameter leaves changed; peak memory {peak_gb:.2f} GiB "
        f"on {smi}")
    del st, params0, batch
    torch.cuda.empty_cache()
    laps("train steps")
    say(f"phase {phase} {name}: {time.perf_counter() - t0:.0f} s ({laps})")
    say(f"{name} launches (phase {phase}) " + json.dumps(launches))
    return launches


def configs_phase(phase, device, smi) -> dict:
    """Phase 45 (rv-waymo), 46 (base-av2 and rv-av2-fast) or 47
    (rv-nuscenes and base-waymo): each of
    ``PUBLISHED_CONFIGS``' configurations of ``phase`` through
    ``config_phase`` (see the module docstring). Returns each config's
    launches by mode."""
    t0 = time.perf_counter()
    out = {}
    for name, (p, x_stride, small_sensor, seed, train_batch) in PUBLISHED_CONFIGS.items():
        if p == phase:
            out[name] = config_phase(name, phase, device, smi, x_stride=x_stride,
                                     small_sensor=small_sensor, seed=seed,
                                     train_batch=train_batch)
    say(f"phase {phase}: {time.perf_counter() - t0:.0f} s")
    return out


# Phase 48: Waymo as its users run it (see the module docstring). The
# oracle's gate, from the JAX package's own run of the same overfit on the
# CPU (``python tests/test_torch_trainer.py overfit waymo E DIR``: the
# corpus and overrides of scripts/debug-overfit-waymo.sh, bf16, 8 steps an
# epoch): the WOD mAP_L2 without the recall-gap penalty (the script's
# oracle number; a converged model reads near 1.0) 0.0803 at 30 epochs,
# 0.4111 at 40, 0.6952 at 60, the last 10 steps' mean loss 0.663, 0.655
# and 0.613 of the first step's. 40 epochs (320 steps, 47-63 s on an
# NVIDIA H100 80GB HBM3 at 700.00 W) of the manual run's 250 is what the
# phase affords; the gate sits below JAX's reading there.
WAYMO_ORACLE_EPOCHS = 40
WAYMO_ORACLE_BAR = 0.3
WAYMO_ORACLE_LOSS_SHARE = 0.7
# Phase 48's requests: B=2 pairs of the corpus's two sweeps.
WAYMO_USER_PAIRS = ((0, 1), (1, 0), (0, 0), (1, 1))


def waymo_user_cuts(epochs: int = WAYMO_ORACLE_EPOCHS) -> list:
    """Phase 48's cuts, printed with its results (PERF.md section 4)."""
    return ["corpus: phase 29's converted Waymo fixture, one log of 2 frames at 64 x 2650 "
            "(one B=2 step an epoch), the val split pinned to train",
            "Trainer: one epoch from random weights",
            f"oracle: {epochs} epochs ({8 * epochs} steps) of the manual run's 250 (2000)",
            f"requests: {len(WAYMO_USER_PAIRS)} B=2 pairs of the corpus's 2 sweeps"]


def convert_waymo_corpus(root: Path, height: int = 64, width: int = 2650) -> Path:
    """Phase 29's Waymo conversion again, for ``chip_smoke.py waymo-user``:
    the same frames (``waymo_frames(2, seed=SEED + 29)``) through the
    port's converter into ``root/train/segment-0``. Returns ``root``."""
    from range_view_3d_detection_torch.converters.waymo import export as waymo_export

    frames = waymo_frames(2, seed=SEED + 29, height=height, width=width)
    n = waymo_export.export_log(None, root / "train" / "segment-0", frames=frames,
                                export_cameras=False)
    check(n == 2, f"Waymo conversion: {n} frames")
    return root


def waymo_trainer_run(corpus: Path, run_dir: Path, device=None, overrides=()) -> dict:
    """Phase 48's Trainer: rv-waymo from ``conf/`` on the converted corpus
    (``compose(REPO / "conf", "rv-waymo", ...)``; its one log is both
    splits), one epoch at B=2 on ``device`` (None: the Trainer's default,
    the card; ``overrides`` after the phase's), ``validate`` to one shard
    a sweep, the shards scored by the WOD evaluator
    (``evaluate.evaluate_dirs``: ``evaluate_waymo`` with the recall-gap
    penalty and without) under ``detection_cfg_factory("waymo")``, every
    average finite (mAP and mAPH at levels 1 and 2). Returns the trainer
    and its numbers."""
    import torch

    from range_view_3d_detection_torch.evaluate import evaluate_dirs
    from range_view_3d_detection_torch.evaluation import detection_cfg_factory
    from range_view_3d_detection_torch.evaluation.waymo_eval import mean_ap
    from range_view_3d_detection_torch.training.loop import Trainer
    from range_view_3d_detection_torch.utils.config import compose

    cfg = compose(REPO / "conf", "rv-waymo", [
        f"++dataset.root_dir={corpus}", "++dataset._val_dataset.split_name=train",
        f"++run_dir={run_dir}", "++trainer.max_epochs=1", "++model.batch_size=2",
        "++model.train_log_freq=0", *overrides])
    trainer = Trainer(cfg, device=device)
    want = torch.device(device).type if device is not None else "cuda"
    check(trainer.device.type == want and len(trainer.train_ds) == 2
          and len(trainer.val_ds) == 2,
          f"Waymo trainer on {trainer.device}, {len(trainer.train_ds)} train and "
          f"{len(trainer.val_ds)} val sweeps")

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()

    item = trainer.train_ds[0]
    t0 = time.perf_counter()
    state = trainer.fit()
    sync()
    fit_s = time.perf_counter() - t0
    check(state.step == 1, f"Waymo corpus: step {state.step}")
    losses = [json.loads(x).get("loss") for x in
              (Path(cfg["run_dir"]) / "metrics.jsonl").read_text().splitlines()]
    losses = [x for x in losses if x is not None]
    check(len(losses) == 1 and math.isfinite(losses[0]), f"Waymo losses {losses}")
    t0 = time.perf_counter()
    pred_dir = trainer.validate()
    sync()
    val_s = time.perf_counter() - t0
    shards = sorted(pred_dir.glob("*.feather"))
    check(len(shards) == 2, f"Waymo corpus: {len(shards)} shards")
    eval_cfg = detection_cfg_factory("waymo")
    check((eval_cfg.dataset_name, eval_cfg.max_range_m, eval_cfg.eval_only_roi_instances)
          == ("waymo", math.inf, False), f"WOD settings {eval_cfg}")
    t0 = time.perf_counter()
    average = {}
    for tag, penalty in (("penalty", True), ("no penalty", False)):
        m = evaluate_dirs(pred_dir, corpus / "train", eval_cfg.dataset_name,
                          recall_gap_penalty=penalty)
        for level in (1, 2):
            for metric in ("AP", "APH"):
                average[f"m{metric}_L{level} {tag}"] = mean_ap(m, level=level, metric=metric)
    eval_s = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in average.values()), f"WOD averages {average}")
    return dict(trainer=trainer, fit_s=fit_s, val_s=val_s, eval_s=eval_s, loss=losses[0],
                shards=len(shards), average=average, shape=tuple(item["features"].shape),
                layers=trainer.det_cfg.layers)


def corpus_requests(dataset, pairs=WAYMO_USER_PAIRS) -> list:
    """B=2 requests ``(feats, cart, mask)`` of a dataset's items (padded as
    its split pads them), one a pair of item indices."""
    import numpy as np

    items = {i: dataset[i] for i in sorted({i for pair in pairs for i in pair})}
    return [tuple(np.stack([items[i][k] for i in pair]) for k in ("features", "cart", "mask"))
            for pair in pairs]


def corpus_clouds(corpus: Path, extra, height: int, pairs=WAYMO_USER_PAIRS,
                  split: str = "train") -> list:
    """The converted corpus's own points, as a user's raw clouds: a sweep's
    pixels with a return (range > 0), its x, y, z (the vehicle frame the
    converter writes), the laser its row, and the channels ``extra`` names
    (raw, as the converter keeps them); B=2 requests a pair of the
    ``split``'s sweeps, padded to a common count with zero rows (which the
    z-buffer's minimum distance drops). ``height``: the sensor's rows."""
    import numpy as np

    from range_view_3d_detection_torch.utils.feather import read_feather

    sweeps = []
    for path in sorted((corpus / split).rglob("sensors/range_view/*.feather")):
        c = read_feather(path)
        valid = c["range"] > 0
        rows = np.arange(len(valid)) // (len(valid) // height)
        sweeps.append((np.stack([c["x"], c["y"], c["z"]], -1)[valid], rows[valid],
                       [c[n][valid] for n in extra]))
    out = []
    for pair in pairs:
        n = max(len(sweeps[i][0]) for i in pair)

        def pad(a, n=n):
            return np.pad(a, ((0, n - len(a)),) + ((0, 0),) * (a.ndim - 1))

        out.append((np.stack([pad(sweeps[i][0]) for i in pair]).astype(np.float32),
                    np.stack([pad(sweeps[i][1]) for i in pair]).astype(np.int32),
                    *(np.stack([pad(sweeps[i][2][k]) for i in pair]).astype(np.float32)
                      for k in range(len(extra)))))
    return out


def bit_equal(a, b) -> bool:
    """Two tensors equal bit for bit, NaNs included: dtype, shape and bits."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.contiguous().view(view), b.contiguous().view(view))
    return torch.equal(a, b)


def differing_fields(got, want) -> list:
    """The fields of two results (named tuples of tensors) that are not
    equal bit for bit."""
    return [name for name, a, b in zip(want._fields, got, want) if not bit_equal(a, b)]


def waymo_oracle(smi, epochs: int = WAYMO_ORACLE_EPOCHS) -> dict:
    """Phase 48's WOD overfit oracle: ``overfit.run("waymo", epochs)`` on
    the card (its default device: the corpus and overrides of
    scripts/debug-overfit-waymo.sh, rv-waymo-synthetic in bf16), the loss
    by epoch, the WOD mAP and mAPH at level 2 with and without the
    recall-gap penalty; the gate: the last 10 steps' mean loss at most
    ``WAYMO_ORACLE_LOSS_SHARE`` of the first step's, and the mAP without
    the penalty at least ``WAYMO_ORACLE_BAR``. Then the int8 PTQ of its
    weights (``overfit.int8_predictor``: full scope, calibrated on its
    train batches) scored alike. Returns the launches of the bf16 run
    (fit and validate) and of the int8 scoring."""
    import torch

    from range_view_3d_detection_torch import overfit
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.ops import nms as nms_ops

    work = Path(tempfile.mkdtemp(prefix="chip-smoke-overfit-waymo-"))
    launches = {}
    try:
        reset_counts()
        t0 = time.perf_counter()
        out = overfit.run("waymo", epochs, work)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches["oracle bf16"] = read_counts()
        trainer, losses = out["trainer"], out["losses"]
        check(trainer.device.type == "cuda", f"the oracle ran on {trainer.device}")
        check(len(losses) == 8 * epochs, f"the oracle took {len(losses)} steps")
        last10 = statistics.mean(losses[-10:])
        by_epoch = [round(statistics.mean(losses[i:i + 8]), 4) for i in range(0, len(losses), 8)]
        wod = {"bf16": {tag: out[tag] for tag in ("penalty", "no_penalty")}}
        # rv-waymo-synthetic's MetaKernel takes the accumulate path
        # (``stem_pallas`` false in conf/, as in the JAX package): no K1.
        stem = "meta_kernel_fused"
        check(launches["oracle bf16"]["nms_scan"] > 0
              and (launches["oracle bf16"][stem] > 0) == trainer.det_cfg.stem_pallas,
              f"oracle launches {launches['oracle bf16']}")
        reset_counts()
        t0 = time.perf_counter()
        predictor = overfit.int8_predictor(trainer)
        seen = {}

        def capture_k2(*args, **kw):
            # The first request with proposals.
            if "K2" not in seen or not bool(seen["K2"][0][2].any()):
                seen["K2"] = (tuple(a.clone() for a in args), kw)
            return nms_scan(*args, **kw)

        nms_ops.nms_scan = capture_k2
        try:
            pred_dir = overfit.write_predictor_shards(trainer, predictor,
                                                      work / "int8_predictions")
        finally:
            nms_ops.nms_scan = nms_scan
        torch.cuda.synchronize()
        launches["oracle int8"] = read_counts()
        check(launches["oracle int8"]["conv3x3_i8_fused"] > 0
              and launches["oracle int8"]["nms_scan"] > 0,
              f"oracle int8 launches {launches['oracle int8']}")
        int8 = overfit.score(trainer, pred_dir)
        int8_s = time.perf_counter() - t0
        # K2 on the trained model's own proposals.
        k2_args, k2_kw = seen["K2"]
        k2_err = check_k2("WOD oracle request", k2_args)
        live = int(nms_scan(*k2_args, **k2_kw)[0].sum())
        check(live > 0, "WOD oracle request: K2 kept nothing")
        k2_ms = cuda_ms(lambda: nms_scan(*k2_args, **k2_kw), reps=20)
        B2, cap = k2_args[0].shape[:2]
        k2_flops, k2_bytes = k2_cost(B2, cap, live, k2_args[3].shape[-1])
        k2_bound = bound_ms(k2_flops, H100_FP32_FLOPS, k2_bytes)
        say(f"WOD oracle K2 B {B2} cap {cap} (an int8 request's own IoU matrix, {live} kept, "
            f"{int(k2_args[2].sum())} valid): merged max|diff| {k2_err:.3g}; {k2_ms:.4f} ms "
            f"eager, bound {k2_bound[0] * 1e3:.2f} us ({k2_bound[1]}) on {smi}")
        del seen, k2_args
        wod["int8"] = {tag: int8[tag] for tag in ("penalty", "no_penalty")}
        text = "; ".join(
            f"{dtype} " + ", ".join(f"{tag.replace('_', ' ')} mAP_L2 {m['mAP_L2']:.4f} mAPH_L2 "
                                    f"{m['mAPH_L2']:.4f}" for tag, m in ms.items())
            for dtype, ms in wod.items())
        say(f"WOD overfit oracle (phase 48): overfit.run('waymo', {epochs}) on "
            f"{trainer.device}, {len(losses)} steps, fit, validate and WOD scoring in "
            f"{run_s:.1f} s; loss {losses[0]:.4f} at step 1, last-10 mean {last10:.4f} "
            f"({last10 / losses[0]:.3f} of it), by epoch {by_epoch}; {text}; int8 PTQ, "
            f"shards and scoring {int8_s:.1f} s; launches {launches} (synthetic data) on {smi}")
        check(all(math.isfinite(v) for ms in wod.values() for m in ms.values()
                  for v in m.values()), f"oracle WOD numbers {wod}")
        check(last10 <= WAYMO_ORACLE_LOSS_SHARE * losses[0],
              f"oracle: last-10 mean loss {last10} > {WAYMO_ORACLE_LOSS_SHARE} of the first "
              f"{losses[0]}")
        check(out["no_penalty"]["mAP_L2"] >= WAYMO_ORACLE_BAR,
              f"oracle: mAP_L2 without the penalty {out['no_penalty']['mAP_L2']} < "
              f"{WAYMO_ORACLE_BAR} at {epochs} epochs")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def waymo_deploy(trainer, corpus: Path, work: Path, device, smi) -> dict:
    """Phase 48's deployment of the fitted rv-waymo (see the module
    docstring): its bf16 and int8 artifacts written from the Trainer's
    model (int8 calibrated on its train batches), then ``deploy_artifacts``
    with the AOT programs. Returns each mode's launches."""
    import torch

    from range_view_3d_detection_torch.export import _dataset_meta_from_cfg, export_artifact

    det_cfg, dec_cfg = trainer.det_cfg, trainer.dec_cfg
    model = trainer.state.model.eval()
    meta = _dataset_meta_from_cfg(trainer.cfg)
    requests = corpus_requests(trainer.val_ds)
    check(meta["padding_mode"] == "constant", f"rv-waymo {meta['padding_mode']} padding")
    calib = [tuple(torch.as_tensor(b[k], device=device) for k in ("features", "cart", "mask"))
             for b in trainer.train_loader]
    art = work / "artifacts"
    t0 = time.perf_counter()
    export_artifact(model, det_cfg, dec_cfg, art / "bf16", dataset_meta=meta)
    export_artifact(model, det_cfg, dec_cfg, art / "int8", quantize_batches=calib,
                    dataset_meta=meta)
    say(f"rv-waymo fitted (phase 48): bf16 and int8 artifacts (int8 calibrated on its "
        f"{len(calib)} train batch(es)) in {time.perf_counter() - t0:.1f} s, "
        f"variables.msgpack {(art / 'bf16' / 'variables.msgpack').stat().st_size / 2**20:.1f} "
        f"MiB")
    clouds = corpus_clouds(corpus, POINTS_EXTRA["waymo"], height=meta["height"])
    launches, _ = deploy_artifacts(
        "rv-waymo fitted", art, model, det_cfg, dec_cfg, meta, requests, calib, clouds,
        device, smi, shape=(2, 64, 2656, 6), aot_label="phase 48")
    return launches


def deploy_artifacts(name, art: Path, model, det_cfg, dec_cfg, meta, requests, calib, clouds,
                     device, smi, *, shape, source="the fitted model", aot_label=None,
                     timed=False) -> tuple:
    """A trained model deployed from its artifacts (phases 48 and 49):
    ``art``'s ``bf16`` and ``int8`` artifacts (written from ``model``, the
    int8 one calibrated on ``calib``), each loaded by ``load_artifact`` and
    serving ``requests`` (B=2 requests of ``shape``) equal bit for bit to
    ``model`` folded (and quantized on ``calib``) in memory; the int8
    artifact's quant tree the one calibrated in memory; K2, and with
    ``det_cfg``'s MetaKernel stem K1, against their twins on the first
    request's own inputs and K3 on every shape of an int8 request; K4
    once under ``RV3D_STEM_INT8=1``, no element differing (MetaKernel
    stem); ``clouds`` (the corpus's own returns of ``meta``'s
    dataset) through the bf16 artifact's points front end against the
    artifact on the clouds rasterized by hand with ``meta``'s layout; the
    requests as one CUDA-graph replay against the eager calls; with
    ``aot_label`` the AOT programs against ``load_artifact``
    (``aot_phase``). Each mode's launches are held to the stem's
    ``CONFIG_EXPECT``. ``name`` opens every printed line, ``source`` names
    the reference; ``timed`` adds K1's graph replay and K4's times.
    Returns ``(launches by mode, times)``."""
    import os

    import torch

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.data.dataset import width_padding
    from range_view_3d_detection_torch.export import (
        load_artifact,
        make_chunked_predict,
        make_points_predict,
    )
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.kernels.stem import (
        meta_kernel_fused,
        meta_kernel_fused_i8,
        meta_kernel_fused_i8_plain,
        meta_kernel_fused_plain,
    )
    from range_view_3d_detection_torch.models import stems
    from range_view_3d_detection_torch.models.quantized import fold_batch_norms, quant_tree_of
    from range_view_3d_detection_torch.ops import nms as nms_ops
    from range_view_3d_detection_torch.ops.projection import rasterize_points
    from range_view_3d_detection_torch.utils.msgpack import msgpack_serialize

    B, H, W, C = requests[0][0].shape
    check((B, H, W, C) == tuple(shape), f"{name} requests {(B, H, W, C)}, not {shape}")
    meta_stem = det_cfg.stem_type == "META"
    expect = CONFIG_EXPECT[det_cfg.stem_type]
    launches, times = {}, {}

    def serve(tag, predict, inputs, want, mode, reference):
        """``inputs`` through ``predict`` after one warm-up call, the
        counts reset just before and read just after: the kernels of
        ``expect[mode]`` launched and not, each result equal bit for bit
        to ``want``'s; ms a request the median of the host walls."""
        need, never = expect[mode]
        predict(*inputs[0])
        torch.cuda.synchronize()
        reset_counts()
        got, walls = [], []
        for r in inputs:
            t1 = time.perf_counter()
            got.append(predict(*r))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        counts = launches[tag] = read_counts()
        check(all(counts[k] > 0 for k in need) and all(counts[k] == 0 for k in never),
              f"{name} {tag}: launches {counts}")
        for i, (g, w) in enumerate(zip(got, want)):
            bad = differing_fields(g, w)
            check(not bad, f"{name} {tag}: request {i}: {bad} differ from {reference}")
        kept = [r.keep.sum(-1).tolist() for r in got]
        odd = sum(int((~torch.isfinite(r.cuboids[r.keep])).sum()) for r in got)
        times[f"{tag} ms"] = statistics.median(walls)
        say(f"{name} {tag}: {len(inputs)} B={B} requests equal bit for bit to "
            f"{reference}; launches {counts}; kept {kept} ({odd} non-finite kept cuboid values, "
            f"counted, not gated); {statistics.median(walls):.3f} ms a request (host clock, "
            f"median of {len(walls)}) on {smi}")
        return got

    # bf16: the artifact against the model folded in memory; K1 and K2
    # held against their twins on the first request's own inputs.
    ref = serving.Predictor(det_cfg, dec_cfg, device=device)
    ref.model.load_state_dict(model.state_dict())
    fold_batch_norms(ref.model)
    ref.bn_folded = True
    want = [ref(*r) for r in requests]
    bf16, _, _ = load_artifact(art / "bf16", device=device)
    check(bf16.bn_folded and bf16.quant_tree is None, "bf16 artifact: not folded fp")
    seen = {}

    def capture_k1(*args):
        seen.setdefault("K1", tuple(a.clone() for a in args))
        return meta_kernel_fused(*args)

    def capture_k2(*args, **kw):
        seen.setdefault("K2", (tuple(a.clone() for a in args), kw))
        return nms_scan(*args, **kw)

    stems.meta_kernel_fused, nms_ops.nms_scan = capture_k1, capture_k2
    try:
        bf16(*requests[0])
    finally:
        stems.meta_kernel_fused, nms_ops.nms_scan = meta_kernel_fused, nms_scan
    eager = serve("artifact bf16", bf16, requests, want, "bf16",
                  f"{source}'s Predictor, folded in memory")
    text = []
    if meta_stem:
        k1_args = seen["K1"]
        got, twin = meta_kernel_fused(*k1_args), meta_kernel_fused_plain(*k1_args)
        torch.cuda.synchronize()
        k1_err, k1_ref = (got - twin).abs().max().item(), twin.abs().max().item()
        check(k1_err <= 2e-2 * k1_ref, f"{name} K1: max|diff| {k1_err} > 2e-2 * {k1_ref}")
        k1_ms = times["K1 ms"] = cuda_ms(lambda: meta_kernel_fused(*k1_args), reps=10)
        k1_flops, k1_bytes = k1_cost(*k1_args[0].shape)
        k1_bound = bound_ms(k1_flops, H100_BF16_FLOPS, k1_bytes)
        times["K1 bound"] = k1_bound
        graph = ""
        if timed:
            times["K1 graph ms"] = graph_ms(lambda: meta_kernel_fused(*k1_args))
            graph = f", {times['K1 graph ms']:.4f} ms graph replay"
        text.append(f"K1 {tuple(k1_args[0].shape)} (a request's own stem inputs): max|diff| "
                    f"{k1_err:.4g} (max|ref| {k1_ref:.4g}), {k1_ms:.4f} ms eager{graph}, bound "
                    f"{k1_bound[0]:.4f} ms ({k1_bound[1]})")
        del k1_args, got, twin
    else:
        check("K1" not in seen, f"{name}: the BASIC stem called K1")
    k2_args, k2_kw = seen["K2"]
    k2_err = check_k2(f"{name} request", k2_args)
    k2_ms = times["K2 ms"] = cuda_ms(lambda: nms_scan(*k2_args, **k2_kw), reps=20)
    live = int(nms_scan(*k2_args, **k2_kw)[0].sum())
    k2_flops, k2_bytes = k2_cost(B, k2_args[0].shape[-1], live, k2_args[3].shape[-1])
    k2_bound = times["K2 bound"] = bound_ms(k2_flops, H100_FP32_FLOPS, k2_bytes)
    text.append(f"K2 cap {k2_args[0].shape[-1]} (its own IoU matrix, {live} kept): merged "
                f"max|diff| {k2_err:.3g}, {k2_ms:.4f} ms eager, bound "
                f"{k2_bound[0] * 1e3:.2f} us ({k2_bound[1]})")
    say(f"{name} " + "; ".join(text) + f" on {smi}")
    del seen, k2_args, want

    # int8: the artifact against the model quantized in memory on the same
    # calibration batches; K3 on every shape a request launches.
    ref_i8 = serving.Predictor(det_cfg, dec_cfg, device=device)
    ref_i8.model.load_state_dict(model.state_dict())
    ref_i8.quantize(calib, scope="full")
    want = [ref_i8(*r) for r in requests]
    int8, _, _ = load_artifact(art / "int8", device=device)
    written = (art / "int8" / "quant.msgpack").read_bytes()
    check(msgpack_serialize(int8.quant_tree) == written
          and msgpack_serialize(quant_tree_of(int8.model)) == written
          and msgpack_serialize(ref_i8.quant_tree) == written,
          "int8 artifact: its quant tree is not the one calibrated in memory")
    captured, k3_in = capture_k3(int8, requests[0])
    check(k3_in["unquantized"] == k3_in["launches"] == k3_in["nhwc_contiguous"] > 0,
          f"{name}: a K3 input was quantized or copied before the launch: {k3_in}")
    serve("artifact int8", int8, requests, want, "int8", f"{source} quantized in memory")
    times["K3"] = k3_request_shapes(captured, B, H, smi, config=name)
    del captured, want

    # The int8 stem (K4), once: the artifact loaded under RV3D_STEM_INT8=1.
    if meta_stem:
        os.environ["RV3D_STEM_INT8"] = "1"
        try:
            k4, _, _ = load_artifact(art / "int8", device=device)
        finally:
            del os.environ["RV3D_STEM_INT8"]
        ref_i8.quantize(quant_tree=ref_i8.quant_tree, stem_int8=True)
        seen = {}

        def capture_k4(*args):
            seen.setdefault("K4", tuple(a.clone() for a in args))
            return meta_kernel_fused_i8(*args)

        stems.meta_kernel_fused_i8 = capture_k4
        try:
            k4(*requests[0])
        finally:
            stems.meta_kernel_fused_i8 = meta_kernel_fused_i8
        serve("artifact int8, K4 stem", k4, requests[:1], [ref_i8(*requests[0])],
              "int8 K4 stem", "the in-memory int8 model with the int8 stem")
        k4_args = seen["K4"]
        got, twin = meta_kernel_fused_i8(*k4_args), meta_kernel_fused_i8_plain(*k4_args)
        torch.cuda.synchronize()
        n_diff = int((got != twin).sum())
        check(n_diff == 0, f"{name} K4: {n_diff} elements differ from its twin")
        timing = ""
        if timed:
            times["K4 ms"] = cuda_ms(lambda: meta_kernel_fused_i8(*k4_args), reps=10)
            times["K4 graph ms"] = graph_ms(lambda: meta_kernel_fused_i8(*k4_args))
            times["K4 bound"] = bound_ms(*k4_cost(*k4_args[0].shape))
            timing = (f"; {times['K4 ms']:.4f} ms eager, {times['K4 graph ms']:.4f} ms graph "
                      f"replay, bound {times['K4 bound'][0]:.4f} ms ({times['K4 bound'][1]}) "
                      f"on {smi}")
        say(f"{name} K4 {tuple(k4_args[0].shape)} (the request's own stem inputs): no "
            f"element differs from its twin{timing}")
        del k4, seen, k4_args, got, twin
    del ref_i8, int8, ref
    torch.cuda.empty_cache()

    # Raw points: the corpus's own clouds through the points front end of
    # the bf16 artifact, against the artifact on the clouds rasterized by
    # hand with the artifact's recorded layout.
    layout = dict(height=meta["height"], width=meta["sensor_width"],
                  feature_names=tuple(meta["feature_names"]),
                  dataset_name=meta["dataset_name"], x_stride=meta["x_stride"],
                  pad=width_padding(meta["sensor_width"], meta["x_stride"]),
                  padding_mode=meta["padding_mode"])
    points, extra = make_points_predict(
        bf16, sensor_width=meta["sensor_width"], height=meta["height"],
        feature_names=meta["feature_names"], dataset_name=meta["dataset_name"],
        x_stride=meta["x_stride"], padding_mode=meta["padding_mode"])
    check(list(extra) == POINTS_EXTRA[meta["dataset_name"]],
          f"{name} points channels {extra}")

    def by_hand(xyz, laser, *chans):
        with torch.inference_mode():
            image = rasterize_points(
                torch.as_tensor(xyz, device=device), torch.as_tensor(laser, device=device),
                {n: torch.as_tensor(c, device=device) for n, c in zip(extra, chans)},
                **layout)
        check(tuple(image[0].shape) == (B, H, W, C), f"{name} points {image[0].shape}")
        return bf16(*image)

    want = [by_hand(*c) for c in clouds]
    serve("points", points, clouds, want, "points",
          f"the artifact on the clouds rasterized by hand ({[c[0].shape[1] for c in clouds]} "
          f"points a cloud)")
    del points, want

    # The chunk loop: the requests as one CUDA-graph replay.
    run = make_chunked_predict(bf16, len(requests))
    stacked = [torch.stack([torch.as_tensor(r[j], device=device) for r in requests])
               for j in range(3)]
    torch.cuda.synchronize()
    reset_counts()
    first = run(*stacked)
    torch.cuda.synchronize()
    counts = launches["chunk"] = read_counts()
    need, never = expect["bf16"]
    check(all(counts[k] > 0 for k in need) and all(counts[k] == 0 for k in never),
          f"{name} chunk loop launches {counts}")
    walls = []
    for _ in range(5):
        walls.append(cuda_sync_wall(lambda: run(*stacked)) / len(requests))
    again = run(*stacked)
    for got in (first, again):
        for i, e in enumerate(eager):
            bad = [n for n, a, b in zip(e._fields, got, e) if not bit_equal(a[i], b)]
            check(not bad, f"{name} chunk loop: request {i}: {bad} differ from the eager call")
    times["chunk ms"] = statistics.median(walls)
    say(f"{name} chunk loop: {len(requests)} B={B} requests as one CUDA-graph replay "
        f"equal {len(requests)} eager calls of the bf16 artifact bit for bit (twice); launches "
        f"while captured {counts}; {statistics.median(walls):.3f} ms a request (host clock, "
        f"median of 5 replays) on {smi}")
    del run, first, again, stacked, bf16, eager
    torch.cuda.empty_cache()

    # AOT: each artifact's program against load_artifact (phase 27's).
    if aot_label is not None:
        launches["AOT"] = aot_phase(art, requests, device, smi, label=aot_label)
    return launches, times


def waymo_user_phase(device, smi, corpus: Path | None = None) -> dict:
    """Phase 48 (see the module docstring) on ``corpus``, phase 29's
    converted Waymo corpus (None: converted here). Returns each kernel's
    launches over the phase's paths."""
    import torch

    t0 = time.perf_counter()
    laps = Laps()
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-waymo-user-"))
    launches = {}
    try:
        source = "phase 29's"
        if corpus is None:
            corpus, source = convert_waymo_corpus(work / "sensor"), "converted here"
        say("Waymo user path (phase 48), cuts: " + "; ".join(waymo_user_cuts()))
        torch.cuda.synchronize()
        reset_counts()
        tr = waymo_trainer_run(corpus, work / "run")
        torch.cuda.synchronize()
        counts = launches["Trainer"] = read_counts()
        check(counts["meta_kernel_fused"] > 0 and counts["nms_scan"] > 0,
              f"Waymo Trainer launches {counts}")
        check(tr["layers"] == (128,) * 5 and tr["shape"] == (64, 2656, 6),
              f"Waymo Trainer: layers {tr['layers']}, sweep {tr['shape']}")
        say(f"Waymo corpus (phase 48, {source}): rv-waymo at its published widths on "
            f"{tr['trainer'].device}, B=2 {tr['shape']}, 1 step in {tr['fit_s']:.2f} s (loss "
            f"{tr['loss']:.4f}), validate {tr['val_s']:.2f} s ({tr['shards']} shards), WOD "
            f"evaluator {tr['eval_s']:.3f} s under detection_cfg_factory('waymo'): "
            + ", ".join(f"{k} {v:.4f}" for k, v in tr["average"].items())
            + f"; launches {counts} on {smi}")
        laps("Trainer")
        launches.update(waymo_deploy(tr["trainer"], corpus, work, device, smi))
        del tr
        torch.cuda.empty_cache()
        laps("deployment")
        launches.update(waymo_oracle(smi))
        torch.cuda.empty_cache()
        laps("oracle")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"phase 48 Waymo user path: {time.perf_counter() - t0:.0f} s ({laps})")
    say("Waymo user launches (phase 48) " + json.dumps(launches))
    return {k: sum(m[k] for m in launches.values()) for k in kernel_counts()}


# Phase 49: the four other published experiments as their users run them
# (see the module docstring). Each takes one of phase 29's converted
# corpora (``USER_CORPORA``): name -> (corpus, the split its requests and
# clouds come from, the requests' shape, the train batch). The AV2 corpus
# holds 4 train sweeps, so base-av2 and rv-av2-fast train at their
# published batch_size, 4; the nuScenes and Waymo corpora hold 2 sweeps,
# so B=2 there, their val split pinned to train.
USER_CORPORA = ("av2", "nuscenes", "waymo")
PUBLISHED_USERS = {
    "base-av2": ("av2", "val", (2, 64, 1808, 5), 4),
    "rv-av2-fast": ("av2", "val", (2, 64, 464, 5), 4),
    "rv-nuscenes": ("nuscenes", "train", (2, 32, 1808, 5), 2),
    "base-waymo": ("waymo", "train", (2, 64, 2656, 6), 2),
}
USER_PAIRS = ((0, 1), (1, 0))  # the requests: B=2 pairs of two val sweeps
# The configs whose AOT programs (bf16 and int8) phase 49 writes through the
# export CLI: the BASIC and the META stem, at x_stride 1 and 4. The first
# one's bf16 program is also served by a process that imports only the
# kernels package.
USER_AOT = ("base-av2", "rv-av2-fast")
USER_AOT_REPS = 5  # each AOT program's timed requests: half phase 27's, a cut


def published_user_cuts() -> list:
    """Phase 49's cuts, printed with its results (PERF.md section 4)."""
    return ["corpora: phase 29's converted fixtures, AV2 one train log of 4 sweeps and one "
            "val log of 2 at 64 x 1800, nuScenes one scene of 2 sweeps at 32 x 1800, Waymo "
            "one log of 2 frames at 64 x 2650, the last two with the val split pinned to "
            "train",
            "Trainer: one epoch from random weights (one step), B=4 for base-av2 and "
            "rv-av2-fast (their published batch_size), B=2 for rv-nuscenes and base-waymo "
            "(2 sweeps)",
            f"requests: {len(USER_PAIRS)} B=2 pairs of the 2 val sweeps in every mode, the "
            "int8 stem 1",
            f"AOT: B=2 only, for {' and '.join(USER_AOT)} (the BASIC and META stems at "
            "x_stride 1 and 4), not for rv-nuscenes and base-waymo (the same export code at "
            "other widths; phases 27 and 48 export the META stem at 64 rows); exported by the "
            "export CLI beside the phase's runs, checked once every export has ended; the "
            f"kernels-only process for {USER_AOT[0]} alone; each program timed on "
            f"{USER_AOT_REPS} requests beside load_artifact (phase 27: 10)",
            "K2 on a non-empty matrix: one request of the bf16 artifact with the decoder's "
            "min_confidence lowered to 0 in memory (the artifact keeps the published value)"]


def convert_user_corpora(root: Path, av2_width: int = 1800, nuscenes_width: int = 1800,
                         waymo_size=(64, 2650), points: int = RAW_POINTS) -> Path:
    """Phase 29's corpora converted again, for ``chip_smoke.py users``: the
    raw AV2 logs of ``RAW_AV2_LOGS`` (phase 29's seeds, ``points`` a
    sweep) and the raw nuScenes scene through the port's converters at 64
    and 32 rows, and phase 29's Waymo frames (``convert_waymo_corpus``),
    into ``root/NAME`` for each of ``USER_CORPORA``. Returns ``root``."""
    from range_view_3d_detection_torch.converters.av2 import export as av2_export
    from range_view_3d_detection_torch.converters.nuscenes import export as nusc_export
    from range_view_3d_detection_torch.utils.config import compose

    categories = compose(REPO / "conf", "rv-av2")["model"]["tasks"][0]
    for k, (split, (log_id, sweeps)) in enumerate(RAW_AV2_LOGS.items()):
        write_raw_av2_log(root / "raw_av2" / split / log_id, sweeps=sweeps,
                          seed=SEED + 290 + k, categories=categories, points=points)
    version = write_raw_nuscenes(root / "raw_nuscenes", seed=SEED + 292)
    av2_export.export_dataset(str(root / "raw_av2"), str(root / "av2"), height=64,
                              width=av2_width)
    nusc_export.export_dataset(str(root / "raw_nuscenes"), str(root / "nuscenes"),
                               version=version, height=32, width=nuscenes_width)
    convert_waymo_corpus(root / "waymo", *waymo_size)
    for raw in ("raw_av2", "raw_nuscenes"):
        shutil.rmtree(root / raw)
    return root


def _user_sync(device) -> None:
    import torch

    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.synchronize()


def user_train(name: str, corpus: Path, run_dir: Path, *, batch: int, pin_val: bool,
               device=None, overrides=()) -> dict:
    """Phase 49's training as its users run it: ``train.main([f"experiment=
    {name}", ...])`` in this process on ``corpus`` (``pin_val``: its val
    split pinned to train), one epoch with checkpointing on, at B =
    ``batch`` where the config's published batch_size is more than the
    corpus holds; on the Trainer's default device, the card, unless
    ``device`` names one (``++trainer.device``); ``overrides`` after the
    phase's. Gates: one step, every loss finite, a checkpoint of it, one
    shard a val sweep, every average of the dataset's protocol
    (``evaluate_run``: AV2's with its ROI for AV2) finite; for Waymo also
    the WOD evaluator (``evaluate_dirs``) with the recall-gap penalty and
    without, every mAP and mAPH finite. Returns the trainer (its ``fit``
    and ``validate`` timed) and the numbers."""
    from range_view_3d_detection_torch import train
    from range_view_3d_detection_torch.evaluate import evaluate_dirs
    from range_view_3d_detection_torch.evaluation.waymo_eval import mean_ap
    from range_view_3d_detection_torch.training import loop
    from range_view_3d_detection_torch.utils.config import compose

    published = int(compose(REPO / "conf", name)["model"]["batch_size"])
    argv = [f"experiment={name}", f"++dataset.root_dir={corpus}", f"++run_dir={run_dir}",
            "++trainer.max_epochs=1"]
    if batch != published:
        argv.append(f"++model.batch_size={batch}")
    if pin_val:
        argv.append("++dataset._val_dataset.split_name=train")
    if device is not None:
        argv.append(f"++trainer.device={device}")
    argv += list(overrides)
    made, walls = [], {}
    init = loop.Trainer.__init__

    def timed(fn, tag):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _user_sync(device)
            walls[tag] = walls.get(tag, 0.0) + time.perf_counter() - t0
            return out
        return run

    def capturing(self, *args, **kw):
        init(self, *args, **kw)
        self.fit, self.validate = timed(self.fit, "fit"), timed(self.validate, "validate")
        made.append(self)

    loop.Trainer.__init__ = capturing
    try:
        t0 = time.perf_counter()
        metrics = train.main(argv)
        _user_sync(device)
        train_s = time.perf_counter() - t0
    finally:
        loop.Trainer.__init__ = init
    check(len(made) == 1, f"{name}: train.main built {len(made)} Trainers")
    trainer = made[0]
    want = "cuda" if device is None else str(device)  # the entry point's default: the card
    check(trainer.device.type == want and trainer.batch_size == batch
          and trainer.state.step == 1,
          f"{name}: trained on {trainer.device} at B={trainer.batch_size}, step "
          f"{trainer.state.step}")
    losses = [json.loads(x).get("loss") for x in
              (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [x for x in losses if x is not None]
    check(len(losses) == 1 and all(math.isfinite(x) for x in losses), f"{name} losses {losses}")
    check(trainer.ckpt is not None and trainer.ckpt.latest_step() == 1
          and (run_dir / "checkpoints" / "step_1.pt").is_file(),
          f"{name}: no checkpoint of step 1 under {run_dir / 'checkpoints'}")
    shards = sorted((run_dir / "predictions").glob("*.feather"))
    check(len(shards) == len(trainer.val_ds), f"{name}: {len(shards)} shards for "
          f"{len(trainer.val_ds)} val sweeps")
    average = dict(metrics["AVERAGE_METRICS"])
    dataset = trainer.cfg["dataset"]["dataset_name"]
    if dataset == "waymo":
        gt = corpus / trainer.cfg["dataset"]["_val_dataset"].get("split_name", "val")
        for tag, penalty in (("penalty", True), ("no penalty", False)):
            m = evaluate_dirs(run_dir / "predictions", gt, "waymo", recall_gap_penalty=penalty)
            for level in (1, 2):
                for metric in ("AP", "APH"):
                    average[f"WOD m{metric}_L{level} {tag}"] = mean_ap(m, level=level,
                                                                      metric=metric)
    check(bool(average) and all(math.isfinite(v) for v in average.values()),
          f"{name} averages {average}")
    item = trainer.val_ds[0]
    return dict(trainer=trainer, train_s=train_s, fit_s=walls["fit"],
                val_s=walls["validate"], loss=losses[0], shards=len(shards), average=average,
                shape=tuple(item["features"].shape), dataset=dataset)


def user_predict(run_dir: Path, out_dir: Path, device=None) -> dict:
    """``predict.main(["--ckpt-dir", RUN, "--out-dir", OUT])`` (``--device``
    only when ``device`` names one): the run's latest checkpoint restored
    without training, its val split decoded on the Trainer's device, the
    shards written under ``out_dir`` each equal byte for byte to the
    Trainer's own validate shard of that sweep (same weights, same data,
    same process). Returns the shard count, their rows and the seconds."""
    from range_view_3d_detection_torch import predict
    from range_view_3d_detection_torch.utils.feather import read_feather

    argv = ["--ckpt-dir", str(run_dir), "--out-dir", str(out_dir)]
    if device is not None:
        argv += ["--device", str(device)]
    t0 = time.perf_counter()
    out = predict.main(argv)
    _user_sync(device)
    seconds = time.perf_counter() - t0
    mine = sorted(p.name for p in out.glob("*.feather"))
    theirs = sorted(p.name for p in (run_dir / "predictions").glob("*.feather"))
    check(out == out_dir and mine == theirs and mine,
          f"predict.main wrote {mine} under {out}, the Trainer {theirs}")
    for shard in mine:
        a, b = (out / shard).read_bytes(), (run_dir / "predictions" / shard).read_bytes()
        if a != b:
            got, want = read_feather(out / shard), read_feather(run_dir / "predictions" / shard)
            bad = [k for k in want if k not in got or got[k].tobytes() != want[k].tobytes()]
            check(False, f"predict.main's {shard} differs from the Trainer's in {bad}")
    rows = [len(read_feather(out / s)["score"]) for s in mine]
    return dict(shards=len(mine), rows=rows, seconds=seconds)


def user_export(run_dir: Path, art: Path, device=None) -> dict:
    """``export.main(["--run-dir", RUN, "--out", ART/bf16])`` and again with
    ``--quantize`` into ``ART/int8`` (calibrated at ``_eval_shape`` on the
    run's val items); ``--device`` only when ``device`` names one. Each
    artifact's ``meta.json`` records the run's dataset facts, its x_stride
    and padding mode the val split's, and its decoder the published
    ``min_confidence``. Returns the dataset facts and the seconds."""
    from range_view_3d_detection_torch import export
    from range_view_3d_detection_torch.training.builders import (
        build_dataset_config,
        build_decoder_config,
    )

    cfg = json.loads((run_dir / "config.json").read_text())
    val = build_dataset_config(cfg, "val")
    dec = build_decoder_config(cfg)
    seconds = {}
    for tag, extra in (("bf16", []), ("int8", ["--quantize"])):
        argv = ["--run-dir", str(run_dir), "--out", str(art / tag), *extra]
        if device is not None:
            argv += ["--device", str(device)]
        t0 = time.perf_counter()
        export.main(argv)
        _user_sync(device)
        seconds[tag] = time.perf_counter() - t0
        meta = json.loads((art / tag / "meta.json").read_text())
        ds = meta["dataset"]
        check(ds == export._dataset_meta_from_cfg(cfg)
              and (ds["x_stride"], ds["padding_mode"]) == (val.x_stride, val.padding_mode)
              and meta["decoder_config"]["min_confidence"] == dec.min_confidence
              and (art / tag / "quant.msgpack").is_file() == (tag == "int8"),
              f"{tag} artifact of {run_dir}: {meta['dataset']}, min_confidence "
              f"{meta['decoder_config']['min_confidence']}")
    return dict(meta=ds, seconds=seconds, eval_shape=export._eval_shape(cfg))


def lowered_confidence_predictor(art: Path, device) -> tuple:
    """The bf16 artifact ``art`` loaded with only its decoder's
    ``min_confidence`` lowered to 0, in memory: a one-step model keeps no
    box at the published 0.1, so this is where K2 sees a non-empty matrix.
    ``meta.json`` keeps the published value. Returns ``(predictor, the
    published decoder config)``."""
    import dataclasses

    from range_view_3d_detection_torch.export import load_artifact

    predictor, _, dec = load_artifact(art, device=device)
    predictor.decoder_cfg = dataclasses.replace(dec, min_confidence=0.0)
    return predictor, dec


def aot_export_job(art: Path, shape) -> tuple:
    """The export CLI's AOT step as a user types it, ``python -m
    range_view_3d_detection_torch.export --load ART --aot --batch B
    --height H --width W`` (``run_cli``'s record), on one host thread: the
    trace is Python, and these share the host with the phase's runs."""
    B, H, W = shape[:3]
    return run_cli("export --aot", ["range_view_3d_detection_torch.export", "--load", str(art),
                                    "--aot", "--batch", str(B), "--height", str(H),
                                    "--width", str(W)], env=_env(OMP_NUM_THREADS="1"))


def published_user_run(name: str, corpus: Path, work: Path, device, smi, pool, jobs) -> dict:
    """One config of phase 49 up to its artifacts (see the module
    docstring): train, export, predict; for a config of ``USER_AOT`` its
    AOT programs handed to ``pool`` (the export CLI beside the rest of the
    phase's runs) and added to ``jobs``, the phase's list of them, and for
    the first of ``USER_AOT`` the kernels-only process started, to serve
    the bf16 program once it is written. Returns its launches by step, run
    directory, artifacts, requests, AOT jobs and that process."""
    import numpy as np
    import torch

    from range_view_3d_detection_torch.data.dataset import RangeViewDataset
    from range_view_3d_detection_torch.training.builders import build_dataset_config

    _, split, shape, batch = PUBLISHED_USERS[name]
    run, art = work / name / "run", work / name / "artifacts"
    launches, laps = {}, Laps()

    def beside():
        return f"{sum(not j.done() for j in jobs)} AOT export processes running beside"

    torch.cuda.synchronize()
    reset_counts()
    tr = user_train(name, corpus, run, batch=batch, pin_val=split == "train")
    launches["train"] = read_counts()
    meta_stem = tr["trainer"].det_cfg.stem_type == "META"
    check(launches["train"]["nms_scan"] > 0
          and (launches["train"]["meta_kernel_fused"] > 0) == meta_stem,
          f"{name} train.main launches {launches['train']}")
    say(f"{name} (phase 49): train.main on {tr['trainer'].device}, B={batch} "
        f"{tr['shape']}, 1 step, fit {tr['fit_s']:.2f} s (loss {tr['loss']:.4f}), validate "
        f"{tr['val_s']:.2f} s ({tr['shards']} shards), train.main {tr['train_s']:.2f} s in all "
        f"({beside()}); {tr['dataset']} protocol (evaluate_run): "
        + ", ".join(f"{k} {v:.4f}" for k, v in tr["average"].items())
        + f"; checkpoint step 1; launches {launches['train']} on {smi}")
    del tr
    torch.cuda.empty_cache()
    laps("train")

    # The artifacts before predict.main, so that their AOT exports start
    # as early as they can.
    reset_counts()
    ex = user_export(run, art)
    launches["export"] = read_counts()
    say(f"{name} export.main --run-dir: bf16 {ex['seconds']['bf16']:.2f} s, --quantize "
        f"{ex['seconds']['int8']:.2f} s (calibrated at {ex['eval_shape']} on the run's val "
        f"items, {beside()}); meta.json dataset {ex['meta']}; launches {launches['export']} "
        f"on {smi}")
    # The requests: the corpus's own sweeps, padded and strided as the val
    # split does.
    cfg = json.loads((run / "config.json").read_text())
    requests = corpus_requests(RangeViewDataset(build_dataset_config(cfg, "val")), USER_PAIRS)
    aot, child = {}, None
    if name in USER_AOT:
        aot = {tag: pool.submit(aot_export_job, art / tag, shape) for tag in ("bf16", "int8")}
        jobs.extend(aot.values())
        if name == USER_AOT[0]:
            np.savez(art / "request.npz", *requests[0])
            path = art / "bf16" / f"predict_b{shape[0]}.pt2"
            ready = path.with_suffix(".ready")

            def written(job):
                if not job.cancelled() and job.exception() is None and job.result()[2] == 0:
                    ready.touch()

            child = aot_child_start(art, path, ready)
            aot["bf16"].add_done_callback(written)
    laps("export")

    reset_counts()
    pr = user_predict(run, work / name / "predict")
    launches["predict"] = read_counts()
    check(launches["predict"]["nms_scan"] > 0
          and (launches["predict"]["meta_kernel_fused"] > 0) == meta_stem,
          f"{name} predict.main launches {launches['predict']}")
    say(f"{name} predict.main --ckpt-dir: {pr['shards']} shards ({pr['rows']} rows) equal byte "
        f"for byte to the Trainer's validate shards, {pr['seconds']:.2f} s ({beside()}); "
        f"launches {launches['predict']} on {smi}")
    laps("predict")
    say(f"phase 49 {name} run: {laps}")
    return dict(launches=launches, aot=aot, child=child, run=run, art=art, meta=ex["meta"],
                corpus=corpus, split=split, shape=shape, requests=requests)


def published_user_aot(name: str, r: dict, device, smi) -> None:
    """The AOT programs the export CLI wrote for one config of phase 49
    (``published_user_run``'s ``r``), each against ``load_artifact`` on
    the config's requests, and the kernels-only process's result on the
    bf16 one. Adds their launches to ``r``."""
    r["launches"]["AOT"] = dict.fromkeys(read_counts(), 0)
    for tag in ("bf16", "int8"):
        wall = r["aot"][tag].result()[-1]
        path = r["art"] / tag / f"predict_b{r['shape'][0]}.pt2"
        check(path.is_file(), f"{name}: the export CLI wrote no {path}")
        launches, want = aot_check(r["art"], tag, path, r["requests"], device, smi,
                                   f"phase 49, {name}", f"the export CLI's --aot {wall:.1f} s "
                                   "beside the phase's runs", reps=USER_AOT_REPS)
        for k, v in launches.items():
            r["launches"]["AOT"][k] += v
        if tag == "bf16" and r["child"] is not None:
            aot_child_finish(r["child"], want, f"phase 49, {name}",
                             "from its start beside the phase's runs")
        path.unlink()


def published_user_deploy(name: str, r: dict, device, smi) -> None:
    """One config of phase 49 deployed (see the module docstring): the run
    ``r`` (``published_user_run``'s) restored in memory against its
    artifacts (``deploy_artifacts``), and K2 on a non-empty matrix. Adds
    the launches and kernel times to ``r``."""
    import torch

    from range_view_3d_detection_torch.export import (
        _calibration_batches_from_run,
        _restore_from_run_dir,
    )
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.ops import nms as nms_ops

    run, art, meta, shape, launches = r["run"], r["art"], r["meta"], r["shape"], r["launches"]
    requests = r["requests"]
    laps = Laps()
    # The reference: the run restored in memory; the clouds: the corpus's
    # own returns of the requests' sweeps.
    model, det_cfg, dec_cfg = _restore_from_run_dir(run, device)
    calib = _calibration_batches_from_run(run)
    clouds = corpus_clouds(r["corpus"], POINTS_EXTRA[meta["dataset_name"]],
                           height=meta["height"], pairs=USER_PAIRS, split=r["split"])
    deployed, times = deploy_artifacts(
        f"{name} restored", art, model, det_cfg, dec_cfg, meta, requests, calib, clouds,
        device, smi, shape=shape, source="the restored model", timed=True)
    launches.update(deployed)
    del model, calib, clouds
    laps("deploy")

    # K2 on a non-empty matrix: the bf16 artifact with min_confidence 0.
    lowered, published = lowered_confidence_predictor(art / "bf16", device)
    seen = {}

    def capture_k2(*args, **kw):
        seen.setdefault("K2", (tuple(a.clone() for a in args), kw))
        return nms_scan(*args, **kw)

    reset_counts()
    nms_ops.nms_scan = capture_k2
    try:
        result = lowered(*requests[0])
    finally:
        nms_ops.nms_scan = nms_scan
    torch.cuda.synchronize()
    launches["min_confidence 0"] = read_counts()
    k2_args, k2_kw = seen.pop("K2")
    k2_err = check_k2(f"{name} min_confidence 0 request", k2_args)
    live = int(nms_scan(*k2_args, **k2_kw)[0].sum())
    valid = int(k2_args[2].sum())
    on_disk = json.loads((art / "bf16" / "meta.json").read_text())["decoder_config"]
    check(live > 0 and int(result.keep.sum()) > 0
          and on_disk["min_confidence"] == published.min_confidence > 0,
          f"{name} min_confidence 0: {live} kept of {valid}, artifact {on_disk}")
    times["K2 nonempty ms"] = cuda_ms(lambda: nms_scan(*k2_args, **k2_kw), reps=20)
    k2_flops, k2_bytes = k2_cost(shape[0], k2_args[0].shape[-1], live, k2_args[3].shape[-1])
    times["K2 nonempty bound"] = bound_ms(k2_flops, H100_FP32_FLOPS, k2_bytes)
    say(f"{name} K2 cap {k2_args[0].shape[-1]} on a non-empty matrix (one request of the bf16 "
        f"artifact with the decoder's min_confidence lowered to 0 in memory; meta.json keeps "
        f"{on_disk['min_confidence']}): {live} kept of {valid} valid, merged max|diff| "
        f"{k2_err:.3g}; {times['K2 nonempty ms']:.4f} ms eager, bound "
        f"{times['K2 nonempty bound'][0] * 1e3:.2f} us ({times['K2 nonempty bound'][1]}); "
        f"launches {launches['min_confidence 0']} on {smi}")
    del lowered, result, seen, k2_args
    torch.cuda.empty_cache()
    laps("min_confidence 0")
    say(f"phase 49 {name} deployment: {laps}")
    r["times"] = times


def published_users_phase(device, smi, corpora: Path | None = None) -> dict:
    """Phase 49 (see the module docstring) on ``corpora``, phase 29's
    converted corpora (None: converted here). Returns each kernel's
    launches over the phase's paths."""
    import torch

    t0 = time.perf_counter()
    laps = Laps()
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-users-"))
    runs, jobs = {}, []
    try:
        source = "phase 29's"
        if corpora is None:
            corpora, source = convert_user_corpora(work / "corpora"), "converted here"
            laps("conversion")
        say(f"published experiments as their users run them (phase 49, {source} corpora), "
            f"cuts: " + "; ".join(published_user_cuts()))
        with concurrent.futures.ThreadPoolExecutor(2 * len(USER_AOT)) as pool:
            try:
                # Every run and its artifacts first, the AOT exports and the
                # kernels-only process beside the later runs; nothing is
                # timed per request until they have ended.
                for name, (corpus, *_) in PUBLISHED_USERS.items():
                    runs[name] = published_user_run(name, corpora / corpus, work, device, smi,
                                                    pool, jobs)
                    torch.cuda.empty_cache()
                laps("runs")
                concurrent.futures.wait(jobs)
                for name in USER_AOT:
                    for job in runs[name]["aot"].values():
                        _, args, rc, out, err, _ = job.result()
                        check(rc == 0, f"{name} {' '.join(args)}: rc {rc}\n{out[-2000:]}\n"
                              f"{err[-2000:]}")
                    if runs[name]["child"] is not None:
                        aot_child_wait(runs[name]["child"])
                laps("the AOT exports' end")
                for name in USER_AOT:
                    published_user_aot(name, runs[name], device, smi)
                    torch.cuda.empty_cache()
                laps("AOT")
                for name, r in runs.items():
                    published_user_deploy(name, r, device, smi)
                    torch.cuda.empty_cache()
                    laps(name)
            finally:
                for r in runs.values():
                    child = r["child"]
                    if child is not None and child["proc"].poll() is None:
                        child["proc"].kill()
                        child["proc"].wait()
                for job in jobs:
                    job.cancel()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {name: r["launches"] for name, r in runs.items()}
    times = {name: {k: v for k, v in r["times"].items() if k != "K3"} | {
        "K3 eager": r["times"]["K3"][0]["eager"], "K3 graph": r["times"]["K3"][0]["graph"],
        "K3 bound": r["times"]["K3"][0]["bound"]} for name, r in runs.items()}
    say(f"phase 49 published users: {time.perf_counter() - t0:.0f} s ({laps})")
    say("published user launches (phase 49) " + json.dumps(launches))
    say("published user times (phase 49, ms; host clock for the modes, CUDA events for the "
        f"kernels; nothing ran beside) on {smi} " + json.dumps(times))
    return {k: sum(m[k] for modes in launches.values() for m in modes.values())
            for k in kernel_counts()}


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
    laps = Laps()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    gen = torch.Generator().manual_seed(SEED)

    # 1. Device.
    kind = torch.cuda.get_device_name(0)
    smi = card_smi()
    say(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"nvidia-smi: {smi}")

    # 2. Build.
    lib = _build.library()
    say(f"build: {lib.path} in {lib.build_seconds:.1f} s")
    check_spills(lib)
    laps("1-2 device, build")

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
    # Past the configs' widths, in bf16 and fp32, from a generator of its
    # own (the main path's weights stay as they were).
    k1_any = check_k1_any_c(torch.Generator().manual_seed(SEED + 17), device)
    k1_err = max(k1_err, k1_any["torch.bfloat16"])
    laps("3 K1")

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
    # Payloads of other widths; caps past 4096 are phase 39's.
    k2_err = max(k2_err, check_k2_any_p(gen_k2, device))
    laps("4 K2")

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
    laps("5 main path")

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
    k2_flops, k2_bytes = k2_cost(2, cap, live)
    k2_bound, k2_by = bound_ms(k2_flops, H100_FP32_FLOPS, k2_bytes)
    # The greedy keep's own floor: the images run side by side, each a chain
    # of one shared-memory round trip a live step.
    k2_chain_ms = int(live_per_image.max()) * SMEM_STEP_S * 1e3
    k2_phases = kernel_device_us(lambda: nms_scan(*k2_in, **nms_kw),
                                 ("nms_mask_kernel", "nms_keep_kernel", "nms_merge_kernel"))
    # Phase 39's split of K2 at cap 9216, taken here: late in the process
    # the profiler records no kernels.
    k2_big_split = k2_big_phases(device)
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
    laps("6 timings")
    kernels += int8_phases(predictor, requests, bf16_results, bf16_heads, cfg, dec,
                           device, gen, smi)
    laps("7-11 int8")
    del predictor, model, results, bf16_results, bf16_heads, out, made, k1_in, k1_waymo, k2_in
    torch.cuda.empty_cache()
    step_ms = training_phases(device, smi)
    torch.cuda.empty_cache()
    laps("12-16 training")
    remat_ms = remat_phase(device, smi)
    torch.cuda.empty_cache()
    laps("22 remat")
    trainer_launches, trainer_work = trainer_phase(device, smi)
    torch.cuda.empty_cache()
    laps("17 Trainer")
    distributed_launches = distributed_phase(device, smi, trainer_work)
    laps("23 distributed")
    int8_launches, qat_launches, phase18 = overfit_phase(device, smi)
    torch.cuda.empty_cache()
    laps("18, 24 overfit, QAT")
    try:
        serving_launches = serving_phases(art_dir, requests, phase5_results, phase5_heads,
                                          cfg, dec, device, smi)
        torch.cuda.empty_cache()
        laps("19-21 serving")
        width_launches = width_phase(art_dir / "bf16", device, smi)
        laps("25 width")
        chunk_launches = chunk_phase(art_dir / "bf16", requests, device, smi)
        laps("26 chunk")
        aot_launches = aot_phase(art_dir, requests, device, smi)
        laps("27 AOT")
    finally:
        shutil.rmtree(art_dir, ignore_errors=True)
    range_partition_phase(device, smi)
    torch.cuda.empty_cache()
    laps("28 range partition")
    corpora = Path(tempfile.mkdtemp(prefix="chip-smoke-corpora-"))
    converted_launches = converted_phase(device, smi, keep=corpora)
    torch.cuda.empty_cache()
    laps("29 converted")
    bench_launches = bench_phase(device, kind, smi)
    torch.cuda.empty_cache()
    laps("30 bench")
    tool_launches = tools_phases(device, kind, smi, fwd_ms=fwd_ms, dec_ms=dec_ms,
                                 step_ms=step_ms, remat_ms=remat_ms["B=2 remat"],
                                 phase18=phase18)
    torch.cuda.empty_cache()
    laps("31-38 tools")
    slice_counts = slice_phases(device, smi, tool_launches["dryrun"], k2_big_split,
                                tool_launches["hw_beside"])
    torch.cuda.empty_cache()
    laps("39-42")
    conv_shapes_launches = conv_shapes_phase(device, smi)
    torch.cuda.empty_cache()
    laps("43 conv shapes")
    shapes_entries = kernel_shapes_phase(device, smi)
    laps("44 kernel shapes")
    configs_phase(45, device, smi)
    torch.cuda.empty_cache()
    laps("45 rv-waymo")
    config_launches = configs_phase(46, device, smi)
    torch.cuda.empty_cache()
    laps("46 base-av2, rv-av2-fast")
    config_launches.update(configs_phase(47, device, smi))
    torch.cuda.empty_cache()
    laps("47 rv-nuscenes, base-waymo")
    try:
        waymo_user_launches = waymo_user_phase(device, smi, corpora / "waymo")
        torch.cuda.empty_cache()
        laps("48 Waymo user path")
        published_user_launches = published_users_phase(device, smi, corpora)
    finally:
        shutil.rmtree(corpora, ignore_errors=True)
    torch.cuda.empty_cache()
    laps("49 published users")
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
        k["anycap_launches"] = slice_counts["anycap"][k["name"]]
        k["hw_tools_launches"] = slice_counts["hw_tools"][k["name"]]
        k["conv_shapes_launches"] = conv_shapes_launches[k["name"]]
        k["waymo_user_launches"] = waymo_user_launches[k["name"]]
        k["published_user_launches"] = published_user_launches[k["name"]]
        for name, modes in config_launches.items():  # phases 46-47's served requests
            k[f"{name.replace('-', '_')}_launches"] = sum(
                counts[k["name"]] for tag, counts in modes.items() if not tag.startswith("bench"))
        if k["name"] == "nms_scan":
            k.update(slice_counts["k2_big"])
    kernels += shapes_entries
    say(f"chip_smoke: by phase {laps}")
    say(f"chip_smoke: total {time.perf_counter() - t_start:.0f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def card_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def card_start():
    """The subcommands' start on the first card: TF32 off, the port package
    of this checkout importable, the device and the card's name and power
    limit said, the kernels built. Returns ``(device, smi)``, or None
    without a CUDA device (said on stderr)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return None
    sys.path.insert(0, str(REPO))
    from range_view_3d_detection_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = card_smi()
    say(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {smi}")
    lib = _build.library()
    say(f"build: {lib.path} in {lib.build_seconds:.1f} s")
    return device, smi


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
    """``chip_smoke.py tools``: the build, then phases 30-42 alone (phase 18's
    run and phase 6's forward and decode times made here; phases 16's and
    22's step times not measured)."""
    import torch

    t_start = time.perf_counter()
    start = card_start()
    if start is None:
        return 1
    device, smi = start
    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.models.decoder import DecoderConfig, decode

    kind = torch.cuda.get_device_name(0)
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
    torch.cuda.empty_cache()
    slice_counts = slice_phases(device, smi, tool_launches.pop("dryrun"),
                                hw_beside=tool_launches.pop("hw_beside"))
    say(json.dumps({"bench": bench_launches, **tool_launches, **slice_counts}))
    say(f"chip_smoke tools: total {time.perf_counter() - t_start:.0f} s")
    return 0


def conv_shapes_main() -> int:
    """``chip_smoke.py conv-shapes``: the build, then phase 43 alone."""
    t_start = time.perf_counter()
    start = card_start()
    if start is None:
        return 1
    device, smi = start
    say(json.dumps({"conv_shapes_launches": conv_shapes_phase(device, smi)}))
    say(f"chip_smoke conv-shapes: total {time.perf_counter() - t_start:.0f} s")
    return 0


def capture_k3(predictor, request) -> tuple:
    """Serve ``request`` once, recording every K3 launch (phase 8): the
    first inputs of each distinct (Cin, Cout, W, stride) with its launches
    a request, ``{key: {"inputs": (x, w, dq, in_scale), "out_dtype",
    "per_request"}}``, and counts of launches, of those given the
    unquantized activation and of those given NHWC-contiguous memory."""
    import torch

    from range_view_3d_detection_torch.kernels.conv import conv3x3_i8_fused
    from range_view_3d_detection_torch.models import blocks, quantized

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
        predictor(*request)
    finally:
        blocks.conv3x3_i8_fused = quantized.conv3x3_i8_fused = conv3x3_i8_fused
    torch.cuda.synchronize()
    return captured, k3_in


def shipped_round(tree: Path) -> int:
    """``chip_smoke.py shipped-round TREE``: one round of
    ``shipped-times``, with the port package of the checkout TREE (its
    wrappers, and its ``csrc`` built into its own ``build/``): K1 at the
    flagship stem (2, 64, 1808, 256) and the Waymo stem (2, 64, 2656, 128),
    K4 at the flagship stem and at C = 128 (its two bf16 wgmma instances),
    K2 at B=2 cap 1024, and K3 summed over the 62
    launches of one served int8 request, each by CUDA events around eager
    launches (phase 6's method) and by CUDA-graph replay. Prints one line,
    ``shipped_round {json}``."""
    import torch

    sys.path.insert(0, str(tree.resolve()))
    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.kernels import _build
    from range_view_3d_detection_torch.kernels.conv import conv3x3_i8_fused
    from range_view_3d_detection_torch.kernels.nms import nms_scan
    from range_view_3d_detection_torch.kernels.stem import (
        meta_kernel_fused,
        meta_kernel_fused_i8,
    )
    from range_view_3d_detection_torch.models.decoder import DecoderConfig

    check(Path(serving.__file__).resolve().is_relative_to(tree.resolve()),
          f"the port package came from {serving.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    _build.library()
    gen = torch.Generator().manual_seed(SEED)
    k1_in = stem_inputs(2, 64, 1808, 256, gen, device)
    waymo_in = stem_inputs(2, 64, 2656, 128, gen, device)
    k4_in = k4_inputs(2, 64, 1808, 256, gen, device)
    k4_128 = k4_inputs(2, 64, 1808, 128, gen, device)
    k2_in = nms_case(2, 1024, gen, device)
    nms_kw = dict(iou_threshold=0.3, merge_threshold=0.5)
    request = serving._sample_inputs(2, 64, 1808, 5, seed=0)
    predictor = flagship_predictor(serving._flagship_config(), DecoderConfig(), device,
                                   gen, request)
    k3_in = capture_k3(predictor.quantize([request], scope="full"), request)[0]
    del predictor
    n_k3 = sum(e["per_request"] for e in k3_in.values())
    check(n_k3 == 62, f"K3 launches a served int8 request: {n_k3}")
    calls = {
        "K1": lambda: meta_kernel_fused(**k1_in),
        "K1 Waymo": lambda: meta_kernel_fused(**waymo_in),
        "K2": lambda: nms_scan(*k2_in, **nms_kw),
        "K4": lambda: meta_kernel_fused_i8(**k4_in),
        "K4 C=128": lambda: meta_kernel_fused_i8(**k4_128),
    }
    row = {}
    for name, fn in calls.items():
        row[name] = cuda_ms(fn, reps=20)
        row[name + " graph"] = graph_ms(fn)
    row["K3"] = row["K3 graph"] = 0.0
    for key, e in k3_in.items():
        def k3(e=e, key=key):
            return conv3x3_i8_fused(*e["inputs"][:3], stride_w=key[3],
                                    out_dtype=e["out_dtype"], in_scale=e["inputs"][3])
        row["K3"] += e["per_request"] * cuda_ms(k3, reps=10)
        row["K3 graph"] += e["per_request"] * graph_ms(k3)
    say("shipped_round " + json.dumps(row))
    return 0


def shipped_times_main(parent: Path) -> int:
    """``chip_smoke.py shipped-times PARENT``: the four kernels at their
    shipped shapes with this checkout's port package and with PARENT's
    (another checkout of the repository), each round a process of its own
    (``shipped_round``), in turns: parent, this, this, parent. Prints each
    round and each version's medians, eager and by graph replay, with the
    card's name and power limit."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 1
    smi = card_smi()
    trees = {"parent": parent, "this": REPO}
    times = {"parent": [], "this": []}
    for version in ("parent", "this", "this", "parent"):
        run = subprocess.run(
            [sys.executable, str(REPO / "chip_smoke.py"), "shipped-round",
             str(trees[version])],
            capture_output=True, text=True, timeout=900,
        )
        lines = [x for x in run.stdout.splitlines() if x.startswith("shipped_round ")]
        check(run.returncode == 0 and len(lines) == 1,
              f"shipped-round {version} failed:\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
        row = json.loads(lines[0].split(" ", 1)[1])
        times[version].append(row)
        say(f"{version}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()) + " ms")
    for name in times["this"][0]:
        med = {v: statistics.median(r[name] for r in rows) for v, rows in times.items()}
        say(f"shipped {name}: parent {med['parent']:.4f} ms, this {med['this']:.4f} ms "
            f"({100 * (med['this'] / med['parent'] - 1):+.2f}%) on {smi}")
    return 0


def kernel_shapes_main() -> int:
    """``chip_smoke.py kernel-shapes``: the build, the kernels' checks past
    the configs' shapes (phases 3, 4, 7 and 10's) and phase 44 alone."""
    import torch

    t_start = time.perf_counter()
    start = card_start()
    if start is None:
        return 1
    device, smi = start
    from range_view_3d_detection_torch.kernels import _build

    check_spills(_build.library())
    gen = torch.Generator().manual_seed(SEED + 17)
    check_k1_any_c(gen, device)
    check_k2_any_p(gen, device)
    k3_odd_shapes(K3_TAIL_SHAPES, gen, device)
    check_k4_any_c(gen, device)
    say(json.dumps({"kernels": kernel_shapes_phase(device, smi)}))
    say(f"chip_smoke kernel-shapes: total {time.perf_counter() - t_start:.0f} s")
    return 0


def waymo_user_main() -> int:
    """``chip_smoke.py waymo-user``: the device, the build and its spill
    gate (phases 1-2), then phase 48 alone on a corpus converted here."""
    t_start = time.perf_counter()
    start = card_start()
    if start is None:
        return 1
    device, smi = start
    from range_view_3d_detection_torch.kernels import _build

    check_spills(_build.library())
    say(json.dumps({"waymo_user_launches": waymo_user_phase(device, smi)}))
    say(f"chip_smoke phase 48: total {time.perf_counter() - t_start:.0f} s")
    return 0


def users_main() -> int:
    """``chip_smoke.py users``: the device, the build and its spill gate
    (phases 1-2), then phase 49 alone on corpora converted here."""
    t_start = time.perf_counter()
    start = card_start()
    if start is None:
        return 1
    device, smi = start
    from range_view_3d_detection_torch.kernels import _build

    check_spills(_build.library())
    say(json.dumps({"published_user_launches": published_users_phase(device, smi)}))
    say(f"chip_smoke phase 49: total {time.perf_counter() - t_start:.0f} s")
    return 0


def configs_main(phase: int) -> int:
    """``chip_smoke.py waymo`` (phase 45) and ``chip_smoke.py configs
    [PHASE]`` (46, or the phase named: 45, 46 or 47): the device, the
    build and its spill gate (phases 1-2), then the phase alone."""
    check(phase in {v[0] for v in PUBLISHED_CONFIGS.values()},
          f"configs: no phase {phase} among {sorted({v[0] for v in PUBLISHED_CONFIGS.values()})}")
    t_start = time.perf_counter()
    start = card_start()
    if start is None:
        return 1
    device, smi = start
    from range_view_3d_detection_torch.kernels import _build

    check_spills(_build.library())
    configs_phase(phase, device, smi)
    say(f"chip_smoke phase {phase}: total {time.perf_counter() - t_start:.0f} s")
    return 0


# The subcommands: the first argument names one, the rest are its own.
SUBCOMMANDS = {
    "kernel-shapes": lambda args: kernel_shapes_main(),
    "shipped-times": lambda args: shipped_times_main(Path(args[0])),
    "shipped-round": lambda args: shipped_round(Path(args[0])),
    "tools": lambda args: tools_main(),
    "conv-shapes": lambda args: conv_shapes_main(),
    "compile-decode": lambda args: compile_decode_main(),
    "train-rank": train_rank,
    "width-rank": width_rank,
    "convert": convert_rank,
    "waymo": lambda args: configs_main(45),
    "configs": lambda args: configs_main(int(args[0]) if args else 46),
    "waymo-user": lambda args: waymo_user_main(),
    "users": lambda args: users_main(),
}


def run(argv) -> int:
    """The subcommand ``argv`` (the arguments after the script's name)
    names, or the whole run."""
    if argv and argv[0] in SUBCOMMANDS:
        return SUBCOMMANDS[argv[0]](argv[1:])
    return main()


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
