#!/usr/bin/env python3
"""Time K2, the greedy NMS scan, beside other revisions of its source.

    python3 chip_probe_k2.py [--cap 9216] [--batch 2] [--source PATH ...]
                             [--trace] [--reps 10]

Builds ``csrc/nms_scan.cu`` as it is, and each ``--source`` (a revision
of that file written out with ``git show REV:PATH``), with ``nvcc`` for
``sm_90a`` into its own library under ``build/k2_probe/``, beside this
checkout's ``csrc/hopper.cuh``. Each build runs its C entry point
``rv3d_nms_scan`` on ``chip_smoke.nms_case(--batch, --cap)`` in WEIGHTED
mode with the plan this checkout's ``k2_plan`` names and a scratch large enough for
either layout (the ``seen`` words or the ``killed_at`` column). Its
``keep`` must equal ``nms_scan_plain``'s bit for bit and its ``merged``
come within 1e-4. Then all builds are timed in turns (in the given order,
then reversed): CUDA events around eager launches (median of ``--reps``)
and CUDA-graph replay (10 calls), the methods of ``chip_smoke.py``, and
the device time of each of K2's kernels (torch.profiler). Prints the
card's name and power limit. One card; no CPU path.

``--trace`` adds, for each build whose kernel holds the anchors, a
variant patched at fixed anchors (``chip_probe_k1.patch``; a variant
whose anchor is missing is skipped with a line that says so) that
records ``clock64`` stamps of one step at a time in the keep past cap
4096, and reports the mean split of a step:

- ``nms_keep_big_kernel`` (the shared-memory keep before the lookahead
  design), thread 0 at each step of a slab's column chunk: ring wait,
  the block barrier, the chain (the diagonal's chunk), the barrier after
  it, the OR pass with the ``seen`` stores, and the keep store with the
  last barrier. A second variant without the ``seen`` stores
  (``no-seen``, its ``keep`` checked, its ``merged`` not) gives their
  share by difference.
- ``nms_keep_ahead_kernel``: the chain warp's lane 0 a slab (the
  diagonal words' loads and staging, the wait for the word that the updaters
  finish, the chain, the publish, the fold and keep store) and the
  first updater thread a slab (the wait for the kept bits, the ring wait,
  the OR pass, the release of its first box).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

from chip_probe_k1 import MissingAnchor, patch

REPO = Path(__file__).resolve().parent
SOURCE = REPO / "range_view_3d_detection_torch/csrc/nms_scan.cu"
OUT = REPO / "build/k2_probe"
KERNELS = ("nms_mask_kernel", "nms_keep", "nms_killed_at_kernel", "nms_merge_kernel")
SLOTS = 10  # stamps a step (a slab, or a slab's chunk)

HEAD = (
    "__device__ unsigned long long* g_k2_trace;\n"
    "__device__ int g_k2_slots;\n"
    'extern "C" int rv3d_k2_set_trace(void* p, int slots) {\n'
    "  cudaError_t e = cudaMemcpyToSymbol(g_k2_trace, &p, sizeof(p));\n"
    "  if (e != cudaSuccess) return (int)e;\n"
    "  return (int)cudaMemcpyToSymbol(g_k2_slots, &slots, sizeof(slots));\n"
    "}\n"
    "__device__ __forceinline__ unsigned long long k2_gtime() {\n"
    "  unsigned long long t;\n"
    '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
    "  return t;\n"
    "}\n"
    "#define K2_AT(k) g_k2_trace[(size_t)blockIdx.x * g_k2_slots + (k)]\n"
)


def _head(src: str) -> str:
    return patch(src, "namespace {\n\nconstexpr int kP = 9;",
                 HEAD + "\nnamespace {\n\nconstexpr int kP = 9;")


def traced_big(src: str, seen: bool = True) -> str:
    """``nms_keep_big_kernel`` with thread 0's stamps: slots 0/1 clock64 and
    globaltimer at the start, 2/3 at the end; at 8 + SLOTS t + k for step t: 0
    the step's start, 1 after the ring wait, 2 after the block barrier,
    3 the chain's end and 4 after the barrier that follows it (the
    diagonal's chunk only), 5 the OR pass's end, 6 after the last
    barrier. ``seen=False`` drops the ``seen`` stores."""
    src = _head(src)
    t = "if (tid == 0) K2_AT(8 + %d * t + {k}) = clock64();\n" % SLOTS
    src = patch(src, "  for (int t = 0; t < kStages - 1; ++t) prefetch(t);\n\n"
                "  uint32_t kept = 0;\n",
                "  for (int t = 0; t < kStages - 1; ++t) prefetch(t);\n"
                "  if (tid == 0) { K2_AT(0) = clock64(); K2_AT(1) = k2_gtime(); }\n\n"
                "  uint32_t kept = 0;\n")
    src = patch(src, "    prefetch(t + kStages - 1);  // refills the buffer step t - 1 left\n"
                "    cp_async_wait<kStages - 1>();\n"
                "    __syncthreads();  // every thread's copies of step t are in;"
                " rem is current\n",
                "    " + t.format(k=0)
                + "    prefetch(t + kStages - 1);  // refills the buffer step t - 1 left\n"
                "    cp_async_wait<kStages - 1>();\n    " + t.format(k=1)
                + "    __syncthreads();  // every thread's copies of step t are in;"
                " rem is current\n    " + t.format(k=2))
    barrier = "      __syncthreads();  // rem[s] read by every thread before its owner ORs\n"
    src = patch(src, barrier, "      " + t.format(k=3) + barrier + "      " + t.format(k=4))
    src = patch(src, "    if (j == nchunks - 1 && tid < 32) {\n",
                "    " + t.format(k=5) + "    if (j == nchunks - 1 && tid < 32) {\n")
    src = patch(src, "    __syncthreads();  // step t's buffer read before it is refilled\n  }\n"
                "  cp_async_wait<0>();\n}\n",
                "    __syncthreads();  // step t's buffer read before it is refilled\n"
                "    " + t.format(k=6) + "  }\n"
                "  cp_async_wait<0>();\n"
                "  if (tid == 0) { K2_AT(2) = clock64(); K2_AT(3) = k2_gtime(); }\n}\n")
    if not seen:
        src = patch(src, "// the same in every thread\n"
                    "          if (take) seen_w[(size_t)r * nwords] = r_k;\n",
                    "// the same in every thread\n")
    return src


def traced_ahead(src: str) -> str:
    """``nms_keep_ahead_kernel`` with stamps of the chain warp's lane 0 at
    8 + SLOTS s + k for slab s (0 the slab's start, 1 after the diagonal
    words' loads and staging, 2 after the wait for the updaters' word, 3 the
    chain's end, 4 the kept bits published) and of the first updater
    thread at 8 + SLOTS s + 5..8 (5 after the wait for the kept bits, 6
    after the ring wait of the slab's first box, 7 after its OR pass, 8
    after its release); 0/1 clock64 and globaltimer at the chain's start,
    2/3 at its end, 4 the updater's end."""
    src = _head(src)
    c = "if (lane == 0) K2_AT(8 + %d * s + {k}) = clock64();\n" % SLOTS
    u = "if (tid == kUpdaterBase) K2_AT(8 + %d * t + {k}) = clock64();\n" % SLOTS
    src = patch(src, "    // The chain warp.\n",
                "    // The chain warp.\n"
                "    if (lane == 0) { K2_AT(0) = clock64(); K2_AT(1) = k2_gtime(); }\n")
    for k, anchor in enumerate((
            "      // Slab s's diagonal words d[r] = mask[32 s + r][s] in every lane, from\n",
            "      // Word s from the updaters: every kept row of slab s - 2 and before.\n",
            "      // The greedy chain over the slab's 32 rows, in registers.\n",
            "      // Publish the slab's kept rows to the updaters.\n",
            "      // Slab s's own rows into word s + 1, for the next slab.\n")):
        src = patch(src, anchor, "      " + c.format(k=k) + anchor)
    updaters = "  } else {\n    // The updaters: thread u owns words w = u (mod kUpdaters).\n"
    src = patch(src, "    }\n" + updaters,
                "    }\n    if (lane == 0) { K2_AT(2) = clock64(); K2_AT(3) = k2_gtime(); }\n"
                + updaters)
    src = patch(src, "      const uint32_t kept = kept_q[t % kKeptSlots];\n",
                "      const uint32_t kept = kept_q[t % kKeptSlots];\n      " + u.format(k=5))
    src = patch(src, "        mbar_wait(&full[st], ph);\n",
                "        mbar_wait(&full[st], ph);\n        if (k == 0) " + u.format(k=6))
    src = patch(src, "        __syncwarp();\n        if (lane == 0) mbar_arrive(&empty[st]);"
                "  // box read by the warp\n",
                "        if (k == 0) " + u.format(k=7)
                + "        __syncwarp();\n        if (lane == 0) mbar_arrive(&empty[st]);"
                "  // box read by the warp\n        if (k == 0) " + u.format(k=8))
    src = patch(src, "    }\n  }\n}\n\n// Phase 3 past cap 4096",
                "    }\n    if (tid == kUpdaterBase) K2_AT(4) = clock64();\n"
                "  }\n}\n\n// Phase 3 past cap 4096")
    return src


def make_variants(base: str, trace: bool, tag: str = "as is") -> tuple:
    """``({name: (source, tracer)}, [skip messages])``: the source as it
    is, and with ``trace`` each traced variant whose anchors it holds;
    ``tracer`` is ``None``, ``"big"`` or ``"ahead"``."""
    variants, skipped = {tag: (base, None)}, []
    if not trace:
        return variants, skipped
    makers = (("trace", traced_big, "big"),
              ("trace no-seen", lambda s: traced_big(s, seen=False), "big"),
              ("trace", traced_ahead, "ahead"))
    for name, make, kind in makers:
        if f"nms_keep_{kind}_kernel" not in base:
            continue
        try:
            variants[f"{tag}, {name}"] = (make(base), kind)
        except MissingAnchor as e:
            skipped.append(f"{tag}, {name}: skipped, {e}")
    return variants, skipped


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, action="append", default=[])
    ap.add_argument("--cap", type=int, default=9216)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if args.cap < 1 or args.batch < 1 or args.reps < 1:
        ap.error("--cap, --batch and --reps must be positive")
    return args


def trace_slots(cap: int) -> int:
    """Stamps a block: the header's 8 and ``SLOTS`` for each of at most
    two steps a slab (a slab's column chunks past 256 words)."""
    nwords = (cap + 31) // 32
    return 8 + SLOTS * nwords * max(1, -(-((nwords + 3) // 4 * 4) // 256))


def report_trace(name: str, kind: str, t, B: int, smi: str) -> None:
    import numpy as np

    t = t.reshape(B, -1).astype(np.float64)
    ghz = np.median((t[:, 2] - t[:, 0]) / (t[:, 3] - t[:, 1]))
    us = lambda c: c / ghz / 1e3  # noqa: E731
    steps = t[:, 8:].reshape(B, -1, SLOTS)
    live = steps[:, :, 0] > 0
    n = int(live.sum(1).max())
    st = steps[:, :n]
    total = us(np.median(t[:, 2] - t[:, 0]))
    print(f"{name}: SM clock {ghz:.3f} GHz; keep {total:.2f} us a block (median of {B}), "
          f"{n} steps, mean per step on {smi}:")
    if kind == "big":
        diag = st[:, :, 3] > 0
        after_chain = np.where(diag, st[:, :, 4], st[:, :, 2])
        parts = {
            "ring wait (prefetch issue, cp.async wait)": st[:, :, 1] - st[:, :, 0],
            "block barrier": st[:, :, 2] - st[:, :, 1],
            "chain (diagonal chunk)": np.where(diag, st[:, :, 3] - st[:, :, 2], 0),
            "barrier after the chain": np.where(diag, st[:, :, 4] - st[:, :, 3], 0),
            "OR pass (and seen stores)": st[:, :, 5] - after_chain,
            "keep store, last barrier": st[:, :, 6] - st[:, :, 5],
        }
        step = st[:, :, 6] - st[:, :, 0]
    else:
        # Slabs 1 .. n - 2: each has a slab before it and one after it.
        x, prev, nxt = st[:, 1:-1], st[:, :-2], st[:, 2:]
        parts = {
            "chain: diagonal words (staged; loads two slabs ahead)": x[..., 1] - x[..., 0],
            "chain: wait for the updaters' word": x[..., 2] - x[..., 1],
            "chain: the 32-row chain": x[..., 3] - x[..., 2],
            "chain: publish": x[..., 4] - x[..., 3],
            "chain: fold, keep store": nxt[..., 0] - x[..., 4],
            "updater: wait for the kept bits (and box 1 of the slab before)":
                x[..., 5] - prev[..., 8],
            "updater: ring wait (first box)": x[..., 6] - x[..., 5],
            "updater: OR pass (first box)": x[..., 7] - x[..., 6],
            "updater: release (first box)": x[..., 8] - x[..., 7],
            "updater: behind the chain (kept bits published to seen)": x[..., 5] - x[..., 4],
        }
        step = nxt[..., 0] - x[..., 0]
    print(f"  step: {us(step.mean()):.4f} us")
    for k, v in parts.items():
        print(f"  {k}: {us(v.mean()):.4f} us")


def main(argv=None) -> int:
    import torch

    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_probe_k2: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from range_view_3d_detection_torch.kernels import _build
    from range_view_3d_detection_torch.kernels.nms import k2_plan, mask_shape, nms_scan_plain

    smi = cs.card_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    header = (SOURCE.parent / "hopper.cuh").read_text()
    builds, skipped = make_variants(SOURCE.read_text(), args.trace)
    for src in args.source:
        more, skip = make_variants(src.read_text(), args.trace, tag=str(src))
        builds.update(more)
        skipped += skip
    for line in skipped:
        print(line, flush=True)
    procs = {}
    for i, (name, (text, _)) in enumerate(builds.items()):
        vdir = OUT / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "hopper.cuh").write_text(header)
        cu = vdir / SOURCE.name
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", str(cu),
             *_build.LINK_LIBS, "-o", str(cu.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        cs.check(proc.returncode == 0, f"{name}: build failed\n{log}")
        lines = log.splitlines()
        for j, line in enumerate(lines[:-1]):
            if "Function properties for" in line and "keep" in line:
                print(f"{name}: ptxas {line.split()[-1]}: {lines[j + 1].strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.rv3d_nms_scan.argtypes = _build.SIGNATURES["rv3d_nms_scan"]
        lib.rv3d_nms_scan.restype = ctypes.c_int
        libs[name] = lib

    B, cap = args.batch, args.cap
    case = cs.nms_case(B, cap, torch.Generator().manual_seed(cs.SEED + 6), "cuda")
    iou, scores, valid, payload = (t.contiguous() for t in case)
    P = payload.shape[2]
    plan = k2_plan(cap, P)
    _, rows, ld = mask_shape(B, cap)
    nwords = rows // 32
    keep = torch.empty((B, cap), dtype=torch.bool, device="cuda")
    merged = torch.empty((B, cap, P), dtype=torch.float32, device="cuda")
    mask = torch.empty((B, rows, ld), dtype=torch.int32, device="cuda")
    scratch = torch.empty((B, cap, nwords), dtype=torch.int32, device="cuda")
    nonfinite = torch.empty((B, P), dtype=torch.int32, device="cuda")
    merge_thr = 0.5  # WEIGHTED: keep does not depend on the mode

    def run(lib):
        # An earlier revision takes the arguments up to the stream and
        # ignores the last.
        err = lib.rv3d_nms_scan(
            iou.data_ptr(), scores.data_ptr(), valid.data_ptr(), payload.data_ptr(),
            keep.data_ptr(), merged.data_ptr(), mask.data_ptr(), scratch.data_ptr(),
            B, cap, ld, P, int(plan.keep != "register"), int(plan.merge == "p9"),
            0.3, merge_thr, torch.cuda.current_stream().cuda_stream, nonfinite.data_ptr())
        _build.check(err, "rv3d_nms_scan")
        return keep, merged

    keep_p, merged_p = nms_scan_plain(iou, scores, valid, payload, iou_threshold=0.3,
                                      merge_threshold=merge_thr)
    slots = trace_slots(cap)
    trace = torch.zeros(B * slots, dtype=torch.int64, device="cuda")
    for name, lib in libs.items():
        if builds[name][1] is not None:
            _build.check(lib.rv3d_k2_set_trace(ctypes.c_void_p(trace.data_ptr()), slots),
                         "rv3d_k2_set_trace")
        k, m = run(lib)
        torch.cuda.synchronize()
        cs.check(torch.equal(k, keep_p), f"{name}: keep differs from the twin in "
                 f"{int((k != keep_p).sum())} slots")
        err = (m - merged_p).abs().max().item()
        if "no-seen" not in name:
            cs.check(err <= 1e-4, f"{name}: merged max|diff| {err} > 1e-4")
        print(f"{name}: keep equal to the twin at B {B} cap {cap} WEIGHTED ({plan}; kept "
              f"{int(k.sum())} of {int(valid.sum())} valid), merged max|diff| {err:.3g}",
              flush=True)
    names = [n for n in libs if builds[n][1] is None]
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            fn = (lambda lib: lambda: run(lib))(libs[n])
            times[n].append((cs.cuda_ms(fn, reps=args.reps), cs.graph_ms(fn),
                             cs.kernel_device_us(fn, KERNELS)))
    for n in names:
        eager = " / ".join(f"{e:.4f}" for e, _, _ in times[n])
        graph = " / ".join(f"{g:.4f}" for _, g, _ in times[n])
        split = " / ".join(", ".join(f"{k} {v:.2f}" for k, v in d.items() if v)
                           for _, _, d in times[n])
        print(f"{n}: eager {eager} ms (median of {args.reps}), graph replay {graph} ms; "
              f"device us by kernel: {split}; at B {B} cap {cap} WEIGHTED on {smi}")
    for name, lib in libs.items():
        kind = builds[name][1]
        if kind is None:
            continue
        _build.check(lib.rv3d_k2_set_trace(ctypes.c_void_p(trace.data_ptr()), slots),
                     "rv3d_k2_set_trace")
        trace.zero_()
        run(lib)
        torch.cuda.synchronize()
        report_trace(name, kind, trace.cpu().numpy(), B, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
