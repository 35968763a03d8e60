#!/usr/bin/env python3
"""Measure variants of the fused stem kernel K1 on one CUDA GPU.

    python3 chip_probe_k1.py [--source PATH] [--regs 72/216,88/200]
                             [--ablate] [--trace]

Builds ``csrc/meta_kernel_fused.cu`` (or ``--source``, e.g. an earlier
revision written out with ``git show``) with ``nvcc`` for ``sm_90a`` into
``build/k1_probe/``: once as it is, and once per variant made by patching
the source text at fixed anchors. A variant whose anchor the source no
longer holds is skipped, with a line that says so: the kernel is edited
freely, and the probe follows it where it still applies.

- ``--regs P/C``: the producer / consumer ``setmaxnreg`` split. Each split
  must stay within the 64,512 registers the 384-thread launch holds.
- ``--ablate``: ``no-act`` stages zeros instead of loading g and feats;
  ``w-once`` loads the weight boxes for the first neighbour only. Both
  give wrong outputs and are timed, not checked.
- ``--trace``: ``clock64`` stamps of consumer thread 0 (and of the first
  builder thread, where the source has builders) at each phase of every
  neighbour, for a breakdown of one flagship call.

Every exact variant is checked against the plain twin at the flagship
shape (max|diff| <= 2e-2 * max|ref|), its ptxas spills are printed, and
all are timed in turns at (2, 64, 1808, 256) bf16: CUDA events around
eager launches (median of 10) and CUDA-graph replay (10 calls). Prints
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
SOURCE = REPO / "range_view_3d_detection_torch/csrc/meta_kernel_fused.cu"
OUT = REPO / "build/k1_probe"
SHAPE = (2, 64, 1808, 256)
TRACE_SLOTS = 384  # per block


class MissingAnchor(RuntimeError):
    """The source does not hold a variant's anchor exactly once."""


def patch(src: str, old: str, new: str, regex: bool = False) -> str:
    """``src`` with ``old`` (exactly one occurrence) replaced by ``new``."""
    found = len(re.findall(old, src)) if regex else src.count(old)
    if found != 1:
        raise MissingAnchor(f"anchor found {found} times: {old!r}")
    return re.sub(old, new, src) if regex else src.replace(old, new)


def with_regs(src: str, producer: int, consumer: int) -> str:
    src = patch(src, r"constexpr int kProducerRegs = \d+;",
                f"constexpr int kProducerRegs = {producer};", regex=True)
    return patch(src, r"constexpr int kConsumerRegs = \d+;",
                 f"constexpr int kConsumerRegs = {consumer};", regex=True)


def without_activations(src: str) -> str:
    src = patch(src, "if (p < kTileP && w < W && ch_ok) {", "if (false) {")
    return patch(src, "fs[j][r] = ok && col_ok ? __ldg(", "fs[j][r] = false ? __ldg(")


def weights_once(src: str) -> str:
    return patch(src, "        mbar_arrive_tx(&full[s], kBoxBytes);\n",
                 "        if (i >= kBoxesPerNb) {\n"
                 "          mbar_arrive(&full[s]);\n"
                 "          continue;\n"
                 "        }\n"
                 "        mbar_arrive_tx(&full[s], kBoxBytes);\n")


def traced(src: str) -> str:
    """Stamps (slots per block): 0/1 clock64/globaltimer at the start, 2/3
    at the end; 8 + 8 nb + k consumer phase k (0 neighbour start, 1 GEMM1
    start, 2 GEMM1 done, 3 GEMM2 start, 4 GEMM2 done); 96 + i / 168 + i
    before / after the wait for weight box i; 240 + 4 nb + k builder (0
    start, 1 buffer free, 2 hh written)."""
    head = (
        "__device__ unsigned long long* g_k1_trace;\n"
        'extern "C" int rv3d_k1_set_trace(void* p) {\n'
        "  return (int)cudaMemcpyToSymbol(g_k1_trace, &p, sizeof(p));\n"
        "}\n"
        "__device__ __forceinline__ unsigned long long k1_gtime() {\n"
        "  unsigned long long t;\n"
        '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
        "  return t;\n"
        "}\n"
        "#define K1_SLOT(k) g_k1_trace[((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * "
        f"gridDim.x + blockIdx.x) * {TRACE_SLOTS} + (k)]\n"
        "#define K1_T(k) do { if (threadIdx.x == 0) K1_SLOT(k) = clock64(); } while (0)\n"
    )
    src = patch(src, '#include "hopper.cuh"\n', '#include "hopper.cuh"\n\n' + head)
    src = patch(src, "  __syncthreads();\n\n  if (threadIdx.x >= kConsumerThreads) {",
                "  if (threadIdx.x == 0) { K1_SLOT(0) = clock64(); K1_SLOT(1) = k1_gtime(); }\n"
                "  __syncthreads();\n\n  if (threadIdx.x >= kConsumerThreads) {")
    src = patch(src, "        mbar_wait(&full[s], (box / kStages) & 1);\n",
                "        K1_T(96 + box);\n"
                "        mbar_wait(&full[s], (box / kStages) & 1);\n"
                "        K1_T(168 + box);\n")
    src = patch(src, "      const bool row_ok = hs >= 0 && hs < H;\n\n",
                "      const bool row_ok = hs >= 0 && hs < H;\n      K1_T(8 + 8 * nb);\n\n")
    src = patch(src, r"( *)(gemm\(z[^;]*\);)\n",
                r"\1K1_T(9 + 8 * nb);\n\1\2\n\1K1_T(10 + 8 * nb);\n", regex=True)
    src = patch(src, r"( *)(gemm\(acc[^;]*\);)\n",
                r"\1K1_T(11 + 8 * nb);\n\1\2\n\1K1_T(12 + 8 * nb);\n", regex=True)
    src = patch(src, "    // Store this thread's accumulator rows and its columns below C.\n",
                "    if (threadIdx.x == 0) { K1_SLOT(2) = clock64(); K1_SLOT(3) = k1_gtime(); }\n"
                "    // Store this thread's accumulator rows and its columns below C.\n")
    builder = "        if (nb >= 2) mbar_wait(&hh_empty[buf], ((nb >> 1) - 1) & 1);\n"
    if builder in src:
        b0 = "threadIdx.x == kConsumerThreads + 32"
        src = patch(src, builder,
                    f"        if ({b0}) K1_SLOT(240 + 4 * nb) = clock64();\n" + builder
                    + f"        if ({b0}) K1_SLOT(241 + 4 * nb) = clock64();\n")
        src = patch(src, "        if ((threadIdx.x & 31) == 0) mbar_arrive(&hh_full[buf]);\n",
                    f"        if ({b0}) K1_SLOT(242 + 4 * nb) = clock64();\n"
                    "        if ((threadIdx.x & 31) == 0) mbar_arrive(&hh_full[buf]);\n")
    return src


def make_variants(base: str, regs: str = "", ablate: bool = False,
                  trace: bool = False):
    """``({name: (source, exact)}, [skip messages])``: the source as it is,
    and each asked-for variant whose anchors ``base`` holds. ``exact``
    variants compute the kernel's function and are checked."""
    makers = [(f"regs {s}", lambda src, s=s: with_regs(src, *map(int, s.split("/"))), True)
              for s in filter(None, regs.split(","))]
    if ablate:
        makers += [("no-act", without_activations, False), ("w-once", weights_once, False)]
    if trace:
        makers.append(("trace", traced, True))
    variants, skipped = {"as is": (base, True)}, []
    for name, make, exact in makers:
        try:
            variants[name] = (make(base), exact)
        except MissingAnchor as e:
            skipped.append(f"{name}: skipped, {e}")
    return variants, skipped


def report_trace(t, ncta: int, smi: str) -> None:
    import numpy as np

    t = t.reshape(ncta, TRACE_SLOTS).astype(np.float64)
    ghz = np.median((t[:, 2] - t[:, 0]) / (t[:, 3] - t[:, 1]))
    us = lambda c: c / ghz / 1e3  # noqa: E731
    ph = t[:, 8:80].reshape(ncta, 9, 8)[:, :, :5]
    nxt = np.concatenate([ph[:, 1:, 0], t[:, 2:3]], axis=1)  # next start, or the end
    parts = {
        "before GEMM1 (hh build or wait, fs loads)": ph[:, :, 1] - ph[:, :, 0],
        "GEMM1": ph[:, :, 2] - ph[:, :, 1],
        "between (syncs, epilogue)": ph[:, :, 3] - ph[:, :, 2],
        "GEMM2": ph[:, :, 4] - ph[:, :, 3],
        "after GEMM2": nxt - ph[:, :, 4],
    }
    wait = (t[:, 168:240] - t[:, 96:168]).reshape(ncta, 9, 8)
    print(f"trace: SM clock {ghz:.3f} GHz; block {us(np.median(t[:, 2] - t[:, 0])):.2f} us "
          f"(median, to the stores); per neighbour 1-8, mean over {ncta} blocks, on {smi}:")
    for name, v in parts.items():
        print(f"  {name}: {us(v[:, 1:].mean()):.3f} us")
    print(f"  of which waiting for weight boxes: GEMM1 {us(wait[:, 1:, :4].sum(2).mean()):.3f} us, "
          f"GEMM2 {us(wait[:, 1:, 4:].sum(2).mean()):.3f} us")
    b = t[:, 240:276].reshape(ncta, 9, 4)
    if b[:, :, 2].any():
        print(f"  builders: waiting for a free buffer {us((b[:, 2:, 1] - b[:, 2:, 0]).mean()):.3f} us, "
              f"building {us((b[:, 1:, 2] - b[:, 1:, 1]).mean()):.3f} us")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=SOURCE)
    ap.add_argument("--regs", default="", help="comma-separated P/C splits")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_probe_k1: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from range_view_3d_detection_torch.kernels import _build
    from range_view_3d_detection_torch.kernels.stem import meta_kernel_fused_plain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}; source {args.source}", flush=True)
    variants, skipped = make_variants(args.source.read_text(), args.regs, args.ablate,
                                      args.trace)
    for line in skipped:
        print(line, flush=True)

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "hopper.cuh").write_text((SOURCE.parent / "hopper.cuh").read_text())
    procs = {}
    for i, (name, (src, _)) in enumerate(variants.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(src)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", str(cu),
             *_build.LINK_LIBS, "-o", str(cu.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        cs.check(proc.returncode == 0, f"{name}: build failed\n{log}")
        spills = cs.ptxas_spills(log, "meta_kernel_fused_wgmma")
        print(f"{name}: bytes spilled {spills}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.rv3d_meta_kernel_fused.argtypes = _build.SIGNATURES["rv3d_meta_kernel_fused"]
        lib.rv3d_meta_kernel_fused.restype = ctypes.c_int
        libs[name] = lib

    B, H, W, C = SHAPE
    x = cs.stem_inputs(B, H, W, C, torch.Generator().manual_seed(0), "cuda")
    w1t = x["w1"].t().contiguous()
    kt = x["k"].transpose(1, 2).contiguous()
    out = torch.empty(SHAPE, dtype=torch.float32, device="cuda")

    def run(lib):
        err = lib.rv3d_meta_kernel_fused(
            x["g"].data_ptr(), x["feats"].data_ptr(), w1t.data_ptr(), kt.data_ptr(),
            x["a0"].data_ptr(), x["b0"].data_ptr(), x["a1"].data_ptr(), x["b1"].data_ptr(),
            out.data_ptr(), B, H, W, C, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "rv3d_meta_kernel_fused")
        return out

    ncta = (W + 63) // 64 * H * B
    trace = torch.zeros(ncta * TRACE_SLOTS, dtype=torch.int64, device="cuda")
    if "trace" in libs:
        libs["trace"].rv3d_k1_set_trace.argtypes = [ctypes.c_void_p]
        _build.check(libs["trace"].rv3d_k1_set_trace(trace.data_ptr()), "set_trace")
    want = meta_kernel_fused_plain(**x)
    ref = want.abs().max().item()
    for name, lib in libs.items():
        if variants[name][1]:
            err = (run(lib) - want).abs().max().item()
            cs.check(err <= 2e-2 * ref, f"{name}: max|diff| {err} > 2e-2 * {ref}")
            print(f"{name}: max|diff| {err:.4g} (max|ref| {ref:.4g}) ok", flush=True)
    names = list(libs)
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            times[n].append((cs.cuda_ms(lambda: run(libs[n]), reps=10),
                             cs.graph_ms(lambda: run(libs[n]))))
    for n in names:
        eager = " / ".join(f"{e:.4f}" for e, _ in times[n])
        graph = " / ".join(f"{g:.4f}" for _, g in times[n])
        print(f"{n}: eager {eager} ms, graph replay {graph} ms on {smi}")
    if "trace" in libs:
        trace.zero_()
        run(libs["trace"])
        torch.cuda.synchronize()
        report_trace(trace.cpu().numpy(), ncta, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
