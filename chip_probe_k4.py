#!/usr/bin/env python3
"""Time the int8 fused stem kernel K4 beside other revisions of its source.

    python3 chip_probe_k4.py [--source PATH ...]

Builds ``csrc/meta_kernel_fused_i8.cu`` as it is, and each ``--source``
(an earlier revision written out with ``git show REV:PATH``; every
revision keeps the C entry point ``rv3d_meta_kernel_fused_i8``), with
``nvcc`` for ``sm_90a`` into its own library under ``build/k4_probe/``,
beside this checkout's ``csrc/hopper.cuh``. Each is held against the
plain twin at (2, 64, 1808, 256) on ``chip_smoke.k4_inputs``: no element
may differ. Then all are timed in turns (in the given order, then
reversed): CUDA events around eager launches (median of 10) and
CUDA-graph replay (10 calls), the methods of ``chip_smoke.py``. Prints
the card's name and power limit. One card; no CPU path.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
SOURCE = REPO / "range_view_3d_detection_torch/csrc/meta_kernel_fused_i8.cu"
OUT = REPO / "build/k4_probe"
SHAPE = (2, 64, 1808, 256)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_probe_k4: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from range_view_3d_detection_torch.kernels import _build
    from range_view_3d_detection_torch.kernels.stem import meta_kernel_fused_i8_plain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "hopper.cuh").write_text((SOURCE.parent / "hopper.cuh").read_text())
    procs = {}
    for i, src in enumerate([SOURCE, *args.source]):
        name = "as is" if i == 0 else str(src)
        cu = OUT / f"v{i}.cu"
        cu.write_text(src.read_text())
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), *_build.LINK_LIBS,
             "-o", str(cu.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        cs.check(proc.returncode == 0, f"{name}: build failed\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.rv3d_meta_kernel_fused_i8.argtypes = _build.SIGNATURES["rv3d_meta_kernel_fused_i8"]
        lib.rv3d_meta_kernel_fused_i8.restype = ctypes.c_int
        libs[name] = lib

    B, H, W, C = SHAPE
    x = cs.k4_inputs(B, H, W, C, torch.Generator().manual_seed(0), "cuda")
    w1t = x["w1_i8"].t().contiguous()
    kt = x["k_i8"].transpose(1, 2).contiguous()
    out = torch.empty(SHAPE, dtype=torch.float32, device="cuda")

    def run(lib):
        err = lib.rv3d_meta_kernel_fused_i8(
            x["g"].data_ptr(), x["feats"].data_ptr(), w1t.data_ptr(), kt.data_ptr(),
            x["a0"].data_ptr(), x["b0"].data_ptr(), x["a1"].data_ptr(), x["b1"].data_ptr(),
            x["kdq"].data_ptr(), out.data_ptr(), B, H, W, C,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "rv3d_meta_kernel_fused_i8")
        return out

    want = meta_kernel_fused_i8_plain(**x)
    for name, lib in libs.items():
        n_diff = int((run(lib) != want).sum())
        cs.check(n_diff == 0, f"{name}: {n_diff} elements differ from the twin")
        print(f"{name}: equal to the twin at {SHAPE}", flush=True)
    names = list(libs)
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            times[n].append((cs.cuda_ms(lambda: run(libs[n]), reps=10),
                             cs.graph_ms(lambda: run(libs[n]))))
    for n in names:
        eager = " / ".join(f"{e:.4f}" for e, _ in times[n])
        graph = " / ".join(f"{g:.4f}" for _, g in times[n])
        print(f"{n}: eager {eager} ms, graph replay {graph} ms at {SHAPE} on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
