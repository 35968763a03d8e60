#!/usr/bin/env python3
"""Time the int8 fused stem kernel K4 beside other revisions of its source.

    python3 chip_probe_k4.py [--dtype bf16|fp32] [--C 256] [--batch 2]
                             [--source PATH ...] [--ablate]

Builds ``csrc/meta_kernel_fused_i8.cu`` as it is, and each ``--source``,
with ``nvcc`` for ``sm_90a`` into its own library under
``build/k4_probe/``. A ``--source`` is a revision of that file (written
out with ``git show REV:PATH``), built beside this checkout's
``csrc/hopper.cuh``, or a revision's whole ``csrc`` directory (``git
archive REV range_view_3d_detection_torch/csrc | tar -x -C DIR``), built
with its own header. Each runs the route that this checkout's ``k4_plan``
names for ``--C`` and ``--dtype``, on the wrapper's padded operands: the
bf16 wgmma entry ``rv3d_meta_kernel_fused_i8``, or, for fp32 and past C =
256, ``rv3d_meta_kernel_fused_i8_tiles`` where the revision has it and
the CUDA-core kernel's ``rv3d_meta_kernel_fused_i8_tiled`` in the
revisions before it. Where the plan names form 1 (fp32 at C <= 256),
form 2 of the source as it is runs beside it on the same operands (one
256-wide output tile), the measurement that keeps the two forms apart.
Each is held against the plain twin at (batch, 64, 1808, C) on
``chip_smoke.k4_inputs``: no element may differ. Then all are timed in
turns (in the given order, then reversed): CUDA events around eager
launches (median of 10) and CUDA-graph replay (10 calls), the methods of
``chip_smoke.py``, with fewer calls where one takes more than 20 ms (3
eager, 1 captured), so that C in the thousands stays inside a call's
time. Prints the card's name and power limit. One card; no CPU path.

``--ablate`` adds variants of the source as it is, made by patching the
output-tiled kernel's text at fixed anchors (``chip_probe_k1.patch``; a
variant whose anchor the source no longer holds is skipped with a line
that says so), for what bounds its two forms: ``no-build``, the builders
write no hq (its g loads and arithmetic go with it); ``no-g``, form 2's
builders compute hq from zeros instead of loading g from L2; ``no-fs``,
the epilogue multiplies by zeros instead of loading the shifted feats;
``w-once``, the weight boxes are loaded on the ring's first lap only
(later laps reuse what the stages hold). They give wrong outputs and are
timed, not checked. Each build's ptxas registers and spills for the
kernels of the source are printed.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

from chip_probe_k1 import MissingAnchor, patch

REPO = Path(__file__).resolve().parent
SOURCE = REPO / "range_view_3d_detection_torch/csrc/meta_kernel_fused_i8.cu"
OUT = REPO / "build/k4_probe"
# The dp4a entry of the revisions before the output-tiled kernel: g, feats,
# w1t, kt, a0, b0, a1, b1, kdq, out, B, H, W, C, fp32, stream.
TILED_DP4A = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def no_build(src: str) -> str:
    src = patch(src, "*reinterpret_cast<uint2*>(dst + sw128(p, ch)) = hq8<T>(gc, gs, sa0, sb0);",
                "")
    return patch(src, "*reinterpret_cast<uint2*>(dst + sw128(p, 8 * cg)) = "
                 "hq8<T>(gc, gs, sa0, sb0);", "")


def no_g(src: str) -> str:
    src = patch(src, "gc[v] = c_ok ? __ldg(cp + v) :", "gc[v] = false ? __ldg(cp + v) :")
    return patch(src, "gs[v] = s_ok ? __ldg(sp + v) :", "gs[v] = false ? __ldg(sp + v) :")


def no_fs(src: str) -> str:
    return patch(src, "dst[gi][r] = fok[r] && col < C ? Fs::load(",
                 "dst[gi][r] = false ? Fs::load(")


def weights_once(src: str) -> str:
    return patch(src, "        mbar_arrive_tx(&full[s], bytes);\n"
                 "        tma_load_3d(ring + s * L::kSlot, map, &full[s], c0, c1, c2);\n",
                 "        if (i >= kS) {\n"
                 "          mbar_arrive(&full[s]);\n"
                 "        } else {\n"
                 "          mbar_arrive_tx(&full[s], bytes);\n"
                 "          tma_load_3d(ring + s * L::kSlot, map, &full[s], c0, c1, c2);\n"
                 "        }\n")


ABLATIONS = (("no-build", no_build), ("no-g", no_g), ("no-fs", no_fs), ("w-once", weights_once))


def make_variants(base: str, ablate: bool) -> tuple:
    """``({name: source}, [skip messages])``: with ``ablate``, each
    ablation of ``base`` whose anchors it holds."""
    variants, skipped = {}, []
    for name, make in ABLATIONS if ablate else ():
        try:
            variants[name] = make(base)
        except MissingAnchor as e:
            skipped.append(f"{name}: skipped, {e}")
    return variants, skipped


def timing_counts(first_ms: float) -> tuple:
    """``(eager reps, graph calls)`` for a launch that took ``first_ms``:
    chip_smoke's 10 and 10, or 3 and 1 past 20 ms."""
    return (10, 10) if first_ms <= 20 else (3, 1)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, action="append", default=[])
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--C", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_probe_k4: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from range_view_3d_detection_torch.kernels import _build
    from range_view_3d_detection_torch.kernels.stem import (
        k4_plan,
        meta_kernel_fused_i8_plain,
        padded_operands,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    # name -> (its sources: {file name: text}, exact)
    header = (SOURCE.parent / "hopper.cuh").read_text()
    builds = {"as is": ({SOURCE.name: SOURCE.read_text(), "hopper.cuh": header}, True)}
    for src in args.source:
        files = ({f.name: f.read_text() for f in src.rglob("*.cu*")} if src.is_dir()
                 else {SOURCE.name: src.read_text(), "hopper.cuh": header})
        builds[str(src)] = (files, True)
    variants, skipped = make_variants(SOURCE.read_text(), args.ablate)
    for line in skipped:
        print(line, flush=True)
    for name, text in variants.items():
        builds[name] = ({SOURCE.name: text, "hopper.cuh": header}, False)
    procs = {}
    for i, (name, (files, _)) in enumerate(builds.items()):
        vdir = OUT / f"v{i}"
        shutil.rmtree(vdir, ignore_errors=True)
        vdir.mkdir(parents=True)
        for fname, text in files.items():
            (vdir / fname).write_text(text)
        cu = vdir / SOURCE.name
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
            if "Function properties for" in line:
                print(f"{name}: ptxas {line.split()[-1]}: {lines[j + 1].strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        for entry, argtypes in (
            ("rv3d_meta_kernel_fused_i8", _build.SIGNATURES["rv3d_meta_kernel_fused_i8"]),
            ("rv3d_meta_kernel_fused_i8_tiles",
             _build.SIGNATURES["rv3d_meta_kernel_fused_i8_tiles"]),
            ("rv3d_meta_kernel_fused_i8_tiled", TILED_DP4A),
        ):
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib

    dtype = torch.float32 if args.dtype == "fp32" else torch.bfloat16
    shape = (args.batch, 64, 1808, args.C)
    plan = k4_plan(args.C, dtype)
    x = cs.k4_inputs(*shape, torch.Generator().manual_seed(0), "cuda", dtype=dtype)
    g, feats, w1t, kt, *vecs = (t.contiguous() for t in padded_operands(
        plan.pad, x["g"], x["feats"], x["w1_i8"].t(), x["k_i8"].transpose(1, 2),
        *(x[k] for k in ("a0", "b0", "a1", "b1", "kdq"))))
    B, H, W, Cp = g.shape
    out = torch.empty(g.shape, dtype=torch.float32, device="cuda")
    fp32 = int(dtype == torch.float32)

    # name -> (library, form 2 of the output-tiled entry, checked)
    rows = {name: (lib, plan.kernel == "wgmma_tiled", builds[name][1])
            for name, lib in libs.items()}
    if plan.kernel == "wgmma_fp32":
        rows["as is, form 2"] = (libs["as is"], True, True)

    def run(lib, tiled):
        ptrs = (g.data_ptr(), feats.data_ptr(), w1t.data_ptr(), kt.data_ptr(),
                *(v.data_ptr() for v in vecs), out.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if plan.kernel == "wgmma":
            entry = "rv3d_meta_kernel_fused_i8"
            err = lib.rv3d_meta_kernel_fused_i8(*ptrs, B, H, W, Cp, stream)
        elif hasattr(lib, "rv3d_meta_kernel_fused_i8_tiles"):
            entry = "rv3d_meta_kernel_fused_i8_tiles"
            err = lib.rv3d_meta_kernel_fused_i8_tiles(*ptrs, B, H, W, Cp, fp32, int(tiled),
                                                      stream)
        else:
            entry = "rv3d_meta_kernel_fused_i8_tiled"
            err = lib.rv3d_meta_kernel_fused_i8_tiled(*ptrs, B, H, W, Cp, fp32, stream)
        _build.check(err, entry)
        return out[..., :args.C]

    want = meta_kernel_fused_i8_plain(**x)
    first_ms = 0.0
    for name, (lib, tiled, exact) in rows.items():
        if not exact:
            run(lib, tiled)
            torch.cuda.synchronize()
            print(f"{name}: ran (an ablation: not checked)", flush=True)
            continue
        n_diff = int((run(lib, tiled) != want).sum())
        first_ms = max(first_ms, cs.cuda_ms(lambda: run(lib, tiled), reps=1, warmup=0))
        cs.check(n_diff == 0, f"{name}: {n_diff} elements differ from the twin")
        print(f"{name}: equal to the twin at {shape} {args.dtype} ({plan}"
              f"{', form 2' if tiled else ''})", flush=True)
    del want
    reps, calls = timing_counts(first_ms)
    names = list(rows)
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            fn = (lambda lib, tiled: lambda: run(lib, tiled))(*rows[n][:2])
            times[n].append((cs.cuda_ms(fn, reps=reps), cs.graph_ms(fn, calls=calls)))
    for n in names:
        eager = " / ".join(f"{e:.4f}" for e, _ in times[n])
        graph = " / ".join(f"{g:.4f}" for _, g in times[n])
        print(f"{n}: eager {eager} ms (median of {reps}), graph replay {graph} ms "
              f"({calls} a graph) at {shape} {args.dtype} on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
