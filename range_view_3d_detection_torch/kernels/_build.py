"""Build ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` and load it with ctypes.

At first use every source compiles to an object file in its own ``nvcc``
process (all started together), the objects link into one shared library
with a plain C interface under ``build/`` at the repository root, beside
ptxas's register and spill report, and the library is loaded with
:mod:`ctypes`. The library's name carries a hash of
the sources, so an edited source rebuilds and an unchanged one is reused.
Nothing here runs at import time: the CPU tests import every module on a
host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
# K3 encodes its TMA tensor map with cuTensorMapEncodeTiled, from libcuda.
LINK_LIBS = ("-lcuda",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points (csrc/*.cu): each returns the cudaError_t of its launch.
SIGNATURES = {
    # g, feats, w1t, kt, a0, b0, a1, b1, out, B, H, W, C, stream
    "rv3d_meta_kernel_fused": [_P] * 9 + [_I] * 4 + [_P],
    # iou, scores, valid, payload, keep, merged, mask, seen, B, cap, ld, P,
    # big_keep, p9_merge, iou_thr, merge_thr, stream, nonfinite
    "rv3d_nms_scan": [_P] * 8 + [_I] * 6 + [_F, _F, _P, _P],
    # x, wt, dq, in_scale, out, B, H, W, Cin, Cout, stride, in_kind,
    # out_bf16, stream
    "rv3d_conv3x3_i8": [_P] * 5 + [_I] * 8 + [_P],
    # g, feats, w1t, kt, a0, b0, a1, b1, kdq, out, B, H, W, C, stream
    "rv3d_meta_kernel_fused_i8": [_P] * 10 + [_I] * 4 + [_P],
    # g, feats, w1t, kt, w1t_lo, kt_lo, aff, out, B, H, W, C, fp32, stream
    "rv3d_meta_kernel_fused_rs": [_P] * 8 + [_I] * 5 + [_P],
    # g, feats, w1t, kt, a0, b0, a1, b1, kdq, out, B, H, W, C, fp32, tiled,
    # stream
    "rv3d_meta_kernel_fused_i8_tiles": [_P] * 10 + [_I] * 6 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's kernels build only where the CUDA "
        "toolkit is installed (set CUDA_HOME or put nvcc on PATH)"
    )


def _run_all(cmds):
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for c in cmds
    ]
    logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n{log}")
    return logs


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + LINK_LIBS).encode())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"librv3d_kernels_{tag}.so"
    log_path = lib_path.with_suffix(".ptxas.log")
    build_seconds = 0.0
    if not (lib_path.exists() and log_path.exists()):
        t0 = time.perf_counter()
        nvcc = _nvcc()
        obj_dir = BUILD_DIR / f"obj_{tag}"
        obj_dir.mkdir(parents=True, exist_ok=True)
        objs = [obj_dir / (s.stem + ".o") for s in sources]
        logs = _run_all(
            [
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(s), "-o", str(o)]
                for s, o in zip(sources, objs)
            ]
        )
        log_path.write_text("".join(logs))
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        _run_all(
            [[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), *LINK_LIBS, "-o", str(tmp)]]
        )
        os.replace(tmp, lib_path)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.build_seconds = build_seconds
    # ptxas's register and spill report of the build, kept beside the library.
    lib.ptxas_log = log_path.read_text()
    lib.path = str(lib_path)
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
