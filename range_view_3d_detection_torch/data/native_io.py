"""ctypes bindings of the port's native data-path library (counterpart of
the JAX ``data/native_io.py``).

``native/rangeview_io.cpp`` (the nearest-return z-buffer and the
column-to-image fuse, the port's copy of the JAX package's
``native/rangeview_io.cpp``), ``native/lz4_frame.cpp`` and
``native/zstd_frame.cpp`` (LZ4 and ZSTD frame decoders, for Feather files
whose record batches are compressed) are built with ``g++ -O3 -fPIC -shared`` at first use into ``build/``
at the repository root, as ``kernels/_build.py`` builds the CUDA kernels:
the library's name carries a hash of the sources, the flags and the
compiler's version, so an edited source or another compiler rebuilds and
an unchanged one is reused, and it is written under a
temporary name and moved into place, so processes that build it at the
same time do not see each other's half-written file. Nothing builds at
import.

There is no fallback: where the JAX module serves numpy when its library
is missing, a failed build here raises with the compiler's output. The
plain twins are ``ops/projection.py::z_buffer_numpy``,
``utils/lz4.py::lz4_frame_decompress_py`` and
``utils/zstd.py::zstd_frame_decompress_py``, which the tests hold these
against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCES = tuple(
    Path(__file__).resolve().parents[1] / "native" / name
    for name in ("rangeview_io.cpp", "lz4_frame.cpp", "zstd_frame.cpp")
)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# No -fopenmp: the g++ beside the card has no libgomp. Only
# columns_to_image has a parallel loop, and no converter calls it.
CXX_FLAGS = ("-O3", "-fPIC", "-shared")


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source, flag and compiler hash) and load the native
    library."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native data-path "
                           "library builds with it at first use")
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join((cxx, *CXX_FLAGS)).encode() + version.encode())
    lib_path = BUILD_DIR / f"librv3d_native_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.z_buffer.argtypes = [vp, vp, vp, vp, i64, i64, i64, i64, ctypes.c_float, vp, vp]
    lib.z_buffer.restype = None
    lib.columns_to_image.argtypes = [vp, i64, i64, i64, vp, vp]
    lib.columns_to_image.restype = None
    lib.lz4_frame_decompress.argtypes = [vp, i64, vp, i64]
    lib.lz4_frame_decompress.restype = i64
    lib.lz4_frame_error.argtypes = [i64]
    lib.lz4_frame_error.restype = ctypes.c_char_p
    lib.zstd_frame_decompress.argtypes = [vp, i64, vp, i64]
    lib.zstd_frame_decompress.restype = i64
    lib.zstd_frame_error.argtypes = [i64]
    lib.zstd_frame_error.restype = ctypes.c_char_p
    lib.path = str(lib_path)
    return lib


def available() -> bool:
    """Whether the native library builds and loads on this host."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def z_buffer_native(
    row: np.ndarray,
    col: np.ndarray,
    distances: np.ndarray,
    values: np.ndarray,
    *,
    height: int,
    width: int,
    min_distance: float = 1.0,
) -> np.ndarray:
    """Native nearest-return-wins rasterization, equal to
    ``ops.projection.z_buffer_numpy`` (ties to the first writer)."""
    lib = library()
    n, c = values.shape
    row = np.ascontiguousarray(row, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    distances = np.ascontiguousarray(distances, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    if not len(row) == len(col) == len(distances) == n:
        raise ValueError(f"z_buffer_native: {len(row)} rows, {len(col)} columns, "
                         f"{len(distances)} distances, {n} values")
    if n and (row.min() < 0 or row.max() >= height or col.min() < 0 or col.max() >= width):
        raise ValueError(f"z_buffer_native: a pixel outside the {height}x{width} image")
    out = np.zeros((height * width, c), np.float32)
    depth = np.full(height * width, np.inf, np.float32)
    lib.z_buffer(_ptr(row), _ptr(col), _ptr(distances), _ptr(values), n, height, width, c,
                 ctypes.c_float(min_distance), _ptr(out), _ptr(depth))
    return out.reshape(height, width, c)


def columns_to_image_native(
    columns: list[np.ndarray],
    *,
    height: int,
    width: int,
    range_index: int = -1,
) -> tuple[np.ndarray, np.ndarray]:
    """Fuse per-column buffers into a channel-last image + validity mask."""
    lib = library()
    num_pixels = height * width
    cols32 = [np.ascontiguousarray(c, np.float32) for c in columns]
    n_cols = len(cols32)
    if any(c.shape != (num_pixels,) for c in cols32) or not -1 <= range_index < n_cols:
        raise ValueError(f"columns_to_image_native: {n_cols} columns of shapes "
                         f"{sorted({c.shape for c in cols32})} for {height}x{width} pixels, "
                         f"range_index {range_index}")
    ptrs = (ctypes.c_void_p * n_cols)(*[_ptr(c) for c in cols32])
    out = np.empty((num_pixels, n_cols), np.float32)
    # Without a range column every pixel is valid; the library then leaves
    # the mask as it finds it (the JAX module's native path returns it
    # uninitialized, its numpy path all true).
    mask = np.ones(num_pixels, np.uint8)
    lib.columns_to_image(ctypes.addressof(ptrs), n_cols, num_pixels, range_index,
                         _ptr(out), _ptr(mask))
    return out.reshape(height, width, n_cols), mask.reshape(height, width) > 0


def _decompress(codec: str, decode, error, data, uncompressed_size: int) -> bytearray:
    if uncompressed_size < 0:
        raise ValueError(f"{codec} frame: expected size {uncompressed_size}")
    src = np.frombuffer(data, np.uint8)
    out = bytearray(max(int(uncompressed_size), 1))
    dst = (ctypes.c_char * len(out)).from_buffer(out)
    got = decode(_ptr(src), len(src), ctypes.addressof(dst), int(uncompressed_size))
    del dst  # release the export of ``out``
    if got < 0:
        raise ValueError(f"{codec} frame: {error(got).decode()}")
    if got != uncompressed_size:
        raise ValueError(f"{codec} frame: decoded {got} bytes, expected {uncompressed_size}")
    del out[uncompressed_size:]
    return out


def lz4_frame_decompress(data, uncompressed_size: int) -> bytearray:
    """Decode the LZ4 frame(s) in ``data`` (bytes-like), which must hold
    exactly ``uncompressed_size`` bytes; raises ``ValueError`` naming what
    is wrong with a corrupt, truncated or unsupported frame."""
    lib = library()
    return _decompress("LZ4", lib.lz4_frame_decompress, lib.lz4_frame_error, data,
                       uncompressed_size)


def zstd_frame_decompress(data, uncompressed_size: int) -> bytearray:
    """Decode the ZSTD frame(s) in ``data`` (bytes-like), which must hold
    exactly ``uncompressed_size`` bytes; raises ``ValueError`` naming what
    is wrong with a corrupt, truncated or unsupported frame (one that
    needs a dictionary among them)."""
    lib = library()
    return _decompress("ZSTD", lib.zstd_frame_decompress, lib.zstd_frame_error, data,
                       uncompressed_size)
