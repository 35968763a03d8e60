"""The port's native data-path library (``data/native_io.py``, built by
g++ at first use) against its plain twins and pyarrow.

- The LZ4 frame decoder equals the pure-Python twin (``utils/lz4.py``),
  ``pyarrow.decompress(..., codec="lz4")`` and the original bytes: on
  frames pyarrow writes (independent blocks) and on frames of
  ``chip_smoke.py``'s encoder (linked blocks with matches into earlier
  blocks, overlapping matches, raw blocks, block and content checksums,
  content size, 64 KB to 4 MB blocks, concatenated and skippable frames).
- Corrupt, truncated and unsupported frames raise ``ValueError`` in both
  decoders; a wrong expected size raises.
- The z-buffer equals ``ops/projection.py::z_buffer_numpy`` and the JAX
  package's, ties to the first writer and the minimum distance included;
  ``columns_to_image_native`` equals the JAX module's.
- A failed build raises with the compiler's output (no fallback).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest

import chip_smoke
from range_view_3d_detection_torch.data import native_io
from range_view_3d_detection_torch.ops.projection import z_buffer_numpy
from range_view_3d_detection_torch.utils.lz4 import lz4_frame_decompress_py, xxh32
from range_view_3d_detection_tpu.data import native_io as jax_native_io
from range_view_3d_detection_tpu.ops.projection import z_buffer_numpy as jax_z_buffer_numpy


def payload(kind: str, n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "zeros":
        return bytes(n)
    if kind == "float16":
        return (rng.normal(size=n // 2) * 30).astype(np.float16).tobytes()
    if kind == "periodic":
        return (b"xyz" * (n // 3 + 1))[:n]
    head = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    return (head + head + bytes(30_000) + b"ab" * 20_000 + rng.integers(
        0, 4, n, dtype=np.uint8).tobytes())[:n]  # "mixed"


def decoders_agree(frame: bytes, data: bytes, *, pyarrow: bool = True) -> None:
    assert native_io.lz4_frame_decompress(frame, len(data)) == data
    assert lz4_frame_decompress_py(frame, len(data)) == data
    if pyarrow:  # which decodes one frame only
        assert pa.decompress(frame, decompressed_size=len(data), codec="lz4",
                             asbytes=True) == data


@pytest.mark.parametrize("kind", ["random", "zeros", "float16", "periodic", "mixed"])
@pytest.mark.parametrize("n", [0, 1, 15, 4096, 200_000])
def test_pyarrow_frames(kind, n):
    data = payload(kind, n)
    decoders_agree(pa.compress(data, codec="lz4", asbytes=True), data)


FRAME_OPTIONS = {
    "linked": {},
    "independent": dict(linked=False),
    "checksums": dict(block_checksum=True, content_checksum=True),
    "content_size": dict(content_size=True),
    "256k_all": dict(block_size=1 << 18, block_checksum=True, content_checksum=True,
                     content_size=True),
    "1m_independent": dict(block_size=1 << 20, linked=False),
    "4m": dict(block_size=1 << 22, content_checksum=True),
}


@pytest.mark.parametrize("options", list(FRAME_OPTIONS))
@pytest.mark.parametrize("kind", ["mixed", "float16", "zeros"])
def test_encoder_frames(options, kind):
    data = payload(kind, 180_000, seed=1)
    stats: dict = {}
    frame = chip_smoke.lz4_frame_compress(data, stats=stats, **FRAME_OPTIONS[options])
    decoders_agree(frame, data)
    if kind == "mixed" and options == "linked":
        # The cases a decoder that resets its window at each block, or
        # copies overlapping matches in bulk, gets wrong.
        assert stats["into_earlier_block"] > 0 and stats["overlapping"] > 0
        assert stats["blocks"] > 2


def test_concatenated_and_skippable_frames():
    a, b = payload("mixed", 90_000), payload("periodic", 70_000)
    skip = (0x184D2A5A).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    frame = chip_smoke.lz4_frame_compress(a) + skip + chip_smoke.lz4_frame_compress(
        b, linked=False, content_checksum=True)
    decoders_agree(frame, a + b, pyarrow=False)


def corruptions():
    data = payload("mixed", 100_000, seed=2)
    good = chip_smoke.lz4_frame_compress(data, block_checksum=True, content_checksum=True,
                                         content_size=True)
    out = {}
    out["truncated"] = good[:-7]
    out["bad_magic"] = b"\x05" + good[1:]
    out["bad_version"] = good[:4] + bytes([good[4] ^ 0x80]) + good[5:]
    out["header_checksum"] = good[:14] + bytes([good[14] ^ 1]) + good[15:]
    flip = bytearray(good)
    flip[len(good) // 2] ^= 0x10
    out["block_checksum"] = bytes(flip)
    unchecked = chip_smoke.lz4_frame_compress(data)
    offset = bytearray(unchecked)
    assert not offset[10] & 0x80  # the first block is compressed
    offset[11:15] = b"\x10A\xff\xff"  # one literal, then a match 65,535 bytes back
    out["offset"] = bytes(offset)
    out["dictionary"] = good[:4] + bytes([good[4] | 0x01]) + good[5:]
    return data, out


@pytest.mark.parametrize("case", ["truncated", "bad_magic", "bad_version", "header_checksum",
                                  "block_checksum", "offset", "dictionary"])
def test_bad_frames_raise(case):
    data, frames = corruptions()
    for decode in (native_io.lz4_frame_decompress, lz4_frame_decompress_py):
        with pytest.raises(ValueError, match="LZ4 frame"):
            decode(frames[case], len(data))


@pytest.mark.parametrize("delta", [-1, 1])
def test_wrong_size_raises(delta):
    data = payload("mixed", 70_000)
    frame = chip_smoke.lz4_frame_compress(data)
    for decode in (native_io.lz4_frame_decompress, lz4_frame_decompress_py):
        with pytest.raises(ValueError, match="LZ4 frame"):
            decode(frame, len(data) + delta)


def test_xxh32_known_values():
    # Reference values of xxHash32 (seed 0), from the xxHash project.
    assert xxh32(b"") == 0x02CC5D05
    assert xxh32(b"a") == 0x550D7456
    assert xxh32(b"abc") == 0x32D153FF
    assert xxh32(b"Nobody inspects the spammish repetition") == 0xE2293B2F


def random_points(n, H, W, seed):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, H, n)
    col = rng.integers(0, W, n)
    dist = rng.uniform(0.2, 50, n).astype(np.float32)
    dist[rng.uniform(size=n) < 0.3] = 7.5  # ties on shared pixels
    values = rng.normal(size=(n, 5)).astype(np.float32)
    return row, col, dist, values


@pytest.mark.parametrize("n,H,W,seed", [(0, 8, 64, 0), (1, 8, 64, 1), (3000, 8, 64, 2),
                                        (20_000, 32, 64, 3), (5000, 1, 1, 4)])
def test_z_buffer_native_equals_numpy(n, H, W, seed):
    row, col, dist, values = random_points(n, H, W, seed)
    got = native_io.z_buffer_native(row, col, dist, values, height=H, width=W)
    want = z_buffer_numpy(row, col, dist, values, height=H, width=W)
    jax_want = jax_z_buffer_numpy(row, col, dist, values, height=H, width=W)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), jax_want.view(np.uint32))


def test_z_buffer_ties_and_min_distance():
    row = np.zeros(4, np.int64)
    col = np.zeros(4, np.int64)
    dist = np.array([0.5, 5.0, 5.0, 6.0], np.float32)  # first below min_distance
    values = np.arange(4, dtype=np.float32)[:, None]
    got = native_io.z_buffer_native(row, col, dist, values, height=1, width=1)
    assert got[0, 0, 0] == 1.0  # the first of the two ties
    got = native_io.z_buffer_native(row, col, dist, values, height=1, width=1, min_distance=0.1)
    assert got[0, 0, 0] == 0.0


@pytest.mark.parametrize("range_index", [-1, 2])
def test_columns_to_image_native(range_index):
    rng = np.random.default_rng(5)
    cols = [rng.normal(size=8 * 64).astype(np.float32) for _ in range(4)]
    got = native_io.columns_to_image_native(cols, height=8, width=64, range_index=range_index)
    want = jax_native_io.columns_to_image_native(cols, height=8, width=64,
                                                 range_index=range_index)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_io, "CXX_FLAGS", native_io.CXX_FLAGS + ("-fno-such-option",))
    native_io.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native build failed"):
            native_io.library()
        assert not native_io.available()
        assert not list(tmp_path.glob("*.so"))
    finally:
        native_io.library.cache_clear()
    monkeypatch.undo()
    assert native_io.available()


def test_wrappers_refuse_what_would_write_out_of_range():
    row, col, dist, values = random_points(10, 4, 8, 6)
    with pytest.raises(ValueError, match="outside"):
        native_io.z_buffer_native(row + 4, col, dist, values, height=4, width=8)
    with pytest.raises(ValueError, match="outside"):
        native_io.z_buffer_native(row, col - 8, dist, values, height=4, width=8)
    with pytest.raises(ValueError, match="distances"):
        native_io.z_buffer_native(row, col, dist[:5], values, height=4, width=8)
    with pytest.raises(ValueError, match="columns_to_image"):
        native_io.columns_to_image_native([np.zeros(31, np.float32)], height=4, width=8)
    with pytest.raises(ValueError, match="columns_to_image"):
        native_io.columns_to_image_native([np.zeros(32, np.float32)], height=4, width=8,
                                          range_index=1)
    with pytest.raises(ValueError, match="LZ4 frame"):
        native_io.lz4_frame_decompress(chip_smoke.lz4_frame_compress(b"abc"), -1)
