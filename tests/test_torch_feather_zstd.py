"""ZSTD frames and Feather files as pyarrow writes them, against pyarrow,
on the CPU.

- The ZSTD decoders, the pure-Python twin (``utils/zstd.py``) and the
  native one (``native/zstd_frame.cpp`` through ``data/native_io.py``),
  each equal to ``pa.decompress`` on ``pa.Codec("zstd", level).compress``
  buffers at levels 1, 3, 19 and -5, for text (Huffman literals, FSE
  sequences), smooth float32 (FSE-compressed Huffman weights),
  incompressible bytes (raw blocks), a run (RLE), short and empty
  inputs and over 128 KB of mixed data (several blocks, treeless
  literals and repeated tables).
- Frames by hand: the checksum flag set on a pyarrow frame and its XXH64
  appended, a skippable frame before two frames, a block of RLE literals, a
  frame naming a dictionary (``zstandard``'s), which raises and says so; a
  byte flipped in a checksummed frame's compressed block, or in its
  checksum, raises in both decoders (the twin's XXH64 is the ``xxhash``
  package's; the native one's is held by the checksummed frames).
- Feather files that pyarrow writes with ZSTD bodies (one and several
  record batches), with nulls in every column type the reader takes
  (float16/32/64, int8-64, uint8-64, bool, utf8, large utf8, binary, large
  binary, dictionary of strings, the null type) and binary columns
  without nulls, read equal to the JAX ``read_feather``: dtype and bytes
  (NaN positions included), objects by value and type. A dictionary
  column's null slots are ``None`` (numeric dictionaries: NaN in float64,
  as ``pa.DictionaryArray.to_numpy`` gives), where the JAX reader returns
  the dictionary value under the null's index: those slots are held to
  the port's rule, the others to the JAX reader.
- ``chip_smoke.py``'s fixture (``FEATHER_ZSTD``, which pyarrow wrote at
  levels 1 and 19): the port reads it as pyarrow does, its columns'
  digests are ``FEATHER_ZSTD_SUMS``, and its frames decode equally in
  both decoders.
"""

from __future__ import annotations

import base64
import struct

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest
import xxhash
import zstandard

import chip_smoke
from range_view_3d_detection_torch.data import native_io
from range_view_3d_detection_torch.utils.feather import read_feather
from range_view_3d_detection_torch.utils.zstd import ZstdError, xxh64, zstd_frame_decompress_py
from range_view_3d_detection_tpu.utils.feather import read_feather as jread

RNG = np.random.default_rng(0)
DATA = {
    "text": b"".join(b"sweep %d of log-%03d: %d points " % (i, i // 50, 90000 + i)
                     for i in range(3000)),
    "float32": (np.round(np.cumsum(RNG.normal(size=30000)) * 50) / 50).astype(
        np.float32).tobytes(),
    "incompressible": RNG.bytes(150_000),
    "run": bytes([7]) * 300_000,
    "short": b"range view",
    "empty": b"",
    "mixed_multi_block": np.concatenate([
        RNG.integers(0, 4, 200_000).astype(np.uint8),
        np.frombuffer(b"".join(b"cat_%d " % (i % 17) for i in range(30000)), np.uint8),
        (RNG.normal(size=20000) * 40).astype(np.float16).view(np.uint8),
    ]).tobytes(),
}
LEVELS = (1, 3, 19, -5)


def compress(data: bytes, level: int) -> bytes:
    return pa.Codec("zstd", compression_level=level).compress(data, asbytes=True)


def native(data: bytes, size: int) -> bytes:
    return bytes(native_io.zstd_frame_decompress(data, size))


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", sorted(DATA))
def test_decoders_equal_pyarrow(kind, level):
    data = DATA[kind]
    frame = compress(data, level)
    want = pa.Codec("zstd").decompress(frame, decompressed_size=len(data), asbytes=True)
    assert want == data
    assert native(frame, len(data)) == want
    assert zstd_frame_decompress_py(frame) == want


def with_checksum(frame: bytes, content: bytes) -> bytes:
    """``frame`` with its descriptor's checksum flag set and the XXH64's low
    32 bits appended."""
    out = bytearray(frame)
    out[4] |= 4
    return bytes(out) + struct.pack("<I", xxhash.xxh64(content).intdigest() & 0xFFFFFFFF)


def test_xxh64_equals_xxhash():
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 63, 64, 100, 1000, 4099):
        b = RNG.bytes(n)
        want = xxhash.xxh64(b).intdigest()
        assert xxh64(b) == want, n


@pytest.mark.parametrize("kind", ["text", "float32", "run"])
def test_checksum_frames_and_flipped_bytes(kind):
    data = DATA[kind]
    frame = with_checksum(compress(data, 3), data)
    assert native(frame, len(data)) == data
    assert zstd_frame_decompress_py(frame) == data
    # The frame header is magic (4), descriptor (1), window (1) or content
    # size; flip a byte in the middle of the compressed block, and the
    # checksum's last.
    for at in (len(frame) // 2, len(frame) - 1):
        bad = bytearray(frame)
        bad[at] ^= 0xFF
        with pytest.raises(ValueError, match="ZSTD"):
            native(bytes(bad), len(data))
        with pytest.raises(ZstdError):
            zstd_frame_decompress_py(bytes(bad))


def test_frames_by_hand():
    # A skippable frame, then two frames: their contents concatenated.
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    a, b = compress(DATA["text"][:5000], 3), compress(b"xyz" * 100, 19)
    both = DATA["text"][:5000] + b"xyz" * 100
    assert native(skip + a + b, len(both)) == both
    assert zstd_frame_decompress_py(skip + a + b) == both
    # One compressed block of RLE literals (20 x 'A') and no sequences:
    # magic, single-segment descriptor, content size 20, block header.
    rle = struct.pack("<I", 0xFD2FB528) + bytes([0x20, 20, 0x1D, 0, 0, (20 << 3) | 1, 0x41, 0])
    assert zstandard.ZstdDecompressor().decompress(rle) == b"A" * 20
    assert native(rle, 20) == b"A" * 20 and zstd_frame_decompress_py(rle) == b"A" * 20
    # A frame that needs a dictionary.
    samples = [b"sweep %d points %d" % (i, i * 7) for i in range(2000)]
    dictionary = zstandard.train_dictionary(4096, samples)
    framed = zstandard.ZstdCompressor(dict_data=dictionary).compress(samples[5])
    with pytest.raises(ValueError, match="ZSTD frame: .*dictionary"):
        native(framed, len(samples[5]))
    with pytest.raises(ZstdError, match="dictionary"):
        zstd_frame_decompress_py(framed)


def _table(n: int, seed: int = 0) -> pa.Table:
    rng = np.random.default_rng(seed)

    def mask(p):
        return rng.uniform(size=n) < p

    cols = {}
    for t in ("float16", "float32", "float64", "int8", "int16", "int32", "int64",
              "uint8", "uint16", "uint32", "uint64"):
        values = (rng.normal(size=n) * 40).astype(t)
        cols[t] = pa.array(values, mask=mask(0.2))
    cols["bool"] = pa.array(rng.uniform(size=n) < 0.5, mask=mask(0.2))
    m = mask(0.2)
    cols["utf8"] = pa.array([None if m[i] else f"s{i}-é" for i in range(n)])
    cols["large_utf8"] = pa.array([None if m[i] else f"L{i}" for i in range(n)],
                                  pa.large_string())
    cols["binary"] = pa.array([None if m[i] else rng.bytes(i % 5) for i in range(n)])
    cols["large_binary"] = pa.array([None if m[i] else bytes([i % 9]) * (i % 3)
                                     for i in range(n)], pa.large_binary())
    cols["binary_no_nulls"] = pa.array([rng.bytes(i % 4) for i in range(n)])
    cols["dict_utf8"] = pa.array([None if m[i] else f"C{i % 7}"
                                  for i in range(n)]).dictionary_encode()
    cols["dict_int16"] = pa.array([None if m[i] else i % 5 for i in range(n)],
                                  pa.int16()).dictionary_encode()
    cols["null"] = pa.array([None] * n)
    cols["int64_no_nulls"] = pa.array(np.arange(n, dtype=np.int64) * 1000)
    cols["late_null"] = pa.array([None if i == n - 1 else i for i in range(n)], pa.int32())
    return pa.table(cols), m


def assert_like_jax(path, null_dict_slots):
    got, want = read_feather(path), jread(path)
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        if k.startswith("dict_"):
            # The port's nulls; the JAX reader's values elsewhere.
            nulls = null_dict_slots[: len(g)]
            if g.dtype == object:
                assert all(v is None for v in g[nulls])
            else:
                assert g.dtype == np.float64 and np.isnan(g[nulls]).all()
            g, w = g[~nulls], w[~nulls].astype(g.dtype)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if w.dtype == object:
            assert [type(v) for v in g] == [type(v) for v in w], k
            assert list(g) == list(w), k
        else:
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), k
    return got


@pytest.mark.parametrize("chunk", [None, 157])
@pytest.mark.parametrize("level", [1, 19])
def test_zstd_feather_with_nulls_and_binary_equals_jax(tmp_path, level, chunk):
    table, null_dict = _table(600)
    path = tmp_path / "t.feather"
    opts = paipc.IpcWriteOptions(compression=pa.Codec("zstd", compression_level=level))
    with paipc.new_file(str(path), table.schema, options=opts) as w:
        w.write_table(table, max_chunksize=chunk)
    got = assert_like_jax(path, null_dict)
    assert got["int8"].dtype == np.float64 and np.isnan(got["int8"]).any()
    assert got["float16"].dtype == np.float16 and np.isnan(got["float16"]).any()
    assert got["bool"].dtype == object and None in list(got["bool"])
    assert got["binary_no_nulls"].dtype == object and isinstance(got["binary_no_nulls"][1],
                                                                 bytes)
    assert got["int64_no_nulls"].dtype == np.int64
    assert list(got["null"]) == [None] * 600


def test_chip_smoke_fixture_reads_as_pyarrow(tmp_path):
    decode, frames = native_io.zstd_frame_decompress, []

    def recording(data, size):
        frames.append((bytes(data), size))
        return decode(data, size)

    for level, parts in chip_smoke.FEATHER_ZSTD.items():
        path = tmp_path / f"zstd{level}.feather"
        path.write_bytes(base64.b64decode("".join(parts)))
        native_io.zstd_frame_decompress = recording
        try:
            got = read_feather(path)
        finally:
            native_io.zstd_frame_decompress = decode
        want = jread(path)
        nulls = np.array([v is None for v in got["category"]])
        assert nulls.any() and not np.array([v is None for v in want["category"]]).all()
        assert list(got["category"][~nulls]) == list(want["category"][~nulls])
        for k in want:
            if k != "category":
                g, w = got[k], want[k]
                assert g.dtype == w.dtype, k
                assert (list(g) == list(w) if w.dtype == object
                        else np.array_equal(g.view(np.uint8), w.view(np.uint8))), k
        assert {k: chip_smoke.column_digest(v) for k, v in got.items()} == \
            chip_smoke.FEATHER_ZSTD_SUMS
    assert len(frames) > 10
    for data, size in frames:
        assert native(data, size) == zstd_frame_decompress_py(data)
    assert sum(len("".join(p)) for p in chip_smoke.FEATHER_ZSTD.values()) <= 16 * 1024
