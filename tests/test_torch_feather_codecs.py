"""The port's Feather reader on what real files carry, against the JAX
reader (pyarrow), on files pyarrow writes here.

- LZ4-frame bodies (pyarrow's default for Feather V2): one block, several
  linked blocks (buffers over 64 KB, with matches into the previous
  block), buffers that do not compress (raw blocks), empty columns and
  several record batches; a compressed dictionary file.
- ``float16`` (kept ``float16``), ``large_string``, and dictionary columns
  with int8 and int32 indices (also signed and unsigned 16/64-bit, integer
  values, and delta dictionaries across record batches).
- Every column equals the JAX ``read_feather``'s, dtype and value.
- A body whose uncompressed length is ``-1`` is read raw.
- ZSTD bodies read equal to the JAX reader (they raised naming ``ZSTD``
  until the reader took them); a dictionary column with nulls reads
  ``None`` at the null (it raised until the reader took validity
  bitmaps). ``test_torch_feather_zstd.py`` holds both in depth.
- The port's writer writes ``float16``, read back equal by pyarrow.
"""

from __future__ import annotations

import struct

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest

import chip_smoke
from range_view_3d_detection_torch.utils.feather import read_feather, write_feather
from range_view_3d_detection_tpu.utils.feather import read_feather as jread


def write_pa(path, table, *, compression=None, max_chunksize=None):
    opts = paipc.IpcWriteOptions(compression=compression)
    with paipc.new_file(str(path), table.schema, options=opts) as w:
        w.write_table(table, max_chunksize=max_chunksize)


def assert_equal_to_jax(path):
    got, want = read_feather(path), jread(path)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert got[k].shape == want[k].shape, k
        if want[k].dtype == object:
            assert list(got[k]) == list(want[k]), k
        else:
            assert np.array_equal(got[k].view(np.uint8), want[k].view(np.uint8)), k
    return got


def table(n: int, seed: int = 0) -> pa.Table:
    rng = np.random.default_rng(seed)
    strings = [f"CAT_{i % 7}-é" if i % 3 else "" for i in range(n)]
    return pa.table({
        "f64": pa.array(rng.normal(size=n)),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
        "f16": pa.array((rng.normal(size=n) * 40).astype(np.float16)),
        "u8": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
        "u32": pa.array(rng.integers(0, 10**8, n).astype(np.uint32)),
        "i64": pa.array(np.arange(n, dtype=np.int64) * 100_000_000),
        "flag": pa.array(rng.uniform(size=n) < 0.3),
        "zeros": pa.array(np.zeros(n)),
        "s": pa.array(strings),
        "L": pa.array(strings, type=pa.large_string()),
        "d8": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, 3, n), pa.int8()), pa.array(["car", "bus", "ped"])),
        "d32": pa.array([f"k{i % 11}" for i in range(n)], pa.string()).dictionary_encode(),
    })


@pytest.mark.parametrize("compression", [None, "lz4"])
@pytest.mark.parametrize("n,chunk", [(0, None), (1, None), (37, None), (3000, 1000),
                                     (40_000, None)])
def test_pyarrow_files_read_as_jax_reads_them(tmp_path, compression, n, chunk):
    """40,000 rows: the float64 buffers are 320 KB, five linked 64 KB
    blocks; the random ones store raw blocks."""
    path = tmp_path / "t.feather"
    write_pa(path, table(n), compression=compression, max_chunksize=chunk)
    got = assert_equal_to_jax(path)
    assert got["f16"].dtype == np.float16 and got["d8"].dtype == object


def lz4_frame_blocks(data: bytes, at: int):
    """(FLG, blocks) of the LZ4 frame at ``data[at]`` (no content size, no
    checksums, as Arrow writes them); each block is (raw, matches that
    reach before the block's own output)."""
    flg, pos, blocks = data[at + 4], at + 7, []
    while (word := struct.unpack_from("<I", data, pos)[0]) != 0:
        size, pos = word & 0x7FFFFFFF, pos + 4
        earlier = 0
        if not word & 0x80000000:
            ip, out = pos, 0
            while True:
                token = data[ip]
                ip += 1
                lit = token >> 4
                if lit == 15:
                    while data[ip] == 255:
                        lit += 255
                        ip += 1
                    lit += data[ip]
                    ip += 1
                ip += lit
                out += lit
                if ip == pos + size:
                    break
                offset = data[ip] | data[ip + 1] << 8
                ip += 2
                n = token & 15
                if n == 15:
                    while data[ip] == 255:
                        n += 255
                        ip += 1
                    n += data[ip]
                    ip += 1
                earlier += offset > out
                out += n + 4
        blocks.append((bool(word & 0x80000000), earlier))
        pos += size
    return flg, blocks


def test_lz4_file_has_linked_blocks_and_raw_blocks(tmp_path):
    """The 40,000-row file holds what it is named for: frames of several
    64 KB blocks, linked (FLG 0x40), with matches into the previous block,
    and blocks stored raw."""
    path = tmp_path / "t.feather"
    write_pa(path, table(40_000), compression="lz4")
    data = path.read_bytes()
    frames = [lz4_frame_blocks(data, i) for i in range(len(data) - 4)
              if data[i : i + 4] == b"\x04\x22\x4d\x18"]
    multi = [(flg, blocks) for flg, blocks in frames if len(blocks) > 1]
    assert multi and all(flg & 0x20 == 0 for flg, _ in multi)
    assert sum(e for _, blocks in multi for _, e in blocks) > 0
    assert any(raw for _, blocks in frames for raw, _ in blocks)


@pytest.mark.parametrize("index_type", [pa.int8(), pa.uint8(), pa.int16(), pa.int32(),
                                        pa.uint32(), pa.int64()])
@pytest.mark.parametrize("compression", [None, "lz4"])
def test_dictionary_columns(tmp_path, index_type, compression):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 4, 500)
    t = pa.table({
        "cat": pa.DictionaryArray.from_arrays(pa.array(idx, index_type),
                                              pa.array(["VEHICLE", "PEDESTRIAN", "", "é"])),
        "num": pa.DictionaryArray.from_arrays(pa.array(idx, index_type),
                                              pa.array([1.5, -2.0, 3.25, 0.0])),
    })
    write_pa(tmp_path / "d.feather", t, compression=compression)
    got = assert_equal_to_jax(tmp_path / "d.feather")
    assert list(got["cat"][:5]) == [["VEHICLE", "PEDESTRIAN", "", "é"][i] for i in idx[:5]]


def test_dictionary_as_pandas_writes_it(tmp_path):
    """A dictionary of ``a, b, a, c, a`` (what a pandas ``category`` column
    becomes) decodes to the strings."""
    write_pa(tmp_path / "p.feather",
             pa.table({"c": pa.array(["a", "b", "a", "c", "a"]).dictionary_encode()}),
             compression="lz4")
    got = assert_equal_to_jax(tmp_path / "p.feather")
    assert got["c"].tolist() == ["a", "b", "a", "c", "a"]


@pytest.mark.parametrize("compression", [None, "lz4"])
def test_delta_dictionaries(tmp_path, compression):
    b1 = pa.record_batch({"d": pa.DictionaryArray.from_arrays(
        pa.array([0, 1, 0], pa.int8()), pa.array(["a", "b"]))})
    b2 = pa.record_batch({"d": pa.DictionaryArray.from_arrays(
        pa.array([2, 1, 0], pa.int8()), pa.array(["a", "b", "c"]))})
    opts = paipc.IpcWriteOptions(compression=compression, emit_dictionary_deltas=True)
    with paipc.new_file(str(tmp_path / "delta.feather"), b1.schema, options=opts) as w:
        w.write_batch(b1)
        w.write_batch(b2)
    got = assert_equal_to_jax(tmp_path / "delta.feather")
    assert got["d"].tolist() == ["a", "b", "a", "c", "b", "a"]


def test_raw_stored_buffers(tmp_path):
    """Buffers stored raw (uncompressed length ``-1``), as Arrow writers do
    where compression does not pay, beside compressed ones."""
    rng = np.random.default_rng(2)
    cols = {"x": rng.normal(size=20_000), "z": np.zeros(20_000), "s": np.asarray(["ab"] * 5)}
    cols["s"] = np.resize(cols["s"], 20_000)
    counts = chip_smoke.write_feather_lz4(tmp_path / "raw.feather", cols)
    assert counts["raw"] > 0 and counts["lz4"] > 0
    got = assert_equal_to_jax(tmp_path / "raw.feather")
    np.testing.assert_array_equal(got["x"], cols["x"])


def test_zstd_raises_and_names_it(tmp_path):
    """ZSTD bodies read (the name is kept from when they raised)."""
    write_pa(tmp_path / "z.feather", table(100), compression="zstd")
    assert_equal_to_jax(tmp_path / "z.feather")


def test_dictionary_with_nulls_raises(tmp_path):
    """A dictionary column's null reads ``None`` (the name is kept from
    when it raised); the JAX reader gives the value under the null's
    index there, so only the other slots are held to it."""
    write_pa(tmp_path / "n.feather",
             pa.table({"c": pa.array(["a", None, "b"]).dictionary_encode()}), compression="lz4")
    got = read_feather(tmp_path / "n.feather")["c"]
    want = jread(tmp_path / "n.feather")["c"]
    assert got.dtype == object and list(got) == ["a", None, "b"]
    assert [want[0], want[2]] == ["a", "b"]


def test_port_writes_float16(tmp_path):
    x = (np.random.default_rng(3).normal(size=50) * 100).astype(np.float16)
    write_feather(tmp_path / "h.feather", {"x": x, "n": np.arange(50, dtype=np.uint32)})
    back = jread(tmp_path / "h.feather")
    assert back["x"].dtype == np.float16
    assert np.array_equal(back["x"].view(np.uint16), x.view(np.uint16))
    assert read_feather(tmp_path / "h.feather")["x"].dtype == np.float16
