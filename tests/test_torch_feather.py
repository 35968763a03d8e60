"""The port's Feather (Arrow IPC file) reader and writer against pyarrow.

- Every column type the converters, the synthetic generator and the
  prediction shards write (bool, int8-64, uint8-64, float32/64, utf8 from
  numpy unicode and from object arrays of ``str``), at lengths 0, 1 and
  37: the port's files read by pyarrow equal the input, and files written
  by pyarrow (the JAX ``write_feather``) read by the port equal what the
  JAX ``read_feather`` gives, dtype included; ``columns=`` selects in
  order.
- The files of the JAX synthetic generator read equal through both.
- What the port does not read raises and names it: a corrupt LZ4 or ZSTD
  frame, nested lists; the writer refuses dtypes Arrow files do not hold
  here. Nulls (also in dictionary and large-string columns) read as
  pyarrow's ``to_numpy`` gives them (they raised until the reader took
  validity bitmaps). (LZ4 and ZSTD bodies, ``float16``, large strings,
  binary and dictionaries read: ``test_torch_feather_codecs.py``,
  ``test_torch_feather_zstd.py``.)
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest

from range_view_3d_detection_torch.utils.feather import FeatherError, read_feather, write_feather
from range_view_3d_detection_tpu.data.synthetic import generate_dataset as jgenerate
from range_view_3d_detection_tpu.utils.feather import read_feather as jread
from range_view_3d_detection_tpu.utils.feather import write_feather as jwrite

NUMERIC = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
           "float32", "float64")


def columns(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    cols = {t: (rng.normal(size=n) * 50).astype(t) for t in NUMERIC}
    cols["flag"] = rng.uniform(size=n) < 0.5
    cols["category"] = np.asarray([f"CAT_{i % 5}" for i in range(n)], dtype=object)
    cols["log_id"] = np.asarray([f"log-{i}-é" for i in range(n)])  # numpy unicode
    cols["empty_str"] = np.asarray(["" if i % 2 else "x" for i in range(n)], dtype=object)
    return cols


def assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert got[k].shape == want[k].shape, k
        if want[k].dtype == object:
            assert list(got[k]) == list(want[k]), k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n", [0, 1, 37])
def test_port_writer_reads_back_in_pyarrow(tmp_path, n):
    cols = columns(n)
    write_feather(tmp_path / "a.feather", cols)
    assert [p.name for p in tmp_path.iterdir()] == ["a.feather"]  # no temp file left
    table = paipc.open_file(pa.memory_map(str(tmp_path / "a.feather"))).read_all()
    assert table.num_rows == n
    for k, v in cols.items():
        got = table.column(k).to_numpy(zero_copy_only=False)
        if v.dtype.kind in "OU":
            assert table.schema.field(k).type == pa.string()
            assert list(got) == list(v)
        else:
            assert got.dtype == v.dtype
            np.testing.assert_array_equal(got, v)


@pytest.mark.parametrize("n", [0, 1, 37])
def test_port_reader_reads_pyarrow_files(tmp_path, n):
    jwrite(tmp_path / "a.feather", columns(n, seed=1))
    assert_same(read_feather(tmp_path / "a.feather"), jread(tmp_path / "a.feather"))
    sel = read_feather(tmp_path / "a.feather", columns=["log_id", "int8"])
    assert_same(sel, jread(tmp_path / "a.feather", columns=["log_id", "int8"]))


def test_port_reader_reads_several_record_batches(tmp_path):
    a, b = columns(5, seed=2), columns(7, seed=3)
    tables = [pa.table({k: pa.array(v) for k, v in c.items()}) for c in (a, b)]
    with paipc.new_file(str(tmp_path / "m.feather"), tables[0].schema) as w:
        for t in tables:
            w.write_table(t)
    assert_same(read_feather(tmp_path / "m.feather"), jread(tmp_path / "m.feather"))
    assert len(read_feather(tmp_path / "m.feather")["int32"]) == 12


def test_jax_synthetic_files_read_equal(tmp_path):
    root = jgenerate(tmp_path / "sensor", splits={"train": 1}, sweeps_per_log=2, height=8,
                     width=56, seed=4)
    files = sorted(root.rglob("*.feather"))
    assert len(files) == 3
    for f in files:
        assert_same(read_feather(f), jread(f))


def _write_pa(path, table, **options):
    opts = paipc.IpcWriteOptions(**options)
    with paipc.new_file(str(path), table.schema, options=opts) as w:
        w.write_table(table)


@pytest.mark.parametrize("codec,name", [("lz4", "LZ4_FRAME"), ("zstd", "ZSTD")])
def test_compressed_files_raise(tmp_path, codec, name):
    """A corrupt frame raises and names its codec: the buffer's
    uncompressed length, just before the frame's magic, is made wrong."""
    _write_pa(tmp_path / "c.feather", pa.table({"x": pa.array(np.arange(100.0))}),
              compression=codec)
    magic = b"\x04\x22\x4d\x18" if codec == "lz4" else b"\x28\xb5\x2f\xfd"
    data = bytearray((tmp_path / "c.feather").read_bytes())
    at = data.index(magic) - 8
    data[at : at + 8] = (801).to_bytes(8, "little")
    (tmp_path / "c.feather").write_bytes(bytes(data))
    with pytest.raises(FeatherError, match=name):
        read_feather(tmp_path / "c.feather")


@pytest.mark.parametrize("array,what", [
    (lambda: pa.array(["a", None, "a"]).dictionary_encode(), "dictionary"),
    (lambda: pa.array([1.0, None, 3.0]), "nulls"),
    (lambda: pa.array(["a", None], type=pa.large_string()), "LargeUtf8"),
    (lambda: pa.array([[1], [2, 3]]), "nested"),
])
def test_unsupported_columns_raise(tmp_path, array, what):
    """Nested columns raise and name it; the null-bearing ones, which
    raised until the reader took validity bitmaps, read as pyarrow's
    ``to_numpy`` gives them (the name is kept)."""
    _write_pa(tmp_path / "u.feather", pa.table({"x": array()}))
    if what == "nested":
        with pytest.raises(FeatherError, match=what):
            read_feather(tmp_path / "u.feather")
        return
    got = read_feather(tmp_path / "u.feather")["x"]
    want = array().to_numpy(zero_copy_only=False)
    assert got.dtype == want.dtype
    if want.dtype == object:
        assert list(got) == list(want)
    else:
        assert np.array_equal(got, want, equal_nan=True)


def test_writer_refuses_other_dtypes(tmp_path):
    with pytest.raises(FeatherError, match="complex64"):
        write_feather(tmp_path / "h.feather", {"x": np.zeros(3, np.complex64)})
    with pytest.raises(FeatherError, match="unequal"):
        write_feather(tmp_path / "h.feather", {"x": np.zeros(3), "y": np.zeros(2)})
