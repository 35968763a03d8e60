"""Feather (Arrow IPC file) reading and writing in numpy and the standard
library (counterpart of the JAX ``utils/feather.py``, which uses pyarrow).

A Feather file is an Arrow IPC file: the magic ``ARROW1``, a schema
message, dictionary and record batches and a footer that indexes them,
with the metadata of each as a flatbuffer. This module decodes and builds
those flatbuffers by hand for the columns the raw logs, the converters,
the synthetic generator and the prediction shards hold: bool, int8-64,
uint8-64, float16/32/64, utf8 and large utf8 strings, binary and large
binary, the null type, and dictionary-encoded columns of any of these
(int8-64 indices, delta dictionaries included). Results are what
pyarrow's ``to_numpy(zero_copy_only=False)`` gives: numeric columns come
back as numpy arrays of their type (``float16`` stays ``float16``),
strings and dictionaries of strings as an object array of ``str``, binary
columns as one of ``bytes``. A column with nulls (a validity bitmap) keeps
a float dtype with NaN at each null, turns integers into float64 with
NaN, and bool, string and binary columns into object arrays with
``None``; a dictionary column's null index gives the same (the index
buffer under a null slot is not read).

Record batches compressed with ``LZ4_FRAME`` (pyarrow's default for
Feather V2) or ``ZSTD`` are read: each non-empty buffer starts with its
uncompressed length as an int64 (``-1``: the rest is stored raw),
followed by a frame that ``data/native_io.py::lz4_frame_decompress`` or
``zstd_frame_decompress`` decodes. Nested and other columns raise and
name what they met; so does a replacement dictionary, which the IPC file
format forbids.

The writer writes uncompressed files of one record batch, as the JAX
writer does.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"ARROW1"
_V5 = 4  # MetadataVersion.V5
_SCHEMA, _DICTIONARY_BATCH, _RECORD_BATCH = 1, 2, 3  # MessageHeader union
_NULL, _INT, _FLOAT, _BINARY, _UTF8, _BOOL = 1, 2, 3, 4, 5, 6  # Type union
_LARGE_BINARY, _LARGE_UTF8 = 19, 20
_TYPE_NAMES = {
    0: "NONE", 1: "Null", 2: "Int", 3: "FloatingPoint", 4: "Binary", 5: "Utf8",
    6: "Bool", 7: "Decimal", 8: "Date", 9: "Time", 10: "Timestamp",
    11: "Interval", 12: "List", 13: "Struct", 14: "Union",
    15: "FixedSizeBinary", 16: "FixedSizeList", 17: "Map", 18: "Duration",
    19: "LargeBinary", 20: "LargeUtf8", 21: "LargeList", 22: "RunEndEncoded",
    23: "BinaryView", 24: "Utf8View", 25: "ListView", 26: "LargeListView",
}
_CODECS = {0: "LZ4_FRAME", 1: "ZSTD"}
_FLOAT_DTYPES = {0: np.float16, 1: np.float32, 2: np.float64}  # Precision HALF..DOUBLE
_PRECISION = {2: 0, 4: 1, 8: 2}  # itemsize -> Precision


class FeatherError(ValueError):
    """A Feather file this reader does not take, or a malformed one."""


# -- flatbuffer decoding ------------------------------------------------------


class _Table:
    """A flatbuffer table at ``pos`` of ``buf``; fields by their id."""

    def __init__(self, buf: memoryview, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_size = struct.unpack_from("<H", buf, self.vt)[0]

    def _off(self, field: int) -> int:
        at = 4 + 2 * field
        return struct.unpack_from("<H", self.buf, self.vt + at)[0] if at < self.vt_size else 0

    def scalar(self, field: int, fmt: str, default):
        off = self._off(field)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0] if off else default

    def _target(self, field: int) -> Optional[int]:
        off = self._off(field)
        if not off:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, field: int) -> Optional["_Table"]:
        t = self._target(field)
        return None if t is None else _Table(self.buf, t)

    def string(self, field: int) -> Optional[str]:
        t = self._target(field)
        if t is None:
            return None
        n = struct.unpack_from("<I", self.buf, t)[0]
        return bytes(self.buf[t + 4 : t + 4 + n]).decode("utf-8")

    def vector_len(self, field: int) -> int:
        t = self._target(field)
        return 0 if t is None else struct.unpack_from("<I", self.buf, t)[0]

    def tables(self, field: int) -> List["_Table"]:
        t = self._target(field)
        if t is None:
            return []
        n = struct.unpack_from("<I", self.buf, t)[0]
        out = []
        for i in range(n):
            at = t + 4 + 4 * i
            out.append(_Table(self.buf, at + struct.unpack_from("<I", self.buf, at)[0]))
        return out

    def structs(self, field: int, fmt: str) -> List[Tuple]:
        t = self._target(field)
        if t is None:
            return []
        n = struct.unpack_from("<I", self.buf, t)[0]
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, t + 4 + i * size) for i in range(n)]


def _root(buf: memoryview) -> _Table:
    return _Table(buf, struct.unpack_from("<I", buf, 0)[0])


# -- reading -------------------------------------------------------------------


class _Spec(NamedTuple):
    """How to decode one schema ``Field``: its values' kind and dtype, and
    for a dictionary-encoded field its dictionary id and index dtype."""

    name: str
    what: str  # the Arrow type, for error messages
    kind: str  # "fixed", "bool", "utf8", "large_utf8", "binary", "large_binary" or "null"
    dtype: Any
    dict_id: Optional[int] = None
    index_dtype: Any = None


def _int_dtype(t: _Table) -> np.dtype:
    bits, signed = t.scalar(0, "i", 0), bool(t.scalar(1, "B", 0))
    if bits not in (8, 16, 32, 64):
        raise FeatherError(f"{bits}-bit integers are not supported")
    return np.dtype(f"{'i' if signed else 'u'}{bits // 8}").newbyteorder("<")


def _field_spec(field: _Table) -> _Spec:
    """The ``_Spec`` of a schema ``Field``."""
    name = field.string(0) or ""
    type_id = field.scalar(2, "B", 0)
    what = _TYPE_NAMES.get(type_id, f"type {type_id}")
    if field.vector_len(5):
        raise FeatherError(f"column {name!r}: nested type {what} is not supported")
    t = field.table(3)
    if type_id == _INT:
        spec = _Spec(name, what, "fixed", _int_dtype(t))
    elif type_id == _FLOAT:
        precision = t.scalar(0, "h", 0)
        if precision not in _FLOAT_DTYPES:
            raise FeatherError(f"column {name!r}: float precision {precision} is not supported")
        spec = _Spec(name, what, "fixed", np.dtype(_FLOAT_DTYPES[precision]).newbyteorder("<"))
    elif type_id == _BOOL:
        spec = _Spec(name, what, "bool", None)
    elif type_id == _UTF8:
        spec = _Spec(name, what, "utf8", None)
    elif type_id == _LARGE_UTF8:
        spec = _Spec(name, what, "large_utf8", None)
    elif type_id == _BINARY:
        spec = _Spec(name, what, "binary", None)
    elif type_id == _LARGE_BINARY:
        spec = _Spec(name, what, "large_binary", None)
    elif type_id == _NULL:
        spec = _Spec(name, what, "null", None)
    else:
        raise FeatherError(f"column {name!r}: Arrow type {what} is not supported")
    enc = field.table(4)  # DictionaryEncoding
    if enc is None:
        return spec
    index = enc.table(1)  # absent: int32
    index_dtype = _int_dtype(index) if index is not None else np.dtype("<i4")
    return spec._replace(what=f"dictionary of {what}", dict_id=enc.scalar(0, "q", 0),
                         index_dtype=index_dtype)


def _decode_utf8(offsets: np.ndarray, data: bytes) -> np.ndarray:
    out = np.empty(len(offsets) - 1, dtype=object)
    text = data.decode("utf-8")
    if len(text) == len(data):  # ASCII: byte offsets are character offsets
        for i in range(len(out)):
            out[i] = text[offsets[i] : offsets[i + 1]]
    else:
        for i in range(len(out)):
            out[i] = data[offsets[i] : offsets[i + 1]].decode("utf-8")
    return out


def _decode_binary(offsets: np.ndarray, data: bytes) -> np.ndarray:
    out = np.empty(len(offsets) - 1, dtype=object)
    for i in range(len(out)):
        out[i] = data[offsets[i] : offsets[i + 1]]
    return out


def _with_nulls(values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """``values`` with a null at each slot ``valid`` clears, as pyarrow's
    ``to_numpy(zero_copy_only=False)`` gives them: NaN in a float array,
    integers as float64 with NaN, ``None`` in an object array (bool,
    strings, bytes)."""
    if values.dtype == np.float16:  # pyarrow's half NaN is 0x7fff
        out = values.copy()
        out.view(np.uint16)[~valid] = 0x7FFF
    elif values.dtype.kind == "f":
        out = values.copy()
        out[~valid] = np.nan
    elif values.dtype.kind in "iu":
        out = values.astype(np.float64)
        out[~valid] = np.nan
    else:
        out = values.astype(object)
        out[~valid] = None
    return out


def _header(raw: memoryview, block: Tuple[int, int, int], header_type: int, what: str) -> _Table:
    """The header table of the message a footer ``Block`` points to."""
    offset, meta_len, _ = block
    start = offset + 8 if struct.unpack_from("<I", raw, offset)[0] == 0xFFFFFFFF else offset + 4
    msg = _root(raw[start : offset + meta_len])
    if msg.scalar(1, "B", 0) != header_type:
        raise FeatherError(f"footer block is not a {what}")
    return msg.table(2)


def _body_buffers(raw: memoryview, rb: _Table, body: int) -> Callable[[int], Any]:
    """Buffer ``i`` of the record batch ``rb`` whose body starts at
    ``body``, decompressed when the batch is."""
    buffers = rb.structs(2, "qq")
    comp = rb.table(3)  # BodyCompression
    if comp is None:
        return lambda i: raw[body + buffers[i][0] : body + buffers[i][0] + buffers[i][1]]
    codec, method = comp.scalar(0, "b", 0), comp.scalar(1, "b", 0)
    if codec not in _CODECS:
        raise FeatherError(f"compressed record batch (codec {codec}) is not supported")
    if method != 0:  # BodyCompressionMethod.BUFFER
        raise FeatherError(f"body compression method {method} is not supported")
    from range_view_3d_detection_torch.data import native_io

    name = _CODECS[codec]
    decompress = (native_io.lz4_frame_decompress if name == "LZ4_FRAME"
                  else native_io.zstd_frame_decompress)

    def buf(i: int):
        off, n = buffers[i]
        if n == 0:  # an empty buffer carries no length prefix
            return raw[0:0]
        if n < 8:
            raise FeatherError(f"compressed buffer of {n} bytes has no length prefix")
        size = struct.unpack_from("<q", raw, body + off)[0]
        data = raw[body + off + 8 : body + off + n]
        if size == -1:  # stored raw
            return data
        try:
            return memoryview(decompress(data, size))
        except ValueError as exc:
            raise FeatherError(f"{name} buffer: {exc}") from exc

    return buf


def _read_column(spec: _Spec, node: Tuple[int, int], buf: Callable[[int], Any], bi: int):
    """Decode one column whose buffers start at ``bi``: (array, validity
    or None when the column has no nulls, next ``bi``). A
    dictionary-encoded column gives its indices (0 under a null)."""
    n, nulls = node
    if spec.kind == "null":  # no buffers
        return np.full(n, None, dtype=object), None, bi
    valid = None
    if nulls:
        bits = np.frombuffer(buf(bi), dtype=np.uint8)
        if len(bits) * 8 < n:
            raise FeatherError(f"column {spec.name!r}: validity bitmap of {len(bits)} bytes")
        valid = np.unpackbits(bits, count=n, bitorder="little").astype(bool)
    if spec.dict_id is not None:
        idx = np.frombuffer(buf(bi + 1), dtype=spec.index_dtype, count=n)
        idx = idx.astype(spec.index_dtype.newbyteorder("="))
        if valid is not None:
            idx = np.where(valid, idx, 0)
        return idx, valid, bi + 2
    if spec.kind == "fixed":
        col = np.frombuffer(buf(bi + 1), dtype=spec.dtype, count=n)
        return col.astype(spec.dtype.newbyteorder("=")), valid, bi + 2
    if spec.kind == "bool":
        bits = np.frombuffer(buf(bi + 1), dtype=np.uint8)
        return np.unpackbits(bits, count=n, bitorder="little").astype(bool), valid, bi + 2
    off_dtype = "<i4" if spec.kind in ("utf8", "binary") else "<i8"
    offs = np.frombuffer(buf(bi + 1), dtype=off_dtype, count=n + 1) if n else np.zeros(1, np.int64)
    decode = _decode_utf8 if spec.kind in ("utf8", "large_utf8") else _decode_binary
    return decode(offs, bytes(buf(bi + 2))), valid, bi + 3


def _read_dictionaries(raw: memoryview, blocks, specs: List[_Spec]) -> Dict[int, np.ndarray]:
    """The values of every dictionary, deltas appended in file order."""
    by_id = {s.dict_id: s._replace(dict_id=None) for s in specs if s.dict_id is not None}
    out: Dict[int, np.ndarray] = {}
    for block in blocks:
        db = _header(raw, block, _DICTIONARY_BATCH, "dictionary batch")
        dict_id, is_delta = db.scalar(0, "q", 0), bool(db.scalar(2, "B", 0))
        if dict_id not in by_id:
            raise FeatherError(f"dictionary {dict_id} belongs to no column")
        rb = db.table(1)
        nodes = rb.structs(1, "qq")
        if len(nodes) != 1:
            raise FeatherError(f"dictionary {dict_id}: {len(nodes)} columns")
        values, valid, _ = _read_column(by_id[dict_id], nodes[0],
                                        _body_buffers(raw, rb, block[0] + block[1]), 0)
        if valid is not None:
            values = _with_nulls(values, valid)
        if dict_id in out and not is_delta:
            raise FeatherError(f"dictionary {dict_id}: a replacement dictionary (the IPC "
                               "file format forbids them)")
        out[dict_id] = np.concatenate([out[dict_id], values]) if dict_id in out else values
    return out


def _read_batch(
    raw: memoryview, block: Tuple[int, int, int], specs: List[_Spec],
    dictionaries: Dict[int, np.ndarray],
) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Each column of one record batch: (values, validity or None)."""
    rb = _header(raw, block, _RECORD_BATCH, "record batch")
    nodes = rb.structs(1, "qq")
    buf = _body_buffers(raw, rb, block[0] + block[1])
    cols, bi = [], 0
    for spec, node in zip(specs, nodes):
        col, valid, bi = _read_column(spec, node, buf, bi)
        if spec.dict_id is not None:
            values = dictionaries.get(spec.dict_id)
            if values is None:
                raise FeatherError(f"column {spec.name!r}: dictionary {spec.dict_id} is missing")
            live = col if valid is None else col[valid]
            if len(live) and (live.min() < 0 or live.max() >= len(values)):
                raise FeatherError(f"column {spec.name!r}: dictionary index out of range")
            col = values[col] if len(values) else np.zeros(len(col), values.dtype)
        cols.append((col, valid))
    return cols


def read_feather(
    path: str | Path, columns: Optional[Sequence[str]] = None
) -> Dict[str, np.ndarray]:
    """Read a Feather (Arrow IPC) file into a dict of numpy columns,
    ``columns`` only (in that order) when given."""
    data = Path(path).read_bytes()
    raw = memoryview(data)
    if len(data) < 18 or data[:6] != MAGIC or data[-6:] != MAGIC:
        raise FeatherError(f"{path}: not an Arrow IPC file (Feather V2)")
    footer_len = struct.unpack_from("<i", raw, len(data) - 10)[0]
    footer = _root(raw[len(data) - 10 - footer_len : len(data) - 10])
    schema = footer.table(1)
    if schema.scalar(0, "h", 0) != 0:
        raise FeatherError(f"{path}: big-endian files are not supported")
    specs = [_field_spec(f) for f in schema.tables(1)]
    dictionaries = _read_dictionaries(raw, footer.structs(2, "qi4xq"), specs)
    parts: List[list] = [[] for _ in specs]
    for block in footer.structs(3, "qi4xq"):
        for ci, col in enumerate(_read_batch(raw, block, specs, dictionaries)):
            parts[ci].append(col)
    out: Dict[str, np.ndarray] = {}
    for spec, p in zip(specs, parts):
        if p:
            # One null anywhere in the column sets the form of all of it.
            if any(valid is not None for _, valid in p):
                p = [_with_nulls(v, np.ones(len(v), bool) if m is None else m) for v, m in p]
            else:
                p = [v for v, _ in p]
            out[spec.name] = np.concatenate(p) if len(p) > 1 else p[0]
        else:
            empty = {"bool": bool, "fixed": spec.dtype}.get(spec.kind, object)
            out[spec.name] = np.empty(0, dtype=np.dtype(empty).newbyteorder("="))
    if columns:
        missing = [c for c in columns if c not in out]
        if missing:
            raise KeyError(f"{path}: no column(s) {missing}")
        out = {c: out[c] for c in columns}
    return out


# -- flatbuffer building ------------------------------------------------------


class _Builder:
    """Builds a flatbuffer front to back: each object is written before
    the objects it points to, so every ``uoffset`` points forward."""

    def __init__(self):
        self.buf = bytearray()

    def _align(self, n: int) -> None:
        self.buf += b"\0" * (-len(self.buf) % n)

    def table(self, fields: Sequence[Optional[Tuple[str, Any]]]) -> int:
        """Write a table; ``fields[i]`` is ``(fmt, value)`` for a scalar
        (``struct`` format letter) or ``("ref", writer)`` for an offset to
        an object that ``writer()`` writes and returns the position of."""
        layout, size = [], 4
        for fid, f in enumerate(fields):
            if f is None:
                continue
            width = 4 if f[0] == "ref" else struct.calcsize("<" + f[0])
            size += -size % width
            layout.append((fid, f, size))
            size += width
        size += -size % 8
        vt = [4 + 2 * len(fields), size] + [0] * len(fields)
        for fid, _, at in layout:
            vt[2 + fid] = at
        self._align(2)
        vt_pos = len(self.buf)
        self.buf += struct.pack(f"<{len(vt)}H", *vt)
        self._align(8)
        pos = len(self.buf)
        self.buf += b"\0" * size
        struct.pack_into("<i", self.buf, pos, pos - vt_pos)
        for fid, (fmt, value), at in layout:
            if fmt != "ref":
                struct.pack_into("<" + fmt, self.buf, pos + at, value)
        for fid, (fmt, value), at in layout:
            if fmt == "ref":
                target = value()
                struct.pack_into("<I", self.buf, pos + at, target - (pos + at))
        return pos

    def string(self, s: str) -> int:
        b = s.encode("utf-8")
        self._align(4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(b)) + b + b"\0"
        return pos

    def structs(self, fmt: str, items: Sequence[Tuple]) -> int:
        self.buf += b"\0" * (-(len(self.buf) + 4) % 8)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(items))
        for it in items:
            self.buf += struct.pack("<" + fmt, *it)
        return pos

    def tables(self, writers: Sequence[Callable[[], int]]) -> int:
        self._align(4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(writers)) + b"\0" * (4 * len(writers))
        for i, w in enumerate(writers):
            at = pos + 4 + 4 * i
            struct.pack_into("<I", self.buf, at, w() - at)
        return pos

    def finish(self, root: Callable[["_Builder"], int]) -> bytes:
        self.buf += b"\0" * 8  # root uoffset, padded so tables stay 8-aligned
        struct.pack_into("<I", self.buf, 0, root(self))
        self._align(8)
        return bytes(self.buf)


# -- writing -------------------------------------------------------------------


def _column_kind(name: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    if v.ndim != 1:
        raise FeatherError(f"column {name!r}: {v.ndim}-d arrays are not supported")
    if v.dtype == bool:
        return "bool", v
    if v.dtype.kind in "iu" or v.dtype in (np.float16, np.float32, np.float64):
        return "fixed", v.astype(v.dtype.newbyteorder("<"))
    if v.dtype.kind == "U" or (v.dtype == object and all(isinstance(x, str) for x in v)):
        return "utf8", v
    raise FeatherError(f"column {name!r}: numpy dtype {v.dtype} is not supported")


def _type_fields(kind: str, v: np.ndarray):
    """(Type union id, writer of the type table)."""
    if kind == "bool":
        return _BOOL, []
    if kind == "utf8":
        return _UTF8, []
    if v.dtype.kind == "f":
        return _FLOAT, [("h", _PRECISION[v.dtype.itemsize])]
    return _INT, [("i", 8 * v.dtype.itemsize), ("B", int(v.dtype.kind == "i"))]


def _schema_writer(b: _Builder, cols: List[Tuple[str, str, np.ndarray]]) -> Callable[[], int]:
    def field(name, kind, v):
        type_id, type_fields = _type_fields(kind, v)
        return lambda: b.table([
            ("ref", lambda: b.string(name)),
            ("B", 1),  # nullable, as pyarrow writes
            ("B", type_id),
            ("ref", lambda: b.table(type_fields)),
            None,
            ("ref", lambda: b.tables([])),  # children
        ])

    return lambda: b.table([
        ("h", 0),  # little endian
        ("ref", lambda: b.tables([field(*c) for c in cols])),
    ])


def _message(header_type: int, header: Callable[[_Builder], Callable[[], int]], body_len: int) -> bytes:
    """An encapsulated message: continuation, metadata length, the
    flatbuffer ``Message``, padded to 8 bytes."""
    b = _Builder()
    fb = b.finish(lambda b: b.table([
        ("h", _V5),
        ("B", header_type),
        ("ref", header(b)),
        ("q", body_len),
    ]))
    return struct.pack("<Ii", 0xFFFFFFFF, len(fb)) + fb


def _body(cols: List[Tuple[str, str, np.ndarray]]):
    """(body bytes, FieldNodes, Buffers) of one record batch."""
    chunks: List[bytes] = []
    buffers: List[Tuple[int, int]] = []
    pos = 0

    def add(data: bytes) -> None:
        nonlocal pos
        buffers.append((pos, len(data)))
        pad = -len(data) % 8
        chunks.append(data + b"\0" * pad)
        pos += len(data) + pad

    nodes = []
    for name, kind, v in cols:
        nodes.append((len(v), 0))
        add(b"")  # no validity bitmap: no nulls
        if kind == "fixed":
            add(v.tobytes())
        elif kind == "bool":
            add(np.packbits(v, bitorder="little").tobytes())
        else:
            encoded = [str(s).encode("utf-8") for s in v]
            offsets = np.zeros(len(encoded) + 1, "<i4")
            if encoded:
                lengths = np.fromiter((len(e) for e in encoded), np.int64, len(encoded))
                total = np.cumsum(lengths)
                if total[-1] > np.iinfo(np.int32).max:
                    raise FeatherError(f"column {name!r}: over 2 GiB of text needs large_string")
                offsets[1:] = total
            add(offsets.tobytes())
            add(b"".join(encoded))
    return b"".join(chunks), nodes, buffers


def write_feather(path: str | Path, columns: Dict[str, np.ndarray]) -> None:
    """Write a dict of equal-length 1-d numpy columns as an uncompressed
    Feather (Arrow IPC) file of one record batch.

    The write is atomic (temporary file, then ``os.replace``), as the JAX
    ``write_feather``'s is."""
    path = Path(path)
    cols = []
    for name, v in columns.items():
        kind, arr = _column_kind(name, np.asarray(v))
        cols.append((str(name), kind, arr))
    lengths = {len(a) for _, _, a in cols}
    if len(lengths) > 1:
        raise FeatherError(f"columns of unequal lengths {sorted(lengths)}")
    n = lengths.pop() if lengths else 0

    schema_msg = _message(_SCHEMA, lambda b: _schema_writer(b, cols), 0)
    body, nodes, buffers = _body(cols)
    batch_msg = _message(
        _RECORD_BATCH,
        lambda b: lambda: b.table([
            ("q", n),
            ("ref", lambda: b.structs("qq", nodes)),
            ("ref", lambda: b.structs("qq", buffers)),
        ]),
        len(body),
    )
    head = MAGIC + b"\0\0"
    batch_at = len(head) + len(schema_msg)
    eos = struct.pack("<Ii", 0xFFFFFFFF, 0)
    fb = _Builder()
    footer = fb.finish(lambda b: b.table([
        ("h", _V5),
        ("ref", _schema_writer(b, cols)),
        ("ref", lambda: b.structs("qi4xq", [])),
        ("ref", lambda: b.structs("qi4xq", [(batch_at, len(batch_msg), len(body))])),
    ]))
    data = b"".join([
        head, schema_msg, batch_msg, body, eos, footer,
        struct.pack("<i", len(footer)), MAGIC,
    ])
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)
