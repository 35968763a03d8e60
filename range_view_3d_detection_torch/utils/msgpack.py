"""The msgpack that ``flax.serialization`` writes and reads, without the
``msgpack`` package (the card's machine has none).

:func:`msgpack_serialize` gives the bytes ``flax.serialization.
msgpack_serialize`` gives for the same tree, and :func:`msgpack_restore`
reads them back as ``flax.serialization.msgpack_restore`` does:

- nil, bool, ints, float32/64, str, bin, arrays (lists) and maps (dicts
  with str keys), in every width msgpack defines; Python floats are
  written as float64, ints in the narrowest form, as msgpack-python does;
- ext type 1, an ndarray: a packed ``(shape, dtype name, C-order
  bytes)``; ext type 3, a numpy scalar, the same for a 0-d array. Numpy
  arrays and scalars and torch tensors are written so; ``bfloat16``
  (which numpy lacks) reads back as a torch ``bfloat16`` tensor;
- map keys are written sorted, as flax writes them;
- flax's chunked arrays: an array of more than :data:`MAX_CHUNK_SIZE`
  bytes that is a map value (or the whole tree) is written as
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
  {...}}`` of flat pieces, and such a map is joined on read.

Anything else (tuples, complex numbers, ext type 2 or another code,
object or structured dtypes, non-str map keys) raises and names what it
met.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
_DTYPES = {
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64", "bfloat16",
}

# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return struct.pack("B", v)
    if -0x20 <= v < 0:
        return struct.pack("b", v)
    if 0 < v <= 0xFF:
        return b"\xcc" + struct.pack("B", v)
    if -0x80 <= v < 0:
        return b"\xd0" + struct.pack("b", v)
    if 0 < v <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", v)
    if -0x8000 <= v < 0:
        return b"\xd1" + struct.pack(">h", v)
    if 0 < v <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", v)
    if -0x80000000 <= v < 0:
        return b"\xd2" + struct.pack(">i", v)
    if 0 < v <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", v)
    if -0x8000000000000000 <= v < 0:
        return b"\xd3" + struct.pack(">q", v)
    raise OverflowError(f"msgpack: int {v} does not fit 64 bits")


def _sized(n: int, fix: Tuple[int, int] | None, forms) -> bytes:
    """Header of a str/bin/array/map of length ``n``: the fix form
    ``(tag, max)`` if it fits, else the first of ``forms`` ((tag, fmt,
    max)) that does."""
    if fix is not None and n <= fix[1]:
        return struct.pack("B", fix[0] | n)
    for tag, fmt, top in forms:
        if n <= top:
            return struct.pack("B", tag) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xA0, 31), ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF)))
_BIN = (None, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF)))
_ARRAY = ((0x90, 15), ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))
_MAP = ((0x80, 15), ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("B", fixed[n])
    elif n <= 0xFF:
        head = b"\xc7" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack("b", code) + data


def _array_parts(x) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    x = np.asarray(x)
    name = x.dtype.name
    if x.dtype.hasobject or x.dtype.isalignedstruct or name not in _DTYPES:
        raise TypeError(f"msgpack: arrays of dtype {x.dtype} are not supported")
    return tuple(int(s) for s in x.shape), name, x.tobytes("C")


def _ndarray_bytes(x) -> bytes:
    shape, name, buf = _array_parts(x)
    out = [_sized(3, *_ARRAY), _sized(len(shape), *_ARRAY)]
    out += [_int(s) for s in shape]
    raw = name.encode()
    out += [_sized(len(raw), *_STR), raw, _sized(len(buf), *_BIN), buf]
    return b"".join(out)


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        raw = x.encode("utf-8")
        out.append(_sized(len(raw), *_STR) + raw)
    elif type(x) is bytes:
        out.append(_sized(len(x), *_BIN) + x)
    elif type(x) is list:
        out.append(_sized(len(x), *_ARRAY))
        for v in x:
            _pack(v, out)
    elif type(x) is dict:
        out.append(_sized(len(x), *_MAP))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)) and (
        not isinstance(x, torch.Tensor) or x.dim() > 0
    ):
        out.append(_ext(_EXT_NDARRAY, _ndarray_bytes(x)))
    elif isinstance(x, (np.generic, torch.Tensor)):
        out.append(_ext(_EXT_NPSCALAR, _ndarray_bytes(x)))
    else:
        raise TypeError(f"msgpack: cannot serialize {type(x).__name__!r} object")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's chunked form of an array above :data:`MAX_CHUNK_SIZE` bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {
        _CHUNKED: True,
        "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
        "chunks": {str(j): flat[i: i + size] for j, i in enumerate(range(0, n, size))},
    }


def _sorted_keys(x):
    """The tree with every map's keys sorted, as flax's copy of the tree
    (``jax.tree_util.tree_map``) leaves them."""
    if type(x) is dict:
        return {k: _sorted_keys(x[k]) for k in sorted(x)}
    if type(x) is list:
        return [_sorted_keys(v) for v in x]
    return x


def _chunk_leaves(x):
    is_array = isinstance(x, (np.ndarray, torch.Tensor))
    if is_array and _nbytes(x) > MAX_CHUNK_SIZE:
        return _chunk(x)
    if type(x) is dict:
        return {k: _chunk_leaves(v) for k, v in x.items()}
    return x


def msgpack_serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``: the tree's bytes,
    map keys sorted."""
    out: list = []
    _pack(_chunk_leaves(_sorted_keys(tree)), out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: data ends inside an object")
        view = self.data[self.pos: self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False):
        tag = self.unpack("B")
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F, raw)
        if 0x90 <= tag <= 0x9F:
            return [self.obj(raw) for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self.str(tag & 0x1F, raw)
        simple = {
            0xC0: None, 0xC2: False, 0xC3: True,
        }
        if tag in simple:
            return simple[tag]
        formats = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if tag in formats:
            return self.unpack(formats[tag])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                   0xDE: ">H", 0xDF: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if tag in fixext:
            return self.ext(fixext[tag])
        if tag not in lengths:
            raise ValueError(f"msgpack: unknown type byte 0x{tag:02x}")
        n = self.unpack(lengths[tag])
        if tag <= 0xC6:
            return bytes(self.take(n))
        if tag <= 0xC9:
            return self.ext(n)
        if tag <= 0xDB:
            return self.str(n, raw)
        if tag <= 0xDD:
            return [self.obj(raw) for _ in range(n)]
        return self.map(n, raw)

    def str(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack: map key of type {type(k).__name__} "
                                 "(only str keys are read)")
            out[k] = self.obj(raw)
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray_from_bytes(data)
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == _EXT_COMPLEX:
            raise TypeError("msgpack: complex numbers (ext type 2) are not supported")
        raise TypeError(f"msgpack: ext type {code} is not supported")


def _ndarray_from_bytes(data: bytes):
    reader = _Reader(data)
    shape, name, buf = reader.obj(raw=True)
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes in an ndarray")
    name = name.decode()
    if name not in _DTYPES:
        raise TypeError(f"msgpack: arrays of dtype {name!r} are not supported")
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(buf, np.dtype(name)).reshape(tuple(shape)).copy()


def _unchunk_leaves(x):
    if type(x) is dict:
        if _CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            parts = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            if isinstance(parts[0], torch.Tensor):
                return torch.cat(parts).reshape(shape)
            return np.concatenate(parts).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in x.items()}
    return x


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the tree, arrays as
    numpy (``bfloat16`` as torch tensors), chunked arrays joined."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the tree")
    return _unchunk_leaves(tree)
