"""ZSTD frame decoding in pure Python: the plain twin of
``native/zstd_frame.cpp`` (``data/native_io.py::zstd_frame_decompress``).

The tests and ``chip_smoke.py`` hold the native decoder against this one;
nothing on the data path uses it (it is several hundred times slower). It
follows RFC 8878 (Zstandard Compression and the 'application/zstd' Media
Type) step for step:

- concatenated frames and skippable frames; the frame header's window,
  dictionary id and content size; raw, RLE and compressed blocks of at
  most 128 KB; the XXH64 content checksum, verified where the descriptor
  sets it;
- literals stored raw, as one repeated byte, or Huffman-coded (with a
  new tree, or the previous block's: "treeless") in one or four streams;
  Huffman trees given as 4-bit weights or FSE-compressed ones;
- sequences whose literal-length, offset and match-length codes take the
  predefined distributions, a single (RLE) symbol, an FSE table read from
  the block, or the previous block's table; repeat offsets.

A frame that names a dictionary raises: the Feather files this reads
carry none. Every inconsistency (a bitstream that does not end where its
block does, an offset before the frame's start, a checksum that differs)
raises :class:`ZstdError`.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

MAGIC = 0xFD2FB528
_SKIPPABLE = range(0x184D2A50, 0x184D2A60)
_BLOCK_MAX = 128 * 1024
_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


class ZstdError(ValueError):
    """A corrupt, truncated or unsupported ZSTD frame."""


# -- XXH64 -------------------------------------------------------------------


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round64(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl64(acc, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (bytes-like)."""
    data = bytes(data)
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed & _M64,
             (seed - _P1) & _M64]
        stripes = n // 32
        lanes = struct.unpack_from(f"<{4 * stripes}Q", data)
        for s in range(stripes):
            for i in range(4):
                v[i] = _round64(v[i], lanes[4 * s + i])
        p = 32 * stripes
        h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
             + _rotl64(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round64(0, x)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round64(0, struct.unpack_from("<Q", data, p)[0])
        h = (_rotl64(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (struct.unpack_from("<I", data, p)[0] * _P1) & _M64
        h = (_rotl64(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl64(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


# -- bitstreams ------------------------------------------------------------------


class _Backward:
    """The backward bitstream of Huffman and FSE data: read from the end,
    highest bits first, after the end marker (the last byte's highest set
    bit). ``p`` counts the bits left; reading past the start gives zeros
    and makes it negative."""

    def __init__(self, data: bytes, what: str):
        if not data or data[-1] == 0:
            raise ZstdError(f"{what}: bitstream without its end marker")
        self.d = data
        self.p = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def peek(self, n: int) -> int:
        p = self.p - n
        if p >= 0:
            lo = p >> 3
            v = int.from_bytes(self.d[lo : (p + n + 7) >> 3], "little") >> (p & 7)
            return v & ((1 << n) - 1)
        top = self.p
        if top <= 0:
            return 0
        v = int.from_bytes(self.d[: (top + 7) >> 3], "little") & ((1 << top) - 1)
        return v << -p

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek(n)
        self.p -= n
        return v


# -- FSE ------------------------------------------------------------------------


class _FSE:
    """An FSE decoding table: for each state its symbol, the bits it reads
    and the base of the next state."""

    __slots__ = ("log", "sym", "nb", "new")

    def __init__(self, log: int, sym: List[int], nb: List[int], new: List[int]):
        self.log, self.sym, self.nb, self.new = log, sym, nb, new


def _read_ncount(data: bytes, pos: int, max_symbol: int, max_log: int, what: str):
    """An FSE table description at ``data[pos:]``: (normalized counts,
    accuracy log, position after it)."""
    bitpos = 8 * pos
    end = len(data)

    def peek(n: int) -> int:
        lo = bitpos >> 3
        return (int.from_bytes(data[lo : lo + 8], "little") >> (bitpos & 7)) & ((1 << n) - 1)

    if pos >= end:
        raise ZstdError(f"{what}: truncated FSE table description")
    log = peek(4) + 5
    bitpos += 4
    if log > max_log:
        raise ZstdError(f"{what}: FSE accuracy log {log} > {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    norm: List[int] = []
    prev0 = False
    while remaining > 1:
        if prev0:
            while True:
                rep = peek(2)
                bitpos += 2
                norm.extend([0] * rep)
                if rep != 3:
                    break
        if len(norm) > max_symbol:
            raise ZstdError(f"{what}: FSE table past symbol {max_symbol}")
        mx = (2 * threshold - 1) - remaining
        v = peek(nbits)
        if (v & (threshold - 1)) < mx:
            count = v & (threshold - 1)
            bitpos += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bitpos += nbits
        count -= 1
        remaining -= abs(count)
        if remaining < 1:
            raise ZstdError(f"{what}: FSE probabilities exceed the table")
        norm.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    after = (bitpos + 7) >> 3
    if after > end:
        raise ZstdError(f"{what}: truncated FSE table description")
    return norm, log, after


def _fse_table(norm: List[int], log: int, what: str) -> _FSE:
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = list(norm)
    for s, c in enumerate(norm):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
    step, mask, p = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise ZstdError(f"{what}: FSE counts do not fill the table")
    nb, new = [0] * size, [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        n = log - (x.bit_length() - 1)
        nb[u], new[u] = n, (x << n) - size
    return _FSE(log, sym, nb, new)


def _rle_table(symbol: int) -> _FSE:
    return _FSE(0, [symbol], [0], [0])


# The predefined distributions (RFC 8878 3.1.1.3.2.2).
_LL_NORM = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
            2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_NORM = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
            -1, -1, -1, -1, -1]
_OF_NORM = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
            -1, -1, -1, -1, -1]
# Literal-length and match-length codes: baselines and extra bits.
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                       16]


def _baselines(bits: List[int], first: int) -> List[int]:
    base, out = first, []
    for b in bits:
        out.append(base)
        base += 1 << b
    return out


_LL_BASE = _baselines(_LL_BITS, 0)
_ML_BASE = _baselines(_ML_BITS, 3)
# (kind, largest symbol, largest accuracy log, predefined table)
_KINDS = (
    ("literal lengths", 35, 9, _fse_table(_LL_NORM, 6, "predefined")),
    ("offsets", 31, 8, _fse_table(_OF_NORM, 5, "predefined")),
    ("match lengths", 52, 9, _fse_table(_ML_NORM, 6, "predefined")),
)


# -- Huffman --------------------------------------------------------------------


class _Huffman:
    __slots__ = ("bits", "sym", "nb")

    def __init__(self, bits: int, sym: bytes, nb: bytes):
        self.bits, self.sym, self.nb = bits, sym, nb


def _huffman_tree(blk: bytes, pos: int, end: int) -> Tuple[_Huffman, int]:
    """The Huffman tree description at ``blk[pos:end]``: (table, position
    after it)."""
    if pos >= end:
        raise ZstdError("Huffman tree: truncated")
    head = blk[pos]
    pos += 1
    if head >= 128:  # 4-bit weights, two a byte
        n = head - 127
        if pos + (n + 1) // 2 > end:
            raise ZstdError("Huffman tree: truncated weights")
        weights = [(blk[pos + i // 2] >> 4) if i % 2 == 0 else (blk[pos + i // 2] & 15)
                   for i in range(n)]
        pos += (n + 1) // 2
    else:  # FSE-compressed weights, two interleaved states
        if pos + head > end:
            raise ZstdError("Huffman tree: truncated FSE weights")
        data = blk[pos : pos + head]
        pos += head
        norm, log, at = _read_ncount(data, 0, 255, 6, "Huffman weights")
        t = _fse_table(norm, log, "Huffman weights")
        br = _Backward(data[at:], "Huffman weights")
        s1, s2 = br.read(log), br.read(log)
        weights = []
        while True:
            weights.append(t.sym[s1])
            s1 = t.new[s1] + br.read(t.nb[s1])
            if br.p < 0:
                weights.append(t.sym[s2])
                break
            weights.append(t.sym[s2])
            s2 = t.new[s2] + br.read(t.nb[s2])
            if br.p < 0:
                weights.append(t.sym[s1])
                break
            if len(weights) > 255:
                raise ZstdError("Huffman tree: over 255 weights")
    if len(weights) > 255:
        raise ZstdError("Huffman tree: over 255 weights")
    if any(w > 11 for w in weights):
        raise ZstdError("Huffman tree: a weight over 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman tree: no weights")
    bits = total.bit_length()
    left = (1 << bits) - total
    if bits > 11 or left & (left - 1):
        raise ZstdError("Huffman tree: weights do not complete a prefix code")
    weights.append(left.bit_length())
    sym, nb = bytearray(), bytearray()
    for w in range(1, bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                sym += bytes([s]) * (1 << (w - 1))
                nb += bytes([bits + 1 - w]) * (1 << (w - 1))
    return _Huffman(bits, bytes(sym), bytes(nb)), pos


def _huffman_stream(stream: bytes, n: int, table: _Huffman) -> bytes:
    br = _Backward(stream, "Huffman stream")
    out = bytearray(n)
    bits, sym, nb = table.bits, table.sym, table.nb
    for i in range(n):
        v = br.peek(bits)
        out[i] = sym[v]
        br.p -= nb[v]
    if br.p != 0:
        raise ZstdError("Huffman stream: does not end where its size says")
    return bytes(out)


# -- blocks ---------------------------------------------------------------------


class _FrameState:
    """What a block may reuse from the frame's earlier blocks."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables: List[Optional[_FSE]] = [None, None, None]
        self.reps = [1, 4, 8]


def _literals(blk: bytes, st: _FrameState) -> Tuple[bytes, int]:
    if not blk:
        raise ZstdError("compressed block: empty")
    b0 = blk[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if fmt in (0, 2):
            size, pos = b0 >> 3, 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (blk[1] << 4), 2
        else:
            size, pos = (b0 >> 4) + (blk[1] << 4) + (blk[2] << 12), 3
        if kind == 0:
            if pos + size > len(blk):
                raise ZstdError("raw literals: truncated")
            return blk[pos : pos + size], pos + size
        if pos >= len(blk):
            raise ZstdError("RLE literals: truncated")
        return bytes([blk[pos]]) * size, pos + 1
    # Huffman-coded (kind 2: with its tree; kind 3: the previous one).
    width = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    if width > len(blk):
        raise ZstdError("compressed literals: truncated header")
    h = int.from_bytes(blk[:width], "little")
    field = {3: 10, 4: 14, 5: 18}[width]
    size = (h >> 4) & ((1 << field) - 1)
    comp = (h >> (4 + field)) & ((1 << field) - 1)
    streams = 1 if fmt == 0 else 4
    pos, end = width, width + comp
    if end > len(blk):
        raise ZstdError("compressed literals: truncated")
    if kind == 2:
        st.huffman, pos = _huffman_tree(blk, pos, end)
    elif st.huffman is None:
        raise ZstdError("treeless literals without an earlier Huffman tree")
    if streams == 1:
        return _huffman_stream(blk[pos:end], size, st.huffman), end
    if pos + 6 > end:
        raise ZstdError("compressed literals: truncated jump table")
    s1, s2, s3 = struct.unpack_from("<3H", blk, pos)
    pos += 6
    s4 = end - pos - s1 - s2 - s3
    quarter = (size + 3) // 4
    last = size - 3 * quarter
    if s4 < 0 or last < 0:
        raise ZstdError("compressed literals: inconsistent stream sizes")
    out = []
    for n_bytes, n_out in ((s1, quarter), (s2, quarter), (s3, quarter), (s4, last)):
        out.append(_huffman_stream(blk[pos : pos + n_bytes], n_out, st.huffman))
        pos += n_bytes
    return b"".join(out), end


def _sequences(blk: bytes, pos: int, st: _FrameState) -> List[Tuple[int, int, int]]:
    """The block's sequences: (literal length, match length, offset value)."""
    if pos >= len(blk):
        raise ZstdError("sequences: truncated")
    b0 = blk[pos]
    if b0 == 0:
        if pos + 1 != len(blk):
            raise ZstdError("sequences: bytes after a block of none")
        return []
    if b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        n, pos = ((b0 - 128) << 8) + blk[pos + 1], pos + 2
    else:
        n, pos = blk[pos + 1] + (blk[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= len(blk):
        raise ZstdError("sequences: truncated")
    modes = blk[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("sequences: reserved bits set")
    for k, (what, max_symbol, max_log, predefined) in enumerate(_KINDS):
        mode = (modes >> (6 - 2 * k)) & 3
        if mode == 0:
            st.tables[k] = predefined
        elif mode == 1:
            if pos >= len(blk):
                raise ZstdError(f"{what}: truncated RLE symbol")
            if blk[pos] > max_symbol:
                raise ZstdError(f"{what}: RLE symbol {blk[pos]} > {max_symbol}")
            st.tables[k] = _rle_table(blk[pos])
            pos += 1
        elif mode == 2:
            norm, log, pos = _read_ncount(blk, pos, max_symbol, max_log, what)
            st.tables[k] = _fse_table(norm, log, what)
        elif st.tables[k] is None:
            raise ZstdError(f"{what}: repeat mode without an earlier table")
    ll_t, of_t, ml_t = st.tables
    br = _Backward(blk[pos:], "sequences")
    s_ll, s_of, s_ml = br.read(ll_t.log), br.read(of_t.log), br.read(ml_t.log)
    out = []
    for i in range(n):
        of_code, ml_code, ll_code = of_t.sym[s_of], ml_t.sym[s_ml], ll_t.sym[s_ll]
        if of_code > 31:
            raise ZstdError(f"offsets: code {of_code}")
        of_value = (1 << of_code) + br.read(of_code)
        ml = _ML_BASE[ml_code] + br.read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + br.read(_LL_BITS[ll_code])
        out.append((ll, ml, of_value))
        if i != n - 1:
            s_ll = ll_t.new[s_ll] + br.read(ll_t.nb[s_ll])
            s_ml = ml_t.new[s_ml] + br.read(ml_t.nb[s_ml])
            s_of = of_t.new[s_of] + br.read(of_t.nb[s_of])
    if br.p != 0:
        raise ZstdError("sequences: bitstream does not end with the block")
    return out


def _offset(of_value: int, ll: int, reps: List[int]) -> int:
    """The match offset of an offset value, updating the repeat offsets."""
    if of_value > 3:
        off = of_value - 3
        reps[:] = [off, reps[0], reps[1]]
        return off
    idx = of_value - 1 + (ll == 0)
    if idx == 0:
        return reps[0]
    if idx == 3:
        off = reps[0] - 1
        if off == 0:
            raise ZstdError("repeat offset 0")
        reps[:] = [off, reps[0], reps[1]]
        return off
    off = reps[idx]
    reps[:] = [off, reps[0], reps[2] if idx == 1 else reps[1]]
    return off


def _compressed_block(blk: bytes, out: bytearray, start: int, st: _FrameState) -> None:
    lit, pos = _literals(blk, st)
    lp = 0
    for ll, ml, of_value in _sequences(blk, pos, st):
        if lp + ll > len(lit):
            raise ZstdError("sequence: literal length past the literals")
        out += lit[lp : lp + ll]
        lp += ll
        off = _offset(of_value, ll, st.reps)
        if off > len(out) - start:
            raise ZstdError(f"sequence: offset {off} before the frame's start")
        if off >= ml:
            at = len(out) - off
            out += out[at : at + ml]
        else:
            chunk = out[len(out) - off :]
            out += (chunk * (ml // off + 1))[:ml]
    out += lit[lp:]


# -- frames ---------------------------------------------------------------------


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the frame whose header starts at ``data[pos]`` (after the
    magic) into ``out``; returns the position after it."""
    if pos >= len(data):
        raise ZstdError("frame header: truncated")
    desc = data[pos]
    pos += 1
    fcs_flag, single = desc >> 6, (desc >> 5) & 1
    checksum, did_flag = (desc >> 2) & 1, desc & 3
    if desc & 8:
        raise ZstdError("frame header: reserved bit set")
    if not single:
        pos += 1  # the window descriptor: every match is checked against the frame
    did_size = (0, 1, 2, 4)[did_flag]
    fcs_size = (single, 2, 4, 8)[fcs_flag]
    if pos + did_size + fcs_size > len(data):
        raise ZstdError("frame header: truncated")
    did = int.from_bytes(data[pos : pos + did_size], "little")
    pos += did_size
    if did:
        raise ZstdError(f"frame needs dictionary {did}; none is supported")
    fcs = int.from_bytes(data[pos : pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    pos += fcs_size
    start = len(out)
    st = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("block header: truncated")
        hdr = int.from_bytes(data[pos : pos + 3], "little")
        pos += 3
        last, kind, size = hdr & 1, (hdr >> 1) & 3, hdr >> 3
        if size > _BLOCK_MAX:
            raise ZstdError(f"block of {size} bytes > 128 KB")
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("raw block: truncated")
            out += data[pos : pos + size]
            pos += size
        elif kind == 1:
            if pos >= len(data):
                raise ZstdError("RLE block: truncated")
            out += bytes([data[pos]]) * size
            pos += 1
        elif kind == 2:
            if pos + size > len(data):
                raise ZstdError("compressed block: truncated")
            _compressed_block(data[pos : pos + size], out, start, st)
            if len(out) - start > (1 << 62):
                raise ZstdError("frame too large")
            pos += size
        else:
            raise ZstdError("block type 3 (reserved)")
        if last:
            break
    if fcs_size and len(out) - start != fcs:
        raise ZstdError(f"frame holds {len(out) - start} bytes, its header says {fcs}")
    if checksum:
        if pos + 4 > len(data):
            raise ZstdError("content checksum: truncated")
        want = struct.unpack_from("<I", data, pos)[0]
        if xxh64(out[start:]) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum differs")
        pos += 4
    return pos


def zstd_frame_decompress_py(data) -> bytes:
    """Decode every frame in ``data`` (bytes-like; skippable frames are
    skipped) and return their contents, concatenated."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    if not data:
        raise ZstdError("no frame")
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("frame magic: truncated")
        magic = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        if magic in _SKIPPABLE:
            if pos + 4 > len(data):
                raise ZstdError("skippable frame: truncated")
            pos += 4 + struct.unpack_from("<I", data, pos)[0]
            if pos > len(data):
                raise ZstdError("skippable frame: truncated")
            continue
        if magic != MAGIC:
            raise ZstdError(f"bad frame magic {magic:#010x}")
        try:
            pos = _frame(data, pos, out)
        except (IndexError, struct.error) as exc:  # a field read past the end
            raise ZstdError(f"truncated frame ({exc})") from exc
    return bytes(out)
