"""LZ4 frame decoding in pure Python: the plain twin of
``native/lz4_frame.cpp`` (``data/native_io.py::lz4_frame_decompress``).

The tests and ``chip_smoke.py`` hold the native decoder against this one;
nothing on the converter path uses it (it is about a hundred times
slower). It follows the frame and block formats of the LZ4 project
(``doc/lz4_Frame_format.md``, ``doc/lz4_Block_format.md``) step for step:
concatenated and skippable frames, the FLG and BD bytes, the optional
content size, data blocks compressed or stored raw, linked or independent
blocks, overlapping matches, and every checksum (xxHash32) verified.
"""

from __future__ import annotations

import struct

_MAGIC = 0x184D2204
_P1, _P2, _P3, _P4, _P5 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def xxh32(data, seed: int = 0) -> int:
    """xxHash32 of ``data`` (bytes-like)."""
    data = bytes(data)
    n, p = len(data), 0
    if n >= 16:
        v = [(seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed & _M, (seed - _P1) & _M]
        stripes = n // 16
        words = struct.unpack_from(f"<{4 * stripes}I", data)
        for s in range(stripes):
            for lane in range(4):
                acc = (v[lane] + words[4 * s + lane] * _P2) & _M
                v[lane] = (_rotl(acc, 13) * _P1) & _M
        p = 16 * stripes
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while p + 4 <= n:
        h = (_rotl((h + struct.unpack_from("<I", data, p)[0] * _P3) & _M, 17) * _P4) & _M
        p += 4
    while p < n:
        h = (_rotl((h + data[p] * _P5) & _M, 11) * _P1) & _M
        p += 1
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    h ^= h >> 16
    return h


def _decode_block(src: bytes, out: bytearray, window: int) -> None:
    """Append LZ4 block ``src`` to ``out``; matches reach back no further
    than ``out[window]``."""
    n, ip = len(src), 0
    while True:
        if ip >= n:
            raise ValueError("LZ4 frame: corrupt block")
        token = src[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise ValueError("LZ4 frame: corrupt block")
                b = src[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if lit > n - ip:
            raise ValueError("LZ4 frame: corrupt block")
        out += src[ip : ip + lit]
        ip += lit
        if ip == n:
            return
        if n - ip < 2:
            raise ValueError("LZ4 frame: corrupt block")
        offset = src[ip] | src[ip + 1] << 8
        ip += 2
        if offset == 0 or offset > len(out) - window:
            raise ValueError("LZ4 frame: corrupt block")
        length = token & 15
        if length == 15:
            while True:
                if ip >= n:
                    raise ValueError("LZ4 frame: corrupt block")
                b = src[ip]
                ip += 1
                length += b
                if b != 255:
                    break
        length += 4
        start = len(out) - offset
        if offset >= length:
            out += out[start : start + length]
        else:  # overlapping: the match repeats its last ``offset`` bytes
            pattern = out[start:]
            out += (pattern * (length // offset + 1))[:length]


def lz4_frame_decompress_py(data, uncompressed_size: int) -> bytearray:
    """Decode the LZ4 frame(s) in ``data`` to exactly ``uncompressed_size``
    bytes; raises ``ValueError`` on a corrupt, truncated or unsupported
    frame, as the native decoder does."""
    src = bytes(data)
    n, pos = len(src), 0
    out = bytearray()
    if n == 0:
        raise ValueError("LZ4 frame: truncated frame")

    def take(k: int) -> bytes:
        nonlocal pos
        if n - pos < k:
            raise ValueError("LZ4 frame: truncated frame")
        pos += k
        return src[pos - k : pos]

    while pos < n:
        magic = struct.unpack("<I", take(4))[0]
        if magic & 0xFFFFFFF0 == 0x184D2A50:  # skippable frame
            take(struct.unpack("<I", take(4))[0])
            continue
        if magic != _MAGIC:
            raise ValueError("LZ4 frame: not an LZ4 frame (bad magic number)")
        flg, bd = take(2)
        if flg >> 6 != 1 or flg & 0x02 or bd & 0x8F or (bd >> 4) & 7 < 4:
            raise ValueError("LZ4 frame: bad frame descriptor (FLG or BD byte)")
        if flg & 0x01:
            raise ValueError("LZ4 frame: frames that need a dictionary are not supported")
        independent, block_checksum = bool(flg & 0x20), bool(flg & 0x10)
        has_size, content_checksum = bool(flg & 0x08), bool(flg & 0x04)
        max_block = 1 << (8 + 2 * ((bd >> 4) & 7))
        desc = bytes([flg, bd])
        content_size = None
        if has_size:
            field = take(8)
            desc += field
            content_size = struct.unpack("<Q", field)[0]
        if (xxh32(desc) >> 8) & 0xFF != take(1)[0]:
            raise ValueError("LZ4 frame: frame descriptor checksum mismatch")
        start = len(out)
        while True:
            word = struct.unpack("<I", take(4))[0]
            if word == 0:
                break
            size = word & 0x7FFFFFFF
            if size > max_block:
                raise ValueError("LZ4 frame: block larger than the frame's maximum block size")
            block = take(size)
            if block_checksum and xxh32(block) != struct.unpack("<I", take(4))[0]:
                raise ValueError("LZ4 frame: block checksum mismatch")
            before = len(out)
            if word & 0x80000000:
                out += block
            else:
                _decode_block(block, out, before if independent else start)
                if len(out) - before > max_block:
                    raise ValueError(
                        "LZ4 frame: block larger than the frame's maximum block size")
            if len(out) > uncompressed_size:
                raise ValueError("LZ4 frame: decoded data is larger than the expected size")
        if content_checksum and xxh32(out[start:]) != struct.unpack("<I", take(4))[0]:
            raise ValueError("LZ4 frame: content checksum mismatch")
        if content_size is not None and len(out) - start != content_size:
            raise ValueError("LZ4 frame: decoded size differs from the frame's content size")
    if len(out) != uncompressed_size:
        raise ValueError(f"LZ4 frame: decoded {len(out)} bytes, expected {uncompressed_size}")
    return out
