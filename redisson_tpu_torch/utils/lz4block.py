"""LZ4 *block* format (compress + decompress): native fast path + pure
Python fallback.

A copy of ``redisson_tpu/utils/lz4block.py``.  ``compress``/``decompress``
call ``rtpu_lz4_compress``/``rtpu_lz4_decompress`` of this package's host
library (``native/resp.cpp``, loaded by ``net/_native``) when it builds,
and otherwise the pure-Python implementation of the published block format
(token nibbles, 255-run extended lengths, little-endian 2-byte match
offsets, a literals-only final sequence, the 12/5-byte end-of-block match
rules): ``compress_python``/``decompress_python``, kept public as the
fallback and the cross-check.  Both are interoperable with any standard LZ4
block decoder at the byte level, and both find matches through the same
16-bit multiplicative hash table, so they write the same bytes: the
reference's native bytes, which are what it stores when its library loads
(its Python fallback keys an exact dict and can pick other matches in
incompressible input).  ``RTPU_NO_NATIVE=1`` forces the fallback.
"""
from __future__ import annotations

import ctypes

_MIN_MATCH = 4
_LAST_LITERALS = 5   # spec: the last 5 bytes are always literals
_MATCH_GUARD = 12    # spec: no match may start within the last 12 bytes
_MAX_OFFSET = 0xFFFF


def _lib():
    from redisson_tpu_torch.net import _native

    return _native.load()


def compress(src: bytes) -> bytes:
    """LZ4 block compress — native when available, else pure Python."""
    lib = _lib()
    if lib is None:
        return compress_python(src)
    src = bytes(src)
    n = len(src)
    cap = n + n // 255 + 16  # LZ4 worst-case expansion bound
    out = ctypes.create_string_buffer(cap)
    w = lib.rtpu_lz4_compress(src, n, out, cap)
    if w < 0:  # oversized input (-3) or bound drift (-1): python handles it
        return compress_python(src)
    return ctypes.string_at(out, w)


def decompress(src: bytes, expected_size: int) -> bytes:
    """LZ4 block decompress; raises ValueError on malformed input or a size
    mismatch — native when available, else pure Python."""
    lib = _lib()
    if lib is None:
        return decompress_python(src, expected_size)
    if expected_size < 0:
        raise ValueError(f"bad LZ4 expected size {expected_size}")
    src = bytes(src)
    out = ctypes.create_string_buffer(max(1, expected_size))
    produced = ctypes.c_uint64(0)
    rc = lib.rtpu_lz4_decompress(
        src, len(src), out, expected_size, ctypes.byref(produced)
    )
    if rc == -1:
        raise ValueError("truncated or malformed LZ4 block")
    if rc != 0:
        raise ValueError(
            f"LZ4 size mismatch: got {produced.value}, expected {expected_size}"
        )
    return ctypes.string_at(out, expected_size)


def compress_python(src: bytes) -> bytes:
    """Pure-python LZ4 block compress (greedy; the native path's table: a
    4-byte word's multiplicative hash keys the last position seen)."""
    n = len(src)
    if n == 0:
        return b"\x00"  # one empty-literal token: a valid empty block
    out = bytearray()
    table: dict = {}
    anchor = 0
    i = 0
    limit = n - _MATCH_GUARD
    find = int.from_bytes
    while i < limit:
        h = (find(src[i : i + 4], "little") * 2654435761 & 0xFFFFFFFF) >> 16
        cand = table.get(h)
        table[h] = i
        if cand is None or i - cand > _MAX_OFFSET or src[cand : cand + 4] != src[i : i + 4]:
            i += 1
            continue
        # extend the match forward (stop before the guard tail)
        m = i + 4
        c = cand + 4
        end = n - _LAST_LITERALS
        while m < end and src[m] == src[c]:
            m += 1
            c += 1
        lit = src[anchor:i]
        _emit(out, lit, i - cand, m - i)
        anchor = i = m
    # final literals-only sequence
    lit = src[anchor:]
    ll = len(lit)
    if ll >= 15:
        out.append(0xF0)
        _ext(out, ll - 15)
    else:
        out.append(ll << 4)
    out += lit
    return bytes(out)


def _ext(out: bytearray, v: int) -> None:
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)


def _emit(out: bytearray, lit: bytes, offset: int, mlen: int) -> None:
    ll = len(lit)
    ml = mlen - _MIN_MATCH
    token = (min(ll, 15) << 4) | min(ml, 15)
    out.append(token)
    if ll >= 15:
        _ext(out, ll - 15)
    out += lit
    out += offset.to_bytes(2, "little")
    if ml >= 15:
        _ext(out, ml - 15)


def decompress_python(src: bytes, expected_size: int) -> bytes:
    """Pure-python LZ4 block decompress; raises ValueError on malformed
    input or a size mismatch (the codec frame carries the uncompressed
    length)."""
    out = bytearray()
    i = 0
    n = len(src)
    try:
        while i < n:
            token = src[i]
            i += 1
            ll = token >> 4
            if ll == 15:
                while True:
                    b = src[i]
                    i += 1
                    ll += b
                    if b != 255:
                        break
            if i + ll > n:
                raise ValueError("truncated literals")
            out += src[i : i + ll]
            i += ll
            if i >= n:
                break  # final sequence has no match part
            offset = int.from_bytes(src[i : i + 2], "little")
            i += 2
            if offset == 0 or offset > len(out):
                raise ValueError(f"bad match offset {offset}")
            ml = token & 0xF
            if ml == 15:
                while True:
                    b = src[i]
                    i += 1
                    ml += b
                    if b != 255:
                        break
            ml += _MIN_MATCH
            start = len(out) - offset
            if offset >= ml:
                out += out[start : start + ml]
            else:
                # overlapping copy (RLE-style): byte-at-a-time semantics
                for k in range(ml):
                    out.append(out[start + k])
    except IndexError:
        raise ValueError("truncated LZ4 block") from None
    if len(out) != expected_size:
        raise ValueError(
            f"LZ4 size mismatch: got {len(out)}, expected {expected_size}"
        )
    return bytes(out)
