"""CRC16 (CCITT/XModem) keyspace slot hashing with ``{hashtag}`` colocation.

Parity: ``org/redisson/connection/CRC16.java`` (the 256-entry table algorithm)
and ``MasterSlaveConnectionManager.calcSlot`` hashtag extraction.  The 16384
CRC16 slot model is kept verbatim so routing semantics (which keys may be
combined in one atomic compound op) match the reference; slots map to mesh
shards instead of Redis masters (SURVEY.md §2.8).
"""
from __future__ import annotations

import numpy as np

MAX_SLOT = 16384

_POLY = 0x1021
_TABLE = np.zeros(256, np.uint16)
for _i in range(256):
    _crc = _i << 8
    for _ in range(8):
        _crc = ((_crc << 1) ^ _POLY) if (_crc & 0x8000) else (_crc << 1)
        _crc &= 0xFFFF
    _TABLE[_i] = _crc


def crc16(data: bytes) -> int:
    crc = 0
    t = _TABLE
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ int(t[((crc >> 8) ^ b) & 0xFF])
    return crc


def hashtag(key: bytes) -> bytes:
    """Extract the {hashtag} portion if present and non-empty (Redis rules)."""
    start = key.find(b"{")
    if start >= 0:
        end = key.find(b"}", start + 1)
        if end > start + 1:
            return key[start + 1 : end]
    return key


def calc_slot(key) -> int:
    if isinstance(key, str):
        key = key.encode()
    return crc16(hashtag(key)) % MAX_SLOT
