"""Versioned key hashing for sketch indexes: numpy host helpers and the plain
PyTorch path.

The scheme is a persisted format (bloom bit layouts and HLL registers only
mean something under the hash that produced them), identical bit for bit to
``redisson_tpu/utils/hashing.py``:

    HASH_VERSION = 1  -- "rtpu-mur32x2/1"
      * int keys: key split into (lo, hi) uint32 words, murmur3-x86-32 chain
        over the two words, seeds SEED1/SEED2; h2 forced odd.
      * byte keys: keys padded to W uint32 little-endian words; words beyond
        ceil(len/4) are masked out of the chain; length xored in finalization.

Lanes.  torch on the CPU has no ``>>``, ``<<``, ``+`` or ``%`` for uint32, so
the plain path carries every 32-bit lane in an int64 tensor holding a value in
[0, 2**32) and masks with 0xFFFFFFFF after each multiply and add.  A product
of two such values can overflow int64; two's-complement wraparound keeps its
low 32 bits, which are all the hash keeps.  The CUDA kernels run the same
chain on native uint32 (``csrc/hash.cuh``).
"""
from __future__ import annotations

import numpy as np
import torch

HASH_VERSION = 1
HASH_NAME = "rtpu-mur32x2/1"

SEED1 = 0x9747B28C
SEED2 = 0x3C6EF372

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FM1 = 0x85EBCA6B
_FM2 = 0xC2B2AE35

M32 = 0xFFFFFFFF


def lanes(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor holding 32-bit words (int32 bit patterns, uint32,
    int64) -> int64 lanes in [0, 2**32)."""
    return x.to(torch.int64) & M32


def _rotl32(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on int64 lanes."""
    x = x ^ (x >> 16)
    x = (x * _FM1) & M32
    x = x ^ (x >> 13)
    x = (x * _FM2) & M32
    return x ^ (x >> 16)


def _mur_round(h, k):
    k = (k * _C1) & M32
    k = _rotl32(k, 15)
    k = (k * _C2) & M32
    h = _rotl32(h ^ k, 13)
    return (h * 5 + 0xE6546B64) & M32


def hash_words(words, nbytes: torch.Tensor, seed: int) -> torch.Tensor:
    """Murmur3-x86-32-style hash over 32-bit word lanes.

    words: sequence of integer tensors (one per word position, all of
    nbytes' shape); word j is masked out for keys with ceil(nbytes/4) <= j.
    Returns int64 lanes.
    """
    nbytes = lanes(nbytes)
    h = torch.full_like(nbytes, seed)
    nwords = ((nbytes + 3) & M32) >> 2
    for j, w in enumerate(words):
        h = torch.where(nwords > j, _mur_round(h, lanes(w)), h)
    return fmix32(h ^ nbytes)


def hash_u64_pair(lo: torch.Tensor, hi: torch.Tensor):
    """64-bit keys as (lo, hi) word tensors -> (h1, h2) int64 lanes; h2 odd."""
    eight = torch.full(lo.shape, 8, dtype=torch.int64, device=lo.device)
    h1 = hash_words([lo, hi], eight, SEED1)
    h2 = hash_words([lo, hi], eight, SEED2) | 1
    return h1, h2


def hash_packed_bytes(words: torch.Tensor, nbytes: torch.Tensor):
    """Byte keys packed as (W, N) word columns -> (h1, h2) int64 lanes."""
    if words.shape[0] == 0:  # zero-width packing hashes to 0, h2 not forced odd
        z = torch.zeros(nbytes.shape, dtype=torch.int64, device=nbytes.device)
        return z, z
    cols = [words[j] for j in range(words.shape[0])]
    return hash_words(cols, nbytes, SEED1), hash_words(cols, nbytes, SEED2) | 1


def bloom_indexes(h1: torch.Tensor, h2: torch.Tensor, k: int, m_bits: int) -> torch.Tensor:
    """Double-hashed bit positions (..., k) int64: (h1 + i*h2) mod 2**32 mod m."""
    i = torch.arange(k, dtype=torch.int64, device=h1.device)
    return ((h1[..., None] + i * h2[..., None]) & M32) % m_bits


# --- host side (numpy) --------------------------------------------------------

def pack_keys(keys):
    """Pack a list of bytes keys into (words[W,N] uint32, nbytes[N] uint32).

    W is ceil(maxlen/4); little-endian word packing, zero padding.
    """
    n = len(keys)
    if n == 0:
        return np.zeros((0, 0), np.uint32), np.zeros((0,), np.uint32)
    maxlen = max(len(k) for k in keys)
    w = max(1, (maxlen + 3) // 4)
    buf = np.zeros((n, w * 4), np.uint8)
    nbytes = np.empty((n,), np.uint32)
    for i, k in enumerate(keys):
        buf[i, : len(k)] = np.frombuffer(k, np.uint8)
        nbytes[i] = len(k)
    words = buf.view("<u4").T.copy()  # (W, N)
    return words, nbytes


def int_keys_to_u32_pair(keys):
    """int64/uint64 numpy array -> (lo, hi) uint32 arrays."""
    k = np.asarray(keys).astype(np.uint64)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    return lo, hi
