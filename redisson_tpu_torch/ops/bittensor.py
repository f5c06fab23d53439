"""Bit planes for bloom filters and bit sets: one uint8 lane per bit
("expanded" form).

The expanded layout and its padding are a persisted format shared with
``redisson_tpu/ops/bittensor.py``: a plane of logical size n bits is
``padded_size(n)`` uint8 lanes, padding lanes stay 0, and the packed form
(``to_packed``) is np.packbits little-endian order.

Unlike the JAX functions, which return new arrays, ``set_bits`` writes into
the plane it is given.  The bloom add contract (every bit read as it was
before the batch, then all set) is ``contains`` followed by ``set_bits``.
``get_bits`` / ``set_bits`` index as JAX's ``.at[]`` does: an index in
[-size, -1] counts from the end once, any other index outside [0, size)
reads 0 / is dropped.  The BITOP functions return new planes, as the JAX
ones do.
"""
from __future__ import annotations

import numpy as np
import torch

# Planes are padded to a multiple of 1024 lanes; part of the plane format.
_PAD = 1024


def padded_size(nbits: int) -> int:
    return max(_PAD, (nbits + _PAD - 1) // _PAD * _PAD)


def make(nbits: int, device) -> torch.Tensor:
    """Zeroed bit plane for a logical size of `nbits` bits."""
    return torch.zeros((padded_size(nbits),), dtype=torch.uint8, device=device)


def _read(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather at idx; positions outside [0, size) read as 1."""
    size = bits.shape[0]
    inb = (idx >= 0) & (idx < size)
    got = bits[torch.where(inb, idx, 0)]
    return torch.where(inb, got, torch.ones_like(got))


def contains(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per row of idx (N, k): True iff all k bits are set."""
    return (_read(bits, idx) != 0).all(dim=-1)


def _lanes(bits: torch.Tensor, idx: torch.Tensor):
    """(plane position, in range) of each index, negatives wrapped once."""
    size = bits.shape[0]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + size, i)
    inb = (i >= 0) & (i < size)
    return torch.where(inb, i, 0), inb


def get_bits(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """GETBIT batch -> uint8 of idx's shape; out-of-range reads 0."""
    i, inb = _lanes(bits, idx)
    return torch.where(inb, bits[i], torch.zeros((), dtype=bits.dtype, device=bits.device))


def set_bits(bits: torch.Tensor, idx: torch.Tensor, value: int = 1) -> None:
    """SETBIT batch to `value`, in place; out-of-range indexes are dropped."""
    i, inb = _lanes(bits, idx.reshape(-1))
    bits[i[inb]] = value


def popcount(bits: torch.Tensor, nbits: int) -> int:
    """BITCOUNT: number of set bits in [0, nbits)."""
    return int(bits[: min(nbits, bits.shape[0])].sum())


def bit_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(a, b)


def bit_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def bit_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a ^ b


def bit_not(a: torch.Tensor, nbits: int) -> torch.Tensor:
    """BITOP NOT limited to the logical length (padding lanes stay 0)."""
    lane = torch.arange(a.shape[0], device=a.device)
    return torch.where(lane < nbits, 1 - a, torch.zeros_like(a))


def bitpos(bits: torch.Tensor, value: int, nbits: int) -> int:
    """BITPOS: first index in [0, nbits) holding `value`, -1 if none."""
    hit = (bits[: min(nbits, bits.shape[0])] == value).nonzero()
    return int(hit[0, 0]) if hit.numel() else -1


def length_hint(bits: torch.Tensor) -> int:
    """Index of the highest set bit + 1 (RBitSet.length()), 0 if none."""
    hit = bits.nonzero()
    return int(hit[-1, 0]) + 1 if hit.numel() else 0


def length_tensor(bits: torch.Tensor) -> torch.Tensor:
    """length_hint as a 0-d int64 tensor on the plane's device, computed
    without a host sync (the reply of BITOP rides its frame's readback)."""
    if bits.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=bits.device)
    nz = bits.flip(0) != 0
    last = nz.to(torch.uint8).argmax()  # the first set lane from the end
    return torch.where(nz.any(), bits.numel() - last, 0)


# --- serialization boundary (host-side, packed little-endian like Redis) -----

def to_packed(bits_host: np.ndarray, nbits: int) -> bytes:
    """Expanded uint8 lanes -> packed bytes (bit 0 = LSB of byte 0)."""
    b = np.asarray(bits_host[:nbits], np.uint8)
    return np.packbits(b, bitorder="little").tobytes()


def from_packed(data: bytes, nbits: int) -> np.ndarray:
    arr = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")[:nbits]
    out = np.zeros((padded_size(nbits),), np.uint8)
    out[: arr.shape[0]] = arr
    return out
