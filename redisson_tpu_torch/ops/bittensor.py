"""Bit planes for bloom filters: one uint8 lane per bit ("expanded" form).

The expanded layout and its padding are a persisted format shared with
``redisson_tpu/ops/bittensor.py``: a plane of logical size n bits is
``padded_size(n)`` uint8 lanes, padding lanes stay 0, and the packed form
(``to_packed``) is np.packbits little-endian order.

Unlike the JAX functions, which return new arrays, ``set_bits`` writes into
the plane it is given.  The bloom add contract (every bit read as it was
before the batch, then all set) is ``contains`` followed by ``set_bits``.
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


def set_bits(bits: torch.Tensor, idx: torch.Tensor) -> None:
    """SETBIT batch to 1, in place; positions outside [0, size) are dropped."""
    flat = idx.reshape(-1)
    bits[flat[(flat >= 0) & (flat < bits.shape[0])]] = 1


def popcount(bits: torch.Tensor, nbits: int) -> int:
    """Number of set bits in [0, nbits)."""
    return int(bits[: min(nbits, bits.shape[0])].sum())


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
