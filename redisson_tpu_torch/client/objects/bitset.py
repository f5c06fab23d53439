"""BitSet handle (Redisson's RBitSet), a port of
``redisson_tpu/client/objects/bitset.py``.

A bit set is a resident expanded bit plane (ops/bittensor.py, one uint8 lane
per bit).  Single-bit calls are 1-element batches; the real surface is the
vectorized set_each/get_each used by batch flushes, which launch the
bitset_set / bitset_get kernels (core/kernels.py).  BITCOUNT, BITOP, BITPOS
and length run as torch ops over the plane.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core.store import StateRecord
from redisson_tpu_torch.ops import bittensor as bt

_DEFAULT_BITS = 1 << 20


class BitSet(RExpirable):
    def _rec_or_create(self, min_bits: int = 0) -> StateRecord:
        device = self._home

        def factory():
            return StateRecord(
                kind="bitset",
                meta={"nbits": max(_DEFAULT_BITS, bt.padded_size(min_bits))},
                arrays={"bits": bt.make(max(_DEFAULT_BITS, min_bits), device)},
            )

        rec = self._engine.store.get_or_create(self._name, "bitset", factory)
        if min_bits > rec.meta["nbits"]:
            self._grow(rec, min_bits)
        return rec

    def _grow(self, rec: StateRecord, min_bits: int) -> None:
        """Grow the plane (Redis strings auto-grow on SETBIT past the end),
        at least doubling it."""
        new_size = bt.padded_size(max(min_bits, rec.meta["nbits"] * 2))
        old = rec.arrays["bits"]
        new = bt.make(new_size, old.device)
        new[: old.shape[0]] = old
        rec.arrays["bits"] = new
        rec.meta["nbits"] = new_size

    # -- single-bit surface (RBitSet.get/set) --------------------------------

    def set(self, index: int, value: bool = True) -> bool:
        """Set one bit, returning its previous value (SETBIT reply)."""
        return bool(self.set_each(np.asarray([index], np.int64), value)[0])

    def get(self, index: int) -> bool:
        return bool(self.get_each(np.asarray([index], np.int64))[0])

    def clear_bit(self, index: int) -> bool:
        return self.set(index, False)

    # -- vectorized surface (the batch-coalesced fast path) -----------------

    MAX_BIT = 2**31 - 1024  # int32 index space minus plane padding

    def _check_range(self, idx: np.ndarray) -> None:
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) > self.MAX_BIT):
            raise ValueError(
                f"bit index out of range [0, {self.MAX_BIT}] — int32 kernel "
                "index space (Redis allows up to 2^32; shard larger planes)"
            )

    def set_each(self, indexes: np.ndarray, value: bool = True) -> np.ndarray:
        """Batch SETBIT; returns previous bit values aligned with indexes."""
        old, n = self.set_each_async(indexes, value)
        return old[:n].cpu().numpy() if isinstance(old, torch.Tensor) else old

    def set_each_async(self, indexes: np.ndarray, value: bool = True):
        """Batch SETBIT with no host sync: (device previous-values uint8
        tensor, n_valid)."""
        self._check_range(np.asarray(indexes, np.int64))
        idx = np.ascontiguousarray(indexes, np.int32)
        n = idx.shape[0]
        if n == 0:
            return np.zeros((0,), np.uint8), 0
        b = K.pow2_bucket(n)
        staged = K.stage(K.pad_to(idx, b), self._home)
        with self._engine.locked(self._name):
            rec = self._rec_or_create(int(idx.max()) + 1)
            staged = self._engine.on_card(staged, rec.arrays["bits"])
            _, old = K.bitset_set(rec.arrays["bits"], staged, n, 1 if value else 0)
            self._touch_version(rec)
        return old, n

    def get_each(self, indexes: np.ndarray) -> np.ndarray:
        got, n = self.get_each_async(indexes)
        return got[:n].cpu().numpy() if isinstance(got, torch.Tensor) else got

    def get_each_async(self, indexes: np.ndarray):
        """Batch GETBIT with no host sync: (device uint8 tensor, n_valid)."""
        self._check_range(np.asarray(indexes, np.int64))
        idx = np.ascontiguousarray(indexes, np.int32)
        n = idx.shape[0]
        if n == 0:
            return np.zeros((0,), np.uint8), 0
        staged = K.stage(K.pad_to(idx, K.pow2_bucket(n)), self._home)
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return np.zeros(idx.shape, np.uint8), n
            staged = self._engine.on_card(staged, rec.arrays["bits"])
            got = K.bitset_get(rec.arrays["bits"], staged)
        return got, n

    def set_range(self, from_index: int, to_index: int, value: bool = True) -> None:
        """RBitSet.set(from, to): a contiguous range."""
        self.set_each(np.arange(from_index, to_index, dtype=np.int64), value)

    # -- aggregates ---------------------------------------------------------

    def cardinality(self) -> int:
        """BITCOUNT."""
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return 0
            return int(K.bitset_popcount(rec.arrays["bits"], rec.meta["nbits"]))

    def length(self) -> int:
        """Highest set bit + 1."""
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return 0
            return int(K.bitset_length(rec.arrays["bits"]))

    def size(self) -> int:
        """Allocated plane size in bits (RBitSet.size = string length * 8)."""
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else rec.meta["nbits"]

    def bitpos(self, value: bool) -> int:
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return 0 if not value else -1
            return int(K.bitset_bitpos(rec.arrays["bits"], 1 if value else 0, rec.meta["nbits"]))

    # -- BITOP against other bit sets ---------------------------------------

    def _binary_op(self, op, other_names: Sequence[str]) -> None:
        names = (self._name, *other_names)
        with self._engine.locked_many(names):
            rec = self._rec_or_create()
            acc = rec.arrays["bits"]
            for nm in other_names:
                if nm == self._name:
                    continue
                other = self._engine.store.get(nm)
                if other is None:
                    o_bits = bt.make(rec.meta["nbits"], acc.device)
                elif other.kind != "bitset":
                    raise TypeError(f"'{nm}' is not a BitSet")
                else:
                    # a source on another card comes over by a peer copy
                    # (ioplane.colocate, counted), never through the host
                    o_bits = ioplane.colocate(other.arrays["bits"], acc.device)
                if o_bits.shape[0] > acc.shape[0]:
                    grown = bt.make(o_bits.shape[0], acc.device)
                    grown[: acc.shape[0]] = acc
                    acc = grown
                    rec.meta["nbits"] = o_bits.shape[0]
                elif o_bits.shape[0] < acc.shape[0]:
                    grown = bt.make(acc.shape[0], acc.device)
                    grown[: o_bits.shape[0]] = o_bits
                    o_bits = grown
                acc = op(acc, o_bits)
            rec.arrays["bits"] = acc
            self._touch_version(rec)

    def and_(self, *other_names: str) -> None:
        self._binary_op(K.bitset_and, other_names)

    def or_(self, *other_names: str) -> None:
        self._binary_op(K.bitset_or, other_names)

    def xor(self, *other_names: str) -> None:
        self._binary_op(K.bitset_xor, other_names)

    def not_(self) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.arrays["bits"] = K.bitset_not(rec.arrays["bits"], rec.meta["nbits"])
            self._touch_version(rec)

    # -- serialization ------------------------------------------------------

    def to_byte_array(self) -> bytes:
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return b""
            nbits = rec.meta["nbits"]
            host = rec.arrays["bits"].cpu().numpy()
        return bt.to_packed(host, nbits)

    def from_byte_array(self, data: bytes) -> None:
        nbits = len(data) * 8
        with self._engine.locked(self._name):
            rec = self._rec_or_create(nbits)
            host = torch.from_numpy(bt.from_packed(data, nbits))
            rec.arrays["bits"][: host.shape[0]] = host.to(rec.arrays["bits"].device)
            self._touch_version(rec)
