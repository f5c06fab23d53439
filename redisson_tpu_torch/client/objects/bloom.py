"""BloomFilter: one filter's bit plane on the device (BASELINE config 1).

Same geometry, keys and replies as ``redisson_tpu/client/objects/bloom.py``:
m and k from the Guava formulas, integer numpy keys hashed as int64 and any
other key hashed over its codec bytes, the whole batch in one kernel launch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core.store import StateRecord
from redisson_tpu_torch.ops import bittensor as bt
from redisson_tpu_torch.utils import hashing as H


def optimal_num_of_bits(n: int, p: float) -> int:
    """m = -n ln p / (ln 2)^2 (Guava)."""
    if p == 0:
        p = 4.9e-324
    return int(-n * math.log(p) / (math.log(2) ** 2))


def optimal_num_of_hash_functions(n: int, m: int) -> int:
    """k = max(1, round(m/n * ln 2)) (Guava)."""
    return max(1, round(m / max(1, n) * math.log(2)))


class BloomFilter(RExpirable):
    MAX_SIZE = 2**31 - 1024  # int32 index space minus plane padding

    def try_init(self, expected_insertions: int, false_probability: float) -> bool:
        """Create the filter; False if it already exists."""
        if not 0 < false_probability < 1:
            raise ValueError("false probability must be in (0, 1)")
        if expected_insertions <= 0:
            raise ValueError("expected insertions must be positive")
        m = optimal_num_of_bits(expected_insertions, false_probability)
        if m > self.MAX_SIZE:
            raise ValueError(f"bloom filter size {m} exceeds max {self.MAX_SIZE}")
        k = optimal_num_of_hash_functions(expected_insertions, m)
        with self._engine.locked(self._name):
            if self._engine.store.exists(self._name):
                return False

            def factory():
                return StateRecord(
                    kind="bloom",
                    meta={"n": expected_insertions, "p": false_probability,
                          "m": m, "k": k, "hash": H.HASH_NAME},
                    arrays={"bits": bt.make(m, self._home)},
                )

            self._engine.store.get_or_create(self._name, "bloom", factory)
            return True

    def _rec(self) -> StateRecord:
        rec = self._engine.store.get(self._name)
        if rec is None:
            raise RuntimeError(f"Bloom filter '{self._name}' is not initialized")
        if rec.meta.get("hash") != H.HASH_NAME:
            raise RuntimeError(
                f"Bloom filter '{self._name}' was built with hash "
                f"{rec.meta.get('hash')!r}, runtime is {H.HASH_NAME!r}"
            )
        return rec

    def get_expected_insertions(self) -> int:
        return self._rec().meta["n"]

    def get_false_probability(self) -> float:
        return self._rec().meta["p"]

    def get_size(self) -> int:
        return self._rec().meta["m"]

    def get_hash_iterations(self) -> int:
        return self._rec().meta["k"]

    # -- data plane ---------------------------------------------------------

    def add(self, obj) -> bool:
        """True iff the element was (probably) newly added."""
        return bool(self.add_all([obj] if not isinstance(obj, np.ndarray) else obj))

    def add_all(self, objs) -> int:
        """Batch add; the number of (probably) new elements."""
        return int(self.add_all_async(objs))

    def add_all_async(self, objs):
        """Batch add with the newly-added count left on the device (0-d int32);
        only reading it waits for the card."""
        kind, arrays, n = self._engine.pack_keys(objs, self._codec, device=self._home)
        if n == 0:
            return np.int32(0)
        with self._engine.locked(self._name):
            rec = self._rec()
            m, k = rec.meta["m"], rec.meta["k"]
            arrays = self._engine.on_card(arrays, rec.arrays["bits"])
            if kind == "u64":
                _, count = K.bloom_add_packed_count(rec.arrays["bits"], arrays, n, k, m)
            else:
                words, nbytes = arrays
                _, newly = K.bloom_add_bytes_masked(rec.arrays["bits"], words, nbytes, n, k, m)
                count = newly.sum(dtype=torch.int32)
            self._touch_version(rec)
        return count

    def add_each(self, objs) -> np.ndarray:
        """Batch add; per key, was it newly added."""
        newly, n = self.add_each_async(objs)
        return newly[:n].cpu().numpy() if isinstance(newly, torch.Tensor) else newly

    def add_each_async(self, objs):
        """Batch add: (device newly-added flags, n_valid), no host sync."""
        kind, arrays, n = self._engine.pack_keys(objs, self._codec, device=self._home)
        if n == 0:
            return np.zeros((0,), bool), 0
        with self._engine.locked(self._name):
            rec = self._rec()
            m, k = rec.meta["m"], rec.meta["k"]
            arrays = self._engine.on_card(arrays, rec.arrays["bits"])
            if kind == "u64":
                _, newly = K.bloom_add_packed(rec.arrays["bits"], arrays, n, k, m)
            else:
                words, nbytes = arrays
                _, newly = K.bloom_add_bytes_masked(rec.arrays["bits"], words, nbytes, n, k, m)
            self._touch_version(rec)
        return newly, n

    def contains(self, obj) -> bool:
        if isinstance(obj, np.ndarray):
            raise TypeError("use contains_each / count_contains for batches")
        return bool(self.contains_each([obj])[0])

    def contains_each(self, objs) -> np.ndarray:
        """Vectorized membership: bool array aligned with objs."""
        found, n = self.contains_each_async(objs)
        if isinstance(found, np.ndarray):
            return found.astype(bool)
        if found.dtype == torch.int32:  # bitmap (integer keys)
            return K.unpack_found(found, n)
        return found[:n].cpu().numpy()

    def contains_each_async(self, objs):
        """Membership with no host sync: an int32 bitmap for integer keys
        (decode with kernels.unpack_found), device bool flags otherwise."""
        kind, arrays, n = self._engine.pack_keys(objs, self._codec, cache_hot=True,
                                                  device=self._home)
        if n == 0:
            return np.zeros((0,), np.uint32), 0
        # dispatch under the record lock: the plane is read in stream order
        # after every add dispatched before it
        with self._engine.locked(self._name):
            rec = self._rec()
            m, k = rec.meta["m"], rec.meta["k"]
            arrays = self._engine.on_card(arrays, rec.arrays["bits"])
            if kind == "u64":
                found = K.bloom_contains_packed_bits(rec.arrays["bits"], arrays, n, k, m)
            else:
                words, nbytes = arrays
                found = K.bloom_contains_bytes_masked(rec.arrays["bits"], words, nbytes, n, k, m)
        return found, n

    def count_contains(self, objs) -> int:
        """Number of objs (probably) present."""
        return int(self.contains_each(objs).sum())

    def count(self) -> int:
        """Approximate cardinality from the fill ratio: -m/k * ln(1 - X/m)."""
        with self._engine.locked(self._name):
            rec = self._rec()
            m, k = rec.meta["m"], rec.meta["k"]
            x = bt.popcount(rec.arrays["bits"], m)
        if x == 0:
            return 0
        if x >= m:
            return rec.meta["n"]
        return int(round(-m / k * math.log1p(-x / m)))
