"""BloomFilterArray: a multi-tenant bloom bank (BASELINE config 2).

All tenants of one family share a (T, m) bit plane, so a mixed flush that
spans hundreds of tenants is still one kernel launch: the tenant id is one
more index column.  Same geometry, packing and replies as
``redisson_tpu/client/objects/bloom_array.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.client.objects.bloom import (
    optimal_num_of_bits,
    optimal_num_of_hash_functions,
)
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core.store import StateRecord
from redisson_tpu_torch.ops import bittensor as bt
from redisson_tpu_torch.utils import hashing as H


class BloomFilterArray(RExpirable):
    def try_init(self, tenants: int, expected_insertions: int, false_probability: float) -> bool:
        """Create a (tenants, m) bank; m/k sized per tenant."""
        if tenants <= 0:
            raise ValueError("tenants must be positive")
        m = bt.padded_size(optimal_num_of_bits(expected_insertions, false_probability))
        k = optimal_num_of_hash_functions(expected_insertions, m)
        if tenants * m > K.BANK_MAX_CELLS:
            raise ValueError(
                f"bank of {tenants} x {m} bits = {tenants * m} cells exceeds the "
                f"flat-index limit ({K.BANK_MAX_CELLS}); use fewer/smaller tenants"
            )
        with self._engine.locked(self._name):
            if self._engine.store.exists(self._name):
                return False
            self._engine.store.put(
                self._name,
                StateRecord(
                    kind="bloom_array",
                    meta={"tenants": tenants, "n": expected_insertions,
                          "p": false_probability, "m": m, "k": k, "hash": H.HASH_NAME},
                    arrays={"bits": torch.zeros((tenants, m), dtype=torch.uint8,
                                                device=self._home)},
                ),
            )
            return True

    def _rec(self) -> StateRecord:
        rec = self._engine.store.get(self._name)
        if rec is None:
            raise RuntimeError(f"BloomFilterArray '{self._name}' is not initialized")
        return rec

    def tenants(self) -> int:
        return self._rec().meta["tenants"]

    def get_size(self) -> int:
        return self._rec().meta["m"]

    def get_hash_iterations(self) -> int:
        return self._rec().meta["k"]

    def _validate_flush(self, tenant_ids, keys, allow_empty: bool = True):
        """Dtype/shape rules shared by the single-flush and window packers."""
        t = np.ascontiguousarray(tenant_ids, np.int32)
        if not self._engine.is_int_batch(keys):
            raise TypeError(
                "BloomFilterArray is the vectorized fast path: keys must be an "
                "integer numpy array (use BloomFilter for codec-encoded objects)"
            )
        arr = np.ascontiguousarray(keys, np.int64)
        if t.shape != arr.shape or t.ndim != 1:
            raise ValueError("tenant_ids and keys must be aligned 1-D arrays")
        if not allow_empty and arr.shape[0] == 0:
            raise ValueError("window flushes must be non-empty")
        return t, arr

    def _pack(self, tenant_ids, keys, cache_hot: bool = False):
        """One flush -> ONE (3, B) int32 buffer (rows: tenant, key lo, key hi),
        copied to the device in one transfer.  Read paths (`cache_hot`) reuse
        the staged buffer of an identical flush."""
        t, arr = self._validate_flush(tenant_ids, keys)
        n = arr.shape[0]
        b = K.bucket_size(max(1, n))

        device = self._home

        def build():
            lo, hi = H.int_keys_to_u32_pair(arr)
            return K.pack_rows(t, lo, hi, size=b, device=device,
                               pool=self._engine.staging_pool(device))

        if cache_hot and n >= 4096:
            tag = b"bfa%d|%s" % (b, self._engine.cache_tag(device))
            return self._engine.query_cache.cached_staged(build, t, arr, extra=tag), n
        return build(), n

    def add_each(self, tenant_ids, keys) -> np.ndarray:
        """Batch add across tenants; per key, was it (probably) new."""
        newly, n = self.add_each_async(tenant_ids, keys)
        return newly[:n].cpu().numpy() if isinstance(newly, torch.Tensor) else newly

    def add_each_async(self, tenant_ids, keys):
        """Batch add: (device newly-added flags, n_valid), no host sync."""
        tlh, n = self._pack(tenant_ids, keys)
        if n == 0:
            return np.zeros((0,), bool), 0
        with self._engine.locked(self._name):
            rec = self._rec()
            tlh = self._engine.on_card(tlh, rec.arrays["bits"])
            _, newly = K.bloom_bank_add_packed(rec.arrays["bits"], tlh, n,
                                               rec.meta["k"], rec.meta["m"])
            self._touch_version(rec)
        return newly, n

    def add(self, tenant_ids, keys) -> int:
        """Batch add across tenants; the number of (probably) new elements."""
        return int(self.add_async(tenant_ids, keys))

    def add_async(self, tenant_ids, keys):
        """Batch add with the newly-added count left on the device."""
        tlh, n = self._pack(tenant_ids, keys)
        if n == 0:
            return np.int32(0)
        with self._engine.locked(self._name):
            rec = self._rec()
            tlh = self._engine.on_card(tlh, rec.arrays["bits"])
            _, count = K.bloom_bank_add_packed_count(rec.arrays["bits"], tlh, n,
                                                     rec.meta["k"], rec.meta["m"])
            self._touch_version(rec)
        return count

    def contains(self, tenant_ids, keys) -> np.ndarray:
        """Vectorized membership across tenants: bool array aligned with keys."""
        packed, n = self.contains_async(tenant_ids, keys)
        return K.unpack_found(packed, n)

    def contains_async(self, tenant_ids, keys):
        """(device int32 result bitmap, n_valid) with no host sync; decode
        with kernels.unpack_found(bitmap, n)."""
        tlh, n = self._pack(tenant_ids, keys, cache_hot=True)
        if n == 0:
            return np.zeros((0,), np.uint32), 0
        with self._engine.locked(self._name):
            rec = self._rec()
            tlh = self._engine.on_card(tlh, rec.arrays["bits"])
            found = K.bloom_bank_contains_packed_bits(rec.arrays["bits"], tlh, n,
                                                      rec.meta["k"], rec.meta["m"])
        return found, n

    # -- window submission (multi-flush, single transfer) --------------------

    def _pack_flush_window(self, flushes):
        """Pack R flushes into ONE (3, R*Bb) int32 device buffer.

        Each flush gets a uniform Bb = bucket_size(max_len) slot; the slack is
        filled by REPEATING the flush's last entry, so one buffer serves add
        (setting the same bits again changes nothing) and contains (repeat
        results are discarded at unpack).  Flushes passed as the same array
        objects are copied to the device once and the window is composed
        there (kernels.window_from_unique).  Returns (buffer, Bb, lengths)."""
        if not flushes:
            raise ValueError("empty window")
        slot_of: dict = {}
        first_pos: list = []
        idx = np.empty(len(flushes), np.int64)
        for i, (t, k) in enumerate(flushes):
            key = (id(t), id(k))
            s = slot_of.get(key)
            if s is None:
                s = slot_of[key] = len(first_pos)
                first_pos.append(i)
            idx[i] = s
        rows = [self._validate_flush(*flushes[i], allow_empty=False) for i in first_pos]
        lengths = [rows[idx[i]][1].shape[0] for i in range(len(flushes))]
        bb = K.bucket_size(max(lengths))

        def fill(dst, t, arr):
            n = arr.shape[0]
            lo, hi = H.int_keys_to_u32_pair(arr)
            dst[0, :n] = t.view(np.uint32)
            dst[1, :n] = lo
            dst[2, :n] = hi
            if n < bb:  # repeat-pad: idempotent for add, ignored for contains
                dst[:, n:bb] = dst[:, n - 1 : n]

        device = self._home
        if len(rows) == len(flushes):
            buf = np.zeros((3, len(rows) * bb), np.uint32)
            for i, (t, arr) in enumerate(rows):
                fill(buf[:, i * bb : (i + 1) * bb], t, arr)
            return K.stage(buf, device), bb, lengths
        uniq = np.zeros((len(rows), 3, bb), np.uint32)
        for s, (t, arr) in enumerate(rows):
            fill(uniq[s], t, arr)
        tlh = K.window_from_unique(K.stage(uniq, device), K.stage(idx, device))
        return tlh, bb, lengths

    def contains_flushes_async(self, flushes):
        """R contains flushes as ONE upload + ONE kernel launch.  Returns
        (device int32 bitmap over R*Bb entries, Bb, lengths)."""
        tlh, bb, lengths = self._pack_flush_window(flushes)
        with self._engine.locked(self._name):
            rec = self._rec()
            tlh = self._engine.on_card(tlh, rec.arrays["bits"])
            packed = K.bloom_bank_contains_packed_bits(rec.arrays["bits"], tlh, tlh.shape[1],
                                                       rec.meta["k"], rec.meta["m"])
        return packed, bb, lengths

    def contains_flushes(self, flushes) -> list:
        """Sync window submission: list of bool arrays, one per flush."""
        packed, bb, lengths = self.contains_flushes_async(flushes)
        full = K.unpack_found(packed, len(lengths) * bb)
        return [full[i * bb : i * bb + n] for i, n in enumerate(lengths)]

    def add_flushes_async(self, flushes):
        """R add flushes as ONE upload and one probe + one set launch; returns
        (device newly-added int32 bitmap, Bb, lengths) without a host sync."""
        tlh, bb, lengths = self._pack_flush_window(flushes)
        with self._engine.locked(self._name):
            rec = self._rec()
            tlh = self._engine.on_card(tlh, rec.arrays["bits"])
            _, newly = K.bloom_bank_add_packed_bits(rec.arrays["bits"], tlh, tlh.shape[1],
                                                    rec.meta["k"], rec.meta["m"])
            self._touch_version(rec)
        return newly, bb, lengths

    def add_flushes(self, flushes) -> list:
        """Sync window submission: newly-added count per flush.  "Newly" is
        read against the bank at window start, so a key in two flushes of one
        window counts as new in both."""
        newly, bb, lengths = self.add_flushes_async(flushes)
        full = K.unpack_found(newly, len(lengths) * bb)
        return [int(full[i * bb : i * bb + n].sum()) for i, n in enumerate(lengths)]

    def clear_tenant(self, tenant_id: int) -> None:
        with self._engine.locked(self._name):
            rec = self._rec()
            rec.arrays["bits"][tenant_id].zero_()
            self._touch_version(rec)

    def tenant_bit_counts(self) -> np.ndarray:
        """Per-tenant set-bit counts."""
        with self._engine.locked(self._name):
            rec = self._rec()
            return rec.arrays["bits"].sum(dim=1, dtype=torch.int32).cpu().numpy()
