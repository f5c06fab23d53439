"""HyperLogLogArray: a bank of HLL counters as one (T, m) register tensor
(BASELINE config 3): a mixed-tenant add batch is one scatter-max launch and a
whole wave of pairwise merges one row gather-max launch per round.  Same
replies as ``redisson_tpu/client/objects/hll_array.py``."""
from __future__ import annotations

import numpy as np

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core.store import StateRecord
from redisson_tpu_torch.ops import hll as hll_ops
from redisson_tpu_torch.utils import hashing as H


class HyperLogLogArray(RExpirable):
    def try_init(self, tenants: int, p: int = hll_ops.DEFAULT_P) -> bool:
        if tenants <= 0:
            raise ValueError("tenants must be positive")
        with self._engine.locked(self._name):
            if self._engine.store.exists(self._name):
                return False
            self._engine.store.put(
                self._name,
                StateRecord(
                    kind="hll_array",
                    meta={"tenants": tenants, "p": p, "hash": H.HASH_NAME},
                    arrays={"regs": hll_ops.make_bank(tenants, p, self._home)},
                ),
            )
            return True

    def _rec(self) -> StateRecord:
        rec = self._engine.store.get(self._name)
        if rec is None:
            raise RuntimeError(f"HyperLogLogArray '{self._name}' is not initialized")
        return rec

    def tenants(self) -> int:
        return self._rec().meta["tenants"]

    def add(self, tenant_ids, keys) -> None:
        """Mixed-tenant streaming add: one scatter-max launch."""
        t = np.ascontiguousarray(tenant_ids, np.int32)
        if not self._engine.is_int_batch(keys):
            raise TypeError("HyperLogLogArray fast path requires integer numpy keys")
        arr = np.ascontiguousarray(keys, np.int64)
        if t.shape != arr.shape:
            raise ValueError("tenant_ids and keys must be aligned 1-D arrays")
        n = arr.shape[0]
        if n == 0:
            return
        lo, hi = H.int_keys_to_u32_pair(arr)
        tlh = K.pack_rows(t, lo, hi, size=K.bucket_size(n), device=self._home)
        with self._engine.locked(self._name):
            rec = self._rec()
            tlh = self._engine.on_card(tlh, rec.arrays["regs"])
            K.hll_bank_add_packed(rec.arrays["regs"], tlh, n, rec.meta["p"])
            self._touch_version(rec)

    def merge_rows(self, dst_ids, src_ids) -> None:
        """Batched pairwise PFMERGE: counter[dst] |= counter[src] per pair.

        Each round is one dense (P,) source map and one row gather-max over
        the bank (kernels.hll_bank_merge_map), written to a new bank.  Pairs
        sharing a dst split into successive unique-dst rounds; rounds past
        the first gather their sources from a snapshot of the bank taken
        before the call (hll_bank_merge_map_from), so a dst updated in round
        1 cannot leak its new registers through a later round."""
        dst = np.ascontiguousarray(dst_ids, np.int32)
        src = np.ascontiguousarray(src_ids, np.int32)
        if dst.shape != src.shape:
            raise ValueError("dst_ids and src_ids must be aligned")
        if dst.shape[0] == 0:
            return
        with self._engine.locked(self._name):
            rec = self._rec()
            device = rec.arrays["regs"].device
            P = rec.arrays["regs"].shape[0]
            if (int(dst.min()) < 0 or int(dst.max()) >= P
                    or int(src.min()) < 0 or int(src.max()) >= P):
                raise ValueError(f"counter id out of range [0, {P})")
            multi_round = len(np.unique(dst)) != dst.shape[0]
            orig = rec.arrays["regs"].clone() if multi_round else None
            first_round = True
            pairs_d, pairs_s = dst, src
            while pairs_d.size:
                _vals, first = np.unique(pairs_d, return_index=True)
                take = np.zeros(pairs_d.shape[0], bool)
                take[first] = True
                src_map = np.arange(P, dtype=np.int32)
                src_map[pairs_d[take]] = pairs_s[take]
                src_map = K.stage(src_map, device)
                if first_round:
                    rec.arrays["regs"] = K.hll_bank_merge_map(rec.arrays["regs"], src_map)
                    first_round = False
                else:
                    rec.arrays["regs"] = K.hll_bank_merge_map_from(rec.arrays["regs"], orig, src_map)
                pairs_d, pairs_s = pairs_d[~take], pairs_s[~take]
            self._touch_version(rec)

    def estimate_all(self) -> np.ndarray:
        """Per-tenant cardinality estimates (float32), one launch."""
        return self.estimate_all_async().cpu().numpy()

    def estimate_all_async(self):
        """(T,) float32 estimates left on the device."""
        with self._engine.locked(self._name):
            return K.hll_estimate(self._rec().arrays["regs"])

    def estimate_union_pairs(self, a_ids, b_ids) -> np.ndarray:
        """PFCOUNT of the union per (a, b) pair without changing either row."""
        return self.estimate_union_pairs_async(a_ids, b_ids).cpu().numpy()

    def estimate_union_pairs_async(self, a_ids, b_ids):
        a = K.stage(np.ascontiguousarray(a_ids, np.int32), self._home)
        b = K.stage(np.ascontiguousarray(b_ids, np.int32), self._home)
        with self._engine.locked(self._name):
            regs = self._rec().arrays["regs"]
            a, b = self._engine.on_card((a, b), regs)
            return K.hll_bank_estimate_union_pairs(regs, a, b)
