"""Sharded sketch objects: single logical objects spread across the mesh.

A copy of ``redisson_tpu/client/objects/sharded.py``.  A
ShardedBloomFilterArray's bit plane is column-sharded over the mesh's
`shard` positions and probed by every shard's windowed kernel, a
ShardedHllArray's tenant axis is range-sharded, and a ShardedBitSet is ONE
logical bit set column-sharded (``parallel/sharded.py``).  They are object
handles on the engine path: the same record store and locks as every other
object.  A sharded record's plane is a ``parallel.sharded.ShardedPlane``;
no call of these handles runs the unsharded programs.

Geometry notes:
  * bloom: m is rounded up so it divides evenly by the shard-axis size
    (each shard owns a contiguous column range of every tenant's plane);
  * hll: tenants are rounded up to a shard-axis multiple (each shard owns a
    tenant range; adds route with zero collectives, estimates gather).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.client.objects.bloom import (
    optimal_num_of_bits,
    optimal_num_of_hash_functions,
)
from redisson_tpu_torch.core.store import StateRecord
from redisson_tpu_torch.ops import hll as hll_ops
from redisson_tpu_torch.parallel.manager import MeshManager
from redisson_tpu_torch.parallel.sharded import ShardedPlane
from redisson_tpu_torch.utils import hashing as H

BLOOM_AXIS = 1    # (T, m): columns sharded
HLL_AXIS = 0      # (T, regs): tenants sharded
BITSET_AXIS = 0   # (m,): bits sharded


def _host(flags: torch.Tensor, n: int) -> np.ndarray:
    return flags[:n].cpu().numpy().astype(bool)


class _ShardedBase(RExpirable):
    @property
    def _mgr(self) -> MeshManager:
        return MeshManager.of(self._engine)

    def _bloom_width(self, m: int, geom) -> int:
        """Stored plane width for the dispatch geometry: the hash domain m
        padded to a lane-aligned shard multiple (pad columns are never
        probed, so a reshard to a non-dividing shard count re-pads)."""
        return self._mgr.round_up(m, 128 * geom.n_shard)

    def _hll_rows(self, tenants: int, geom) -> int:
        """Stored row count for the dispatch geometry (logical tenants
        padded to a shard multiple; pad rows are never addressed)."""
        return self._mgr.round_up(tenants, geom.n_shard)

    def _rec(self) -> StateRecord:
        rec = self._engine.store.get(self._name)
        if rec is None:
            raise RuntimeError(f"{type(self).__name__} '{self._name}' is not initialized")
        return rec

    def _pack(self, tenant_ids, keys, geom):
        t = np.ascontiguousarray(tenant_ids, np.int32)
        if not self._engine.is_int_batch(keys):
            raise TypeError(
                f"{type(self).__name__} is the vectorized fast path: keys must "
                "be an integer numpy array"
            )
        arr = np.ascontiguousarray(keys, np.int64)
        if t.shape != arr.shape:
            raise ValueError("tenant_ids and keys must be aligned 1-D arrays")
        lo, hi = H.int_keys_to_u32_pair(arr)
        return self._mgr.pad_batch(t, lo, hi, geom=geom)

    def shards(self) -> int:
        return self._mgr.n_shard


class ShardedBloomFilterArray(_ShardedBase):
    """Multi-tenant bloom bank whose bit plane is sharded across the mesh."""

    _kind = "sharded_bloom_array"

    def try_init(
        self,
        tenants: int,
        expected_insertions: int,
        false_probability: float,
        m: Optional[int] = None,
    ) -> bool:
        if tenants <= 0:
            raise ValueError("tenants must be positive")
        mgr = self._mgr
        if m is None:
            m = optimal_num_of_bits(expected_insertions, false_probability)
        # columns split evenly over the shard axis, each shard's width a
        # multiple of 128
        geom = mgr.geometry()
        m = mgr.round_up(m, 128 * geom.n_shard)
        k = optimal_num_of_hash_functions(expected_insertions, m)
        with self._engine.locked(self._name):
            if self._engine.store.exists(self._name):
                return False
            rec = StateRecord(
                kind=self._kind,
                meta={
                    "tenants": tenants,
                    "n": expected_insertions,
                    "p": false_probability,
                    "m": m,
                    "k": k,
                    "hash": H.HASH_NAME,
                    "sharded": True,
                },
                arrays={"bits": ShardedPlane.zeros((tenants, m), geom.mesh, BLOOM_AXIS)},
            )
            self._engine.store.put(self._name, rec)
            return True

    def tenants(self) -> int:
        return self._rec().meta["tenants"]

    def get_size(self) -> int:
        return self._rec().meta["m"]

    def get_hash_iterations(self) -> int:
        return self._rec().meta["k"]

    def _plane(self, rec, geom):
        w = self._bloom_width(rec.meta["m"], geom)
        return w, self._mgr.adapt_plane(rec, "bits", BLOOM_AXIS, length=w, geom=geom)

    def add_each(self, tenant_ids, keys) -> np.ndarray:
        """Batch add across tenants; bool array: element was (probably) new."""
        geom = self._mgr.geometry()
        batch, n = self._pack(tenant_ids, keys, geom)
        if n == 0:
            return np.zeros((0,), bool)
        with self._engine.locked(self._name):
            rec = self._rec()
            meta = rec.meta
            w, bits = self._plane(rec, geom)
            add, _ = self._mgr.bloom_kernels(meta["k"], meta["m"], meta["tenants"], width=w, geom=geom)
            bits, newly = add(bits, batch, n)
            rec.arrays["bits"] = bits
            self._touch_version(rec)
        return _host(newly, n)

    def add(self, tenant_ids, keys) -> int:
        return int(np.sum(self.add_each(tenant_ids, keys)))

    def contains_each(self, tenant_ids, keys) -> np.ndarray:
        """Vectorized membership across tenants: bool array aligned to keys."""
        found, n = self.contains_async(tenant_ids, keys)
        return found[:n] if isinstance(found, np.ndarray) else _host(found, n)

    def contains_async(self, tenant_ids, keys):
        """Pipelined probe: (device bool tensor, n_valid) without forcing the
        device->host copy; callers keep flushes in flight and force later."""
        geom = self._mgr.geometry()
        batch, n = self._pack(tenant_ids, keys, geom)
        if n == 0:
            return np.zeros((0,), bool), 0
        with self._engine.locked(self._name):
            rec = self._rec()
            meta = rec.meta
            w, bits = self._plane(rec, geom)
            _, contains = self._mgr.bloom_kernels(meta["k"], meta["m"], meta["tenants"], width=w,
                                                  geom=geom)
            found = contains(bits, batch, n)
        return found, n

    def clear_tenant(self, tenant_id: int) -> None:
        with self._engine.locked(self._name):
            rec = self._rec()
            if not 0 <= tenant_id < rec.meta["tenants"]:
                raise IndexError(
                    f"tenant {tenant_id} out of range [0, {rec.meta['tenants']})"
                )
            _, bits = self._plane(rec, self._mgr.geometry())
            for _d, _s, part in bits.each():
                part[tenant_id].zero_()
            self._touch_version(rec)

    def tenant_bit_counts(self) -> np.ndarray:
        """Per-tenant set-bit counts (the fill monitor): a count a shard,
        summed over the column shards."""
        with self._engine.locked(self._name):
            rec = self._rec()
            _, bits = self._plane(rec, self._mgr.geometry())
            dev = bits.device
            total = None
            for part in bits.parts[0]:
                c = part.sum(dim=1, dtype=torch.int32).to(dev)
                total = c if total is None else total + c
            return total.cpu().numpy()


class ShardedHllArray(_ShardedBase):
    """Multi-tenant HLL bank with the tenant axis sharded across the mesh:
    adds are shard-local (no combine but the dp replicas'), estimates
    gather once."""

    _kind = "sharded_hll_array"

    def try_init(self, tenants: int, p: int = hll_ops.DEFAULT_P) -> bool:
        if tenants <= 0:
            raise ValueError("tenants must be positive")
        geom = self._mgr.geometry()
        padded_tenants = self._hll_rows(tenants, geom)
        with self._engine.locked(self._name):
            if self._engine.store.exists(self._name):
                return False
            rec = StateRecord(
                kind=self._kind,
                meta={"tenants": tenants, "p": p, "hash": H.HASH_NAME, "sharded": True},
                arrays={"regs": ShardedPlane.zeros((padded_tenants, hll_ops.m_of(p)), geom.mesh,
                                                   HLL_AXIS)},
            )
            self._engine.store.put(self._name, rec)
            return True

    def tenants(self) -> int:
        return self._rec().meta["tenants"]

    def _bank(self, rec, geom):
        rows = self._hll_rows(rec.meta["tenants"], geom)
        return rows, self._mgr.adapt_plane(rec, "regs", HLL_AXIS, length=rows, geom=geom)

    def add_each(self, tenant_ids, keys) -> None:
        geom = self._mgr.geometry()
        batch, n = self._pack(tenant_ids, keys, geom)
        if n == 0:
            return
        with self._engine.locked(self._name):
            rec = self._rec()
            rows, regs = self._bank(rec, geom)
            add, _ = self._mgr.hll_kernels(rec.meta["p"], rows, geom=geom)
            rec.arrays["regs"] = add(regs, batch, n)
            self._touch_version(rec)

    def estimate_all(self) -> np.ndarray:
        """Per-tenant cardinality estimates (each shard's rows, gathered)."""
        with self._engine.locked(self._name):
            rec = self._rec()
            geom = self._mgr.geometry()
            rows, regs = self._bank(rec, geom)
            _, estimate = self._mgr.hll_kernels(rec.meta["p"], rows, geom=geom)
            ests = estimate(regs)
        return ests.cpu().numpy()[: rec.meta["tenants"]]

    def estimate(self, tenant_id: int) -> int:
        return int(round(float(self.estimate_all()[tenant_id])))

    def clear_tenant(self, tenant_id: int) -> None:
        with self._engine.locked(self._name):
            rec = self._rec()
            if not 0 <= tenant_id < rec.meta["tenants"]:
                raise IndexError(
                    f"tenant {tenant_id} out of range [0, {rec.meta['tenants']})"
                )
            _, regs = self._bank(rec, self._mgr.geometry())
            t_local = regs.parts[0, 0].shape[0]
            for _d, s, part in regs.each():
                if s == tenant_id // t_local:
                    part[tenant_id - s * t_local].zero_()
            self._touch_version(rec)


class ShardedBitSet(_ShardedBase):
    """ONE logical RBitSet column-sharded across the mesh.

    The LOGICAL size is fixed at try_init; the STORED width depends on the
    mesh (padded to a lane- and shard-aligned multiple for the current
    geometry, re-padded on reshard by adapt_plane).  Indexes are checked
    against the logical size, so padding never leaks into results."""

    _kind = "sharded_bitset"

    def try_init(self, size: int) -> bool:
        if size <= 0:
            raise ValueError("size must be positive")
        if size > (1 << 31):
            # indexes travel as int32 through the kernels
            raise ValueError("sharded bitset size is capped at 2^31 bits")
        geom = self._mgr.geometry()
        m = self._mgr.round_up(size, 128 * geom.n_shard)
        with self._engine.locked(self._name):
            if self._engine.store.exists(self._name):
                return False
            rec = StateRecord(
                kind=self._kind,
                meta={"size": size, "m": m, "sharded": True},
                arrays={"bits": ShardedPlane.zeros((m,), geom.mesh, BITSET_AXIS)},
            )
            self._engine.store.put(self._name, rec)
            return True

    def size(self) -> int:
        return self._rec().meta["size"]

    def plane_width(self) -> int:
        return self._rec().meta["m"]

    def _plane(self, rec, geom):
        w = self._bloom_width(rec.meta["m"], geom)
        return w, self._mgr.adapt_plane(rec, "bits", BITSET_AXIS, length=w, geom=geom)

    def _pack_indexes(self, indexes, size: int, geom):
        idx = np.ascontiguousarray(indexes, np.int64)
        if idx.ndim != 1:
            raise ValueError("indexes must be a 1-D integer array")
        if idx.size and ((idx < 0) | (idx >= size)).any():
            raise IndexError(f"bit index out of range [0, {size})")
        return self._mgr.pad_indexes(idx, geom=geom)

    def set_each(self, indexes, value: bool = True) -> np.ndarray:
        """Batch SETBIT; returns each bit's PREVIOUS value."""
        with self._engine.locked(self._name):
            rec = self._rec()
            geom = self._mgr.geometry()
            batch, n = self._pack_indexes(indexes, rec.meta["size"], geom)
            if n == 0:
                return np.zeros((0,), bool)
            w, bits = self._plane(rec, geom)
            (set_t, set_f), _, _ = self._mgr.bitset_kernels(rec.meta["m"], width=w, geom=geom)
            bits, old = (set_t if value else set_f)(bits, batch, n)
            rec.arrays["bits"] = bits
            self._touch_version(rec)
        return _host(old, n)

    def get_each(self, indexes) -> np.ndarray:
        with self._engine.locked(self._name):
            rec = self._rec()
            geom = self._mgr.geometry()
            batch, n = self._pack_indexes(indexes, rec.meta["size"], geom)
            if n == 0:
                return np.zeros((0,), bool)
            w, bits = self._plane(rec, geom)
            _, get, _ = self._mgr.bitset_kernels(rec.meta["m"], width=w, geom=geom)
            got = get(bits, batch, n)
        return _host(got, n)

    def set(self, index: int, value: bool = True) -> bool:
        return bool(self.set_each(np.asarray([index]), value)[0])

    def get(self, index: int) -> bool:
        return bool(self.get_each(np.asarray([index]))[0])

    def cardinality(self) -> int:
        with self._engine.locked(self._name):
            rec = self._rec()
            geom = self._mgr.geometry()
            w, bits = self._plane(rec, geom)
            _, _, card = self._mgr.bitset_kernels(rec.meta["m"], width=w, geom=geom)
            return card(bits)

    def clear(self) -> None:
        with self._engine.locked(self._name):
            rec = self._rec()
            geom = self._mgr.geometry()
            w = self._bloom_width(rec.meta["m"], geom)
            rec.arrays["bits"] = ShardedPlane.zeros((w,), geom.mesh, BITSET_AXIS)
            self._touch_version(rec)

    def _binary_op(self, op, other_names):
        """BITOP against other sharded bitsets: identically-sharded planes,
        combined part by part on each position (no data moves)."""
        other_names = [self._map_name(n) for n in other_names]
        names = [self._name, *other_names]
        with self._engine.locked_many(names):
            rec = self._rec()
            geom = self._mgr.geometry()
            w, bits = self._plane(rec, geom)
            for other in other_names:
                orec = self._engine.store.get(other)
                if orec is None or orec.kind != self._kind:
                    raise ValueError(f"'{other}' is not an initialized {type(self).__name__}")
                if orec.meta["m"] != rec.meta["m"] or orec.meta["size"] != rec.meta["size"]:
                    # a wider-size operand would plant ghost bits past this
                    # plane's size
                    raise ValueError("sharded BITOP operands must share geometry (size and plane width)")
                obits = self._mgr.adapt_plane(orec, "bits", BITSET_AXIS, length=w, geom=geom)
                for d, s, part in bits.each():
                    op(part, obits.parts[d, s], out=part)
            self._touch_version(rec)

    def or_(self, *other_names: str) -> None:
        self._binary_op(torch.bitwise_or, other_names)

    def and_(self, *other_names: str) -> None:
        self._binary_op(torch.bitwise_and, other_names)

    def xor(self, *other_names: str) -> None:
        self._binary_op(torch.bitwise_xor, other_names)

    def not_(self) -> None:
        """Flip every LOGICAL bit (padding stays zero so cardinality and
        cross-plane ops never see ghost bits)."""
        with self._engine.locked(self._name):
            rec = self._rec()
            _, bits = self._plane(rec, self._mgr.geometry())
            size = rec.meta["size"]
            for _d, s, part in bits.each():
                lo = s * part.shape[0]
                live = torch.arange(lo, lo + part.shape[0], device=part.device) < size
                part.copy_(torch.where(live, 1 - part, part))
            self._touch_version(rec)
