"""Batch: the RBatch / CommandBatchService analog — op coalescing.

A port of ``redisson_tpu/core/batch.py``: the user queues async ops against
batch-scoped object proxies and `execute()` groups them per (object, op
kind); each group concatenates its key payloads into one packed tensor and
launches ONE kernel, then scatters result slices back to the queued futures.
Consecutive same-verb bloom groups over different filters fuse into one
stacked-bank launch and an add-then-contains pair on one filter into one
dispatch (core/coalesce.py).  A run of consecutive bit-set groups is split
into levels (bitset_levels: groups on distinct records), and each level
is one upload and one launch a verb (kernels.bitset_groups).  Redisson
amortizes network round trips at this boundary; the port amortizes kernel
launches and copies.

Execution modes (Redisson's BatchOptions): IN_MEMORY (default: ops are
grouped and flushed on execute), skip_result (no result transfer) and
atomic (every touched record's lock held for the whole execute).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


class BatchFuture:
    """Minimal completion handle (RFuture analog, misc/CompletableFutureWrapper).

    Under the overlap plane (core/ioplane) a future may complete LAZILY:
    the launch happened, the result is a device-side readback future, and
    the D2H transfer runs only when get() actually demands the value (or
    when execute() drains every pending readback in one grouped transfer).
    """

    __slots__ = ("_value", "_error", "_done", "_resolve")

    def __init__(self):
        self._value = None
        self._error = None
        self._done = False
        self._resolve = None

    def _complete(self, value):
        self._value = value
        self._done = True

    def _complete_lazy(self, resolve):
        """Dispatch done; `resolve()` materializes the value on demand."""
        self._resolve = resolve
        self._done = True

    def _fail(self, err):
        self._error = err
        self._resolve = None
        self._done = True

    def done(self) -> bool:
        return self._done

    def get(self):
        if not self._done:
            raise RuntimeError("batch not executed yet")
        if self._resolve is not None:
            resolve, self._resolve = self._resolve, None
            try:
                self._value = resolve()
            except Exception as e:  # noqa: BLE001 — readback failure lands here
                self._error = e
        if self._error is not None:
            raise self._error
        return self._value


@dataclass
class _QueuedOp:
    group: Tuple  # (object name, op kind, geometry discriminator)
    payload: Any
    future: BatchFuture
    n: int  # result slice width (0 = scalar result)


class BatchResult:
    def __init__(self, responses: List[Any]):
        self.responses = responses


class Batch:
    def __init__(self, engine, skip_result: bool = False, atomic: bool = False):
        self._engine = engine
        self._ops: List[_QueuedOp] = []
        self._executed = False
        self._skip_result = skip_result
        # IN_MEMORY_ATOMIC analog: every touched record's lock is held for
        # the WHOLE execute, so no other command interleaves with the batch
        # (EXEC semantics — non-interleaved, no rollback)
        self._atomic = atomic

    # -- batch-scoped object proxies ---------------------------------------

    def get_bloom_filter(self, name: str, codec=None) -> "BatchBloom":
        return BatchBloom(self, name, codec)

    def get_bloom_filter_array(self, name: str) -> "BatchBloomArray":
        return BatchBloomArray(self, name)

    def get_hyper_log_log(self, name: str, codec=None) -> "BatchHll":
        return BatchHll(self, name, codec)

    def get_bit_set(self, name: str) -> "BatchBitSet":
        return BatchBitSet(self, name)

    def get_bucket(self, name: str, codec=None) -> "BatchBucket":
        return BatchBucket(self, name, codec)

    def get_atomic_long(self, name: str) -> "BatchAtomicLong":
        return BatchAtomicLong(self, name)

    def _enqueue(self, group: Tuple, payload, n: int) -> BatchFuture:
        if self._executed:
            raise RuntimeError("batch already executed")
        fut = BatchFuture()
        self._ops.append(_QueuedOp(group, payload, fut, n))
        return fut

    # -- execution ----------------------------------------------------------

    def execute(self) -> BatchResult:
        """Group queued ops, one fused dispatch per group, scatter results.

        Overlap plane (core/ioplane, default on): groups DISPATCH in order
        but their results stay on the card as readback futures — the whole
        batch then drains in ONE grouped D2H transfer (force_all) instead of
        one blocking fetch per group, so group G+1's staging and kernel
        overlap group G's readback.  With the plane off (set_overlap(False))
        every group forces its results before the next dispatches — the
        serial A/B reference.  Results are bit-identical in both modes: the
        plane reorders host WAITS, never device work (the stream is in
        order and mutations apply at dispatch time)."""
        from redisson_tpu_torch.core import ioplane

        if self._executed:
            raise RuntimeError("batch already executed")
        self._executed = True
        groups: Dict[Tuple, List[_QueuedOp]] = {}
        order: List[_QueuedOp] = []
        for op in self._ops:
            groups.setdefault(op.group, []).append(op)
            order.append(op)
        # pending device readbacks (overlap mode); None = serial dispatch
        pending: Optional[List] = [] if ioplane.overlap_enabled() else None

        def run_one(group, ops):
            try:
                fn = None if pending is None else _DISPATCH_LAZY.get(group[1])
                if fn is not None:
                    fn(self._engine, group, ops, pending)
                else:
                    _DISPATCH[group[1]](self._engine, group, ops)
            except Exception as e:  # noqa: BLE001 - failures land on futures
                for op in ops:
                    if not op.future.done():
                        op.future._fail(e)

        def run_groups():
            # groups run in first-submission order of their first op, so a
            # same-name object queued under two op kinds sees its earlier-
            # submitted group applied first (documented ordering contract).
            # The coalescing plane fuses CONSECUTIVE same-verb bloom groups
            # (different filters, one stacked-bank dispatch) and the
            # add-then-contains hot pair on one filter (one fused program) —
            # run boundaries never cross a verb change, so the ordering
            # contract is untouched; ineligible runs fall back per group.
            # A run of bit-set groups runs level by level: a group runs
            # after every earlier group on its record.
            items = list(groups.items())
            i = 0
            while i < len(items):
                group, ops = items[i]
                verb = group[1]
                if verb in _BITSET_VERBS:
                    # a run of bit-set groups: one upload and a launch a
                    # verb for each level of groups on distinct records
                    j = i + 1
                    while j < len(items) and items[j][0][1] in _BITSET_VERBS:
                        j += 1
                    if j - i >= 2:
                        _bitset_run(self._engine, items[i:j], pending, run_one)
                        i = j
                        continue
                if verb in ("bloom.add", "bloom.contains"):
                    j = i + 1
                    while j < len(items) and items[j][0][1] == verb:
                        j += 1
                    if j - i >= 2 and _try_fused_run(
                        self._engine, verb, items[i:j], pending
                    ):
                        i = j
                        continue
                    if (
                        verb == "bloom.add"
                        and j == i + 1
                        and j < len(items)
                        and items[j][0][1] == "bloom.contains"
                        and items[j][0][0] == group[0]
                        and _try_fused_pair(
                            self._engine, items[i], items[j], pending
                        )
                    ):
                        i = j + 1
                        continue
                run_one(group, ops)
                i += 1

        if self._atomic:
            with self._engine.locked_many({g[0] for g in groups}):
                run_groups()
        else:
            run_groups()
        if self._skip_result:
            # results were never demanded: pending readbacks stay on device
            # (a later fut.get() still resolves them individually)
            return BatchResult([])
        if pending:
            # THE one grouped D2H transfer for the whole batch's readbacks
            ioplane.force_all(pending)
        return BatchResult([op.future.get() for op in order])


# -- cross-group coalescing (core/coalesce.py fused dispatch) ----------------

def _host(value) -> np.ndarray:
    """A result on the host: tensors are copied there, numpy passes."""
    return value.cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _group_int_keys(engine, ops: List[_QueuedOp]) -> Optional[np.ndarray]:
    """One group's concatenated int keys, or None when any op carries
    codec-encoded keys (the coalescer's eligibility probe)."""
    for op in ops:
        if not engine.is_int_batch(np.asarray(op.payload)):
            return None
    return _concat_int_keys(ops)


def _assign_lazy_slices(ops: List[_QueuedOp], rb, start: int = 0,
                        summed: bool = False) -> int:
    """Complete each op's future with a lazy slice of `rb.result()` —
    demand-driven readback (overlap plane).  Returns the end offset."""
    off = start
    for op in ops:
        o, w = off, op.n
        if summed:
            op.future._complete_lazy(
                lambda o=o, w=w: int(rb.result()[o : o + w].sum())
            )
        else:
            op.future._complete_lazy(lambda o=o, w=w: rb.result()[o : o + w])
        off += w
    return off


def _try_fused_run(engine, verb: str, run, pending=None) -> bool:
    """Fuse a run of >=2 consecutive same-verb bloom groups into ONE stacked
    dispatch.  True = futures completed (or failed); False = ineligible,
    caller dispatches per group.  With `pending` (overlap plane) the run's
    result stays on device as one readback future the batch drains later."""
    from redisson_tpu_torch.core import coalesce as CO
    from redisson_tpu_torch.core import ioplane

    names = [group[0] for group, _ops in run]
    keys_list = []
    for _group, ops in run:
        keys = _group_int_keys(engine, ops)
        if keys is None or keys.size == 0:
            return False
        keys_list.append(keys)
    try:
        if verb == "bloom.contains":
            found, _lengths = CO.fused_bloom_contains_async(engine, names, keys_list)
            if pending is not None:
                rb = ioplane.ReadbackFuture((found,))
                pending.append(rb)
                off = 0
                for _group, ops in run:
                    off = _assign_lazy_slices(ops, rb, off)
            else:
                flat = _host(found)
                off = 0
                for _group, ops in run:
                    for op in ops:
                        op.future._complete(flat[off : off + op.n])
                        off += op.n
        else:
            newly, _lengths = CO.fused_bloom_add_async(engine, names, keys_list)
            if pending is not None:
                rb = ioplane.ReadbackFuture((newly,))
                pending.append(rb)
                off = 0
                for _group, ops in run:
                    off = _assign_lazy_slices(ops, rb, off, summed=True)
            else:
                flat = _host(newly)
                off = 0
                for _group, ops in run:
                    for op in ops:
                        op.future._complete(int(flat[off : off + op.n].sum()))
                        off += op.n
    except CO.CoalesceIneligible:
        return False
    except Exception as e:  # noqa: BLE001 — failures land on the run's futures
        for _group, ops in run:
            for op in ops:
                if not op.future.done():
                    op.future._fail(e)
    return True


_BITSET_VERBS = ("bitset.set", "bitset.get")


def bitset_levels(names: List[str]) -> List[List[int]]:
    """Levels of a run of bit-set groups naming records `names`: group i's
    level is the number of earlier groups of the run that name its record.
    A level's groups name distinct records, so they commute; levels run in
    order, so each group still sees every earlier group on its record."""
    seen: Dict[str, int] = {}
    levels: List[List[int]] = []
    for i, name in enumerate(names):
        level = seen.get(name, 0)
        seen[name] = level + 1
        if level == len(levels):
            levels.append([])
        levels[level].append(i)
    return levels


def _bitset_run(engine, run, pending, run_one) -> None:
    """A run of >= 2 consecutive bit-set groups, level by level
    (bitset_levels), each level's live groups in one kernels.bitset_groups
    call: one upload, one bitset_get launch for its gets and one bitset_set
    launch for its sets.  Each group is range-checked on the host first (a
    failing group's futures alone fail); a set group creates or grows its
    record, a get of a missing record replies zeros and creates nothing, an
    empty group touches nothing: as per-group dispatch does.  Every record
    of the run stays locked for the whole run.  A group on a record of
    another kind goes through run_one."""
    from redisson_tpu_torch.client.objects.bitset import BitSet

    idx = []
    for group, ops in run:
        try:
            arr = _concat_field(ops, 0, np.int64)
            BitSet(engine, group[0])._check_range(arr)
            idx.append(np.ascontiguousarray(arr, np.int32))
        except Exception as e:  # noqa: BLE001 - lands on the group's futures
            for op in ops:
                op.future._fail(e)
            idx.append(None)
    with engine.locked_many({group[0] for group, _ops in run}):
        for level in bitset_levels([group[0] for group, _ops in run]):
            _bitset_level(engine, [(run[g], idx[g]) for g in level if idx[g] is not None], pending, run_one)


def _bitset_level(engine, items, pending, run_one) -> None:
    from redisson_tpu_torch.client.objects.bitset import BitSet
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core import kernels as K

    members, planes, idx, values, touched = [], [], [], [], []
    for (group, ops), arr in items:
        name, is_set = group[0], group[1] == "bitset.set"
        try:
            if arr.size == 0:
                for op in ops:
                    op.future._complete(np.zeros(op.n, np.uint8))
                continue
            bs = BitSet(engine, name)
            rec = bs._rec_or_create(int(arr.max()) + 1) if is_set else engine.store.get(name)
        except Exception as e:  # noqa: BLE001
            for op in ops:
                op.future._fail(e)
            continue
        if rec is None:  # a get of a missing record
            for op in ops:
                op.future._complete(np.zeros(op.n, np.uint8))
            continue
        if rec.kind != "bitset" or (planes and rec.arrays["bits"].device != planes[0].device):
            # not a bit set, or a plane on another card than the level's
            # table: the group runs on its own
            run_one(group, ops)
            continue
        members.append(ops)
        planes.append(rec.arrays["bits"])
        idx.append(arr)
        values.append((1 if group[2] else 0) if is_set else None)
        if is_set:
            touched.append((bs, rec))
    if not members:
        return
    try:
        out, firsts = K.bitset_groups(planes, idx, values,
                                      pool=engine.staging_pool(planes[0].device))
        for bs, rec in touched:
            bs._touch_version(rec)
        if pending is not None:
            rb = ioplane.ReadbackFuture((out,))
            pending.append(rb)
            for ops, first in zip(members, firsts):
                _assign_lazy_slices(ops, rb, first)
        else:
            host = _host(out)
            for ops, first in zip(members, firsts):
                _scatter(ops, host[first:])
    except Exception as e:  # noqa: BLE001 - a failed launch fails the level's futures
        for ops in members:
            for op in ops:
                if not op.future.done():
                    op.future._fail(e)


def _try_fused_pair(engine, add_item, probe_item, pending=None) -> bool:
    """Fuse the add-then-contains hot pair on ONE filter into a single
    program (kernels.bloom_fused_add_contains): the probe group observes the
    adds, exactly as the sequential group order would."""
    from redisson_tpu_torch.core import coalesce as CO
    from redisson_tpu_torch.core import ioplane

    (add_group, add_ops), (probe_group, probe_ops) = add_item, probe_item
    add_keys = _group_int_keys(engine, add_ops)
    probe_keys = _group_int_keys(engine, probe_ops)
    if add_keys is None or probe_keys is None:
        return False
    if add_keys.size == 0 or probe_keys.size == 0:
        return False
    try:
        newly, n_add, found, n_probe = CO.fused_bloom_pair_async(
            engine, add_group[0], add_keys, probe_keys
        )
        if pending is not None:
            rb_add = ioplane.ReadbackFuture((newly,), lambda h: h[0][:n_add])
            rb_probe = ioplane.ReadbackFuture((found,))
            pending.extend((rb_add, rb_probe))
            _assign_lazy_slices(add_ops, rb_add, summed=True)
            _assign_lazy_slices(probe_ops, rb_probe)
        else:
            newly = _host(newly)[:n_add]
            off = 0
            for op in add_ops:
                op.future._complete(int(newly[off : off + op.n].sum()))
                off += op.n
            _scatter(probe_ops, _host(found))
    except CO.CoalesceIneligible:
        return False
    except Exception as e:  # noqa: BLE001
        for op in add_ops + probe_ops:
            if not op.future.done():
                op.future._fail(e)
    return True


# -- per-op-kind dispatchers -------------------------------------------------

def _concat_int_keys(ops: List[_QueuedOp]) -> np.ndarray:
    """Concatenate every op's keys into ONE preallocated buffer.

    np.concatenate over a per-op list allocates an intermediate array per op
    before the final copy; at batch fan-outs (hundreds of queued ops per
    flush) that numpy churn is host overhead on the hot path, so the buffer
    is sized once from the summed key counts and filled through views."""
    if len(ops) == 1:
        return np.ascontiguousarray(
            np.asarray(ops[0].payload, np.int64).reshape(-1)
        )
    arrs = [np.asarray(op.payload, np.int64).reshape(-1) for op in ops]
    out = np.empty(sum(a.shape[0] for a in arrs), np.int64)
    off = 0
    for a in arrs:
        out[off : off + a.shape[0]] = a
        off += a.shape[0]
    return out


def _concat_field(ops: List[_QueuedOp], index: Optional[int], dtype) -> np.ndarray:
    """Concatenate one payload field of every op into ONE preallocated
    buffer (the _concat_int_keys discipline for tuple payloads: no per-op
    intermediate array before the final copy).  `index` picks the payload
    tuple element; None takes the payload itself."""
    pick = (lambda op: op.payload) if index is None else (lambda op: op.payload[index])
    if len(ops) == 1:
        return np.ascontiguousarray(np.asarray(pick(ops[0]), dtype).reshape(-1))
    arrs = [np.asarray(pick(op), dtype).reshape(-1) for op in ops]
    out = np.empty(sum(a.shape[0] for a in arrs), dtype)
    off = 0
    for a in arrs:
        out[off : off + a.shape[0]] = a
        off += a.shape[0]
    return out


def _group_keys(engine, ops: List[_QueuedOp]):
    """One group's key payloads: int batches concatenate into ONE
    preallocated buffer; codec-encoded payloads flatten to a list."""
    if all(engine.is_int_batch(np.asarray(op.payload)) for op in ops):
        return _concat_int_keys(ops)
    return [
        k
        for op in ops
        for k in (op.payload if isinstance(op.payload, list) else [op.payload])
    ]


def _key_count(keys) -> int:
    """Result-slice width of a queued key payload: scalars (incl. str/bytes,
    which have misleading __len__) contribute 1 result; sequences their
    length."""
    if isinstance(keys, (str, bytes, int, float)):
        return 1
    return len(keys) if hasattr(keys, "__len__") else 1


def _scatter(ops: List[_QueuedOp], results: np.ndarray):
    # force a single host materialization up front so every per-op slice
    # below is a VIEW of one buffer, never a per-op device fetch/copy
    results = _host(results)
    off = 0
    for op in ops:
        # op.n == 0 means the op contributed no keys (empty array): complete
        # with an empty slice WITHOUT advancing the offset
        op.future._complete(results[off : off + op.n])
        off += op.n


def _bloom_contains(engine, group, ops):
    from redisson_tpu_torch.client.objects.bloom import BloomFilter

    bf = BloomFilter(engine, group[0], group[2])
    found = bf.contains_each(_group_keys(engine, ops))
    _scatter(ops, found)


def _bloom_contains_lazy(engine, group, ops, pending):
    """Dispatch-only contains: the result bitmap stays on device; each op's
    future resolves a slice when demanded (overlap plane)."""
    from redisson_tpu_torch.client.objects.bloom import BloomFilter
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core import kernels as K

    bf = BloomFilter(engine, group[0], group[2])
    found, n = bf.contains_each_async(_group_keys(engine, ops))

    def finish(host):
        arr = host[0]
        if arr.dtype in (np.int32, np.uint32):  # bitmap (u64 keys)
            return K.unpack_found(arr, n)
        return arr[:n]

    rb = ioplane.ReadbackFuture((found,), finish)
    pending.append(rb)
    _assign_lazy_slices(ops, rb)


def _bloom_add(engine, group, ops):
    from redisson_tpu_torch.client.objects.bloom import BloomFilter

    bf = BloomFilter(engine, group[0], group[2])
    # adds complete with per-op "new element" counts; one fused kernel call
    newly, n = bf.add_each_async(_group_keys(engine, ops))
    newly = _host(newly)[:n]
    off = 0
    for op in ops:
        op.future._complete(int(newly[off : off + op.n].sum()))
        off += op.n


def _bloom_add_lazy(engine, group, ops, pending):
    from redisson_tpu_torch.client.objects.bloom import BloomFilter
    from redisson_tpu_torch.core import ioplane

    bf = BloomFilter(engine, group[0], group[2])
    newly, n = bf.add_each_async(_group_keys(engine, ops))
    rb = ioplane.ReadbackFuture((newly,), lambda host: host[0][:n])
    pending.append(rb)
    _assign_lazy_slices(ops, rb, summed=True)


def _bloom_array_op(engine, group, ops, add: bool):
    from redisson_tpu_torch.client.objects.bloom_array import BloomFilterArray

    arr = BloomFilterArray(engine, group[0])
    tenants = _concat_field(ops, 0, np.int32)
    keys = _concat_field(ops, 1, np.int64)
    if add:
        newly = arr.add_each(tenants, keys)
        off = 0
        for op in ops:
            op.future._complete(int(newly[off : off + op.n].sum()))
            off += op.n
    else:
        found = arr.contains(tenants, keys)
        _scatter(ops, found)


def _bloom_array_op_lazy(engine, group, ops, pending, add: bool):
    from redisson_tpu_torch.client.objects.bloom_array import BloomFilterArray
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core import kernels as K

    arr = BloomFilterArray(engine, group[0])
    tenants = _concat_field(ops, 0, np.int32)
    keys = _concat_field(ops, 1, np.int64)
    if add:
        newly, n = arr.add_each_async(tenants, keys)
        rb = ioplane.ReadbackFuture((newly,), lambda host: host[0][:n])
        pending.append(rb)
        _assign_lazy_slices(ops, rb, summed=True)
    else:
        packed, n = arr.contains_async(tenants, keys)
        rb = ioplane.ReadbackFuture(
            (packed,), lambda host: K.unpack_found(host[0], n)
        )
        pending.append(rb)
        _assign_lazy_slices(ops, rb)


def _hll_add(engine, group, ops):
    from redisson_tpu_torch.client.objects.hyperloglog import HyperLogLog

    h = HyperLogLog(engine, group[0], group[2])
    # add_all launches without a host sync (the registers are updated in
    # place); PFADD-style True is the whole reply — nothing to read back
    h.add_all(_group_keys(engine, ops))
    for op in ops:
        op.future._complete(True)


def _bitset_set(engine, group, ops):
    from redisson_tpu_torch.client.objects.bitset import BitSet

    bs = BitSet(engine, group[0])
    idx = _concat_field(ops, 0, np.int64)
    value = group[2]
    old = bs.set_each(idx, value)
    _scatter(ops, old)


def _bitset_set_lazy(engine, group, ops, pending):
    from redisson_tpu_torch.client.objects.bitset import BitSet
    from redisson_tpu_torch.core import ioplane

    bs = BitSet(engine, group[0])
    old, n = bs.set_each_async(_concat_field(ops, 0, np.int64), group[2])
    rb = ioplane.ReadbackFuture((old,), lambda host: host[0][:n])
    pending.append(rb)
    _assign_lazy_slices(ops, rb)


def _bitset_get(engine, group, ops):
    from redisson_tpu_torch.client.objects.bitset import BitSet

    bs = BitSet(engine, group[0])
    idx = _concat_field(ops, 0, np.int64)
    got = bs.get_each(idx)
    _scatter(ops, got)


def _bitset_get_lazy(engine, group, ops, pending):
    from redisson_tpu_torch.client.objects.bitset import BitSet
    from redisson_tpu_torch.core import ioplane

    bs = BitSet(engine, group[0])
    got, n = bs.get_each_async(_concat_field(ops, 0, np.int64))
    rb = ioplane.ReadbackFuture((got,), lambda host: host[0][:n])
    pending.append(rb)
    _assign_lazy_slices(ops, rb)


def _bucket_get(engine, group, ops):
    from redisson_tpu_torch.client.objects.bucket import Bucket

    b = Bucket(engine, group[0], group[2])
    v = b.get()
    for op in ops:
        op.future._complete(v)


def _bucket_set(engine, group, ops):
    from redisson_tpu_torch.client.objects.bucket import Bucket

    b = Bucket(engine, group[0], group[2])
    for op in ops:
        b.set(op.payload)
        op.future._complete(None)


def _atomic_add(engine, group, ops):
    from redisson_tpu_torch.client.objects.bucket import AtomicLong

    a = AtomicLong(engine, group[0])
    for op in ops:
        op.future._complete(a.add_and_get(op.payload))


_DISPATCH: Dict[str, Callable] = {
    "bloom.contains": _bloom_contains,
    "bloom.add": _bloom_add,
    "bloom_array.add": lambda e, g, o: _bloom_array_op(e, g, o, True),
    "bloom_array.contains": lambda e, g, o: _bloom_array_op(e, g, o, False),
    "hll.add": _hll_add,
    "bitset.set": _bitset_set,
    "bitset.get": _bitset_get,
    "bucket.get": _bucket_get,
    "bucket.set": _bucket_set,
    "atomic.add": _atomic_add,
}

# Overlap-plane dispatchers (core/ioplane): dispatch WITHOUT forcing — the
# group's device results join the batch's pending readbacks and drain in one
# grouped transfer at execute() end.  Verbs without a lazy form (host-value
# ops: buckets, atomics, hll's constant True) use _DISPATCH in both modes.
_DISPATCH_LAZY: Dict[str, Callable] = {
    "bloom.contains": _bloom_contains_lazy,
    "bloom.add": _bloom_add_lazy,
    "bloom_array.add": lambda e, g, o, p: _bloom_array_op_lazy(e, g, o, p, True),
    "bloom_array.contains": lambda e, g, o, p: _bloom_array_op_lazy(e, g, o, p, False),
    "bitset.set": _bitset_set_lazy,
    "bitset.get": _bitset_get_lazy,
}


# -- batch-scoped proxies ----------------------------------------------------

class _BatchProxy:
    def __init__(self, batch: Batch, name: str, codec=None):
        self._batch = batch
        self._name = name
        self._codec = codec


class BatchBloom(_BatchProxy):
    def contains_async(self, keys) -> BatchFuture:
        return self._batch._enqueue(
            (self._name, "bloom.contains", self._codec), keys, _key_count(keys)
        )

    def add_async(self, keys) -> BatchFuture:
        return self._batch._enqueue(
            (self._name, "bloom.add", self._codec), keys, _key_count(keys)
        )


class BatchBloomArray(_BatchProxy):
    def contains_async(self, tenant_ids, keys) -> BatchFuture:
        return self._batch._enqueue(
            (self._name, "bloom_array.contains", None), (tenant_ids, keys), len(keys)
        )

    def add_async(self, tenant_ids, keys) -> BatchFuture:
        return self._batch._enqueue(
            (self._name, "bloom_array.add", None), (tenant_ids, keys), len(keys)
        )


class BatchHll(_BatchProxy):
    def add_all_async(self, keys) -> BatchFuture:
        return self._batch._enqueue(
            (self._name, "hll.add", self._codec), keys, _key_count(keys)
        )


class BatchBitSet(_BatchProxy):
    def set_async(self, indexes, value: bool = True) -> BatchFuture:
        idx = np.asarray(indexes)
        return self._batch._enqueue((self._name, "bitset.set", bool(value)), (idx,), idx.size)

    def get_async(self, indexes) -> BatchFuture:
        idx = np.asarray(indexes)
        return self._batch._enqueue((self._name, "bitset.get", None), (idx,), idx.size)


class BatchBucket(_BatchProxy):
    def get_async(self) -> BatchFuture:
        return self._batch._enqueue((self._name, "bucket.get", self._codec), None, 0)

    def set_async(self, value) -> BatchFuture:
        return self._batch._enqueue((self._name, "bucket.set", self._codec), value, 0)


class BatchAtomicLong(_BatchProxy):
    def add_and_get_async(self, delta: int) -> BatchFuture:
        return self._batch._enqueue((self._name, "atomic.add", None), delta, 0)
