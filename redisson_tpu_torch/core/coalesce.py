"""Cross-object coalescing plane: a run of same-verb bloom ops against
different filters as ONE kernel launch (``redisson_tpu/core/coalesce.py``).

The batch layer (core/batch.py) arrives at runs of same-verb bloom ops
against DIFFERENT filters in one batch: the config-5 fan-out (64 per-tenant
filters, one add and one contains each).  Ungrouped that costs one launch
and one key upload per (verb, object); this module fuses such a run: filters
that share geometry (same m, k, hash, physical plane size) are stacked into
a (F, S) bank on the card, every op's keys concatenate into one packed
(3, B) transfer buffer whose first row is the SEGMENT SLOT (which filter
each key probes), and the bank kernels (core/kernels.py, flat
``slot*stride + idx``) run the whole run.  Results scatter back to each
issuer by segment offset.

Semantics preserved exactly:
  * per-issuer results: segment offsets are computed on the host from the
    submitted lengths, so every reply slices back to its op in order;
  * adds: "newly" is read against the planes as they stood before the run,
    as a single group reads duplicate keys of one flush; a run naming the
    SAME filter twice under `add` is ineligible (the second group must see
    the first's bits, which one launch cannot do);
  * locking: the whole fused dispatch runs under engine.locked_many over
    the touched names (sorted order, deadlock-free).

In place on the card: ``torch.stack`` copies the planes, the add writes
into the stack, and each row is then copied back into its record's own
plane, so no two records ever share (and pin) one storage.

Ineligible runs (mixed geometry, codec keys, missing records, duplicate add
names, int32 flat-index overflow) raise CoalesceIneligible; callers fall
back to the per-group path, so coalescing is a fast path only, never a
change of semantics.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core.ioplane import device_of as _plane_device
from redisson_tpu_torch.utils import hashing as H


class CoalesceIneligible(Exception):
    """Run cannot fuse; caller must dispatch per group."""


def runs_within_admission(runs, shed_mask) -> List[Tuple[int, int]]:
    """Split each [start, end) coalescible run at QoS shed boundaries: a shed
    command never dispatches, so a run spanning one would fuse commands the
    admission decision refused, and a fused ADD run that partly applied
    could never be dispatched again (at most once).  Each run is cut into
    its maximal admitted sub-runs; sub-runs shorter than 2 fall back to
    per-command dispatch.  ``shed_mask`` None (a fully admitted frame)
    returns ``runs`` unchanged."""
    if shed_mask is None:
        return list(runs)
    out: List[Tuple[int, int]] = []
    for start, end in runs:
        i = start
        while i < end:
            if shed_mask[i]:
                i += 1
                continue
            j = i + 1
            while j < end and not shed_mask[j]:
                j += 1
            if j - i >= 2:
                out.append((i, j))
            i = j
    return out


def plan_subwindows(items: Sequence[int], target: int) -> List[Tuple[int, int]]:
    """Partition one coalescible run into preemptible sub-windows: given the
    per-command device-item counts of a run's commands, return [start, end)
    chunks (indices into the run) whose totals stay within ``target`` items.

    Splits happen at command boundaries only, never inside one command's
    key batch, so a single command larger than ``target`` forms its own
    oversized chunk (splitting a fused apply mid-batch would break at most
    once).  ``target <= 0`` (splitting off) or a run already within target
    returns the whole run as one chunk."""
    n = len(items)
    if n == 0:
        return []
    if target <= 0 or sum(items) <= target:
        return [(0, n)]
    out: List[Tuple[int, int]] = []
    start = 0
    acc = 0
    for i, it in enumerate(items):
        if i > start and acc + it > target:
            out.append((start, i))
            start = i
            acc = 0
        acc += it
    out.append((start, n))
    return out


def _concat_segments(engine, keys_list) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Concatenate per-op int-key arrays into one preallocated buffer plus an
    aligned segment-slot column.  Returns (slot, keys, lengths)."""
    arrs = []
    for ks in keys_list:
        a = np.asarray(ks)
        if not engine.is_int_batch(a):
            raise CoalesceIneligible("non-integer key batch")
        arrs.append(np.ascontiguousarray(a, np.int64).reshape(-1))
    lengths = [a.shape[0] for a in arrs]
    total = sum(lengths)
    if total == 0:
        raise CoalesceIneligible("empty run")
    keys = np.empty(total, np.int64)
    slot = np.empty(total, np.int32)
    off = 0
    for s, a in enumerate(arrs):
        n = a.shape[0]
        keys[off : off + n] = a
        slot[off : off + n] = s
        off += n
    return slot, keys, lengths


def _validated_records(engine, names: Sequence[str]):
    """Fetch and geometry-check the run's records.  Caller holds the locks.

    Every plane of the stack must live on one device, and with placement on
    every record must be owned by one position (``StateRecord.position``):
    the server splits a frame's runs a position at a time
    (``placement.plan_frame``), so a mixed run here happens only
    mid-handoff, and it falls back to per-record dispatch, each record on
    its own owner's lane."""
    recs = []
    m = k = shape = hname = None
    device = position = None
    for name in names:
        rec = engine.store.get(name)
        if rec is None or rec.kind != "bloom":
            raise CoalesceIneligible(f"'{name}' is not an initialized bloom filter")
        if m is None:
            m, k = rec.meta["m"], rec.meta["k"]
            hname = rec.meta.get("hash")
            shape = rec.arrays["bits"].shape
            device = _plane_device(rec.arrays["bits"])
            position = rec.position
        elif (
            rec.meta["m"] != m
            or rec.meta["k"] != k
            or rec.meta.get("hash") != hname
            or rec.arrays["bits"].shape != shape
        ):
            raise CoalesceIneligible("mixed filter geometry in run")
        elif _plane_device(rec.arrays["bits"]) != device or rec.position != position:
            raise CoalesceIneligible("planes span devices")
        recs.append(rec)
    if len(names) * shape[0] > K.BANK_MAX_CELLS:
        raise CoalesceIneligible("stacked planes exceed flat int32 index space")
    return recs, m, k


def _pack_window(engine, slot: np.ndarray, keys: np.ndarray, device=None):
    """(slot, keys) -> staged (3, B) int32 transfer buffer + n_valid, staged
    through the engine's pinned double-buffered pool when it has one."""
    n = keys.shape[0]
    b = K.bucket_size(n)
    lo, hi = H.int_keys_to_u32_pair(keys)
    return K.pack_rows(slot, lo, hi, size=b, device=engine.device,
                       pool=engine.staging_pool(device)), n


def fused_bloom_contains_async(engine, names: Sequence[str], keys_list):
    """ONE launch for a contains run over several same-geometry filters.

    Returns (device bool tensor over the concatenated window, lengths):
    issuer i's reply is at [sum(lengths[:i]), +lengths[i]).  No host sync."""
    slot, keys, lengths = _concat_segments(engine, keys_list)
    tlh, n = _pack_window(engine, slot, keys, device=engine.device_for_name(names[0]))
    with engine.locked_many(set(names)):
        recs, m, k = _validated_records(engine, names)
        planes = torch.stack([r.arrays["bits"] for r in recs])
        found = K.bloom_bank_contains_packed(planes, tlh, n, k, m)
    return found, lengths


def fused_bloom_add_async(engine, names: Sequence[str], keys_list):
    """ONE add for a run over several DISTINCT same-geometry filters; each
    filter's row is copied back into its own plane under the run's locks.
    Returns (device newly-added bool tensor, lengths)."""
    if len(set(names)) != len(names):
        raise CoalesceIneligible(
            "duplicate filter in add run (second group must observe the first)"
        )
    slot, keys, lengths = _concat_segments(engine, keys_list)
    tlh, n = _pack_window(engine, slot, keys, device=engine.device_for_name(names[0]))
    with engine.locked_many(set(names)):
        recs, m, k = _validated_records(engine, names)
        planes = torch.stack([r.arrays["bits"] for r in recs])
        planes, newly = K.bloom_bank_add_packed(planes, tlh, n, k, m)
        for i, rec in enumerate(recs):
            rec.arrays["bits"].copy_(planes[i])
            rec.version += 1
    return newly, lengths


def fused_bloom_pair_async(engine, name: str, add_keys, probe_keys):
    """The add-then-probe PAIR on one filter as one dispatch
    (kernels.bloom_fused_add_contains): the probe observes the adds.
    Returns (device newly bool, n_add, device found bool, n_probe)."""
    add_arr = np.asarray(add_keys)
    probe_arr = np.asarray(probe_keys)
    if not (engine.is_int_batch(add_arr) and engine.is_int_batch(probe_arr)):
        raise CoalesceIneligible("non-integer key batch")
    if add_arr.size == 0 or probe_arr.size == 0:
        raise CoalesceIneligible("empty side of fused pair")
    kind_a, lh_a, n_a = engine.pack_keys(add_arr, None)
    kind_p, lh_p, n_p = engine.pack_keys(probe_arr, None)
    if kind_a != "u64" or kind_p != "u64":
        raise CoalesceIneligible("fused pair requires u64 key packing")
    with engine.locked(name):
        rec = engine.store.get(name)
        if rec is None or rec.kind != "bloom":
            raise CoalesceIneligible(f"'{name}' is not an initialized bloom filter")
        m, k = rec.meta["m"], rec.meta["k"]
        _, newly, found = K.bloom_fused_add_contains(rec.arrays["bits"], lh_a, n_a, lh_p, n_p, k, m)
        rec.version += 1
    return newly, n_a, found, n_p
