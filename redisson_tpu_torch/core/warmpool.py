"""Kernel warm pool: run the hot kernels OUTSIDE any request's latency
budget.

A port of ``redisson_tpu/core/warmpool.py``.  The reference warms XLA
programs, which compile lazily on their first dispatch.  The port builds no
program per shape: its kernels are built once a process.  What the first
launch of a kernel at a record's geometry still pays on the card is the
load of the kernel's module, its shared-memory attributes and the growth of
PyTorch's caching allocator to the sizes the kernel's outputs and scratch
take.  Warming runs each hot kernel once, on a throwaway plane of the
record's geometry and at the batch bucket, on each requested device, and
waits for it.

One process-global pool (the kernels' modules and the caching allocator are
process-wide), keyed by ``(verb, shape, dtype, epoch, geometry, device)``
exactly as the reference keys it:

  * verb   — the kernel family ("bloom", "bloom_array", "hll", ...);
  * shape  — the bucketed shape(s) the kernels ran at;
  * dtype  — the operand dtype;
  * epoch  — the mesh epoch of sharded programs (0 for the rest);
  * device — the placement axis: the position id with placement on, -1
             (the engine's device) without, so a single-device engine keeps
             the reference's keys.

The pool only BOOKKEEPS which keys are warm (a bounded LRU; it pins no
device memory), and ``warm()`` runs a key's thunk once: engine start,
repeated prewarm calls and mapper boots do the work once.  A throwaway
plane never touches the record.  ``prewarm_store`` walks an engine's live
records and warms each kind's hot kernels at the requested buckets (the
server's ``--prewarm`` and ``Engine.prewarm``).

The sharded programs' cross-epoch pool lives on
``parallel/manager.MeshManager``; the manifest warmer fetches through it.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import kernels as K


class KernelWarmPool:
    """Bounded bookkeeping of warmed (verb, shape, dtype, epoch) keys."""

    def __init__(self, max_entries: int = 512):
        self._entries: "OrderedDict[Tuple, float]" = OrderedDict()
        self._max = max_entries
        self._lock = threading.Lock()
        self.hits = 0    # warm() calls that found the key already warm
        self.warms = 0   # thunks actually run

    def warmed(self, key: Tuple) -> bool:
        with self._lock:
            return key in self._entries

    def warm(self, key: Tuple, thunk) -> bool:
        """Run `thunk` once a key; True iff THIS call ran it.  The thunk
        runs OUTSIDE the lock; a concurrent warm of the same key at worst
        runs the kernels twice."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return False
        thunk()
        with self._lock:
            self._entries[key] = time.monotonic()
            self._entries.move_to_end(key)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)
            self.warms += 1
        return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits, "warms": self.warms}


# process-global: the kernels' modules and the caching allocator it mirrors
# are process-global too
POOL = KernelWarmPool()


def _dev_key(device) -> int:
    """The key's device axis: -1 = the engine's device (no placement), so a
    single-device engine keeps the reference's keys."""
    return -1 if device is None else getattr(device, "id", 0)


def _target(engine, device) -> torch.device:
    """Where a throwaway plane lives: the position's device, else the
    engine's."""
    return getattr(device, "device", None) or engine.device


def _zeros_like(value: torch.Tensor, dev) -> torch.Tensor:
    """A zeroed throwaway plane of a record array's shape and dtype."""
    return torch.zeros(tuple(value.shape), dtype=value.dtype, device=dev)


def _warm_bloom(engine, rec, buckets: Iterable[int], device=None) -> int:
    m, k = rec.meta["m"], rec.meta["k"]
    plane = rec.arrays["bits"]
    dev = _target(engine, device)
    n = 0
    for b in buckets:
        b = K.bucket_size(b)

        def thunk(b=b):
            lh = K.stage(np.zeros((2, b), np.uint32), dev)
            lh2 = K.stage(np.zeros((2, b), np.uint32), dev)
            # throwaway planes of the record's geometry: the adds write
            # their plane, so a record's own plane never warms directly
            bits = _zeros_like(plane, dev)
            bits, _ = K.bloom_add_packed(bits, lh, 1, k, m)
            K.bloom_contains_packed_bits(bits, lh, 1, k, m)
            bits2 = _zeros_like(plane, dev)
            bits2, _ = K.bloom_add_packed_count(bits2, lh, 1, k, m)
            K.bloom_fused_add_contains(bits2, lh, 1, lh2, 1, k, m)
            ioplane.wait_device(dev)

        n += POOL.warm(("bloom", (b,), "u64", 0, (m, k), _dev_key(device)), thunk)
    return n


def _warm_bloom_array(engine, rec, buckets: Iterable[int], device=None) -> int:
    m, k, tenants = rec.meta["m"], rec.meta["k"], rec.meta["tenants"]
    plane = rec.arrays["bits"]
    dev = _target(engine, device)
    n = 0
    for b in buckets:
        b = K.bucket_size(b)

        def thunk(b=b):
            tlh = K.stage(np.zeros((3, b), np.uint32), dev)
            bank = _zeros_like(plane, dev)
            K.bloom_bank_add_packed_bits(bank, tlh, 1, k, m)
            K.bloom_bank_contains_packed_bits(bank, tlh, 1, k, m)
            ioplane.wait_device(dev)

        n += POOL.warm(
            ("bloom_array", (tenants, b), "u64", 0, (m, k), _dev_key(device)),
            thunk,
        )
    return n


def _warm_hll(engine, rec, buckets: Iterable[int], device=None) -> int:
    p = rec.meta["p"]
    regs = rec.arrays["regs"]
    shape = tuple(regs.shape)
    dtype = str(regs.dtype).replace("torch.", "")
    dev = _target(engine, device)
    n = 0
    for b in buckets:
        b = K.bucket_size(b)

        def thunk(b=b):
            dummy = _zeros_like(regs, dev)
            if len(shape) == 2:
                tlh = K.stage(np.zeros((3, b), np.uint32), dev)
                K.hll_bank_add_packed(dummy, tlh, 1, p)
                K.hll_rows(dummy, estimate=True)
            else:
                lh = K.stage(np.zeros((2, b), np.uint32), dev)
                K.hll_add_packed(dummy, lh, 1, p)
                K.hll_estimate(dummy)
            ioplane.wait_device(dev)

        n += POOL.warm(("hll", shape, dtype, 0, (p, b), _dev_key(device)), thunk)
    return n


def _warm_vector_bank(engine, rec, buckets: Iterable[int], device=None) -> int:
    """Warm one embedding bank's KNN kernels: the FLAT score and select
    (and the IVF route, cell scoring and select when the record carries a
    trained index) at the bank's exact geometry, a device.  A sharded bank
    warms once a shard record; its cross-shard merge warms through the
    manifest warmer below."""
    bank = rec.arrays.get("bank")
    if bank is None:
        return 0  # never flushed: no geometry to warm yet
    meta = rec.meta
    metric = str(meta.get("metric", "COSINE"))
    dtype = str(meta.get("dtype", "FLOAT32"))
    cap, pwidth = bank.shape
    k = max(1, min(10, cap))
    cells = rec.arrays.get("cells")
    cents = rec.arrays.get("centroids")
    nprobe = int(meta.get("nprobe", 0) or 1)
    dev = _target(engine, device)

    def thunk():
        q = K.stage(np.zeros((1, pwidth), np.float32), dev)
        dummy = _zeros_like(bank, dev)
        scale = rec.arrays.get("scale")
        dscale = (torch.ones((cap,), dtype=torch.float32, device=dev)
                  if scale is not None else None)
        dbias = torch.zeros((cap,), dtype=torch.float32, device=dev)
        K.knn_flat(dummy, dscale, dbias, None, q, 1, k, metric)
        if cells is not None and cents is not None:
            dc = torch.zeros(tuple(cents.shape), dtype=torch.float32, device=dev)
            dl = torch.zeros(tuple(cells.shape), dtype=torch.int32, device=dev)
            np_eff = max(1, min(nprobe, cents.shape[0]))
            k_ivf = max(1, min(k, np_eff * cells.shape[1]))
            K.knn_ivf(dummy, dscale, dbias, None, dc, dl, q, 1, k_ivf, np_eff, metric)
        ioplane.wait_device(dev)

    ivf_key = (
        (tuple(cents.shape), tuple(cells.shape), nprobe)
        if cells is not None and cents is not None else None
    )
    return POOL.warm(
        ("ftvec_knn", tuple(bank.shape), str(bank.dtype).replace("torch.", ""),
         metric, k, dtype, ivf_key, _dev_key(device)),
        thunk,
    )


def _warm_vector_manifest(engine, rec, buckets: Iterable[int],
                          device=None) -> int:
    """Warm the sharded KNN MERGE (K19) for a bank constellation: its
    program comes from MeshManager's geometry-keyed cross-epoch pool
    (``knn_merge_kernel``), so a 4 -> 8 -> 4 reshard re-enters prewarm with
    the program already built."""
    from redisson_tpu_torch.parallel.manager import MeshManager

    names = rec.meta.get("shard_names") or ()
    n_legs = len(names)
    if n_legs < 2:
        return 0
    mm = MeshManager.of(engine)
    geom = mm.geometry()
    merge = mm.knn_merge_kernel(n_legs, geom=geom)
    k = 10
    dev = _target(engine, device)

    def thunk():
        dists = tuple(torch.zeros((1, k), dtype=torch.float32, device=dev)
                      for _ in range(n_legs))
        idxs = tuple(torch.zeros((1, k), dtype=torch.int32, device=dev)
                     for _ in range(n_legs))
        sop = torch.zeros((n_legs * k,), dtype=torch.int32, device=dev)
        merge(dists, idxs, sop, k)
        ioplane.wait_device(dev)

    return POOL.warm(
        ("ftvec_merge", n_legs, k, mm._mesh_key(geom.mesh), _dev_key(device)),
        thunk,
    )


_KIND_WARMERS = {
    "bloom": _warm_bloom,
    "bloom_array": _warm_bloom_array,
    "hll": _warm_hll,
    "hll_array": _warm_hll,
    "vector_bank": _warm_vector_bank,
    "vector_bank_manifest": _warm_vector_manifest,
}


def prewarm_store(engine, names: Optional[Iterable[str]] = None,
                  buckets: Iterable[int] = (0,),
                  devices: Optional[Iterable] = None) -> int:
    """Warm the hot kernels of every (named) live record at the given batch
    buckets (0 = the smallest bucket).  Returns the count of keys this call
    warmed; everything already warm is free.  Run at boot or before a timed
    serving phase, never on the hot path.

    ``devices``: the placement axis — warm each geometry ON EACH of these
    positions (Engine.prewarm passes every position with placement on).
    None warms each record where it lives (its owner with placement on,
    the engine's device otherwise)."""
    buckets = [K.bucket_size(max(1, b)) for b in buckets]
    warmed = 0
    for name in list(names) if names is not None else engine.store.keys():
        rec = engine.store.get(name)
        if rec is None:
            continue
        warmer = _KIND_WARMERS.get(rec.kind)
        if warmer is None:
            continue
        if devices is not None:
            devs = list(devices)
        else:
            devs = [engine.device_for_name(name)]  # None with placement off
        with engine.locked(name):
            rec = engine.store.get(name)
            if rec is None:
                continue
            for dev in devs:
                warmed += warmer(engine, rec, buckets, device=dev)
    return warmed
