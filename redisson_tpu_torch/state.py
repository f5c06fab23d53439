"""State carried across between the JAX package and the port.

A record of either package is a kind, a meta dict, named arrays and a host
value.  The arrays (bloom planes, HLL register banks, bit-set planes) are
persisted formats that both packages share bit for bit; the bucket family
(buckets, atomic counters, id generators), the maps and the collections,
queues, multimaps, topics and synchronizers keep their state in ``host``:
dicts, lists and sets of encoded bytes and numbers, the same in both
packages.
``from_reference`` turns a ``redisson_tpu`` StateRecord's meta, arrays (as
numpy) and host value into a record of this package on a device;
``to_reference`` goes back.  Tests use them to start both packages from the
same state and to compare final states.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import numpy as np
import torch

from redisson_tpu_torch.core.store import StateRecord

KINDS = ("bloom", "bloom_array", "hll", "hll_array", "bitset",
         "bucket", "atomic_long", "atomic_double", "id_generator", "map", "map_cache",
         # host-only records: collections, queues, multimaps, topics and
         # synchronizers keep encoded bytes and numbers in ``host``
         "list", "set", "set_cache", "sorted_set", "lex_sorted_set", "zset",
         "queue", "deque", "blocking_queue", "blocking_deque", "bounded_blocking_queue",
         "priority_queue", "ring_buffer", "delayed_queue", "transfer_queue",
         "list_multimap", "set_multimap", "list_multimap_cache", "set_multimap_cache",
         "reliable_topic", "lock", "fenced_lock", "spin_lock", "fair_lock", "rw_lock",
         "semaphore", "permit_semaphore", "count_down_latch", "rate_limiter")


def from_reference(kind: str, meta: Dict[str, Any], arrays_np: Dict[str, np.ndarray],
                   device, host: Any = None) -> StateRecord:
    if kind not in KINDS:
        raise ValueError(f"no port of state kind {kind!r}")
    arrays = {}
    for name, arr in arrays_np.items():
        arr = np.asarray(arr)
        if arr.dtype != np.uint8:
            raise ValueError(f"{kind}.{name}: sketch state is uint8, got {arr.dtype}")
        arrays[name] = torch.from_numpy(arr.copy()).to(device)
    return StateRecord(kind=kind, meta=dict(meta), arrays=arrays, host=copy.deepcopy(host))


def to_reference(rec: StateRecord) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray], Any]:
    return (rec.kind, dict(rec.meta), {n: t.cpu().numpy() for n, t in rec.arrays.items()},
            copy.deepcopy(rec.host))
