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

The sharded kinds (``sharded_bloom_array``, ``sharded_hll_array``,
``sharded_bitset``) carry their plane gathered from the reference's mesh as
one numpy array; ``from_reference`` lays it out on the port's mesh (`mesh`,
a ``parallel.mesh.Mesh`` of the same geometry: columns, rows or bits over
its shard positions) and ``to_reference`` gathers it back.
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
         "semaphore", "permit_semaphore", "count_down_latch", "rate_limiter",
         # streams, geo sets, time series, binary streams, JSON documents and
         # executor task registries: host-only as well
         "stream", "geo", "timeseries", "binary_stream", "json_bucket", "executor_tasks",
         # planes sharded over a mesh (parallel/sharded.py)
         "sharded_bloom_array", "sharded_hll_array", "sharded_bitset")

# the sharded kinds: the axis of the plane their mesh splits
SHARDED_AXIS = {"sharded_bloom_array": 1, "sharded_hll_array": 0, "sharded_bitset": 0}


def from_reference(kind: str, meta: Dict[str, Any], arrays_np: Dict[str, np.ndarray],
                   device, host: Any = None, mesh=None) -> StateRecord:
    """`mesh` lays a sharded kind's gathered plane out over its positions
    (required for those kinds)."""
    if kind not in KINDS:
        raise ValueError(f"no port of state kind {kind!r}")
    if kind in SHARDED_AXIS and mesh is None:
        raise ValueError(f"{kind}: a sharded plane needs the mesh to lay it out on")
    arrays = {}
    for name, arr in arrays_np.items():
        arr = np.asarray(arr)
        if arr.dtype != np.uint8:
            raise ValueError(f"{kind}.{name}: sketch state is uint8, got {arr.dtype}")
        arrays[name] = torch.from_numpy(arr.copy()).to(device)
        if kind in SHARDED_AXIS:
            from redisson_tpu_torch.parallel.sharded import ShardedPlane

            arrays[name] = ShardedPlane.place(arrays[name], mesh, SHARDED_AXIS[kind])
    return StateRecord(kind=kind, meta=dict(meta), arrays=arrays, host=copy.deepcopy(host))


def to_reference(rec: StateRecord) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray], Any]:
    """A sharded plane comes back gathered (the reference's np.asarray of
    its mesh-sharded array)."""
    from redisson_tpu_torch.parallel.sharded import ShardedPlane

    return (rec.kind, dict(rec.meta),
            {n: t.numpy() if isinstance(t, ShardedPlane) else t.cpu().numpy()
             for n, t in rec.arrays.items()},
            copy.deepcopy(rec.host))
