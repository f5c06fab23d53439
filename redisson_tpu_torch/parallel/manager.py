"""MeshManager: the engine service that owns the device mesh and the sharded
program cache.

A copy of ``redisson_tpu/parallel/manager.py``.  Object handles
(``client/objects/sharded.py``), the server's OBJCALL surface and
``graft_entry.dryrun_multichip`` all route through it.

Responsibilities:
  * build the (dp, shard) Mesh once per engine from ``Config.mesh`` (dp,
    shard, and ``n_devices``: the count of local positions, laid round
    robin over the cards; on one card every position is that card) and
    rebuild it on ``reshard``;
  * cache the sharded programs per geometry (the epoch cache, and the
    cross-epoch warm pool keyed by the mesh's positions: a 4 -> 8 -> 4
    round trip reuses the programs it built before).  The programs are
    Python closures over hand kernels that were built once for the
    process, so a "build" costs microseconds here where the reference
    compiled; the cache keeps the reference's contract (no stale-geometry
    program is ever served after a reshard) and its counters;
  * pad op batches to a dp-divisible bucket (``pad_batch``);
  * lay a record's plane onto the dispatch geometry (``adapt_plane``,
    ``ensure_state``): a plane from another mesh or from a restore is
    gathered and re-placed on the device, never through the host.

``merge_across_devices`` (K13) takes the elementwise max of same-shape
tensors on different devices with no host round trip: tensors that share a
device fold there, then the partials are copied to the destination
(``ioplane.colocate``: peer copies between cards) and folded with
``torch.maximum``.

``initialize_multihost`` joins this process into a ``torch.distributed``
process group (NCCL on the card, gloo on the CPU).  No path of the port
uses the group yet, and no run has tested it: a mesh here spans the local
positions of one process.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.parallel import mesh as M
from redisson_tpu_torch.parallel.sharded import (
    OpBatch,
    ShardedPlane,
    make_sharded_bitset_kernels,
    make_sharded_bloom_kernels,
    make_sharded_hll_kernels,
)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join this process into a multi-process torch.distributed group (the
    counterpart of ``jax.distributed.initialize``).  The caller gives the
    coordinator's address (``host:port``), the process count and this
    process's rank: nothing on a machine tells a program of its cluster.
    Unverified: no path of the port runs collectives across processes."""
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs the coordinator address, "
                         "the process count and this process's id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
    )


def merge_across_devices(arrays, dest_device=None) -> torch.Tensor:
    """Elementwise max of same-shape tensors that may live on different
    devices, without a host round trip: a local fold per device, then peer
    copies to ``dest_device`` (default: the first input's device) and a
    fold there.  A single input is returned as is (colocated)."""
    if not arrays:
        raise ValueError("nothing to merge")
    arrays = [a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
              for a in arrays]
    if dest_device is None:
        dest_device = arrays[0].device
    by_dev: "OrderedDict[torch.device, torch.Tensor]" = OrderedDict()
    for a in arrays:
        cur = by_dev.get(a.device)
        by_dev[a.device] = a if cur is None else torch.maximum(cur, a)
    out = None
    for part in by_dev.values():
        part = ioplane.colocate(part, dest_device)
        out = part if out is None else torch.maximum(out, part)
    return out


class Geometry(NamedTuple):
    """One consistent view of the mesh for the duration of ONE dispatch:
    every step of a sharded dispatch (width, batch padding, program fetch,
    plane adaptation) sees the same mesh; the epoch keys the program cache
    so a stale build is never served after a reshard."""

    mesh: M.Mesh
    epoch: int

    @property
    def dp(self) -> int:
        return self.mesh.shape[M.DP_AXIS]

    @property
    def n_shard(self) -> int:
        return self.mesh.shape[M.SHARD_AXIS]


class MeshManager:
    SERVICE_KEY = "mesh_manager"

    # bound on the cross-epoch warm pool: geometries cycle among a handful
    # of shapes in practice (4<->8 reshards)
    WARM_POOL_MAX = 32

    def __init__(self, config=None, mesh: Optional[M.Mesh] = None, device=None):
        self._config = config
        self._mesh = mesh
        self._device = device
        self._guard = threading.Lock()
        self._kernels: Dict[Tuple, Tuple] = {}
        self._epoch = 0
        self.kernel_builds = 0  # program-set builds (epoch cache and pool miss)
        self._warm: "OrderedDict[Tuple, Tuple]" = OrderedDict()

    @staticmethod
    def _mesh_key(mesh: M.Mesh) -> Tuple:
        return (
            tuple(mesh.shape.items()),
            tuple((p.id, str(p.device)) for p in mesh.devices.flat),
        )

    @classmethod
    def of(cls, engine) -> "MeshManager":
        """The engine-scoped singleton, its positions on the engine's device
        kind."""
        return engine.service(cls.SERVICE_KEY,
                              lambda: cls(engine.config, device=engine.device))

    # -- mesh / shardings ----------------------------------------------------

    def _positions(self):
        mc = getattr(self._config, "mesh", None)
        return M.local_devices(self._device, count=getattr(mc, "n_devices", None))

    @property
    def mesh(self) -> M.Mesh:
        with self._guard:
            if self._mesh is None:
                mc = getattr(self._config, "mesh", None)
                dp = getattr(mc, "dp", 1) or 1
                shard = getattr(mc, "shard", None)
                n = dp * shard if shard else None
                self._mesh = M.make_mesh(n_devices=n, dp=dp, devices=self._positions())
            return self._mesh

    def reshard(self, dp: int, shard: int) -> M.Mesh:
        """Live mesh-geometry change.  Swaps the mesh and drops the epoch
        cache; the dual-routing window is per record: a dispatch in flight
        holds its record lock and finishes on the old geometry, every later
        dispatch adapts that record's plane under the same lock
        (adapt_plane), so no probe is lost or applied twice."""
        new = M.make_mesh(n_devices=dp * shard, dp=dp, devices=self._positions())
        with self._guard:
            self._mesh = new
            self._epoch += 1
            self._kernels.clear()
        return new

    def geometry(self) -> Geometry:
        """Snapshot (mesh, epoch) for one dispatch; grab ONCE per call."""
        self.mesh  # noqa: B018 — force the lazy build (under the guard)
        with self._guard:
            return Geometry(self._mesh, self._epoch)

    @property
    def n_shard(self) -> int:
        return self.mesh.shape[M.SHARD_AXIS]

    @property
    def dp(self) -> int:
        return self.mesh.shape[M.DP_AXIS]

    # -- program cache -------------------------------------------------------

    def _cached(self, geom: Optional[Geometry], key: Tuple, build):
        """Fetch/build a program set for `geom`.  A getter racing reshard()
        may still build against the old mesh, but never inserts that build
        where the new epoch would find it.  Second level: the cross-epoch
        warm pool, keyed by the mesh's positions."""
        if geom is None:
            geom = self.geometry()
        ekey = (geom.epoch, *key)
        with self._guard:
            fns = self._kernels.get(ekey)
            if fns is not None:
                return fns
            wkey = (self._mesh_key(geom.mesh), *key)
            fns = self._warm.get(wkey)
            if fns is not None:
                self._warm.move_to_end(wkey)
        if fns is None:
            fns = build(geom.mesh)
            with self._guard:
                self.kernel_builds += 1
        with self._guard:
            if self._epoch == geom.epoch:
                self._kernels[ekey] = fns
            self._warm[wkey] = fns
            self._warm.move_to_end(wkey)
            while len(self._warm) > self.WARM_POOL_MAX:
                self._warm.popitem(last=False)
        return fns

    def bloom_kernels(self, k: int, m: int, tenants: int, width: int = 0,
                      geom: Optional[Geometry] = None):
        """(add, contains) for a (tenants, width) plane sharded over the
        mesh; m is the hash domain (width pads it to a shard multiple)."""
        return self._cached(
            geom, ("bloom", k, m, tenants, width),
            lambda mesh: make_sharded_bloom_kernels(
                mesh, k=k, m=m, n_tenants=tenants, width=width
            ),
        )

    def bitset_kernels(self, m: int, width: int = 0,
                       geom: Optional[Geometry] = None):
        """((set, clear), get, cardinality) for one plane column-sharded."""
        return self._cached(
            geom, ("bitset", m, width),
            lambda mesh: make_sharded_bitset_kernels(mesh, m=m, width=width),
        )

    def hll_kernels(self, p: int, rows: int, geom: Optional[Geometry] = None):
        """(add, estimate) for a (rows, 2**p) HLL bank, tenant-sharded."""
        return self._cached(
            geom, ("hll", p, rows),
            lambda mesh: make_sharded_hll_kernels(mesh, p=p, n_rows=rows),
        )

    def knn_merge_kernel(self, n_legs: int, geom: Optional[Geometry] = None):
        """The sharded banks' top-k of top-ks (K19, ``K.knn_sharded_merge``)
        for an ``n_legs`` constellation (reference ``parallel/manager.py:311-330``),
        geometry-keyed like every sharded program: a 4 -> 8 -> 4 reshard
        lands back on the program object built before, with no new build."""
        def build(_mesh):
            # a fresh wrapper a geometry, so the pool returns this object
            def merge(dists, idxs, shard_of_pos, k):
                return K.knn_sharded_merge(dists, idxs, shard_of_pos, k)

            return merge

        return self._cached(geom, ("knn_merge", n_legs), build)

    # -- placement helpers ---------------------------------------------------

    def round_up(self, value: int, multiple: int) -> int:
        return (value + multiple - 1) // multiple * multiple

    def pad_batch(self, tenant: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                  geom: Optional[Geometry] = None) -> Tuple[OpBatch, int]:
        """Pad op arrays to a dp-divisible bucket and split them over the
        dp axis.  Returns (batch, n_valid)."""
        if geom is None:
            geom = self.geometry()
        n = lo.shape[0]
        b = self.round_up(K.bucket_size(max(1, n)), geom.dp)
        arrays = {"tenant": K.pad_to(np.ascontiguousarray(tenant, np.int32), b),
                  "lo": K.pad_to(lo, b), "hi": K.pad_to(hi, b)}
        return OpBatch(arrays, n, geom.dp), n

    def pad_indexes(self, idx: np.ndarray, geom: Optional[Geometry] = None) -> Tuple[OpBatch, int]:
        """An int32 index batch padded like pad_batch."""
        if geom is None:
            geom = self.geometry()
        n = idx.shape[0]
        b = self.round_up(K.bucket_size(max(1, n)), geom.dp)
        return OpBatch({"idx": K.pad_to(idx.astype(np.int32), b)}, n, geom.dp), n

    def adapt_plane(self, rec, key: str, axis: int, length: int,
                    geom: Optional[Geometry] = None) -> ShardedPlane:
        """ensure_state plus geometry adaptation: pad or trim `axis` of the
        plane to `length` (the dispatch geometry's divisibility), on the
        device, then lay it on the mesh.  Pad cells are zeros and are never
        addressed, so trimming back only removes zeros.  The caller holds
        the record lock: this IS the per-record step of a live reshard."""
        arr = rec.arrays[key]
        cur = arr.shape[axis]
        if cur != length:
            whole = arr.gather() if isinstance(arr, ShardedPlane) else arr
            if length > cur:
                pad = list(whole.shape)
                pad[axis] = length - cur
                whole = torch.cat([whole, whole.new_zeros(pad)], dim=axis)
            else:
                whole = whole.narrow(axis, 0, length)
            rec.arrays[key] = whole
        return self.ensure_state(rec, key, axis, geom=geom)

    def ensure_state(self, rec, key: str, axis: int,
                     geom: Optional[Geometry] = None) -> ShardedPlane:
        """Lay the record's plane on the dispatch mesh: a plane restored as
        one tensor, or laid on another mesh, is gathered and re-placed (the
        reference's device_put to the new sharding)."""
        arr = rec.arrays[key]
        mesh = geom.mesh if geom is not None else self.mesh
        if isinstance(arr, ShardedPlane):
            if arr.axis == axis and self._mesh_key(arr.mesh) == self._mesh_key(mesh):
                return arr
            arr = arr.gather()
        rec.arrays[key] = ShardedPlane.place(arr, mesh, axis)
        return rec.arrays[key]
