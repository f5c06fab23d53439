"""Sharded sketch programs (K12): one logical object spread over a mesh.

A copy of ``redisson_tpu/parallel/sharded.py``.  The reference runs each
program as a ``shard_map`` over the mesh axes (dp, shard) with ``psum``,
``pmax`` and ``pmin`` collectives; here each position's part is a tensor of
its own and each program is a loop over positions that launches the hand
kernels with a **shard window**, then combines the positions' partial
results with torch ops:

  * state: ``ShardedPlane`` holds part (d, s), shard s's slice of the
    sharded axis, on position (d, s); the dp replicas hold equal copies.
  * op batches: ``OpBatch`` splits a padded batch over dp (slice d is ops
    [d*b, (d+1)*b)); each slice's live ops are its part of ``n_valid``
    (the reference's ``base = dp_idx * B_local`` rule), so padded ops
    neither write nor count.
  * bloom contains: each shard's ``bloom_probe(col_lo=...)`` says "every
    probe this shard owns is set"; the AND over shards is the reference's
    ``psum`` then ``== k`` (exactly one shard owns each probe).
  * bloom add: ``bloom_probe(newly=True, col_lo=...)`` reads "some owned
    probe was unset before the batch", then ``bloom_set(col_lo=...)``
    writes the owned probes; the OR over shards is ``any(psum == 0)``.
    It is the windowed probe then the windowed set, never the fused
    ``bloom_add``: the reference reads every probe of the batch from the
    plane as it stood before the batch, so two keys of one batch that share
    probes both report newly added.
  * hll: the bank's rows (tenants) are sharded; ``hll_add(row_lo=...)``
    drops the ops of another shard's tenants; the estimate is ``hll_rows``
    on each shard's rows, concatenated.
  * bitset: ``bitset_get(lo=...)`` and ``bitset_set(lo=...)`` read 0 for
    another shard's index; old bits and gets combine with OR; the
    cardinality is a popcount a shard, summed (torch ops).
  * dp: after a write every dp replica of a shard takes the elementwise max
    (sets) or min (bit clears) of the replicas, the reference's ``pmax`` /
    ``pmin`` over ``dp``, as torch ops.

Pad columns [m, width) and pad rows past the tenants are never addressed:
probes hash over the global domain m and the window uses the stored width,
so a filter can re-lay onto a mesh whose shard count does not divide m.
Results are (B,) tensors on the mesh's first position's device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.parallel.mesh import DP_AXIS, SHARD_AXIS, Mesh


class ShardedPlane:
    """A plane laid out on a mesh: ``parts[d, s]`` is shard s's slice of
    axis `axis` on position (d, s); every dp replica holds an equal copy."""

    def __init__(self, mesh: Mesh, axis: int, parts: np.ndarray):
        self.mesh = mesh
        self.axis = axis
        self.parts = parts

    @classmethod
    def place(cls, value, mesh: Mesh, axis: int) -> "ShardedPlane":
        """Split `value` (a tensor or numpy array) along `axis` over the
        mesh's shard positions, one copy a dp replica."""
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(value))
        dp, n_shard = mesh.devices.shape
        if t.shape[axis] % n_shard:
            raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split over {n_shard} shards")
        w = t.shape[axis] // n_shard
        parts = np.empty((dp, n_shard), dtype=object)
        for s in range(n_shard):
            piece = t.narrow(axis, s * w, w)
            for d in range(dp):
                dev = mesh.devices[d, s].device
                parts[d, s] = ioplane.colocate(piece, dev).clone(memory_format=torch.contiguous_format)
        return cls(mesh, axis, parts)

    @classmethod
    def zeros(cls, shape, mesh: Mesh, axis: int, dtype=torch.uint8) -> "ShardedPlane":
        """A zeroed plane of `shape`, each part made on its own position."""
        dp, n_shard = mesh.devices.shape
        if shape[axis] % n_shard:
            raise ValueError(f"axis {axis} of {tuple(shape)} does not split over {n_shard} shards")
        local = list(shape)
        local[axis] //= n_shard
        parts = np.empty((dp, n_shard), dtype=object)
        for d in range(dp):
            for s in range(n_shard):
                parts[d, s] = torch.zeros(local, dtype=dtype, device=mesh.devices[d, s].device)
        return cls(mesh, axis, parts)

    def each(self):
        """Every part, dp replicas included, with its (d, s)."""
        dp, n_shard = self.parts.shape
        for d in range(dp):
            for s in range(n_shard):
                yield d, s, self.parts[d, s]

    @property
    def shape(self) -> tuple:
        shape = list(self.parts[0, 0].shape)
        shape[self.axis] *= self.parts.shape[1]
        return tuple(shape)

    @property
    def device(self) -> torch.device:
        return self.parts[0, 0].device

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parts.flat)

    def gather(self, device=None) -> torch.Tensor:
        """The whole plane (dp replica 0's shards joined) on `device`
        (default: the first position's)."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([ioplane.colocate(p, dev) for p in self.parts[0]], dim=self.axis)

    def numpy(self) -> np.ndarray:
        return self.gather(torch.device("cpu")).numpy()


class OpBatch:
    """A padded op batch split over dp: slice d is ops [d*b, (d+1)*b).
    Operands are copied once to each torch device of the mesh that asks."""

    def __init__(self, arrays: Dict[str, np.ndarray], n_valid: int, dp: int):
        self.host = arrays
        self.n = len(next(iter(arrays.values())))
        if self.n % dp:
            raise ValueError(f"a batch of {self.n} does not split over dp={dp}")
        self.dp = dp
        self.b = self.n // dp
        self.n_valid = int(n_valid)
        self._on: Dict[str, Dict[str, torch.Tensor]] = {}

    def on(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        key = str(device)
        got = self._on.get(key)
        if got is None:
            got = self._on[key] = {k: K.stage(v, device) for k, v in self.host.items()}
        return got

    def slice(self, d: int, device) -> Dict[str, torch.Tensor]:
        return {k: v[d * self.b:(d + 1) * self.b] for k, v in self.on(device).items()}

    def valid(self, d: int) -> int:
        """Live ops of slice d: the ops < n_valid it holds."""
        return max(0, min(self.n_valid - d * self.b, self.b))

    def keys(self, d: int, device) -> K.Keys:
        t = self.slice(d, device)
        return K.Keys(n=self.b, tenant=t.get("tenant"), lo=t["lo"], hi=t["hi"])


def _combine(parts, op, device):
    """Fold a shard's partial results (on any devices) with `op` on `device`."""
    out = None
    for p in parts:
        p = ioplane.colocate(p, device)
        out = p if out is None else op(out, p)
    return out


def _converge(plane: ShardedPlane, op) -> None:
    """Every dp replica of each shard takes `op` (max or min) over the
    replicas, in place: the reference's pmax / pmin over dp."""
    dp, n_shard = plane.parts.shape
    if dp == 1:
        return
    for s in range(n_shard):
        head = plane.parts[0, s]
        for d in range(1, dp):
            op(head, ioplane.colocate(plane.parts[d, s], head.device), out=head)
        for d in range(1, dp):
            plane.parts[d, s].copy_(head)


def _out_device(mesh: Mesh) -> torch.device:
    return mesh.devices[0, 0].device


def make_sharded_bloom_kernels(mesh: Mesh, k: int, m: int, n_tenants: int, width: int = 0):
    """(add, contains) over the mesh for a (n_tenants, width) plane whose
    HASH DOMAIN is m (probes index [0, m)).  width >= m is the stored
    plane's column count and must divide evenly by the shard-axis size."""
    n_shard = mesh.shape[SHARD_AXIS]
    width = width or m
    if width % n_shard != 0:
        raise ValueError(f"width={width} must be divisible by shard axis {n_shard}")
    if width < m:
        raise ValueError(f"width={width} cannot be below the hash domain m={m}")
    m_local = width // n_shard
    dp = mesh.shape[DP_AXIS]
    out_dev = _out_device(mesh)

    def contains(bits: ShardedPlane, batch: OpBatch, n_valid: Optional[int] = None):
        found = []
        for d in range(dp):
            shard_found = []
            for s in range(n_shard):
                part = bits.parts[d, s]
                shard_found.append(K.bloom_probe(part, m_local, batch.keys(d, part.device),
                                                 batch.valid(d), k, m, col_lo=s * m_local))
            found.append(_combine(shard_found, torch.logical_and, out_dev))
        return torch.cat(found)

    def add(bits: ShardedPlane, batch: OpBatch, n_valid: Optional[int] = None):
        newly = []
        for d in range(dp):
            shard_newly = []
            for s in range(n_shard):
                part = bits.parts[d, s]
                kb = batch.keys(d, part.device)
                # every owned probe read before any is written: the
                # reference's pre-batch psum
                shard_newly.append(K.bloom_probe(part, m_local, kb, batch.valid(d), k, m,
                                                 newly=True, col_lo=s * m_local))
                K.bloom_set(part, m_local, kb, batch.valid(d), k, m, col_lo=s * m_local)
            newly.append(_combine(shard_newly, torch.logical_or, out_dev))
        _converge(bits, torch.maximum)
        return bits, torch.cat(newly)

    return add, contains


def make_sharded_hll_kernels(mesh: Mesh, p: int, n_rows: int):
    """(add, estimate) for a (n_rows, 2**p) HLL bank with the TENANT axis
    sharded: each shard owns a tenant range, adds drop other shards'
    tenants, estimates are each shard's rows gathered.  n_rows is the
    stored row count (logical tenants padded up to a shard multiple)."""
    n_shard = mesh.shape[SHARD_AXIS]
    if n_rows % n_shard != 0:
        raise ValueError(f"rows={n_rows} must divide by shard axis {n_shard}")
    t_local = n_rows // n_shard
    m = 1 << p
    dp = mesh.shape[DP_AXIS]
    out_dev = _out_device(mesh)

    def add(regs: ShardedPlane, batch: OpBatch, n_valid: Optional[int] = None):
        for d in range(dp):
            for s in range(n_shard):
                part = regs.parts[d, s]
                K.hll_add(part, m, batch.keys(d, part.device), batch.valid(d), p,
                          row_lo=s * t_local)
        _converge(regs, torch.maximum)
        return regs

    def estimate(regs: ShardedPlane):
        return torch.cat([ioplane.colocate(K.hll_estimate(part), out_dev)
                          for part in regs.parts[0]])

    return add, estimate


def make_sharded_bitset_kernels(mesh: Mesh, m: int, width: int = 0):
    """((set, clear), get, cardinality) for one (width,) bit plane
    column-sharded over the `shard` axis.  width >= m pads the stored plane
    to a shard multiple (pad bits stay zero; cardinality is exact)."""
    n_shard = mesh.shape[SHARD_AXIS]
    width = width or m
    if width % n_shard != 0:
        raise ValueError(f"width={width} must be divisible by shard axis {n_shard}")
    if width < m:
        raise ValueError(f"width={width} cannot be below logical size m={m}")
    m_local = width // n_shard
    dp = mesh.shape[DP_AXIS]
    out_dev = _out_device(mesh)

    def get(bits: ShardedPlane, batch: OpBatch, n_valid: Optional[int] = None):
        got = []
        for d in range(dp):
            shard_got = []
            for s in range(n_shard):
                part = bits.parts[d, s]
                shard_got.append(K.bitset_get(part, batch.slice(d, part.device)["idx"],
                                              lo=s * m_local))
            live = torch.arange(batch.b, device=out_dev) < batch.valid(d)
            got.append((_combine(shard_got, torch.maximum, out_dev) != 0) & live)
        return torch.cat(got)

    def make_set(setting: bool):
        # set and clear are separate programs, as in the reference: each
        # converges its dp replicas with one op (max for sets, min for
        # clears)
        def set_bits(bits: ShardedPlane, batch: OpBatch, n_valid: Optional[int] = None):
            old = []
            for d in range(dp):
                shard_old = []
                for s in range(n_shard):
                    part = bits.parts[d, s]
                    shard_old.append(K.bitset_set(part, batch.slice(d, part.device)["idx"],
                                                  batch.valid(d), int(setting), lo=s * m_local)[1])
                old.append(_combine(shard_old, torch.maximum, out_dev) != 0)
            _converge(bits, torch.maximum if setting else torch.minimum)
            return bits, torch.cat(old)

        return set_bits

    def card(bits: ShardedPlane) -> int:
        return int(sum(int(part.sum(dtype=torch.int64)) for part in bits.parts[0]))

    return (make_set(True), make_set(False)), get, card
