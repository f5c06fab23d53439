"""Device mesh & sharding policy: the topology layer.

A copy of ``redisson_tpu/parallel/mesh.py`` for torch devices.  The
reference maps the 16384 CRC16 slots onto N master shards
(``cluster/ClusterConnectionManager.java:84-180``); here the "cluster" is a
grid of mesh **positions** and the slot table maps keyspace slots onto them.

Axes:
  dp    — data-parallel over op batches (independent request streams),
  shard — state-parallel over device-resident planes: one logical object's
          bit/register tensor is split over the shard positions.

A position is one place a shard's tensors live: an index and a torch
device.  ``local_devices`` is the counterpart of ``jax.local_devices()``:
on CUDA one position per GPU, on the CPU as many positions as the port is
told (``set_cpu_positions`` or ``RTPU_CPU_POSITIONS``; the counterpart of
the reference's ``--xla_force_host_platform_device_count``, which its test
suite sets to 8).  Asked for ``count`` positions, it lays them round robin
over the GPUs, so **a mesh may name one torch device more than once**:
each position is a shard that holds its own tensors, and the collectives
between positions on one device are copies and elementwise ops on that
device.  That is how the CPU tests get 8 positions on torch's one CPU
device and how ``chip_smoke.py`` runs 8 shards on one H100.  JAX cannot do
this outside forced host devices: its Mesh takes each device once.
Positions on one card measure no cross-GPU collective; a mesh over several
GPUs copies between cards with peer copies (``core/ioplane.colocate``) and
is unverified on more than one GPU.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from redisson_tpu_torch.utils.crc16 import MAX_SLOT

DP_AXIS = "dp"
SHARD_AXIS = "shard"

_cpu_positions = max(1, int(os.environ.get("RTPU_CPU_POSITIONS", "1") or 1))


class Position(NamedTuple):
    """One mesh position: its index among the local positions and the
    torch device its tensors live on."""

    id: int
    device: torch.device

    @property
    def platform(self) -> str:
        return self.device.type

    def __str__(self) -> str:
        return f"{self.device}/position {self.id}"


def cpu_positions() -> int:
    return _cpu_positions


def set_cpu_positions(n: int) -> int:
    """Set how many positions ``local_devices`` gives on the CPU; returns
    the previous count."""
    global _cpu_positions
    if n < 1:
        raise ValueError("need at least one CPU position")
    prev, _cpu_positions = _cpu_positions, int(n)
    return prev


def _kind(device) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def local_devices(device=None, count: Optional[int] = None) -> List[Position]:
    """The local mesh positions on `device`'s kind (the card when there is
    one, else the CPU).  ``count`` None: one a GPU, or ``cpu_positions()``
    on the CPU; else ``count`` positions laid round robin over the GPUs (or
    all on the CPU)."""
    kind = _kind(device)
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card for a mesh on cuda")
        gpus = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        n = len(gpus) if count is None else int(count)
        return [Position(i, gpus[i % len(gpus)]) for i in range(n)]
    if kind != "cpu":
        raise ValueError(f"no mesh positions on {kind}")
    n = _cpu_positions if count is None else int(count)
    return [Position(i, torch.device("cpu")) for i in range(n)]


class Mesh:
    """A (dp, shard) grid of positions: the layout descriptor the sharded
    programs take (the counterpart of ``jax.sharding.Mesh``)."""

    def __init__(self, grid: np.ndarray, axis_names=(DP_AXIS, SHARD_AXIS)):
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))

    def position(self, d: int, s: int) -> Position:
        return self.devices[d, s]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(p) for p in self.devices.flat]})"


def make_mesh(
    n_devices: Optional[int] = None,
    dp: int = 1,
    devices: Optional[Sequence] = None,
    device=None,
) -> Mesh:
    """Build a (dp, shard) mesh over the local positions (of `device`'s
    kind when `devices` is not given).  dp * shard == n_devices; shard gets
    everything dp doesn't take."""
    devs = list(devices) if devices is not None else local_devices(device)
    n = n_devices if n_devices is not None else len(devs)
    if n > len(devs):
        raise ValueError(f"{n} positions asked, {len(devs)} available")
    devs = devs[:n]
    if dp < 1 or n % dp != 0:
        raise ValueError(f"dp={dp} must divide device count {n}")
    grid = np.empty((dp, n // dp), dtype=object)
    for i, p in enumerate(devs):
        grid[i // (n // dp), i % (n // dp)] = p
    return Mesh(grid)


def device_ring(n_devices: int, base: int, n: int) -> list:
    """Ring walk over a device axis: n member positions starting at `base`.
    Distinct while n <= n_devices; wraps evenly past it."""
    if n_devices <= 0:
        raise ValueError("need at least one device")
    return [(base + i) % n_devices for i in range(max(0, n))]


class Layout(NamedTuple):
    """A sharding as a layout descriptor (the counterpart of a
    ``NamedSharding``): which axis of the state the `shard` axis splits
    (None: replicated), over `mesh`."""

    mesh: Mesh
    axis: Optional[int]


def state_sharding(mesh: Mesh) -> Layout:
    """(T, m) state planes: the column axis split over `shard`, replicated
    over `dp`."""
    return Layout(mesh, 1)


def batch_sharding(mesh: Mesh) -> Layout:
    """Op batches: split over `dp` (axis 0), replicated over `shard`."""
    return Layout(mesh, 0)


def replicated(mesh: Mesh) -> Layout:
    return Layout(mesh, None)


class SlotTable:
    """slot -> shard routing (the reference's slot2entry[16384] analog):
    contiguous ranges, like a freshly-created Redis cluster."""

    def __init__(self, n_shards: int):
        if n_shards <= 0:
            raise ValueError("need at least one shard")
        self.n_shards = n_shards
        self._table = np.floor_divide(
            np.arange(MAX_SLOT) * n_shards, MAX_SLOT
        ).astype(np.int32)

    def shard_of_slot(self, slot: int) -> int:
        return int(self._table[slot])

    def shard_of_key(self, key) -> int:
        from redisson_tpu_torch.utils.crc16 import calc_slot

        return self.shard_of_slot(calc_slot(key))

    def move_slot(self, slot: int, to_shard: int) -> None:
        """Slot migration (MOVED/resharding analog)."""
        if not 0 <= to_shard < self.n_shards:
            raise ValueError(f"shard {to_shard} out of range")
        self._table[slot] = to_shard

    def slots_of_shard(self, shard: int) -> np.ndarray:
        return np.nonzero(self._table == shard)[0]
