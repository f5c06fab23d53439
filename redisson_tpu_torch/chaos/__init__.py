"""Chaos subsystem: deterministic fault injection, leak accounting and the
endurance harnesses.

  * :mod:`redisson_tpu_torch.chaos.faults`: a seeded, deterministic
    :class:`FaultSchedule` compiled to a :class:`FaultPlane` that injects
    transport faults (drop, delay, truncate mid-reply, refuse connect,
    one-way partition) at the ``net/client.py`` event sites, storage faults
    at ``core/checkpoint.py``'s write and fsync, and device faults at the
    lanes (``core/ioplane.py``), the registry's dispatch and the vector
    banks' growth, feeding the real failure paths instead of bypassing
    them.
  * :mod:`redisson_tpu_torch.chaos.census`: :class:`ResourceCensus`, one
    authority for "did we leak?": live gauges plus snapshot/diff over
    record locks, staged replication buffers, epoch-keyed kernel-cache
    entries, connection pools and replication baselines.
  * :mod:`redisson_tpu_torch.chaos.soak`: the twelve endurance harnesses
    (a copy of ``redisson_tpu/chaos/soak.py``): :class:`SoakHarness`, a
    mixed workload across master-kill, failover and reshard cycles with an
    error budget, asserting zero acked-write loss and a flat census at
    every quiesce point; :class:`MigrationSoakHarness`, journaled slot
    migrations killed at every phase and resumed under transport noise and
    checkpoint corruption; :class:`ClusterProcSoakHarness` and its fleet
    profiles, the same storm against server OS processes with real
    SIGKILLs; and the tracking, read-scale, device-shard, QoS, vector,
    device-fault and residency profiles.  Each config's ``device`` (the
    card unless ``"cpu"``) is where the harness builds its servers and
    clients.
"""
from redisson_tpu_torch.chaos.census import ResourceCensus
from redisson_tpu_torch.chaos.faults import KINDS, Fault, FaultPlane, FaultSchedule
from redisson_tpu_torch.chaos.soak import (
    ClusterProcSoakConfig,
    ClusterProcSoakHarness,
    ClusterProcSoakReport,
    FleetSoakConfig,
    FleetSoakHarness,
    FleetSoakReport,
    HostFleetSoakConfig,
    HostFleetSoakHarness,
    HostFleetSoakReport,
    MigrationSoakConfig,
    MigrationSoakHarness,
    MigrationSoakReport,
    SoakConfig,
    SoakHarness,
    SoakReport,
)

__all__ = [
    "ClusterProcSoakConfig",
    "ClusterProcSoakHarness",
    "ClusterProcSoakReport",
    "Fault",
    "FaultPlane",
    "FaultSchedule",
    "FleetSoakConfig",
    "FleetSoakHarness",
    "FleetSoakReport",
    "HostFleetSoakConfig",
    "HostFleetSoakHarness",
    "HostFleetSoakReport",
    "KINDS",
    "MigrationSoakConfig",
    "MigrationSoakHarness",
    "MigrationSoakReport",
    "ResourceCensus",
    "SoakConfig",
    "SoakHarness",
    "SoakReport",
]
