"""Chaos subsystem: deterministic fault injection and leak accounting.

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

The reference's endurance harnesses (``redisson_tpu/chaos/soak.py``) are
not in the port yet (ROADMAP M11 part 6b).
"""
from redisson_tpu_torch.chaos.census import ResourceCensus
from redisson_tpu_torch.chaos.faults import KINDS, Fault, FaultPlane, FaultSchedule

__all__ = ["Fault", "FaultPlane", "FaultSchedule", "KINDS", "ResourceCensus"]
