"""Process-level chaos primitives for supervisor-run clusters.

A copy of ``redisson_tpu/cluster/chaos.py``.  The victims are real OS
processes, so the primitives are real signals plus one deterministic
coordinator-death hook:

  * :func:`crash_coordinator_at` — run a journaled migration and "die" at a
    chosen journal phase (``migrate_slots(crash_after=...)`` raising
    ``CoordinatorKilled``).  The journal lives in the SUPERVISOR process
    and the servers are separate processes, so the subsequent
    ``resume_migrations`` replays the journal across a genuine process
    boundary.
  * :func:`kill_pair_at_phase` — the coordinator dies at a phase, then the
    migration's target (and optionally its source) is killed.
  * :func:`sigkill_at_phase` — crash the coordinator at a phase, then
    SIGKILL a server process AT that exact journal state, leaving both
    halves of the protocol dead at once.

SIGSTOP/SIGCONT freezes ride :meth:`ClusterSupervisor.pause`/``resume``
directly; SIGKILL/SIGTERM ride :meth:`ClusterSupervisor.kill`/``stop``.
"""
from __future__ import annotations

import signal
from typing import Optional, Sequence

from redisson_tpu_torch.cluster.supervisor import ClusterSupervisor, NodeProc


def crash_coordinator_at(
    source: str,
    target: str,
    slots: Sequence[int],
    journal_dir: str,
    phase: str,
    password: Optional[str] = None,
    ssl_context=None,
) -> None:
    """Start a journaled migration and murder the coordinator right after
    `phase`'s journal entry (``PLANNED``, ``WINDOW_OPEN``,
    ``DRAINING:<sweep>``, ``VIEW_COMMITTED``).  Raises AssertionError if the
    crash point never fired (the phase was not reached) — a storm that
    silently completed is a broken storm, not a passed one."""
    from redisson_tpu_torch.server.migration import CoordinatorKilled, migrate_slots

    try:
        migrate_slots(
            source, target, slots,
            journal_dir=journal_dir, crash_after=phase, password=password,
            ssl_context=ssl_context,
        )
    except CoordinatorKilled:
        return
    raise AssertionError(f"crash_after={phase!r} did not fire")


def kill_pair_at_phase(
    sup: ClusterSupervisor,
    source_node: NodeProc,
    target_node: NodeProc,
    slots: Sequence[int],
    phase: str,
    kill_source: bool = False,
    kill_target: bool = True,
    sig: int = signal.SIGKILL,
) -> dict:
    """The DOUBLE-kill matrix: the coordinator dies at `phase`
    (journal frozen at that exact state), then the chosen server
    process(es) — the migration TARGET by default, optionally the source
    too, i.e. every party to the protocol dead at once.  Returns
    ``{"source": rc, "target": rc}`` for the processes actually killed.
    Recovery is the caller's move: ``sup.restart(...)`` each victim (boot
    replays the target's import journal) + ``resume_migrations`` — or
    ``sup.promote_replica(target_node)`` +
    ``resume_migrations(readdress=...)`` for the failover path."""
    crash_coordinator_at(
        source_node.address, target_node.address, slots, sup.journal_dir,
        phase, password=sup.password, ssl_context=sup.client_ssl_context(),
    )
    out = {}
    if kill_target:
        out["target"] = sup.kill(target_node, sig)
    if kill_source:
        out["source"] = sup.kill(source_node, sig)
    return out


def sigkill_at_phase(
    sup: ClusterSupervisor,
    victim: NodeProc,
    source: str,
    target: str,
    slots: Sequence[int],
    phase: str,
    sig: int = signal.SIGKILL,
) -> Optional[int]:
    """The cross-process double-kill: coordinator dies at `phase` (journal
    frozen at that exact state), THEN the victim server process is killed.
    Returns the victim's exit code (negative signal number).  Recovery is
    the caller's move: ``sup.restart(victim)`` +
    ``resume_migrations(sup.journal_dir)``."""
    crash_coordinator_at(
        source, target, slots, sup.journal_dir, phase, password=sup.password,
        ssl_context=sup.client_ssl_context(),
    )
    return sup.kill(victim, sig)
