"""Cluster topology wiring: the ONE slot-assignment + SETVIEW program.

A copy of ``redisson_tpu/cluster/topology.py``.  Both cluster shapes — the
in-process :class:`~redisson_tpu_torch.harness.ClusterRunner` (hermetic tests)
and the process-level
:class:`~redisson_tpu_torch.cluster.supervisor.ClusterSupervisor` (one server
OS process per node) — must agree EXACTLY on how the 16384 slots map
onto masters and how that map is installed, or a soak that passes in-process
could mask a multi-process routing bug (and vice versa).  This module is that
single source of truth:

  * :func:`split_slots` — the even contiguous partition (the reference's
    create-cluster default layout, ``redis-cli --cluster create``);
  * :func:`view_tuples` / :func:`flatten_view` — the ``CLUSTER SETVIEW``
    5-tuple program built from (slot-range, master identity) pairs;
  * :func:`install_view` — push one view to every live node.

Attaching a replica to its master (the reference's ``wire_replica``) comes
with the replication slice (ROADMAP M11).

Callers hand over *connection factories* (zero-arg callables returning a
context-managed connection with ``.execute``), so the same wiring code drives
in-process ``ServerThread.client()`` handles and the supervisor's real-TCP
admin connections without this module knowing which it is talking to.
"""
from __future__ import annotations

import warnings
from typing import (
    Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple,
)

from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.utils.crc16 import MAX_SLOT

# (slot_from, slot_to, host, port, node_id) — the SETVIEW row shape every
# layer of the system (TpuServer.cluster_view, harness, monitor) shares
ViewRow = Tuple[int, int, str, int, str]


def check_reply(reply: Any) -> Any:
    """Surface server-side errors: a RespError REPLY becomes a raise."""
    if isinstance(reply, RespError):
        raise reply
    return reply


def split_slots(n: int) -> List[Tuple[int, int]]:
    """Even contiguous slot partition for `n` masters (the reference's
    create-cluster default layout).  The last range absorbs the remainder."""
    if n < 1:
        raise ValueError(f"need at least one master, got {n}")
    per = MAX_SLOT // n
    ranges = []
    for i in range(n):
        lo = i * per
        hi = MAX_SLOT - 1 if i == n - 1 else (i + 1) * per - 1
        ranges.append((lo, hi))
    return ranges


def view_tuples(
    slot_ranges: Sequence[Tuple[int, int]],
    masters: Sequence[Optional[Tuple[str, int, str]]],
) -> List[ViewRow]:
    """Zip slot ranges with master identities ``(host, port, node_id)`` into
    SETVIEW rows.  A ``None`` master (stopped/dead node) drops its range from
    the view — exactly the hole a failover coordinator later re-points."""
    if len(slot_ranges) != len(masters):
        raise ValueError(
            f"{len(slot_ranges)} slot ranges vs {len(masters)} masters"
        )
    return [
        (lo, hi, host, int(port), node_id)
        for (lo, hi), m in zip(slot_ranges, masters)
        if m is not None
        for (host, port, node_id) in (m,)
    ]


def flatten_view(view: Iterable[ViewRow]) -> List:
    """SETVIEW wire operands: the 5-tuples flattened in row order."""
    flat: List = []
    for lo, hi, host, port, node_id in view:
        flat += [lo, hi, host, port, node_id]
    return flat


def install_view(
    conn_factories: Sequence[Callable[[], Any]],
    view: Sequence[ViewRow],
    timeout: Optional[float] = 10.0,
) -> None:
    """Push ONE view to every node.  Each factory yields a context-managed
    connection (``with factory() as c: c.execute(...)``); a node that
    rejects the view raises — topology installation is not best-effort."""
    flat = flatten_view(view)
    for factory in conn_factories:
        with factory() as c:
            check_reply(c.execute("CLUSTER", "SETVIEW", *flat, timeout=timeout))


class PlacementDegraded(UserWarning):
    """Host anti-affinity could not be honored (fewer failure domains than
    the replication factor needs) — the fleet still forms, but a single
    host failure can now take a master AND its replica together."""


def assign_hosts(
    hosts: Sequence[str],
    n_masters: int,
    replicas_per_master: int = 0,
) -> Tuple[List[str], Dict[Tuple[int, int], str]]:
    """Failure-domain placement: map a fleet plan onto host
    labels with HOST ANTI-AFFINITY — a replica is never placed on its
    master's host, because a replica that shares its master's failure
    domain is not a replica, it is a second copy of the same outage.

      * masters round-robin across ``hosts`` (spread, not packed);
      * replica ``r`` of master ``mi`` takes the ``(1 + r)``-th host AFTER
        its master's in ring order — off-host by construction, and
        consecutive replicas of one master land on DISTINCT hosts while
        enough domains exist;
      * one host (or ``replicas_per_master >= len(hosts)``) cannot honor
        anti-affinity for every replica: the placement DEGRADES LOUDLY —
        a :class:`PlacementDegraded` warning names every violating pair —
        rather than refusing to form (single-host CI fleets are the
        common case) or silently pretending the domain split exists.

    Returns ``(master_hosts, replica_hosts)``: ``master_hosts[mi]`` is
    master ``mi``'s host label, ``replica_hosts[(mi, r)]`` replica ``r``
    of master ``mi``'s."""
    if not hosts:
        raise ValueError("need at least one host label")
    ring = list(hosts)
    master_hosts = [ring[i % len(ring)] for i in range(n_masters)]
    replica_hosts: Dict[Tuple[int, int], str] = {}
    violations: List[str] = []
    for mi in range(n_masters):
        anchor = mi % len(ring)
        for r in range(replicas_per_master):
            host = ring[(anchor + 1 + r) % len(ring)]
            replica_hosts[(mi, r)] = host
            if host == master_hosts[mi]:
                violations.append(f"r{mi}-{r} shares host {host!r} with m{mi}")
    if violations:
        warnings.warn(
            "host anti-affinity DEGRADED — "
            f"{len(ring)} host(s) cannot separate "
            f"{replicas_per_master} replica(s) from each master: "
            + "; ".join(violations),
            PlacementDegraded,
            stacklevel=2,
        )
    return master_hosts, replica_hosts


def fetch_view(conn: Any, timeout: Optional[float] = 10.0) -> List[ViewRow]:
    """Read a node's current view back (CLUSTER SLOTS reply -> rows)."""
    rows: List[ViewRow] = []
    for row in check_reply(conn.execute("CLUSTER", "SLOTS", timeout=timeout)):
        lo, hi, (host, port, nid) = int(row[0]), int(row[1]), row[2]
        rows.append((lo, hi, _s(host), int(port), _s(nid)))
    return rows


def _s(v: Any) -> str:
    return v.decode() if isinstance(v, (bytes, bytearray)) else str(v)
