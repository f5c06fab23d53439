"""ReplicatedRedisson: master-discovery client over plain replicated nodes.

A copy of ``redisson_tpu/client/replicated.py`` on the port's
``ClusterRedisson``.  Parity target: ``connection/ReplicatedConnectionManager.java`` (270 LoC) —
the Azure Redis Cache / AWS ElastiCache shape where a replication group
exposes N plain endpoints and NO cluster protocol: the client itself polls
every configured node to learn which one is currently master (the
reference polls ``INFO replication`` per node; here the ``ROLE`` verb
answers the same question in one structured reply) and moves writes when
the answer changes.  Promotion itself is external (the cloud service or an
operator runs the failover), exactly as in the reference.

TPU-first shape: not a parallel manager class hierarchy — this is the
cluster client with a different *view source*.  The role scan synthesizes
a one-shard full-range view ([0..16383] -> elected master) and every other
mechanism (routing core, retry machine, redirect handling, pools,
balancers, scheduled refresh) is inherited unchanged from
``ClusterRedisson``.  The replica set ALSO comes from the client-side scan
(nodes answering "slave"), not from the master's own registry: a replica
the master forgot across a restart still serves reads, which is the
reference's client-side discovery contract (ReplicatedConnectionManager
builds the slave set from the node list, not from the master).
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, List, Optional, Tuple

from redisson_tpu_torch.client.cluster import ClusterRedisson
from redisson_tpu_torch.net.client import NodeClient, parse_address
from redisson_tpu_torch.utils.crc16 import MAX_SLOT


def _norm(addr: str) -> str:
    host, port = parse_address(addr)
    return f"{host}:{port}"


class ReplicatedRedisson(ClusterRedisson):
    """Replicated-topology facade (ReplicatedConnectionManager analog)."""

    def __init__(
        self,
        nodes: List[str],
        config=None,
        scan_interval: float = 1.0,
        **kw,
    ):
        # attrs the overridden _fetch_view needs must exist BEFORE the base
        # __init__ runs its first refresh_topology()
        self._nodes = [_norm(a) for a in nodes]
        self._probes: Dict[str, NodeClient] = {}
        self._probe_lock = threading.Lock()
        self._last_scan: Dict[str, Tuple[str, Optional[str]]] = {}
        self._current_master: Optional[str] = None
        self._pending_master: Optional[str] = None
        # replicated groups are small and role flips are externally driven,
        # so the default poll is tighter than cluster's 5s scanInterval
        # (the reference's ReplicatedConnectionManager reuses scanInterval;
        # callers can pass their own)
        super().__init__(nodes, config=config, scan_interval=scan_interval, **kw)

    # -- discovery -----------------------------------------------------------

    def _probe(self, addr: str) -> NodeClient:
        """Persistent single-shot probe client per configured node (the node
        list is static in replicated mode, so probes live for the client's
        lifetime instead of reconnecting every scan tick)."""
        with self._probe_lock:
            pc = self._probes.get(addr)
            if pc is None:
                pkw = dict(self._node_kw)
                pkw.update(ping_interval=0, retry_attempts=0, pool_size=1)
                pc = self._probes[addr] = NodeClient(addr, **pkw)
            return pc

    def _role_scan(self) -> Dict[str, Tuple[str, Optional[str]]]:
        """addr -> ("master", None) | ("replica", master_addr) for every
        configured node that answered ROLE; silent nodes are absent.

        Reported master addresses are normalized through the same parser as
        the configured node list so votes/membership compare equal.  The
        remaining contract (documented, not resolvable client-side): the
        address family must match — a group wired with ``REPLICAOF
        127.0.0.1 ...`` cannot be vote-matched against a node list of
        hostnames, since equating them would need DNS on every scan tick."""
        scan: Dict[str, Tuple[str, Optional[str]]] = {}
        for addr in self._nodes:
            try:
                role = self._probe(addr).execute("ROLE", timeout=2.0, retry_attempts=0)
            except Exception:  # noqa: BLE001 — node down: absent from scan
                continue
            kind = role[0].decode() if isinstance(role[0], bytes) else str(role[0])
            if kind in ("slave", "replica"):
                mh = role[1].decode() if isinstance(role[1], bytes) else str(role[1])
                scan[addr] = ("replica", _norm(f"{mh}:{int(role[2])}"))
            else:
                scan[addr] = ("master", None)
        return scan

    def _elect(self, scan: Dict[str, Tuple[str, Optional[str]]]) -> Optional[str]:
        """Pick the write target among nodes claiming master.

        Replica votes rank first: the group's own replication links are the
        best evidence of who the real master is, and they must be able to
        move a LONG-RUNNING client off a demoted-but-still-claiming old
        master (an external failover that never stops the old node) — a
        freshly started client would elect by votes, and two clients of one
        group must not disagree on the write target.  Stability second: the
        current master keeps the role only among claimants with EQUAL top
        votes (a transient co-claimant with no replica backing must not
        flap writes).  Final tiebreak is node-list order, matching the
        reference's first-found behavior."""
        masters = [a for a, (k, _) in scan.items() if k == "master"]
        if not masters:
            return None
        votes = Counter(m for (k, m) in scan.values() if k == "replica" and m)
        top_votes = max(votes.get(a, 0) for a in masters)
        top = [a for a in masters if votes.get(a, 0) == top_votes]
        if self._current_master in top:
            return self._current_master
        top.sort(key=self._nodes.index)
        return top[0]

    # -- view source override ------------------------------------------------

    def _fetch_view(self):
        """Role scan -> synthesized one-shard full-range CLUSTER SLOTS view.

        Returning None (no node claims master — e.g. the promotion window
        after a master death, before the external failover lands) keeps the
        previous view, so reads keep flowing from replicas while writes
        fail fast until the next scan finds the promoted node."""
        scan = self._role_scan()
        self._last_scan = scan
        master = self._elect(scan)
        if master is None:
            return None
        # publication waits for the table swap (_refresh_topology_locked):
        # current_master and entry_for_slot must never disagree, and a
        # failed install must not anchor the next election's stickiness
        self._pending_master = master
        host, port = parse_address(master)
        return [[0, MAX_SLOT - 1, [host, port, f"replicated:{master}"]]]

    _replica_discovery = False  # replicas come from the scan, not REPLICAS

    def _refresh_topology_locked(self) -> bool:
        swapped = super()._refresh_topology_locked()
        if not swapped:
            return False
        self._current_master = self._pending_master
        # replica set from the client-side scan (see module docstring) —
        # but ONLY nodes replicating the ELECTED master: a replica still
        # following a stale claimant never receives the elected master's
        # op-log, and installing it as a read target would serve silently
        # stale reads forever, not mere replication lag
        scan = self._last_scan
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            reps = [
                a
                for a, (k, m) in scan.items()
                if k == "replica" and m == e.address and a != e.address
            ]
            e.sync_replicas(reps)
        return swapped

    # -- admin ---------------------------------------------------------------

    @property
    def current_master(self) -> Optional[str]:
        return self._current_master

    def shutdown(self) -> None:
        super().shutdown()
        with self._probe_lock:
            for p in self._probes.values():
                p.close()
            self._probes.clear()

    @classmethod
    def create(cls, config) -> "ReplicatedRedisson":
        from redisson_tpu_torch.client.cluster import (
            READ_MASTER,
            READ_MASTER_SLAVE,
            READ_REPLICA,
        )

        rsc = config.replicated_servers_config
        if rsc is None or not rsc.node_addresses:
            raise ValueError("config.use_replicated_servers() with node_addresses required")
        modes = {
            "MASTER": READ_MASTER,
            "SLAVE": READ_REPLICA,
            "REPLICA": READ_REPLICA,
            "MASTER_SLAVE": READ_MASTER_SLAVE,
        }
        key = str(rsc.read_mode).upper()
        if key not in modes:
            raise ValueError(
                f"unknown read_mode {rsc.read_mode!r}; expected one of {sorted(modes)}"
            )
        ssl_ctx = rsc.build_ssl_context()
        return cls(
            rsc.node_addresses,
            config=config,
            scan_interval=rsc.scan_interval,
            read_mode=modes[key],
            dns_monitoring_interval=rsc.dns_monitoring_interval,
            username=rsc.username,
            password=rsc.password,
            client_name=rsc.client_name,
            ssl_context=ssl_ctx,
            pool_size=rsc.connection_pool_size,
            timeout=rsc.timeout,
            connect_timeout=rsc.connect_timeout,
            retry_attempts=rsc.retry_attempts,
            retry_interval=rsc.retry_interval,
            ping_interval=rsc.ping_connection_interval,
        )
