"""Cluster harness: form, mutate, and kill in-process server topologies.

Parity target: the reference's failover-test infrastructure —
``org/redisson/RedisRunner.java`` (spawn/stop/restart real redis-server
processes) and ``ClusterRunner.java:26-65`` (addNode(master, slaves...) ->
run() forms a live cluster).  Multi-node without multi-host = N nodes on
localhost ports; here nodes are in-process ServerThreads (hermetic) — chaos
tests call ``stop_node`` mid-load exactly like RedissonFailoverTest kills
masters.

A copy of ``redisson_tpu/harness.py``: every keyword argument of
``ClusterRunner`` goes to each node's ``ServerThread``, ``device`` among
them, so the nodes' state lives on the CUDA card unless the caller passes
``device="cpu"``.  Replicas (``replicas_per_master > 0``) attach to their
masters by REPLICAOF (``server/replication.py``).
"""
from __future__ import annotations

import socket
from typing import List, Optional, Tuple

from redisson_tpu_torch.cluster import topology as _topology
from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.server import ServerThread

# THE slot-assignment program (cluster/topology.py): shared verbatim with
# the process-level ClusterSupervisor so the in-process and multi-process
# cluster shapes cannot drift in how the 16384 slots map onto masters
split_slots = _topology.split_slots

def _exec(conn, *args, timeout: Optional[float] = None):
    reply = conn.execute(*args, timeout=timeout)
    if isinstance(reply, RespError):
        raise reply
    return reply


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ClusterNode:
    def __init__(self, server: ServerThread, role: str, master_index: Optional[int] = None):
        self.server = server
        self.role = role  # "master" | "replica"
        self.master_index = master_index  # masters[i] this replicates
        self.stopped = False

    @property
    def address(self) -> str:
        return f"{self.server.server.host}:{self.server.server.port}"

    @property
    def port(self) -> int:
        return self.server.server.port


class ClusterRunner:
    """Form an n-master (optionally replicated) in-process cluster."""

    def __init__(self, masters: int = 3, replicas_per_master: int = 0, **server_kw):
        self.n_masters = masters
        self.replicas_per_master = replicas_per_master
        self.server_kw = server_kw
        self.masters: List[ClusterNode] = []
        self.replicas: List[ClusterNode] = []
        self.slot_ranges = split_slots(masters)

    def run(self) -> "ClusterRunner":
        try:
            for _ in range(self.n_masters):
                st = ServerThread(port=free_port(), **self.server_kw).start()
                self.masters.append(ClusterNode(st, "master"))
            for mi in range(self.n_masters):
                for _ in range(self.replicas_per_master):
                    st = ServerThread(port=free_port(), **self.server_kw).start()
                    self.replicas.append(ClusterNode(st, "replica", master_index=mi))
            self.install_view()
            self.wire_replicas()
        except BaseException:
            # a half-formed cluster must not leak serving threads
            self.shutdown()
            raise
        return self

    # -- topology management --------------------------------------------------

    def view_tuples(self) -> List[Tuple[int, int, str, int, str]]:
        return _topology.view_tuples(
            self.slot_ranges,
            [
                None if m.stopped else
                (m.server.server.host, m.port, m.server.server.node_id)
                for m in self.masters
            ],
        )

    def install_view(self) -> None:
        """Push the slot map to every live node (CLUSTER SETVIEW) — through
        the shared topology program (cluster/topology.install_view)."""
        _topology.install_view(
            [
                node.server.client
                for node in self.masters + self.replicas
                if not node.stopped
            ],
            self.view_tuples(),
            timeout=None,
        )

    def wire_replicas(self) -> None:
        for node in self.replicas:
            if node.stopped:
                continue
            master = self.masters[node.master_index]
            if master.stopped:
                continue
            _topology.wire_replica(
                node.server.client, master.server.server.host, master.port
            )

    # -- chaos ops (RedisRunner stop()/restart() analog) ----------------------

    def stop_node(self, node: ClusterNode) -> None:
        node.stopped = True
        node.server.stop()

    def stop_master(self, index: int) -> ClusterNode:
        node = self.masters[index]
        self.stop_node(node)
        return node

    def restart_node(self, node: ClusterNode) -> ClusterNode:
        """Bring a stopped node back on the SAME port (RedisRunner.restart
        analog).  State starts empty — an in-process node's store dies with
        its thread, like a redis-server restarted without persistence."""
        port = node.port
        node.server = ServerThread(port=port, **self.server_kw).start()
        node.stopped = False
        self.install_view()
        self.wire_replicas()  # re-attach replica links severed by the restart
        return node

    def stall_replication(self, node: ClusterNode) -> None:
        """Freeze this master's record shipper (replica lag grows until
        resumed): the repl-link-partition chaos op."""
        src = node.server.server._replication
        if src is not None:
            src.stall()

    def resume_replication(self, node: ClusterNode) -> None:
        src = node.server.server._replication
        if src is not None:
            src.resume()

    def adopt_failover(self, dead_address: str, promoted_address: str) -> Optional[ClusterNode]:
        """Sync this runner's bookkeeping with a promotion an external
        coordinator performed: the promoted replica becomes masters[i] for
        the dead master's range.  Returns the dead node (still stopped), so
        callers can restart_node() it as a fresh replica of the promoted
        master."""
        mi = next(
            (i for i, m in enumerate(self.masters) if m.address == dead_address),
            None,
        )
        promoted = next(
            (r for r in self.replicas if r.address == promoted_address), None
        )
        if mi is None or promoted is None:
            return None
        dead = self.masters[mi]
        promoted.role = "master"
        promoted.master_index = None
        self.masters[mi] = promoted
        self.replicas = [r for r in self.replicas if r is not promoted]
        dead.role = "replica"
        dead.master_index = mi
        self.replicas.append(dead)
        return dead

    def promote(self, replica: ClusterNode) -> None:
        """Manual failover: the replica takes over its dead master's slot
        range."""
        mi = replica.master_index
        with replica.server.client() as c:
            _exec(c, "REPLICAOF", "NO", "ONE")
        replica.role = "master"
        old = self.masters[mi]
        self.masters[mi] = ClusterNode(replica.server, "master")
        self.replicas = [r for r in self.replicas if r is not replica]
        if not old.stopped:
            self.stop_node(old)
        self.install_view()
        self.wire_replicas()

    def seeds(self) -> List[str]:
        return [m.address for m in self.masters if not m.stopped] + [
            r.address for r in self.replicas if not r.stopped
        ]

    def client(self, **kw):
        from redisson_tpu_torch.client.cluster import ClusterRedisson

        # the default response timeout must cover a node's first kernel
        # build: a shorter timeout makes the retry machinery re-send a
        # non-idempotent command the server actually completed
        kw.setdefault("timeout", 180.0)
        return ClusterRedisson(self.seeds(), **kw)

    def shutdown(self) -> None:
        for node in self.masters + self.replicas:
            if not node.stopped:
                node.server.stop()
