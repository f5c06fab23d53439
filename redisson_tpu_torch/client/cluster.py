"""ClusterRedisson: slot-routed client over an N-master server topology.

Parity targets (SURVEY.md §2.2, §3.6):
  * ``cluster/ClusterConnectionManager.java:84-180`` — topology discovery
    (CLUSTER SLOTS from any reachable seed), slot->entry table[16384],
    scheduled topology refresh (scanInterval).
  * ``connection/MasterSlaveEntry.java:106-299`` — per-shard master +
    replica set with freeze/unfreeze and balancer-driven read routing
    (ReadMode MASTER / SLAVE / MASTER_SLAVE).
  * ``command/RedisExecutor.java`` redirect handling — MOVED replies refresh
    the topology and re-route, bounded by max_redirects.

TPU-first departure: there is no gossip; the slot map is installed by the
launcher (harness.ClusterRunner, cluster.ClusterSupervisor) via CLUSTER
SETVIEW, and clients treat MOVED + periodic refresh as the only discovery
protocol — the data plane stays entirely in the server processes next to
their cards.

A copy of ``redisson_tpu/client/cluster.py`` on the port's ``RemoteSurface``;
pickled frames go through ``net/safe_pickle`` as the single-node client's
do.  Reads follow ``read_mode`` ("replica" / "master_slave" read from the
masters' replicas, with the REPLSTATE staleness probe when a bound is set).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from redisson_tpu_torch.client import routing
from redisson_tpu_torch.net import safe_pickle
from redisson_tpu_torch.net.balancer import LoadBalancer, RoundRobinLoadBalancer
from redisson_tpu_torch.net.client import ConnectionError_, NodeClient
from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.net.safe_pickle import safe_loads
from redisson_tpu_torch.utils.crc16 import MAX_SLOT, calc_slot

READ_MASTER = "master"
READ_REPLICA = "replica"
READ_MASTER_SLAVE = "master_slave"

# Default sweep-cut lag bound for replica-read profiles, DERIVED from the
# replication shipper's cadence (server/replication.py): the master's
# ``offset`` ticks once per sweep CUT and the shipper sweeps every 0.2 s by
# default, so a HEALTHY replica is at most ~2 cuts behind at any instant —
# the cut currently in flight on the link plus the cut forming at the
# master (the heartbeat, throttled to interval/2, keeps an idle link's lag
# at 0).  Bounding lag at 2 cuts therefore admits every healthy replica
# (~0.4 s of writes at the default cadence) while redirecting reads off a
# replica whose link has actually stalled — without the operator having to
# know the shipper's internals.  Explicit ``max_staleness_ms`` /
# ``max_staleness_offset`` values override the derivation entirely.
DEFAULT_REPLICA_STALENESS_OFFSET = 2


class ShardEntry:
    """One shard: master client + replica clients + read balancer
    (MasterSlaveEntry analog)."""

    def __init__(self, address: str, balancer: Optional[LoadBalancer] = None, **node_kw):
        self.address = address
        self.master = NodeClient(address, **node_kw)
        self.replicas: Dict[str, NodeClient] = {}
        self.balancer = balancer or RoundRobinLoadBalancer()
        self._node_kw = node_kw

    def sync_replicas(self, addresses: List[str]) -> None:
        for addr in addresses:
            if addr not in self.replicas:
                # replica connections arm READONLY at handshake:
                # a cluster replica -MOVEDs keyed reads from plain conns
                self.replicas[addr] = NodeClient(
                    addr, readonly=True, **self._node_kw
                )
        for addr in list(self.replicas):
            if addr not in addresses:
                self.replicas.pop(addr).close()

    def read_node(self, read_mode: str) -> NodeClient:
        if read_mode == READ_MASTER or not self.replicas:
            return self.master
        pool = list(self.replicas.values())
        if read_mode == READ_MASTER_SLAVE:
            pool = pool + [self.master]
        return self.balancer.pick(pool) or self.master

    def close(self) -> None:
        self.master.close()
        for r in self.replicas.values():
            r.close()


from redisson_tpu_torch.client.remote import RemoteSurface, _unwrap_many  # noqa: E402


class ClusterRedisson(RemoteSurface):
    """Slot-routed facade sharing the Remote* handle surface (the handles
    call ``client.execute``/``client.objcall``; routing happens here)."""

    # refresh asks each master for its replica set (REPLICAS); replicated
    # mode discovers replicas client-side instead and sets this False
    _replica_discovery = True

    def __init__(
        self,
        seeds: List[str],
        config=None,
        read_mode: str = READ_MASTER,
        balancer: Optional[LoadBalancer] = None,
        scan_interval: float = 5.0,
        dns_monitoring_interval: float = 5.0,
        max_redirects: int = 5,
        max_staleness_ms: Optional[int] = None,
        max_staleness_offset: Optional[int] = None,
        **node_kw,
    ):
        from redisson_tpu_torch.config import Config

        self.config = config or Config()
        self.read_mode = read_mode
        self.max_redirects = max_redirects
        # bounded-staleness contract: with either bound set,
        # every replica-served read pipelines a REPLSTATE MAXSTALE probe in
        # the SAME frame and the client redirects to the master when the
        # answer is too stale.  max_staleness_ms bounds time since the
        # replica's last applied push/heartbeat; max_staleness_offset bounds
        # sweep-cut lag against the highest offset this client has seen any
        # node of the shard prove.
        self.max_staleness_ms = max_staleness_ms
        if (max_staleness_offset is None and max_staleness_ms is None
                and read_mode != READ_MASTER):
            # replica-read profiles are staleness-bounded BY DEFAULT: the
            # sweep-cut lag bound derived from the shipper's cadence (see
            # DEFAULT_REPLICA_STALENESS_OFFSET).  Any explicit bound —
            # either axis — overrides the derivation.
            max_staleness_offset = DEFAULT_REPLICA_STALENESS_OFFSET
        self.max_staleness_offset = max_staleness_offset
        self.read_stats: Dict[str, int] = {
            "replica_reads": 0,
            "replica_redirects_stale": 0,
            "replica_fallbacks": 0,
        }
        self._shard_offsets: Dict[str, int] = {}  # master addr -> max offset seen
        if balancer is None and read_mode != READ_MASTER:
            # replica-read profiles default to lane-occupancy scoring:
            # each read leg steers to the candidate whose device lanes are
            # idlest per its scraped CLUSTER QOS ledger, not just
            # round-robin.  One shared instance — it keys its
            # scrape cache by node address.
            from redisson_tpu_torch.net.balancer import OccupancyLoadBalancer

            balancer = OccupancyLoadBalancer()
        self._balancer_factory = balancer
        self._node_kw = dict(node_kw)
        # config-level SPIs ride every node connection of the cluster
        self._node_kw.setdefault("credentials_resolver", self.config.credentials_resolver)
        self._node_kw.setdefault("command_mapper", self.config.command_mapper)
        # one ConnectionEventsHub shared by every node of the cluster:
        # listeners see per-ADDRESS edge-triggered connect/disconnect
        from redisson_tpu_torch.net.detectors import ConnectionEventsHub

        self.events_hub = self._node_kw.setdefault(
            "events_hub", ConnectionEventsHub()
        )
        self._seeds = list(seeds)
        self._entries: Dict[str, ShardEntry] = {}  # master address -> entry
        self._slots: List[Optional[str]] = [None] * MAX_SLOT  # slot -> master address
        self._lock = threading.RLock()
        # refreshes serialize: two concurrent refreshes building entries for
        # the same new address would leak the loser's connections
        self._refresh_lock = threading.Lock()
        self._closed = threading.Event()
        self.refresh_topology()
        self._scan_interval = scan_interval
        self._scan_thread: Optional[threading.Thread] = None
        if scan_interval and scan_interval > 0:
            self._scan_thread = threading.Thread(
                target=self._scan_loop, daemon=True, name="rtpu-cluster-scan"
            )
            self._scan_thread.start()
        # DNS re-resolution for hostname seeds (connection/DNSMonitor.java):
        # an A-record flip behind a stable name triggers a topology refresh.
        # <= 0 disables (the reference's dnsMonitoringInterval=-1)
        self._dns = None
        if dns_monitoring_interval and dns_monitoring_interval > 0:
            from redisson_tpu_torch.net.dns import DNSMonitor

            self._dns = DNSMonitor(
                seeds,
                lambda _ep, _old, _new: self.refresh_topology(),
                interval=dns_monitoring_interval,
            ).start()

    @classmethod
    def create(cls, config) -> "ClusterRedisson":
        """Build from Config.use_cluster_servers() (ClusterServersConfig
        analog: node addresses, scanInterval, readMode, pool/retry knobs)."""
        csc = config.use_cluster_servers()
        if not csc.node_addresses:
            raise ValueError("cluster_servers_config.node_addresses is empty")
        modes = {
            "MASTER": READ_MASTER,
            "SLAVE": READ_REPLICA,
            "REPLICA": READ_REPLICA,
            "MASTER_SLAVE": READ_MASTER_SLAVE,
        }
        key = str(csc.read_mode).upper()
        if key not in modes:
            raise ValueError(
                f"unknown read_mode {csc.read_mode!r}; expected one of {sorted(modes)}"
            )
        read_mode = modes[key]
        return cls(
            list(csc.node_addresses),
            config=config,
            read_mode=read_mode,
            scan_interval=csc.scan_interval,
            dns_monitoring_interval=getattr(csc, "dns_monitoring_interval", 5.0),
            password=csc.password,
            username=csc.username,
            ssl_context=csc.build_ssl_context(),
            client_name=csc.client_name,
            pool_size=csc.connection_pool_size,
            timeout=csc.timeout,
            connect_timeout=csc.connect_timeout,
            retry_attempts=csc.retry_attempts,
            retry_interval=csc.retry_interval,
            ping_interval=csc.ping_connection_interval,
        )

    # -- topology ------------------------------------------------------------

    def _fetch_view(self) -> Optional[List[Any]]:
        """CLUSTER SLOTS from any reachable node (entries first, then seeds)."""
        with self._lock:
            candidates = [e.master for e in self._entries.values()]
        for node in candidates:
            try:
                # single-shot: a dead candidate costs one refused connect,
                # not retries-with-backoff — the NEXT candidate is the retry
                return node.execute("CLUSTER", "SLOTS", timeout=5.0, retry_attempts=0)
            except Exception:  # noqa: BLE001 — try the next node
                continue
        for seed in self._seeds:
            probe = None
            try:
                # probes carry the same credentials as data connections —
                # an AUTH-required cluster must bootstrap too
                kw = dict(self._node_kw)
                kw.update(ping_interval=0, retry_attempts=0)
                probe = NodeClient(seed, **kw)
                return probe.execute("CLUSTER", "SLOTS", timeout=5.0)
            except Exception:  # noqa: BLE001
                continue
            finally:
                if probe is not None:
                    probe.close()
        return None

    def refresh_topology(self) -> bool:
        """Re-read CLUSTER SLOTS and swap the routing table.

        All network I/O (entry construction, REPLICAS discovery) happens
        OUTSIDE self._lock — one dead node's connect timeouts must not stall
        entry_for_slot for healthy shards.  The lock only guards the final
        table swap."""
        if self._closed.is_set():
            return False
        with self._refresh_lock:
            return self._refresh_topology_locked()

    def _refresh_topology_locked(self) -> bool:
        view = self._fetch_view()
        if view is None:
            return False
        new_slots, masters = routing.parse_view(view)
        nat = self.config.nat_mapper
        if nat is not None:
            # NatMapper SPI: advertised addresses -> reachable addresses
            # (container/NAT topologies, api/NatMapper.java role).  Mapped
            # once per DISTINCT address — a real mapper may do table/DNS
            # work, and the slot array has 16384 entries
            table = {a: nat.map(a) for a in masters}
            new_slots = [None if a is None else table.get(a, a) for a in new_slots]
            masters = {table[a]: None for a in masters}
        with self._lock:
            existing = dict(self._entries)
        fresh: Dict[str, ShardEntry] = {}
        for addr in masters:
            # gate EVERY entry on ONE single-shot ping: a dead master must
            # leave the routing table (keyless commands and stale-slot
            # fallbacks would otherwise keep picking it), and must cost one
            # refused connect, not retries-with-backoff under the refresh
            # lock.  EXISTING entries get grace: a healthy-but-slow shard
            # (GC pause, first XLA compile) failing ONE probe must not have
            # its warm pools torn down — eviction needs two consecutive
            # failed refreshes.  New entries admit only on a clean ping.
            entry = existing.get(addr)
            created = False
            try:
                if entry is None:
                    entry = ShardEntry(
                        addr, balancer=self._balancer_factory, **self._node_kw
                    )
                    created = True
                entry.master.execute("PING", timeout=2.0, retry_attempts=0)
                entry.refresh_failures = 0
                fresh[addr] = entry
            except Exception:  # noqa: BLE001 — node down or stalled
                if created or entry is None:
                    # construction itself failed (unparseable address, TLS
                    # context error) or never happened: nothing to grace
                    if entry is not None:
                        entry.close()
                    continue
                entry.refresh_failures = getattr(entry, "refresh_failures", 0) + 1
                if entry.refresh_failures < 2:
                    fresh[addr] = entry  # grace period: keep routing to it
                # else: dropped from fresh -> closed as retired below
        # replica discovery per master (REPLICAS command) — still outside
        # lock, single-shot for the same reason.  Subclasses that already
        # know the replica set from their own scan (replicated mode) turn
        # this off instead of paying the round-trip and overwriting it.
        if self._replica_discovery:
            for addr, entry in fresh.items():
                try:
                    reps = entry.master.execute(
                        "REPLICAS", timeout=5.0, retry_attempts=0
                    )
                    rep_addrs = [r.decode() if isinstance(r, bytes) else r for r in reps]
                    if self.config.nat_mapper is not None:
                        # replicas advertise internal addresses too
                        rep_addrs = [self.config.nat_mapper.map(a) for a in rep_addrs]
                    entry.sync_replicas(rep_addrs)
                except Exception:  # noqa: BLE001 — master briefly down
                    pass
        with self._lock:
            if self._closed.is_set():
                # shutdown raced this refresh: do NOT repopulate a closed
                # client — close anything we just opened and bail
                retired = [e for a, e in fresh.items() if a not in self._entries]
                swapped = False
            else:
                retired = [e for a, e in self._entries.items() if a not in fresh]
                self._entries = fresh
                self._slots = [a if a in fresh else None for a in new_slots]
                swapped = True
        for e in retired:
            e.close()
        return swapped

    def _scan_loop(self) -> None:
        while not self._closed.wait(self._scan_interval):
            try:
                self.refresh_topology()
            except Exception:  # noqa: BLE001 — keep scanning
                pass

    def wait_routable(self, timeout: float = 30.0,
                      full_coverage: bool = True) -> bool:
        """Block until the cluster actually serves: every hash slot has a
        live owner in the routing table (with ``full_coverage``) and every
        routed master answers PING.  The barrier callers need after a
        process-level start/restart (cluster/supervisor.py) or a failover
        storm — node processes report READY when their listener binds,
        which is before the topology view reaches them.  Returns False on
        deadline instead of raising (the caller owns the failure story)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.refresh_topology()
                with self._lock:
                    addrs = {a for a in self._slots if a is not None}
                    covered = all(a is not None for a in self._slots)
                    entries = [
                        self._entries[a] for a in addrs if a in self._entries
                    ]
                if addrs and (covered or not full_coverage) \
                        and len(entries) == len(addrs):
                    for e in entries:
                        e.master.execute("PING", timeout=2.0, retry_attempts=0)
                    return True
            except Exception:  # noqa: BLE001 — not routable yet
                pass
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.1)

    def entry_for_slot(self, slot: int) -> ShardEntry:
        with self._lock:
            addr = self._slots[slot]
            if addr is None or addr not in self._entries:
                raise ConnectionError_(f"no entry serves slot {slot}")
            return self._entries[addr]

    def entries(self) -> List[ShardEntry]:
        with self._lock:
            return list(self._entries.values())

    # -- command path (RedisExecutor redirect state machine) ------------------
    # routing decisions live in client/routing.py — the PURE core shared
    # with the async cluster client so the two flavors cannot drift

    _ALL_SHARD = routing.ALL_SHARD

    def _route(self, cmd: str, args: tuple) -> Tuple[Optional[int], bool]:
        return routing.route(cmd, args)

    def execute(self, *cmd_args, timeout: Optional[float] = None) -> Any:
        cmd = str(cmd_args[0]).upper()
        if cmd in self._ALL_SHARD:
            return self._execute_all_shards(cmd, cmd_args, timeout)
        slot, write = self._route(cmd, cmd_args[1:])
        if slot == -1:  # cross-slot DEL/UNLINK: per-shard sub-commands
            return self._execute_split_keys(cmd_args, timeout)
        last: Optional[BaseException] = None
        for attempt in range(self.max_redirects + 1):
            try:
                if slot is None:
                    entries = self.entries()
                    if not entries:
                        raise ConnectionError_("no cluster entries")
                    # rotate per redirect attempt: pinning keyless commands
                    # to entries[0] forever starves them when that one node
                    # is down but not yet pruned from the table
                    entry = entries[attempt % len(entries)]
                    node = entry.master
                    if self.read_mode != READ_MASTER and not write \
                            and routing.replica_readable(cmd, cmd_args[1:]):
                        # keyless FT reads ride the replica plane too:
                        # same staleness probe + master re-serve as keyed
                        # replica reads
                        cand = entry.read_node(self.read_mode)
                        if cand is not entry.master:
                            return self._execute_replica_read(
                                entry, cand, cmd_args, timeout
                            )
                else:
                    entry = self.entry_for_slot(slot)
                    if write:
                        node = entry.master
                    else:
                        node = entry.read_node(self.read_mode)
                        if node is not entry.master:
                            return self._execute_replica_read(
                                entry, node, cmd_args, timeout
                            )
                return node.execute(*cmd_args, timeout=timeout)
            except RespError as e:
                msg = str(e)
                if msg.startswith("MOVED "):
                    # MOVED <slot> <host>:<port> — refresh and re-route
                    # (cluster/ClusterConnectionManager topology diff analog)
                    last = e
                    self.refresh_topology()
                    continue
                if msg.startswith("ASK "):
                    # ASK <slot> <host:port> — one-shot redirect into the
                    # migration window; NO topology refresh (the view still
                    # names the draining owner until finalization)
                    try:
                        return self._execute_asking(msg.split()[2], cmd_args, timeout)
                    except RespError as e2:
                        if str(e2).startswith(("MOVED ", "ASK ", "TRYAGAIN")):
                            # stale window (chained reshard / lost view):
                            # feed it back into the redirect loop
                            last = e2
                            self.refresh_topology()
                            continue
                        raise
                    except (ConnectionError, OSError, TimeoutError) as e2:
                        # importing node dropped mid-hop: same transport-retry
                        # rules as the primary path (writes keep at-most-once)
                        if write and isinstance(e2, TimeoutError):
                            raise
                        last = e2
                        self.refresh_topology()
                        time.sleep(min(0.1 * (attempt + 1), 1.0))
                        continue
                if msg.startswith("TRYAGAIN"):
                    # multi-key op spanning a live migration window: neither
                    # node holds every key yet — back off and retry
                    # (RedisExecutor treats TRYAGAIN as a scheduled retry)
                    last = e
                    time.sleep(min(0.05 * (attempt + 1), 0.5))
                    continue
                raise
            except (ConnectionError, OSError, TimeoutError) as e:
                if write and isinstance(e, TimeoutError):
                    # the command may already have been written — re-sending a
                    # non-idempotent write (INCR, OBJCALL put, lock ops) could
                    # double-apply it.  At-most-once for writes, matching the
                    # no-retry-after-write rule NodeClient._with_retry enforces
                    # one layer down.
                    raise
                last = e
                self.refresh_topology()
                time.sleep(min(0.1 * (attempt + 1), 1.0))
                continue
        assert last is not None
        raise last

    def _execute_replica_read(self, entry: ShardEntry, node: NodeClient,
                              cmd_args, timeout) -> Any:
        """Replica-served read under the bounded-staleness contract.
        With a staleness bound configured, the REPLSTATE
        MAXSTALE probe rides the SAME pipelined frame as the read — one
        round trip, one connection — and its reply decides CLIENT-side
        whether the answer is admissible: too stale (or never synced, or a
        reply-shape surprise) and the master re-serves.  Transport failure
        mid-read drains to the master too (reads are idempotent); redirect
        errors re-enter the outer redirect loop like master-served reads."""
        probe = (self.max_staleness_ms is not None
                 or self.max_staleness_offset is not None)
        try:
            if not probe:
                reply = node.execute(*cmd_args, timeout=timeout)
                self.read_stats["replica_reads"] += 1
                return reply
            ms = self.max_staleness_ms
            replies = node.execute_many(
                [("REPLSTATE", "MAXSTALE", int(1 << 30 if ms is None else ms)),
                 tuple(cmd_args)],
                timeout=timeout,
            )
        except (ConnectionError, OSError, TimeoutError):
            self.read_stats["replica_fallbacks"] += 1
            return entry.master.execute(*cmd_args, timeout=timeout)
        state, reply = replies[0], replies[1]
        if isinstance(reply, RespError) and str(reply).startswith(
            ("MOVED ", "ASK ", "TRYAGAIN", "CLUSTERDOWN", "RECOVERING")
        ):
            # fenced / migrating / mid-hand-off slot: NEVER replica-served —
            # the outer redirect loop re-routes exactly as for a master read
            raise reply
        if isinstance(state, RespError) or not self._fresh_enough(entry, state):
            self.read_stats["replica_redirects_stale"] += 1
            return entry.master.execute(*cmd_args, timeout=timeout)
        if isinstance(reply, RespError):
            raise reply
        self.read_stats["replica_reads"] += 1
        return reply

    def _fresh_enough(self, entry: ShardEntry, state) -> bool:
        """Judge one REPLSTATE reply ([role, applied_offset, staleness_ms,
        view_epoch]) against the configured bounds.  A node that answers as
        master (promotion raced the read) is authoritative by definition."""
        try:
            role, offset, stale_ms = state[0], int(state[1]), int(state[2])
        except (TypeError, ValueError, IndexError):
            return False
        role = role.decode() if isinstance(role, (bytes, bytearray)) else str(role)
        if role != "replica":
            return True
        if stale_ms < 0:
            return False  # never synced: always too stale
        if self.max_staleness_ms is not None and stale_ms > self.max_staleness_ms:
            return False
        hw = self._shard_offsets.get(entry.address, 0)
        if self.max_staleness_offset is not None \
                and hw - offset > self.max_staleness_offset:
            return False
        if offset > hw:
            # a replica can only prove an offset its master has cut: reads
            # advance the client's per-shard high-water for the lag bound
            self._shard_offsets[entry.address] = offset
        return True

    def _execute_asking(self, target: str, cmd_args, timeout) -> Any:
        """ASKING + command on ONE connection of the importing node (the
        RedisExecutor ASK path: same connection, no slot-table update)."""
        if self.config.nat_mapper is not None:
            target = self.config.nat_mapper.map(target)  # ASK advertises too
        with self._lock:
            entry = self._entries.get(target)
        transient = None
        try:
            if entry is not None:
                node = entry.master
            else:
                # target not in the current view (fresh master taking its
                # first slots): transient link with the same credentials
                kw = dict(self._node_kw)
                kw.update(ping_interval=0, retry_attempts=0)
                transient = node = NodeClient(target, **kw)
            replies = node.execute_many([("ASKING",), tuple(cmd_args)], timeout=timeout)
            reply = replies[1]
            if isinstance(reply, RespError):
                raise reply
            return reply
        finally:
            if transient is not None:
                transient.close()

    def _execute_all_shards(self, cmd: str, cmd_args, timeout) -> Any:
        merge = self._ALL_SHARD[cmd]
        out: List[Any] = []
        for entry in self.entries():
            reply = entry.master.execute(*cmd_args, timeout=timeout)
            out.append(reply)
        if merge == "concat":
            return [x for r in out for x in (r or [])]
        if merge == "sum":
            return sum(int(r) for r in out)
        return out[0] if out else None

    def _execute_split_keys(self, cmd_args, timeout) -> int:
        """DEL/UNLINK across slots: group keys per owning shard, sum counts
        (the per-entry grouping of RedissonKeys.deleteAsync)."""
        cmd = cmd_args[0]
        groups = routing.group_by_slot(list(cmd_args[1:]))
        total = 0
        for slot, keys in groups.items():
            total += int(self.execute(cmd, *keys, timeout=timeout) or 0)
        return total

    def _group_replies(self, entry: ShardEntry, cmds, timeout) -> List[Any]:
        """One shard group's pipelined replies for execute_many — replica-
        served when EVERY command of the group is replica-readable (the
        read-only legs of FT.MSEARCH / execute_many cross-shard fan-outs
        ride the replica plane instead of pinning to masters),
        master-served otherwise.  The
        group's staleness probe rides the SAME frame (one REPLSTATE row
        ahead of the group); a stale verdict or transport failure re-serves
        the WHOLE group from the master (reads are idempotent); per-command
        redirect rows (-MOVED/-ASK/...) surface to the caller exactly as
        master-served rows do, preserving redirect parity."""
        node = None
        if self.read_mode != READ_MASTER and entry.replicas and all(
            routing.replica_readable(str(c[0]), tuple(c[1:])) for c in cmds
        ):
            cand = entry.read_node(self.read_mode)
            if cand is not entry.master:
                node = cand
        if node is None:
            return entry.master.execute_many(cmds, timeout=timeout)
        probe = (self.max_staleness_ms is not None
                 or self.max_staleness_offset is not None)
        try:
            if not probe:
                replies = node.execute_many(cmds, timeout=timeout)
                self.read_stats["replica_reads"] += len(cmds)
                return replies
            ms = self.max_staleness_ms
            replies = node.execute_many(
                [("REPLSTATE", "MAXSTALE",
                  int(1 << 30 if ms is None else ms))]
                + [tuple(c) for c in cmds],
                timeout=timeout,
            )
        except (ConnectionError, OSError, TimeoutError):
            self.read_stats["replica_fallbacks"] += 1
            return entry.master.execute_many(cmds, timeout=timeout)
        state, rest = replies[0], replies[1:]
        if isinstance(state, RespError) or not self._fresh_enough(entry, state):
            self.read_stats["replica_redirects_stale"] += 1
            return entry.master.execute_many(cmds, timeout=timeout)
        self.read_stats["replica_reads"] += len(cmds)
        return rest

    def execute_many(self, commands, timeout: Optional[float] = None):
        """Per-slot grouped pipeline (executeBatchedAsync per-entry grouping,
        CommandAsyncService.java:575-640): one pipelined frame per shard,
        results stitched back in submission order.  Entries are snapshotted
        once; commands whose shard vanished mid-flight fall back to the
        redirect-aware execute()."""
        with self._lock:
            slot_table = list(self._slots)
            entries = dict(self._entries)
        writes: List[bool] = [False] * len(commands)
        results: List[Any] = [None] * len(commands)

        def run_group(addr, idxs):
            entry = entries.get(addr) if addr is not None else next(iter(entries.values()), None)
            try:
                if entry is None:
                    raise ConnectionError_(f"no entry for {addr}")
                replies = self._group_replies(
                    entry, [commands[i] for i in idxs], timeout
                )
            except (ConnectionError, OSError, TimeoutError) as group_err:
                # topology changed under us: redirect-aware per-command path.
                # After a TIMEOUT the frame may already be written server-side,
                # so writes must NOT re-execute (at-most-once): the whole call
                # raises, like the single-command path.  Reads are safe to
                # re-run; their failures also propagate (the pre-existing
                # contract — transport errors raise, only per-command RESP
                # errors come back as data rows).
                if isinstance(group_err, TimeoutError) and any(
                    writes[i] for i in idxs
                ):
                    raise
                replies = [self.execute(*commands[i], timeout=timeout) for i in idxs]
            for i, r in zip(idxs, replies):
                if isinstance(r, RespError) and str(r).startswith(
                    ("MOVED ", "CLUSTERDOWN", "ASK ", "TRYAGAIN")
                ):
                    # pipelined frames return per-command errors as values;
                    # redirects re-route through the redirect-aware execute()
                    # (a migrated slot must not surface as a silent error row)
                    try:
                        r = self.execute(*commands[i], timeout=timeout)
                    except Exception as e:  # noqa: BLE001 — keep the error as data
                        r = e if isinstance(r, RespError) else r
                results[i] = r

        def run_segment(seg: List[int]) -> None:
            groups: Dict[Optional[str], List[int]] = {}
            for i in seg:
                c = commands[i]
                slot, w = self._route(str(c[0]), tuple(c[1:]))
                writes[i] = w
                addr = None if slot in (None, -1) else slot_table[slot]
                groups.setdefault(addr, []).append(i)
            if len(groups) <= 1:
                for addr, idxs in groups.items():
                    run_group(addr, idxs)
            else:
                # shards execute their frames CONCURRENTLY (per-shard order
                # is preserved inside each frame) — a multi-shard batch costs
                # one shard's latency, not the sum (CommandBatchService
                # writes all entries in parallel)
                import concurrent.futures as _cf

                with _cf.ThreadPoolExecutor(max_workers=min(len(groups), 16)) as pool:
                    futs = [
                        pool.submit(run_group, a, idxs) for a, idxs in groups.items()
                    ]
                    for f in futs:
                        f.result()

        # scatter-gather commands (KEYS/DBSIZE/FLUSHALL) act as ordering
        # barriers: everything submitted before one completes before it runs,
        # everything after starts after — submission-order semantics hold
        # even for a (\"SET\", ...), (\"FLUSHALL\",) batch.  Transport errors
        # raise, matching execute().
        segment: List[int] = []
        for i, c in enumerate(commands):
            cmd = str(c[0]).upper()
            if cmd in self._ALL_SHARD:
                if segment:
                    run_segment(segment)
                    segment = []
                results[i] = self._execute_all_shards(cmd, tuple(c), timeout)
            else:
                segment.append(i)
        if segment:
            run_segment(segment)
        return results

    def objcall_many(self, ops, caller=None, timeout: Optional[float] = None):
        """OBJCALLM with per-shard grouping: one frame + one pickle per
        shard, shards concurrent (the executeBatchedAsync discipline applied
        to the generic object wire).  Per-op MOVED/ASK errors from a stale
        view re-route through the single-op redirect-aware objcall.  Ops may
        be 6-tuples whose trailing element is a pickled codec blob (the
        OBJCALL codec-frame contract)."""
        caller = caller or self.caller_id()
        with self._lock:
            slot_table = list(self._slots)
            entries = dict(self._entries)
        ops = [tuple(op) for op in ops]
        groups = routing.group_by_slot_owner(slot_table, [op[1] for op in ops])
        results: List[Any] = [None] * len(ops)

        def reroute_one(i):
            """Single-op redirect-aware fallback, codec preserved."""
            f, n, m, a, kw = ops[i][:5]
            codec = safe_loads(ops[i][5]) if len(ops[i]) > 5 else None
            return self.objcall(f, n, m, a, kw, caller=caller, codec=codec)

        def run_group(addr, idxs):
            entry = entries.get(addr) if addr is not None else next(iter(entries.values()), None)
            try:
                if entry is None:
                    raise ConnectionError_(f"no entry for {addr}")
                payload = safe_pickle.dumps([ops[i] for i in idxs])
                replies = _unwrap_many(
                    entry.master.execute("OBJCALLM", payload, caller, timeout=timeout),
                    self,
                )
            except TimeoutError:
                # The OBJCALLM frame was written and may have EXECUTED
                # server-side; re-running every op through the per-op path
                # would double-apply non-idempotent writes (map puts, counter
                # adds, lock calls).  Same rule as execute()/run_group for
                # write+timeout: raise, let the caller decide.
                raise
            except (ConnectionError, OSError):
                # stale entry / connect refused: the failure happened before
                # the frame was written, so the per-op redirect-aware path
                # is safe for reads AND writes
                replies = []
                for i in idxs:
                    try:
                        replies.append(reroute_one(i))
                    except Exception as e:  # noqa: BLE001 — errors stay as data
                        replies.append(e)
            for i, r in zip(idxs, replies):
                if isinstance(r, RespError) and str(r).startswith(
                    ("MOVED ", "ASK ", "TRYAGAIN", "CLUSTERDOWN")
                ):
                    try:
                        r = reroute_one(i)
                    except Exception as e:  # noqa: BLE001
                        r = e
                results[i] = r

        if len(groups) <= 1:
            for addr, idxs in groups.items():
                run_group(addr, idxs)
        else:
            import concurrent.futures as _cf

            with _cf.ThreadPoolExecutor(max_workers=min(len(groups), 16)) as pool:
                futs = [pool.submit(run_group, a, idxs) for a, idxs in groups.items()]
                for f in futs:
                    f.result()
        return results

    def objcall_many_batch(
        self, ops, atomic: bool = False, timeout: Optional[float] = None
    ):
        """Cluster RemoteBatch flush: per-shard OBJCALLM grouping via
        objcall_many; atomic groups must colocate on ONE shard (the
        reference's cluster rule for REDIS_*_ATOMIC modes — use
        {hashtags}), shipped as a single OBJCALLMA frame to that owner."""
        wire_ops = [self._normalize_batch_op(op) for op in ops]
        if not atomic:
            return self.objcall_many(wire_ops, timeout=timeout)
        slots = {
            calc_slot(str(op[1]).encode()) for op in wire_ops if op[1]
        }
        if len(slots) > 1:
            raise RespError(
                "CROSSSLOT atomic batch spans multiple slots; use a {hashtag} "
                "to colocate every object of an atomic batch"
            )
        slot = slots.pop() if slots else None
        payload = safe_pickle.dumps(wire_ops)
        last: Optional[BaseException] = None
        for attempt in range(self.max_redirects + 1):
            entry = self.entry_for_slot(slot) if slot is not None else next(
                iter(self.entries()), None
            )
            if entry is None:
                raise ConnectionError_("no cluster entries")
            replies = _unwrap_many(
                entry.master.execute("OBJCALLMA", payload, self.caller_id(), timeout=timeout),
                self,
            )
            # a stale view bounces EVERY op with a routing error before any
            # applies (single-slot frame): refresh + full resend is safe.
            # Mixed results (some applied) must NOT resend — return as-is.
            routing_errs = [
                r for r in replies
                if isinstance(r, RespError)
                and str(r).startswith(("MOVED ", "ASK ", "TRYAGAIN", "CLUSTERDOWN"))
            ]
            if routing_errs and len(routing_errs) == len(replies):
                last = routing_errs[0]
                self.refresh_topology()
                time.sleep(min(0.05 * (attempt + 1), 0.5))
                continue
            return replies
        assert last is not None
        raise last

    def tx_groups(self, names):
        """Transaction commit grouping: one TXEXEC frame per slot owner
        (the per-MasterSlaveEntry grouping of the reference's commit batch,
        CommandBatchService executeBatchedAsync)."""
        with self._lock:
            slot_table = list(self._slots)
        groups: Dict[Optional[str], List[str]] = {}
        for n in names:
            slot = calc_slot(str(n).encode())
            groups.setdefault(slot_table[slot], []).append(n)
        return groups

    def txexec(
        self, group_key, versions, ops, timeout: Optional[float] = None
    ):
        """One commit frame straight to the owning master.  MOVED/ASK/
        TRYAGAIN raise to the caller (RemoteTransaction regroups after a
        topology refresh and retries — TXEXEC's whole-frame routing precheck
        guarantees a bounced frame applied nothing)."""
        entry = self._entries.get(group_key) if group_key is not None else None
        if entry is None:
            entry = next(iter(self.entries()), None)
        if entry is None:
            raise ConnectionError_("no cluster entries")
        reply = entry.master.execute(
            "TXEXEC", safe_pickle.dumps(versions), safe_pickle.dumps(ops),
            self.caller_id(), timeout=timeout,
        )
        return _unwrap_many(reply, self)

    def sync_replication(self, names, timeout: Optional[float] = None) -> None:
        """REPLFLUSH on every shard that owns one of `names` (syncSlaves)."""
        with self._lock:
            slot_table = list(self._slots)
            entries = dict(self._entries)
        addrs = {
            slot_table[calc_slot(str(n).encode())] for n in names if n
        }
        for addr in addrs:
            entry = entries.get(addr)
            if entry is not None:
                entry.master.execute("REPLFLUSH", timeout=timeout)

    def pubsub_for(self, name: str):
        """Channel subscriptions ride the shard that owns the channel's slot
        (SSUBSCRIBE semantics — RedissonShardedTopic analog)."""
        entry = self.entry_for_slot(calc_slot(name.encode()))
        return entry.master.pubsub()

    def publish_for(self, routing_name: str, channel, payload) -> int:
        """Publish on the exact node pubsub_for(routing_name) subscribed on —
        server pubsub hubs are node-local, so the publish and the
        subscription MUST land on the same master or fan-out silently drops
        (topic messages, local-cache invalidations)."""
        entry = self.entry_for_slot(calc_slot(routing_name.encode()))
        return int(entry.master.execute("PUBLISH", channel, payload) or 0)

    # -- object surface: inherited from RemoteSurface (same handle classes,
    #    routed through execute()/objcall()/pubsub_for() above) --------------

    def ping_all(self) -> Dict[str, bool]:
        out = {}
        for e in self.entries():
            try:
                out[e.address] = e.master.execute("PING") in (b"PONG", "PONG")
            except Exception:  # noqa: BLE001
                out[e.address] = False
        return out

    def shutdown(self) -> None:
        self._closed.set()
        # cancel element subscriptions FIRST (their daemon loops would
        # otherwise retry the closed cluster forever — same rule as the
        # single-node facade's shutdown)
        svc = self.__dict__.get("_elements_service")
        if svc is not None:
            svc.shutdown()
        plane = self.__dict__.get("tracking")
        if plane is not None:
            plane.close()
        self._stop_renewals()
        if self._dns is not None:
            self._dns.stop()
        with self._lock:
            for e in self._entries.values():
                e.close()
            self._entries.clear()
