"""FailoverCoordinator: the sentinel-role monitor for the port's clusters.

A copy of ``redisson_tpu/server/monitor.py``.  Detection is a periodic ping
with the failed-node thresholds of ``net/detectors.py``; recovery is the
sentinel's master switch: on a confirmed master death, promote a replica
(REPLICAOF NO ONE), rewrite the slot view on every surviving node (CLUSTER
SETVIEW), re-point sibling replicas.

Unlike Redis Sentinel there is no quorum vote: one coordinator owns the
decision (run it supervised; a standby can watch the same topology since
promotion is idempotent: SETVIEW is last-writer-wins and replicas of the old
master re-register against the promoted one).  :class:`HAFailoverCoordinator`
runs several, one leading under a fenced lease.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from redisson_tpu_torch.net.client import NodeClient
from redisson_tpu_torch.net.detectors import FailedConnectionDetector


class MonitoredMaster:
    def __init__(self, address: str, slot_range: Tuple[int, int], node_id: str):
        self.address = address
        self.slot_range = slot_range
        self.node_id = node_id
        # 3 failed pings in a short window = dead (the coordinator pings
        # every check_interval, so the window bounds detection latency)
        self.detector = FailedConnectionDetector(threshold=3, window_s=30.0)
        self.client = NodeClient(address, ping_interval=0, retry_attempts=0)
        self.replicas: List[str] = []


class FailoverCoordinator:
    """Watches the masters of one cluster view; promotes replicas on death."""

    def __init__(
        self,
        view: List[Tuple[int, int, str, int, str]],
        check_interval: float = 0.5,
        on_failover: Optional[Callable[[str, str], None]] = None,
        view_token: Optional[int] = None,
        known_nodes: Optional[List[str]] = None,
    ):
        self._masters: Dict[str, MonitoredMaster] = {}
        for lo, hi, host, port, nid in view:
            addr = f"{host}:{port}"
            self._masters[addr] = MonitoredMaster(addr, (lo, hi), nid)
        self.check_interval = check_interval
        self.on_failover = on_failover
        # leadership fencing token (HA mode): stamped on every SETVIEW so a
        # stale ex-leader's late writes are rejected server-side
        self.view_token = view_token
        # every address worth probing with ROLE when a dead master's replica
        # list is unknown — a SUCCESSOR coordinator (HA takeover) has no
        # poll history from before the death, so it must discover
        self.known_nodes = [a for a in (known_nodes or [])]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.failovers: List[Tuple[str, str]] = []  # (dead master, promoted)
        # dead masters with no promotable replica: their slot range is down
        # (CLUSTERDOWN) but NOT abandoned — the loop keeps pinging them and
        # retrying promotion, so a restarted master or a late replica
        # restores the range instead of leaving it orphaned forever
        self._pending: Dict[str, MonitoredMaster] = {}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "FailoverCoordinator":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="rtpu-failover"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for m in list(self._masters.values()) + list(self._pending.values()):
            m.client.close()

    # -- the check loop (scheduleClusterChangeCheck analog) -------------------

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval):
            for m in list(self._masters.values()):
                self._check(m)
            for m in list(self._pending.values()):
                self._check_pending(m)

    def _check_pending(self, m: MonitoredMaster) -> None:
        try:
            back = m.client.execute("PING", timeout=2.0) in (b"PONG", "PONG")
        except Exception:  # noqa: BLE001 — still down
            back = False
        if back:
            # the master itself returned: resume monitoring, and re-push the
            # view — an intervening failover's SETVIEW was built while this
            # range was pending and may have reached nodes that missed it
            self._pending.pop(m.address, None)
            m.detector.on_ping_successful()
            self._masters[m.address] = m
            self._push_view()
            return
        # still dead: a replica may have come (back) up — retry promotion
        self._failover(m)

    def _view_flat(self) -> List:
        """Current slot view INCLUDING pending (down but unreplaced) ranges —
        dropping a pending range from SETVIEW would orphan its slots on every
        node even after the master returns."""
        flat: List = []
        for m in list(self._masters.values()) + list(self._pending.values()):
            h, p = m.address.rsplit(":", 1)
            flat += [m.slot_range[0], m.slot_range[1], h, int(p), m.node_id]
        return flat

    def _setview_args(self) -> List:
        flat = self._view_flat()
        if self.view_token is not None:
            return ["TOKEN", self.view_token, *flat]
        return flat

    def _push_view(self) -> None:
        flat = self._setview_args()
        for m in list(self._masters.values()):
            try:
                m.client.execute("CLUSTER", "SETVIEW", *flat, timeout=5.0)
            except Exception:  # noqa: BLE001 — node will catch up on next push
                pass

    def _check(self, m: MonitoredMaster) -> None:
        try:
            reply = m.client.execute("PING", timeout=2.0)
            ok = reply in (b"PONG", "PONG")
        except Exception:  # noqa: BLE001 — unreachable counts as a failed ping
            ok = False
        if ok:
            m.detector.on_ping_successful()
            try:
                reps = m.client.execute("REPLICAS", timeout=2.0)
                m.replicas = [r.decode() if isinstance(r, bytes) else r for r in reps]
            except Exception:  # noqa: BLE001
                pass
            return
        m.detector.on_ping_failed()
        if m.detector.is_node_failed():
            self._failover(m)

    # -- promotion ------------------------------------------------------------

    def _discover_replicas(self, master_addr: str) -> List[str]:
        """ROLE-probe every known node for promotion candidates — the
        successor-coordinator path: it never polled the master alive.

        Two classes of candidate, slaves first:
          * a node reporting ROLE slave OF the dead master;
          * an unmonitored node reporting ROLE MASTER whose promoted-from
            breadcrumb (ROLE's 4th element) NAMES the dead master — the
            signature of a HALF-FINISHED failover (the predecessor ran
            REPLICAOF NO ONE, died before SETVIEW).  The breadcrumb check
            matters: without it a RESTARTED stale master (empty data, also
            unmonitored) would get adopted for a range it never replicated.
            Adopting converges the predecessor's work; the promotion
            command is idempotent on an already-master."""
        slaves: List[str] = []
        orphan_masters: List[str] = []
        monitored = set(self._masters) | set(self._pending)
        for addr in self.known_nodes:
            a = addr.split("://", 1)[-1]
            if a == master_addr or a in monitored:
                continue
            c = None
            try:
                c = NodeClient(a, ping_interval=0, retry_attempts=0)
                role = c.execute("ROLE", timeout=2.0)
                if role and bytes(role[0]) == b"slave":
                    host = role[1].decode() if isinstance(role[1], bytes) else role[1]
                    if f"{host}:{int(role[2])}" == master_addr:
                        slaves.append(a)
                elif role and bytes(role[0]) == b"master" and len(role) > 3:
                    promoted_from = (
                        role[3].decode() if isinstance(role[3], bytes) else role[3]
                    )
                    if promoted_from == master_addr:
                        orphan_masters.append(a)
            except Exception:  # noqa: BLE001 — node down/probing best-effort
                continue
            finally:
                if c is not None:
                    c.close()
        return slaves + orphan_masters

    def _failover(self, dead: MonitoredMaster) -> None:
        self._masters.pop(dead.address, None)
        if not dead.replicas:
            dead.replicas = self._discover_replicas(dead.address)
        promoted: Optional[str] = None
        for candidate in dead.replicas:
            c = None
            try:
                c = NodeClient(candidate, ping_interval=0, retry_attempts=0)
                c.execute("REPLICAOF", "NO", "ONE", timeout=10.0)
                promoted = candidate
                break
            except Exception:  # noqa: BLE001 — try the next replica
                continue
            finally:
                if c is not None:
                    c.close()
        if promoted is None:
            # no live replica: slot range is down (CLUSTERDOWN) but stays on
            # the pending list so a node restart can recover it (above)
            self._pending[dead.address] = dead
            return
        self._pending.pop(dead.address, None)
        dead.client.close()
        host, port = promoted.rsplit(":", 1)
        nm = MonitoredMaster(promoted, dead.slot_range, dead.node_id)
        nm.replicas = [r for r in dead.replicas if r != promoted]
        self._masters[promoted] = nm
        # rewrite the view everywhere (SETVIEW is last-writer-wins); pending
        # ranges stay in the view so their slots aren't orphaned
        self._push_view()
        # surviving replicas of the dead master re-attach to the promoted one
        setview = self._setview_args()
        for r in nm.replicas:
            rc = None
            try:
                rc = NodeClient(r, ping_interval=0, retry_attempts=0)
                rc.execute("CLUSTER", "SETVIEW", *setview, timeout=5.0)
                rc.execute("REPLICAOF", host, int(port), timeout=120.0)
            except Exception:  # noqa: BLE001
                continue
            finally:
                if rc is not None:
                    rc.close()
        self.failovers.append((dead.address, promoted))
        if self.on_failover is not None:
            try:
                self.on_failover(dead.address, promoted)
            except Exception:  # noqa: BLE001 — user callback must not kill the loop
                pass


class HAFailoverCoordinator:
    """Coordinator HA: run N of these; exactly one acts.

    Leadership rides the framework's own FencedLock over the cluster (the
    sentinel layer's tolerance of sentinel death, re-expressed with a lease
    instead of a quorum vote):
      * each instance loops trying the leader lock (client-side watchdog
        renews while alive; a crashed leader stops renewing and the lease
        lapses);
      * the winner gets a strictly monotonic FENCING token and runs a
        FailoverCoordinator stamping every SETVIEW with it; nodes reject
        lower-token views (registry CLUSTER SETVIEW TOKEN), so a paused
        ex-leader resuming after its lease lapsed cannot clobber its
        successor's topology;
      * standbys keep polling; promotion is idempotent, so the successor
        re-driving a half-finished failover converges.

    Known limitation (documented, like single-sentinel deployments): the
    leader lock lives on the cluster itself; if the shard owning the lock
    name is down, leadership cannot CHANGE until that range recovers — the
    incumbent keeps acting on its last-known lease.  Pin the lock to a
    well-replicated shard with a {hashtag} if that matters.
    """

    LOCK_NAME = "redisson:failover:leader"

    def __init__(
        self,
        view: List[Tuple[int, int, str, int, str]],
        seeds: List[str],
        check_interval: float = 0.5,
        lease: float = 3.0,
        on_failover: Optional[Callable[[str, str], None]] = None,
        lock_name: Optional[str] = None,
    ):
        self._view = list(view)
        self._seeds = list(seeds)
        self.check_interval = check_interval
        self.lease = lease
        self.on_failover = on_failover
        self.lock_name = lock_name or self.LOCK_NAME
        self._stop = threading.Event()
        self._release_on_stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._inner: Optional[FailoverCoordinator] = None
        self._client = None
        self.is_leader = threading.Event()
        self.token: Optional[int] = None
        # failover history survives demotion (an operator reading .failovers
        # after a lease loss must still see what happened on our watch)
        self._failover_log: List[Tuple[str, str]] = []
        self._log_lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "HAFailoverCoordinator":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="rtpu-ha-failover"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Graceful stop: releases leadership so a standby takes over fast.
        The unlock happens ON the _run thread (synchronizer identity is
        uuid:threadId — a cross-thread unlock would be rejected as a
        non-owner, silently degrading stop() into kill())."""
        self._release_on_stop.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._teardown()

    def kill(self) -> None:
        """Crash simulation: abandon WITHOUT unlocking — the lease must
        lapse before a standby can take over (chaos-test hook)."""
        self._stop.set()
        if self._inner is not None:
            self._inner.stop()
            self._inner = None
        if self._client is not None:
            try:
                self._client.shutdown()
            except Exception:  # noqa: BLE001
                pass
            self._client = None
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _teardown(self) -> None:
        # NO unlock here: the synchronizer identity is uuid:threadId, so
        # only the _run thread can release (stop() routes the unlock there)
        if self._inner is not None:
            self._inner.stop()
            self._inner = None
        self.is_leader.clear()
        if self._client is not None:
            try:
                self._client.shutdown()
            except Exception:  # noqa: BLE001
                pass
            self._client = None

    # -- leadership loop -------------------------------------------------------

    def _make_client(self):
        from redisson_tpu_torch.client.cluster import ClusterRedisson

        return ClusterRedisson(self._seeds, scan_interval=2.0, timeout=10.0)

    def _current_view(self) -> Optional[List[Tuple[int, int, str, int, str]]]:
        """The cluster's CURRENT slot view (CLUSTER SLOTS), or None when it
        cannot be fetched.  A successor leader MUST bootstrap from live
        state: monitoring a stale snapshot after a predecessor's completed
        failover would treat the promoted replica's range as still owned by
        the old (dead) master — and, armed with a newer fencing token,
        re-installing that stale map would make the pre-failover topology
        authoritative again.  So on failure the caller must NOT lead —
        better briefly leaderless than confidently wrong."""
        for _ in range(3):
            try:
                rows = self._client.execute("CLUSTER", "SLOTS", timeout=5.0)
                view = []
                for row in rows:
                    lo, hi, (host, port, nid) = int(row[0]), int(row[1]), row[2]
                    host = host.decode() if isinstance(host, bytes) else host
                    nid = nid.decode() if isinstance(nid, bytes) else nid
                    view.append((lo, hi, host, int(port), nid))
                if view:
                    return view
            except Exception:  # noqa: BLE001 — retry, then refuse to lead
                pass
            self._stop.wait(0.3)
        return None

    def _record_failover(self, dead: str, promoted: str) -> None:
        with self._log_lock:
            self._failover_log.append((dead, promoted))
        if self.on_failover is not None:
            try:
                self.on_failover(dead, promoted)
            except Exception:  # noqa: BLE001 — user callback must not kill us
                pass

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                if self._client is None:
                    self._client = self._make_client()
                # acquire + fencing token in ONE atomic server-side step
                # (two steps would let a lapse-and-steal between them hand
                # two leaders the same token).  EXPLICIT short lease, not
                # the 30s client watchdog: a crashed leader stops renewing
                # and the lease lapses within `lease` seconds.
                token = self._client.objcall(
                    "get_fenced_lock", self.lock_name,
                    "try_lock_and_get_token", (self.lease / 2, self.lease), {},
                )
                if token is None:
                    continue
            except Exception:  # noqa: BLE001 — cluster briefly away; retry
                if self._client is not None:
                    try:
                        self._client.shutdown()
                    except Exception:  # noqa: BLE001
                        pass
                    self._client = None
                self._stop.wait(min(1.0, self.lease / 2))
                continue
            try:
                self.token = int(token)
                view = self._current_view()
                if view is None:
                    # can't see live topology: refuse to lead on a stale
                    # snapshot — release (same thread = same holder id) and
                    # return to standby
                    try:
                        self._client.objcall(
                            "get_fenced_lock", self.lock_name, "unlock", (), {}
                        )
                    except Exception:  # noqa: BLE001 — lease will lapse
                        pass
                    self._stop.wait(min(1.0, self.lease / 2))
                    continue
                self._inner = FailoverCoordinator(
                    view,
                    check_interval=self.check_interval,
                    on_failover=self._record_failover,
                    view_token=self.token,
                    known_nodes=self._seeds,
                ).start()
                self.is_leader.set()
                # hold leadership: renew at lease/3.  Demotion triggers on a
                # clean False (someone else holds it) OR when no renewal has
                # SUCCEEDED within a full lease — a partitioned leader whose
                # renew calls all raise must stand down, not act forever on
                # a lease that lapsed (its unfenced REPLICAOF commands would
                # otherwise race the successor's)
                last_ok = time.time()
                while not self._stop.wait(self.lease / 3):
                    try:
                        if not self._client.objcall(
                            "get_fenced_lock", self.lock_name,
                            "renew_lease", (self.lease,), {},
                        ):
                            break
                        last_ok = time.time()
                    except Exception:  # noqa: BLE001 — transient unless stale
                        if time.time() - last_ok > self.lease:
                            break
                if self._stop.is_set() and self._release_on_stop.is_set():
                    # graceful stop: unlock FROM THIS THREAD (the holder
                    # identity is per-thread) so a standby takes over fast
                    try:
                        self._client.objcall(
                            "get_fenced_lock", self.lock_name, "unlock", (), {}
                        )
                    except Exception:  # noqa: BLE001 — lease will lapse anyway
                        pass
            except Exception:  # noqa: BLE001 — leadership bootstrap failed:
                # drop the (possibly broken) client and return to standby;
                # the thread must NEVER die silently, or this instance
                # leaves the HA pool forever
                if self._client is not None:
                    try:
                        self._client.shutdown()
                    except Exception:  # noqa: BLE001
                        pass
                    self._client = None
                self._stop.wait(min(1.0, self.lease / 2))
            finally:
                self.is_leader.clear()
                if self._inner is not None:
                    self._inner.stop()
                    self._inner = None

    # -- introspection ---------------------------------------------------------

    @property
    def failovers(self) -> List[Tuple[str, str]]:
        """Failovers performed on THIS instance's watch — survives demotion."""
        with self._log_lock:
            return list(self._failover_log)
