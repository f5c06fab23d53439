"""TpuServer: asyncio RESP server fronting one Engine ("the sidecar").

Role parity: the reference has no server (Redis is the server); this
build's data plane lives in THIS process next to the accelerator, so the
server is the piece that takes the Redis role for remote clients while the
Engine takes the command-execution role.

Connection discipline mirrors the reference's pipeline
(client/handler/RedisChannelInitializer.java:74-108): framed RESP in, ordered
execution per connection (the CommandsQueue FIFO guarantee), replies written
in arrival order, pubsub push frames interleaved from a writer queue.
Engine calls execute on a bounded thread pool so the event loop never blocks
on device dispatch.

A copy of the single-device path of ``redisson_tpu/server/server.py``, on
state that lives on ``device`` (the CUDA card unless the caller asks for the
CPU).  Every sketch verb reaches the port's hand kernels through the same
objects and coalescer the embedded path uses.

  * **Frames.** A pipelined frame dispatches every command first (handlers
    may return ``LazyReply``: kernels launched, results still on the card),
    then brings the frame's device results to the host in ONE grouped copy
    (``core/ioplane.gather_device_results``) and writes the replies in
    order.  A run of same-verb BF blob commands (``client/routing.py``
    ``coalescible_frame_runs``) is one fused kernel launch
    (``verbs/sketch.coalesce_bloom_run``).
  * **Frame boundaries.** The reference takes each 64 KiB read as a frame,
    so a pipelined run of blob commands larger than a read (config 5's
    80 KB BF.MADD64 blobs) never reaches the coalescer as a run.  Here a
    frame ends where a read ends on a command boundary: while a read stops
    inside a command, the server reads on (up to ``FRAME_READ_LIMIT``)
    before it dispatches.  Reply bytes are the same either way.  Latency
    is not: a complete command waits for the partial one behind it (a
    small command ahead of a 12 MB ``HLLA.MADD64`` blob waits for the whole
    blob, where the reference dispatches it at once), and a frame grown so
    may be classed bulk by the QoS plane where the reference's pieces were
    interactive.  Reading on only while the frame holds nothing but BF blob
    commands keeps the reference's framing for mixed frames, but then a
    client that writes a long pipeline before it reads a reply (config 2's
    window of 50 ``BFA.MEXISTS64`` frames) stalls: the frames dispatch one
    by one, their unread replies fill the socket, the writer task waits,
    the dispatch-ahead bound stops the read loop, and the client's write
    never ends.
  * **Overlap.** With the overlap plane on, a frame's readback runs as a
    future the connection's writer task drains (FIFO, so reply order and
    framing are untouched) while the read loop dispatches the next frame.
    The readback waits on an event recorded behind its own copy, never on
    the whole device.  ``--no-overlap`` restores the serial shape.
  * **QoS** (``server/scheduler.py``): frames are classified interactive or
    bulk, charged against their tenant's token bucket (over budget: -BUSY
    before dispatch), and bulk frames pass a bounded admission gate.
    ``--no-qos`` / ``RTPU_NO_QOS=1`` restores arrival-order dispatch.

One difference from the reference, visible only when the device fails: the
reference re-dispatches a fused contains run command by command after ANY
failure of the fused launch.  Here only an ineligible run
(``core/coalesce.CoalesceIneligible``, or a precheck of
``coalesce_bloom_run``) takes the per-command route, since that is the
designed case; any other failure of a fused run, contains or add, replies a
per-command ``ERR internal`` (``-TRYAGAIN`` for a retryable fault shape)
and counts in ``stats["errors"]``, so a failing kernel is never hidden
behind a slower path that might succeed.

**The device-fault domain** (reference ``:95-101``, ``:1181-1187``,
``:1357-1361``, ``:1438-1443``, ``:1522-1525``, ``:1559-1564``): a keyed
command, coalesced run or position bucket bound for a QUARANTINED lane
replies ``-TRYAGAIN device <id> quarantined; retry after evacuation``
without dispatching, and a retryable device fault
(``ioplane.is_retryable_device_fault``: a failed CUDA launch, the lane
watchdog's timeout) replies ``-TRYAGAIN device fault during dispatch;
retry``; the connection lives.  One more difference: a launch failure as a
coalesced run's or a bucket's occupancy is taken (the chaos plane's
dispatch chokepoint) replies each of its commands the error, where the
reference's frame raises and drops the connection.  ``pause``/``resume``
are the chaos plane's pause gate (the SIGSTOP analog): a paused server
parks every dispatch, bounded at 60 s.

  * **Blocking verbs** (``_SLOW_COMMANDS``: BLPOP, BRPOP, BLMOVE,
    BRPOPLPUSH, BZPOPMIN, BZPOPMAX, BLMPOP, BZMPOP, XREAD and XREADGROUP,
    and OBJCALL, OBJCALLM, OBJCALLMA, OBJCALLV, TXEXEC and EXEC, which may
    run a parking object method or wait on the exec mutex) dispatch on a
    wide slow pool, so a parked waiter never holds a worker of the pool
    every connection shares; inside a frame a blocking verb keeps its place
    in the reply order.  ``stop()`` sets ``_closing``, which the wait loops
    (``verbs/common._block_loop`` and XREAD/XREADGROUP BLOCK in
    ``verbs/streamgeo``) poll: every parked waiter unparks.
  * **Search.** FT.SEARCH and FT.MSEARCH KNN queries launch the vector
    kernels (``knn_score``, ``knn_select``, ``ivf_score``) on the engine's
    device and reply through ``LazyReply``, so their results ride the
    frame's grouped readback; an IVF field trains its centroids with the
    k-means kernels on the same device.

  * **Cluster mode.** A node that holds a cluster view (``CLUSTER
    SETVIEW``, installed by ``harness.ClusterRunner`` or the process
    ``cluster.ClusterSupervisor`` through ``cluster/topology.py``) checks
    every keyed command before it dispatches (``check_routing``, called by
    the registry, by OBJCALLM/EXEC/TXEXEC and by the coalesced BF run):
    a slot it does not own replies ``MOVED <slot> <host>:<port>``.  A
    replica (REPLICAOF, ``server/replication.py``) serves READONLY reads
    of its master's slots and refuses writes.
  * **Live slot migration** (``server/migration.py`` drives it): CLUSTER
    SETSLOT opens a MIGRATING window on the source and an IMPORTING one on
    the target; an absent key in a MIGRATING slot replies ``ASK``, a
    multi-key command split across the window ``TRYAGAIN``, and the
    store's absent guard (``_migration_absent_guard``) closes the race with
    the drain.  ``migrate_slot_batch`` ships records in batches of
    ``DRAIN_BATCH_RECORDS`` by IMPORTRECORDS, each under its records' locks,
    and deletes them here once the target acks.  With ``journal_dir`` the
    target journals every batch before it acks (``ImportJournal``), and a
    restarted node re-arms its windows and replays its journals at boot
    (RECOVERING slots reply TRYAGAIN until the migration settles).

The port serves the connection, keyspace, sketch, objcall_tx (OBJCALL,
OBJCALLM, OBJCALLMA, OBJCALLV, MULTI, DISCARD, WATCH, UNWATCH, RESET, EXEC
and TXEXEC), collections, zset, streamgeo (X*, GEO*) and modules (JSON.*,
FT.*) verb families, admin's script and function verbs (EVALSHA, EVAL,
SCRIPT, FCALL, FCALL_RO, FUNCTION), and the cluster view verbs (CLUSTER
SLOTS, MYID, INFO, SETVIEW, RESET, COUNTKEYSINSLOT, GETKEYSINSLOT, and
ASKING), the migration verbs (CLUSTER SETSLOT, WINDOWS, MIGRATESLOT,
MIGRATESLOTS, and IMPORTRECORDS), the node-info verbs (TIME, INFO,
MEMORY), the device-placement verbs (CLUSTER DEVICES, DEVMOVE), the
observability verbs (ROLE, METRICS, TRACE, SLOWLOG, LATENCY) and the
durability verbs (SAVE, BGSAVE, BGREWRITEAOF, LASTSAVE, SHUTDOWN,
RESTORESTATE, DUMP, RESTORE, COPY) (``server/verbs``).

  * **Positions** (``devices=``, ``--devices``): the 16384-slot table maps
    onto that many mesh positions (``server/placement.py``; ``"all"``: the
    local positions, ``parallel/mesh.local_devices``), each record is owned
    by its slot's position, and a pipelined frame splits by the placement
    plan (``SlotPlacement.plan_frame``): "sharded" segments run one bucket a
    position on the worker pool at once, each under its position's lane
    (``core/ioplane.DeviceLane``: dispatches bound for one position
    serialize, for different positions overlap), "serial" segments run in
    frame order as barriers; replies keep frame order.  A frame's
    single-position commands and coalesced runs on the sequential path hold
    their position's lane as well.  Positions on one card share its stream
    (``core/ioplane.py`` says why).
  * **Preemptible sub-windows** (reference ``server/server.py:1383-1630``):
    with preemption armed (``--no-preempt`` / ``RTPU_NO_PREEMPT=1``
    disarm it) and ``qos-bulk-subwindow-items`` set, a bulk coalesced run
    on a lane, or a position's bucket of a sharded frame, splits at
    command (or coalesced-run) boundaries into chunks of at most that many
    items (``core/coalesce.plan_subwindows``; one oversized command keeps
    its own chunk).  Each chunk is its own lane occupancy, waits for its
    kernels before it lets the lane go (``ioplane.wait_device``: a launch
    returns before the kernel runs, and an interactive kernel launched
    behind a running chunk would wait for it on the card's one stream),
    and ``lane.preempt_point()`` sits between chunks.  A failed chunk
    replies per-command errors and is never re-dispatched; earlier chunks
    stay applied (at most once a sub-window).  Replies are the unsplit
    dispatch's bytes, in frame order.
  * **CONFIG** (``config_view``/``config_set``, reference ``:483-680``):
    the knobs of the planes the port has, the ``qos-*`` knobs,
    ``checkpoint-path``, ``residency-enabled``, ``device-budget-bytes``,
    ``lane-watchdog-ms`` and ``lane-quarantine-after`` among them.
  * **Residency** (``core/residency.py``): ``enable_residency`` arms the
    HOT/WARM/COLD plane with the slot fences wired in (a migrating,
    importing or recovering slot never demotes); the CLI's
    ``--residency`` arms it at boot and ``--no-tier`` pins the getter
    guard disarmed for the process's life, as ``RTPU_NO_TIER=1`` does;
    the ``residency`` METRICS family carries the per-tier rows.
  * **Durability** (``core/checkpoint.py``): ``checkpoint_path`` (the CLI's
    ``--checkpoint``, with ``--restore`` at boot and
    ``--checkpoint-interval`` for an ``AutoCheckpointer`` that flushes on a
    graceful stop) is the default path of SAVE, BGSAVE, SHUTDOWN and
    RESTORESTATE.
  * **Tracing** (``observe/trace.py``): a traced frame records ``qos``,
    ``dispatch``, ``readback`` and ``reply`` spans; a frame dispatched
    under a position's lane records the lane-gate wait as ``stage`` and the
    occupancy as ``dispatch`` (``core/ioplane._LaneOccupancy``), as the
    reference's does.  TRACE, SLOWLOG, LATENCY and METRICS read them.

Replication (``server/replication.py``): REPLICAOF, the REPL* verbs and
WAIT; ``replication_source()`` is the master's lazy shipper, closed by
``stop``.  ``--prewarm`` warms the restored records' kernels at boot
(``core/warmpool.py``).

``--retry-profile lan|wan`` sets the link retry cadence of the node's
cluster-internal connections (``net/retry.py``'s ``LINK_PROFILES``).
"""
from __future__ import annotations

import asyncio
import functools
import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from redisson_tpu_torch.client import routing as _routing
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core.coalesce import plan_subwindows, runs_within_admission
from redisson_tpu_torch.core.engine import Engine
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.net.resp import ProtocolError, RespError
from redisson_tpu_torch.observe import trace as _obs
from redisson_tpu_torch.server import scheduler as _sched
from redisson_tpu_torch.server.registry import (
    REGISTRY,
    CommandContext,
    LazyReply,
    gather_lazy_device_results,
)


class _Encoded:
    """Pre-encoded wire frame (errors encoded at catch time)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data


class _PendingFrame:
    """A frame whose readback is still in flight (overlap plane): the
    per-connection writer task awaits `fut` (the executor job forcing the
    frame's LazyReplies), then encodes and writes the replies — while the
    connection's read loop is already dispatching the NEXT frame.  `proto`
    is the connection's negotiated protocol AT DISPATCH time: a later
    frame's HELLO must not re-encode earlier replies.  `trace` is the
    frame's FrameTrace when tracing is armed, else None."""

    __slots__ = ("results", "fut", "proto", "trace")

    def __init__(self, results: list, fut, proto: int, trace=None):
        self.results = results
        self.fut = fut
        self.proto = proto
        self.trace = trace

    def encoded(self) -> bytes:
        return _encode_frame(self.results, self.proto)


class _TracedEncoded:
    """Pre-encoded frame bytes carrying their FrameTrace (tracing armed
    only): the writer task writes `data` and closes the trace's `reply`
    span, making the trace total the true client-observable latency."""

    __slots__ = ("data", "trace")

    def __init__(self, data: bytes, trace):
        self.data = data
        self.trace = trace


# the most bytes one frame reads past its first read while the last read
# stopped inside a command (see TpuServer._handle)
FRAME_READ_LIMIT = 64 << 20

# Commands whose handlers may PARK the worker thread (blocking verbs hold it
# for up to their timeout; OBJCALL runs arbitrary object methods incl.
# poll_blocking and lock waits; EXEC and TXEXEC wait on the exec mutex and
# record locks; XREAD and XREADGROUP park for their BLOCK time; WAIT parks
# until its replica count or timeout).  Dispatched on the wide slow pool so
# the shared dispatch pool never starves.
_SLOW_COMMANDS = frozenset(
    b.encode() for b in (
        "OBJCALL", "OBJCALLM", "OBJCALLMA", "OBJCALLV", "TXEXEC", "EXEC",
        "BLPOP", "BRPOP", "BLMOVE", "BRPOPLPUSH", "BZPOPMIN", "BZPOPMAX",
        "BLMPOP", "BZMPOP", "XREAD", "XREADGROUP", "WAIT",
    )
)

# the reference's fixed -TRYAGAIN texts: byte-identical whichever layer
# detects the fault and whether the chaos plane is armed or not
_DEVICE_FAULT_TRYAGAIN = "TRYAGAIN device fault during dispatch; retry"


def _quarantined_tryagain(dev_id: int) -> str:
    return f"TRYAGAIN device {dev_id} quarantined; retry after evacuation"


def _error_reply(e: BaseException) -> bytes:
    """The encoded per-command error of a failed dispatch."""
    if isinstance(e, RespError):
        return resp.encode_error(str(e.args[0]))
    if ioplane.is_retryable_device_fault(e):
        return resp.encode_error(_DEVICE_FAULT_TRYAGAIN)
    return resp.encode_error(f"ERR internal: {type(e).__name__}: {e}")


def _force_lazies(results: list, server, trace=None) -> None:
    """Materialize every LazyReply of a frame in place.  Device-form lazies
    come to the host in one grouped transfer (if it fails, each of them
    replies the error and counts in ``stats["errors"]``); callable-form
    lazies force individually.  `trace` (tracing armed only) is activated on this worker
    thread so the readback span recorded inside the gather lands on the
    right frame."""
    if trace is not None:
        _obs.set_current(trace)

    def fail(i, e):
        server.stats["errors"] += 1
        results[i] = _Encoded(_error_reply(e))

    try:
        dev_idx = [
            i for i, r in enumerate(results)
            if isinstance(r, LazyReply) and r.device is not None
        ]
        if dev_idx:
            try:
                host_vals = gather_lazy_device_results([results[i] for i in dev_idx])
            except Exception as e:  # noqa: BLE001 — the frame's one readback failed
                # every device reply of the frame replies the error: no
                # per-reply copies that might hide a failing device
                for i in dev_idx:
                    fail(i, e)
            else:
                for i, vals in zip(dev_idx, host_vals):
                    try:
                        results[i] = results[i].finish(vals)
                    except Exception as e:  # noqa: BLE001 — per-reply isolation
                        fail(i, e)
        for i, r in enumerate(results):
            if isinstance(r, LazyReply):
                try:
                    results[i] = r.force()
                except Exception as e:  # noqa: BLE001 — per-reply isolation
                    fail(i, e)
    finally:
        if trace is not None:
            _obs.clear_current()


class TpuServer:
    def __init__(
        self,
        engine: Optional[Engine] = None,
        host: str = "127.0.0.1",
        port: int = 6390,
        password: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        mode: str = "standalone",
        workers: int = 4,
        tls_cert_file: Optional[str] = None,
        tls_key_file: Optional[str] = None,
        tls_ca_file: Optional[str] = None,
        users: Optional[Dict[str, str]] = None,
        overlap: Optional[bool] = None,
        devices=None,
        qos: Optional[bool] = None,
        dispatch_ahead: Optional[int] = None,
        journal_dir: Optional[str] = None,
        advertise_host: Optional[str] = None,
        device="cuda",
    ):
        self.engine = engine if engine is not None else Engine(device=device)
        # device-sharded serving: `devices` maps the 16384-slot table onto
        # that many mesh positions ("all": every local position).  None (the
        # default) is the single-device server; an engine whose placement
        # is already enabled is left as configured.
        if devices is not None and self.engine.placement is None:
            n = None if devices in ("all", "ALL") else int(devices)
            self.engine.enable_placement(n_devices=n)
        self.started_at = time.time()
        # overlapped device I/O plane: frames with device-form lazy replies
        # hand their readback to the per-connection writer task instead of
        # blocking the read loop.  None = follow the process-global switch;
        # False = the serial A/B reference (--no-overlap).
        self.overlap = ioplane.overlap_enabled() if overlap is None else bool(overlap)
        # dispatch-ahead bound: at most this many frames may sit between
        # "dispatched" and "replies written" per connection (bounds device
        # memory held by un-drained readbacks); default 2
        self.readback_ahead = (
            2 if dispatch_ahead is None else max(1, int(dispatch_ahead))
        )
        # chaos pause gate (the SIGSTOP analog): cleared = every dispatch
        # parks on it; clients see reply timeouts, not dropped connections
        self._pause_gate = threading.Event()
        self._pause_gate.set()
        # deadline classes + per-tenant QoS (server/scheduler.py); None =
        # follow the process-global switch (RTPU_NO_QOS=1 disarms)
        self.scheduler = _sched.WindowScheduler(enabled=qos)
        if self.scheduler.bulk_slots <= 0:
            # reserve one dispatch slot for interactive traffic: bulk-class
            # frames across ALL connections share workers-1 admission slots
            self.scheduler.bulk_slots = max(1, workers - 1)
        self._bulk_gate: Optional[asyncio.Semaphore] = None
        self._bulk_gate_n = 0
        self.host = host
        self.port = port
        # the address this node IS in cluster views: a cross-host node binds
        # 0.0.0.0 but is named in views and its READY line by its routable
        # address; without the split, owns_slot never matches and the node
        # MOVED-bounces its own slots forever.  None = the bind host.
        self.advertise_host = advertise_host
        self.password = password
        # SAVE / SHUTDOWN / RESTORESTATE default path (core/checkpoint.py);
        # CONFIG SET checkpoint-path changes it at run time
        self.checkpoint_path = checkpoint_path
        # ACL users (username -> password): AUTH user pass
        # (BaseConnectionHandler.java:59-122).  "default" aliases `password`.
        self.users: Dict[str, str] = dict(users or {})
        # TLS: cert+key enable the listener's TLS; ca_file additionally
        # REQUIRES client certificates (mTLS)
        self.tls_cert_file = tls_cert_file
        self.tls_key_file = tls_key_file
        self.tls_ca_file = tls_ca_file
        self.mode = mode
        self.node_id = uuid.uuid4().hex
        # replica_reads / replica_redirects_stale / replica_fallbacks count
        # the replica read path (a replica serves and refuses reads);
        # METRICS carries them as the reference's does
        self.stats = {"connections": 0, "commands": 0, "errors": 0, "sheds": 0,
                      "replica_reads": 0, "replica_redirects_stale": 0,
                      "replica_fallbacks": 0}
        # observability (utils/metrics.py): per-command timers + counters;
        # hooks = NettyHook-analog SPI
        from redisson_tpu_torch.net.client import dropped_push_count
        from redisson_tpu_torch.tracking.table import TrackingTable
        from redisson_tpu_torch.utils.metrics import MetricsHook, MetricsRegistry

        self.metrics = MetricsRegistry()
        self.hooks = [MetricsHook(self.metrics)]
        self.metrics.gauge("keys", lambda: len(self.engine.store))
        self.metrics.gauge("connections", lambda: self.stats["connections"])
        # tracing plane (observe/trace.py): the process tracer, disarmed by
        # default; set_tracing(True) / RTPU_TRACE=1 arms it.  Stage-duration
        # histograms feed THIS registry (stage.* timers).
        self.tracer = _obs.TRACER
        self.tracer.registry = self.metrics
        self.metrics.gauge(
            "trace_ring_entries",
            lambda: self.tracer.census()["trace_ring_entries"],
        )
        self.metrics.gauge(
            "trace_inflight",
            lambda: self.tracer.census()["trace_inflight"],
        )
        self.metrics.gauge("dropped_pushes", dropped_push_count)
        self.metrics.gauge("qos_shed_ops", lambda: self.scheduler.shed_ops)
        self.metrics.gauge("qos_shed_frames", lambda: self.scheduler.shed_frames)
        self.metrics.gauge(
            "qos_interactive_inflight_ops",
            lambda: self.scheduler.ledger.ops["interactive"],
        )
        self.metrics.gauge(
            "qos_bulk_inflight_ops", lambda: self.scheduler.ledger.ops["bulk"]
        )
        self.metrics.gauge("qos_bulk_waiting", lambda: self.scheduler.ledger.waiting)
        self._client_ids = iter(range(1, 1 << 62))
        # server-assisted client tracking (tracking/table.py): per-connection
        # read-key memory + RESP3 invalidation pushes on write/expiry/
        # FLUSHALL.  Always constructed (cheap); the dispatch hook costs one
        # int load while no client has tracking on.
        self.tracking = TrackingTable(self)
        self.metrics.gauge("tracking_keys", self.tracking.tracked_key_count)
        self.metrics.gauge(
            "tracking_overflow_evictions",
            lambda: self.tracking.stats["overflow_evictions"],
        )
        self.metrics.gauge("tracking_pushes", lambda: self.tracking.stats["pushes"])
        # cluster_view: [(slot_from, slot_to, host, port, node_id)] when this
        # node is part of a cluster (CLUSTER SETVIEW, cluster/topology.py)
        self.cluster_view: List[Tuple[int, int, str, int, str]] = []
        # highest accepted SETVIEW fencing token: a stale coordinator's late
        # view write carries a lower token and is refused (STALEVIEW)
        self.view_epoch: int = 0
        # live slot migration windows (slot -> "host:port"), set by CLUSTER
        # SETSLOT and read by check_routing
        self.migrating_slots: Dict[int, str] = {}
        self.importing_slots: Dict[int, str] = {}
        # the crash-recovery fence: slots whose journaled migration was in
        # flight when THIS process last died (rearm_recovery at boot).
        # Until resume_migrations settles the journal, every keyed command
        # on them replies TRYAGAIN: the restored copies may be stale against
        # what the pre-crash drain already shipped
        self.recovering_slots: Dict[int, str] = {}
        # per-slot migration fencing: the highest epoch a journaled
        # coordinator stamped on the slot.  A re-send at the same epoch is
        # accepted (the idempotent redo), a lower one is a stale
        # coordinator's late write and replies STALEEPOCH
        self.slot_epochs: Dict[int, int] = {}
        # the ACTIVE journaled epoch per MIGRATING slot (set by SETSLOT
        # MIGRATING ... EPOCH n): the drain stamps it on every outgoing
        # IMPORTRECORDS so the target journals the batch before it acks.
        # Distinct from slot_epochs, the high-water mark, which would
        # attribute a later unjournaled migration's batches to a settled
        # journal
        self.migrating_epochs: Dict[int, int] = {}
        # the import side's journals: the shared journal directory
        # (--journal-dir, which ClusterSupervisor passes every node) and the
        # OPEN import journals by epoch
        self.journal_dir = journal_dir
        self._import_journals: Dict[int, Any] = {}
        self._import_journal_lock = threading.Lock()
        # -- cluster / replication role (server/replication.py) -------------
        self.role = "master"  # "master" | "replica"
        self.master_address: Optional[str] = None
        # the bounded-staleness stamp: the highest sweep-cut offset this
        # REPLICA applied (a REPLPUSH payload's stamp or a REPLPING), the
        # master's wall clock at that cut, and the LOCAL monotonic receipt
        # time: staleness is measured against the local receipt, so clock
        # skew between hosts can never fake freshness
        self.repl_applied_offset = 0
        self.repl_applied_ts = 0.0
        self.repl_applied_at: Optional[float] = None
        # set on REPLICAOF NO ONE: the master this node replicated before
        # (ROLE's breadcrumb for coordinators adopting half-finished
        # failovers)
        self.promoted_from: Optional[str] = None
        self._replication = None  # the lazy ReplicationSource (master side)
        self._repl_lock = threading.Lock()
        # REPLPUSHSEG staging: xfer_id -> [chunk slots, last-touch monotonic]
        self._repl_xfers: Dict[str, list] = {}
        self._repl_xfers_lock = threading.Lock()
        # resumable REPLSNAPSHOT staging: xfer_id -> [blob, chunk_bytes,
        # last-touch monotonic], one immutable cut a replica FETCHes by
        # offset, reaped by staleness
        self._snap_stages: Dict[str, list] = {}
        self._snap_lock = threading.Lock()
        self._snap_seq = 0
        # expiry invalidation: a key the TTL reaper (or a lazy-expiry read)
        # drops must invalidate near caches exactly like a DEL would
        self.engine.store.on_expired = self.tracking.note_expired
        # the embedding-bank census as one labeled gauge family: the totals
        # (ftvec_banks, ftvec_device_bytes, ftvec_index_bytes) and the
        # ftvec_*_bytes_dev<N> rows a position, which exist only while the
        # position holds bank bytes (FT.DROPINDEX takes a shard's row away)
        self.metrics.multi_gauge("ftvec", self._ftvec_census)
        # per-device record bytes over every record kind: record_bytes_dev<N>
        # totals and record_bytes_dev<N>_<kind> rows, present only while the
        # device holds bytes (reference ``_device_bytes_census``)
        self.metrics.multi_gauge("devbytes", self._device_bytes_census)
        # the residency plane's per-tier rows (residency_bytes_dev<N>_{hot,
        # warm,cold}) and its counters: rows exist only while a manager is
        # armed and the tier holds bytes, so DEL drains them
        self.metrics.multi_gauge("residency", self._residency_census)
        for name in ("replica_reads", "replica_redirects_stale", "replica_fallbacks"):
            self.metrics.gauge(name, lambda name=name: self.stats[name])
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="rtpu-srv")
        self._workers = workers
        # reserved interactive dispatch capacity: frames the scheduler
        # classifies interactive run HERE, so a bulk flood holding every
        # shared worker can never queue ahead of them (threads spawn lazily)
        self._qos_pool = ThreadPoolExecutor(
            max_workers=max(2, workers), thread_name_prefix="rtpu-qos"
        )
        # OBJCALL handle cache (ordered for LRU eviction; see
        # verbs/objcall_tx._objcall_resolve)
        from collections import OrderedDict

        self._objcall_handles: "OrderedDict" = OrderedDict()
        self._objcall_handles_lock = threading.Lock()
        # blocking verbs park their worker, and OBJCALL may run arbitrarily
        # blocking object methods (blocking queues, latches, locks):
        # isolate them on a wide pool so parked callers can't starve the
        # data-plane workers (the reference marks such commands
        # isBlockingCommand and gives them dedicated connections)
        self._slow_pool = ThreadPoolExecutor(max_workers=64, thread_name_prefix="rtpu-slow")
        # set by stop(): parked blocking verbs poll it to unpark
        self._closing = False
        # the CLI serve loop's stop event: SHUTDOWN ends the process too
        self._serve_stopped: Optional[asyncio.Event] = None
        # EXEC transactions serialize (see cmd_exec: handlers may take record
        # locks beyond the precomputed key set)
        self._exec_mutex = threading.Lock()
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._writers: set = set()
        self._local_client = None

    # -- registry support ----------------------------------------------------

    def next_client_id(self) -> int:
        return next(self._client_ids)

    def local_client(self):
        """Embedded client over this server's engine."""
        if self._local_client is None:
            from redisson_tpu_torch.client.redisson import RedissonTpu

            self._local_client = RedissonTpu(self.engine)
        return self._local_client

    # -- cluster routing ---------------------------------------------------------

    def cluster_slots(self) -> List[Any]:
        """CLUSTER SLOTS reply shape: [from, to, [host, port, id]]."""
        if not self.cluster_view:
            return [[0, 16383,
                     [self.public_host.encode(), self.port,
                      self.node_id.encode()]]]
        return [
            [lo, hi, [h.encode(), p, nid.encode()]]
            for (lo, hi, h, p, nid) in self.cluster_view
        ]

    @property
    def public_host(self) -> str:
        """The host this node is KNOWN BY (views, READY line): the
        advertised address when bind and routable addresses differ
        (cross-host nodes binding 0.0.0.0), else the bind host."""
        return self.advertise_host or self.host

    def address(self) -> str:
        return f"{self.public_host}:{self.port}"

    def owns_slot(self, slot: int) -> bool:
        if not self.cluster_view:
            return True
        for lo, hi, h, p, _nid in self.cluster_view:
            if lo <= slot <= hi:
                if (h, p) == (self.public_host, self.port):
                    return True
                # a replica serves READS for its master's range (the READONLY
                # connection mode of Redis cluster replicas); writes are
                # rejected separately by the role check in check_routing
                return self.role == "replica" and self.master_address == f"{h}:{p}"
        return False  # unassigned slot: treat as not owned

    def moved_target(self, slot: int) -> Optional[Tuple[str, int]]:
        for lo, hi, h, p, _nid in self.cluster_view:
            if lo <= slot <= hi:
                return h, p
        return None

    def check_routing(self, cmd: str, args: List[bytes], asking: bool = False,
                      readonly: bool = False) -> None:
        """MOVED/ASK + READONLY enforcement (the server half of the
        reference's redirect protocol, cluster/ClusterConnectionManager +
        command/RedisExecutor redirect handling).

        Migration window semantics (Redis slot-migration model):
          * slot MIGRATING here: keys still present serve locally; absent
            keys redirect ASK to the draining target (they either moved
            already or must be created there);
          * slot IMPORTING here: normally MOVED back to the source (the view
            still names it), but a command preceded by ASKING is served.

        Replica read admission (Redis parity): a CLUSTER replica serves
        keyed reads only to connections that armed READONLY — everyone
        else is MOVED to the master (writes get the -READONLY refusal
        below).
        """
        from redisson_tpu_torch.net import commands as C
        from redisson_tpu_torch.utils.crc16 import calc_slot

        if self.cluster_view:
            migrating_absent = migrating_present = 0
            ask_target = None
            replica_read = False
            for key in C.command_keys(cmd, args):
                slot = calc_slot(key)
                if slot in self.recovering_slots:
                    # interrupted-migration fence: neither the restored
                    # local copy nor an ASK hop is safe until the journal
                    # resume settles the slot
                    raise RespError(
                        f"TRYAGAIN slot {slot} recovering from an "
                        "interrupted migration"
                    )
                if self.owns_slot(slot):
                    if self.role == "replica" and not C.is_write(cmd, args):
                        if not readonly:
                            # keyed reads without READONLY bounce to the
                            # master
                            self.stats["replica_fallbacks"] += 1
                            ma = self.master_address
                            if ma:
                                raise RespError(f"MOVED {slot} {ma}")
                        else:
                            replica_read = True
                    target = self.migrating_slots.get(slot)
                    if target is not None:
                        name = key.decode() if isinstance(key, bytes) else key
                        if self.engine.store.peek(name):
                            migrating_present += 1
                        else:
                            migrating_absent += 1
                            ask_target, ask_slot = target, slot
                    continue
                if asking and slot in self.importing_slots:
                    continue  # one-shot admission during the handoff window
                target = self.moved_target(slot)
                if target is not None:
                    raise RespError(f"MOVED {slot} {target[0]}:{target[1]}")
                raise RespError(f"CLUSTERDOWN Hash slot {slot} not served")
            if migrating_absent:
                if migrating_present:
                    # mixed present/absent across a migration window: neither
                    # node holds every key right now (Redis TRYAGAIN)
                    raise RespError(
                        "TRYAGAIN Multiple keys request during rehashing of slot"
                    )
                raise RespError(f"ASK {ask_slot} {ask_target}")
            if replica_read:
                self.stats["replica_reads"] += 1
        if self.role == "replica" and C.is_write(cmd, args):
            raise RespError("READONLY You can't write against a read only replica.")

    # -- live slot migration (server side) -----------------------------------

    def _migration_absent_guard(self, name: str) -> None:
        """DeviceStore absent-name hook: any touch of an ABSENT record in a
        MIGRATING slot redirects to the target.  This closes the races the
        pre-dispatch ASK check cannot: a record the drain deletes between
        check_routing and the handler would otherwise be silently recreated
        here (lost acked write) or read as nil (read-your-writes violation)."""
        from redisson_tpu_torch.utils.crc16 import calc_slot

        slot = calc_slot(name.encode())
        target = self.migrating_slots.get(slot)
        if target is not None:
            raise RespError(f"ASK {slot} {target}")

    def fence_slot_epoch(self, slot: int, epoch: Optional[int]) -> None:
        """Accept-or-reject a migration-control command's fencing epoch for
        one slot.  Epoch-less commands (legacy callers, manual admin) pass
        unfenced; an epoch below the highest accepted one is a stale
        coordinator's late write and is refused loudly."""
        if epoch is None:
            return
        cur = self.slot_epochs.get(slot, 0)
        if epoch < cur:
            raise RespError(
                f"STALEEPOCH slot {slot} fenced at epoch {cur}; got {epoch}"
            )
        self.slot_epochs[slot] = epoch

    def set_slot_migrating(self, slot: int, target: str,
                           epoch: Optional[int] = None) -> None:
        self.migrating_slots[slot] = target
        if epoch is not None:
            # journaled drain: outgoing IMPORTRECORDS carry this epoch so
            # the target journals each batch before acking
            self.migrating_epochs[slot] = epoch
        self.engine.store.absent_guard = self._migration_absent_guard

    def set_slot_importing(self, slot: int, source: str) -> None:
        self.importing_slots[slot] = source

    def set_slot_recovering(self, slot: int, target: str,
                            epoch: Optional[int] = None) -> None:
        self.recovering_slots[slot] = target
        # fence-first invalidation (the case Redis gets wrong-by-config): a
        # RECOVERING slot's restored copies may be stale against what the
        # pre-crash drain already shipped — every near cache drops the
        # slot's keys BEFORE the slot serves anything again, stamped with
        # THIS handoff's fencing epoch (the caller's, NOT the recorded
        # slot_epochs high-water mark: an epoch-less handoff of a slot a
        # PREVIOUS journaled migration fenced would otherwise be deduped
        # against that stale record and emit nothing) so the resume
        # re-send is idempotent
        # slot_names is a full store scan — only pay it when a tracking
        # client could actually hear the invalidation (rearm_recovery calls
        # this per in-flight slot BEFORE serving; with tracking idle the
        # boot path must stay O(1))
        self.tracking.invalidate_slot(
            slot, epoch,
            self.slot_names(slot) if self.tracking.active else None,
        )

    def set_slot_stable(self, slot: int, epoch: Optional[int] = None) -> None:
        migrated = slot in self.migrating_slots or slot in self.recovering_slots
        self.migrating_slots.pop(slot, None)
        self.importing_slots.pop(slot, None)
        self.recovering_slots.pop(slot, None)  # resume settled the journal
        self.migrating_epochs.pop(slot, None)
        if not self.migrating_slots:
            self.engine.store.absent_guard = None
        self._settle_import_journals(epoch)
        if migrated:
            # handoff finalized on the SOURCE: whatever the per-key drain
            # stream didn't already invalidate (keys read-but-absent, keys
            # registered after their ship) flushes here, stamped with THIS
            # command's epoch — None (unfenced legacy migration) always
            # emits, a journaled re-send at its own epoch dedupes
            self.tracking.invalidate_slot(slot, epoch)

    # -- import-side journal (the target-kill durability gap) -----------------

    def journal_import_batch(self, epoch: int, source: Optional[str],
                             blob: bytes) -> None:
        """Make one accepted IMPORTRECORDS batch durable (fsync'd into this
        node's ImportJournal) BEFORE it is applied or acked — the source
        deletes a record only once its batch survives a SIGKILL here.  A
        batch arriving for an epoch whose journal is already terminal is a
        stale re-ship of a settled migration: applied (idempotent by
        version) but not re-journaled — terminal journals stay terminal."""
        from redisson_tpu_torch.server.migration_journal import ImportJournal

        if self.journal_dir is None:
            return
        with self._import_journal_lock:
            j = self._import_journals.get(epoch)
            if j is None:
                j = ImportJournal.open_for(
                    self.journal_dir, self.address(), epoch, source=source
                )
                if j.is_terminal():
                    return
                self._import_journals[epoch] = j
            j.append_batch(blob)

    def adopt_import_journal(self, journal) -> None:
        """Boot-time re-adoption (migration.rearm_recovery): a replayed
        in-flight import journal stays open on the restarted node so the
        resumed migration's final SETSLOT STABLE settles it."""
        with self._import_journal_lock:
            self._import_journals[journal.epoch] = journal

    def import_journal_rows(self) -> List[Tuple[int, str, int, str]]:
        """(epoch, phase, batches journaled, source) per OPEN import
        journal — the CLUSTER WINDOWS rows that let an operator see an
        in-flight import from the receiving end."""
        with self._import_journal_lock:
            return [
                (epoch, j.phase or "", j.batch_count(), j.source or "")
                for epoch, j in sorted(self._import_journals.items())
            ]

    def _settle_import_journals(self, epoch: Optional[int]) -> None:
        """Terminalize the import journal for `epoch` once its migration's
        LAST window slot goes STABLE (no remaining MIGRATING/IMPORTING/
        RECOVERING slot fenced at that epoch) — after which gc may prune it
        and a restart no longer replays it."""
        if epoch is None or not self._import_journals:
            return

        def _settleable() -> bool:
            j = self._import_journals.get(epoch)
            if j is None:
                return False
            open_slots = (
                set(self.importing_slots) | set(self.migrating_slots)
                | set(self.recovering_slots)
            )
            # still a window in flight for this migration? not settleable
            return not any(
                self.slot_epochs.get(s) == epoch for s in open_slots
            )

        with self._import_journal_lock:
            if not _settleable():
                return
        # durability point OUTSIDE the lock: a concurrent drain's
        # journal-and-ack (journal_import_batch) must not stall behind a
        # full-store snapshot and time its source's link out
        if not self._checkpoint_import_state():
            return  # not durable yet: keep the journal for boot replay
        with self._import_journal_lock:
            if not _settleable():  # a re-opened window raced the save
                return
            self._import_journals.pop(epoch).append("STABLE", settled=True)

    def _checkpoint_import_state(self) -> bool:
        """Make the imported records as durable as this node's normal
        story BEFORE an import journal retires: the journal holds the only
        durable copy of batches whose source copies are already deleted,
        so it may only terminalize once a checkpoint covers them — else a
        SIGKILL after STABLE but before the next snapshot would restore a
        pre-import checkpoint with nothing left to replay.  A node with no
        checkpoint configured has no durability floor to wait for.
        Returns False (journal kept in flight, replayed at next boot) when
        the save fails."""
        if self.checkpoint_path is None:
            return True
        from redisson_tpu_torch.core import checkpoint

        try:
            checkpoint.save(self.engine, self.checkpoint_path)
            self.__dict__["_lastsave"] = int(time.time())
            return True
        except Exception:  # noqa: BLE001 — keep the journal instead
            return False

    def slot_names(self, slot: int) -> List[str]:
        from redisson_tpu_torch.utils.crc16 import calc_slot

        return [
            n for n in self.engine.store.keys() if calc_slot(n.encode()) == slot
        ]

    # records shipped per IMPORTRECORDS frame during drains: a journaled
    # target fsyncs ONCE per frame, so batch coalescing divides the
    # journal-before-ack cost by the batch width
    DRAIN_BATCH_RECORDS = 32

    def migrate_slot_batch(self, slots, limit: int = 0,
                           batch: Optional[int] = None) -> int:
        """Drain MIGRATING slot(s) to their targets; limit<=0 drains fully.

        Records ship in BATCHES of `batch` (default DRAIN_BATCH_RECORDS)
        per IMPORTRECORDS frame, grouped by (target, epoch).  The whole
        batch's record locks are held (sorted order — deadlock-free) across
        serialize -> IMPORTRECORDS -> local delete, the same atomicity the
        per-record path had: every mutation path (object handles AND the
        store-level DEL/EXPIRE commands) takes these locks, so no client
        write, delete, or expire can interleave between the snapshot
        leaving and the local copies dying — the zero-lost-acked-writes
        contract holds for deletes too (a DEL either lands before the
        snapshot, keeping the record out of the batch, or blocks until the
        name is locally absent and then ASK-redirects to the target).
        Redis gets the same guarantee from MIGRATE's single-threaded
        blocking; we pay it per-batch instead of per-server.  A journaled
        target fsyncs its ImportJournal ONCE per frame (journal-before-ack
        and the pre-ack replica cover are per-frame contracts — both hold
        unchanged), so the batch width directly divides the durability
        overhead the import journal adds.
        """
        from redisson_tpu_torch.net.client import NodeClient
        from redisson_tpu_torch.utils.crc16 import calc_slot

        if isinstance(slots, int):
            slots = [slots]
        targets: Dict[int, str] = {}
        for s in slots:
            t = self.migrating_slots.get(s)
            if t is None:
                raise RespError(f"ERR slot {s} is not MIGRATING")
            targets[s] = t
        wanted = set(targets)
        names = [
            (n, calc_slot(n.encode()))
            for n in self.engine.store.keys()
            if calc_slot(n.encode()) in wanted
        ]
        if limit and limit > 0:
            names = names[:limit]
        if not names:
            return 0
        if batch is None or batch <= 0:
            batch = self.DRAIN_BATCH_RECORDS
        # group by (target, epoch) preserving scan order: one frame may
        # carry records of MANY slots, but never records bound for
        # different targets or fenced at different epochs
        groups: Dict[Tuple[str, Optional[int]], List[str]] = {}
        for name, slot in names:
            key = (targets[slot], self.migrating_epochs.get(slot))
            groups.setdefault(key, []).append(name)
        moved = 0
        links: Dict[str, NodeClient] = {}
        try:
            for (target, ep), gnames in groups.items():
                link = links.get(target)
                if link is None:
                    link = links[target] = self.link_client(
                        target, ping_interval=0, retry_attempts=1
                    )
                for i in range(0, len(gnames), batch):
                    moved += self._drain_batch_locked(
                        link, ep, gnames[i : i + batch]
                    )
        finally:
            for link in links.values():
                link.close()
        return moved

    def _drain_batch_locked(self, link, ep: Optional[int],
                            names: List[str]) -> int:
        """Ship one drain batch under ALL its record locks (sorted
        acquisition; serialize_records re-enters each per-record RLock)."""
        from redisson_tpu_torch.server import replication

        with self.engine.locked_many(names):
            present = [n for n in names if self.engine.store.peek(n)]
            if not present:
                return 0  # expired/deleted meanwhile
            blob, shipped = replication.serialize_records(
                self.engine, present, include_live=False
            )
            if not shipped:
                return 0
            if ep is not None:
                # journaled migration: the target fsyncs the whole frame
                # into its ImportJournal BEFORE this ack — the local
                # deletes below are then safe against a target SIGKILL,
                # at ONE fsync per batch
                link.execute(
                    "IMPORTRECORDS", "EPOCH", ep, "SOURCE",
                    self.address(), blob, timeout=30.0,
                )
            else:
                link.execute("IMPORTRECORDS", blob, timeout=30.0)
            shipped_names = [n for n, _nonce, _ver in shipped]
            for name in shipped_names:
                self.engine.store.delete_unguarded(name)
            # drain-stream invalidation: the records just left this node —
            # a near cache serving them would miss every write the target
            # accepts from now on (push enqueue only, so holding the locks
            # here is fine); active-guarded like every other site so an
            # idle-tracking migration never touches the dispatch-shared
            # table lock
            if self.tracking.active:
                self.tracking.note_write(shipped_names, None)
            return len(shipped_names)

    # -- dispatch --------------------------------------------------------------

    def _fused_add_error_invalidate(self, track, run_names) -> None:
        """A failed fused BF.MADD64 run may have PARTIALLY applied (that is
        why add runs never re-dispatch) — tracked near caches holding
        negative `contains` entries for these filters must still be
        invalidated or they serve stale membership forever.  writer_ctx is
        None deliberately: the writer's client-side wrapper aborted on the
        error reply, so even a NOLOOP writer needs the push."""
        if track is not None and run_names:
            try:
                track.note_write(run_names, None)
            except Exception:  # noqa: BLE001 — never mask the primary error
                pass

    # -- chaos hooks (fault plane, server layer) ------------------------------

    def pause(self) -> None:
        """Stop answering commands without dropping connections (the
        SIGSTOP/GC-pause analog).  Paused workers park on the gate; clients
        observe reply timeouts, feeding FailedCommandsTimeoutDetector."""
        self._pause_gate.clear()

    def resume(self) -> None:
        self._pause_gate.set()

    @property
    def paused(self) -> bool:
        return not self._pause_gate.is_set()

    def _pause_wait(self) -> None:
        if not self._pause_gate.is_set():
            # bounded so a forgotten resume() degrades to a long stall, not
            # a permanently wedged worker pool
            self._pause_gate.wait(timeout=60.0)

    def _failed(self, e: BaseException, n: int = 1) -> _Encoded:
        """The per-command error reply of a dispatch unit of `n` commands
        that raised `e` (worker pool shut down -> drop the connection)."""
        if isinstance(e, RuntimeError) and "shutdown" in str(e):
            raise ConnectionResetError(str(e)) from e
        # a real CUDA failure of the handler counts on the lane it ran under
        ioplane.note_raised_fault(e, ioplane.current_position())
        self.stats["errors"] += n
        return _Encoded(_error_reply(e))

    def _dispatch_one(self, ctx, cmd):
        """One command with the per-command error translation of the
        connection loop (RespError -> its reply, worker pool shut down ->
        drop the connection, anything else sandboxed per command)."""
        self._pause_wait()
        try:
            return REGISTRY.dispatch(self, ctx, cmd)
        except ConnectionResetError:
            raise
        except Exception as e:  # noqa: BLE001 — sandbox handler bugs per-command
            return self._failed(e)

    def _dispatch_bloom_run(self, ctx, cmds):
        """Coalesced execution of a same-verb BF blob run inside one frame:
        ONE stacked-bank kernel launch for the whole run instead of one per
        command, per-command LazyReplies riding the frame's single readback.
        Only an ineligible run falls back to per-command dispatch (identical
        semantics); a failure of the fused launch replies per-command
        errors, for contains runs as for add runs (see the module
        docstring)."""
        from redisson_tpu_torch.server.verbs.sketch import coalesce_bloom_run

        self._pause_wait()
        cur = _obs.current_trace() if _obs._tracer is not None else None
        k0 = time.monotonic() if cur is not None else 0.0
        is_add = bytes(cmds[0][0]).upper() == b"BF.MADD64"
        # tracking hooks for the fused path (the fallback below dispatches
        # through REGISTRY.dispatch, which carries its own hooks): probe runs
        # register their filter names PRE-dispatch, add runs invalidate after
        # the fused kernel applied
        track = self.tracking if self.tracking.active else None
        run_names = None
        if track is not None:
            seen = set()
            run_names = [
                n for n in (bytes(c[1]).decode() for c in cmds)
                if not (n in seen or seen.add(n))
            ]
            if not is_add:
                track.note_read(ctx, run_names)
        try:
            fused = coalesce_bloom_run(self, ctx, cmds)
        except Exception as e:  # noqa: BLE001 — per-run isolation
            if isinstance(e, RuntimeError) and "shutdown" in str(e):
                # a stopping worker pool drops the connection, never replies
                # per-command errors
                raise ConnectionResetError(str(e)) from e
            if is_add:
                self._fused_add_error_invalidate(track, run_names)
            ioplane.note_raised_fault(e, ioplane.current_position())
            self.stats["errors"] += len(cmds)
            enc = _Encoded(_error_reply(e))
            return [enc for _ in cmds]
        if fused is not None:
            if cur is not None:
                # coalescer fan-in: ONE kernel span for the fused run, its
                # member commands recorded as child spans sharing the
                # kernel's interval (bounded so a 1000-command blob run
                # cannot bloat the trace)
                k1 = time.monotonic()
                cur.add_span(
                    "kernel", k0, k1,
                    verb=bytes(cmds[0][0]).upper().decode(),
                    members=len(cmds),
                )
                for c in cmds[:32]:
                    cur.add_span(
                        "kernel.member", k0, k1,
                        key=bytes(c[1]).decode(errors="replace"),
                    )
            if track is not None and is_add:
                track.note_write(run_names, ctx)
            return fused
        return [self._dispatch_one(ctx, cmd) for cmd in cmds]

    def _dispatch_traced(self, fn, ctx, arg, trace=None, span=True):
        """Run one dispatch unit (a command, a coalesced run or a position's
        bucket) on a worker thread with `trace` (tracing armed only) current
        there, so the spans recorded deep inside it (lane gates, readbacks)
        land on the frame.  With `span` the handler window is the frame's
        `dispatch` span; the lane wrappers pass span=False, since a lane's
        occupancy records `stage` and `dispatch` (and a laneless dispatch
        its own, ``_timed``)."""
        if trace is None:
            return fn(ctx, arg)
        _obs.set_current(trace)
        try:
            return self._timed(fn, ctx, arg) if span else fn(ctx, arg)
        finally:
            _obs.clear_current()

    @staticmethod
    def _timed(fn, ctx, arg):
        """fn(ctx, arg), its window recorded as the `dispatch` span of this
        thread's frame trace (tracing armed only)."""
        trace = _obs.current_trace()
        if trace is None:
            return fn(ctx, arg)
        t0 = time.monotonic()
        try:
            return fn(ctx, arg)
        finally:
            trace.add_span("dispatch", t0, time.monotonic())

    def _ftvec_census(self) -> dict:
        """The embedding banks' census rows from the search service, zeros
        while it does not exist (a scrape does not create it)."""
        svc = self.engine._services.get("search")
        zeros = {"ftvec_banks": 0.0, "ftvec_device_bytes": 0.0,
                 "ftvec_index_bytes": 0.0}
        if svc is None:
            return zeros
        try:
            # observe-only: a scrape never faults a demoted bank back in (a
            # WARM bank reports 0 device bytes, which is what it holds)
            from redisson_tpu_torch.core import residency as _res

            with _res.no_promote():
                return svc.device_census()
        except Exception:  # noqa: BLE001 — a broken gauge must not kill the scrape
            return zeros

    def _device_bytes_census(self) -> dict:
        """One store scan summing each record's tensors by (device index,
        kind); a sharded plane spans positions and counts on none (the
        reference's multi-device arrays), a CPU tensor counts as device 0
        (the reference's one CPU device)."""
        import torch

        by_dev: dict = {}
        by_kind: dict = {}
        with self.engine.store._lock:
            records = [(r.kind, r) for r in self.engine.store._states.values() if not r.expired()]
        for kind, rec in records:
            for arr in list(rec.arrays.values()):
                if not isinstance(arr, torch.Tensor):
                    continue
                n = float(arr.numel() * arr.element_size())
                if n <= 0.0:
                    continue
                d = arr.device.index or 0
                by_dev[d] = by_dev.get(d, 0.0) + n
                by_kind[(d, kind)] = by_kind.get((d, kind), 0.0) + n
        out: dict = {}
        for d, v in sorted(by_dev.items()):
            out[f"record_bytes_dev{d}"] = v
        for (d, kind), v in sorted(by_kind.items()):
            out[f"record_bytes_dev{d}_{kind}"] = v
        return out

    def _residency_census(self) -> dict:
        """The residency plane's rows: empty while no manager is armed, so
        the family adds nothing to a scrape."""
        mgr = self.engine.residency
        if mgr is None:
            return {}
        try:
            return mgr.census()
        except Exception:  # noqa: BLE001 — a broken gauge must not kill the scrape
            return {}

    def _residency_fence_check(self, name: str) -> bool:
        """True when ``name``'s slot is mid-migration on this node: the
        demoter never touches a record the fenced mover is about to
        snapshot."""
        if not (self.migrating_slots or self.importing_slots
                or self.recovering_slots):
            return False
        from redisson_tpu_torch.utils.crc16 import calc_slot

        slot = calc_slot(name.encode())
        return (slot in self.migrating_slots
                or slot in self.importing_slots
                or slot in self.recovering_slots)

    def enable_residency(self, **kw) -> None:
        """Arm the residency plane with the server's fences wired in (CONFIG
        SET residency-enabled yes, the --residency boot path).  Under
        RTPU_NO_TIER=1 or --no-tier this is a refused no-op end to end: a
        manager whose sweeper demotes while the getter guard stays disarmed
        would strand WARM records with no fault-in path."""
        from redisson_tpu_torch.core import residency as _res

        if _res._NO_TIER:
            return
        self.engine.enable_residency(**kw)
        self.engine.residency.fence_check = self._residency_fence_check
        _res.set_tier(True)

    # -- per-position lanes (device-sharded serving) ---------------------------

    def _lane_for(self, cmds):
        """The one position lane every key of `cmds` maps to, else None
        (no placement, keyless or mixed-position: no occupancy gate)."""
        eng = self.engine
        if eng.placement is None or eng.lanes is None:
            return None
        dev = None
        for cmd in cmds:
            d = eng.placement.device_index_for_command(cmd)
            if d is None or (dev is not None and d != dev):
                return None
            dev = d
        if dev is None:
            return None
        return eng.lanes.lane(eng.placement.devices[dev])

    def _occupancy_gate(self, cmds, qos_class: Optional[str] = None):
        """Lane-occupancy context for one sequential-path dispatch (a
        command or a coalesced run): the owning position's lane when every
        key maps to one position, else None.  Dispatches from concurrent
        connections bound for different positions overlap, same-position
        ones serialize."""
        lane = self._lane_for(cmds)
        if lane is None:
            return None
        if lane.quarantined:
            # a QUARANTINED lane rejects new keyed work retryably while its
            # slots evacuate or await a probe: never a dispatch into a
            # faulted device stream
            raise RespError(_quarantined_tryagain(lane.dev_id))
        return self._chunk_occupancy(lane, cmds, qos_class)

    def _dispatch_laned(self, ctx, cmd, qos_class: Optional[str] = None):
        """_dispatch_one under the command's lane (when it has one).  A
        quarantined lane, or a launch failure as the occupancy is taken,
        replies the command's error (-TRYAGAIN)."""
        try:
            gate = self._occupancy_gate((cmd,), qos_class)
            if gate is None:
                return self._timed(self._dispatch_one, ctx, cmd)
            with gate:
                return self._dispatch_one(ctx, cmd)
        except ConnectionResetError:
            raise
        except Exception as e:  # noqa: BLE001 — the gate's failure is the reply
            return self._failed(e)

    def _subwindow_target(self, qos_class: Optional[str]) -> int:
        """The bulk sub-window item target of one dispatch: > 0 only with
        preemption armed, splitting set, and a dispatch that is not
        interactive (interactive frames dispatch whole)."""
        if qos_class == "interactive" or not ioplane.preempt_enabled():
            return 0
        return ioplane.bulk_subwindow_items()

    @staticmethod
    def _chunk_occupancy(lane, cmds, qos_class: Optional[str]):
        """`lane`'s occupancy for dispatching `cmds` (their items and, with
        the scheduler armed, their class and bytes on its ledger)."""
        return lane.occupy(
            _sched.estimate_device_items(cmds), qos_class=qos_class,
            nbytes=_sched._frame_nbytes(cmds) if qos_class is not None else 0,
        )

    @staticmethod
    def _lane_torch_device(lane):
        return getattr(lane.device, "device", lane.device)

    def _dispatch_bloom_run_laned(self, ctx, cmds, qos_class: Optional[str] = None):
        """_dispatch_bloom_run under the run's lane; a run whose filters
        span positions takes no gate (the coalescer refuses such a run and
        it dispatches command by command).  An oversized bulk run splits
        into sub-windows (the module docstring): each chunk a complete
        fused dispatch with its own occupancy, a preemption point between
        chunks, replies extended in frame order."""
        lane = self._lane_for(cmds)
        if lane is None:
            return self._timed(self._dispatch_bloom_run, ctx, cmds)
        if lane.quarantined:
            # per-command retryable rejection: the run never dispatched,
            # so at-most-once holds trivially
            self.stats["errors"] += len(cmds)
            enc = _Encoded(resp.encode_error(_quarantined_tryagain(lane.dev_id)))
            return [enc for _ in cmds]
        target = self._subwindow_target(qos_class)
        plan = None
        if target > 0:
            plan = plan_subwindows([_sched.estimate_command_items(c) for c in cmds], target)
        if plan is None or len(plan) < 2:
            plan = [(0, len(cmds))]
        dev = self._lane_torch_device(lane)
        out = []
        for k, (a, b) in enumerate(plan):
            if k:
                lane.preempt_point()
            sub = cmds[a:b]
            out.extend(self._laned_unit(
                lane, sub, qos_class,
                lambda sub=sub: self._dispatch_bloom_run(ctx, sub),
                dev if len(plan) > 1 else None))
        return out

    def _laned_unit(self, lane, cmds, qos_class, run, dev=None) -> list:
        """`run()` (the replies of `cmds`) under one occupancy of `lane`,
        waiting for its kernels on `dev` before the lane goes when given
        (a sub-window).  A launch failure as the occupancy is taken (the
        chaos plane's dispatch chokepoint) replies each command the error:
        nothing was dispatched, so nothing is re-dispatched either (the
        reference drops the connection here)."""
        try:
            occupancy = self._chunk_occupancy(lane, cmds, qos_class)
            occupancy.__enter__()
        except ConnectionResetError:
            raise
        except Exception as e:  # noqa: BLE001 — the unit's reply
            enc = self._failed(e, len(cmds))
            return [enc for _ in cmds]
        try:
            out = run()
            if dev is not None:
                ioplane.wait_device(dev)
            return out
        finally:
            occupancy.__exit__(None, None, None)

    def _dispatch_device_bucket(self, ctx, items, dev_index: int,
                                qos_class: Optional[str] = None):
        """One position's ordered slice of a pipelined frame (a plan_frame
        "sharded" segment), on a worker thread while the other positions'
        buckets run on theirs, under the position's lane.  Same-verb BF blob
        runs inside the bucket still coalesce.  Returns [(frame index,
        result), ...].  An oversized bulk bucket splits into sub-windows as a
        coalesced run does (``_dispatch_bloom_run_laned``)."""
        self._pause_wait()
        eng = self.engine
        lane = eng.lanes.lane(eng.placement.devices[dev_index]) if eng.lanes is not None else None
        if lane is not None and lane.quarantined:
            # the whole bucket rejects retryably in frame position; the
            # other positions' buckets still serve
            self.stats["errors"] += len(items)
            enc = _Encoded(resp.encode_error(_quarantined_tryagain(lane.dev_id)))
            return [(i, enc) for i, _c in items]
        cmds = [c for _i, c in items]
        run_at: Dict[int, int] = (
            dict(_routing.coalescible_frame_runs(cmds)) if len(cmds) > 1 else {}
        )

        def dispatch_all(lo: int, hi: int) -> list:
            replies = []
            ci = lo
            while ci < hi:
                run_end = run_at.get(ci)
                if run_end is not None:
                    replies.extend(self._dispatch_bloom_run(ctx, cmds[ci:run_end]))
                    ci = run_end
                    continue
                replies.append(self._dispatch_one(ctx, cmds[ci]))
                ci += 1
            return replies

        if lane is None:
            return list(zip((i for i, _c in items), dispatch_all(0, len(cmds))))
        # sub-windows: segments cut at dispatch-unit boundaries (one
        # coalesced run or one command), so a fused add run is never split
        target = self._subwindow_target(qos_class)
        segs = None
        if target > 0:
            units: List[Tuple[int, int]] = []
            ci = 0
            while ci < len(cmds):
                units.append((ci, run_at.get(ci, ci + 1)))
                ci = units[-1][1]
            plan = plan_subwindows(
                [_sched.estimate_device_items(cmds[a:b]) for a, b in units], target)
            if len(plan) > 1:
                segs = [(units[lo][0], units[hi - 1][1]) for lo, hi in plan]
        if segs is None:
            segs = [(0, len(cmds))]
        dev = self._lane_torch_device(lane) if len(segs) > 1 else None
        replies = []
        for k, (a, b) in enumerate(segs):
            if k:
                lane.preempt_point()
            replies.extend(self._laned_unit(
                lane, cmds[a:b], qos_class,
                lambda a=a, b=b: dispatch_all(a, b), dev))
        return list(zip((i for i, _c in items), replies))

    async def _run_frame_sharded(self, ctx, commands, plan, loop, adm=None, trace=None):
        """Execute one pipelined frame under a placement plan: "sharded"
        segments fan their per-position buckets out on the worker pool at
        once (each bucket FIFO on its lane: per-key order holds because a
        key maps to one position), "serial" segments run in frame order as
        barriers.  Replies go by frame index whatever the completion
        order."""
        qos_class = adm.qos_class if adm is not None else None
        pool = self._pool_for(adm)
        results: list = [None] * len(commands)
        for seg_kind, seg in plan:
            if seg_kind == "serial":
                for i in seg:
                    cmd = commands[i]
                    self.stats["commands"] += 1
                    if not isinstance(cmd, list) or not all(
                        isinstance(a, (bytes, bytearray)) for a in cmd
                    ):
                        results[i] = _Encoded(resp.encode_error("ERR bad request frame"))
                        continue
                    cmd_pool = self._slow_pool if bytes(cmd[0]).upper() in _SLOW_COMMANDS else pool
                    results[i] = await loop.run_in_executor(
                        cmd_pool, self._dispatch_traced, self._dispatch_one, ctx, cmd, trace,
                    )
                continue
            jobs = []
            for dev_index, idxs in seg.items():
                self.stats["commands"] += len(idxs)
                bucket = functools.partial(self._dispatch_device_bucket,
                                           dev_index=dev_index, qos_class=qos_class)
                jobs.append(loop.run_in_executor(
                    pool, self._dispatch_traced,
                    bucket, ctx, [(i, commands[i]) for i in idxs], trace, False,
                ))
            outs = await asyncio.gather(*jobs, return_exceptions=True)
            err = next((o for o in outs if isinstance(o, BaseException)), None)
            if err is not None:
                raise err
            for out in outs:
                for i, r in out:
                    results[i] = r
        return results

    def _frame_plan(self, ctx, commands, shed_mask):
        """The placement plan of a pipelined frame, or None (the plain
        sequential loop): placement on, no MULTI queue, authenticated, no
        ASKING, nothing shed, more than one command."""
        if (
            self.engine.placement is None
            or ctx.multi_queue is not None
            or not ctx.authenticated
            or getattr(ctx, "asking", False)
            or shed_mask is not None
            or len(commands) < 2
        ):
            return None
        # with the modelled occupancy armed, even a one-position frame runs
        # the lane path, so both legs of an A/B run the same code
        return self.engine.placement.plan_frame(
            commands, single_device_ok=ioplane.replica_occupancy() is not None,
        )

    def _pool_for(self, adm):
        """Worker pool for one frame's dispatch: interactive-class frames
        (scheduler armed) run on the reserved interactive pool so a bulk
        flood occupying every shared worker can never queue ahead of them;
        everything else keeps the shared pool."""
        if adm is not None and adm.interactive:
            return self._qos_pool
        return self._pool

    # -- QoS admission ---------------------------------------------------------

    def _bulk_gate_for(self, slots: int) -> Optional[asyncio.Semaphore]:
        """The server-wide bulk admission gate: at most `slots` bulk-class
        frames may be in dispatch at once across ALL connections, so a bulk
        flood can never occupy every worker ahead of interactive traffic."""
        if slots <= 0:
            return None
        gate = self._bulk_gate
        if gate is None or self._bulk_gate_n != slots:
            gate = self._bulk_gate = asyncio.Semaphore(slots)
            self._bulk_gate_n = slots
        return gate

    async def _serve_frame(self, ctx, commands, loop, write_q,
                           readback_slots, alive, trace=None) -> bool:
        """Admit + dispatch ONE parsed frame (the read loop's per-frame
        body).  Returns False when the connection must stop reading (writer
        task dead).  With the scheduler armed the frame is classified
        (interactive/bulk) and charged against its tenant's token bucket
        BEFORE anything dispatches: over-budget commands shed with -BUSY,
        bulk frames pass the bounded bulk admission gate, and the frame's
        dispatch is accounted on the per-class in-flight ledger.  `trace`
        (tracing armed only) records admit + bulk-gate wait as the frame's
        `qos` span."""
        sched = self.scheduler
        adm = None
        bulk_gate = None
        acquired = begun = False
        tq0 = time.monotonic() if trace is not None else 0.0
        if (
            sched.armed
            and commands
            and ctx.authenticated
            and ctx.multi_queue is None
        ):
            adm = sched.admit(ctx, commands)
            if adm.shed_count:
                self.stats["sheds"] += adm.shed_count
        fully_shed = (
            adm is not None
            and adm.shed_mask is not None
            and all(adm.shed_mask)
        )
        try:
            if adm is not None:
                # a FULLY-refused frame never dispatches (its replies are
                # pure encodes), so it must not occupy a bulk admission slot
                if not adm.interactive and not fully_shed:
                    bulk_gate = self._bulk_gate_for(sched.bulk_slots)
                    if bulk_gate is not None:
                        sched.ledger.wait_enter()
                        try:
                            await bulk_gate.acquire()
                            acquired = True
                        finally:
                            sched.ledger.wait_exit()
                sched.begin(adm)
                begun = True
                if trace is not None:
                    trace.qos_class = adm.qos_class
                    trace.tenant = adm.tenant
                    trace.add_span(
                        "qos", tq0, time.monotonic(),
                        tenant=adm.tenant, cls=adm.qos_class,
                        items=adm.items, shed=adm.shed_count,
                    )
            ok = await self._dispatch_frame(
                ctx, commands, loop, write_q, readback_slots, alive, adm,
                trace,
            )
        finally:
            if begun:
                sched.end(adm)
            if acquired:
                bulk_gate.release()
        if ok and fully_shed and sched.shed_penalty_ms > 0:
            # fully-refused frame: park THIS connection's read loop for the
            # shed penalty, so a client spinning on -BUSY cannot turn the
            # cheap shed path into a parse-plane DoS
            await asyncio.sleep(sched.shed_penalty_ms / 1000.0)
        return ok

    async def _dispatch_frame(self, ctx, commands, loop, write_q,
                              readback_slots, alive, adm=None,
                              trace=None) -> bool:
        # Two-phase frame execution: dispatch every command of the
        # pipelined frame first (handlers may return LazyReply — kernels
        # launched, NOT waited for), then force all lazy replies together
        # and write the replies in order.  One device->host copy per frame
        # instead of per command; per-connection ordering is untouched
        # (dispatch stays sequential, and the device stream is in-order).
        # Same-verb BF blob RUNS additionally collapse into one fused kernel
        # launch each (_dispatch_bloom_run; runs never cross a verb change,
        # so frame order is preserved exactly).
        shed_mask = adm.shed_mask if adm is not None else None
        shed_enc = (
            resp.encode_error(_sched.busy_error(adm.tenant))
            if shed_mask is not None else None
        )
        pool = self._pool_for(adm)
        plan = self._frame_plan(ctx, commands, shed_mask)
        if plan is not None:
            results = await self._run_frame_sharded(ctx, commands, plan, loop, adm, trace)
            return await self._finish_frame(ctx, results, loop, write_q, readback_slots,
                                            alive, pool, trace)
        qos_class = adm.qos_class if adm is not None else None
        # the dispatch units, chosen once a frame: with placement off, the
        # plain ones (no lane to look up per command), each its own
        # `dispatch` span; with it on, the lane wrappers, whose occupancy
        # records `stage` and `dispatch`
        if self.engine.placement is None:
            unit = self._dispatch_traced
            run_fn, one_fn = self._dispatch_bloom_run, self._dispatch_one
        else:
            unit = functools.partial(self._dispatch_traced, span=False)
            run_fn = functools.partial(self._dispatch_bloom_run_laned, qos_class=qos_class)
            one_fn = functools.partial(self._dispatch_laned, qos_class=qos_class)
        run_at: Dict[int, int] = {}
        if len(commands) > 1:
            runs = [
                (s, e)
                for s, e in _routing.coalescible_frame_runs(commands)
                if all(
                    isinstance(a, (bytes, bytearray))
                    for c in commands[s:e]
                    for a in c
                )
            ]
            # QoS shed boundary: a run never spans a shed command — the
            # fused window covers ADMITTED ops only
            run_at = dict(runs_within_admission(runs, shed_mask))
        results: list = []
        ci = -1
        for cmd in commands:
            ci += 1
            if len(results) > ci:
                continue  # covered by an already-dispatched run
            if shed_mask is not None and shed_mask[ci]:
                # load-shed: -BUSY in frame position, NO dispatch
                results.append(_Encoded(shed_enc))
                continue
            run_end = run_at.get(ci)
            if run_end is not None:
                run_cmds = commands[ci:run_end]
                self.stats["commands"] += len(run_cmds)
                results.extend(
                    await loop.run_in_executor(
                        pool, unit, run_fn, ctx, run_cmds, trace,
                    )
                )
                continue
            if not isinstance(cmd, list) or not all(
                isinstance(a, (bytes, bytearray)) for a in cmd
            ):
                results.append(_Encoded(resp.encode_error("ERR bad request frame")))
                continue
            self.stats["commands"] += 1
            # blocking verbs go to the wide slow pool: a parked handler must
            # never starve the pool every connection shares
            cmd_pool = self._slow_pool if bytes(cmd[0]).upper() in _SLOW_COMMANDS else pool
            results.append(
                await loop.run_in_executor(
                    cmd_pool, unit, one_fn, ctx, cmd, trace,
                )
            )
        return await self._finish_frame(ctx, results, loop, write_q, readback_slots,
                                        alive, pool, trace)

    async def _finish_frame(self, ctx, results, loop, write_q, readback_slots, alive,
                            pool, trace=None) -> bool:
        """Bring a dispatched frame's device results to the host and queue
        its replies, in frame order."""
        if any(isinstance(r, LazyReply) for r in results):
            if self.overlap:
                # overlap plane: hand the readback to the writer task as a
                # completion-queue entry and go straight back to reading.
                # FIFO queue order preserves the reply order; proto is
                # snapshotted at dispatch time.
                await readback_slots.acquire()
                if not alive["writer"]:
                    return False  # connection is going down; stop dispatching
                if trace is not None:
                    trace.mark_dispatched()
                fut = loop.run_in_executor(pool, _force_lazies, results, self, trace)
                write_q.put_nowait(_PendingFrame(results, fut, ctx.proto, trace))
                return True
            await loop.run_in_executor(pool, _force_lazies, results, self, trace)
        if results:
            # one queue item per frame — the whole frame's replies encode
            # in one pass and write in one syscall batch
            if trace is not None:
                trace.mark_dispatched()
                t0 = time.monotonic()
                data = _encode_frame(results, ctx.proto)
                trace.add_span("encode", t0, time.monotonic())
                write_q.put_nowait(_TracedEncoded(data, trace))
            else:
                write_q.put_nowait(_encode_frame(results, ctx.proto))
        return True

    # -- node info -------------------------------------------------------------

    def info_text(self) -> str:
        up = int(time.time() - self.started_at)
        return (
            "# Server\r\n"
            f"redis_version:7.2.0-rtpu\r\nrun_id:{self.node_id}\r\n"
            f"tcp_port:{self.port}\r\nuptime_in_seconds:{up}\r\nmode:{self.mode}\r\n"
            "# Clients\r\n"
            f"connected_clients:{self.stats['connections']}\r\n"
            "# Stats\r\n"
            f"total_commands_processed:{self.stats['commands']}\r\n"
            f"errors:{self.stats['errors']}\r\n"
            "# Keyspace\r\n"
            f"db0:keys={len(self.engine.store)},expires=0\r\n"
        )

    def commandstats_text(self) -> str:
        """INFO commandstats: per-verb calls/usec/usec_per_call from the
        MetricsRegistry's ``command.<verb>`` timers."""
        lines = ["# Commandstats"]
        with self.metrics._lock:
            timers = sorted(self.metrics._timers.items())
        for name, t in timers:
            if not name.startswith("command."):
                continue
            verb = name[len("command."):]
            usec = int(t.total_s * 1e6)
            per = usec / t.count if t.count else 0.0
            lines.append(
                f"cmdstat_{verb}:calls={t.count},usec={usec},"
                f"usec_per_call={per:.2f}"
            )
        return "\r\n".join(lines) + "\r\n"

    def config_view(self) -> Dict[str, Any]:
        """CONFIG GET surface: the node's live knob table (reference
        ``server/server.py:483-527``)."""
        ev = self.engine._eviction
        cfg = self.engine.config
        view = {
            "port": self.port,
            "mode": self.mode,
            "role": self.role,
            "node-id": self.node_id,
            "checkpoint-path": self.checkpoint_path or "",
            "tls": bool(self.tls_cert_file),
            # before the eviction scheduler starts, what it WILL use
            "eviction-min-delay": ev.min_delay if ev else cfg.min_cleanup_delay,
            "eviction-max-delay": ev.max_delay if ev else cfg.max_cleanup_delay,
            "tracking-table-max-keys": self.tracking.max_keys,
            "placement-devices": (
                self.engine.placement.n_devices
                if self.engine.placement is not None else 0
            ),
            "dispatch-ahead": self.readback_ahead,
            # the device-fault domain: lane watchdog and quarantine
            "lane-watchdog-ms": ioplane.lane_watchdog_ms(),
            "lane-quarantine-after": ioplane.quarantine_after(),
            "trace-enabled": int(_obs.tracing_enabled()),
            "trace-ring-capacity": self.tracer.ring_capacity,
            "slowlog-log-slower-than": self.tracer.slowlog_slower_than_us,
            "slowlog-max-len": self.tracer.slowlog_max_len,
        }
        from redisson_tpu_torch.services import vector as _V

        view["ivf-cell-imbalance"] = _V.IVF_CELL_IMBALANCE
        view["ivf-cell-cap-max"] = _V.IVF_CELL_CAP_MAX
        view["ftvec-device-budget"] = _V.DEVICE_BYTES_BUDGET
        # the residency plane: the per-device byte budget and arming
        from redisson_tpu_torch.core import residency as _res

        view["device-budget-bytes"] = _res.DEVICE_BUDGET_BYTES
        view["residency-enabled"] = int(
            self.engine.residency is not None and _res.tier_enabled()
        )
        view.update(self.scheduler.config_view())
        return view

    def config_set(self, key: str, value: str) -> bool:
        """CONFIG SET: the runtime-tunable subset (reference
        ``server/server.py:529-680``).  Structural knobs (port, TLS, mode)
        are read-only."""
        if key == "eviction-min-delay":
            self.engine.eviction.min_delay = float(value)
            return True
        if key == "eviction-max-delay":
            self.engine.eviction.max_delay = float(value)
            return True
        if key == "checkpoint-path":
            self.checkpoint_path = value or None
            return True
        if key == "tracking-table-max-keys":
            n = int(value)
            if n <= 0:
                return False
            self.tracking.max_keys = n
            return True
        if key == "dispatch-ahead":
            n = int(value)
            if n <= 0:
                return False
            # connections opened from now on size their dispatch-ahead
            # semaphore with this (see _handle)
            self.readback_ahead = n
            return True
        if key == "lane-watchdog-ms":
            # bounded readback wait: 0 disarms (the unbounded wait, with
            # the same replies)
            n = int(value)
            if n < 0:
                return False
            ioplane.set_lane_watchdog_ms(n)
            return True
        if key == "lane-quarantine-after":
            # consecutive device faults/timeouts that flip a lane to
            # QUARANTINED (CLUSTER DEVICES shows the state)
            n = int(value)
            if n <= 0:
                return False
            ioplane.set_quarantine_after(n)
            return True
        if key == "trace-enabled":
            _obs.set_tracing(value.lower() not in ("0", "false", "no", "off"))
            return True
        if key == "trace-ring-capacity":
            n = int(value)
            if n <= 0:
                return False
            self.tracer.set_ring_capacity(n)
            return True
        if key == "slowlog-log-slower-than":
            # microseconds; negative disables the slowlog, 0 logs every frame
            self.tracer.slowlog_slower_than_us = int(value)
            return True
        if key == "slowlog-max-len":
            n = int(value)
            if n <= 0:
                return False
            self.tracer.set_slowlog_max_len(n)
            return True
        if key == "ivf-cell-imbalance":
            # the cell_cap bound's multiplier, read at the next cell rebuild
            v = float(value)
            if v < 1.0:
                return False
            from redisson_tpu_torch.services import vector as _V

            _V.set_ivf_cell_imbalance(v)
            return True
        if key == "ivf-cell-cap-max":
            # the gather-width ceiling (0 = unbounded)
            n = int(value)
            if n < 0:
                return False
            from redisson_tpu_torch.services import vector as _V

            _V.set_ivf_cell_cap_max(n)
            return True
        if key == "ftvec-device-budget":
            # a bank's device-bytes budget (0 = unlimited)
            n = int(value)
            if n < 0:
                return False
            from redisson_tpu_torch.services import vector as _V

            _V.set_device_bytes_budget(n)
            return True
        if key == "device-budget-bytes":
            # the per-device budget the residency sweeper demotes against
            # (0 = unlimited; the explicit demotion verbs still work)
            n = int(value)
            if n < 0:
                return False
            from redisson_tpu_torch.core import residency as _res

            _res.set_device_budget_bytes(n)
            return True
        if key == "residency-enabled":
            # arm or disarm the residency plane live; disarming promotes
            # every demoted record back to HOT first
            on = value.lower() not in ("0", "false", "no", "off")
            from redisson_tpu_torch.core import residency as _res

            if on:
                self.enable_residency(sweep_interval=1.0)
            else:
                # the guard stays armed until every record is HOT again:
                # a promotion that fails leaves the plane serving
                self.engine.disable_residency()
                _res.set_tier(False)
            return True
        if key.startswith("qos-"):
            if key == "qos-bulk-slots" and int(value) <= 0:
                # 0 re-derives from the workers as at construction: it
                # never disables the flood protection
                value = str(max(1, self._workers - 1))
            ok = self.scheduler.config_set(key, value)
            if ok and key == "qos-interactive-deadline-ms":
                # live lane pipelines now, pipelines built later through
                # the process-global default
                sec = self.scheduler.interactive_deadline_ms / 1000.0
                ioplane.set_window_deadline(sec if sec > 0 else None)
                if self.engine.lanes is not None:
                    for lane in self.engine.lanes.lanes():
                        lane.pipeline.deadline_s = sec if sec > 0 else None
            if ok and key == "qos-bulk-subwindow-items":
                # the process-global target every lane's dispatch reads
                ioplane.set_bulk_subwindow_items(self.scheduler.bulk_subwindow_items)
            return ok
        return False

    # -- asyncio plumbing ----------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.stats["connections"] += 1
        self._writers.add(writer)
        ctx = CommandContext(self)
        self.tracking.register_conn(ctx)
        parser = resp.RespParser()
        loop = asyncio.get_running_loop()
        write_q: asyncio.Queue = asyncio.Queue()

        def push(msg) -> None:
            # pubsub listeners fire on engine threads; hop to the loop
            # (encoded with THIS connection's negotiated protocol)
            loop.call_soon_threadsafe(
                write_q.put_nowait, resp.encode_reply(msg, ctx.proto)
            )

        ctx.push = push

        # dispatch-ahead bound (overlap plane): the read loop may run at most
        # `readback_ahead` frames ahead of the slowest un-written readback
        readback_ahead = max(1, self.readback_ahead)
        readback_slots = asyncio.Semaphore(readback_ahead)
        # shared liveness flag (writer task -> read loop/_serve_frame)
        alive = {"writer": True}

        async def writer_task():
            # The completion queue drain: items are pre-encoded bytes (pubsub
            # pushes, readback-free frames) or _PendingFrame readback futures
            # (awaited HERE, off the read loop, so the next frame's dispatch
            # overlaps this frame's readback).  The queue is FIFO and this
            # task writes strictly in pop order, so per-connection reply
            # ordering and RESP framing are preserved exactly.  Everything
            # drained from one queue pass is joined and written as a SINGLE
            # transport.write.  Traced items close their `reply` span once
            # their bytes are written; a trace whose bytes never reach the
            # wire is abandoned so the inflight census row still drains.
            held = None  # a _PendingFrame popped while coalescing bytes
            try:
                while True:
                    item = held if held is not None else await write_q.get()
                    held = None
                    if item is None:
                        return
                    parts: list = []
                    done_tr = None  # traces of this batch (armed only)
                    final = False
                    while True:
                        if isinstance(item, _PendingFrame):
                            if parts and not item.fut.done():
                                # flush what's ready; await this one next pass
                                held = item
                                break
                            try:
                                await item.fut  # the overlapped readback
                            except Exception:  # noqa: BLE001 — pool died mid-force
                                # tear the connection DOWN: a silent return
                                # leaves the client blocked on recv with no EOF
                                if item.trace is not None:
                                    _obs.TRACER.abandon(item.trace)
                                for t in done_tr or ():
                                    _obs.TRACER.abandon(t)
                                try:
                                    writer.close()
                                except Exception:  # noqa: BLE001
                                    pass
                                return
                            finally:
                                readback_slots.release()
                            if item.trace is None:
                                parts.append(item.encoded())
                            else:
                                t0 = time.monotonic()
                                parts.append(item.encoded())
                                item.trace.add_span("encode", t0, time.monotonic())
                                done_tr = (done_tr or []) + [item.trace]
                        elif isinstance(item, _TracedEncoded):
                            parts.append(item.data)
                            done_tr = (done_tr or []) + [item.trace]
                        else:
                            parts.append(item)
                        if write_q.empty():
                            break
                        nxt = write_q.get_nowait()
                        if nxt is None:
                            final = True
                            break
                        item = nxt
                    if parts:
                        writer.write(parts[0] if len(parts) == 1 else b"".join(parts))
                        try:
                            await writer.drain()
                        except ConnectionError:
                            for t in done_tr or ():
                                _obs.TRACER.abandon(t)
                            return
                        for t in done_tr or ():
                            _obs.TRACER.finish_reply(t)
                    if final:
                        return
            finally:
                alive["writer"] = False
                # un-stick a read loop parked on the dispatch-ahead bound
                for _ in range(readback_ahead):
                    readback_slots.release()

        wt = asyncio.create_task(writer_task())
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                # tracing: frames are stamped AT PARSE TIME and the stamp
                # rides the frame through every chokepoint.  Disarmed cost:
                # one module-global load + `is not None` per read.
                t_parse0 = time.monotonic() if _obs._tracer is not None else None
                try:
                    commands = parser.feed(data)
                    # a frame ends where the client's write ends: while a
                    # read stops inside a command, read on (up to
                    # FRAME_READ_LIMIT bytes), so a pipelined run of blob
                    # commands larger than one read still reaches the
                    # coalescer as one run (the latency this costs: the
                    # module docstring)
                    taken = len(data)
                    while parser.pending_bytes and taken < FRAME_READ_LIMIT:
                        more = await reader.read(1 << 16)
                        if not more:
                            break
                        taken += len(more)
                        commands += parser.feed(more)
                except ProtocolError as e:
                    write_q.put_nowait(resp.encode_error(f"ERR protocol error: {e}"))
                    break
                trace = None
                if _obs._tracer is not None and commands:
                    trace = _obs._tracer.begin_frame(ctx, commands, t0=t_parse0)
                try:
                    ok = await self._serve_frame(
                        ctx, commands, loop, write_q, readback_slots, alive,
                        trace,
                    )
                except BaseException:
                    # frame died before its replies were queued: close the
                    # trace's books so the inflight census row drains
                    if trace is not None and not trace.finished:
                        _obs.TRACER.abandon(trace)
                    raise
                if not ok:
                    if trace is not None and not trace.finished:
                        _obs.TRACER.abandon(trace)
                    break
        except (ConnectionResetError, asyncio.IncompleteReadError, BrokenPipeError):
            pass
        finally:
            # tracking disconnect-cleanup FIRST: the table must not leak this
            # conn's keys, and dependents redirecting here must break loudly
            self.tracking.unregister_conn(ctx)
            for ch, lid in list(ctx.subscriptions.items()):
                self.engine.pubsub.unsubscribe(ch, lid)
            for pat, lid in list(ctx.psubscriptions.items()):
                self.engine.pubsub.punsubscribe(pat, lid)
            write_q.put_nowait(None)
            await wt
            # traced frames still queued behind the writer's death never
            # reached the wire: abandon them so trace_inflight drains
            while not write_q.empty():
                leftover = write_q.get_nowait()
                t = getattr(leftover, "trace", None)
                if t is not None and not t.finished:
                    _obs.TRACER.abandon(t)
            self._writers.discard(writer)
            self.stats["connections"] -= 1
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    @property
    def tls_enabled(self) -> bool:
        return self.tls_cert_file is not None

    def _server_ssl_context(self):
        if not self.tls_enabled:
            return None
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.tls_cert_file, self.tls_key_file)
        if self.tls_ca_file:
            ctx.load_verify_locations(self.tls_ca_file)
            ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS
        return ctx

    def replication_source(self):
        """The lazy master-side record shipper (server/replication.py)."""
        from redisson_tpu_torch.server.replication import ReplicationSource

        with self._repl_lock:
            if self._replication is None:
                self._replication = ReplicationSource(self)
            return self._replication

    def link_client(self, address: str, **kw):
        """NodeClient for this node's OUTGOING links (METRICS CLUSTER's
        scrape of its peers): inherits the node's password and, when TLS is
        on, a client context trusting the cluster CA (hostname checks off —
        cluster peers are addressed by IP)."""
        from redisson_tpu_torch.net.client import NodeClient, client_ssl_context

        kw.setdefault("password", self.password)
        if self.tls_enabled:
            kw.setdefault(
                "ssl_context",
                client_ssl_context(
                    # self-signed deployments trust the node cert itself
                    ca_file=self.tls_ca_file or self.tls_cert_file,
                    cert_file=self.tls_cert_file,
                    key_file=self.tls_key_file,
                    verify_hostname=False,
                ),
            )
        return NodeClient(address, **kw)

    async def start_async(self):
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, reuse_address=True,
            ssl=self._server_ssl_context(),
        )
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def serve_forever(self):
        await self.start_async()
        async with self._server:
            await self._server.serve_forever()

    async def serve_until_signal(self, ready_fd: Optional[int] = None,
                                 journal_dir: Optional[str] = None):
        """CLI serve loop: run until SIGTERM or SIGINT (both graceful).

        ``ready_fd``: once the listener is bound (port 0 resolved), write
        one line — ``READY <host> <port> <pid>`` — to this inherited file
        descriptor and close it, so a supervisor awaits that line instead of
        polling the port.  With a journal directory, the node re-arms the
        migration windows it was a party to and replays its import journals
        (``migration.rearm_recovery``) before that line goes out.

        On the signal the listener and every established connection close
        BEFORE the loop leaves ``async with self._server``: since Python
        3.12 its ``wait_closed()`` waits for every open connection, so a
        client left connected would hold the process until a supervisor's
        SIGKILL, and the caller's flush-on-stop would never run."""
        import signal as _signal

        loop = asyncio.get_running_loop()
        stopped = self._serve_stopped = asyncio.Event()
        installed = []
        for sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stopped.set)
                installed.append(sig)
            except (NotImplementedError, RuntimeError):  # non-main thread /
                pass                                     # exotic loop
        await self.start_async()
        if journal_dir is not None:
            # the IMPORTRECORDS handler journals into it: armed before serving
            self.journal_dir = journal_dir
        if self.journal_dir is not None:
            # BEFORE the ready line (supervised clients gate on it): restored
            # copies of mid-migration slots must answer TRYAGAIN, not serve
            # a forked lineage, and batches this node acked but lost with its
            # memory come back from its import journals
            from redisson_tpu_torch.server.migration import rearm_recovery

            rearm_recovery(self, self.journal_dir)
        if ready_fd is not None:
            line = f"READY {self.public_host} {self.port} {os.getpid()}\n".encode()
            try:
                os.write(ready_fd, line)
            finally:
                try:
                    os.close(ready_fd)
                except OSError:
                    pass
        async with self._server:
            try:
                await stopped.wait()
            finally:
                for sig in installed:
                    loop.remove_signal_handler(sig)
                # stop() closes the listener and the connections (on this
                # loop, while __aexit__ waits for them)
                self.stop()

    def stop(self):
        # parked blocking verbs (_block_loop) poll this to unpark: a
        # forever-blocked worker would otherwise survive pool shutdown
        # (wait=False) and hang interpreter exit via the futures atexit join
        self._closing = True
        self._pause_gate.set()  # release chaos-paused workers
        loop, server = self._loop, self._server
        if loop is not None and server is not None:
            def shutdown():
                server.close()
                if self._serve_stopped is not None:
                    # SHUTDOWN over the wire ends the CLI process, as
                    # Redis's does
                    self._serve_stopped.set()
                # drop established connections too: clients must see a dead
                # node, not a half-alive one
                for w in list(self._writers):
                    try:
                        w.close()
                    except Exception:  # noqa: BLE001
                        pass

            try:
                loop.call_soon_threadsafe(shutdown)
            except RuntimeError:
                pass  # loop already closed (repeated stop): nothing to do
        if self._replication is not None:
            self._replication.close()
        self._pool.shutdown(wait=False)
        self._qos_pool.shutdown(wait=False)
        self._slow_pool.shutdown(wait=False)


def _encode_result(result, proto: int = 3) -> bytes:
    if isinstance(result, str) and result.startswith("+"):
        return resp.encode_simple(result[1:])
    if isinstance(result, list) and result and all(isinstance(r, resp.Push) for r in result):
        # subscribe-style confirmations: stream of push frames
        return b"".join(resp.encode_reply(r, proto) for r in result)
    return resp.encode_reply(result, proto)


def _encode_frame(results: list, proto: int) -> bytes:
    """Encode a whole frame's replies as ONE byte string.  Runs of plain
    values ride a single resp.encode_replies emit (one native arena write
    for the run); pre-encoded errors and the two special result forms
    (`+simple` strings, push-frame lists) keep their _encode_result
    semantics, in place, in order."""
    parts: list = []
    run: list = []
    flush = parts.append
    for r in results:
        if isinstance(r, _Encoded):
            if run:
                flush(resp.encode_replies(run, proto))
                run = []
            flush(r.data)
        elif isinstance(r, str) and r.startswith("+"):
            if run:
                flush(resp.encode_replies(run, proto))
                run = []
            flush(resp.encode_simple(r[1:]))
        elif isinstance(r, list) and r and isinstance(r[0], resp.Push):
            if run:
                flush(resp.encode_replies(run, proto))
                run = []
            flush(_encode_result(r, proto))
        else:
            run.append(r)
    if run:
        flush(resp.encode_replies(run, proto))
    if len(parts) == 1:
        return parts[0]
    return b"".join(parts)


class ServerThread:
    """In-process server on a daemon thread — the embedded-test harness
    (RedisRunner analog for hermetic tests).  Keyword arguments go to
    TpuServer, ``device`` among them (the CUDA card unless "cpu")."""

    def __init__(self, engine: Optional[Engine] = None, port: int = 0, **kw):
        self.server = TpuServer(engine=engine, port=port, **kw)
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    def __enter__(self) -> "ServerThread":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def start(self) -> "ServerThread":
        def run():
            async def main():
                await self.server.start_async()
                self._started.set()
                async with self.server._server:
                    try:
                        await self.server._server.serve_forever()
                    except asyncio.CancelledError:
                        pass

            asyncio.run(main())

        self._thread = threading.Thread(target=run, daemon=True, name="rtpu-server")
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("server failed to start")
        return self

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def address(self) -> str:
        scheme = "tpus" if self.server.tls_enabled else "tpu"
        return f"{scheme}://{self.server.host}:{self.server.port}"

    def stop(self):
        self.server.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def client(self):
        """One-shot admin connection (context manager) to this node — speaks
        TLS when the node does (trusting the node's own CA/cert chain)."""
        from contextlib import closing

        from redisson_tpu_torch.net.client import Connection, client_ssl_context

        ssl_ctx = None
        if self.server.tls_enabled:
            ssl_ctx = client_ssl_context(
                ca_file=self.server.tls_ca_file or self.server.tls_cert_file,
                cert_file=self.server.tls_cert_file if self.server.tls_ca_file else None,
                key_file=self.server.tls_key_file if self.server.tls_ca_file else None,
                verify_hostname=False,
            )
        return closing(
            Connection(
                self.server.host,
                self.server.port,
                timeout=120.0,
                password=self.server.password,
                ssl_context=ssl_ctx,
            )
        )


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description="redisson-tpu server on PyTorch")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6390)
    ap.add_argument(
        "--advertise-host", default=None,
        help="the routable address this node is named by in cluster views "
             "and its READY line when it differs from the bind --host "
             "(cross-host nodes bind 0.0.0.0; without this a node would "
             "MOVED-bounce its own slots)",
    )
    ap.add_argument(
        "--mode", default="standalone", choices=("standalone", "cluster"),
        help="the mode HELLO reports; a node routes by slot once a cluster "
             "view is installed (CLUSTER SETVIEW) in either mode",
    )
    ap.add_argument("--password", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path: SAVE, SHUTDOWN and RESTORESTATE default to it")
    ap.add_argument("--restore", action="store_true",
                    help="load the checkpoint at boot (when the file exists)")
    ap.add_argument(
        "--checkpoint-interval", type=float, default=0.0,
        help="seconds between automatic snapshots (0 = manual SAVE only); "
             "a final snapshot is taken at a graceful stop",
    )
    ap.add_argument(
        "--journal-dir", default=None,
        help="the migration journal directory (shared with the coordinator): "
             "accepted IMPORTRECORDS batches are journaled here before the "
             "ack, and at boot the node re-arms the migration windows it was "
             "a party to and replays its import journals before serving",
    )
    ap.add_argument(
        "--prewarm", action="store_true",
        help="warm the hot kernels of the restored records at boot "
             "(core/warmpool: the first request's latency stays clean)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the state lives: 'cuda' (the default; without a card the "
             "server refuses to start) or 'cpu' (the plain PyTorch versions)",
    )
    ap.add_argument(
        "--no-overlap", action="store_true",
        help="disable the overlapped device I/O plane (core/ioplane): every "
             "frame's readback blocks its connection's read loop — the "
             "serial reference path for A/B measurement",
    )
    ap.add_argument(
        "--workers", type=int, default=4,
        help="data-plane worker threads (the per-connection dispatch pool)",
    )
    ap.add_argument(
        "--no-qos", action="store_true",
        help="disable the deadline-aware scheduler / per-tenant QoS plane "
             "(server/scheduler.py): frames dispatch in pure arrival order "
             "(RTPU_NO_QOS=1 equivalent)",
    )
    ap.add_argument(
        "--no-preempt", action="store_true",
        help="disable the bulk-window preemption plane (core/ioplane): no "
             "sub-window splitting, no interactive lane stream; every "
             "dispatch serializes through the one lane gate "
             "(RTPU_NO_PREEMPT=1 equivalent)",
    )
    ap.add_argument(
        "--no-tier", action="store_true",
        help="disable the tiered residency plane (core/residency) for the "
             "process's life: every record stays HOT on its device, and "
             "neither --residency nor CONFIG SET residency-enabled yes arms "
             "it (RTPU_NO_TIER=1 equivalent; replies are bit-identical)",
    )
    ap.add_argument(
        "--residency", action="store_true",
        help="arm the tiered residency plane at boot (cold records demote "
             "to host RAM or spill under the per-device device-budget-bytes "
             "budget and fault back in on first touch; also CONFIG SET "
             "residency-enabled yes)",
    )
    ap.add_argument(
        "--dispatch-ahead", type=int, default=None,
        help="per-connection dispatch-ahead bound: how many frames may sit "
             "between 'dispatched' and 'replies written' on one connection. "
             "Default: 2.",
    )
    ap.add_argument(
        "--devices", default=None,
        help="device-sharded serving: map the 16384-slot table onto this many "
             "mesh positions ('all' = every local position: one a GPU, or "
             "RTPU_CPU_POSITIONS on the CPU); each record is owned by its "
             "slot's position and frames dispatch down per-position lanes.  "
             "Default: one device (no placement).",
    )
    ap.add_argument(
        "--ready-fd", type=int, default=None,
        help="inherited fd to write one 'READY <host> <port> <pid>' line to "
             "once the listener is bound (with --port 0 this reports the "
             "kernel-chosen port)",
    )
    ap.add_argument(
        "--tls-cert", default=None,
        help="PEM certificate: enables TLS on the listener (with --tls-key)",
    )
    ap.add_argument("--tls-key", default=None, help="PEM private key for --tls-cert")
    ap.add_argument(
        "--tls-ca", default=None,
        help="PEM CA bundle: additionally REQUIRE client certificates "
             "(mutual TLS)",
    )
    ap.add_argument(
        "--retry-profile", default=None, choices=("lan", "wan"),
        help="link retry cadence for cluster-internal connections "
             "(net/retry.py LINK_PROFILES): 'lan' (default) keeps the tight "
             "schedules; 'wan' stretches backoff and deadlines for links "
             "that cross real networks.  Sets RTPU_RETRY_PROFILE, which "
             "child processes inherit.",
    )
    args = ap.parse_args(argv)
    if bool(args.tls_cert) != bool(args.tls_key):
        ap.error("--tls-cert and --tls-key must be given together")
    if args.checkpoint_interval > 0 and not args.checkpoint:
        ap.error("--checkpoint-interval requires --checkpoint <path>")
    if args.no_overlap:
        # flip the process-global switch too: the embedded Batch/pack paths
        # of THIS process must match the server's serial reply path
        ioplane.set_overlap(False)
    if args.no_qos:
        _sched.set_qos(False)
    if args.no_preempt:
        ioplane.set_preempt(False)
    if args.no_tier:
        from redisson_tpu_torch.core import residency as _res_tier

        _res_tier.pin_disarmed()
    if args.retry_profile:
        # the one channel: net/retry.current_profile reads it in this
        # process, and coordinator code spawned from it inherits it
        os.environ["RTPU_RETRY_PROFILE"] = args.retry_profile
    engine = Engine(device=args.device)
    srv = TpuServer(
        engine,
        host=args.host,
        port=args.port,
        advertise_host=args.advertise_host,
        mode=args.mode,
        password=args.password,
        checkpoint_path=args.checkpoint,
        overlap=not args.no_overlap,
        workers=args.workers,
        qos=False if args.no_qos else None,
        dispatch_ahead=args.dispatch_ahead,
        devices=args.devices,
        tls_cert_file=args.tls_cert,
        tls_key_file=args.tls_key,
        tls_ca_file=args.tls_ca,
    )
    # the node's log (a supervisor sends stdout there) names the device it
    # serves on, and at a graceful stop the kernel launches it made
    print(f"serving on {srv.engine.device}", flush=True)
    from redisson_tpu_torch.core import checkpoint

    # a fresh boot has nothing to restore yet: a supervisor's restart passes
    # --restore once the node's checkpoint directory exists
    if args.restore and args.checkpoint and os.path.exists(args.checkpoint):
        n = checkpoint.load(engine, args.checkpoint)
        print(f"restored {n} records from {args.checkpoint}", flush=True)
    if args.residency and not args.no_tier:
        srv.enable_residency(sweep_interval=1.0)
    if args.prewarm:
        t0 = time.perf_counter()
        n = engine.prewarm()
        print(f"prewarmed {n} keys in {time.perf_counter() - t0:.6f} s "
              f"{json.dumps(engine.warm_pool.stats())}", flush=True)
    checkpointer = None
    if args.checkpoint and args.checkpoint_interval > 0:
        checkpointer = checkpoint.AutoCheckpointer(
            engine, args.checkpoint, args.checkpoint_interval
        ).start()
    try:
        # SIGTERM and SIGINT both land on the graceful path
        asyncio.run(srv.serve_until_signal(ready_fd=args.ready_fd,
                                           journal_dir=args.journal_dir))
    finally:
        if checkpointer is not None:
            # flush-on-stop: writes since the last tick reach disk
            checkpointer.stop()
    from redisson_tpu_torch.core import kernels as K

    print("kernel launches " + json.dumps(dict(K.launches)), flush=True)
    return 0


if __name__ == "__main__":
    main()
