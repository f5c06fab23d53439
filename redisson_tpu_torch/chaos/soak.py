"""Soak/endurance harness: mixed workload across repeated chaos cycles.

A copy of ``redisson_tpu/chaos/soak.py``: the same twelve harnesses, with
the reference's class names, fields, defaults, fault schedules and
assertions.  What differs:

  * **An explicit device.**  Every ``*SoakConfig`` has ``device`` (the
    CUDA card unless ``"cpu"``), and the harness builds everything on it:
    each ``ServerThread`` and ``ClusterRunner`` node, the embedded
    ``create()`` clients, and each ``ClusterSupervisor``'s children
    (``platform``; ``RTPU_PROC_PLATFORM`` still overrides it).  With no
    card and the default device a harness raises the port's no-card error
    (``core/engine.resolve_device``); it never carries on on the CPU.
  * **Mesh positions in place of ``jax.devices()``.**  ``SoakConfig``,
    ``DeviceShardSoakConfig`` (and ``DeviceFaultSoakConfig``),
    ``VectorSoakConfig`` and ``ResidencySoakConfig`` have ``positions``:
    ``None`` is every local position (the reference's ``"all"``), which is
    one position on one card; ``positions=8`` puts 8 shards on it
    (``parallel/mesh.local_devices``).  The standard profile's reshard
    runs when there are 8 positions; its embedded client's
    ``mesh.n_devices`` and the device-sharded servers' ``devices`` take
    ``positions``.

Parity target: ``RedissonFailoverTest.java:47-152`` (a write stream
surviving repeated ``master.stop()``) scaled into an endurance discipline:
every cycle runs a mixed workload (bucket writes with acked tracking, map
put/get, lock acquire/release with a mutual-exclusion probe, pubsub, and a
sharded-bloom batch on an embedded mesh engine), then injects chaos
(master kill → automatic failover → restart-as-replica; mesh reshard
4 → 8 → 4), then QUIESCES and asserts:

  * zero acked-write loss — every pre-kill acked+flushed bucket write is
    still readable after failover, and every acked bloom add is still
    contained after every reshard;
  * a flat :class:`~redisson_tpu_torch.chaos.census.ResourceCensus` — record
    locks and staged replication buffers drain to zero, no kernel-cache
    entry outlives its epoch, connection pools return every connection,
    and replication baselines stay bounded by the live keyspace;
  * a bounded error budget — outage-window errors stay a fraction of acked
    operations.

Determinism: the workload content is a pure function of ``SoakConfig.seed``
(keys, bloom batches, fault schedule).  Wall clock only decides HOW MUCH
work a phase performs, never WHAT the assertions compare.

Run it three ways: the reference's ``tests/test_soak.py`` on the port
(``tests/test_torch_suite_soak.py``; ``-m slow`` for the endurance tier),
``python -m redisson_tpu_torch.tools.soak_smoke`` (a ~10s sanity loop), or
construct :class:`SoakHarness` directly.

The **migration-under-fault profile** (:class:`MigrationSoakHarness`) is
the second discipline in this module: a mixed workload keeps writing
through a slot range while the MIGRATION COORDINATOR is killed at every
journal phase (``migrate_slots(crash_after=...)`` →
``resume_migrations``) and storage faults corrupt checkpoint heads.
Invariants per cycle: zero acked-write loss, no slot left non-STABLE on
either end, bit-identical record contents for a quiesced device-backed
record vs its pre-migration snapshot, checkpoint loads surviving torn
heads via generation fallback, and a flat ResourceCensus
(``soak_smoke --profile migration``).

The **cross-process profile** (:class:`ClusterProcSoakHarness`) is the
third discipline: the same storm against REAL server OS processes
(cluster/supervisor.py) — the coordinator dies at a journal phase AND the
source master takes an actual SIGKILL, the supervisor restarts it from its
checkpoint, and ``resume_migrations`` must terminalize every journal
across a genuine process boundary (``soak_smoke --profile cluster-proc``).

The **fleet profile** (:class:`FleetSoakHarness`) extends the
cross-process storm to whole-fleet lifecycle: replica-covered masters, a
rolling restart of the live fleet (zero acked loss through graceful
drains), TARGET double-kills recovered by import-journal replay, a
replica promotion carrying an in-flight import window across a failover,
and a live-coordinator target kill that must leave its journal resumable —
under client-side transport faults, with a flat client census per cycle
(``soak_smoke --profile fleet``).
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from redisson_tpu_torch.chaos.census import ResourceCensus
from redisson_tpu_torch.chaos.faults import FaultPlane, FaultSchedule


def _proc_platform(device: str) -> str:
    """The server processes' device: ``RTPU_PROC_PLATFORM``, else the
    config's.  Resolved here, so a harness without a card raises the
    no-card error before it spawns children that would fail the same way."""
    from redisson_tpu_torch.core.engine import resolve_device

    platform = os.environ.get("RTPU_PROC_PLATFORM", device)
    resolve_device(platform)
    return platform


@dataclass
class SoakConfig:
    cycles: int = 3
    seconds_per_phase: float = 1.5
    masters: int = 2
    replicas_per_master: int = 1
    writer_threads: int = 3
    seed: int = 0
    kill: bool = True              # master-kill -> failover -> recover
    reshard: bool = True           # mesh reshard 4 -> 8 -> 4 per cycle
    faults_per_cycle: int = 4      # injected transport faults per cycle
    error_budget_ratio: float = 0.5
    verify_sample: int = 50        # acked bucket writes re-read per cycle
    bloom_batch: int = 256         # sharded-bloom adds per cycle
    failover_deadline_s: float = 45.0
    quiesce_deadline_s: float = 15.0
    tag: str = "soak"              # hashtag pinning the write stream
    device: str = "cuda"           # where every node and client lives
    positions: Optional[int] = None  # mesh positions; None = every local one


@dataclass
class SoakReport:
    cycles_completed: int = 0
    acked_writes: int = 0
    verified_writes: int = 0
    errors: int = 0
    failovers: List[Tuple[str, str]] = field(default_factory=list)
    injected_faults: Dict[str, int] = field(default_factory=dict)
    bloom_keys_verified: int = 0
    pubsub_received: int = 0
    lock_rounds: int = 0
    lock_max_concurrency: int = 0
    census: List[Dict[str, float]] = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"soak: {self.cycles_completed} cycles, "
            f"{self.acked_writes} acked writes ({self.verified_writes} re-verified), "
            f"{self.errors} budgeted errors, {len(self.failovers)} failovers, "
            f"faults={self.injected_faults}, "
            f"bloom={self.bloom_keys_verified} keys verified, "
            f"pubsub={self.pubsub_received} received, "
            f"locks={self.lock_rounds} rounds (peak concurrency "
            f"{self.lock_max_concurrency}), census points={len(self.census)}"
        )


class SoakHarness:
    """One endurance run over an in-process cluster + embedded mesh engine."""

    def __init__(self, config: Optional[SoakConfig] = None,
                 schedule: Optional[FaultSchedule] = None):
        self.config = config or SoakConfig()
        cfg = self.config
        # a user-supplied schedule is ONE program across the whole run; the
        # default builds a FRESH plane per cycle (fresh event counters), so
        # every cycle's chaos phase actually injects faults_per_cycle faults
        # instead of cycle 0 exhausting the whole event window
        self._user_schedule = schedule
        self.schedule = schedule or self._default_schedule(cfg)
        self.plane = FaultPlane(self.schedule)
        self._planes: List[FaultPlane] = [self.plane]
        self.census = ResourceCensus()
        self.report = SoakReport()
        self._rng = np.random.default_rng(cfg.seed)
        self._acked: Dict[str, int] = {}
        self._acked_lock = threading.Lock()
        self._bloom_added: List[np.ndarray] = []  # int64 key batches
        self._pubsub_seen: set = set()
        self._last_pubsub = None  # PubSubConnection currently subscribed
        self._lock_inside = 0
        self._runner = None
        self._client = None
        self._coord = None
        self._embedded = None
        self._mesh_mgr = None
        self._failovers_seen = 0  # coord.failovers entries already reconciled

    @staticmethod
    def _default_schedule(cfg: SoakConfig, cycle: int = 0) -> FaultSchedule:
        """Seed-deterministic background noise for ONE cycle: delays,
        drops, and one-way partitions sprinkled over the early send/recv
        events of the cycle's chaos phase (the window is small on purpose —
        a phase generates hundreds of events, so the whole program lands
        inside the phase it belongs to)."""
        sched = FaultSchedule(cfg.seed * 7919 + cycle)
        n = max(1, cfg.faults_per_cycle)
        sched.add_random("delay", n=n, window=200, delay_s=0.02)
        sched.add_random("drop", n=max(1, n // 2), window=200)
        sched.add_random("partition_in", n=max(1, n // 4), window=200)
        return sched

    def _plane_for_cycle(self, cycle: int) -> FaultPlane:
        if self._user_schedule is not None:
            return self.plane  # one continuous program, shared counters
        if cycle == 0:
            return self.plane
        plane = FaultPlane(self._default_schedule(self.config, cycle))
        self._planes.append(plane)
        return plane

    # -- lifecycle -----------------------------------------------------------

    def _setup(self) -> None:
        import redisson_tpu_torch
        from redisson_tpu_torch.config import Config
        from redisson_tpu_torch.harness import ClusterRunner
        from redisson_tpu_torch.server.monitor import FailoverCoordinator

        cfg = self.config
        self._runner = ClusterRunner(
            masters=cfg.masters, replicas_per_master=cfg.replicas_per_master,
            device=cfg.device,
        ).run()
        # short timeouts on purpose: a writer blocked behind a dead node or a
        # partitioned reply must fail (budgeted) within seconds, not park for
        # the 180s default — worst case per op is ~timeout x attempts
        self._client = self._runner.client(
            scan_interval=0.5, timeout=10.0, connect_timeout=5.0,
            retry_attempts=1, retry_interval=0.2,
        )
        self._coord = FailoverCoordinator(
            self._runner.view_tuples(), check_interval=0.1
        ).start()
        if cfg.reshard:
            from redisson_tpu_torch.parallel.manager import MeshManager
            from redisson_tpu_torch.parallel.mesh import local_devices

            if len(local_devices(cfg.device, count=cfg.positions)) >= 8:
                ecfg = Config()
                ecfg.mesh.dp = 2
                ecfg.mesh.shard = 4
                ecfg.mesh.n_devices = cfg.positions
                self._embedded = redisson_tpu_torch.create(ecfg, cfg.device)
                self._mesh_mgr = MeshManager.of(self._embedded._engine)
                bf = self._embedded.get_sharded_bloom_filter_array("soak:bloom")
                bf.try_init(8, expected_insertions=200_000, false_probability=0.01)
        self.census.track_client("client", self._client)
        if self._embedded is not None:
            self.census.track_engine("embedded", self._embedded._engine)
        time.sleep(0.5)  # coordinator learns each master's replica set

    def _teardown(self) -> None:
        if self._coord is not None:
            self._coord.stop()
        if self._client is not None:
            self._client.shutdown()
        if self._embedded is not None:
            self._embedded.shutdown()
        if self._runner is not None:
            self._runner.shutdown()

    # -- workload ------------------------------------------------------------

    def _record_error(self) -> None:
        with self._acked_lock:
            self.report.errors += 1

    def _writer(self, wid: int, cycle: int, stop: threading.Event) -> None:
        cfg = self.config
        client = self._client
        i = 0
        while not stop.is_set():
            key = f"c{cycle}-w{wid}-{i}{{{cfg.tag}}}"
            try:
                client.get_bucket(key).set(i)
                with self._acked_lock:
                    self._acked[key] = i
                    self.report.acked_writes += 1
            except Exception:  # noqa: BLE001 — budgeted chaos error
                self._record_error()
            i += 1
            time.sleep(0.004)

    def _mapper(self, wid: int, cycle: int, stop: threading.Event) -> None:
        cfg = self.config
        m = self._client.get_map(f"soak-map{{{cfg.tag}}}")
        i = 0
        while not stop.is_set():
            try:
                m.put(f"c{cycle}-w{wid}-{i}", i)
                m.get(f"c{cycle}-w{wid}-{max(0, i - 1)}")
            except Exception:  # noqa: BLE001
                self._record_error()
            i += 1
            time.sleep(0.004)

    def _locker(self, wid: int, cycle: int, stop: threading.Event) -> None:
        cfg = self.config
        lk = self._client.get_lock(f"soak-lock{{{cfg.tag}}}")
        while not stop.is_set():
            try:
                lk.lock()
            except Exception:  # noqa: BLE001
                self._record_error()
                time.sleep(0.05)
                continue
            try:
                with self._acked_lock:
                    self._lock_inside += 1
                    self.report.lock_max_concurrency = max(
                        self.report.lock_max_concurrency, self._lock_inside
                    )
                time.sleep(0.002)
                with self._acked_lock:
                    self._lock_inside -= 1
                    self.report.lock_rounds += 1
            finally:
                try:
                    lk.unlock()
                except Exception:  # noqa: BLE001 — node died holding it; the
                    self._record_error()  # lease lapses server-side
            time.sleep(0.002)

    def _publisher(self, cycle: int, stop: threading.Event) -> None:
        cfg = self.config
        chan = f"soak-chan{{{cfg.tag}}}"
        i = 0
        while not stop.is_set():
            try:
                self._client.publish_for(chan, chan, f"c{cycle}-{i}".encode())
            except Exception:  # noqa: BLE001
                self._record_error()
            i += 1
            time.sleep(0.01)

    def _on_pubsub(self, _channel: str, payload: bytes) -> None:
        with self._acked_lock:  # reader thread vs. report readers
            if payload not in self._pubsub_seen:
                self._pubsub_seen.add(payload)
                self.report.pubsub_received += 1

    def _subscribe(self) -> None:
        """Attach the ONE listener to the channel's current pubsub
        connection — re-subscribing only when failover handed the channel a
        fresh connection (same connection = already listening; stacking a
        duplicate listener would double-count every message)."""
        chan = f"soak-chan{{{self.config.tag}}}"
        try:
            ps = self._client.pubsub_for(chan)
            if ps is self._last_pubsub:
                return
            ps.subscribe(chan, self._on_pubsub)
            self._last_pubsub = ps
        except Exception:  # noqa: BLE001 — pubsub is best-effort mid-chaos
            pass

    def _workload_phase(self, cycle: int, chaos: bool = True) -> None:
        cfg = self.config
        self._subscribe()
        stop = threading.Event()
        threads = [
            threading.Thread(target=self._writer, args=(w, cycle, stop))
            for w in range(cfg.writer_threads)
        ] + [
            threading.Thread(target=self._mapper, args=(0, cycle, stop)),
            threading.Thread(target=self._locker, args=(0, cycle, stop)),
            threading.Thread(target=self._locker, args=(1, cycle, stop)),
            threading.Thread(target=self._publisher, args=(cycle, stop)),
        ]
        ctx = self._plane_for_cycle(cycle).active() if chaos else None
        if ctx is not None:
            ctx.__enter__()
        try:
            for t in threads:
                t.start()
            time.sleep(cfg.seconds_per_phase)
        finally:
            stop.set()
            for t in threads:
                # a partitioned reply holds an op for ~timeout x attempts;
                # the join bound must dominate that, not race it
                t.join(timeout=90.0)
            if ctx is not None:
                ctx.__exit__(None, None, None)
        assert not any(t.is_alive() for t in threads), "soak worker wedged"

    # -- chaos ops -----------------------------------------------------------

    def _victim_index(self) -> int:
        from redisson_tpu_torch.utils.crc16 import calc_slot

        slot = calc_slot(self.config.tag.encode())
        return next(
            i for i, (lo, hi) in enumerate(self._runner.slot_ranges)
            if lo <= slot <= hi
        )

    def _reconcile_failovers(self) -> None:
        """Fold every coordinator failover not yet processed into the
        runner's bookkeeping — our own kills AND any spurious one (a fault
        program that includes the control plane can push a healthy master's
        ping stream past the detector threshold).  The demoted node — dead
        or alive — becomes a replica of the promoted one, so capacity and
        monitoring survive every cycle."""
        runner, coord = self._runner, self._coord
        fos = coord.failovers
        while self._failovers_seen < len(fos):
            dead_addr, promoted_addr = fos[self._failovers_seen]
            self._failovers_seen += 1
            self.report.failovers.append((dead_addr, promoted_addr))
            dead = runner.adopt_failover(dead_addr, promoted_addr)
            if dead is None:
                continue
            if dead.stopped:
                runner.restart_node(dead)
            else:
                # spuriously demoted but alive: re-point it as a replica
                runner.install_view()
                runner.wire_replicas()

    def _kill_failover_recover(self) -> None:
        from redisson_tpu_torch.harness import _exec

        cfg = self.config
        runner, coord = self._runner, self._coord
        self._reconcile_failovers()
        mi = self._victim_index()
        victim = runner.masters[mi]
        victim_addr = victim.address
        # flush so every already-acked write is on the replica BEFORE the
        # kill: the zero-acked-write-loss contract covers flushed writes
        # (async replication semantics, WAIT/REPLFLUSH analog)
        with victim.server.client() as c:
            _exec(c, "REPLFLUSH", timeout=60.0)
        with self._acked_lock:
            pre_kill = dict(self._acked)
        seen = self._failovers_seen
        runner.stop_master(mi)
        deadline = time.monotonic() + cfg.failover_deadline_s

        def victim_failed_over() -> bool:
            return any(d == victim_addr for d, _p in coord.failovers[seen:])

        while time.monotonic() < deadline and not victim_failed_over():
            time.sleep(0.1)
        assert victim_failed_over(), "no automatic failover happened"
        self._client.refresh_topology()
        # restart the dead node as a fresh replica of the promoted master so
        # the NEXT cycle has a promotion candidate again
        self._reconcile_failovers()
        time.sleep(0.5)  # clients re-route; coordinator re-learns replicas
        self._verify_acked(pre_kill)

    def _verify_acked(self, acked: Dict[str, int]) -> None:
        cfg = self.config
        keys = sorted(acked)
        sample = keys[:: max(1, len(keys) // cfg.verify_sample)]
        for key in sample:
            got = None
            # the freshly promoted topology may still be settling: bounded
            # retry, but the VALUE comparison is exact — no acked-write loss
            for _ in range(20):
                try:
                    got = self._client.get_bucket(key).get()
                    break
                except Exception:  # noqa: BLE001
                    time.sleep(0.2)
            assert got == acked[key], (
                f"lost acked+flushed write {key!r}: want {acked[key]!r}, got {got!r}"
            )
            self.report.verified_writes += 1

    def _bloom_phase(self) -> None:
        """Add one deterministic batch, then verify EVERY batch ever acked
        across a 4 -> 8 -> 4 reshard roundtrip (zero lost acked adds)."""
        if self._embedded is None:
            return
        cfg = self.config
        bf = self._embedded.get_sharded_bloom_filter_array("soak:bloom")
        keys = self._rng.integers(0, 1 << 60, cfg.bloom_batch).astype(np.int64)
        tenant = (np.arange(cfg.bloom_batch) % 8).astype(np.int32)
        bf.add_each(tenant, keys)
        self._bloom_added.append(keys)
        for dp, shard in ((1, 8), (2, 4)):
            self._mesh_mgr.reshard(dp=dp, shard=shard)
            for batch in self._bloom_added:
                t = (np.arange(batch.size) % 8).astype(np.int32)
                got = bf.contains_each(t, batch)
                assert got.all(), (
                    f"lost {int((~got).sum())} acked bloom adds after reshard "
                    f"to (dp={dp}, shard={shard})"
                )
                self.report.bloom_keys_verified += int(batch.size)

    # -- quiesce + census ----------------------------------------------------

    def _quiesce_census(self, cycle: int) -> Dict[str, float]:
        cfg = self.config
        # re-track the CURRENT live servers (kills/restarts change the set)
        runner = self._runner
        live = [
            n for n in runner.masters + runner.replicas if not n.stopped
        ]
        for i, node in enumerate(live):
            self.census.track_server(f"server{i}", node.server.server)
            self.census.track_engine(f"server{i}.engine", node.server.server.engine)
        # drain: workload is stopped; wait for pools, staging, and record
        # locks to settle (lock-watchdog renewal ticks touch record locks
        # transiently, so we assert on a SETTLED snapshot, not an instant)
        deadline = time.monotonic() + cfg.quiesce_deadline_s
        snap = self.census.snapshot()
        while time.monotonic() < deadline:
            busy = [
                k for k, v in snap.items()
                if v and (
                    k.endswith(".conn_in_use")
                    or k.endswith(".repl_staged_xfers")
                    or k.endswith(".record_locks")
                )
            ]
            if not busy:
                break
            time.sleep(0.2)
            snap = self.census.snapshot()
        # absolute leak assertions (hold at EVERY quiesce, any server set)
        for k, v in snap.items():
            if k.endswith((".conn_in_use", ".repl_staged_xfers", ".record_locks",
                           ".kernel_cache_stale")):
                assert v == 0, f"cycle {cycle}: leaked resource {k} = {v}"
            if k.endswith(".repl_baselines"):
                keys_k = k.replace(".repl_baselines", ".engine.keys")
                limit = snap.get(keys_k)
                if limit is not None:
                    assert v <= limit, (
                        f"cycle {cycle}: {k} = {v} exceeds live keys {limit}"
                    )
        self.report.census.append(snap)
        # flat across quiesce points for the STABLE sources (embedded engine
        # + client): census_before == census_after, not ad-hoc introspection
        if len(self.report.census) > 1:
            stable = ("embedded.record_locks", "embedded.kernel_cache_entries",
                      "embedded.kernel_cache_stale", "client.conn_in_use")
            before = {k: v for k, v in self.report.census[0].items() if k in stable}
            after = {k: v for k, v in snap.items() if k in stable}
            self.census.assert_flat(before, after, context=f"cycle {cycle}")
        return snap

    # -- the run loop --------------------------------------------------------

    def run(self) -> SoakReport:
        cfg = self.config
        self._setup()
        try:
            for cycle in range(cfg.cycles):
                self._workload_phase(cycle, chaos=True)
                if cfg.kill:
                    self._kill_failover_recover()
                    # keep writing through the post-failover topology too
                    self._workload_phase(cycle, chaos=False)
                self._bloom_phase()
                self._quiesce_census(cycle)
                self.report.cycles_completed += 1
            budget = int(cfg.error_budget_ratio * max(1, self.report.acked_writes))
            assert self.report.errors <= budget, (
                f"error budget blown: {self.report.errors} errors vs "
                f"{self.report.acked_writes} acked writes (budget {budget})"
            )
            assert self.report.lock_max_concurrency <= 1, (
                "lock mutual exclusion violated under chaos: "
                f"{self.report.lock_max_concurrency} holders observed"
            )
            return self.report
        finally:
            # aggregate in the failure path too: a mid-run assertion must
            # still report WHICH chaos fired (the first diagnostic needed)
            self.report.injected_faults = {}
            for plane in self._planes:
                for kind, n in plane.injected.items():
                    self.report.injected_faults[kind] = (
                        self.report.injected_faults.get(kind, 0) + n
                    )
            self._teardown()


# -- migration-under-fault profile ----------------------------------

@dataclass
class MigrationSoakConfig:
    cycles: int = 1
    # one coordinator kill per phase per cycle; DRAINING:1 = after the
    # first drain sweep's journal entry (mid-drain death)
    crash_phases: Tuple[str, ...] = (
        "PLANNED", "WINDOW_OPEN", "DRAINING:1", "VIEW_COMMITTED",
    )
    keys: int = 40                 # acked bucket writes riding the moving slots
    writer_threads: int = 2
    seed: int = 0
    transport_faults: bool = True  # delay/drop program over each cycle
    storage_faults: bool = True    # torn-write/ENOSPC checkpoint chaos per cycle
    error_budget_ratio: float = 0.5
    quiesce_deadline_s: float = 15.0
    verify_retries: int = 25
    device: str = "cuda"           # where every node and client lives


@dataclass
class MigrationSoakReport:
    cycles_completed: int = 0
    coordinator_kills: int = 0
    resumed_completed: int = 0
    resumed_rolled_back: int = 0
    acked_writes: int = 0
    verified_writes: int = 0
    errors: int = 0
    checkpoint_fallbacks: int = 0
    bloom_bits_verified: int = 0
    injected_faults: Dict[str, int] = field(default_factory=dict)
    census: List[Dict[str, float]] = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"migration soak: {self.cycles_completed} cycles, "
            f"{self.coordinator_kills} coordinator kills "
            f"({self.resumed_completed} resumed-complete, "
            f"{self.resumed_rolled_back} rolled back), "
            f"{self.acked_writes} acked writes ({self.verified_writes} re-verified), "
            f"{self.errors} budgeted errors, "
            f"{self.checkpoint_fallbacks} checkpoint generation fallbacks, "
            f"bloom bits bit-identical x{self.bloom_bits_verified}, "
            f"faults={self.injected_faults}, census points={len(self.census)}"
        )


# -- cross-process profile -------------------------------------------

@dataclass
class ClusterProcSoakConfig:
    cycles: int = 1
    # per cycle: one coordinator-crash + server-SIGKILL at each phase.
    # DRAINING:1 = after the first drain sweep's journal entry (mid-drain).
    crash_phases: Tuple[str, ...] = ("WINDOW_OPEN", "DRAINING:1")
    # which server process(es) take the SIGKILL next to the dead
    # coordinator: "source" (the historical profile), "target" (the
    # import-side gap — records the source already deleted
    # must come back from the target's import journal), or "both" (the
    # full double-kill matrix)
    victims: str = "source"
    keys: int = 24                 # acked TCP writes riding the moving slots
    writer_threads: int = 2
    seed: int = 0
    bloom_keys: int = 512          # acked bloom adds re-probed after each storm
    error_budget_ratio: float = 2.0  # dead-process windows are real here
    verify_retries: int = 30
    ready_timeout: float = 90.0
    # replicas per master: >0 spawns replica PROCESSES and adds a
    # read_mode="replica" reader thread to the workload, so replica-served
    # reads (staleness probe + master re-serve, the read-scaling plane) are
    # exercised on the multi-process supervisor fleet, not just the
    # in-process harness.  Correctness stays carried by the master-read
    # verify; the reader's errors are budgeted like the mapper's.
    replicas: int = 0
    device: str = "cuda"           # the server processes' --device


@dataclass
class ClusterProcSoakReport:
    cycles_completed: int = 0
    coordinator_kills: int = 0
    server_sigkills: int = 0
    restarts: int = 0
    resumed_completed: int = 0
    resumed_rolled_back: int = 0
    acked_writes: int = 0
    verified_writes: int = 0
    errors: int = 0
    bloom_keys_verified: int = 0
    replica_reads: int = 0
    exit_codes: List[int] = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"cluster-proc soak: {self.cycles_completed} cycles, "
            f"{self.coordinator_kills} coordinator kills + "
            f"{self.server_sigkills} server SIGKILLs "
            f"({self.restarts} supervisor restarts, exit codes "
            f"{self.exit_codes}), "
            f"{self.resumed_completed} resumed-complete / "
            f"{self.resumed_rolled_back} rolled back, "
            f"{self.acked_writes} acked writes "
            f"({self.verified_writes} re-verified), "
            f"{self.errors} budgeted errors, "
            f"bloom={self.bloom_keys_verified} acked adds re-probed"
        )


class ClusterProcSoakHarness:
    """The process-level chaos discipline: a 2-master cluster of
    REAL server OS processes serves a mixed write stream over real
    TCP while a journaled slot migration is storming between them — and at
    a chosen journal phase the coordinator "dies" (``CoordinatorKilled``)
    and a server process is SIGKILLed at that exact journal state: the
    SOURCE master (the historical profile), the import TARGET (its
    boot-time import-journal replay must restore records the source
    already deleted), or BOTH (``config.victims``).  The supervisor
    restarts the dead process(es) (``--restore`` from checkpoint + journal
    re-arm/replay), ``resume_migrations`` replays the journal ACROSS the
    process boundary, and the cycle asserts:

      * **zero acked-durable-write loss** — every write acked before the
        pre-kill ``SAVE`` barrier reads back at its acked value or newer
        (the SIGKILL analog of the standard profile's REPLFLUSH-before-kill
        contract: with no replica, durability is the checkpoint, so the
        covered set is acked-and-saved writes; writes acked in the
        SAVE→SIGKILL window are explicitly NOT covered — that is what
        replicas are for);
      * **exactly-one-owner residency** — after resume, no workload record
        is resident on more than one master (``CLUSTER GETKEYSINSLOT`` on
        every node; a re-drained stale restore copy must lose to the
        target's newer version and then die locally);
      * **all slots STABLE** — no journal left in flight, no node
        reporting a MIGRATING/IMPORTING window (``CLUSTER WINDOWS``);
      * every acked bloom add from setup still probes positive over TCP.

    Runs via ``python -m redisson_tpu_torch.tools.soak_smoke --profile
    cluster-proc`` (<60s) or the slow tier in ``tests/test_cluster_proc.py``.
    """

    def __init__(self, config: Optional[ClusterProcSoakConfig] = None):
        self.config = config or ClusterProcSoakConfig()
        self.report = ClusterProcSoakReport()
        self._rng = np.random.default_rng(self.config.seed)
        self._acked: Dict[str, str] = {}
        self._durable: Dict[str, str] = {}  # acked AND checkpoint-covered
        self._acked_lock = threading.Lock()
        self._sup = None
        self._client = None
        self._keys: List[str] = []
        self._slots: List[int] = []
        self._bloom_name: Optional[str] = None
        self._bloom_keys = None
        self._owner = 0  # masters[_owner] currently holds the moving slots

    # -- setup ----------------------------------------------------------------

    def _make_supervisor(self):
        """The fleet to storm — subclass hook (FleetSoakHarness adds
        replicas + auto-checkpointing)."""
        from redisson_tpu_torch.cluster import ClusterSupervisor

        # server processes run on the config's device (RTPU_PROC_PLATFORM
        # overrides); N processes share one card, each in its own context
        return ClusterSupervisor(
            masters=2, replicas_per_master=self.config.replicas,
            ready_timeout=self.config.ready_timeout,
            platform=_proc_platform(self.config.device),
        )

    def _setup(self) -> None:
        from redisson_tpu_torch.utils.crc16 import calc_slot

        cfg = self.config
        self._sup = self._make_supervisor().start()
        self._client = self._sup.client(
            scan_interval=0.5, timeout=15.0, connect_timeout=5.0,
            retry_attempts=2, retry_interval=0.1,
        )
        assert self._client.wait_routable(timeout=30.0), "cluster never served"
        lo0, hi0 = self._sup.slot_ranges[0]
        self._keys = [
            k for k in (f"procsoak-{i}" for i in range(3000))
            if lo0 <= calc_slot(k.encode()) <= hi0
        ][: cfg.keys]
        assert len(self._keys) >= 8, "key generation failed to fill the range"
        self._bloom_name = next(
            n for n in (f"procsoak:bloom-{j}" for j in range(500))
            if lo0 <= calc_slot(n.encode()) <= hi0
        )
        self._slots = sorted(
            {calc_slot(k.encode()) for k in self._keys}
            | {calc_slot(self._bloom_name.encode())}
        )
        bf = self._client.get_bloom_filter(self._bloom_name)
        bf.try_init(expected_insertions=50_000, false_probability=0.01)
        self._bloom_keys = self._rng.integers(
            0, 1 << 60, cfg.bloom_keys
        ).astype(np.int64)
        newly = bf.add_each(self._bloom_keys)
        assert len(newly) == cfg.bloom_keys, "bloom setup batch truncated"

    def _teardown(self) -> None:
        try:
            if self._client is not None:
                self._client.shutdown()
        finally:
            # the supervisor MUST reap its OS processes even if the client
            # teardown throws — orphaned server processes outlive the
            # test session otherwise
            if self._sup is not None:
                self._sup.shutdown()
                for node in self._sup.nodes():
                    self.report.exit_codes.extend(node.exit_codes)

    # -- workload -------------------------------------------------------------

    def _writer(self, wid: int, cycle: int, stop: threading.Event) -> None:
        client = self._client
        mine = self._keys[wid::self.config.writer_threads]
        i = 0
        while not stop.is_set():
            k = mine[i % len(mine)]
            v = f"c{cycle}-w{wid}-{i}"
            try:
                client.execute("SET", k, v)
                with self._acked_lock:
                    self._acked[k] = v
                    self.report.acked_writes += 1
            except Exception:  # noqa: BLE001 — budgeted chaos error
                with self._acked_lock:
                    self.report.errors += 1
                stop.wait(0.05)  # a dead-process window fails fast; back off
            i += 1
            stop.wait(0.004)

    def _replica_reader(self, stop: threading.Event) -> None:
        """Replica-plane read traffic (config.replicas > 0): GETs on the
        soak keys through a read_mode="replica" client — the bounded-
        staleness probe rides every read (the client's derived default
        offset bound), stale verdicts re-serve from the master, and dead-
        process windows are budgeted errors exactly like the mapper's.
        The run loop asserts the replica plane actually served reads."""
        client = self._sup.client(
            read_mode="replica", scan_interval=0.5, timeout=15.0,
            connect_timeout=5.0, retry_attempts=2, retry_interval=0.1,
        )
        i = 0
        try:
            while not stop.is_set():
                try:
                    client.execute("GET", self._keys[i % len(self._keys)])
                except Exception:  # noqa: BLE001 — budgeted chaos error
                    with self._acked_lock:
                        self.report.errors += 1
                    stop.wait(0.05)
                i += 1
                stop.wait(0.01)
            with self._acked_lock:
                self.report.replica_reads += client.read_stats["replica_reads"]
        finally:
            client.shutdown()

    def _mapper(self, cycle: int, stop: threading.Event) -> None:
        """The 'mixed' half: hash traffic sharing the moving slot range
        (errors budgeted, correctness carried by the SET stream)."""
        # hashtag pins the map into the same (moving) slot as keys[0]
        m = self._client.get_map(f"{{{self._keys[0]}}}:map")
        i = 0
        while not stop.is_set():
            try:
                m.put(f"c{cycle}-{i}", i)
                m.get(f"c{cycle}-{max(0, i - 1)}")
            except Exception:  # noqa: BLE001
                with self._acked_lock:
                    self.report.errors += 1
                stop.wait(0.05)
            i += 1
            stop.wait(0.008)

    @staticmethod
    def _value_seq(v: str) -> Tuple[int, int]:
        parts = v.split("-")
        return int(parts[0][1:]), int(parts[2])

    def _save_barrier(self, min_acked: int = 4, wait_s: float = 15.0) -> None:
        """Checkpoint the CURRENT owner and promote every write acked
        before the SAVE started into the durable (covered) set.

        Waits (bounded) for a few acks to exist first: under heavy machine
        load the writers may not have landed anything yet, and a barrier
        that promotes an empty snapshot would make the later verify
        vacuous — the soak would "pass" having protected nothing."""
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            with self._acked_lock:
                if len(self._acked) >= min(min_acked, len(self._keys)):
                    break
            time.sleep(0.05)
        with self._acked_lock:
            snapshot = dict(self._acked)
        victim = self._sup.masters[self._owner]
        with self._sup.conn(victim, timeout=60.0) as c:
            reply = c.execute("SAVE", timeout=60.0)
            from redisson_tpu_torch.net.resp import RespError

            assert not isinstance(reply, RespError), reply
        self._durable.update(snapshot)

    def _void_unsaved_acks(self) -> None:
        """A SIGKILL voids every ack the victim applied AFTER the SAVE
        barrier (same truth as Redis writes past the last RDB snapshot:
        they die with the process).  Roll the promise set back to the
        durable floor, or the NEXT barrier would promote doomed acks its
        SAVE can no longer cover — the harness would then "detect" a loss
        the durability contract never promised to prevent.  Acks that
        actually landed on a surviving node are conservatively un-promised
        too; they re-enter the promise set the next time their writer gets
        an ack."""
        with self._acked_lock:
            for k in list(self._acked):
                if k in self._durable:
                    self._acked[k] = self._durable[k]
                else:
                    del self._acked[k]

    def _verify_durable(self, sample: Optional[int] = None) -> None:
        """Monotone zero-loss check over the durable set: the stored value
        is the acked-durable one or a NEWER write by the same key's single
        writer — never older, never gone."""
        keys = sorted(self._durable)
        if sample:
            keys = keys[:: max(1, len(keys) // sample)]
        for k in keys:
            got = None
            for _ in range(self.config.verify_retries):
                try:
                    got = self._client.execute("GET", k)
                except Exception:  # noqa: BLE001 — topology still settling
                    got = None
                if got is not None:
                    break
                # nil is retryable too: a read routed while the post-resume
                # topology is still converging can transiently miss; only a
                # PERSISTENT nil is a lost write
                time.sleep(0.2)
            got = bytes(got).decode() if got is not None else None
            want = self._durable[k]
            assert got is not None and (
                self._value_seq(got) >= self._value_seq(want)
            ), f"lost acked-durable write {k!r}: want >= {want!r}, got {got!r}"
            self.report.verified_writes += 1

    def _verify_bloom(self) -> None:
        """Every acked bloom add from setup (pre-first-SAVE, so durable)
        still probes positive through whatever master now owns the slot."""
        bf = self._client.get_bloom_filter(self._bloom_name)
        got = None
        for _ in range(self.config.verify_retries):
            try:
                got = bf.contains_each(self._bloom_keys)
                break
            except Exception:  # noqa: BLE001
                time.sleep(0.2)
        assert got is not None, "bloom probe never answered after the storm"
        got = np.asarray(got)
        assert got.all(), (
            f"lost {int((~got).sum())} acked bloom adds across the "
            "process-kill storm"
        )
        self.report.bloom_keys_verified += int(got.size)

    # -- invariants -----------------------------------------------------------

    def _assert_slots_stable(self) -> None:
        from redisson_tpu_torch.server.migration_journal import MigrationJournal

        assert not MigrationJournal.in_flight(self._sup.journal_dir), (
            "journal left non-terminal migrations behind"
        )
        for node in self._sup.masters:
            with self._sup.conn(node) as c:
                windows = c.execute("CLUSTER", "WINDOWS")
            assert not windows, (
                f"{node.name} left migration windows open: {windows!r}"
            )

    def _assert_one_owner(self) -> None:
        """No workload record resident on more than one PROCESS: asked over
        the wire per node (CLUSTER GETKEYSINSLOT bypasses routing)."""
        holders: Dict[str, int] = {}
        for node in self._sup.masters:
            with self._sup.conn(node) as c:
                for slot in self._slots:
                    names = c.execute(
                        "CLUSTER", "GETKEYSINSLOT", slot, 1_000_000
                    )
                    for n in names or []:
                        n = bytes(n).decode()
                        holders[n] = holders.get(n, 0) + 1
        multi = {n: c for n, c in holders.items() if c > 1}
        assert not multi, f"records resident on multiple processes: {multi}"

    # -- the storm ------------------------------------------------------------

    def _storm(self, cycle: int) -> None:
        import signal as _signal

        from redisson_tpu_torch.cluster.chaos import kill_pair_at_phase
        from redisson_tpu_torch.server.migration import resume_migrations

        sup = self._sup
        kill_source = self.config.victims in ("source", "both")
        kill_target = self.config.victims in ("target", "both")
        assert kill_source or kill_target, self.config.victims
        for phase in self.config.crash_phases:
            src = sup.masters[self._owner]
            dst = sup.masters[1 - self._owner]
            # durability barrier BEFORE the kill: this cycle's covered set
            self._save_barrier()
            rcs = kill_pair_at_phase(
                sup, src, dst, self._slots, phase,
                kill_source=kill_source, kill_target=kill_target,
                sig=_signal.SIGKILL,
            )
            self.report.coordinator_kills += 1
            self.report.server_sigkills += len(rcs)
            for who, rc in rcs.items():
                assert rc == -_signal.SIGKILL, \
                    f"expected SIGKILL death of {who}, got {rc}"
            # The short settle lets in-flight replies (applied+buffered
            # before the kill) finish recording, then the promise set rolls
            # back to the durable floor (see _void_unsaved_acks).
            time.sleep(0.3)
            self._void_unsaved_acks()
            # restart every victim on its old port: the target FIRST, so
            # its boot-time import-journal replay restores the records the
            # source already deleted before the resumed drain re-fences
            for victim in ([dst] if kill_target else []) \
                    + ([src] if kill_source else []):
                sup.restart(victim)  # --restore + journal re-arm/replay
                self.report.restarts += 1
            results = resume_migrations(sup.journal_dir)
            assert results, "resume found no in-flight migration"
            for r in results:
                assert r["action"] in ("completed", "rolled_back"), r
                if r["action"] == "completed":
                    self.report.resumed_completed += 1
                    self._owner = 1 - self._owner
                else:
                    self.report.resumed_rolled_back += 1
            self._client.refresh_topology()
            self._assert_slots_stable()
            self._assert_one_owner()
            self._verify_durable(sample=8)

    # -- the run loop ---------------------------------------------------------

    def run(self) -> ClusterProcSoakReport:
        cfg = self.config
        try:
            # inside the try: _setup spawns real OS processes and then has
            # failure points (wait_routable, key generation) — a setup
            # abort must still reap them via the finally's _teardown
            self._setup()
            for cycle in range(cfg.cycles):
                stop = threading.Event()
                threads = [
                    threading.Thread(target=self._writer, args=(w, cycle, stop))
                    for w in range(cfg.writer_threads)
                ] + [threading.Thread(target=self._mapper, args=(cycle, stop))]
                if cfg.replicas > 0:
                    threads.append(threading.Thread(
                        target=self._replica_reader, args=(stop,)
                    ))
                try:
                    for t in threads:
                        t.start()
                    self._storm(cycle)
                    # post-recovery write window: let the writers land acks
                    # on the HEALED topology before they stop, so the final
                    # verify covers fresh post-storm writes too (writers
                    # parked in retry funnels during recovery may otherwise
                    # contribute nothing after the ack rollback)
                    time.sleep(1.0)
                finally:
                    stop.set()
                    for t in threads:
                        t.join(timeout=90.0)
                assert not any(t.is_alive() for t in threads), "writer wedged"
                # final barrier: everything acked while the cluster was
                # healthy post-storm becomes covered, then full verify
                self._save_barrier()
                self._verify_durable()
                self._verify_bloom()
                self.report.cycles_completed += 1
            budget = int(
                cfg.error_budget_ratio * max(1, self.report.acked_writes)
            )
            assert self.report.errors <= budget, (
                f"error budget blown: {self.report.errors} errors vs "
                f"{self.report.acked_writes} acked writes (budget {budget})"
            )
            if cfg.replicas > 0:
                assert self.report.replica_reads > 0, (
                    "replica fleet spawned but the replica plane served "
                    "zero reads — the read_mode=replica leg never engaged"
                )
            return self.report
        finally:
            self._teardown()


# -- fleet lifecycle profile ----------------------------------------

@dataclass
class FleetSoakConfig(ClusterProcSoakConfig):
    """The fleet-survival profile: replica-covered masters, a rolling
    restart of the live fleet, TARGET double-kills at journal phases,
    a replica-promotion failover of a dead import target, and a
    live-coordinator target SIGKILL — all under client-side transport
    faults."""
    replicas_per_master: int = 1
    crash_phases: Tuple[str, ...] = ("DRAINING:1",)
    victims: str = "target"
    roll_scope: str = "masters"     # "all" | "masters" | "none"
    promote: bool = True            # replica-promotion failover leg
    live_kill: bool = True          # target dies under a LIVE coordinator
    # auto-checkpoint cadence: with it armed, a graceful (SIGTERM) stop
    # flushes on exit, so a rolling restart loses NOTHING acked before the
    # stop — the property the roll leg asserts
    checkpoint_interval: float = 0.5


@dataclass
class FleetSoakReport(ClusterProcSoakReport):
    nodes_rolled: int = 0
    promotions: int = 0
    live_kill_migrations: int = 0

    def summary(self) -> str:
        return (
            super().summary()
            + f"; fleet: {self.nodes_rolled} nodes rolled, "
              f"{self.promotions} replica promotions, "
              f"{self.live_kill_migrations} live-coordinator target kills"
        )


class FleetSoakHarness(ClusterProcSoakHarness):
    """Whole-fleet lifecycle robustness: a 2-master cluster of
    real OS processes, each master replica-covered, serves a mixed write
    stream over real TCP while — under injected client-side transport
    faults — the harness:

      1. **rolls the fleet** (``ClusterSupervisor.rolling_restart``): each
         node drains (REPLFLUSH + SAVE), stops gracefully (escalating
         SIGTERM→SIGKILL), restarts on its address, and the roll only
         advances through the health barrier.  EVERY write acked before
         the roll must survive it — graceful stops flush, so this leg has
         no SAVE-barrier exclusions;
      2. **double-kills the import TARGET** at journal phases (coordinator
         dead at the same instant) and recovers via restart + import-journal
         replay + ``resume_migrations`` — records the source deleted on the
         strength of a journaled ack must come back;
      3. **promotes a replica over a dead target** mid-import
         (``promote_replica`` + ``resume_migrations(readdress=...)``): the
         REPLPUSH-covered batches carry the import forward with the window
         intact, and the old master rejoins as a replica of its successor;
      4. **SIGKILLs the target under a LIVE coordinator** mid-drain: the
         failed ``migrate_slots`` must leave its journal IN FLIGHT (no
         rollback into a fork), and resume completes the pair forward.

    Each cycle ends with the full invariant sweep: zero acked-durable-write
    loss (monotone per-key), exactly-one-owner residency, all slots STABLE
    with every import journal terminal, acked bloom adds intact, and a flat
    client-side resource census.

    Runs via ``python -m redisson_tpu_torch.tools.soak_smoke --profile
    fleet`` (<60s) or the 2-cycle kill-every-phase variant in
    ``tests/test_cluster_proc.py``'s slow tier.
    """

    def __init__(self, config: Optional[FleetSoakConfig] = None):
        super().__init__(config or FleetSoakConfig())
        self.report = FleetSoakReport()

    def _make_supervisor(self):
        from redisson_tpu_torch.cluster import ClusterSupervisor

        cfg = self.config
        return ClusterSupervisor(
            masters=2, replicas_per_master=cfg.replicas_per_master,
            ready_timeout=cfg.ready_timeout,
            checkpoint_interval=cfg.checkpoint_interval,
            platform=_proc_platform(cfg.device),
        )

    def _transport_schedule(self, cycle: int) -> FaultSchedule:
        """Light seed-deterministic client-side noise: the routed client,
        the coordinator's RetryPolicy-riding admin links, and the resume
        path all have to absorb it mid-roll/mid-kill."""
        sched = FaultSchedule(self.config.seed * 9173 + cycle)
        sched.add_random("delay", n=6, window=400, delay_s=0.01)
        sched.add_random("drop", n=2, window=400)
        return sched

    def _relearn_owner(self) -> None:
        """Re-derive which master holds the moving slots by actual record
        residency (the bloom record always exists) — legs whose outcome can
        legitimately be either completed or rolled back re-sync here
        instead of guessing."""
        from redisson_tpu_torch.utils.crc16 import calc_slot

        slot = calc_slot(self._bloom_name.encode())
        for i, node in enumerate(self._sup.masters):
            with self._sup.conn(node) as c:
                names = c.execute("CLUSTER", "GETKEYSINSLOT", slot, 1_000_000)
            if self._bloom_name in {bytes(n).decode() for n in names or []}:
                self._owner = i
                return
        raise AssertionError("bloom record resident on no master")

    # -- legs ------------------------------------------------------------------

    def _roll_leg(self) -> None:
        """Rolling restart under load: pre-roll acks are promoted to the
        covered set BEFORE the roll — the roll's own drain (SAVE +
        flush-on-stop) is the durability mechanism, so losing any of them
        is a failed roll, not an uncovered window."""
        sup = self._sup
        with self._acked_lock:
            snapshot = dict(self._acked)
        nodes = None if self.config.roll_scope == "all" else list(sup.masters)
        rolled = sup.rolling_restart(nodes=nodes)
        for step in rolled:
            assert step["exit_code"] == 0, (
                f"roll step was not graceful: {step}"
            )
        self.report.nodes_rolled += len(rolled)
        self._durable.update(snapshot)
        self._client.refresh_topology()
        self._verify_durable(sample=8)

    def _promote_leg(self, cycle: int) -> None:
        """Target dies mid-import with the coordinator; its replica is
        promoted WITH the in-flight window and the readdressed resume
        drives the pair to STABLE — then the old master rejoins as a
        replica of its successor."""
        import signal as _signal

        from redisson_tpu_torch.cluster.chaos import kill_pair_at_phase
        from redisson_tpu_torch.server.migration import resume_migrations

        sup = self._sup
        src = sup.masters[self._owner]
        dst = sup.masters[1 - self._owner]
        self._save_barrier()
        rcs = kill_pair_at_phase(
            sup, src, dst, self._slots, "DRAINING:1", kill_target=True,
        )
        self.report.coordinator_kills += 1
        self.report.server_sigkills += len(rcs)
        assert rcs["target"] == -_signal.SIGKILL, rcs
        time.sleep(0.3)
        self._void_unsaved_acks()
        promoted = sup.promote_replica(dst)
        assert promoted is not None, "target had no live replica to promote"
        self.report.promotions += 1
        results = resume_migrations(
            sup.journal_dir, readdress={dst.address: promoted.address},
        )
        assert any(r["action"] == "completed" for r in results), results
        self.report.resumed_completed += sum(
            1 for r in results if r["action"] == "completed"
        )
        self._owner = 1 - self._owner
        sup.restart(dst)  # rejoins as a replica of its successor
        self.report.restarts += 1
        self._client.refresh_topology()
        self._assert_slots_stable()
        self._assert_one_owner()
        self._verify_durable(sample=8)

    def _live_kill_leg(self, cycle: int) -> None:
        """The coordinator is ALIVE when its target dies: migrate_slots
        must leave the journal in flight (rolling back would fork the
        journaled-but-deleted records), and restart + resume completes the
        pair forward."""
        import glob
        import signal as _signal

        from redisson_tpu_torch.server.migration import (
            migrate_slots, resume_migrations,
        )

        sup = self._sup
        src = sup.masters[self._owner]
        dst = sup.masters[1 - self._owner]
        self._save_barrier()
        pattern = os.path.join(sup.journal_dir, "*.import")
        before = set(glob.glob(pattern))
        did_kill: List[int] = []

        def killer() -> None:
            # SIGKILL the target the moment its NEW import journal exists —
            # the first batch is durable, the source has begun deleting.
            # Exits only on kill or deadline: a drain that wins the race
            # still gets its (now harmless) late kill, so the leg's
            # did-the-trigger-fire assert below stays race-free.
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if set(glob.glob(pattern)) - before:
                    sup.kill(dst, _signal.SIGKILL)
                    did_kill.append(1)
                    return
                time.sleep(0.002)

        t = threading.Thread(target=killer)
        t.start()
        inline_error = None
        try:
            migrate_slots(
                src.address, dst.address, self._slots,
                journal_dir=sup.journal_dir,
            )
        except BaseException as e:  # noqa: BLE001 — the kill's intended blast
            inline_error = e
        finally:
            t.join(timeout=35.0)
        # a storm whose trigger never fired is a broken storm, not a green
        # one: the kill waits on a NEW .import file, so this also guards
        # EPOCH stamping and target-side journaling end to end
        assert did_kill, "live-kill trigger never fired (no import journal)"
        self.report.server_sigkills += len(did_kill)
        time.sleep(0.3)
        self._void_unsaved_acks()
        sup.restart(dst)
        self.report.restarts += 1
        results = resume_migrations(sup.journal_dir)
        if inline_error is not None:
            # the failed run must have left its journal resumable — the
            # new no-rollback-into-a-dead-target policy
            assert any(
                r["action"] in ("completed", "rolled_back") for r in results
            ), (inline_error, results)
            self.report.resumed_completed += sum(
                1 for r in results if r["action"] == "completed"
            )
        self.report.live_kill_migrations += 1
        self._client.refresh_topology()
        self._relearn_owner()
        self._assert_slots_stable()
        self._assert_one_owner()
        self._verify_durable(sample=8)

    # -- the run loop ----------------------------------------------------------

    def run(self) -> FleetSoakReport:
        cfg = self.config
        try:
            self._setup()
            census = ResourceCensus()
            census.track_client("client", self._client)
            for cycle in range(cfg.cycles):
                stop = threading.Event()
                threads = [
                    threading.Thread(target=self._writer, args=(w, cycle, stop))
                    for w in range(cfg.writer_threads)
                ] + [threading.Thread(target=self._mapper, args=(cycle, stop))]
                plane = FaultPlane(self._transport_schedule(cycle))
                base = census.snapshot()
                try:
                    for t in threads:
                        t.start()
                    with plane.active():
                        if cfg.roll_scope != "none":
                            self._roll_leg()
                        self._storm(cycle)  # target double-kills per phase
                        if cfg.promote:
                            self._promote_leg(cycle)
                        if cfg.live_kill:
                            self._live_kill_leg(cycle)
                    time.sleep(1.0)  # post-recovery acks on the healed fleet
                finally:
                    stop.set()
                    for t in threads:
                        t.join(timeout=90.0)
                assert not any(t.is_alive() for t in threads), "writer wedged"
                self._save_barrier()
                self._verify_durable()
                self._verify_bloom()
                self._assert_slots_stable()
                self._assert_one_owner()
                # quiesce, then the census must be flat: no connection,
                # push, or near-cache growth survives a full fleet cycle
                time.sleep(0.5)
                census.assert_flat(
                    base, census.snapshot(),
                    ignore=("client.conn_idle", "client.node_clients"),
                    context=f"fleet cycle {cycle}",
                )
                self.report.cycles_completed += 1
            budget = int(
                cfg.error_budget_ratio * max(1, self.report.acked_writes)
            )
            assert self.report.errors <= budget, (
                f"error budget blown: {self.report.errors} errors vs "
                f"{self.report.acked_writes} acked writes (budget {budget})"
            )
            return self.report
        finally:
            self._teardown()


# -- cross-host fleet profile ---------------------------------------

@dataclass
class HostFleetSoakConfig(FleetSoakConfig):
    """The failure-DOMAIN profile: the fleet spans host labels under the
    REAL ssh driver pipeline (loopback transport — no sshd in CI),
    placement is host-anti-affine, the bus is TLS-armed, and the storm
    takes out a whole HOST — every process on it at once — while the
    network to that host partitions mid-drain."""
    hosts: Tuple[str, ...] = ("hostA", "hostB")
    crash_phases: Tuple[str, ...] = ("DRAINING:1",)
    # the host kill IS this profile's storm and failover; the
    # single-process roll/promote/live-kill legs stay with the plain
    # fleet profile
    roll_scope: str = "none"
    promote: bool = False
    live_kill: bool = False
    # partition shape while the host is dark: a couple of swallowed
    # in-flight frames (the wire died mid-send) + a refused-connect
    # window (new dials to an unreachable machine fail fast for a dialer
    # with a deadline — and keep the <60s smoke budget honest, unlike a
    # swallow that parks the writer on its full reply timeout)
    partition_sends: int = 2
    partition_connects: int = 32


@dataclass
class HostFleetSoakReport(FleetSoakReport):
    host_kills: int = 0
    hosts_partitioned: int = 0

    def summary(self) -> str:
        return (
            super().summary()
            + f"; host: {self.host_kills} whole-host kills "
              f"({self.hosts_partitioned} partitioned mid-drain)"
        )


class HostFleetSoakHarness(FleetSoakHarness):
    """Whole-host chaos: two masters + their replicas placed
    across two HOST labels with anti-affinity (a replica never shares its
    master's failure domain), spawned through the real
    :class:`~redisson_tpu_torch.cluster.hostdriver.SshHostDriver` command
    pipeline (remote-spawn script, READY over the channel, signals by
    remote kill) with the loopback transport standing in for the ssh hop,
    and the cross-host bus TLS-armed by the supervisor exactly as a real
    fleet would be.  A mixed write stream runs over real (TLS) TCP while,
    per cycle:

      1. a journaled migration is crashed mid-drain (coordinator dead,
         journal frozen at ``DRAINING:1``);
      2. the import TARGET's whole host dies AT ONCE (``kill_host`` —
         the target master AND the other master's replica share it) and
         the network to that host partitions (swallowed frames + refused
         dials) while it is dark;
      3. the partition heals, the processes stay dead, and recovery runs
         in dependency order: the surviving master's replica restarts and
         re-wires; the dead target fails over onto its OFF-host replica
         (``promote_replica`` — alive precisely because placement was
         anti-affine); the import resumes READDRESSED to the promoted
         node; the old target rejoins as a replica of its successor.

    Each cycle ends with the full sweep: zero acked-durable-write loss,
    exactly-one-owner residency, all slots STABLE with journals terminal,
    acked bloom adds intact, flat client census.

    Runs via ``python -m redisson_tpu_torch.tools.soak_smoke --profile
    fleet-host`` (<60s) or the 2-cycle host-kill matrix in ``tests/test_soak.py``'s slow
    tier.
    """

    def __init__(self, config: Optional[HostFleetSoakConfig] = None):
        super().__init__(config or HostFleetSoakConfig())
        self.report = HostFleetSoakReport()
        self._cycle_sched: Optional[FaultSchedule] = None

    def _make_supervisor(self):
        from redisson_tpu_torch.cluster import ClusterSupervisor
        from redisson_tpu_torch.cluster.hostdriver import (
            LoopbackTransport, SshHostDriver,
        )

        cfg = self.config
        return ClusterSupervisor(
            masters=2, replicas_per_master=cfg.replicas_per_master,
            hosts=list(cfg.hosts),
            driver=SshHostDriver(transport=LoopbackTransport()),
            ready_timeout=cfg.ready_timeout,
            checkpoint_interval=cfg.checkpoint_interval,
            platform=_proc_platform(cfg.device),
        )

    def _setup(self) -> None:
        super()._setup()
        sup = self._sup
        # the properties the storm depends on, asserted up front so a
        # placement/TLS regression fails HERE and not as a mystery
        # promotion failure mid-storm
        assert sup.tls_armed, "cross-host fleet must arm TLS"
        for rep in sup.replicas:
            master = sup.masters[rep.master_index]
            assert rep.host_label != master.host_label, (
                f"anti-affinity violated: {rep.name}@{rep.host_label} "
                f"shares {master.name}'s host"
            )

    def _transport_schedule(self, cycle: int) -> FaultSchedule:
        # stashed so _storm can graft the host-partition rules onto the
        # plane the run loop already activated (the matcher reads the
        # schedule's rule list live)
        self._cycle_sched = super()._transport_schedule(cycle)
        return self._cycle_sched

    def _storm(self, cycle: int) -> None:
        import signal as _signal

        from redisson_tpu_torch.cluster.chaos import crash_coordinator_at
        from redisson_tpu_torch.server.migration import resume_migrations

        sup = self._sup
        for phase in self.config.crash_phases:
            src = sup.masters[self._owner]
            dst = sup.masters[1 - self._owner]
            victim_host = dst.host_label
            victim_ports = tuple(sorted(
                n.port for n in sup.nodes_on(victim_host)
            ))
            self._save_barrier()
            # the coordinator dies mid-drain, journal frozen at `phase`...
            crash_coordinator_at(
                src.address, dst.address, self._slots, sup.journal_dir,
                phase, password=sup.password,
                ssl_context=sup.client_ssl_context(),
            )
            # ...the target's whole failure domain drops off the network...
            faults = [
                self._cycle_sched.add(
                    "partition_out", ports=victim_ports,
                    count=self.config.partition_sends,
                ),
                self._cycle_sched.add(
                    "refuse_connect", ports=victim_ports,
                    count=self.config.partition_connects,
                ),
            ]
            self.report.hosts_partitioned += 1
            # ...and every process on the host dies at once
            rcs = sup.kill_host(victim_host, _signal.SIGKILL)
            self.report.coordinator_kills += 1
            self.report.host_kills += 1
            self.report.server_sigkills += len(rcs)
            assert dst.name in rcs, rcs
            assert len(rcs) >= 2, (
                f"host held one process, not a failure domain: {rcs}"
            )
            for who, rc in rcs.items():
                assert rc == -_signal.SIGKILL, \
                    f"expected SIGKILL death of {who}, got {rc}"
            time.sleep(0.3)
            self._void_unsaved_acks()
            # the partition heals (the network comes back; the processes
            # stay dead): zero the windows in place — the plane's matcher
            # reads rule counts live, so recovery links are clean
            for f in faults:
                f.count = 0
            # recovery in dependency order: (1) every CO-victim that died
            # with the host restarts and re-wires — the other master's
            # replica, and (after a prior cycle's failover moved mastership
            # around) possibly the migration SOURCE master itself, which
            # resume needs alive; (2) the dead target fails over onto its
            # off-host replica; (3) the journaled import resumes
            # READDRESSED to the promoted node; (4) the old target rejoins
            # as a replica of its successor
            for n in sup.nodes_on(victim_host):
                if n is not dst:
                    sup.restart(n)
                    self.report.restarts += 1
            promoted = sup.promote_replica(dst)
            assert promoted is not None, (
                "anti-affinity left no live replica to promote"
            )
            self.report.promotions += 1
            results = resume_migrations(
                sup.journal_dir,
                readdress={dst.address: promoted.address},
                ssl_context=sup.client_ssl_context(),
            )
            assert any(r["action"] == "completed" for r in results), results
            self.report.resumed_completed += sum(
                1 for r in results if r["action"] == "completed"
            )
            self._owner = 1 - self._owner
            sup.restart(dst)  # rejoins as a replica of its successor
            self.report.restarts += 1
            self._client.refresh_topology()
            self._assert_slots_stable()
            self._assert_one_owner()
            self._verify_durable(sample=8)


class MigrationSoakHarness:
    """Kill-the-coordinator endurance: a 2-master cluster serves a mixed
    write stream while journaled slot migrations are murdered at every
    phase boundary and resumed, and checkpoint storage is corrupted under
    it.  The acceptance property: every cycle ends with all slots STABLE
    on exactly one owner, every acked write readable at its acked value,
    a quiesced device record bit-identical to its pre-storm snapshot, the
    last good checkpoint generation loadable, and a flat census."""

    def __init__(self, config: Optional[MigrationSoakConfig] = None):
        self.config = config or MigrationSoakConfig()
        self.report = MigrationSoakReport()
        self.census = ResourceCensus()
        self._rng = np.random.default_rng(self.config.seed)
        self._acked: Dict[str, str] = {}
        self._acked_lock = threading.Lock()
        self._runner = None
        self._client = None
        self._journal_dir: Optional[str] = None
        self._keys: List[str] = []
        self._slots: List[int] = []
        self._bloom_name: Optional[str] = None
        self._planes: List[FaultPlane] = []

    # -- setup ----------------------------------------------------------------

    def _setup(self) -> None:
        from redisson_tpu_torch.harness import ClusterRunner
        from redisson_tpu_torch.utils.crc16 import calc_slot

        self._runner = ClusterRunner(masters=2, device=self.config.device).run()
        self._client = self._runner.client(
            scan_interval=0.5, timeout=10.0, connect_timeout=5.0,
            retry_attempts=2, retry_interval=0.1,
        )
        self._journal_dir = tempfile.mkdtemp(prefix="rtpu-migsoak-journal-")
        lo0, hi0 = self._runner.slot_ranges[0]
        self._keys = [
            k for k in (f"migsoak-{i}" for i in range(2000))
            if lo0 <= calc_slot(k.encode()) <= hi0
        ][: self.config.keys]
        assert len(self._keys) >= 10, "key generation failed to fill the range"
        self._bloom_name = next(
            n for n in (f"migsoak:bloom-{j}" for j in range(500))
            if lo0 <= calc_slot(n.encode()) <= hi0
        )
        self._slots = sorted(
            {calc_slot(k.encode()) for k in self._keys}
            | {calc_slot(self._bloom_name.encode())}
        )
        bf = self._client.get_bloom_filter(self._bloom_name)
        bf.try_init(expected_insertions=50_000, false_probability=0.01)
        bf.add(self._rng.integers(0, 1 << 60, 512).astype(np.int64))
        self.census.track_client("client", self._client)
        self.census.track_checkpoints("checkpoint")
        for i, m in enumerate(self._runner.masters):
            self.census.track_server(f"m{i}", m.server.server)
            self.census.track_engine(f"m{i}.engine", m.server.server.engine)

    def _teardown(self) -> None:
        if self._client is not None:
            self._client.shutdown()
        if self._runner is not None:
            self._runner.shutdown()

    def _transport_schedule(self, cycle: int) -> FaultSchedule:
        """Light seed-deterministic noise: delays plus a few drops — the
        RetryPolicy-riding admin links must absorb them mid-migration."""
        sched = FaultSchedule(self.config.seed * 6151 + cycle)
        sched.add_random("delay", n=6, window=300, delay_s=0.01)
        sched.add_random("drop", n=2, window=300)
        return sched

    # -- workload -------------------------------------------------------------

    def _writer(self, wid: int, cycle: int, stop: threading.Event) -> None:
        client = self._client
        mine = self._keys[wid::self.config.writer_threads]
        i = 0
        while not stop.is_set():
            k = mine[i % len(mine)]
            v = f"c{cycle}-w{wid}-{i}"
            try:
                client.execute("SET", k, v)
                with self._acked_lock:
                    self._acked[k] = v
                    self.report.acked_writes += 1
            except Exception:  # noqa: BLE001 — budgeted chaos error
                with self._acked_lock:
                    self.report.errors += 1
            i += 1
            time.sleep(0.004)

    @staticmethod
    def _value_seq(v: str) -> Tuple[int, int]:
        """Order a writer value ``c<cycle>-w<wid>-<i>``: each key has ONE
        writer, so its stored value advances monotonically in (cycle, i)."""
        parts = v.split("-")
        return int(parts[0][1:]), int(parts[2])

    def _verify_acked(self, sample: Optional[int] = None) -> None:
        """Zero acked-write LOSS: the stored value must be the acked one or
        a NEWER write by the same key's writer (the writer keeps running
        during verification, and a timed-out-but-applied SET is allowed to
        land — what must never happen is the value going BACKWARDS or
        vanishing)."""
        with self._acked_lock:
            acked = dict(self._acked)
        keys = sorted(acked)
        if sample:
            keys = keys[:: max(1, len(keys) // sample)]
        for k in keys:
            got = None
            for _ in range(self.config.verify_retries):
                try:
                    got = self._client.execute("GET", k)
                    break
                except Exception:  # noqa: BLE001 — topology still settling
                    time.sleep(0.2)
            got = bytes(got).decode() if got is not None else None
            assert got is not None and (
                self._value_seq(got) >= self._value_seq(acked[k])
            ), f"lost acked write {k!r}: want >= {acked[k]!r}, got {got!r}"
            self.report.verified_writes += 1

    # -- migration storm ------------------------------------------------------

    def _owner_engines(self):
        return [m.server.server for m in self._runner.masters]

    def _assert_slots_stable(self) -> None:
        from redisson_tpu_torch.server.migration_journal import MigrationJournal

        assert not MigrationJournal.in_flight(self._journal_dir), (
            "journal left non-terminal migrations behind"
        )
        for srv in self._owner_engines():
            assert not srv.migrating_slots, (
                f"slots left MIGRATING on {srv.address()}: {srv.migrating_slots}"
            )
            assert not srv.importing_slots, (
                f"slots left IMPORTING on {srv.address()}: {srv.importing_slots}"
            )

    def _assert_one_owner(self) -> None:
        """Every workload key lives on EXACTLY one master's store."""
        stores = [s.engine.store for s in self._owner_engines()]
        for name in self._keys + [self._bloom_name]:
            holders = sum(1 for st in stores if st.exists(name))
            # a key never successfully written exists nowhere — only assert
            # single-residency for ones that do exist
            assert holders <= 1, f"record {name!r} resident on {holders} masters"

    def _bloom_snapshot(self):
        for srv in self._owner_engines():
            rec = srv.engine.store.get(self._bloom_name)
            if rec is not None:
                return {k: np.asarray(v).copy() for k, v in rec.arrays.items()}
        raise AssertionError(f"bloom record {self._bloom_name!r} not found")

    def _assert_bloom_bit_identical(self, before) -> None:
        after = self._bloom_snapshot()
        assert set(before) == set(after), "bloom arrays changed shape set"
        for k in before:
            assert np.array_equal(before[k], after[k]), (
                f"bloom plane {k!r} not bit-identical after faulted migration"
            )
            self.report.bloom_bits_verified += int(before[k].size)

    def _migration_storm(self, cycle: int) -> None:
        """Kill the coordinator at every journal phase; resume each time."""
        from redisson_tpu_torch.server.migration import (
            CoordinatorKilled, migrate_slots, resume_migrations,
        )

        masters = self._runner.masters
        # who currently owns the moving slots (cycle > 0 may have flipped)
        owner = next(
            i for i, m in enumerate(masters)
            if m.server.server.engine.store.exists(self._bloom_name)
        )
        for phase in self.config.crash_phases:
            src, dst = masters[owner], masters[1 - owner]
            try:
                migrate_slots(
                    src.address, dst.address, self._slots,
                    journal_dir=self._journal_dir, crash_after=phase,
                )
                raise AssertionError(f"crash_after={phase!r} did not fire")
            except CoordinatorKilled:
                self.report.coordinator_kills += 1
            results = resume_migrations(self._journal_dir)
            assert results, "resume found no in-flight migration"
            for r in results:
                assert r["action"] in ("completed", "rolled_back"), r
                if r["action"] == "completed":
                    self.report.resumed_completed += 1
                    owner = 1 - owner
                else:
                    self.report.resumed_rolled_back += 1
            self._client.refresh_topology()
            self._assert_slots_stable()
            self._assert_one_owner()
            self._verify_acked(sample=10)

    # -- checkpoint chaos -----------------------------------------------------

    def _checkpoint_chaos(self, cycle: int) -> None:
        """Good save → torn-write save (head corrupt) → load falls back to
        the good generation; ENOSPC save fails loudly and leaves the
        lineage untouched."""
        import redisson_tpu_torch
        from redisson_tpu_torch.core import checkpoint

        engine = self._runner.masters[0].server.server.engine
        path = os.path.join(self._journal_dir, f"cycle{cycle}.ckpt")
        n_good = checkpoint.save(engine, path)
        sched = FaultSchedule(self.config.seed * 31 + cycle)
        sched.add("torn_write", after=0, count=1, torn_frac=0.5)
        sched.add("enospc", after=1, count=1)
        plane = FaultPlane(sched)
        self._planes.append(plane)
        with plane.active():
            checkpoint.save(engine, path)         # head torn (media lied)
            try:
                checkpoint.save(engine, path)     # disk full: loud failure
                raise AssertionError("ENOSPC fault did not surface")
            except OSError:
                pass
        before = dict(checkpoint.STATS)
        fresh = redisson_tpu_torch.create(device=self.config.device)
        try:
            n_loaded = checkpoint.load(fresh._engine, path)
            assert n_loaded == n_good, (
                f"fallback generation lost records: {n_loaded} != {n_good}"
            )
        finally:
            fresh.shutdown()
        assert checkpoint.STATS["generation_fallbacks"] > before.get(
            "generation_fallbacks", 0
        ), "torn head did not register a generation fallback"
        self.report.checkpoint_fallbacks += 1

    # -- quiesce --------------------------------------------------------------

    def _quiesce_census(self, cycle: int) -> None:
        deadline = time.monotonic() + self.config.quiesce_deadline_s
        snap = self.census.snapshot()
        while time.monotonic() < deadline:
            busy = [
                k for k, v in snap.items()
                if v and (
                    k.endswith(".conn_in_use")
                    or k.endswith(".repl_staged_xfers")
                    or k.endswith(".record_locks")
                )
            ]
            if not busy:
                break
            time.sleep(0.2)
            snap = self.census.snapshot()
        for k, v in snap.items():
            if k.endswith((".conn_in_use", ".repl_staged_xfers",
                           ".record_locks", ".kernel_cache_stale")):
                assert v == 0, f"cycle {cycle}: leaked resource {k} = {v}"
        self.report.census.append(snap)

    # -- the run loop ---------------------------------------------------------

    def run(self) -> MigrationSoakReport:
        cfg = self.config
        self._setup()
        try:
            for cycle in range(cfg.cycles):
                bloom_before = self._bloom_snapshot()
                stop = threading.Event()
                threads = [
                    threading.Thread(target=self._writer, args=(w, cycle, stop))
                    for w in range(cfg.writer_threads)
                ]
                ctx = None
                if cfg.transport_faults:
                    plane = FaultPlane(self._transport_schedule(cycle))
                    self._planes.append(plane)
                    ctx = plane.active()
                    ctx.__enter__()
                try:
                    for t in threads:
                        t.start()
                    self._migration_storm(cycle)
                finally:
                    stop.set()
                    for t in threads:
                        t.join(timeout=90.0)
                    if ctx is not None:
                        ctx.__exit__(None, None, None)
                assert not any(t.is_alive() for t in threads), "writer wedged"
                self._verify_acked()           # EVERY acked write, exact value
                self._assert_bloom_bit_identical(bloom_before)
                if cfg.storage_faults:
                    self._checkpoint_chaos(cycle)
                self._quiesce_census(cycle)
                self.report.cycles_completed += 1
            budget = int(
                cfg.error_budget_ratio * max(1, self.report.acked_writes)
            )
            assert self.report.errors <= budget, (
                f"error budget blown: {self.report.errors} errors vs "
                f"{self.report.acked_writes} acked writes (budget {budget})"
            )
            return self.report
        finally:
            self.report.injected_faults = {}
            for plane in self._planes:
                for kind, n in plane.injected.items():
                    self.report.injected_faults[kind] = (
                        self.report.injected_faults.get(kind, 0) + n
                    )
            self._teardown()


# -- tracking / near-cache profile ----------------------------------

@dataclass
class TrackingSoakConfig:
    """Zipf readers with server-assisted near caches while a master dies
    (failover) and slots migrate — the coherence storm for the CLIENT
    TRACKING plane."""

    seed: int = 0
    cycles: int = 1
    keys: int = 48
    readers: int = 3
    writer_threads: int = 2
    phase_seconds: float = 1.2
    migrate_count: int = 4          # slots round-tripped m0 -> m1 -> m0
    kill: bool = True
    failover_deadline_s: float = 45.0
    quiesce_deadline_s: float = 10.0
    device: str = "cuda"           # where every node and client lives


@dataclass
class TrackingSoakReport:
    cycles_completed: int = 0
    reads: int = 0
    writes_acked: int = 0
    errors: int = 0
    stale_reads: int = 0            # monotonicity violations (MUST stay 0)
    migrations: int = 0
    failovers: int = 0
    records_migrated: int = 0
    converged_keys: int = 0
    cache_stats: List[Dict[str, float]] = field(default_factory=list)
    census: List[Dict[str, float]] = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"tracking soak: {self.cycles_completed} cycles, "
            f"{self.reads} tracked reads ({self.stale_reads} stale), "
            f"{self.writes_acked} acked writes, {self.errors} budgeted "
            f"errors, {self.migrations} slot round-trips "
            f"({self.records_migrated} records), {self.failovers} failovers, "
            f"{self.converged_keys} keys converged, "
            f"census points={len(self.census)}"
        )


class TrackingSoakHarness:
    """The coherence invariant, under fire: **no tracked read may ever go
    BACKWARDS** (per reader, per key — once a reader observed version v of
    a key, serving v' < v later means an invalidation was lost while the
    near cache kept answering), and after the storm quiesces every reader's
    near-cache view must CONVERGE to ground truth.  Plus the leak half:
    server tracking tables must drain to zero when reader connections die
    (disconnect cleanup), asserted through the census.

    Storm per cycle: zipf readers + per-key-single-writer streams run while
    (1) a batch of key-bearing slots migrates m0 -> m1 and back (the
    invalidation-on-handoff path, both directions), then (2) the master
    owning the write tag is killed, the FailoverCoordinator promotes its
    replica, and the dead node restarts as a replica (the SIGKILL-failover
    analog of the in-process tier — writers pause over the REPLFLUSH+kill
    window so replica lag cannot fake a staleness signal).
    """

    def __init__(self, config: Optional[TrackingSoakConfig] = None):
        self.config = config or TrackingSoakConfig()
        self.report = TrackingSoakReport()
        self.census = ResourceCensus()
        self._rng = np.random.default_rng(self.config.seed)
        self._runner = None
        self._coord = None
        self._writer_client = None
        self._readers = []            # (client, plane, {key: bucket})
        # per-reader high-water marks, shared ACROSS phases: the workload
        # runs as many short _phase() slices, and a backwards read right
        # after a slice boundary (exactly where the handoff/kill legs sit)
        # must still count as stale — a per-slice memory would reset and
        # silently accept it
        self._reader_last: List[Dict[str, int]] = []
        self._acked: Dict[str, int] = {}
        self._acked_lock = threading.Lock()
        self._failovers_seen = 0
        self._violations: List[str] = []

    # -- lifecycle -----------------------------------------------------------

    def _key(self, i: int) -> str:
        return f"tk:{i}"

    def _setup(self) -> None:
        from redisson_tpu_torch.harness import ClusterRunner
        from redisson_tpu_torch.server.monitor import FailoverCoordinator

        cfg = self.config
        self._runner = ClusterRunner(
            masters=2, replicas_per_master=1, device=cfg.device,
        ).run()
        self._writer_client = self._runner.client(
            scan_interval=0.5, timeout=10.0, connect_timeout=5.0,
            retry_attempts=1, retry_interval=0.2,
        )
        # preload every key so readers never see a first-write race
        for i in range(cfg.keys):
            self._writer_client.get_bucket(self._key(i)).set(0)
            self._acked[self._key(i)] = 0
        for _r in range(cfg.readers):
            c = self._runner.client(
                scan_interval=0.5, timeout=10.0, connect_timeout=5.0,
                retry_attempts=1, retry_interval=0.2,
            )
            plane = c.enable_tracking(cache_entries=8 * cfg.keys)
            buckets = {
                self._key(i): plane.get_bucket(self._key(i))
                for i in range(cfg.keys)
            }
            self._readers.append((c, plane, buckets))
            self._reader_last.append({})
        if cfg.kill:
            self._coord = FailoverCoordinator(
                self._runner.view_tuples(), check_interval=0.1
            ).start()
            time.sleep(0.5)  # coordinator learns the replica sets
        self.census.track_client("writer", self._writer_client)

    def _teardown(self) -> None:
        if self._coord is not None:
            self._coord.stop()
        for c, _plane, _b in self._readers:
            try:
                c.shutdown()
            except Exception:  # noqa: BLE001
                pass
        if self._writer_client is not None:
            self._writer_client.shutdown()
        if self._runner is not None:
            self._runner.shutdown()

    # -- workload ------------------------------------------------------------

    def _writer(self, wid: int, stop: threading.Event) -> None:
        cfg = self.config
        client = self._writer_client
        my_keys = [self._key(i) for i in range(wid, cfg.keys, cfg.writer_threads)]
        vals = {k: self._acked.get(k, 0) for k in my_keys}
        j = 0
        while not stop.is_set():
            k = my_keys[j % len(my_keys)]
            v = vals[k] + 1
            try:
                client.get_bucket(k).set(v)
                vals[k] = v
                with self._acked_lock:
                    self._acked[k] = v
                    self.report.writes_acked += 1
            except Exception:  # noqa: BLE001 — budgeted outage-window error
                with self._acked_lock:
                    self.report.errors += 1
            j += 1
            time.sleep(0.002)

    def _reader(self, rid: int, stop: threading.Event) -> None:
        cfg = self.config
        _c, _plane, buckets = self._readers[rid]
        rng = np.random.default_rng(self.config.seed * 131 + rid)
        p = 1.0 / np.power(np.arange(1, cfg.keys + 1), 1.0)
        p /= p.sum()
        last = self._reader_last[rid]  # spans phases (see __init__)
        n = 0
        while not stop.is_set():
            k = self._key(int(rng.choice(cfg.keys, p=p)))
            try:
                v = buckets[k].get()
            except Exception:  # noqa: BLE001 — budgeted outage-window error
                with self._acked_lock:
                    self.report.errors += 1
                time.sleep(0.01)
                continue
            n += 1
            if v is not None:
                prev = last.get(k)
                if prev is not None and v < prev:
                    with self._acked_lock:
                        self.report.stale_reads += 1
                        self._violations.append(
                            f"reader {rid} key {k}: saw {v} after {prev}"
                        )
                if prev is None or v > prev:
                    last[k] = v
        with self._acked_lock:
            self.report.reads += n

    def _phase(self, seconds: float, writers: bool = True) -> None:
        stop = threading.Event()
        threads = [
            threading.Thread(target=self._reader, args=(r, stop), daemon=True)
            for r in range(self.config.readers)
        ]
        if writers:
            threads += [
                threading.Thread(target=self._writer, args=(w, stop), daemon=True)
                for w in range(self.config.writer_threads)
            ]
        for t in threads:
            t.start()
        time.sleep(seconds)
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads), "tracking soak worker wedged"

    # -- chaos ops -----------------------------------------------------------

    def _migrate_roundtrip(self) -> None:
        """Migrate a batch of key-bearing slots m0 -> m1 and BACK while the
        readers run: both directions exercise the drain-stream + handoff
        invalidations, and the round-trip restores the canonical view so
        the failover bookkeeping (runner.slot_ranges) stays truthful."""
        from redisson_tpu_torch.server.migration import migrate_slots
        from redisson_tpu_torch.utils.crc16 import calc_slot

        cfg = self.config
        runner = self._runner
        lo, hi = runner.slot_ranges[0]
        key_slots = []
        for i in range(cfg.keys):
            s = calc_slot(self._key(i).encode())
            if lo <= s <= hi and s not in key_slots:
                key_slots.append(s)
            if len(key_slots) >= cfg.migrate_count:
                break
        if not key_slots:
            return
        src = runner.masters[0].address
        dst = runner.masters[1].address
        nodes = runner.seeds()
        moved = migrate_slots(src, dst, key_slots, all_nodes=nodes)
        self.report.records_migrated += moved
        moved = migrate_slots(dst, src, key_slots, all_nodes=nodes)
        self.report.records_migrated += moved
        self.report.migrations += 1
        for c in [self._writer_client] + [c for c, _p, _b in self._readers]:
            c.refresh_topology()

    def _reconcile_failovers(self) -> None:
        runner, coord = self._runner, self._coord
        fos = coord.failovers
        while self._failovers_seen < len(fos):
            dead_addr, promoted_addr = fos[self._failovers_seen]
            self._failovers_seen += 1
            self.report.failovers += 1
            dead = runner.adopt_failover(dead_addr, promoted_addr)
            if dead is not None and dead.stopped:
                runner.restart_node(dead)

    def _kill_failover(self) -> None:
        """SIGKILL-analog on the master owning key 0's slot: writers are
        ALREADY paused (the calling phase ran readers-only), the victim
        REPLFLUSHes so its replica holds every acked value, then it dies
        abruptly and the coordinator promotes."""
        from redisson_tpu_torch.harness import _exec
        from redisson_tpu_torch.utils.crc16 import calc_slot

        cfg = self.config
        runner, coord = self._runner, self._coord
        self._reconcile_failovers()
        slot = calc_slot(self._key(0).encode())
        mi = next(
            i for i, (lo, hi) in enumerate(runner.slot_ranges) if lo <= slot <= hi
        )
        victim = runner.masters[mi]
        victim_addr = victim.address
        with victim.server.client() as c:
            _exec(c, "REPLFLUSH", timeout=60.0)
        seen = self._failovers_seen
        runner.stop_master(mi)
        deadline = time.monotonic() + cfg.failover_deadline_s
        while time.monotonic() < deadline and not any(
            d == victim_addr for d, _p in coord.failovers[seen:]
        ):
            time.sleep(0.1)
        assert any(
            d == victim_addr for d, _p in coord.failovers[seen:]
        ), "no automatic failover happened"
        self._reconcile_failovers()
        time.sleep(0.5)
        for c in [self._writer_client] + [c for c, _p, _b in self._readers]:
            c.refresh_topology()

    # -- convergence + leak checks -------------------------------------------

    def _verify_convergence(self) -> None:
        """Writers stopped, pushes drained: every reader's tracked read must
        equal ground truth for every key (bounded retry per key covers an
        invalidation still in flight when the phase stopped)."""
        cfg = self.config
        with self._acked_lock:
            acked = dict(self._acked)
        ground = self._runner.client(scan_interval=0, timeout=10.0)
        try:
            for i in range(cfg.keys):
                k = self._key(i)
                truth = None
                for _ in range(20):
                    try:
                        truth = ground.get_bucket(k).get()
                        break
                    except Exception:  # noqa: BLE001 — topology settling
                        time.sleep(0.2)
                # durability invariant is truth >= acked (values per key are
                # monotonic from a single writer): a write that APPLIED but
                # whose ack was lost to a budgeted error leaves truth one
                # AHEAD of acked — that is not loss; truth BEHIND acked is
                assert truth is not None and truth >= acked[k], (
                    f"acked write lost: {k} want >= {acked[k]!r} got {truth!r}"
                )
                for rid, (rc, _plane, buckets) in enumerate(self._readers):
                    got = None
                    for _ in range(25):
                        try:
                            got = buckets[k].get()
                        except Exception:  # noqa: BLE001 — topology settling
                            try:
                                rc.refresh_topology()
                            except Exception:  # noqa: BLE001
                                pass
                            time.sleep(0.2)
                            continue
                        if got == truth:
                            break
                        time.sleep(0.1)
                    assert got == truth, (
                        f"STALE near-cache read after quiesce: reader {rid} "
                        f"key {k} want {truth!r} got {got!r}"
                    )
                self.report.converged_keys += 1
        finally:
            ground.shutdown()

    def _quiesce_census(self, cycle: int) -> None:
        cfg = self.config
        runner = self._runner
        live = [n for n in runner.masters + runner.replicas if not n.stopped]
        for i, node in enumerate(live):
            self.census.track_server(f"server{i}", node.server.server)
        # readers disconnect: every tracked key and tracking conn must leave
        # the server tables with them (the disconnect-cleanup contract)
        for c, plane, _b in self._readers:
            self.report.cache_stats.append(plane.stats())
            c.shutdown()
        self._readers = []
        deadline = time.monotonic() + cfg.quiesce_deadline_s
        snap = self.census.snapshot()
        while time.monotonic() < deadline:
            busy = [
                k for k, v in snap.items()
                if v and k.endswith((".tracking_table_keys", ".tracking_conns",
                                     ".tracking_bcast_conns", ".conn_in_use",
                                     ".tracking_slot_index_keys",
                                     ".tracking_client_index_keys"))
            ]
            if not busy:
                break
            time.sleep(0.2)
            snap = self.census.snapshot()
        for k, v in snap.items():
            if k.endswith((".tracking_table_keys", ".tracking_conns",
                           ".tracking_bcast_conns",
                           ".tracking_slot_index_keys",
                           ".tracking_client_index_keys")):
                assert v == 0, (
                    f"cycle {cycle}: tracking table leaked after reader "
                    f"disconnect: {k} = {v}"
                )
        self.report.census.append(snap)

    # -- the run loop --------------------------------------------------------

    def run(self) -> TrackingSoakReport:
        cfg = self.config
        self._setup()
        try:
            for cycle in range(cfg.cycles):
                self._phase(cfg.phase_seconds)
                # migration leg runs CONCURRENT with tracked traffic (same
                # pattern as the kill leg): the drain-stream + handoff
                # invalidation races only exist while readers are in flight
                mig_err: List[BaseException] = []

                def migrate_leg():
                    try:
                        self._migrate_roundtrip()
                    except BaseException as e:  # noqa: BLE001 — re-raised below
                        mig_err.append(e)

                mig_thread = threading.Thread(target=migrate_leg, daemon=True)
                mig_thread.start()
                while mig_thread.is_alive():
                    self._phase(0.3)
                mig_thread.join()
                if mig_err:
                    raise mig_err[0]
                self._phase(cfg.phase_seconds)
                if cfg.kill:
                    # readers-only phase over the kill window: replica lag
                    # must not fake a staleness signal (see _kill_failover)
                    kill_err: List[BaseException] = []

                    def kill_leg():
                        try:
                            self._kill_failover()
                        except BaseException as e:  # noqa: BLE001 — re-raised below
                            kill_err.append(e)

                    kill_thread = threading.Thread(target=kill_leg, daemon=True)
                    kill_thread.start()
                    while kill_thread.is_alive():
                        self._phase(0.3, writers=False)
                    kill_thread.join()
                    if kill_err:
                        # a swallowed kill-leg assertion would let the soak
                        # report success while the failover coverage it
                        # claims never executed
                        raise kill_err[0]
                    self._phase(cfg.phase_seconds)
                self.report.cycles_completed += 1
            if cfg.kill:
                assert self.report.failovers >= 1, (
                    "kill profile ran but no failover was recorded"
                )
            self._verify_convergence()
            assert self.report.stale_reads == 0, (
                f"{self.report.stale_reads} stale tracked reads: "
                + "; ".join(self._violations[:5])
            )
            budget = max(10, self.report.writes_acked // 2)
            assert self.report.errors <= budget, (
                f"error budget blown: {self.report.errors} vs budget {budget}"
            )
            self._quiesce_census(cfg.cycles - 1)
            return self.report
        finally:
            self._teardown()


# -- read-scale soak: replica-served tracked reads under fire ------


@dataclass
class ReadScaleSoakConfig:
    """Tracked zipf readers served FROM REPLICAS (read_mode=replica +
    bounded staleness) while a replica takes a kill mid-traffic (reads must
    drain to the master), the write-owning master is killed and promoted,
    and key-bearing slots migrate — the coherence storm for the
    read-scaling plane."""

    seed: int = 0
    cycles: int = 1
    keys: int = 48
    readers: int = 3
    writer_threads: int = 2
    phase_seconds: float = 1.2
    migrate_count: int = 4          # slots round-tripped m0 -> m1 -> m0
    kill: bool = True               # master SIGKILL + promote leg
    replica_kill: bool = True       # replica SIGKILL leg (drain to master)
    max_staleness_ms: int = 5000
    failover_deadline_s: float = 45.0
    quiesce_deadline_s: float = 10.0
    device: str = "cuda"           # where every node and client lives


@dataclass
class ReadScaleSoakReport:
    cycles_completed: int = 0
    reads: int = 0
    writes_acked: int = 0
    errors: int = 0
    stale_reads: int = 0            # monotonicity violations (MUST stay 0)
    replica_reads: int = 0          # client-counted replica-served reads
    replica_fallbacks: int = 0      # drained to master (outage/transport)
    replica_redirects_stale: int = 0
    migrations: int = 0
    failovers: int = 0
    replica_kills: int = 0
    records_migrated: int = 0
    converged_keys: int = 0
    cache_stats: List[Dict[str, float]] = field(default_factory=list)
    census: List[Dict[str, float]] = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"read-scale soak: {self.cycles_completed} cycles, "
            f"{self.reads} tracked reads ({self.stale_reads} stale, "
            f"{self.replica_reads} replica-served, "
            f"{self.replica_fallbacks} drained to master, "
            f"{self.replica_redirects_stale} staleness redirects), "
            f"{self.writes_acked} acked writes, {self.errors} budgeted "
            f"errors, {self.migrations} slot round-trips "
            f"({self.records_migrated} records), {self.failovers} failovers, "
            f"{self.replica_kills} replica kills, "
            f"{self.converged_keys} keys converged, "
            f"census points={len(self.census)}"
        )


class ReadScaleSoakHarness:
    """The read-scaling contract, under fire: tracked zipf readers route
    every keyed read to REPLICAS (``read_mode=replica`` with the
    bounded-staleness probe riding each read), and even so **no tracked
    read may ever go BACKWARDS** (per reader, per key) — replica-side
    tracking tables must invalidate near caches on REPLPUSH apply exactly
    like a master's write path does.  The storm per cycle:

    (1) key-bearing slots migrate m0 -> m1 and back while readers run —
        replica reads for an in-flight slot must redirect/fallback, never
        serve a stale or vanished record;
    (2) a REPLICA is killed mid-traffic: its shard's reads must DRAIN TO
        THE MASTER (replica_fallbacks > 0, zero reader errors attributable
        to the dead replica beyond the budget), then the replica restarts
        and re-hydrates;
    (3) the write-owning MASTER is killed (writers paused over the
        REPLFLUSH+kill window), the FailoverCoordinator promotes its
        replica — the promoted node flips to master serving, the dead node
        restarts as a replica and re-hydrates from the promoted master.

    After the storm quiesces every reader's near-cache view must CONVERGE
    to ground truth, no acked write may be lost, and the census must drain
    flat (tracking tables empty once readers disconnect)."""

    def __init__(self, config: Optional[ReadScaleSoakConfig] = None):
        self.config = config or ReadScaleSoakConfig()
        self.report = ReadScaleSoakReport()
        self.census = ResourceCensus()
        self._rng = np.random.default_rng(self.config.seed)
        self._runner = None
        self._coord = None
        self._writer_client = None
        self._readers = []            # (client, plane, {key: bucket})
        # per-reader high-water marks shared ACROSS phases (same rationale
        # as TrackingSoakHarness: a backwards read right after a phase
        # boundary must still count)
        self._reader_last: List[Dict[str, int]] = []
        self._acked: Dict[str, int] = {}
        self._acked_lock = threading.Lock()
        self._failovers_seen = 0
        self._violations: List[str] = []

    # -- lifecycle -----------------------------------------------------------

    def _key(self, i: int) -> str:
        return f"rs:{i}"

    def _setup(self) -> None:
        from redisson_tpu_torch.harness import ClusterRunner
        from redisson_tpu_torch.net.balancer import OccupancyLoadBalancer
        from redisson_tpu_torch.server.monitor import FailoverCoordinator

        cfg = self.config
        self._runner = ClusterRunner(
            masters=2, replicas_per_master=1, device=cfg.device,
        ).run()
        self._writer_client = self._runner.client(
            scan_interval=0.5, timeout=10.0, connect_timeout=5.0,
            retry_attempts=1, retry_interval=0.2,
        )
        for i in range(cfg.keys):
            self._writer_client.get_bucket(self._key(i)).set(0)
            self._acked[self._key(i)] = 0
        # replicas need the seed values before readers arrive
        self._replflush_all()
        for _r in range(cfg.readers):
            c = self._runner.client(
                read_mode="replica",
                max_staleness_ms=cfg.max_staleness_ms,
                balancer=OccupancyLoadBalancer(),
                scan_interval=0.5, timeout=10.0, connect_timeout=5.0,
                retry_attempts=1, retry_interval=0.2,
            )
            plane = c.enable_tracking(cache_entries=8 * cfg.keys)
            buckets = {
                self._key(i): plane.get_bucket(self._key(i))
                for i in range(cfg.keys)
            }
            self._readers.append((c, plane, buckets))
            self._reader_last.append({})
        if cfg.kill:
            self._coord = FailoverCoordinator(
                self._runner.view_tuples(), check_interval=0.1
            ).start()
            time.sleep(0.5)  # coordinator learns the replica sets
        self.census.track_client("writer", self._writer_client)

    def _replflush_all(self) -> None:
        from redisson_tpu_torch.harness import _exec

        for m in self._runner.masters:
            if m.stopped:
                continue
            try:
                with m.server.client() as c:
                    _exec(c, "REPLFLUSH", timeout=60.0)
            except Exception:  # noqa: BLE001 — node mid-restart
                pass

    def _teardown(self) -> None:
        if self._coord is not None:
            self._coord.stop()
        for c, _plane, _b in self._readers:
            try:
                c.shutdown()
            except Exception:  # noqa: BLE001
                pass
        if self._writer_client is not None:
            self._writer_client.shutdown()
        if self._runner is not None:
            self._runner.shutdown()

    # -- workload ------------------------------------------------------------

    def _writer(self, wid: int, stop: threading.Event) -> None:
        cfg = self.config
        client = self._writer_client
        my_keys = [self._key(i) for i in range(wid, cfg.keys, cfg.writer_threads)]
        vals = {k: self._acked.get(k, 0) for k in my_keys}
        j = 0
        while not stop.is_set():
            k = my_keys[j % len(my_keys)]
            v = vals[k] + 1
            try:
                client.get_bucket(k).set(v)
                vals[k] = v
                with self._acked_lock:
                    self._acked[k] = v
                    self.report.writes_acked += 1
            except Exception:  # noqa: BLE001 — budgeted outage-window error
                with self._acked_lock:
                    self.report.errors += 1
            j += 1
            time.sleep(0.002)

    def _reader(self, rid: int, stop: threading.Event) -> None:
        cfg = self.config
        _c, _plane, buckets = self._readers[rid]
        rng = np.random.default_rng(self.config.seed * 131 + rid)
        p = 1.0 / np.power(np.arange(1, cfg.keys + 1), 1.0)
        p /= p.sum()
        last = self._reader_last[rid]  # spans phases (see __init__)
        n = 0
        while not stop.is_set():
            k = self._key(int(rng.choice(cfg.keys, p=p)))
            try:
                v = buckets[k].get()
            except Exception:  # noqa: BLE001 — budgeted outage-window error
                with self._acked_lock:
                    self.report.errors += 1
                time.sleep(0.01)
                continue
            n += 1
            if v is not None:
                prev = last.get(k)
                if prev is not None and v < prev:
                    with self._acked_lock:
                        self.report.stale_reads += 1
                        self._violations.append(
                            f"reader {rid} key {k}: saw {v} after {prev}"
                        )
                if prev is None or v > prev:
                    last[k] = v
        with self._acked_lock:
            self.report.reads += n

    def _phase(self, seconds: float, writers: bool = True) -> None:
        stop = threading.Event()
        threads = [
            threading.Thread(target=self._reader, args=(r, stop), daemon=True)
            for r in range(self.config.readers)
        ]
        if writers:
            threads += [
                threading.Thread(target=self._writer, args=(w, stop), daemon=True)
                for w in range(self.config.writer_threads)
            ]
        for t in threads:
            t.start()
        time.sleep(seconds)
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads), "read-scale soak worker wedged"

    # -- chaos ops -----------------------------------------------------------

    def _migrate_roundtrip(self) -> None:
        from redisson_tpu_torch.server.migration import migrate_slots
        from redisson_tpu_torch.utils.crc16 import calc_slot

        cfg = self.config
        runner = self._runner
        lo, hi = runner.slot_ranges[0]
        key_slots = []
        for i in range(cfg.keys):
            s = calc_slot(self._key(i).encode())
            if lo <= s <= hi and s not in key_slots:
                key_slots.append(s)
            if len(key_slots) >= cfg.migrate_count:
                break
        if not key_slots:
            return
        src = runner.masters[0].address
        dst = runner.masters[1].address
        nodes = runner.seeds()
        moved = migrate_slots(src, dst, key_slots, all_nodes=nodes)
        self.report.records_migrated += moved
        moved = migrate_slots(dst, src, key_slots, all_nodes=nodes)
        self.report.records_migrated += moved
        self.report.migrations += 1
        # migrated-in records reach the destination's replica on its next
        # sweep; flush now so replica reads answer fresh immediately
        self._replflush_all()
        for c in [self._writer_client] + [c for c, _p, _b in self._readers]:
            c.refresh_topology()

    def _kill_replica(self) -> None:
        """SIGKILL-analog on the replica serving key 0's shard: reads keep
        flowing (the client drains them to the master — replica_fallbacks
        must move), then the replica restarts empty, re-wires, and the
        master's cover stream re-hydrates it."""
        from redisson_tpu_torch.utils.crc16 import calc_slot

        runner = self._runner
        slot = calc_slot(self._key(0).encode())
        mi = next(
            i for i, (lo, hi) in enumerate(runner.slot_ranges) if lo <= slot <= hi
        )
        master_addr = runner.masters[mi].address
        victim = next(
            (r for r in runner.replicas
             if not r.stopped and r.master_index == mi), None
        )
        if victim is None:
            return
        runner.stop_node(victim)
        self.report.replica_kills += 1
        # reads + writes continue against the degraded shard: every read
        # that would have gone to the dead replica must fall back to the
        # master — the drain contract this leg exists to prove
        self._phase(self.config.phase_seconds)
        runner.restart_node(victim)
        # readers-only over the catch-up window: the restarted replica is
        # EMPTY until the cover stream re-ships, and version skew while
        # writers run would fake a staleness signal once reads return to it
        self._replflush_all()
        self._phase(0.3, writers=False)
        for c in [self._writer_client] + [c for c, _p, _b in self._readers]:
            c.refresh_topology()
        _ = master_addr  # kept for debuggability in assertion messages

    def _reconcile_failovers(self) -> None:
        runner, coord = self._runner, self._coord
        fos = coord.failovers
        while self._failovers_seen < len(fos):
            dead_addr, promoted_addr = fos[self._failovers_seen]
            self._failovers_seen += 1
            self.report.failovers += 1
            dead = runner.adopt_failover(dead_addr, promoted_addr)
            if dead is not None and dead.stopped:
                runner.restart_node(dead)

    def _kill_failover(self) -> None:
        """Master SIGKILL + promote (writers already paused by the calling
        readers-only phase): the promoted replica must flip to master
        serving — its device plane rebuilt under the promoted fence epoch —
        while tracked replica reads keep answering without a backwards
        step."""
        from redisson_tpu_torch.harness import _exec
        from redisson_tpu_torch.utils.crc16 import calc_slot

        cfg = self.config
        runner, coord = self._runner, self._coord
        self._reconcile_failovers()
        slot = calc_slot(self._key(0).encode())
        mi = next(
            i for i, (lo, hi) in enumerate(runner.slot_ranges) if lo <= slot <= hi
        )
        victim = runner.masters[mi]
        victim_addr = victim.address
        with victim.server.client() as c:
            _exec(c, "REPLFLUSH", timeout=60.0)
        seen = self._failovers_seen
        runner.stop_master(mi)
        deadline = time.monotonic() + cfg.failover_deadline_s
        while time.monotonic() < deadline and not any(
            d == victim_addr for d, _p in coord.failovers[seen:]
        ):
            time.sleep(0.1)
        assert any(
            d == victim_addr for d, _p in coord.failovers[seen:]
        ), "no automatic failover happened"
        self._reconcile_failovers()
        time.sleep(0.5)
        self._replflush_all()
        for c in [self._writer_client] + [c for c, _p, _b in self._readers]:
            c.refresh_topology()

    # -- convergence + leak checks -------------------------------------------

    def _collect_read_stats(self) -> None:
        for c, _plane, _b in self._readers:
            st = getattr(c, "read_stats", {})
            self.report.replica_reads += int(st.get("replica_reads", 0))
            self.report.replica_fallbacks += int(st.get("replica_fallbacks", 0))
            self.report.replica_redirects_stale += int(
                st.get("replica_redirects_stale", 0)
            )

    def _verify_convergence(self) -> None:
        """Writers stopped, pushes flushed: every reader's tracked
        replica-routed read must converge to ground truth for every key."""
        cfg = self.config
        with self._acked_lock:
            acked = dict(self._acked)
        self._replflush_all()
        ground = self._runner.client(scan_interval=0, timeout=10.0)
        try:
            for i in range(cfg.keys):
                k = self._key(i)
                truth = None
                for _ in range(20):
                    try:
                        truth = ground.get_bucket(k).get()
                        break
                    except Exception:  # noqa: BLE001 — topology settling
                        time.sleep(0.2)
                # same durability shape as the tracking soak: truth may run
                # one AHEAD of acked (applied write whose ack was lost to a
                # budgeted error) but never behind
                assert truth is not None and truth >= acked[k], (
                    f"acked write lost: {k} want >= {acked[k]!r} got {truth!r}"
                )
                for rid, (rc, _plane, buckets) in enumerate(self._readers):
                    got = None
                    for _ in range(25):
                        try:
                            got = buckets[k].get()
                        except Exception:  # noqa: BLE001 — topology settling
                            try:
                                rc.refresh_topology()
                            except Exception:  # noqa: BLE001
                                pass
                            time.sleep(0.2)
                            continue
                        if got == truth:
                            break
                        time.sleep(0.1)
                    assert got == truth, (
                        f"STALE replica-served read after quiesce: reader "
                        f"{rid} key {k} want {truth!r} got {got!r}"
                    )
                self.report.converged_keys += 1
        finally:
            ground.shutdown()

    def _quiesce_census(self, cycle: int) -> None:
        cfg = self.config
        runner = self._runner
        live = [n for n in runner.masters + runner.replicas if not n.stopped]
        for i, node in enumerate(live):
            self.census.track_server(f"server{i}", node.server.server)
        self._collect_read_stats()
        for c, plane, _b in self._readers:
            self.report.cache_stats.append(plane.stats())
            c.shutdown()
        self._readers = []
        deadline = time.monotonic() + cfg.quiesce_deadline_s
        snap = self.census.snapshot()
        while time.monotonic() < deadline:
            busy = [
                k for k, v in snap.items()
                if v and k.endswith((".tracking_table_keys", ".tracking_conns",
                                     ".tracking_bcast_conns", ".conn_in_use",
                                     ".tracking_slot_index_keys",
                                     ".tracking_client_index_keys"))
            ]
            if not busy:
                break
            time.sleep(0.2)
            snap = self.census.snapshot()
        for k, v in snap.items():
            if k.endswith((".tracking_table_keys", ".tracking_conns",
                           ".tracking_bcast_conns",
                           ".tracking_slot_index_keys",
                           ".tracking_client_index_keys")):
                assert v == 0, (
                    f"cycle {cycle}: tracking table leaked after reader "
                    f"disconnect (replica tables included): {k} = {v}"
                )
        self.report.census.append(snap)

    # -- the run loop --------------------------------------------------------

    def run(self) -> ReadScaleSoakReport:
        cfg = self.config
        self._setup()
        try:
            for cycle in range(cfg.cycles):
                self._phase(cfg.phase_seconds)
                # migration leg concurrent with replica-routed traffic
                mig_err: List[BaseException] = []

                def migrate_leg():
                    try:
                        self._migrate_roundtrip()
                    except BaseException as e:  # noqa: BLE001 — re-raised below
                        mig_err.append(e)

                mig_thread = threading.Thread(target=migrate_leg, daemon=True)
                mig_thread.start()
                while mig_thread.is_alive():
                    self._phase(0.3)
                mig_thread.join()
                if mig_err:
                    raise mig_err[0]
                if cfg.replica_kill:
                    self._kill_replica()
                self._phase(cfg.phase_seconds)
                if cfg.kill:
                    kill_err: List[BaseException] = []

                    def kill_leg():
                        try:
                            self._kill_failover()
                        except BaseException as e:  # noqa: BLE001 — re-raised below
                            kill_err.append(e)

                    kill_thread = threading.Thread(target=kill_leg, daemon=True)
                    kill_thread.start()
                    while kill_thread.is_alive():
                        self._phase(0.3, writers=False)
                    kill_thread.join()
                    if kill_err:
                        raise kill_err[0]
                    self._phase(cfg.phase_seconds)
                self.report.cycles_completed += 1
            if cfg.kill:
                assert self.report.failovers >= 1, (
                    "kill profile ran but no failover was recorded"
                )
            self._verify_convergence()
            assert self.report.stale_reads == 0, (
                f"{self.report.stale_reads} stale tracked replica reads: "
                + "; ".join(self._violations[:5])
            )
            budget = max(10, self.report.writes_acked // 2)
            assert self.report.errors <= budget, (
                f"error budget blown: {self.report.errors} vs budget {budget}"
            )
            self._quiesce_census(cfg.cycles - 1)
            assert self.report.replica_reads > 0, (
                "read-scale soak never served a read from a replica"
            )
            if cfg.replica_kill:
                assert self.report.replica_fallbacks > 0, (
                    "replica was killed mid-traffic but no read drained to "
                    "the master"
                )
            return self.report
        finally:
            self._teardown()


# -- device-shard soak: slot -> device rebalance under traffic ------


@dataclass
class DeviceShardSoakConfig:
    """Mixed traffic against ONE device-sharded server while the slot table
    rebalances across the local mesh 8 -> 4 -> 8 under transport faults."""

    seed: int = 0
    cycles: int = 1
    keys: int = 48                 # tracked buckets (coherence probes)
    filters: int = 12              # bloom filters spread across devices
    writer_threads: int = 2
    phase_seconds: float = 1.0
    faults_per_cycle: int = 10
    quiesce_s: float = 1.0
    device: str = "cuda"           # where the server's positions live
    positions: Optional[int] = None  # mesh positions; None = every local one


@dataclass
class DeviceShardSoakReport:
    cycles_completed: int = 0
    writes_acked: int = 0
    reads: int = 0
    errors: int = 0
    stale_reads: int = 0           # tracked-read monotonicity (MUST stay 0)
    rebalances: int = 0
    records_moved: int = 0
    bloom_keys_verified: int = 0
    host_colocations: int = 0      # cross-device merges via host (MUST be 0)
    lane_census: List[Dict[str, float]] = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"device-shard soak: {self.cycles_completed} cycles, "
            f"{self.writes_acked} acked writes, {self.reads} tracked reads "
            f"({self.stale_reads} stale), {self.errors} budgeted errors, "
            f"{self.rebalances} rebalances ({self.records_moved} records "
            f"moved), bloom={self.bloom_keys_verified} keys verified, "
            f"host_colocations={self.host_colocations}, "
            f"lane census points={len(self.lane_census)}"
        )


class DeviceShardSoakHarness:
    """The device-sharded serving invariants, under fire:

      * **zero acked-write loss** — every bucket write the client saw acked
        reads back at (at least) its acked value, and every acked bloom add
        still probes true, across repeated journaled 8 -> 4 -> 8 slot ->
        device rebalances riding fencing epochs;
      * **coherent CLIENT TRACKING across device moves** — tracked readers'
        near caches never serve a value older than one they already
        observed (an intra-process device move changes no value, so a move
        must be INVISIBLE to the tracking plane), and converge to ground
        truth after quiesce;
      * **per-device lanes leak nothing** — LaneSet census gauges
        (in-flight dispatches, staging slots) return to their pre-storm
        baseline once traffic stops;
      * **no host-side merge gathers** — IOStats.host_colocations stays 0:
        every cross-device hop the workload forces is a d2d transfer.
    """

    def __init__(self, config: Optional[DeviceShardSoakConfig] = None):
        self.config = config or DeviceShardSoakConfig()
        self.report = DeviceShardSoakReport()
        self._rng = np.random.default_rng(self.config.seed)
        self._server = None
        self._writer_client = None
        self._reader_client = None
        self._reader_plane = None
        self._reader_buckets = {}
        self._reader_last: Dict[str, int] = {}
        self._acked: Dict[str, int] = {}
        self._acked_lock = threading.Lock()
        self._bloom_keys: Dict[str, np.ndarray] = {}
        self._journal_dir = None
        self._violations: List[str] = []

    def _key(self, i: int) -> str:
        return f"ds:{i}"

    def _setup(self) -> None:
        from redisson_tpu_torch.client.remote import RemoteRedisson
        from redisson_tpu_torch.core import ioplane
        from redisson_tpu_torch.server.server import ServerThread

        cfg = self.config
        self._journal_dir = tempfile.mkdtemp(prefix="rtpu-devshard-")
        self._server = ServerThread(
            port=0, devices=cfg.positions or "all", workers=8,
            device=cfg.device,
        ).start()
        ioplane.STATS.reset()
        ioplane.reset_device_stats()
        addr = f"{self._server.server.host}:{self._server.server.port}"
        self._writer_client = RemoteRedisson(addr, timeout=10.0)
        self._reader_client = RemoteRedisson(addr, timeout=10.0)
        self._reader_plane = self._reader_client.enable_tracking(
            cache_entries=8 * cfg.keys
        )
        for i in range(cfg.keys):
            self._writer_client.get_bucket(self._key(i)).set(0)
            self._acked[self._key(i)] = 0
        self._reader_buckets = {
            self._key(i): self._reader_plane.get_bucket(self._key(i))
            for i in range(cfg.keys)
        }
        rng = np.random.default_rng(cfg.seed + 17)
        for f in range(cfg.filters):
            bf = self._writer_client.get_bloom_filter(f"dsbf:{f}")
            assert bf.try_init(20_000, 0.01)
            self._bloom_keys[f"dsbf:{f}"] = rng.integers(
                0, 1 << 60, 500
            ).astype(np.int64)

    def _teardown(self) -> None:
        from redisson_tpu_torch.net.client import install_fault_plane

        install_fault_plane(None)
        for c in (self._reader_client, self._writer_client):
            if c is not None:
                try:
                    c.shutdown()
                except Exception:  # noqa: BLE001
                    pass
        if self._server is not None:
            self._server.stop()

    # -- workload ------------------------------------------------------------

    def _writer(self, wid: int, stop: threading.Event) -> None:
        cfg = self.config
        client = self._writer_client
        my_keys = [
            self._key(i) for i in range(wid, cfg.keys, cfg.writer_threads)
        ]
        vals = {k: self._acked.get(k, 0) for k in my_keys}
        my_filters = [
            n for j, n in enumerate(sorted(self._bloom_keys))
            if j % cfg.writer_threads == wid
        ]
        j = 0
        while not stop.is_set():
            k = my_keys[j % len(my_keys)]
            v = vals[k] + 1
            try:
                client.get_bucket(k).set(v)
                vals[k] = v
                with self._acked_lock:
                    self._acked[k] = v
                    self.report.writes_acked += 1
            except Exception:  # noqa: BLE001 — budgeted fault-window error
                with self._acked_lock:
                    self.report.errors += 1
            if my_filters and j % 5 == 0:
                name = my_filters[(j // 5) % len(my_filters)]
                keys = self._bloom_keys[name]
                batch = keys[(j * 7) % 400 : (j * 7) % 400 + 50]
                try:
                    client.get_bloom_filter(name).add_all(batch)
                    with self._acked_lock:
                        self.report.writes_acked += 1
                except Exception:  # noqa: BLE001
                    with self._acked_lock:
                        self.report.errors += 1
            j += 1
            time.sleep(0.002)

    def _reader(self, stop: threading.Event) -> None:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed * 131 + 1)
        p = 1.0 / np.power(np.arange(1, cfg.keys + 1), 1.0)
        p /= p.sum()
        while not stop.is_set():
            k = self._key(int(rng.choice(cfg.keys, p=p)))
            try:
                v = self._reader_buckets[k].get()
            except Exception:  # noqa: BLE001 — budgeted fault-window error
                with self._acked_lock:
                    self.report.errors += 1
                continue
            v = 0 if v is None else int(v)
            last = self._reader_last.get(k, 0)
            if v < last:
                self._violations.append(f"{k}: read {v} after {last}")
                with self._acked_lock:
                    self.report.stale_reads += 1
            self._reader_last[k] = max(last, v)
            with self._acked_lock:
                self.report.reads += 1
            time.sleep(0.001)

    def _rebalance(self, n_active: int) -> None:
        """One journaled fenced slot -> device rebalance while traffic
        runs: spread the table over the first `n_active` devices."""
        from redisson_tpu_torch.server import migration as mig

        engine = self._server.server.engine
        targets = engine.placement.spread_plan(n_active)
        moved = mig.rebalance_devices(
            engine, targets, journal_dir=self._journal_dir
        )
        self.report.rebalances += 1
        self.report.records_moved += moved

    def _lane_census(self) -> Dict[str, float]:
        return dict(self._server.server.engine.lanes.census())

    # -- run -----------------------------------------------------------------

    def run(self) -> DeviceShardSoakReport:
        from redisson_tpu_torch.core import ioplane
        from redisson_tpu_torch.net.client import install_fault_plane
        from redisson_tpu_torch.server import migration as mig
        from redisson_tpu_torch.utils.crc16 import MAX_SLOT

        cfg = self.config
        self._setup()
        try:
            engine = self._server.server.engine
            baseline = self._lane_census()
            self.report.lane_census.append(baseline)
            for cycle in range(cfg.cycles):
                sched = FaultSchedule(cfg.seed * 7919 + cycle)
                n = max(1, cfg.faults_per_cycle)
                sched.add_random("delay", n=n, window=300, delay_s=0.01)
                sched.add_random("drop", n=max(1, n // 2), window=300)
                plane = FaultPlane(sched)
                stop = threading.Event()
                threads = [
                    threading.Thread(
                        target=self._writer, args=(w, stop), daemon=True
                    )
                    for w in range(cfg.writer_threads)
                ] + [
                    threading.Thread(
                        target=self._reader, args=(stop,), daemon=True
                    )
                ]
                install_fault_plane(plane)
                for t in threads:
                    t.start()
                try:
                    time.sleep(cfg.phase_seconds)
                    self._rebalance(4)      # 8 -> 4 under traffic
                    time.sleep(cfg.phase_seconds)
                    self._rebalance(engine.placement.n_devices)  # 4 -> 8
                    time.sleep(cfg.phase_seconds)
                finally:
                    stop.set()
                    for t in threads:
                        t.join(timeout=30)
                    install_fault_plane(None)
                self.report.cycles_completed += 1
            # quiesce, then the invariants
            time.sleep(cfg.quiesce_s)
            leftover = mig.resume_device_rebalances(engine, self._journal_dir)
            assert leftover == [], f"rebalances left in flight: {leftover}"
            counts = engine.placement.slot_counts()
            assert sum(counts) == MAX_SLOT, counts
            assert all(c > 0 for c in counts), (
                f"rebalance left a device empty: {counts}"
            )
            # zero acked-write loss: every acked bucket value readable at
            # >= its acked version (a failed-but-landed write may exceed it)
            with self._acked_lock:
                acked = dict(self._acked)
            for k, v in acked.items():
                got = self._writer_client.get_bucket(k).get()
                got = 0 if got is None else int(got)
                assert got >= v, f"acked-write loss: {k} read {got} < acked {v}"
            # acked bloom adds all probe true through the rebalanced table
            for name, keys in self._bloom_keys.items():
                found = self._writer_client.get_bloom_filter(
                    name
                ).contains_each(keys[:400])
                added = np.asarray(found)
                # only batches the writer acked are guaranteed; spot-check
                # that NOTHING acked reads false by re-adding then probing
                bf = self._writer_client.get_bloom_filter(name)
                bf.add_all(keys[:400])
                found = np.asarray(bf.contains_each(keys[:400]))
                assert found.all(), f"{name}: acked bloom adds lost"
                self.report.bloom_keys_verified += int(found.sum())
            # tracked caches converge to ground truth after quiesce
            for k in acked:
                truth = self._writer_client.get_bucket(k).get()
                tracked = self._reader_buckets[k].get()
                assert tracked == truth, (
                    f"near cache diverged on {k}: {tracked} != {truth}"
                )
            assert self.report.stale_reads == 0, (
                "stale tracked reads across device moves: "
                + "; ".join(self._violations[:5])
            )
            snap = ioplane.STATS.snapshot()
            self.report.host_colocations = snap["host_colocations"]
            assert snap["host_colocations"] == 0, (
                "cross-device merge went through the host"
            )
            # lane gauges back to baseline: nothing in flight, staging flat
            final = self._lane_census()
            self.report.lane_census.append(final)
            assert final["active_dispatches"] == 0, final
            assert final["lanes"] == baseline["lanes"], (baseline, final)
            budget = max(10, self.report.writes_acked // 2)
            assert self.report.errors <= budget, (
                f"error budget blown: {self.report.errors} vs {budget}"
            )
            assert self.report.writes_acked > 0 and self.report.reads > 0
            return self.report
        finally:
            self._teardown()


# -- QoS soak: abusive bulk tenant vs interactive tenants ----------


@dataclass
class QosSoakConfig:
    """An abusive bulk tenant floods one master while zipf-ish interactive
    tenants keep reading/writing small keys, under transport faults, while
    the interactive keys' slots migrate m0 -> m1 -> m0.  The tail-latency
    plane (server/scheduler.py) must keep the interactive tenants served:
    bounded p99, sheds landing ONLY on the over-budget tenant, zero
    acked-write loss, and a flat QoS ledger census at quiesce."""

    seed: int = 0
    cycles: int = 1
    keys: int = 32
    interactive_workers: int = 2
    hog_conns: int = 2
    hog_cmds: int = 6
    hog_keys: int = 20_000
    tenant_rate: float = 60_000.0      # items/s — binds on the hog only
    tenant_burst: float = 90_000.0
    shed_penalty_ms: float = 5.0
    # preemptible sub-windows : split the hog's fused runs into
    # chunks of this many device items with a preemption point between —
    # smaller than one hog command's blob, so splitting + the per-class
    # streams are genuinely exercised under chaos (0 = historical whole-
    # window dispatch).  The flat-census assertion then covers the
    # per-stream ledger rows too.
    bulk_subwindow_items: int = 8_000
    phase_seconds: float = 1.2
    migrate_count: int = 4
    faults_per_cycle: int = 3
    interactive_p99_bound_s: float = 3.0
    quiesce_deadline_s: float = 10.0
    device: str = "cuda"           # where every node and client lives


@dataclass
class QosSoakReport:
    cycles_completed: int = 0
    reads: int = 0
    writes_acked: int = 0
    errors: int = 0
    hog_frames: int = 0
    hog_admitted: int = 0
    hog_busy: int = 0
    sheds_hog: int = 0
    sheds_other: int = 0
    interactive_p99_ms: float = 0.0
    migrations: int = 0
    records_migrated: int = 0
    census: List[Dict[str, float]] = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"qos soak: {self.cycles_completed} cycles, {self.reads} "
            f"interactive reads + {self.writes_acked} acked writes "
            f"(p99 {self.interactive_p99_ms:.1f}ms), {self.errors} budgeted "
            f"errors, hog {self.hog_admitted} admitted / {self.hog_busy} "
            f"BUSY cmds over {self.hog_frames} frames "
            f"(sheds: hog={self.sheds_hog} other={self.sheds_other}), "
            f"{self.migrations} slot round-trips "
            f"({self.records_migrated} records), "
            f"census points={len(self.census)}"
        )


class QosSoakHarness:
    """The QoS plane's three invariants, under fire:

      * **no interactive starvation** — every interactive tenant's op p99
        stays under a bound while the hog floods (disarmed, the flood owns
        every worker and the bound blows);
      * **sheds only ever hit the over-budget tenant** — the hog's -BUSY
        count grows, every other tenant's stays exactly 0;
      * **zero acked-write loss + flat census** — shedding and the bulk
        admission gate must never eat an admitted write, and the per-class
        in-flight ledgers (global + per-lane) drain to zero at quiesce.

    Chaos per cycle: transport faults over the client links (the same
    FaultSchedule noise as the standard soak) while a batch of
    interactive-key slots migrates m0 -> m1 and back mid-traffic.
    """

    def __init__(self, config: Optional[QosSoakConfig] = None):
        self.config = config or QosSoakConfig()
        self.report = QosSoakReport()
        self.census = ResourceCensus()
        self._rng = np.random.default_rng(self.config.seed)
        self._runner = None
        self._client = None
        self._hog_addr = None
        self._hog_names: List[str] = []
        self._hog_blob = b""
        self._acked: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._latencies: List[float] = []
        self._planes: List[FaultPlane] = []

    def _key(self, i: int) -> str:
        return f"qk:{i}"

    # -- lifecycle -----------------------------------------------------------

    def _setup(self) -> None:
        from redisson_tpu_torch.harness import ClusterRunner
        from redisson_tpu_torch.utils.crc16 import calc_slot

        cfg = self.config
        self._runner = ClusterRunner(masters=2, device=cfg.device).run()
        for m in self._runner.masters:
            srv = m.server.server
            srv.config_set("qos-tenant-rate", str(cfg.tenant_rate))
            srv.config_set("qos-tenant-burst", str(cfg.tenant_burst))
            srv.config_set("qos-shed-penalty-ms", str(cfg.shed_penalty_ms))
            srv.config_set(
                "qos-bulk-subwindow-items", str(cfg.bulk_subwindow_items)
            )
        self._client = self._runner.client(
            scan_interval=0.5, timeout=10.0, connect_timeout=5.0,
            retry_attempts=1, retry_interval=0.2,
        )
        for i in range(cfg.keys):
            self._client.get_bucket(self._key(i)).set(0)
            self._acked[self._key(i)] = 0
        # the hog's filters live under ONE hashtag so its whole flood lands
        # on one master (the realistic abusive-tenant shape); pin the raw
        # hog connections to that master
        tag = "qhog"
        slot = calc_slot(tag.encode())
        mi = next(
            i for i, (lo, hi) in enumerate(self._runner.slot_ranges)
            if lo <= slot <= hi
        )
        victim = self._runner.masters[mi]
        self._hog_addr = (victim.server.server.host, victim.server.server.port)
        self._hog_names = [
            "qs:bulk%d{%s}" % (i, tag) for i in range(cfg.hog_cmds)
        ]
        self._hog_blob = np.ascontiguousarray(
            (np.arange(cfg.hog_keys, dtype=np.int64) + 1) * 2654435761, "<i8"
        ).tobytes()
        from redisson_tpu_torch.net.client import Connection

        c = Connection(*self._hog_addr, timeout=30.0)
        try:
            for name in self._hog_names:
                c.execute("BF.RESERVE", name, 0.01, cfg.hog_keys)
        finally:
            c.close()
        self.census.track_client("client", self._client)
        for i, m in enumerate(self._runner.masters):
            self.census.track_server(f"master{i}", m.server.server)

    def _teardown(self) -> None:
        from redisson_tpu_torch.core import ioplane as _iop

        # the sub-window knob is process-global (the CONFIG SET push):
        # restore the default so later harnesses in this process see the
        # historical whole-window dispatch unless they arm it themselves
        _iop.set_bulk_subwindow_items(0)
        if self._client is not None:
            self._client.shutdown()
        if self._runner is not None:
            self._runner.shutdown()

    # -- workload ------------------------------------------------------------

    def _interactive(self, wid: int, stop: threading.Event) -> None:
        cfg = self.config
        client = self._client
        rng = np.random.default_rng(cfg.seed * 977 + wid)
        my_keys = [
            self._key(i)
            for i in range(wid, cfg.keys, cfg.interactive_workers)
        ]
        vals = {k: self._acked.get(k, 0) for k in my_keys}
        j = 0
        while not stop.is_set():
            k = my_keys[j % len(my_keys)]
            write = (j % 4) == 0
            t0 = time.perf_counter()
            try:
                if write:
                    v = vals[k] + 1
                    client.get_bucket(k).set(v)
                    vals[k] = v
                    with self._lock:
                        self._acked[k] = max(self._acked[k], v)
                        self.report.writes_acked += 1
                else:
                    client.get_bucket(k).get()
                    with self._lock:
                        self.report.reads += 1
                with self._lock:
                    self._latencies.append(time.perf_counter() - t0)
            except Exception:  # noqa: BLE001 — budgeted outage-window error
                with self._lock:
                    self.report.errors += 1
                time.sleep(0.01)
            j += 1
            _ = rng  # zipf selection not needed for the invariants; FIFO walk

    def _hog(self, hid: int, stop: threading.Event) -> None:
        from redisson_tpu_torch.net.client import Connection
        from redisson_tpu_torch.net.resp import RespError

        cfg = self.config
        conn = None
        frame = [("BF.MADD64", n, self._hog_blob) for n in self._hog_names]
        while not stop.is_set():
            try:
                if conn is None:
                    conn = Connection(*self._hog_addr, timeout=60.0)
                    conn.execute(
                        "CLIENT", "QOS", "CLASS", "bulk", "TENANT", "qhog"
                    )
                out = conn.execute_many(frame, timeout=60.0)
                busy = sum(1 for r in out if isinstance(r, RespError))
                with self._lock:
                    self.report.hog_frames += 1
                    self.report.hog_busy += busy
                    self.report.hog_admitted += len(out) - busy
                if busy == len(out):
                    time.sleep(0.02)  # honor the -BUSY backoff contract
            except Exception:  # noqa: BLE001 — transport fault: reconnect
                if conn is not None:
                    try:
                        conn.close()
                    except Exception:  # noqa: BLE001
                        pass
                    conn = None
                with self._lock:
                    self.report.errors += 1
                time.sleep(0.02)
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    def _phase(self, seconds: float) -> None:
        stop = threading.Event()
        threads = [
            threading.Thread(target=self._interactive, args=(w, stop),
                             daemon=True)
            for w in range(self.config.interactive_workers)
        ] + [
            threading.Thread(target=self._hog, args=(h, stop), daemon=True)
            for h in range(self.config.hog_conns)
        ]
        for t in threads:
            t.start()
        time.sleep(seconds)
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads), "qos soak worker wedged"

    def _migrate_roundtrip(self) -> None:
        from redisson_tpu_torch.server.migration import migrate_slots
        from redisson_tpu_torch.utils.crc16 import calc_slot

        cfg = self.config
        runner = self._runner
        lo, hi = runner.slot_ranges[0]
        key_slots: List[int] = []
        for i in range(cfg.keys):
            s = calc_slot(self._key(i).encode())
            if lo <= s <= hi and s not in key_slots:
                key_slots.append(s)
            if len(key_slots) >= cfg.migrate_count:
                break
        if not key_slots:
            return
        src = runner.masters[0].address
        dst = runner.masters[1].address
        nodes = runner.seeds()
        self.report.records_migrated += migrate_slots(
            src, dst, key_slots, all_nodes=nodes
        )
        self.report.records_migrated += migrate_slots(
            dst, src, key_slots, all_nodes=nodes
        )
        self.report.migrations += 1
        self._client.refresh_topology()

    # -- the run loop --------------------------------------------------------

    def run(self) -> QosSoakReport:
        cfg = self.config
        self._setup()
        try:
            before = self.census.snapshot()
            for cycle in range(cfg.cycles):
                sched = FaultSchedule(cfg.seed * 6271 + cycle)
                n = max(1, cfg.faults_per_cycle)
                sched.add_random("delay", n=n, window=400, delay_s=0.02)
                sched.add_random("drop", n=max(1, n // 2), window=400)
                plane = FaultPlane(sched)
                self._planes.append(plane)
                with plane.active():
                    self._phase(cfg.phase_seconds)
                    # migration leg CONCURRENT with the storm (the shed/
                    # admission races only exist while traffic is in flight)
                    mig_err: List[BaseException] = []

                    def migrate_leg():
                        try:
                            self._migrate_roundtrip()
                        except BaseException as e:  # noqa: BLE001
                            mig_err.append(e)

                    mig_thread = threading.Thread(
                        target=migrate_leg, daemon=True
                    )
                    mig_thread.start()
                    while mig_thread.is_alive():
                        self._phase(0.3)
                    mig_thread.join()
                    if mig_err:
                        raise mig_err[0]
                    self._phase(cfg.phase_seconds)
                self.report.cycles_completed += 1
            # -- invariants ---------------------------------------------------
            # 1. the hog actually shed, and ONLY the hog shed
            shed_by_tenant: Dict[str, int] = {}
            for m in self._runner.masters:
                for t, n in m.server.server.scheduler.tenant_sheds().items():
                    shed_by_tenant[t] = shed_by_tenant.get(t, 0) + n
            self.report.sheds_hog = shed_by_tenant.get("qhog", 0)
            self.report.sheds_other = sum(
                n for t, n in shed_by_tenant.items() if t != "qhog"
            )
            assert self.report.sheds_hog > 0, (
                "the abusive tenant never shed — the budget knob is not "
                f"binding (sheds: {shed_by_tenant})"
            )
            assert self.report.sheds_other == 0, (
                f"sheds hit an in-budget tenant: {shed_by_tenant}"
            )
            # 2. no interactive starvation: bounded p99 under the flood
            with self._lock:
                lats = list(self._latencies)
            assert len(lats) >= 50, (
                f"interactive tenants starved: only {len(lats)} ops completed"
            )
            p99 = float(np.percentile(np.asarray(lats), 99))
            self.report.interactive_p99_ms = p99 * 1e3
            assert p99 <= cfg.interactive_p99_bound_s, (
                f"interactive starvation: p99 {p99*1e3:.0f}ms over the "
                f"{cfg.interactive_p99_bound_s*1e3:.0f}ms bound"
            )
            # 3. zero acked-write loss (truth may run AHEAD of acked when an
            # applied write's ack was lost to a budgeted error — never behind)
            with self._lock:
                acked = dict(self._acked)
            for k, v in acked.items():
                got = None
                for _ in range(20):
                    try:
                        got = self._client.get_bucket(k).get()
                        break
                    except Exception:  # noqa: BLE001 — topology settling
                        time.sleep(0.2)
                got = 0 if got is None else int(got)
                assert got >= v, f"acked-write loss: {k} read {got} < acked {v}"
            # 4. QoS ledgers flat at quiesce: nothing in flight anywhere
            deadline = time.monotonic() + cfg.quiesce_deadline_s
            snap = self.census.snapshot()
            def busy_rows(s):
                return [
                    k for k, val in s.items()
                    if val and ("_inflight_" in k or k.endswith("_bulk_waiting"))
                ]
            while time.monotonic() < deadline and busy_rows(snap):
                time.sleep(0.2)
                snap = self.census.snapshot()
            assert not busy_rows(snap), (
                f"QoS ledger not flat at quiesce: {busy_rows(snap)}"
            )
            # the rest of the census must be flat too (cumulative QoS shed
            # counters, keyspace growth, and conn-pool churn excepted)
            self.census.assert_flat(
                before, snap,
                ignore=("*.keys", "*.wait_entries", "*.qos_shed_*",
                        "*.connections", "*.conn_idle", "*.conn_in_use",
                        "*.node_clients", "*.repl_*", "*.tracking_*"),
                context="qos soak",
            )
            self.report.census.append(snap)
            budget = max(10, (self.report.writes_acked + self.report.reads) // 2)
            assert self.report.errors <= budget, (
                f"error budget blown: {self.report.errors} vs {budget}"
            )
            return self.report
        finally:
            self._teardown()


# -- vector-search soak: KNN readers vs concurrent ingest ----------


@dataclass
class VectorSoakConfig:
    """KNN readers with tracked near-cached query results + concurrent HSET
    ingest against ONE device-sharded server while the slot table (and the
    index's embedding-bank record with it) rebalances 8 -> 4 -> 8 across
    devices under transport faults.  Invariants: zero stale tracked query
    results, zero acked-write loss, recall@k >= 0.99 vs a float64
    brute-force oracle AFTER the storm, and the embedding-bank census flat
    after FT.DROPINDEX."""

    seed: int = 0
    cycles: int = 1
    docs: int = 48
    dim: int = 16
    knn_k: int = 5
    query_pool: int = 8        # distinct reader queries (cache-hit shape)
    writer_threads: int = 2
    reader_threads: int = 2
    phase_seconds: float = 1.0
    faults_per_cycle: int = 8
    quiesce_s: float = 1.0
    # the soaked index is IVF by default — centroids + cell
    # table live in the bank's record and must MOVE WITH IT through every
    # fenced rebalance.  nprobe == nlist probes every cell, so the strict
    # 0.99 recall floor still binds (routing/cells machinery exercised,
    # exactness preserved — partial-probe recall has its own gated bench
    # legs); algo="FLAT" restores the flat-bank shape.
    algo: str = "IVF"
    nlist: int = 6
    nprobe: int = 6
    train_min: int = 24
    # shards > 1 soaks the MESH-SHARDED bank — per-shard records
    # under shard-salted hashtags rebalance independently, reads run the
    # fan-out + on-device merge path (sharded_knn_merges must move, and
    # host_colocations must NOT — the never-a-host-gather contract under
    # fire), and the per-device census rows must all die on DROPINDEX.
    shards: int = 1
    device: str = "cuda"           # where the server's positions live
    positions: Optional[int] = None  # mesh positions; None = every local one


@dataclass
class VectorSoakReport:
    cycles_completed: int = 0
    writes_acked: int = 0
    reads: int = 0
    cache_hits: int = 0
    invalidations: int = 0
    errors: int = 0
    stale_results: int = 0     # MUST stay 0
    rebalances: int = 0
    records_moved: int = 0
    recall_at_k: float = 0.0   # post-storm, vs the f64 oracle
    bank_bytes_peak: float = 0.0

    def summary(self) -> str:
        return (
            f"vector soak: {self.cycles_completed} cycles, "
            f"{self.writes_acked} acked ingests, {self.reads} KNN reads "
            f"({self.cache_hits} near-cache hits, {self.invalidations} "
            f"invalidations, {self.stale_results} stale), "
            f"{self.errors} budgeted errors, {self.rebalances} rebalances "
            f"({self.records_moved} records moved), post-storm recall@k "
            f"{self.recall_at_k:.4f}, bank peak {self.bank_bytes_peak:.0f}B"
        )


class VectorSoakHarness:
    """The vector-search plane's invariants, under fire:

      * **zero stale tracked results** — a reader that near-caches a KNN
        result keyed on the index's ``__ftq__`` query key either received
        an invalidation for every ingest that could change it, or its
        cached result still equals a fresh server query after quiesce;
      * **recall floor holds post-storm** — after rebalances, faults and
        concurrent ingest, server KNN against the final corpus matches the
        float64 brute-force oracle at >= 0.99 recall@k;
      * **zero acked-write loss** — every acked HSET version reads back;
      * **bank census flat** — FT.DROPINDEX returns the ftvec bank/byte
        gauges to baseline (teardown releases the device memory)."""

    INDEX = "vsoak"
    PREFIX = "vs:"

    def __init__(self, config: Optional[VectorSoakConfig] = None):
        self.config = config or VectorSoakConfig()
        self.report = VectorSoakReport()
        self._server = None
        self._journal_dir = None
        self._acked: Dict[int, int] = {}        # doc -> acked version
        self._acked_lock = threading.Lock()
        self._violations: List[str] = []
        rng = np.random.default_rng(self.config.seed + 5)
        self._base = rng.standard_normal(
            (self.config.docs, self.config.dim)
        ).astype(np.float32)
        self._bump = rng.standard_normal(
            (self.config.docs, self.config.dim)
        ).astype(np.float32)
        self._queries = rng.standard_normal(
            (self.config.query_pool, self.config.dim)
        ).astype(np.float32)

    def _vec(self, doc: int, version: int) -> np.ndarray:
        """Deterministic per-(doc, version) embedding: ingest keeps MOVING
        every doc in embedding space, so a stale cached result is actually
        wrong, not coincidentally right."""
        return (self._base[doc] + 0.05 * version * self._bump[doc]).astype(
            np.float32
        )

    def _connect(self, handler=None):
        from redisson_tpu_torch.net.client import Connection

        c = Connection(self._server.server.host, self._server.server.port,
                       timeout=10.0)
        if handler is not None:
            c.push_handler = handler
        return c

    def _setup(self) -> None:
        from redisson_tpu_torch.server.server import ServerThread

        cfg = self.config
        self._journal_dir = tempfile.mkdtemp(prefix="rtpu-vecsoak-")
        self._server = ServerThread(
            port=0, devices=cfg.positions or "all", workers=8,
            device=cfg.device,
        ).start()
        admin = self._connect()
        shard_tail = (
            ("SHARDS", str(cfg.shards)) if cfg.shards > 1 else ()
        )
        if cfg.algo == "IVF":
            vec_tail = (
                "emb", "VECTOR", "IVF", str(12 + len(shard_tail)),
                "TYPE", "FLOAT32",
                "DIM", str(cfg.dim), "DISTANCE_METRIC", "L2",
                "NLIST", str(cfg.nlist), "NPROBE", str(cfg.nprobe),
                "TRAIN_MIN", str(cfg.train_min), *shard_tail,
            )
        else:
            vec_tail = (
                "emb", "VECTOR", "FLAT", str(6 + len(shard_tail)),
                "TYPE", "FLOAT32",
                "DIM", str(cfg.dim), "DISTANCE_METRIC", "L2", *shard_tail,
            )
        r = admin.execute(
            "FT.CREATE", self.INDEX, "ON", "HASH", "PREFIX", "1", self.PREFIX,
            "SCHEMA", "price", "NUMERIC", *vec_tail,
        )
        assert r == b"OK", r
        for i in range(cfg.docs):
            self._hset(admin, i, 0)
            self._acked[i] = 0
        admin.close()

    def _hset(self, conn, doc: int, version: int):
        return conn.execute(
            "HSET", f"{self.PREFIX}{doc}", "price", str(doc),
            "ver", str(version), "emb", self._vec(doc, version).tobytes(),
        )

    def _knn(self, conn, qi: int, k: Optional[int] = None):
        """One NOCONTENT KNN over query-pool vector `qi`; returns a tuple
        of (doc_id, score) pairs — the near-cache value shape."""
        out = conn.execute(
            "FT.SEARCH", self.INDEX, "(*)=>[KNN %d @emb $v]" % (
                k or self.config.knn_k
            ),
            "PARAMS", "2", "v", self._queries[qi].tobytes(), "NOCONTENT",
        )
        from redisson_tpu_torch.net.resp import RespError

        if isinstance(out, RespError):
            raise RuntimeError(str(out))
        pairs = []
        for j in range(1, len(out), 2):
            pairs.append((bytes(out[j]), bytes(out[j + 1][-1])))
        return tuple(pairs)

    def _teardown(self) -> None:
        from redisson_tpu_torch.net.client import install_fault_plane

        install_fault_plane(None)
        if self._server is not None:
            self._server.stop()

    # -- workload --------------------------------------------------------------

    def _writer(self, wid: int, stop: threading.Event) -> None:
        cfg = self.config
        conn = None
        vers = {d: 0 for d in range(wid, cfg.docs, cfg.writer_threads)}
        my_docs = sorted(vers)
        j = 0
        while not stop.is_set():
            try:
                if conn is None:
                    conn = self._connect()
                d = my_docs[j % len(my_docs)]
                v = vers[d] + 1
                r = self._hset(conn, d, v)
                from redisson_tpu_torch.net.resp import RespError

                if isinstance(r, RespError):
                    raise RuntimeError(str(r))
                vers[d] = v
                with self._acked_lock:
                    self._acked[d] = max(self._acked[d], v)
                    self.report.writes_acked += 1
            except Exception:  # noqa: BLE001 — budgeted fault-window error
                with self._acked_lock:
                    self.report.errors += 1
                try:
                    if conn is not None:
                        conn.close()
                except Exception:  # noqa: BLE001
                    pass
                conn = None
            j += 1
            time.sleep(0.004)
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    def _reader(self, rid: int, stop: threading.Event,
                final_caches: List[Dict[int, tuple]]) -> None:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed * 97 + rid)
        state = {"conn": None, "cache": {}, "epoch": 0}

        def on_push(push) -> None:
            try:
                if bytes(push[0]) == b"invalidate":
                    state["cache"].clear()
                    state["epoch"] += 1
                    with self._acked_lock:
                        self.report.invalidations += 1
            except Exception:  # noqa: BLE001
                state["cache"].clear()
                state["epoch"] += 1

        while not stop.is_set():
            try:
                if state["conn"] is None:
                    state["cache"] = {}
                    c = self._connect(handler=on_push)
                    c.execute("CLIENT", "TRACKING", "ON")
                    state["conn"] = c
                qi = int(rng.integers(cfg.query_pool))
                cached = state["cache"].get(qi)
                if cached is not None and rng.random() < 0.7:
                    # near-cache hit — but still PING so queued pushes drain
                    state["conn"].execute("PING")
                    with self._acked_lock:
                        self.report.reads += 1
                        self.report.cache_hits += 1
                else:
                    # the NearCache in-flight discipline (tracking/
                    # nearcache.py): an invalidation that lands WHILE this
                    # read is on the wire may cover a write the result
                    # predates — and the push also consumed the one-shot
                    # registration, so no later push would ever clear the
                    # entry.  Cache only epoch-stable results.
                    epoch0 = state["epoch"]
                    res = self._knn(state["conn"], qi)
                    if state["epoch"] == epoch0:
                        state["cache"][qi] = res
                    with self._acked_lock:
                        self.report.reads += 1
            except Exception:  # noqa: BLE001 — budgeted fault-window error
                with self._acked_lock:
                    self.report.errors += 1
                try:
                    if state["conn"] is not None:
                        state["conn"].close()
                except Exception:  # noqa: BLE001
                    pass
                state["conn"] = None
            time.sleep(0.003)
        # quiesce-time coherence check happens in run(): hand the LIVE
        # cache dict over (a drain-time invalidation push must still be
        # able to clear entries before the staleness comparison reads them)
        final_caches[rid] = state["cache"]
        self._reader_conns[rid] = state["conn"]

    def _rebalance(self, n_active: int) -> None:
        from redisson_tpu_torch.server import migration as mig

        engine = self._server.server.engine
        targets = engine.placement.spread_plan(n_active)
        moved = mig.rebalance_devices(
            engine, targets, journal_dir=self._journal_dir
        )
        self.report.rebalances += 1
        self.report.records_moved += moved
        self._assert_index_moved_with_bank()

    def _assert_index_moved_with_bank(self) -> None:
        """The IVF coarse index (centroids + cell table) lives in
        the SAME record as the bank — after a fenced rebalance all of its
        device arrays must sit on ONE device (nothing straggles on the old
        owner).  A sharded bank is a CONSTELLATION — the manifest
        record lists the shard records, and the invariant holds PER SHARD
        (each shard's bank + coarse index move as one record; different
        shards legitimately sit on different devices)."""
        from redisson_tpu_torch.core.ioplane import device_of
        from redisson_tpu_torch.services.vector import bank_record_name

        store = self._server.server.engine.store
        rec = store.get(bank_record_name(self.INDEX, "emb"))
        if rec is None:
            return
        names = rec.meta.get("shard_names") or [
            bank_record_name(self.INDEX, "emb")
        ]
        for nm in names:
            srec = store.get(nm)
            if srec is None:
                continue
            devices = {
                str(device_of(a))
                for a in srec.arrays.values() if a is not None
            }
            devices.discard("None")
            assert len(devices) <= 1, (
                f"{nm}: bank/centroids/cells split across devices: "
                f"{devices}"
            )

    # -- run -------------------------------------------------------------------

    def run(self) -> VectorSoakReport:
        from redisson_tpu_torch.net.client import install_fault_plane
        from redisson_tpu_torch.server import migration as mig

        cfg = self.config
        self._setup()
        census = ResourceCensus()
        census.track_server("srv", self._server.server)
        try:
            from redisson_tpu_torch.core import ioplane

            engine = self._server.server.engine
            baseline = census.snapshot()
            io_base = ioplane.STATS.snapshot()
            self._reader_conns: List[Optional[object]] = [None] * cfg.reader_threads
            final_caches: List[Dict[int, tuple]] = [{} for _ in range(cfg.reader_threads)]
            for cycle in range(cfg.cycles):
                sched = FaultSchedule(cfg.seed * 6151 + cycle)
                n = max(1, cfg.faults_per_cycle)
                sched.add_random("delay", n=n, window=300, delay_s=0.01)
                sched.add_random("drop", n=max(1, n // 2), window=300)
                stop = threading.Event()
                threads = [
                    threading.Thread(
                        target=self._writer, args=(w, stop), daemon=True
                    )
                    for w in range(cfg.writer_threads)
                ] + [
                    threading.Thread(
                        target=self._reader, args=(r, stop, final_caches),
                        daemon=True,
                    )
                    for r in range(cfg.reader_threads)
                ]
                install_fault_plane(FaultPlane(sched))
                for t in threads:
                    t.start()
                try:
                    time.sleep(cfg.phase_seconds)
                    self._rebalance(4)      # 8 -> 4 under traffic
                    snap = self._server.server._ftvec_census()
                    self.report.bank_bytes_peak = max(
                        self.report.bank_bytes_peak,
                        snap["ftvec_device_bytes"],
                    )
                    time.sleep(cfg.phase_seconds)
                    self._rebalance(engine.placement.n_devices)  # 4 -> 8
                    time.sleep(cfg.phase_seconds)
                finally:
                    stop.set()
                    for t in threads:
                        t.join(timeout=30)
                    install_fault_plane(None)
                self.report.cycles_completed += 1
            time.sleep(cfg.quiesce_s)
            leftover = mig.resume_device_rebalances(engine, self._journal_dir)
            assert leftover == [], f"rebalances left in flight: {leftover}"
            # zero acked-write loss: every acked version reads back
            check = self._connect()
            with self._acked_lock:
                acked = dict(self._acked)
            for d, v in acked.items():
                got = check.execute("HGET", f"{self.PREFIX}{d}", "ver")
                got = int(got) if got is not None else -1
                assert got >= v, (
                    f"acked-write loss: {self.PREFIX}{d} ver {got} < acked {v}"
                )
            # zero stale tracked results: any cache entry a reader still
            # holds was never invalidated — after quiesce (one PING drains
            # the push queue) it must equal a fresh server answer
            for rid, cache in enumerate(final_caches):
                conn = self._reader_conns[rid]
                if conn is None:
                    continue
                try:
                    conn.execute("PING")  # drain queued invalidations
                except Exception:  # noqa: BLE001
                    continue
                for qi, cached in list(cache.items()):
                    # drop entries an in-flight push just cleared
                    fresh = self._knn(check, qi)
                    if cached != fresh and qi in cache:
                        self.report.stale_results += 1
                        self._violations.append(
                            f"reader{rid} q{qi}: cached {cached} != {fresh}"
                        )
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
            assert self.report.stale_results == 0, (
                "stale tracked KNN results: " + "; ".join(self._violations[:3])
            )
            # recall floor post-storm: server KNN vs the f64 oracle over the
            # FINAL corpus (read back from the server, not assumed)
            corpus = np.zeros((cfg.docs, cfg.dim), np.float64)
            for d in range(cfg.docs):
                blob = check.execute("HGET", f"{self.PREFIX}{d}", "emb")
                corpus[d] = np.frombuffer(bytes(blob), "<f4").astype(np.float64)
            hits = total = 0
            for qi in range(cfg.query_pool):
                mine = self._knn(check, qi)
                q64 = self._queries[qi].astype(np.float64)
                d64 = np.sum((corpus - q64[None, :]) ** 2, axis=1)
                truth = {
                    f"{self.PREFIX}{r}".encode()
                    for r in np.argsort(d64, kind="stable")[: cfg.knn_k]
                }
                hits += len(truth & {doc for doc, _s in mine})
                total += cfg.knn_k
            self.report.recall_at_k = hits / total
            assert self.report.recall_at_k >= 0.99, (
                f"post-storm recall@{cfg.knn_k} {self.report.recall_at_k:.4f}"
            )
            # bank census flat after teardown: DROPINDEX must release the
            # device-resident banks (the HBM-ledger guard)
            assert self.report.bank_bytes_peak > 0, "bank never materialized"
            r = check.execute("FT.DROPINDEX", self.INDEX)
            assert r == b"OK", r
            check.close()
            after = census.snapshot()
            assert after["srv.ftvec_banks"] == 0.0, after
            assert after["srv.ftvec_device_bytes"] == 0.0, after
            # the IVF cell index must die with the bank (a leak row)
            assert after["srv.ftvec_index_bytes"] == 0.0, after
            # per-device ledger rows: every shard's row is gone
            # or zero once the constellation tore down
            leaked = {
                k: v for k, v in after.items()
                if k.startswith("srv.ftvec_") and "bytes_dev" in k
                and v != 0.0
            }
            assert not leaked, leaked
            census.assert_flat(
                baseline, after,
                # ftvec rows are asserted EXACTLY zero above (the baseline
                # snapshot runs after _setup's FT.CREATE, so their diff is
                # the 1 -> 0 teardown, not a leak)
                ignore=("*.keys", "*.wait_entries", "*.connections",
                        "*.conn_*", "*.repl_*", "*.tracking_*",
                        "*.qos_shed_*", "*.ftvec_*"),
                context="vector soak",
            )
            lanes = engine.lanes.census()
            assert lanes["active_dispatches"] == 0, lanes
            # the never-a-host-gather contract: every cross-
            # shard KNN merge of the storm rode d2d colocation, not a host
            # round trip — and with shards > 1, the merge path actually ran
            io_snap = ioplane.STATS.snapshot()
            assert (
                io_snap["host_colocations"] == io_base["host_colocations"]
            ), (io_base, io_snap)
            if cfg.shards > 1:
                assert (
                    io_snap["sharded_knn_merges"]
                    > io_base["sharded_knn_merges"]
                ), (io_base, io_snap)
            budget = max(10, (self.report.writes_acked + self.report.reads) // 2)
            assert self.report.errors <= budget, (
                f"error budget blown: {self.report.errors} vs {budget}"
            )
            assert self.report.writes_acked > 0 and self.report.reads > 0
            return self.report
        finally:
            self._teardown()


# -- device-fault soak: lane watchdogs, OOM degradation, -----------
#    quarantine-and-evacuate


@dataclass
class DeviceFaultSoakConfig(DeviceShardSoakConfig):
    """Mixed bucket/bloom/KNN traffic against one device-sharded server
    while device lanes are killed (kernel-launch failures), hung (stalled
    readbacks under an armed watchdog) and OOMed (RESOURCE_EXHAUSTED bank
    growth), and the quarantined lane is evacuated mid-traffic."""

    watchdog_ms: int = 250         # lane watchdog bound (armed via CONFIG)
    quarantine_after: int = 3      # consecutive faults that trip a lane
    hang_s: float = 0.75           # injected stall (> watchdog bound)
    kernel_faults: int = 40        # consecutive dispatch kills on the victim
    docs: int = 32                 # KNN corpus (bit-identity oracle)
    dim: int = 16
    victim: int = 1                # device INDEX killed + evacuated
    hang_victim: int = 2           # device INDEX whose readbacks stall


@dataclass
class DeviceFaultSoakReport(DeviceShardSoakReport):
    quarantines: int = 0           # lanes the fault streak actually tripped
    evacuations: int = 0
    probes_passed: int = 0         # CLUSTER DEVPROBE un-quarantines
    oom_errors: int = 0            # clean -OOM replies observed
    banks_verified: int = 0        # docs proven bit-identical post-evacuation
    injected: Dict[str, int] = field(default_factory=dict)

    def summary(self) -> str:
        return (
            f"device-fault soak: {self.cycles_completed} cycles, "
            f"{self.writes_acked} acked writes, {self.reads} tracked reads "
            f"({self.stale_reads} stale), {self.errors} budgeted errors, "
            f"{self.quarantines} quarantines, {self.evacuations} evacuations "
            f"({self.records_moved} records moved), {self.probes_passed} "
            f"probes passed, {self.oom_errors} -OOM replies, "
            f"banks={self.banks_verified} docs bit-identical, "
            f"bloom={self.bloom_keys_verified} keys verified, "
            f"injected={self.injected}"
        )


class DeviceFaultSoakHarness(DeviceShardSoakHarness):
    """The device fault domain's invariants, under fire:

      * **detection** — a lane whose dispatches keep failing with the real
        CUDA kernel-launch error shape trips QUARANTINED at the
        consecutive-fault threshold; a hung readback is BOUNDED by the armed
        lane watchdog (``CONFIG SET lane-watchdog-ms``) instead of wedging
        its writer, and counts on the same streak;
      * **degradation** — commands routed to a faulted/quarantined device
        fail with clean retryable ``-TRYAGAIN`` replies (never a dead
        connection, never a wedge); an HBM-exhausted bank growth degrades
        to ONE ``-OOM`` reply with the rows kept pending, and a later retry
        lands them;
      * **recovery** — the quarantined lane's slots evacuate mid-traffic
        through the journaled fenced rebalance path (zero acked-write
        loss, resumable), and a ``CLUSTER DEVPROBE`` dispatch that passes
        un-quarantines the lane so a respread returns it to rotation;
      * **proof of bit-identity** — after evacuation every doc's stored
        version field still matches its bank row EXACTLY (KNN with the
        expected embedding returns that doc at distance ~0), every acked
        bloom add still probes true, tracked readers never saw a stale
        value, and the lane census returns to baseline.
    """

    INDEX = "dfvec"
    PREFIX = "dfv:"

    def __init__(self, config: Optional[DeviceFaultSoakConfig] = None):
        super().__init__(config or DeviceFaultSoakConfig())
        self.report = DeviceFaultSoakReport()
        cfg = self.config
        rng = np.random.default_rng(cfg.seed + 23)
        self._base = rng.standard_normal((cfg.docs, cfg.dim)).astype(np.float32)
        self._bump = rng.standard_normal((cfg.docs, cfg.dim)).astype(np.float32)
        self._doc_acked: Dict[int, int] = {}
        self._prev_watchdog = None
        self._prev_quarantine = None

    def _vec(self, doc: int, version: int) -> np.ndarray:
        """Deterministic per-(doc, version) embedding — the bit-identity
        oracle: the bank row for a doc whose stored ``ver`` field reads v
        must equal EXACTLY this vector."""
        return (self._base[doc] + 0.05 * version * self._bump[doc]).astype(
            np.float32
        )

    def _connect(self):
        from redisson_tpu_torch.net.client import Connection

        return Connection(self._server.server.host, self._server.server.port,
                          timeout=10.0)

    def _hset_doc(self, conn, doc: int, version: int):
        return conn.execute(
            "HSET", f"{self.PREFIX}{doc}", "ver", str(version),
            "emb", self._vec(doc, version).tobytes(),
        )

    def _knn1(self, conn, index: str, query: np.ndarray):
        """Top-1 NOCONTENT KNN; returns (doc_id_bytes, score_float)."""
        from redisson_tpu_torch.net.resp import RespError

        out = conn.execute(
            "FT.SEARCH", index, "(*)=>[KNN 1 @emb $v]",
            "PARAMS", "2", "v", query.astype(np.float32).tobytes(),
            "NOCONTENT",
        )
        if isinstance(out, RespError):
            raise RuntimeError(str(out))
        if len(out) < 3:
            raise RuntimeError(f"empty KNN reply: {out!r}")
        return bytes(out[1]), float(out[2][-1])

    def _setup(self) -> None:
        from redisson_tpu_torch.core import ioplane

        super()._setup()
        cfg = self.config
        self._prev_watchdog = ioplane.lane_watchdog_ms()
        self._prev_quarantine = ioplane.quarantine_after()
        admin = self._connect()
        try:
            r = admin.execute("CONFIG", "SET", "lane-watchdog-ms",
                              str(cfg.watchdog_ms))
            assert r in (b"OK", "OK"), r
            r = admin.execute("CONFIG", "SET", "lane-quarantine-after",
                              str(cfg.quarantine_after))
            assert r in (b"OK", "OK"), r
            r = admin.execute(
                "FT.CREATE", self.INDEX, "ON", "HASH",
                "PREFIX", "1", self.PREFIX,
                "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                "DIM", str(cfg.dim), "DISTANCE_METRIC", "L2",
            )
            assert r in (b"OK", "OK"), r
            for d in range(cfg.docs):
                self._hset_doc(admin, d, 0)
                self._doc_acked[d] = 0
            # force the bank's device allocation NOW, before any chaos plane
            # installs: the armed window's first device_alloc event is then
            # deterministically the OOM leg's own bank, never this one's
            self._knn1(admin, self.INDEX, self._base[0])
        finally:
            admin.close()

    def _teardown(self) -> None:
        from redisson_tpu_torch.core import ioplane

        # the watchdog/quarantine knobs are process-global: restore them so
        # a failing run never leaks an armed watchdog into the next test
        if self._prev_watchdog is not None:
            ioplane.set_lane_watchdog_ms(self._prev_watchdog)
        if self._prev_quarantine is not None:
            ioplane.set_quarantine_after(self._prev_quarantine)
        super()._teardown()

    # -- workload additions ----------------------------------------------------

    def _ingest(self, stop: threading.Event) -> None:
        """KNN-corpus writer: keeps every doc MOVING in embedding space
        (ver bumps re-derive the row), so the post-evacuation bit-identity
        check proves the bank tracked the acked writes exactly."""
        cfg = self.config
        conn = None
        vers = dict(self._doc_acked)
        j = 0
        while not stop.is_set():
            d = j % cfg.docs
            try:
                if conn is None:
                    conn = self._connect()
                from redisson_tpu_torch.net.resp import RespError

                r = self._hset_doc(conn, d, vers[d] + 1)
                if isinstance(r, RespError):
                    raise RuntimeError(str(r))
                vers[d] += 1
                with self._acked_lock:
                    self._doc_acked[d] = vers[d]
                    self.report.writes_acked += 1
            except Exception:  # noqa: BLE001 — budgeted fault-window error
                try:
                    if conn is not None:
                        conn.close()
                except Exception:  # noqa: BLE001
                    pass
                conn = None
                with self._acked_lock:
                    self.report.errors += 1
            j += 1
            time.sleep(0.004)
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    def _survivor_key(self, prefix: str, victim: int) -> str:
        """A key of `prefix` whose slot is NOT owned by the victim device —
        the OOM leg must not stall behind the victim's quarantine."""
        from redisson_tpu_torch.core.ioplane import quarantined_device_ids
        from redisson_tpu_torch.utils.crc16 import calc_slot

        placement = self._server.server.engine.placement
        owner = placement.owner_snapshot()
        bad = quarantined_device_ids()
        for i in range(512):
            key = f"{prefix}{i}"
            idx = int(owner[calc_slot(key)])
            dev_id = getattr(placement.devices[idx], "id", idx)
            if idx != victim and dev_id not in bad:
                return key
        raise AssertionError("no survivor-owned key found")

    def _oom_leg(self, cycle: int) -> None:
        """Deterministic HBM-OOM degradation: a fresh index's FIRST bank
        allocation faults with the RESOURCE_EXHAUSTED shape — the client
        sees ONE clean -OOM reply, the rows stay pending, and the retry
        lands them (graceful degradation, never a dead connection)."""
        from redisson_tpu_torch.net.resp import RespError

        cfg = self.config
        index = f"dfoom{cycle}"
        prefix = f"dfo{cycle}:"
        key = self._survivor_key(prefix, cfg.victim)
        conn = self._connect()
        try:
            r = conn.execute(
                "FT.CREATE", index, "ON", "HASH", "PREFIX", "1", prefix,
                "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                "DIM", "8", "DISTANCE_METRIC", "L2",
            )
            assert r in (b"OK", "OK"), r
            q = np.ones(8, np.float32)
            r = conn.execute("HSET", key, "emb", q.tobytes())
            assert not isinstance(r, RespError), r
            # first search forces the bank's first device allocation — the
            # armed device_oom rule faults it: ONE -OOM reply, rows pending
            out = conn.execute(
                "FT.SEARCH", index, "(*)=>[KNN 1 @emb $v]",
                "PARAMS", "2", "v", q.tobytes(), "NOCONTENT",
            )
            assert isinstance(out, RespError) and "OOM" in str(out), (
                f"expected a clean -OOM reply, got {out!r}"
            )
            with self._acked_lock:
                self.report.oom_errors += 1
            # the retry allocates for real and drains the kept-pending rows
            doc, score = self._knn1(conn, index, q)
            assert doc == key.encode() and score < 1e-4, (doc, score)
        finally:
            conn.close()

    # -- run -------------------------------------------------------------------

    def run(self) -> DeviceFaultSoakReport:
        from redisson_tpu_torch.core import ioplane
        from redisson_tpu_torch.net.client import install_fault_plane
        from redisson_tpu_torch.server import migration as mig
        from redisson_tpu_torch.utils.crc16 import MAX_SLOT

        cfg = self.config
        self._setup()
        try:
            engine = self._server.server.engine
            placement = engine.placement
            assert placement.n_devices > max(cfg.victim, cfg.hang_victim), (
                f"need > {max(cfg.victim, cfg.hang_victim)} devices, "
                f"have {placement.n_devices}"
            )
            victim_id = getattr(
                placement.devices[cfg.victim], "id", cfg.victim
            )
            hang_id = getattr(
                placement.devices[cfg.hang_victim], "id", cfg.hang_victim
            )
            baseline = self._lane_census()
            self.report.lane_census.append(baseline)
            io_base = ioplane.STATS.snapshot()
            for cycle in range(cfg.cycles):
                sched = FaultSchedule(cfg.seed * 6007 + cycle)
                # kill the victim lane's dispatches until quarantine trips
                sched.add("device_kernel", port=victim_id, after=2,
                          count=cfg.kernel_faults)
                # hang two readbacks on another lane: the armed watchdog
                # bounds them (two < quarantine_after: trips nothing)
                sched.add("device_hang", port=hang_id, after=2, count=2,
                          delay_s=cfg.hang_s)
                # the next fresh bank allocation OOMs (the _oom_leg index)
                sched.add("device_oom", after=0, count=1)
                plane = FaultPlane(sched)
                stop = threading.Event()
                threads = [
                    threading.Thread(
                        target=self._writer, args=(w, stop), daemon=True
                    )
                    for w in range(cfg.writer_threads)
                ] + [
                    threading.Thread(
                        target=self._reader, args=(stop,), daemon=True
                    ),
                    threading.Thread(
                        target=self._ingest, args=(stop,), daemon=True
                    ),
                ]
                install_fault_plane(plane)
                for t in threads:
                    t.start()
                try:
                    self._oom_leg(cycle)
                    # detection: traffic drives the victim's dispatch stream
                    # into the kill window; the streak must trip QUARANTINED
                    deadline = time.monotonic() + 30.0
                    while victim_id not in ioplane.quarantined_device_ids():
                        assert time.monotonic() < deadline, (
                            "victim lane never quarantined; injected="
                            f"{plane.injected}"
                        )
                        time.sleep(0.01)
                    self.report.quarantines += 1
                    time.sleep(cfg.phase_seconds / 2)
                    # recovery: evacuate the quarantined lane MID-TRAFFIC
                    # through the journaled fenced rebalance path
                    moved, targets, _epoch = mig.evacuate_device(
                        engine, cfg.victim, journal_dir=self._journal_dir
                    )
                    self.report.evacuations += 1
                    self.report.rebalances += 1
                    self.report.records_moved += moved
                    assert placement.slot_counts()[cfg.victim] == 0, (
                        placement.slot_counts()
                    )
                    time.sleep(cfg.phase_seconds)
                finally:
                    stop.set()
                    for t in threads:
                        t.join(timeout=30)
                    install_fault_plane(None)
                for kind, n in plane.injected.items():
                    self.report.injected[kind] = (
                        self.report.injected.get(kind, 0) + n
                    )
                # probe EVERY quarantined lane (the victim, plus any lane
                # an incidental genuine watchdog trip flagged under load —
                # the same probe loop an operator runs): a passing
                # chaos-free dispatch un-quarantines it, then a respread
                # returns the victim to rotation
                admin = self._connect()
                try:
                    for idx in range(placement.n_devices):
                        lane = engine.lanes.lane(placement.devices[idx])
                        if not lane.quarantined:
                            continue
                        r = admin.execute("CLUSTER", "DEVPROBE", str(idx))
                        assert list(r) == [1, 0], (
                            f"probe of device {idx} should pass + "
                            f"un-quarantine, got {r!r}"
                        )
                        self.report.probes_passed += 1
                finally:
                    admin.close()
                assert ioplane.quarantined_device_ids() == set()
                moved = mig.rebalance_devices(
                    engine, placement.spread_plan(placement.n_devices),
                    journal_dir=self._journal_dir,
                )
                self.report.rebalances += 1
                self.report.records_moved += moved
                self.report.cycles_completed += 1
            # every injected fault kind actually fired
            assert self.report.injected.get("device_kernel", 0) > 0
            assert self.report.injected.get("device_hang", 0) > 0
            assert self.report.injected.get("device_oom", 0) > 0
            # quiesce, then the invariants
            time.sleep(cfg.quiesce_s)
            leftover = mig.resume_device_rebalances(engine, self._journal_dir)
            assert leftover == [], f"rebalances left in flight: {leftover}"
            counts = placement.slot_counts()
            assert sum(counts) == MAX_SLOT, counts
            assert all(c > 0 for c in counts), (
                f"respread left a device empty: {counts}"
            )
            # zero acked-write loss across quarantine + evacuation
            with self._acked_lock:
                acked = dict(self._acked)
                doc_acked = dict(self._doc_acked)
            for k, v in acked.items():
                got = self._writer_client.get_bucket(k).get()
                got = 0 if got is None else int(got)
                assert got >= v, f"acked-write loss: {k} read {got} < acked {v}"
            for name, keys in self._bloom_keys.items():
                bf = self._writer_client.get_bloom_filter(name)
                bf.add_all(keys[:400])
                found = np.asarray(bf.contains_each(keys[:400]))
                assert found.all(), f"{name}: acked bloom adds lost"
                self.report.bloom_keys_verified += int(found.sum())
            # bit-identical banks post-evacuation: each doc's STORED version
            # field must match its bank row exactly — KNN with the expected
            # embedding returns that doc at ~zero L2 distance
            conn = self._connect()
            try:
                for d in range(cfg.docs):
                    ver = conn.execute("HGET", f"{self.PREFIX}{d}", "ver")
                    ver = int(ver)
                    assert ver >= doc_acked[d], (
                        f"acked-ingest loss: doc {d} stored ver {ver} < "
                        f"acked {doc_acked[d]}"
                    )
                    doc, score = self._knn1(
                        conn, self.INDEX, self._vec(d, ver)
                    )
                    assert doc == f"{self.PREFIX}{d}".encode(), (
                        f"doc {d} (ver {ver}): bank row diverged — nearest "
                        f"is {doc!r} at {score}"
                    )
                    assert score < 1e-3, (
                        f"doc {d} (ver {ver}): bank row not bit-identical "
                        f"(L2^2 {score})"
                    )
                    self.report.banks_verified += 1
            finally:
                conn.close()
            # tracked caches converge to ground truth after quiesce
            for k in acked:
                truth = self._writer_client.get_bucket(k).get()
                tracked = self._reader_buckets[k].get()
                assert tracked == truth, (
                    f"near cache diverged on {k}: {tracked} != {truth}"
                )
            assert self.report.stale_reads == 0, (
                "stale tracked reads across quarantine/evacuation: "
                + "; ".join(self._violations[:5])
            )
            # no lane left quarantined, no fault state leaked into census
            assert ioplane.quarantined_device_ids() == set()
            snap = ioplane.STATS.snapshot()
            self.report.host_colocations = snap["host_colocations"]
            assert snap["host_colocations"] == io_base["host_colocations"], (
                "evacuation gathered through the host"
            )
            final = self._lane_census()
            self.report.lane_census.append(final)
            assert final["active_dispatches"] == 0, final
            assert final["lanes"] == baseline["lanes"], (baseline, final)
            budget = max(
                10, (self.report.writes_acked + self.report.reads) // 2
            )
            assert self.report.errors <= budget, (
                f"error budget blown: {self.report.errors} vs {budget}"
            )
            assert self.report.writes_acked > 0 and self.report.reads > 0
            return self.report
        finally:
            self._teardown()


# -- residency soak: zipf tenants over overcommitted HBM -----------


@dataclass
class ResidencySoakConfig:
    """Zipf tenant banks whose combined footprint overcommits the armed
    per-device budget several-fold, read/written under transport faults
    while slots rebalance across devices AND the ResidencyRebalancer sheds
    pressured devices through the journaled fenced driver."""

    seed: int = 0
    cycles: int = 1
    keys: int = 32                 # tracked buckets (coherence probes)
    filters: int = 24              # tenant bloom banks (the demotable HBM)
    filter_keys: int = 400         # acked members per bank
    writer_threads: int = 2
    phase_seconds: float = 1.0
    faults_per_cycle: int = 8
    budget_divisor: int = 4        # armed budget = bank footprint / this
    quiesce_s: float = 1.0
    device: str = "cuda"           # where the server's positions live
    positions: Optional[int] = None  # mesh positions; None = every local one


@dataclass
class ResidencySoakReport:
    cycles_completed: int = 0
    writes_acked: int = 0
    reads: int = 0
    tenant_probes: int = 0
    errors: int = 0
    stale_reads: int = 0           # tracked-read monotonicity (MUST stay 0)
    promotions: int = 0
    demotions_warm: int = 0
    demotions_cold: int = 0
    rebalances: int = 0
    records_moved: int = 0
    rebalancer_sweeps: int = 0
    rebalancer_sheds: int = 0
    post_storm_recall: float = 0.0  # demoted-then-promoted banks (>= 0.99)
    tier_census: List[Dict[str, float]] = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"residency soak: {self.cycles_completed} cycles, "
            f"{self.writes_acked} acked writes, {self.reads} tracked reads "
            f"({self.stale_reads} stale), {self.tenant_probes} tenant "
            f"probes, {self.errors} budgeted errors, "
            f"{self.promotions} promotions / {self.demotions_warm}w+"
            f"{self.demotions_cold}c demotions, {self.rebalances} "
            f"rebalances ({self.records_moved} records moved), rebalancer "
            f"{self.rebalancer_sweeps} sweeps / {self.rebalancer_sheds} "
            f"sheds, post-storm recall={self.post_storm_recall:.4f}, "
            f"tier census points={len(self.tier_census)}"
        )


class ResidencySoakHarness:
    """The tiered-HBM residency invariants, under fire:

      * **overcommit serves** — zipf tenant banks totaling
        ``budget_divisor``x the armed per-device budget keep answering
        membership probes (demote to host + fault-in on first touch)
        through transport faults, slot rebalances, and rebalancer sheds;
      * **zero acked-write loss, zero stale tracked reads** — demotion and
        fault-in are invisible to the consistency planes;
      * **post-storm recall** — after the storm, every bank is force-demoted
        COLD (spilled through the CRC-covered container) and probed back:
        acked members must read true (>= 0.99; bloom banks have no false
        negatives, so a miss means tier cycling corrupted state);
      * **per-tier census flat at quiesce** — two census snapshots after
        quiesce are byte-identical, and DELing a COLD bank drains its rows
        AND its spill file to absence.
    """

    def __init__(self, config: Optional[ResidencySoakConfig] = None):
        self.config = config or ResidencySoakConfig()
        self.report = ResidencySoakReport()
        self._rng = np.random.default_rng(self.config.seed)
        self._server = None
        self._writer_client = None
        self._reader_client = None
        self._reader_plane = None
        self._reader_buckets = {}
        self._reader_last: Dict[str, int] = {}
        self._acked: Dict[str, int] = {}
        self._acked_lock = threading.Lock()
        self._bloom_keys: Dict[str, np.ndarray] = {}
        self._journal_dir = None
        self._rebalancer = None
        self._prev_budget = None
        self._prev_tier = None
        self._violations: List[str] = []

    def _key(self, i: int) -> str:
        return f"res:{i}"

    def _setup(self) -> None:
        from redisson_tpu_torch.client.remote import RemoteRedisson
        from redisson_tpu_torch.core import ioplane
        from redisson_tpu_torch.core import residency as _res
        from redisson_tpu_torch.server.server import ServerThread

        cfg = self.config
        self._journal_dir = tempfile.mkdtemp(prefix="rtpu-ressoak-")
        self._server = ServerThread(
            port=0, devices=cfg.positions or "all", workers=8,
            device=cfg.device,
        ).start()
        ioplane.STATS.reset()
        ioplane.reset_device_stats()
        addr = f"{self._server.server.host}:{self._server.server.port}"
        self._writer_client = RemoteRedisson(addr, timeout=10.0)
        self._reader_client = RemoteRedisson(addr, timeout=10.0)
        self._reader_plane = self._reader_client.enable_tracking(
            cache_entries=8 * cfg.keys
        )
        for i in range(cfg.keys):
            self._writer_client.get_bucket(self._key(i)).set(0)
            self._acked[self._key(i)] = 0
        self._reader_buckets = {
            self._key(i): self._reader_plane.get_bucket(self._key(i))
            for i in range(cfg.keys)
        }
        rng = np.random.default_rng(cfg.seed + 17)
        for f in range(cfg.filters):
            name = f"resbf:{f}"
            bf = self._writer_client.get_bloom_filter(name)
            assert bf.try_init(50_000, 0.01)
            keys = rng.integers(0, 1 << 60, cfg.filter_keys).astype(np.int64)
            bf.add_all(keys)
            self._bloom_keys[name] = keys
        # arm the plane AFTER the banks exist so the measured footprint is
        # real, with the server's migration fences wired in
        srv = self._server.server
        srv.enable_residency(min_idle_s=0.05, sweep_interval=0.2)
        mgr = srv.engine.residency
        footprint = sum(
            b for n, b in self._bank_bytes().items()
        )
        budget = max(1, footprint // cfg.budget_divisor)
        self._prev_budget = _res.set_device_budget_bytes(budget)
        self._prev_tier = _res.set_tier(True)
        # the fleet control loop: scrape this node's ledgers, demote-first,
        # shed persistent pressure through the journaled rebalance
        from contextlib import closing

        from redisson_tpu_torch.cluster.residency_control import ResidencyRebalancer
        from redisson_tpu_torch.net.client import Connection

        host, port = srv.host, srv.port

        def factory():
            return closing(Connection(host, port, timeout=10.0))

        self._rebalancer = ResidencyRebalancer(
            {addr: factory}, interval=0.25, high_water=0.9, shed_after=3,
            shed_count=512, journal_dir=self._journal_dir,
        ).start()

    def _bank_bytes(self) -> Dict[str, int]:
        from redisson_tpu_torch.core import residency as _res

        eng = self._server.server.engine
        out: Dict[str, int] = {}
        with _res.no_promote():
            for name in self._bloom_keys:
                rec = eng.store.get_unguarded(name)
                if rec is not None:
                    out[name] = _res.record_device_bytes(rec)
        return out

    def _teardown(self) -> None:
        from redisson_tpu_torch.core import residency as _res
        from redisson_tpu_torch.net.client import install_fault_plane

        install_fault_plane(None)
        if self._rebalancer is not None:
            self._rebalancer.stop()
        if self._prev_budget is not None:
            _res.set_device_budget_bytes(self._prev_budget)
        if self._prev_tier is not None:
            _res.set_tier(self._prev_tier)
        for c in (self._reader_client, self._writer_client):
            if c is not None:
                try:
                    c.shutdown()
                except Exception:  # noqa: BLE001
                    pass
        if self._server is not None:
            self._server.stop()

    # -- workload ------------------------------------------------------------

    def _writer(self, wid: int, stop: threading.Event) -> None:
        cfg = self.config
        client = self._writer_client
        my_keys = [
            self._key(i) for i in range(wid, cfg.keys, cfg.writer_threads)
        ]
        vals = {k: self._acked.get(k, 0) for k in my_keys}
        my_filters = [
            n for j, n in enumerate(sorted(self._bloom_keys))
            if j % cfg.writer_threads == wid
        ]
        j = 0
        while not stop.is_set():
            k = my_keys[j % len(my_keys)]
            v = vals[k] + 1
            try:
                client.get_bucket(k).set(v)
                vals[k] = v
                with self._acked_lock:
                    self._acked[k] = v
                    self.report.writes_acked += 1
            except Exception:  # noqa: BLE001 — budgeted fault-window error
                with self._acked_lock:
                    self.report.errors += 1
            if my_filters and j % 4 == 0:
                # dirty a bank now and then: a bank with in-flight writes
                # pins HOT (the demoter's pending probe / dirty rule)
                name = my_filters[(j // 4) % len(my_filters)]
                keys = self._bloom_keys[name]
                lo = (j * 7) % (len(keys) - 50)
                try:
                    client.get_bloom_filter(name).add_all(keys[lo:lo + 50])
                    with self._acked_lock:
                        self.report.writes_acked += 1
                except Exception:  # noqa: BLE001
                    with self._acked_lock:
                        self.report.errors += 1
            j += 1
            time.sleep(0.002)

    def _reader(self, stop: threading.Event) -> None:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed * 131 + 1)
        p = 1.0 / np.power(np.arange(1, cfg.keys + 1), 1.0)
        p /= p.sum()
        while not stop.is_set():
            k = self._key(int(rng.choice(cfg.keys, p=p)))
            try:
                v = self._reader_buckets[k].get()
            except Exception:  # noqa: BLE001 — budgeted fault-window error
                with self._acked_lock:
                    self.report.errors += 1
                continue
            v = 0 if v is None else int(v)
            last = self._reader_last.get(k, 0)
            if v < last:
                self._violations.append(f"{k}: read {v} after {last}")
                with self._acked_lock:
                    self.report.stale_reads += 1
            self._reader_last[k] = max(last, v)
            with self._acked_lock:
                self.report.reads += 1
            time.sleep(0.001)

    def _tenant_reader(self, stop: threading.Event) -> None:
        """Zipf(1.1) membership probes over the tenant banks — the reads
        that fault demoted banks back in mid-storm."""
        cfg = self.config
        rng = np.random.default_rng(cfg.seed * 977 + 3)
        names = sorted(self._bloom_keys)
        p = 1.0 / np.power(np.arange(1, len(names) + 1), 1.1)
        p /= p.sum()
        order = rng.permutation(len(names))
        while not stop.is_set():
            name = names[int(order[rng.choice(len(names), p=p)])]
            keys = self._bloom_keys[name]
            lo = int(rng.integers(0, len(keys) - 32))
            try:
                found = self._writer_client.get_bloom_filter(
                    name
                ).contains_each(keys[lo:lo + 32])
                assert np.asarray(found).all(), (
                    f"false negative on {name} mid-storm"
                )
                with self._acked_lock:
                    self.report.tenant_probes += 1
            except AssertionError:
                raise
            except Exception:  # noqa: BLE001 — budgeted fault-window error
                with self._acked_lock:
                    self.report.errors += 1
            time.sleep(0.002)

    def _rebalance(self, n_active: int) -> None:
        from redisson_tpu_torch.server import migration as mig

        engine = self._server.server.engine
        targets = engine.placement.spread_plan(n_active)
        moved = mig.rebalance_devices(
            engine, targets, journal_dir=self._journal_dir
        )
        self.report.rebalances += 1
        self.report.records_moved += moved

    def _tier_rows(self) -> Dict[str, float]:
        mgr = self._server.server.engine.residency
        return {
            k: v for k, v in mgr.census().items()
            if k.startswith("residency_bytes_dev")
        }

    # -- run -----------------------------------------------------------------

    def run(self) -> ResidencySoakReport:
        from redisson_tpu_torch.net.client import install_fault_plane
        from redisson_tpu_torch.server import migration as mig
        from redisson_tpu_torch.utils.crc16 import MAX_SLOT

        cfg = self.config
        self._setup()
        try:
            engine = self._server.server.engine
            mgr = engine.residency
            for cycle in range(cfg.cycles):
                sched = FaultSchedule(cfg.seed * 7919 + cycle)
                n = max(1, cfg.faults_per_cycle)
                sched.add_random("delay", n=n, window=300, delay_s=0.01)
                sched.add_random("drop", n=max(1, n // 2), window=300)
                plane = FaultPlane(sched)
                stop = threading.Event()
                threads = [
                    threading.Thread(
                        target=self._writer, args=(w, stop), daemon=True
                    )
                    for w in range(cfg.writer_threads)
                ] + [
                    threading.Thread(
                        target=self._reader, args=(stop,), daemon=True
                    ),
                    threading.Thread(
                        target=self._tenant_reader, args=(stop,), daemon=True
                    ),
                ]
                install_fault_plane(plane)
                for t in threads:
                    t.start()
                try:
                    time.sleep(cfg.phase_seconds)
                    self._rebalance(4)      # 8 -> 4 while banks are tiered
                    time.sleep(cfg.phase_seconds)
                    self._rebalance(engine.placement.n_devices)  # 4 -> 8
                    time.sleep(cfg.phase_seconds)
                finally:
                    stop.set()
                    for t in threads:
                        t.join(timeout=30)
                    install_fault_plane(None)
                self.report.cycles_completed += 1
            # quiesce, then the invariants
            time.sleep(cfg.quiesce_s)
            self._rebalancer.stop()
            self.report.rebalancer_sweeps = self._rebalancer.sweeps_issued
            self.report.rebalancer_sheds = self._rebalancer.sheds_issued
            leftover = mig.resume_device_rebalances(engine, self._journal_dir)
            assert leftover == [], f"rebalances left in flight: {leftover}"
            counts = engine.placement.slot_counts()
            assert sum(counts) == MAX_SLOT, counts
            # zero acked-write loss through demotion + rebalance + shed
            with self._acked_lock:
                acked = dict(self._acked)
            for k, v in acked.items():
                got = self._writer_client.get_bucket(k).get()
                got = 0 if got is None else int(got)
                assert got >= v, f"acked-write loss: {k} read {got} < acked {v}"
            assert self.report.stale_reads == 0, (
                "stale tracked reads across tier cycling: "
                + "; ".join(self._violations[:5])
            )
            # post-storm recall: force-demote EVERY bank COLD (spill), then
            # probe every acked member back through fault-in
            hits = total = 0
            for name, keys in self._bloom_keys.items():
                mgr.demote(name, force=True)
                mgr.demote(name, cold=True, force=True)
                found = np.asarray(
                    self._writer_client.get_bloom_filter(
                        name
                    ).contains_each(keys)
                )
                hits += int(found.sum())
                total += len(keys)
            self.report.post_storm_recall = hits / max(1, total)
            assert self.report.post_storm_recall >= 0.99, (
                f"post-storm recall {self.report.post_storm_recall}"
            )
            self.report.promotions = mgr.promotions
            self.report.demotions_warm = mgr.demotions_warm
            self.report.demotions_cold = mgr.demotions_cold
            assert mgr.demotions_warm > 0, "storm never demoted a record"
            assert mgr.promotions > 0, "storm never faulted a record back in"
            # per-tier census flat at quiesce (sweeper still running): the
            # system must reach a steady tier assignment, not oscillate.
            # Age past min_idle first so THIS sweep (not a later sweeper
            # tick) is the one that settles the over-budget recall probes.
            time.sleep(max(0.1, 2 * mgr.min_idle_s))
            mgr.sweep()
            rows_a = self._tier_rows()
            self.report.tier_census.append(dict(rows_a))
            time.sleep(0.5)
            rows_b = self._tier_rows()
            self.report.tier_census.append(dict(rows_b))
            assert rows_a == rows_b, (
                f"tier census not flat at quiesce: {rows_a} != {rows_b}"
            )
            # drain-to-absence: DEL a COLD bank -> its rows AND its spill
            # file vanish after the next sweep's GC
            victim = sorted(self._bloom_keys)[0]
            mgr.demote(victim, force=True)
            mgr.demote(victim, cold=True, force=True)
            rec = engine.store.get_unguarded(victim)
            spill = rec.cold_path
            assert spill is not None and os.path.exists(spill)
            self._writer_client.get_bucket(victim).delete()
            mgr.sweep()
            assert not os.path.exists(spill), "spill file outlived DEL"
            budget_errors = max(
                10, (self.report.writes_acked + self.report.reads) // 2
            )
            assert self.report.errors <= budget_errors, (
                f"error budget blown: {self.report.errors} vs {budget_errors}"
            )
            assert self.report.writes_acked > 0 and self.report.reads > 0
            assert self.report.tenant_probes > 0
            return self.report
        finally:
            self._teardown()
