"""ResourceCensus: one authority for "did anything leak?".

A copy of ``redisson_tpu/chaos/census.py``.  ``kernel_cache_entries`` and
``kernel_cache_stale`` read the port's ``parallel/manager.MeshManager``
kernel cache, keyed by epoch as the reference's is.

Leak assertions across chaos/soak runs used to be ad-hoc introspection
(each test reaching into private dicts); the census centralizes them:
track a source once, then ``snapshot()`` → flat ``{metric: value}`` dict,
``diff()``/``assert_flat()`` for before/after comparisons, and
``register()`` to expose every metric as a live gauge on a
``utils/metrics.py`` ``MetricsRegistry`` (Prometheus text exposition
included for free).

Metrics per source kind:

  engine  — ``record_locks`` (``Engine._record_locks`` registry entries:
            must drain to 0 at quiesce — entries exist only while held or
            waited on), ``wait_entries``, ``keys``, and — when a
            ``MeshManager`` exists — ``kernel_cache_entries`` /
            ``kernel_cache_stale`` (entries keyed to a PAST epoch: must
            always be 0, reshard drops them).
  server  — ``repl_staged_xfers`` (REPLPUSHSEG staging buffers),
            ``connections``, and — when replication is live —
            ``repl_baselines`` (host-side delta baselines; bounded by live
            record count) and ``repl_replicas``.
  client  — ``conn_in_use`` / ``conn_idle`` / ``node_clients`` summed over
            every ``NodeClient`` pool of the facade (RemoteRedisson's one
            node or ClusterRedisson's shard entries).
"""
from __future__ import annotations

import fnmatch
import threading
from typing import Callable, Dict, Iterable, Optional, Tuple


class ResourceCensus:
    def __init__(self):
        self._lock = threading.Lock()
        self._sources: Dict[str, Callable[[], Dict[str, float]]] = {}

    # -- source registration -------------------------------------------------

    def track(self, name: str, probe: Callable[[], Dict[str, float]]) -> None:
        """Register/replace a named probe returning {metric: value}."""
        with self._lock:
            self._sources[name] = probe

    def untrack(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def track_engine(self, name: str, engine) -> None:
        # every metric is ALWAYS emitted (0 before its subsystem exists):
        # stable key sets keep diff()/assert_flat() comparable across
        # snapshots and let register() create every gauge up front
        def probe() -> Dict[str, float]:
            out = {
                "record_locks": len(engine._record_locks),
                "wait_entries": len(engine._wait_entries),
                "keys": len(engine.store),
                "kernel_cache_entries": 0,
                "kernel_cache_stale": 0,
            }
            # don't force-create the MeshManager just to count its cache
            mm = engine._services.get("mesh_manager")
            if mm is not None:
                with mm._guard:
                    out["kernel_cache_entries"] = len(mm._kernels)
                    out["kernel_cache_stale"] = sum(
                        1 for k in mm._kernels if k[0] != mm._epoch
                    )
            return out

        self.track(name, probe)

    def track_server(self, name: str, server) -> None:
        def probe() -> Dict[str, float]:
            out = {
                "repl_staged_xfers": len(getattr(server, "_repl_xfers", {})),
                "repl_snap_stages": len(getattr(server, "_snap_stages", {})),
                "connections": server.stats["connections"],
                "repl_baselines": 0,
                "repl_replicas": 0,
                "tracking_table_keys": 0,
                "tracking_conns": 0,
                "tracking_bcast_conns": 0,
            }
            src = server._replication
            if src is not None:
                out["repl_baselines"] = len(src._baseline)
                out["repl_replicas"] = len(src._replicas)
            # client-tracking table (tracking/table.py): sizes must drain to
            # 0 on connection death — a tracked key outliving its connection
            # is a leak, and the soak's disconnect-cleanup assertion
            tracking = getattr(server, "tracking", None)
            if tracking is not None:
                for k, v in tracking.census().items():
                    out[f"tracking_{k}" if not k.startswith("tracking") else k] = v
            # QoS window scheduler (server/scheduler.py): the
            # per-class in-flight rows must drain to 0 at quiesce (a frame
            # whose admission was never exited is a ledger leak); the shed
            # counters are cumulative — soaks that shed on purpose ignore
            # them via "*.qos_shed_*" patterns
            sched = getattr(server, "scheduler", None)
            if sched is not None:
                for k, v in sched.census().items():
                    out[k] = v
            # tracing plane: ring occupancy is BOUNDED by the
            # configured capacity; trace_inflight must drain to 0 at
            # quiesce (a begun frame whose reply never closed the books is
            # a trace leak).  Both 0 while tracing is disarmed.
            out["trace_ring_entries"] = 0.0
            out["trace_inflight"] = 0.0
            tracer = getattr(server, "tracer", None)
            if tracer is not None:
                for k, v in tracer.census().items():
                    out[k] = v
            # embedding-bank residency: bank count + device
            # bytes must return to baseline once FT.DROPINDEX tears an
            # index down — the vector soak's flat-census assertion
            out["ftvec_banks"] = 0.0
            out["ftvec_device_bytes"] = 0.0
            out["ftvec_index_bytes"] = 0.0
            ftvec = getattr(server, "_ftvec_census", None)
            if ftvec is not None:
                for k, v in ftvec().items():
                    out[k] = v
            # per-device residency over ALL record kinds:
            # record_bytes_dev<N>[_<kind>] rows exist only
            # while that device holds bytes — DEL/DROPINDEX drains them
            # to absence, which the soaks read as zero
            devbytes = getattr(server, "_device_bytes_census", None)
            if devbytes is not None:
                for k, v in devbytes().items():
                    out[k] = v
            # tiered-HBM residency: per-device per-tier byte
            # rows exist only while that tier holds bytes — DEL drains a
            # demoted record's warm/cold rows to absence exactly like the
            # hot rows above, so the residency soak's flat-census check
            # covers the spill files too
            residency = getattr(server, "_residency_census", None)
            if residency is not None:
                for k, v in residency().items():
                    out[k] = v
            return out

        self.track(name, probe)

    def track_checkpoints(self, name: str = "checkpoint") -> None:
        """Expose ``core/checkpoint.STATS`` (corrupt generations detected,
        generation fallbacks served) — storage chaos must leave a VISIBLE
        trail, not just a survived one."""

        def probe() -> Dict[str, float]:
            from redisson_tpu_torch.core import checkpoint

            return {k: float(v) for k, v in checkpoint.STATS.items()}

        self.track(name, probe)

    def track_client(self, name: str, client) -> None:
        def probe() -> Dict[str, float]:
            from redisson_tpu_torch.net import client as _net

            nodes = []
            node = getattr(client, "node", None)
            if node is not None:
                nodes.append(node)
            entries = getattr(client, "entries", None)
            if callable(entries):
                for e in entries():
                    nodes.append(e.master)
                    nodes.extend(e.replicas.values())
            out = {
                "conn_in_use": sum(n.pool.in_use for n in nodes),
                "conn_idle": sum(n.pool.idle_count() for n in nodes),
                "node_clients": len(nodes),
                # orphaned RESP3 pushes dropped (process-global): any growth
                # means a push reached a connection with no handler — a
                # mis-routed invalidation or pubsub frame
                "dropped_pushes": float(_net.dropped_push_count()),
                "near_cache_entries": 0,
            }
            plane = getattr(client, "tracking", None)
            if plane is not None:
                out["near_cache_entries"] = float(len(plane.cache))
            return out

        self.track(name, probe)

    # -- reading -------------------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{source.metric: value}`` over every tracked source.  A
        broken probe contributes nothing rather than killing the census
        (same discipline as MetricsRegistry.snapshot)."""
        with self._lock:
            sources = dict(self._sources)
        out: Dict[str, float] = {}
        for name, probe in sources.items():
            try:
                vals = probe()
            except Exception:  # noqa: BLE001 — a dead source must not kill scrape
                continue
            for k, v in vals.items():
                out[f"{name}.{k}"] = float(v)
        return out

    def register(self, registry, prefix: str = "census") -> None:
        """Expose every census metric as a live gauge on a MetricsRegistry.
        One scrape runs each source's probe ONCE: the source's gauges share
        a short-lived memo of the probe result, so M metrics never cost M
        probe executions (each of which takes engine/mesh locks).  Covers
        the sources tracked at call time; re-call after tracking new
        sources to pick them up."""
        with self._lock:
            sources = dict(self._sources)
        for name, probe in sources.items():
            try:
                metrics = list(probe().keys())
            except Exception:  # noqa: BLE001 — dead source registers nothing
                continue
            memo = {"at": 0.0, "vals": {}}

            def read(metric, probe=probe, memo=memo):
                import time

                now = time.monotonic()
                # 50ms memo: gauges of one source scraped together reuse a
                # single probe run; staleness is irrelevant at scrape cadence
                if now - memo["at"] > 0.05:
                    memo["vals"] = probe()
                    memo["at"] = now
                return float(memo["vals"].get(metric, 0.0))

            for metric in metrics:
                registry.gauge(
                    f"{prefix}.{name}.{metric}",
                    lambda metric=metric, read=read: read(metric),
                )

    # -- leak assertions -----------------------------------------------------

    @staticmethod
    def diff(
        before: Dict[str, float],
        after: Dict[str, float],
        ignore: Iterable[str] = (),
    ) -> Dict[str, Tuple[float, float]]:
        """Metrics present in both snapshots whose value moved, minus
        `ignore` (fnmatch patterns — e.g. ``"*.keys"`` for a workload that
        legitimately grows the keyspace)."""
        ignore = tuple(ignore)
        out = {}
        for k, b in before.items():
            if k not in after:
                continue
            if any(fnmatch.fnmatchcase(k, pat) for pat in ignore):
                continue
            a = after[k]
            if a != b:
                out[k] = (b, a)
        return out

    def assert_flat(
        self,
        before: Dict[str, float],
        after: Dict[str, float],
        ignore: Iterable[str] = (),
        context: str = "",
    ) -> None:
        moved = self.diff(before, after, ignore)
        if moved:
            detail = ", ".join(f"{k}: {b} -> {a}" for k, (b, a) in sorted(moved.items()))
            raise AssertionError(
                f"resource census not flat{' (' + context + ')' if context else ''}: {detail}"
            )
