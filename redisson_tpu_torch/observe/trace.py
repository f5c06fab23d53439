"""Per-frame stage-span tracing: the attribution plane.

The serving path crosses five planes — parser, QoS scheduler, coalescer,
device lane (stage/dispatch/readback), reply writer — and until now the only
visibility was disjoint aggregates (IOStats sync counts, QosLedger in-flight,
MetricsRegistry command timers): a p99 regression could be *measured* but
never *attributed* to a stage.  This module is the Dapper-style answer
(PAPERS.md): every parsed frame is stamped with a trace id + monotonic t0,
and each chokepoint it crosses appends a **stage span**:

  ``parse``     — RESP bytes -> command list (read loop);
  ``qos``       — WindowScheduler classify/charge + bulk-gate wait
                  (tenant/class/items/shed annotated);
  ``dispatch``  — handler execution window for the whole frame;
  ``stage``     — device-lane gate wait (queueing ahead of the chip);
  ``kernel``    — ONE span per coalesced same-verb run, its member commands
                  recorded as ``kernel.member`` child spans;
  ``readback``  — D2H force, annotated whether the frame PAID the blocking
                  sync (``blocking``) or rode a grouped fetch (``grouped``);
  ``reply``     — dispatch-done -> bytes written: the tail that makes the
                  trace total the true client-observable latency.

Finished traces land in a **bounded, lock-light ring** (deque append is a
single GIL-atomic op), queryable over the wire (``TRACE GET/RESET/CONFIG``,
slowest-N by total or by stage), backing ``SLOWLOG`` (entries carry the
per-stage breakdown instead of Redis's flat duration) and ``LATENCY
HISTORY``; per-stage duration timers feed the server's MetricsRegistry so
``prometheus_text`` exports stage histograms.

Arming follows the chaos-hook discipline (net/client.py ``_fault_plane``):

  * DISARMED (the default) every instrumentation site costs one module-
    global load plus an ``is None``/``is not None`` branch — no attribute
    chase, no call, no allocation (tests/test_observe.py asserts this at
    the allocator level against the discovered guard lines);
  * ARMED (``RTPU_TRACE=1`` / ``set_tracing(True)`` / ``CONFIG SET
    trace-enabled yes``) replies are bit-identical to disarmed — the
    tracer only *observes* waits and work, it never reorders either.

One tracer per process (``TRACER``), same singleton discipline as
``ioplane.STATS``: production runs one server per process, so the ring IS
the per-server ring; in-process multi-server tests share it knowingly.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# span propagation across worker threads: the read loop stamps the frame,
# dispatch runs on pool threads, ioplane sites (lane gates, readbacks) are
# reached deep inside them — a thread-local carries the active FrameTrace
# so no kernel-adjacent signature needs to thread a trace argument through.
_tls = threading.local()


class Span:
    """One stage interval inside a frame: offsets are µs from the frame's
    t0, attrs is a small flat dict (tenant, device, blocking, ...)."""

    __slots__ = ("name", "off_us", "dur_us", "attrs")

    def __init__(self, name: str, off_us: int, dur_us: int,
                 attrs: Optional[dict] = None):
        self.name = name
        self.off_us = off_us
        self.dur_us = dur_us
        self.attrs = attrs


class FrameTrace:
    """One frame's trace: id, wall timestamp, monotonic t0, and the span
    list every chokepoint appends to.  Spans may be appended from several
    worker threads (device-sharded buckets); ``list.append`` is GIL-atomic,
    so the trace carries no lock — the lock-light half of the contract."""

    __slots__ = ("trace_id", "ts", "t0", "verbs", "n_cmds", "client_id",
                 "qos_class", "tenant", "spans", "dispatched_at", "total_us",
                 "finished", "base_attrs")

    def __init__(self, trace_id: int, ts: float, t0: float, verbs: str,
                 n_cmds: int, client_id: int):
        self.trace_id = trace_id
        self.ts = ts          # wall-clock epoch seconds (SLOWLOG parity)
        self.t0 = t0          # monotonic anchor every span offsets from
        self.verbs = verbs
        self.n_cmds = n_cmds
        self.client_id = client_id
        self.qos_class: Optional[str] = None
        self.tenant: Optional[str] = None
        self.spans: List[Span] = []
        self.dispatched_at: Optional[float] = None
        self.total_us = 0
        self.finished = False
        # attrs merged into EVERY span of this frame (replica-served frames
        # stamp replica=1 here, so per-stage breakdowns split by role)
        self.base_attrs: Optional[dict] = None

    def add_span(self, name: str, start: float, end: float,
                 **attrs) -> None:
        """Record one stage interval ([start, end] monotonic seconds)."""
        if self.base_attrs:
            attrs = {**self.base_attrs, **attrs}
        self.spans.append(Span(
            name,
            int((start - self.t0) * 1e6),
            max(0, int((end - start) * 1e6)),
            attrs or None,
        ))

    def mark_dispatched(self) -> None:
        """Dispatch finished; the remaining time to the reply write is the
        ``reply`` span (recorded by the writer task via finish_reply)."""
        self.dispatched_at = time.monotonic()

    def stage_totals(self) -> Dict[str, int]:
        """{stage: summed µs} — the SLOWLOG breakdown projection (member
        child spans excluded: they duplicate their kernel span's time)."""
        out: Dict[str, int] = {}
        for s in self.spans:
            if s.name.endswith(".member"):
                continue
            out[s.name] = out.get(s.name, 0) + s.dur_us
        return out

    def stage_us(self, stage: str) -> int:
        return sum(s.dur_us for s in self.spans if s.name == stage)


class Tracer:
    """The process tracer: frame factory, bounded ring, SLOWLOG view,
    LATENCY samples, and the MetricsRegistry feed."""

    # LATENCY HISTORY depth (Redis keeps 160 samples per event)
    LATENCY_SAMPLES = 160

    def __init__(self, ring_capacity: int = 512,
                 slowlog_max_len: int = 128,
                 slowlog_slower_than_us: int = 10_000):
        self._ids = itertools.count(1)
        self._slowlog_ids = itertools.count(1)
        self._ring: deque = deque(maxlen=max(1, ring_capacity))
        self._slowlog: deque = deque(maxlen=max(1, slowlog_max_len))
        self.slowlog_slower_than_us = slowlog_slower_than_us
        self._lock = threading.Lock()   # inflight counter + reconfig only
        self._inflight = 0
        # per-stage (ts, ms) samples for LATENCY HISTORY
        self._latency: Dict[str, deque] = {}
        # MetricsRegistry receiving stage.<name> timers (server wires its
        # default registry here; None = no histogram feed)
        self.registry = None

    # -- frame lifecycle ------------------------------------------------------

    def begin_frame(self, ctx, commands, t0: Optional[float] = None
                    ) -> FrameTrace:
        now = time.monotonic()
        try:
            verb = bytes(commands[0][0]).upper().decode()
        except Exception:  # noqa: BLE001 — malformed frame still traces
            verb = "?"
        tr = FrameTrace(
            next(self._ids), time.time(), t0 if t0 is not None else now,
            verb, len(commands), getattr(ctx, "client_id", 0),
        )
        if t0 is not None:
            tr.add_span("parse", t0, now)
        with self._lock:
            self._inflight += 1
        return tr

    def finish(self, trace: FrameTrace, end: Optional[float] = None) -> None:
        with self._lock:  # idempotent: abandon may race the writer's finish
            if trace.finished:
                return
            trace.finished = True
            self._inflight -= 1
        trace.total_us = max(
            0, int(((end if end is not None else time.monotonic())
                    - trace.t0) * 1e6)
        )
        self._ring.append(trace)
        thr = self.slowlog_slower_than_us
        if thr >= 0 and trace.total_us >= thr:
            self._slowlog.append((
                next(self._slowlog_ids), int(trace.ts), trace.total_us,
                trace, trace.stage_totals(),
            ))
        reg = self.registry
        if reg is not None:
            reg.timer("stage.total").record(trace.total_us / 1e6)
            for stage, us in trace.stage_totals().items():
                reg.timer(f"stage.{stage}").record(us / 1e6)
        self._note_latency("total", trace.ts, trace.total_us / 1e3)
        for stage, us in trace.stage_totals().items():
            self._note_latency(stage, trace.ts, us / 1e3)

    def finish_reply(self, trace: FrameTrace) -> None:
        """Writer-task completion: close the ``reply`` span (dispatch-done
        -> bytes written) and finish the trace at the write timestamp —
        total therefore equals the client-observable latency."""
        now = time.monotonic()
        start = trace.dispatched_at if trace.dispatched_at is not None else now
        trace.add_span("reply", start, now)
        self.finish(trace, end=now)

    def abandon(self, trace: FrameTrace) -> None:
        """A frame whose replies never reached the wire (connection died
        mid-flight): close the books so the inflight census row drains."""
        self.finish(trace)

    def _note_latency(self, event: str, ts: float, ms: float) -> None:
        dq = self._latency.get(event)
        if dq is None:
            dq = self._latency.setdefault(
                event, deque(maxlen=self.LATENCY_SAMPLES)
            )
        dq.append((int(ts), ms))

    # -- queries --------------------------------------------------------------

    def entries(self) -> List[FrameTrace]:
        return list(self._ring)

    def slowest(self, n: int = 10, by: str = "total") -> List[FrameTrace]:
        """Slowest-N finished traces by total duration, or by one stage's
        summed duration (``by="qos"``, ``"readback"``, ...)."""
        traces = list(self._ring)
        if by in ("", "total"):
            key = lambda t: t.total_us  # noqa: E731
        else:
            key = lambda t: t.stage_us(by)  # noqa: E731
        traces.sort(key=key, reverse=True)
        return traces[: max(0, n)]

    def reset(self) -> None:
        self._ring.clear()

    def set_ring_capacity(self, n: int) -> None:
        n = max(1, int(n))
        with self._lock:
            self._ring = deque(self._ring, maxlen=n)

    @property
    def ring_capacity(self) -> int:
        return self._ring.maxlen or 0

    # -- SLOWLOG view ---------------------------------------------------------

    def slowlog_get(self, n: Optional[int] = None) -> List[tuple]:
        """Newest-first (Redis order): [(id, ts, dur_us, trace,
        {stage: us}), ...]."""
        items = list(self._slowlog)
        items.reverse()
        return items if n is None else items[: max(0, n)]

    def slowlog_len(self) -> int:
        return len(self._slowlog)

    def slowlog_reset(self) -> None:
        self._slowlog.clear()

    def set_slowlog_max_len(self, n: int) -> None:
        with self._lock:
            self._slowlog = deque(self._slowlog, maxlen=max(1, int(n)))

    @property
    def slowlog_max_len(self) -> int:
        return self._slowlog.maxlen or 0

    # -- LATENCY view ---------------------------------------------------------

    def latency_events(self) -> List[str]:
        return sorted(self._latency)

    def latency_history(self, event: str) -> List[Tuple[int, float]]:
        dq = self._latency.get(event)
        return list(dq) if dq is not None else []

    def latency_reset(self, events=()) -> int:
        names = list(events) if events else list(self._latency)
        n = 0
        for ev in names:
            if self._latency.pop(ev, None) is not None:
                n += 1
        return n

    # -- summaries ------------------------------------------------------------

    def stage_summary(self) -> Dict[str, Dict[str, float]]:
        """{stage: {count, total_ms, p50_ms, p99_ms}} over the current ring
        — bench's ``details.stage_breakdown`` source."""
        import numpy as np

        per: Dict[str, List[int]] = {}
        for tr in list(self._ring):
            for stage, us in tr.stage_totals().items():
                per.setdefault(stage, []).append(us)
            per.setdefault("total", []).append(tr.total_us)
        out: Dict[str, Dict[str, float]] = {}
        for stage, vals in per.items():
            a = np.asarray(vals, np.float64) / 1e3
            out[stage] = {
                "count": len(vals),
                "total_ms": round(float(a.sum()), 3),
                "p50_ms": round(float(np.percentile(a, 50)), 3),
                "p99_ms": round(float(np.percentile(a, 99)), 3),
            }
        return out

    def census(self) -> Dict[str, float]:
        """Census rows: ring occupancy is BOUNDED by capacity; inflight
        must drain to 0 at quiesce (a begun frame whose reply never
        finished the books is a trace leak)."""
        return {
            "trace_ring_entries": float(len(self._ring)),
            "trace_inflight": float(self._inflight),
        }


# -- process-global arming (the chaos-hook discipline) -------------------------

TRACER = Tracer()

# THE guard every instrumentation site loads: None = disarmed (zero-cost),
# TRACER = armed.  Same shape as net/client.py `_fault_plane`.
_tracer: Optional[Tracer] = (
    TRACER if os.environ.get("RTPU_TRACE", "") in ("1", "true", "yes")
    else None
)


def tracing_enabled() -> bool:
    return _tracer is not None


def set_tracing(on: bool) -> bool:
    """Arm/disarm the process tracer; returns the previous armed state
    (callers restore it — the A/B discipline of RTPU_NO_QOS)."""
    global _tracer
    prev = _tracer is not None
    _tracer = TRACER if on else None
    return prev


def current_trace() -> Optional[FrameTrace]:
    """The FrameTrace active on THIS thread (set by the dispatch wrappers),
    or None.  Only called from armed paths — disarmed sites branch on
    ``_tracer`` before reaching here."""
    return getattr(_tls, "trace", None)


def set_current(trace: FrameTrace) -> None:
    _tls.trace = trace


def clear_current() -> None:
    _tls.trace = None
