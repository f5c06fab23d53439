"""Deadline-aware window scheduler + per-tenant QoS.

The overlap plane (core/ioplane) hides a frame's readback *across*
frames, but a single interactive tenant's p99 still waits behind bulk
windows, and one abusive bulk tenant can flood the worker pool and the
per-connection completion queues, starving everyone.  Inference serving
solved exactly this shape with continuous batching and admission control
(Orca's iteration-level scheduling, vLLM's admission/preemption discipline);
this module transfers that playbook onto the device-window pipeline:

  * **Deadline classes** — every parsed frame is classified ``interactive``
    or ``bulk`` before anything dispatches: explicitly via the
    ``CLIENT QOS CLASS <c> [TENANT <t>]`` connection verb, or by heuristic
    (small frames — few estimated device items — are interactive; big blob
    pipelines are bulk).
  * **Admission by class, not arrival** — interactive frames are admitted
    into the next device window first: they dispatch on a reserved slice of
    worker capacity, bulk frames fill the remaining capacity behind a
    bounded concurrency gate (``qos-bulk-slots``), so a bulk flood can
    never occupy every dispatch slot.
  * **Per-tenant token buckets feeding the coalescer** — each tenant (the
    ``{hashtag}`` of the frame's keys, or the connection-declared tenant)
    owns a token bucket over estimated device items.  A frame whose tenant
    is over budget is LOAD-SHED with a RESP ``-BUSY`` error *before
    dispatch* — no queue residency, no partial kernel work — and a
    partially-covered frame sheds only its over-budget tail (coalesced runs
    never form across the shed boundary, core/coalesce.py).  Budgets are
    off by default; ``WindowScheduler.set_tenant_rate`` arms one.

Disarm with ``RTPU_NO_QOS=1`` / ``set_qos(False)`` / ``python -m
redisson_tpu_torch.server --no-qos``: the disarmed plane reproduces the historical arrival-order
dispatch exactly and results are bit-identical (the scheduler reorders
ADMISSION and capacity, never device work inside a connection; shedding is
opt-in via ``qos-tenant-rate`` and defaults off).

Contracts preserved (held to the reference by tests/test_torch_qos.py):
  * per-connection reply FIFO — shed replies are encoded in frame position,
    admitted commands dispatch in frame order, the writer-task completion
    queue is untouched;
  * at-most-once for possibly-applied add runs — a shed command NEVER
    reaches dispatch, and a run never spans a shed boundary, so no
    partially-applied coalesced add run is ever re-dispatched;
  * bit-identical results with the scheduler disarmed.

Observability: with the tracing plane armed (``observe/trace.py``), every
frame's classification + tenant charge + bulk-gate wait is recorded as its
``qos`` stage span (annotated tenant/class/items/shed by
``server._serve_frame``), and the ``stage.qos`` histogram feeds the
server's metrics registry.

A copy of ``redisson_tpu/server/scheduler.py`` without the knobs only other
slices reach: the ``CONFIG SET qos-*`` surface (admin verbs, ROADMAP M11),
tenant weights (``CLUSTER QOS REBALANCE``, M8), and the flush-window
deadline and bulk sub-windows of ``FlushPipeline`` and the lanes (M8).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from redisson_tpu_torch.core.ioplane import QosLedger

# -- global switch (same discipline as ioplane.set_overlap) -------------------

_qos = os.environ.get("RTPU_NO_QOS", "") not in ("1", "true", "yes")


def qos_enabled() -> bool:
    return _qos


def set_qos(on: bool) -> bool:
    """Flip the process-global QoS switch; returns the previous value
    (callers restore it — the A/B discipline of bench.py config 2q)."""
    global _qos
    prev = _qos
    _qos = bool(on)
    return prev


# -- device-item estimation ----------------------------------------------------

# blob verbs: (items per 8 payload bytes at blob arg index) — the occupancy
# unit the per-device lanes account and the unit tenant budgets are charged in
_BLOB8 = {b"BF.MADD64": 2, b"BF.MEXISTS64": 2, b"PFADD64": 2}
_BLOB8_AT3 = {b"BFA.MADD64": 3, b"BFA.MEXISTS64": 3, b"HLLA.MADD64": 3}
_BLOB4 = {b"SETBITSB": 2, b"GETBITSB": 2}
# KNN verbs: charged by their PARAMS vector payload — every 8
# payload bytes counts one device item, the same unit as the sketch blob
# verbs, so tenant budgets and lane ledgers see a stacked multi-query KNN
# frame as proportionally heavier than a single probe
_FT_KNN = frozenset((b"FT.SEARCH", b"FT.MSEARCH"))


def estimate_device_items(cmds: Sequence) -> int:
    """Rough op count a command list dispatches to one device — the
    occupancy unit lanes account, the CPU-replica occupancy model charges,
    and tenant token buckets spend.  Blob verbs count their batch elements;
    everything else counts 1.  (Moved here from server.py so the scheduler,
    the lane gate, and the bench all share ONE sizing rule.)"""
    total = 0
    for cmd in cmds:
        total += estimate_command_items(cmd)
    return total


def estimate_command_items(cmd) -> int:
    try:
        verb = bytes(cmd[0]).upper()
        if verb in _BLOB8:
            return max(1, len(cmd[2]) // 8)
        if verb in _BLOB8_AT3:
            return max(1, len(cmd[3]) // 8)
        if verb in _BLOB4:
            return max(1, len(cmd[2]) // 4)
        if verb in _FT_KNN:
            # the query-vector blob(s) ride PARAMS values: charge every
            # bulk byte argument (small option tokens stay under the bar)
            return max(1, sum(
                len(a) for a in cmd[2:]
                if isinstance(a, (bytes, bytearray)) and len(a) >= 64
            ) // 8)
        return 1
    except (IndexError, TypeError):
        return 1


# -- token bucket --------------------------------------------------------------


class TokenBucket:
    """Per-tenant budget over estimated device items.  ``rate <= 0`` means
    UNLIMITED (the default: shedding is opt-in, so an unconfigured server is
    bit-identical to the pre-QoS wire).  Not thread-safe on its own — the
    scheduler serializes access under its lock."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self.tokens = self.burst
        self.stamp: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self.stamp is None:
            self.stamp = now
        self.tokens = min(self.burst, self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now

    def take(self, n: float, now: float) -> bool:
        """Spend `n` items if covered; an uncovered take spends NOTHING (the
        shed path must not double-punish the tenant's next frame)."""
        if self.rate <= 0:
            return True
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def level(self, now: float) -> float:
        """Current token level (refilled to `now`); unlimited buckets report
        their burst so gauges stay finite."""
        if self.rate <= 0:
            return self.burst
        self._refill(now)
        return self.tokens


class TenantState:
    __slots__ = ("bucket", "admitted_ops", "shed_ops", "shed_frames")

    def __init__(self, bucket: TokenBucket):
        self.bucket = bucket
        self.admitted_ops = 0
        self.shed_ops = 0
        self.shed_frames = 0


# -- admission -----------------------------------------------------------------


class Admission:
    """One frame's admission decision: its deadline class, tenant, estimated
    device items/bytes, and — when the tenant's bucket could not cover the
    whole frame — the per-command shed mask (True = shed, reply -BUSY, never
    dispatch)."""

    __slots__ = ("qos_class", "tenant", "items", "nbytes",
                 "shed_mask", "shed_count")

    def __init__(self, qos_class: str, tenant: str, items: int, nbytes: int,
                 shed_mask: Optional[List[bool]] = None, shed_count: int = 0):
        self.qos_class = qos_class
        self.tenant = tenant
        self.items = items
        self.nbytes = nbytes
        self.shed_mask = shed_mask
        self.shed_count = shed_count

    @property
    def interactive(self) -> bool:
        return self.qos_class == "interactive"


INTERACTIVE = "interactive"
BULK = "bulk"
CLASSES = (INTERACTIVE, BULK)


def _frame_nbytes(commands: Sequence) -> int:
    total = 0
    for cmd in commands:
        try:
            for a in cmd:
                if isinstance(a, (bytes, bytearray)):
                    total += len(a)
        except TypeError:
            continue
    return total


def tenant_of_frame(ctx, commands: Sequence) -> str:
    """Tenant of a frame: the connection-declared tenant (CLIENT QOS ...
    TENANT <t>) wins; otherwise the {hashtag} of the frame's first keyed
    command (the stacked-bank kernels are already tenant-segmented the same
    way — one slot column per filter); otherwise "default"."""
    t = getattr(ctx, "tenant", None)
    if t:
        return t
    for cmd in commands:
        try:
            key = cmd[1]
        except (IndexError, TypeError):
            continue
        if not isinstance(key, (bytes, bytearray)):
            continue
        b = bytes(key)
        i = b.find(b"{")
        if i >= 0:
            j = b.find(b"}", i + 1)
            if j > i + 1:
                return b[i + 1 : j].decode(errors="replace")
        return "default"  # first keyed command decides; no tag = default
    return "default"


class WindowScheduler:
    """The server's QoS policy object: classification, per-tenant budgets,
    admission (shed masks), and the in-flight ledger every layer's gauges
    read.  One per TpuServer; `armed` consults the process-global switch
    LIVE so ``set_qos(False)`` / ``RTPU_NO_QOS=1`` disarms running servers
    exactly like ``ioplane.set_overlap``."""

    def __init__(self, enabled: Optional[bool] = None, *,
                 tenant_rate: float = 0.0,
                 tenant_burst: Optional[float] = None,
                 interactive_max_items: int = 256,
                 bulk_slots: int = 0):
        self.enabled = qos_enabled() if enabled is None else bool(enabled)
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = tenant_burst  # None = follow rate
        self.interactive_max_items = int(interactive_max_items)
        # bulk admission slots: how many bulk-class frames may be in dispatch
        # at once across ALL connections (0 = derive from the server's worker
        # count at wiring time: workers - 1, so one dispatch slot is always
        # reserved for interactive traffic)
        self.bulk_slots = int(bulk_slots)
        # penalty for a FULLY-refused frame: the offending connection's read
        # loop parks this long after its -BUSY replies flush, so a client
        # that spins on BUSY instead of backing off cannot convert the cheap
        # shed path into a parse-plane DoS.  Only the shed connection pays;
        # admitted work is never delayed (this is not queue residency — the
        # frame was already answered).
        self.shed_penalty_ms = 5.0
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantState] = {}
        self.ledger = QosLedger()
        self.shed_ops = 0
        self.shed_frames = 0

    # -- arming ---------------------------------------------------------------

    @property
    def armed(self) -> bool:
        return self.enabled and _qos

    def set_tenant_rate(self, tenant: str, rate: float,
                        burst: Optional[float] = None) -> None:
        """Per-tenant budget (the ``CLUSTER QOS REBALANCE`` actuator's
        handle in the reference; the uniform ``tenant_rate`` covers the
        common case).  An EXISTING bucket is retargeted in
        place — tokens are preserved (capped at the new burst), never
        re-minted: the fleet rebalance loop pushes every sweep, and a
        re-mint would hand the tenant a fresh burst per push, inflating
        its effective budget by burst/interval."""
        with self._lock:
            ts = self._tenants.get(tenant)
            if ts is None:
                self._tenants[tenant] = TenantState(TokenBucket(rate, burst))
                return
            b = ts.bucket
            b.rate = float(rate)
            b.burst = float(burst if burst is not None else max(rate, 1.0))
            if b.tokens > b.burst:
                b.tokens = b.burst

    # -- classification -------------------------------------------------------

    def classify(self, ctx, commands: Sequence) -> Tuple[str, List[int], int]:
        """(qos_class, per-command items, total items).  The connection's
        declared class wins; the heuristic default is: small frames (total
        estimated device items <= ``interactive_max_items``) are
        interactive, everything else is bulk."""
        per = [estimate_command_items(c) for c in commands]
        total = sum(per)
        declared = getattr(ctx, "qos_class", None)
        if declared in CLASSES:
            return declared, per, total
        cls = INTERACTIVE if total <= self.interactive_max_items else BULK
        return cls, per, total

    # -- admission ------------------------------------------------------------

    def admit(self, ctx, commands: Sequence,
              now: Optional[float] = None) -> Admission:
        """Admit one parsed frame: classify, charge the tenant's bucket
        command by command IN FRAME ORDER, and shed the uncovered tail.
        Shedding is greedy-prefix per command (not all-or-nothing): the
        admitted prefix keeps its frame order, the shed suffix replies
        -BUSY without ever dispatching — so a coalesced add run can never
        be partially applied by admission (runs are additionally split at
        shed boundaries, core/coalesce.runs_within_admission)."""
        if now is None:
            now = time.monotonic()
        cls, per, total = self.classify(ctx, commands)
        tenant = tenant_of_frame(ctx, commands)
        nbytes = _frame_nbytes(commands)
        shed_mask: Optional[List[bool]] = None
        shed = 0
        with self._lock:
            ts = self._tenants.get(tenant)
            if ts is None:
                ts = self._tenants[tenant] = TenantState(
                    TokenBucket(self.tenant_rate, self.tenant_burst)
                )
            if ts.bucket.rate > 0:
                for i, n in enumerate(per):
                    if shed_mask is None and ts.bucket.take(n, now):
                        continue
                    # once a command sheds, the REST of the frame sheds too:
                    # admitting commands past a shed hole would reorder the
                    # tenant's effective stream relative to its replies
                    if shed_mask is None:
                        shed_mask = [False] * len(per)
                    shed_mask[i] = True
                    shed += 1
            admitted_items = total - sum(
                n for n, s in zip(per, shed_mask or []) if s
            )
            ts.admitted_ops += admitted_items
            if shed:
                ts.shed_ops += total - admitted_items
                ts.shed_frames += 1
                self.shed_ops += total - admitted_items
                self.shed_frames += 1
        return Admission(cls, tenant, admitted_items, nbytes,
                         shed_mask, shed)

    # -- in-flight accounting -------------------------------------------------

    def begin(self, adm: Admission) -> None:
        self.ledger.enter(adm.qos_class, adm.items, adm.nbytes)

    def end(self, adm: Admission) -> None:
        self.ledger.exit(adm.qos_class, adm.items, adm.nbytes)

    # -- observability --------------------------------------------------------

    def tenant_table(
        self, now: Optional[float] = None,
    ) -> List[Tuple[str, float, int, int, int]]:
        """[(tenant, bucket_level, admitted_ops, shed_ops, shed_frames)] —
        what CLIENT QOS GET reads."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            return [
                (name, ts.bucket.level(now), ts.admitted_ops,
                 ts.shed_ops, ts.shed_frames)
                for name, ts in sorted(self._tenants.items())
            ]


def busy_error(tenant: str) -> str:
    """The load-shed reply: -BUSY, never queue residency (the vLLM
    admission-refusal discipline on a RESP wire).  Clients back off and
    retry; the error names the tenant so multi-tenant proxies can bill."""
    return (
        f"BUSY QoS budget exhausted for tenant '{tenant}'; "
        "retry after backoff"
    )
