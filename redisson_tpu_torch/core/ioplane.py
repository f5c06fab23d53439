"""Overlapped device I/O plane: pinned double-buffered H2D staging and
demand-driven D2H readback, the part of ``redisson_tpu/core/ioplane.py``
that the RBatch boundary drains through.

  * **Staging** (`StagingPool`): flush packing fills one of `depth` reusable
    pinned host buffers, copied to the card without blocking; a slot is
    handed out again only after the CUDA event recorded behind its copy has
    passed (a real wait is counted), so reuse never scribbles over bytes a
    copy is still reading.
  * **Readback futures** (`ReadbackFuture`): kernel outputs stay on the card
    behind an event recorded after their producing kernels; the copy to the
    host happens when a result is demanded (`result()`), and co-pending
    futures drain in ONE grouped transfer (`force_all` /
    `gather_device_results`): one device-side concatenation of the results
    viewed as bytes, one copy into pinned host memory, one event wait.

Disable with ``set_overlap(False)`` or ``RTPU_NO_OVERLAP=1`` for A/B
measurement: the batch then forces each group's results before the next
group dispatches.  Results are identical in both modes: the plane reorders
host waits, never device work (one stream, in order).

``STATS`` counts blocking syncs, staging waits and readbacks.

The server's QoS plane keeps its per-class in-flight ledger here
(``QosLedger``), and its dispatch layer asks ``is_retryable_device_fault``
which failures reply ``-TRYAGAIN``.

Multi-device serving (``server/placement.py``) dispatches through the
per-position lanes here: ``DeviceLane`` (a staging pool, a ``FlushPipeline``,
a QoS ledger and the occupancy gate: dispatches bound for one position
serialize, dispatches bound for different positions overlap) and
``LaneSet`` (the registry, with the peak dispatch concurrency).
``colocate`` moves a tensor to another device without a host round trip
(counted in ``STATS``: ``d2d_colocations``, ``host_colocations``).

Lanes on positions of one card dispatch on that card's current stream, in
order.  A lane stream of its own would let a kernel that still reads or
writes a record run after another connection's DEL handed the record's
memory to a new tensor (PyTorch's caching allocator reuses a block on the
stream that allocated it), unless every place that drops a record's
tensors called ``record_stream``; lanes on different cards dispatch on
their own cards' streams and overlap there.

**The device-fault domain** (reference ``:156-221``, ``:495-600``,
``:834-839``, ``:1183-1284``, ``:1371-1381``):

  * the lane watchdog (``set_lane_watchdog_ms``, CONFIG SET
    ``lane-watchdog-ms``; 0 = off): armed, a readback polls the CUDA event
    recorded behind its kernels until the bound and then fails with
    ``LaneWatchdogTimeout`` (retryable) in place of waiting.  It never
    calls ``synchronize()`` and never starts the blocking copy before the
    event has passed, so a trip leaves no copy into host memory behind it;
    the staging slots the abandoned kernels read from are handed out again
    only once their own ``staged`` events have passed (``StagingPool``);
  * the fault ledger: each lane counts consecutive faults (a failed launch,
    a watchdog trip, an OOM at bank growth) and flips to QUARANTINED at
    ``quarantine_after()`` (CONFIG SET ``lane-quarantine-after``); a clean
    readback resets the streak, only a passing probe (CLUSTER DEVPROBE)
    clears the flag.  ``note_device_fault`` attributes a fault to every
    live ``LaneSet`` (held weakly in ``_LANE_SETS``); ``note_raised_fault``
    counts a CUDA error that the dispatch layer or the probe caught, once
    (a fault counted where it was raised is marked), and
    ``quarantined_device_ids`` reads the flags (the device evacuation's
    survivors skip them);
  * the chaos plane (``chaos/faults.py``, installed in
    ``net/client._fault_plane``): a lane occupancy consults it before it
    takes the gate (``device_kernel``), and a readback before it waits
    (``device_hang``).

Disarmed (no plane, watchdog off) each site costs one global load and a
compare, and allocates nothing.  Faults are attributed to mesh positions:
a lane occupancy makes its position current on the thread
(``current_position``), and a ``ReadbackFuture`` made there keeps it.
Positions of one card share its stream, so a real stall there times out
every lane that waits behind it; the reference's devices stall one at a
time.  ``is_retryable_device_fault`` maps CUDA's failures onto the
reference's replies (its docstring).

``scatter_host_arrays`` (K23) is the inverse of the grouped readback: a
record's host arrays packed into one stream (each piece at a 16-byte
offset, so ``view(dtype)`` may cut it), one host-to-device copy through a
staging slot, and the pieces cut on the device; replication's full ship
installs through it.

**Bulk-window preemption** (reference ``redisson_tpu/core/ioplane.py``
``:97-160``, ``:227``, ``:1099``, ``:1225-1420``), behind one switch
(``RTPU_NO_PREEMPT=1`` / ``set_preempt(False)`` / the server's
``--no-preempt``):

  * sub-windows: an oversized bulk run splits into chunks of at most
    ``bulk_subwindow_items()`` items (``CONFIG SET
    qos-bulk-subwindow-items``), each its own lane occupancy, with
    ``DeviceLane.preempt_point`` between chunks, so a waiting interactive
    dispatch goes before the next chunk instead of after the whole window;
  * the interactive stream: an interactive-class occupancy takes the lane's
    interactive gate (``_igate``), staging slot (``ipool``) and dispatch
    queue (``ipipeline``), so it never queues behind the bulk gate.

The interactive "stream" is a host gate in front of the card's one
in-order stream, as the reference's is a gate in front of one device
queue: a second CUDA stream would race bulk writes to the same record and
a dropped record's reused block (the paragraph above).  So a chunk yields
the card only once its own kernels are done: the server waits on the
chunk's work (``wait_device``) before it releases the chunk's occupancy,
and the interactive kernel then finds the stream empty.  Disarmed, the
plane is the single-gate, unsplit shape, with the same replies.

**Trace sites** (reference ``:539-610``, ``:1388-1416``): with tracing armed
(``observe/trace.py``) and a frame trace current on the thread,
``ReadbackFuture.result`` records a ``readback`` span whose ``blocking``
flag says whether the event behind the result's kernels had not yet passed
when the force came, and a lane occupancy records the wait for its gate as
``stage`` and the hold as ``dispatch``.

``FlushPipeline``'s window deadline defaults to ``window_deadline()``
(``CONFIG SET qos-interactive-deadline-ms``).  ``STATS.sharded_knn_merges``
counts the sharded vector banks' on-device merges (K19).
"""
from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the chaos plane (chaos/faults.py) lives in net/client's process global
# `_fault_plane`; every device-fault site reads it once
from redisson_tpu_torch.net import client as _net
# tracing plane (observe/trace.py): every site below guards on the
# process-global `_obs._tracer`, so the disarmed cost is one global load
from redisson_tpu_torch.observe import trace as _obs

# -- global switch ------------------------------------------------------------

_overlap = os.environ.get("RTPU_NO_OVERLAP", "") not in ("1", "true", "yes")


def overlap_enabled() -> bool:
    return _overlap


def set_overlap(on: bool) -> bool:
    """Flip the process-global overlap switch; returns the previous value
    (callers restore it)."""
    global _overlap
    prev = _overlap
    _overlap = bool(on)
    return prev


# process-global flush-window deadline: FlushPipelines built without an
# explicit deadline_s follow this default, so CONFIG SET
# qos-interactive-deadline-ms arms the deadline-triggered window close for
# every pipeline built afterwards.  None = deadline trigger off.
_window_deadline_s: Optional[float] = None


def set_window_deadline(seconds: Optional[float]) -> Optional[float]:
    """Set the default FlushPipeline window deadline; returns the previous
    value (callers restore it)."""
    global _window_deadline_s
    prev = _window_deadline_s
    _window_deadline_s = seconds
    return prev


def window_deadline() -> Optional[float]:
    return _window_deadline_s


# -- bulk-window preemption (see the module docstring) ------------------------

_preempt = os.environ.get("RTPU_NO_PREEMPT", "") not in ("1", "true", "yes")


def preempt_enabled() -> bool:
    return _preempt


def set_preempt(on: bool) -> bool:
    """Flip the process-global preemption switch; returns the previous
    value (callers restore it)."""
    global _preempt
    prev = _preempt
    _preempt = bool(on)
    return prev


# target device items per bulk sub-window (0 = splitting off, the whole
# window dispatches at once); CONFIG SET qos-bulk-subwindow-items sets it
_bulk_subwindow_items = 0


def bulk_subwindow_items() -> int:
    return _bulk_subwindow_items


def set_bulk_subwindow_items(n: int) -> int:
    """Set the sub-window split target; returns the previous value."""
    global _bulk_subwindow_items
    prev = _bulk_subwindow_items
    _bulk_subwindow_items = max(0, int(n))
    return prev


# -- lane watchdog and quarantine knobs ----------------------------------------
#
# Armed (CONFIG SET lane-watchdog-ms > 0), a readback whose kernels have not
# finished within the bound raises `LaneWatchdogTimeout`, which the server
# replies as a retryable -TRYAGAIN and the lane's fault ledger counts toward
# quarantine.  0 = off: the unbounded wait, with the same replies.

_lane_watchdog_s = 0.0


def lane_watchdog_ms() -> int:
    return int(_lane_watchdog_s * 1000)


def set_lane_watchdog_ms(ms: int) -> int:
    """Arm/disarm the readback lane watchdog (0 = off); returns the
    previous value in ms (callers restore it)."""
    global _lane_watchdog_s
    prev = int(_lane_watchdog_s * 1000)
    _lane_watchdog_s = max(0, int(ms)) / 1000.0
    return prev


# consecutive device faults/timeouts that flip a lane to QUARANTINED
_quarantine_after = 3


def quarantine_after() -> int:
    return _quarantine_after


def set_quarantine_after(n: int) -> int:
    """Set the consecutive-fault quarantine threshold (at least 1);
    returns the previous value."""
    global _quarantine_after
    prev = _quarantine_after
    _quarantine_after = max(1, int(n))
    return prev


# which lane stream the current thread's dispatch occupies ("interactive"
# while an interactive occupancy is held): Engine.staging_pool reads it to
# hand the interactive dispatch its own staging slot.  `position` is the id
# of the lane's mesh position while an occupancy is held: the position a
# readback made there belongs to.
_stream_tls = threading.local()


def current_stream() -> Optional[str]:
    return getattr(_stream_tls, "stream", None)


def current_position() -> Optional[int]:
    """The position id of the lane occupancy the current thread holds,
    else None."""
    return getattr(_stream_tls, "position", None)


def positions_of(values: Sequence[Any], position: Optional[int] = None) -> tuple:
    """The position ids a readback of `values` belongs to: `position` when
    given, else each tensor's device index (0 for the CPU, as the
    reference's values without placement live on its device 0); numpy
    values belong to none."""
    if position is not None:
        return (position,)
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            d = v.device.index or 0
            if d not in out:
                out.append(d)
    return tuple(out)


def staging_reuse_safe(device) -> bool:
    """Pooled host-buffer reuse needs the upload to COPY.  On the CPU the
    staged tensor is ``torch.from_numpy`` of the slot itself, so refilling
    the slot would rewrite a tensor staged earlier (one the query cache may
    still hold); a copy to a CUDA card is a real DMA and reuse is safe."""
    return torch.device(device).type == "cuda"


def record_event(device) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded on `device`'s current stream, after the work
    enqueued so far; None for the CPU, where work is done when it returns."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _passed(event) -> bool:
    return event is None or bool(event.query())


def wait_device(device) -> None:
    """Wait until the work enqueued so far on `device`'s current stream is
    done (one event, not the whole card); nothing on the CPU.  A bulk
    sub-window calls it before it releases its lane, so the card is idle
    when a waiting interactive dispatch launches."""
    ev = record_event(device)
    if ev is not None:
        ev.synchronize()


# -- blocking-sync + readback accounting --------------------------------------


class IOStats:
    """Process-global counters for the plane's observable costs.

    ``blocking_syncs`` counts every host-side wait on device work the plane
    performs (staging waits, forced readbacks, grouped gathers).
    ``readback_exposed_s`` accumulates only the readback wall time spent
    while the device value was not yet ready (the part not hidden)."""

    __slots__ = ("_lock", "blocking_syncs", "readbacks", "readback_wait_s",
                 "readback_exposed_s", "staging_waits", "d2d_colocations",
                 "host_colocations", "sharded_knn_merges")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.blocking_syncs = 0
        self.readbacks = 0
        self.readback_wait_s = 0.0
        self.readback_exposed_s = 0.0
        self.staging_waits = 0
        # cross-device moves (colocate): device to device, or through the
        # host (a numpy value uploaded); the cross-device merges keep the
        # second at 0
        self.d2d_colocations = 0
        self.host_colocations = 0
        self.sharded_knn_merges = 0

    def count_sync(self, n: int = 1) -> None:
        with self._lock:
            self.blocking_syncs += n

    def count_staging_wait(self) -> None:
        with self._lock:
            self.blocking_syncs += 1
            self.staging_waits += 1

    def count_colocation(self, through_host: bool) -> None:
        with self._lock:
            if through_host:
                self.host_colocations += 1
            else:
                self.d2d_colocations += 1

    def add_readback(self, wall_s: float, was_ready: bool) -> None:
        with self._lock:
            self.blocking_syncs += 1
            self.readbacks += 1
            self.readback_wait_s += wall_s
            if not was_ready:
                self.readback_exposed_s += wall_s

    def count_sharded_merge(self) -> None:
        """One on-device sharded-KNN top-k merge ran: with host_colocations
        unmoved it shows the cross-shard reduce stayed on the device."""
        with self._lock:
            self.sharded_knn_merges += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "blocking_syncs": self.blocking_syncs,
                "readbacks": self.readbacks,
                "readback_wait_s": self.readback_wait_s,
                "readback_exposed_s": self.readback_exposed_s,
                "staging_waits": self.staging_waits,
                "d2d_colocations": self.d2d_colocations,
                "host_colocations": self.host_colocations,
                "sharded_knn_merges": self.sharded_knn_merges,
            }


STATS = IOStats()

# per-device ledgers (keyed by the torch device's name): the grouped
# readback counts its sync on the device it read from, a lane its readbacks
_DEVICE_STATS: "dict[str, IOStats]" = {}
_DEVICE_STATS_LOCK = threading.Lock()


def device_stats(device) -> IOStats:
    """The IOStats ledger of one torch device (created on first use)."""
    key = str(torch.device(device))
    with _DEVICE_STATS_LOCK:
        st = _DEVICE_STATS.get(key)
        if st is None:
            st = _DEVICE_STATS[key] = IOStats()
        return st


def device_stats_snapshot() -> dict:
    """{device name: snapshot} of every per-device ledger."""
    with _DEVICE_STATS_LOCK:
        items = list(_DEVICE_STATS.items())
    return {k: st.snapshot() for k, st in items}


def reset_device_stats() -> None:
    with _DEVICE_STATS_LOCK:
        items = list(_DEVICE_STATS.values())
    for st in items:
        st.reset()


def colocate(value, device) -> torch.Tensor:
    """`value` as a tensor on `device`: itself when it is already there, a
    device-to-device copy otherwise (a peer copy between cards; counted
    ``d2d_colocations``), an upload for a numpy value (counted
    ``host_colocations``).  Never a round trip through host memory for a
    tensor."""
    device = torch.device(device)
    if isinstance(value, torch.Tensor):
        if value.device == device:
            return value
        STATS.count_colocation(through_host=False)
        return value.to(device)
    STATS.count_colocation(through_host=True)
    return torch.as_tensor(np.asarray(value), device=device)


def device_of(value) -> Optional[torch.device]:
    """The device of a tensor, else None (numpy values)."""
    return value.device if isinstance(value, torch.Tensor) else None


def _to_host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


# -- readback futures ----------------------------------------------------------


class ReadbackFuture:
    """Demand-driven D2H readback handle (the RFuture of the device plane).

    Holds kernel outputs as device tensors and the event recorded behind
    them; ``result()`` copies them to the host on first demand (counted,
    exposed time attributed) and caches.  ``force_all`` primes several
    futures with ONE grouped transfer instead; device references are
    released either way.  Kernels never write a result tensor after it is
    returned, so holding it is safe.  The future belongs to `position`
    (default: the lane occupancy current on the thread, else its tensors'
    devices): a hung readback's fault lands on that position's lanes."""

    __slots__ = ("_device", "_event", "_finish", "_value", "_error", "_done",
                 "_positions")

    def __init__(self, device: Sequence[Any], finish: Optional[Callable] = None,
                 position: Optional[int] = None):
        self._device: tuple = tuple(device)
        devs = {v.device for v in self._device if isinstance(v, torch.Tensor)}
        self._event = record_event(next(iter(devs))) if len(devs) == 1 else None
        self._finish = finish
        self._value = None
        self._error: Optional[BaseException] = None
        self._done = False
        self._positions = positions_of(
            self._device, current_position() if position is None else position
        )

    def done(self) -> bool:
        return self._done

    def ready(self) -> bool:
        """True when result() would not block on device work."""
        return self._done or _passed(self._event)

    def _deliver(self, host: tuple) -> None:
        try:
            self._value = self._finish(host) if self._finish is not None else (
                host[0] if len(host) == 1 else host
            )
        except Exception as e:  # noqa: BLE001 — surfaced on result()
            self._error = e
        self._done = True
        self._device = ()  # release device memory references
        self._event = None

    def _trip(self, wall: float) -> None:
        """The watchdog fired: account the bounded wait, attribute a
        timeout to every involved position's lanes, and fail this future
        with `LaneWatchdogTimeout`.  No copy was started, so nothing still
        writes host memory for it; dropping the tensors hands their blocks
        back to the caching allocator in stream order."""
        STATS.add_readback(wall, False)
        for d in self._positions:
            note_device_fault(d, "watchdog_timeout")
        if _obs._tracer is not None:
            cur = _obs.current_trace()
            if cur is not None:
                now = time.monotonic()
                cur.add_span("readback", now - wall, now,
                             blocking=1, grouped=0, timeout=1)
        self._error = LaneWatchdogTimeout(_watchdog_text(self._positions))
        self._done = True
        self._device = ()
        self._event = None

    def _guard(self, plane, bound: float) -> None:
        """Armed-only gate shared by ``result()`` and ``force_all``
        (``_bounded_wait``); a timeout fails this future.  Never called on
        the disarmed path."""
        t0 = time.perf_counter()
        if _bounded_wait(plane, self._positions, bound, self._event) is not None:
            self._trip(time.perf_counter() - t0)

    def result(self):
        if not self._done:
            plane = _net._fault_plane
            bound = _lane_watchdog_s
            if plane is not None or bound > 0.0:
                self._guard(plane, bound)
        if not self._done:
            was_ready = self.ready()
            t0 = time.perf_counter()
            try:
                host = tuple(_to_host(v) for v in self._device)
            except Exception as e:  # noqa: BLE001 — surfaced below
                STATS.add_readback(time.perf_counter() - t0, was_ready)
                for d in self._positions:
                    note_device_fault(d, "readback_error")
                mark_fault_noted(e)
                self._error = e
                self._done = True
                self._device = ()
            else:
                wall = time.perf_counter() - t0
                STATS.add_readback(wall, was_ready)
                for d in self._positions:  # a clean readback ends a streak
                    note_device_ok(d)
                if _obs._tracer is not None:
                    cur = _obs.current_trace()
                    if cur is not None:
                        # this frame PAID a blocking sync iff the event
                        # behind its kernels had not passed when the force
                        # came
                        now = time.monotonic()
                        cur.add_span(
                            "readback", now - wall, now,
                            blocking=int(not was_ready), grouped=0,
                        )
                self._deliver(host)
        if self._error is not None:
            raise self._error
        return self._value


def _fetch(device: torch.device, parts: List[torch.Tensor]) -> np.ndarray:
    """ONE transfer of byte views `parts` (all on `device`) to the host."""
    merged = parts[0] if len(parts) == 1 else torch.cat(parts)
    if device.type != "cuda":
        return merged.numpy().copy()
    # pinned memory from PyTorch's caching host allocator: a non_blocking
    # copy into pageable memory would be synchronous, and a fresh
    # cudaHostAlloc per flush would cost more than the copy
    host = torch.empty(merged.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(merged, non_blocking=True)
    ev = record_event(device)
    ev.synchronize()
    return host.numpy().copy()


def _watchdog_text(positions) -> str:
    devs = ", ".join(str(d) for d in sorted(positions)) or "?"
    return (f"readback exceeded lane-watchdog bound ({lane_watchdog_ms()}ms) "
            f"on device(s) {devs}")


def _bounded_wait(plane, positions: Sequence[int], bound: float, event
                  ) -> Optional[List[int]]:
    """The armed gate before a readback of values that belong to
    `positions`, behind `event`: any injected hung-transfer stall
    (``device_hang``), then the watchdog's poll of the event until `bound`
    (never ``synchronize()``, and no copy started).  None when the values
    may be copied; else the positions that timed out, after a wait of the
    bound: those whose injected stall passed it, or every position of a
    wait on the stream that did not end (one stream: every position behind
    it timed out)."""
    if plane is not None:
        stalls = [plane.on_device_readback(d) for d in positions]
        stall = max(stalls, default=0.0)
        if stall > 0.0:
            if bound > 0.0 and stall > bound:
                time.sleep(bound)
                return [d for d, s in zip(positions, stalls) if s > bound]
            time.sleep(stall)
    if bound > 0.0:
        deadline = time.monotonic() + bound
        while not _passed(event):
            left = deadline - time.monotonic()
            if left <= 0.0:
                return list(positions)
            time.sleep(min(0.002, left))
    return None


def _readback_guard(device: torch.device, positions: Sequence[int]) -> None:
    """Armed-only gate of the grouped fetch from `device`, whose values
    belong to `positions` (``_bounded_wait`` on an event recorded now on
    the device's stream, behind every kernel the values wait for; the
    reference fetches each device's bucket on its own thread, one wait of
    the bound covers every position here).  Raises ``LaneWatchdogTimeout``
    (retryable) with the fault on the timed-out positions' lanes.
    Disarmed cost: one global load and one float compare."""
    plane = _net._fault_plane
    bound = _lane_watchdog_s
    if (plane is None and bound <= 0.0) or not positions:
        return
    hung = _bounded_wait(plane, positions, bound,
                         record_event(device) if bound > 0.0 else None)
    if hung is not None:
        for d in hung:
            note_device_fault(d, "watchdog_timeout")
        raise LaneWatchdogTimeout(_watchdog_text(hung))


def _bucket_positions(flat, fis, owner, positions) -> List[int]:
    """The positions the values `fis` of a grouped fetch belong to."""
    out: List[int] = []
    for fi in fis:
        ids = positions[owner[fi]] if positions is not None else None
        if not isinstance(ids, tuple):
            ids = positions_of((flat[fi],), ids)
        for d in ids:
            if d not in out:
                out.append(d)
    return out


def gather_device_results(groups: Sequence[Sequence[Any]],
                          positions: Optional[Sequence[Any]] = None,
                          note_faults: bool = True) -> List[tuple]:
    """Fetch every device value of `groups` with ONE device->host transfer
    per device: view each value as a contiguous uint8 stream, concatenate
    them on the device, copy the merged stream once, then split and
    reinterpret each piece on the host.  numpy values pass through.
    `positions` (one entry a group: a position id, a tuple of them, or
    None for each tensor's device index) names the positions each group
    belongs to, for the armed watchdog and the injected stalls
    (``_readback_guard``), and for a failed copy, counted on them as a
    ``readback_error`` unless `note_faults` is False."""
    flat: List[Any] = []  # tensor (as uint8 stream) or host value
    meta: List[Optional[tuple]] = []  # (dtype, shape) of each tensor
    index: List[List[int]] = []
    for group in groups:
        pos = []
        for v in group:
            pos.append(len(flat))
            if isinstance(v, torch.Tensor):
                flat.append(v.reshape(-1).view(torch.uint8))
                meta.append((v.dtype, tuple(v.shape)))
            else:
                flat.append(np.asarray(v))
                meta.append(None)
        index.append(pos)
    host: List[Any] = [None] * len(flat)
    buckets: "dict[torch.device, List[int]]" = {}
    for fi, m in enumerate(meta):
        if m is None:
            host[fi] = flat[fi]
        else:
            buckets.setdefault(flat[fi].device, []).append(fi)
    owner = None  # the group of each flat value, when armed or failed

    def groups_of():
        return {fi: g for g, pos in enumerate(index) for fi in pos}

    if _net._fault_plane is not None or _lane_watchdog_s > 0.0:
        owner = groups_of()
    for device, fis in buckets.items():
        parts = [flat[fi] for fi in fis]
        if owner is not None:
            _readback_guard(device, _bucket_positions(flat, fis, owner, positions))
        STATS.count_sync()
        device_stats(device).count_sync()
        try:
            merged = _fetch(device, parts)
        except Exception as e:
            # a failed copy (a sticky CUDA error surfaces at the first call
            # after it): the fault lands on the bucket's positions once
            if note_faults and is_retryable_device_fault(e) and not _noted(e):
                for d in _bucket_positions(flat, fis, owner or groups_of(), positions):
                    note_device_fault(d, "readback_error")
                mark_fault_noted(e)
            raise
        off = 0
        for fi in fis:
            n = flat[fi].numel()
            dtype, shape = meta[fi]
            if n == 0:
                host[fi] = torch.empty(shape, dtype=dtype).numpy()
            else:
                piece = torch.from_numpy(merged[off:off + n].copy())  # aligned, owned
                host[fi] = piece.view(dtype).reshape(shape).numpy()
            off += n
    return [tuple(host[i] for i in pos) for pos in index]


# each piece of scatter_host_arrays' merged stream starts at a multiple of
# this: Tensor.view(dtype) on a uint8 slice needs an offset that is a
# multiple of the new item size, and 16 keeps a piece fit for the kernels'
# 16-byte loads
SCATTER_ALIGN = 16


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype; TypeError for one torch lacks."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


def scatter_layout(arrays: dict) -> Tuple[List[tuple], int]:
    """The merged stream's layout for scatter_host_arrays: one
    ``(key, offset, nbytes, numpy dtype, shape)`` a key in sorted order,
    each offset rounded up to SCATTER_ALIGN, and the stream's length.
    Raises on a dtype that does not round-trip (``np.dtype(a.dtype.name)``)
    or that torch has no dtype for: the host-side packing errors."""
    layout = []
    off = 0
    for k in sorted(arrays):
        a = np.asarray(arrays[k])
        np.dtype(a.dtype.name)
        _torch_dtype(a.dtype)
        off = -(-off // SCATTER_ALIGN) * SCATTER_ALIGN
        layout.append((k, off, int(a.nbytes), a.dtype, tuple(a.shape)))
        off += int(a.nbytes)
    return layout, off


def scatter_host_arrays(arrays: dict, device, pool: "Optional[StagingPool]" = None
                        ) -> dict:
    """Upload a dict of host arrays to `device` with ONE host->device copy
    (K23; reference ``core/ioplane.py:753-830``), the inverse of
    gather_device_results: every array is laid as bytes into one merged
    uint8 stream (a bool array as uint8 0/1), each piece at a 16-byte
    offset, filled through `pool`'s pinned slot when one is given (the
    slot is handed out again only after the event recorded behind this
    copy has passed), copied once, then cut into the record's tensors on
    the device by ``narrow``, ``view(dtype)`` and ``reshape``: no kernel
    runs, nothing is computed.  The tensors returned share the merged
    stream's storage.  Returns {key: tensor on `device`}."""
    device = torch.device(device)
    layout, total = scatter_layout(arrays)
    if total == 0:  # nothing but empty planes
        return {k: torch.from_numpy(np.asarray(arrays[k]).copy()).to(device)
                for k, *_ in layout}
    # the alignment gaps are never read: no zeroing
    if pool is not None:
        buf, slot = pool.acquire((total,), np.uint8, zero=False)
    else:
        buf, slot = np.empty(total, np.uint8), None
    try:
        stream = torch.from_numpy(buf)
        for k, off, nbytes, _dt, _shape in layout:
            if nbytes:
                # torch's copy, which spreads a large one over the host's
                # threads, where numpy's takes one
                src = torch.from_numpy(np.ascontiguousarray(arrays[k])).reshape(-1)
                stream[off:off + nbytes].copy_(src.view(torch.uint8))
        merged = stream.to(device, non_blocking=pool is not None)
    except BaseException:
        if pool is not None:
            pool.release(slot)
        raise
    if pool is not None:
        pool.commit(slot, record_event(device))
    out = {}
    for k, off, nbytes, dt, shape in layout:
        piece = merged.narrow(0, off, nbytes)
        out[k] = piece.view(_torch_dtype(dt)).reshape(shape)
    return out


def force_all(futures: Sequence[ReadbackFuture]) -> None:
    """Materialize several ReadbackFutures with ONE grouped transfer (the
    embedded Batch drains its pending groups through here)."""
    todo = [f for f in futures if not f.done()]
    if not todo:
        return
    # the same gate result() applies: injected stalls land here too, and
    # the armed watchdog fails a hung future with LaneWatchdogTimeout
    # instead of wedging the grouped drain.  Disarmed cost: one global
    # load and one float compare.
    plane = _net._fault_plane
    bound = _lane_watchdog_s
    if plane is not None or bound > 0.0:
        for f in todo:
            f._guard(plane, bound)
        todo = [f for f in todo if not f.done()]  # tripped: error delivered
        if not todo:
            return
    try:
        # a failed grouped copy is counted by each future's own retry
        host_groups = gather_device_results(
            [f._device for f in todo], [f._positions for f in todo],
            note_faults=False)
    except Exception:  # noqa: BLE001 — grouped path failed; force singly
        for f in todo:
            try:
                f.result()
            except Exception:  # noqa: BLE001 — error lands on THAT future
                pass
        return
    for f, host in zip(todo, host_groups):
        f._deliver(host)


# -- double-buffered host staging ----------------------------------------------


class _StageSlot:
    __slots__ = ("buf", "pinned", "staged", "busy")

    def __init__(self):
        self.buf: np.ndarray = np.empty(0, np.uint8)
        self.pinned: Optional[torch.Tensor] = None  # owns buf's memory when pinned
        self.staged = None  # event recorded behind the last copy from buf
        self.busy = False


class StagingPool:
    """Double-buffered host staging buffers for flush packing.

    ``acquire(shape, dtype)`` hands out a zeroed numpy view backed by one of
    ``depth`` reusable slots (pinned host memory with ``pin``);
    ``commit(slot, event)`` pairs the slot with the event recorded behind
    the copy made from it and frees it (``zero=False`` skips the zeroing,
    for a caller that writes every byte it reads).  acquire prefers a free slot whose
    copy has passed, then a new slot (up to ``depth``), and only then waits
    (counted as a staging wait) on a free slot's copy, so refilling buffer
    A overlaps buffer B's copy in flight.  When every slot is checked out
    acquire degrades to a fresh one-off allocation (slot=None): correctness
    never depends on pool depth."""

    def __init__(self, depth: int = 2, pin: bool = False):
        self._lock = threading.Lock()
        self._slots: List[_StageSlot] = []
        self._depth = max(1, depth)
        self._pin = pin
        self.oneoffs = 0

    def _grow(self, slot: _StageSlot, nbytes: int) -> None:
        if self._pin:
            slot.pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            slot.buf = slot.pinned.numpy()
        else:
            slot.buf = np.empty(nbytes, np.uint8)

    def acquire(self, shape, dtype=np.uint32,
                zero: bool = True) -> Tuple[np.ndarray, Optional[_StageSlot]]:
        want = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        with self._lock:
            free = [s for s in self._slots if not s.busy]
            # a free slot whose copy has passed, else a new slot, else wait
            # on a free one
            slot = next((s for s in free if _passed(s.staged)), None)
            if slot is None and len(self._slots) < self._depth:
                slot = _StageSlot()
                self._slots.append(slot)
            if slot is None and free:
                slot = free[0]
            if slot is not None:
                slot.busy = True
        if slot is None:
            self.oneoffs += 1
            return (np.zeros if zero else np.empty)(shape, dtype), None
        staged, slot.staged = slot.staged, None
        if staged is not None and not staged.query():
            # the double-buffer boundary: the slot's previous copy is still
            # in flight — wait (counted) before touching its bytes.  This
            # also keeps reuse safe after a lane-watchdog trip: the copy
            # that fed the abandoned kernels was committed with its event,
            # so its slot is not refilled before that copy has read it
            STATS.count_staging_wait()
            staged.synchronize()
        if slot.buf.nbytes < want:
            self._grow(slot, max(want, 1))
        view = slot.buf[:want].view(dtype).reshape(shape)
        if zero:
            view[...] = 0
        return view, slot

    def commit(self, slot: Optional[_StageSlot], event) -> None:
        """Record the event behind the copy made from `slot` and free the
        slot; slot=None (a one-off buffer) is a no-op."""
        if slot is not None:
            with self._lock:
                slot.staged = event
                slot.busy = False

    def release(self, slot: Optional[_StageSlot]) -> None:
        """Abandon a slot without a copy (error paths)."""
        if slot is not None:
            with self._lock:
                slot.busy = False

    def clear(self) -> None:
        with self._lock:
            self._slots.clear()

    def slot_count(self) -> int:
        with self._lock:
            return len(self._slots)


# -- device faults the server replies -TRYAGAIN to -----------------------------


class LaneWatchdogTimeout(RuntimeError):
    """A device readback exceeded the armed lane-watchdog bound: the frame
    fails retryably (-TRYAGAIN) instead of wedging its writer."""


# set on an exception whose fault was counted where it was raised (the
# chaos plane's chokepoints, a failed readback): the dispatch layer that
# later replies it does not count it again
_NOTED_ATTR = "_rtpu_fault_noted"


def _noted(e: BaseException) -> bool:
    return getattr(e, _NOTED_ATTR, False)


def mark_fault_noted(e: BaseException) -> None:
    try:
        setattr(e, _NOTED_ATTR, True)
    except (AttributeError, TypeError):  # an exception type with __slots__
        pass


def note_raised_fault(e: BaseException, dev_id: Optional[int],
                      kind: str = "kernel_launch") -> None:
    """Count `e`, raised by device work on position `dev_id`, on that
    position's lanes when it is a retryable device fault (a failed launch,
    a sticky CUDA error surfacing at a later call) not counted yet.  A
    watchdog trip and a fault counted where it was raised are not counted
    again; `dev_id` None (no lane occupancy current) counts nothing."""
    if (dev_id is None or isinstance(e, LaneWatchdogTimeout) or _noted(e)
            or not is_retryable_device_fault(e)):
        return
    mark_fault_noted(e)
    note_device_fault(dev_id, kind)


def is_out_of_memory(e: BaseException) -> bool:
    """A CUDA allocation failure: ``torch.OutOfMemoryError``, or a
    RuntimeError with the caching allocator's text or the runtime's
    ``cudaErrorMemoryAllocation`` text."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    if not isinstance(e, RuntimeError):
        return False
    text = str(e).lstrip()
    return "CUDA out of memory" in text or text.startswith("CUDA error: out of memory")


def is_retryable_device_fault(e: BaseException) -> bool:
    """The failure shapes the server's dispatch layer converts to a clean
    retryable ``-TRYAGAIN`` (counted on the lane where it was raised):

      * ``LaneWatchdogTimeout``;
      * ``torch.AcceleratorError``, and any RuntimeError whose message
        starts with ``CUDA error:``, unless it is an OOM: a failed launch,
        an illegal address, a device-side assert.  The last two are sticky:
        they lose the process's CUDA context, every later dispatch fails
        the same way, each lane reaches ``lane-quarantine-after`` and
        quarantines, and only a restart of the process (the supervisor's
        ``kill``/``restart``) recovers;
      * a RuntimeError whose message starts with one of the reference's
        transient-runtime prefixes (``INTERNAL``, ``UNAVAILABLE``, ...).

    ``torch.OutOfMemoryError`` is not retryable: at a vector bank's growth
    it replies ``-OOM`` (``services/vector.DeviceOomError``), elsewhere
    ``ERR internal``, as the reference does with ``RESOURCE_EXHAUSTED``."""
    if isinstance(e, LaneWatchdogTimeout):
        return True
    if not isinstance(e, RuntimeError) or is_out_of_memory(e):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return str(e).lstrip().startswith(
        ("CUDA error:", "INTERNAL", "UNAVAILABLE", "ABORTED", "CANCELLED",
         "DEADLINE_EXCEEDED")
    )


# -- per-class QoS in-flight ledger --------------------------------------------


class QosLedger:
    """Per-deadline-class in-flight accounting: one global ledger on the
    server's WindowScheduler, one a DeviceLane.  Every ``enter`` must be
    paired with an ``exit``: the server's metrics gauges read the in-flight
    rows, CLUSTER DEVICES the cumulative ones (``wire_row``)."""

    __slots__ = ("_lock", "frames", "ops", "nbytes", "waiting",
                 "dispatched_ops", "dispatched_frames",
                 "stream_inflight", "stream_dispatched")

    _CLASSES = ("interactive", "bulk")
    # lane streams: "interactive" only when the interactive gate served the
    # dispatch (preemption armed and the frame interactive-class), "bulk"
    # otherwise, so a disarmed run books every dispatch on the bulk stream
    _STREAMS = ("interactive", "bulk")

    def __init__(self):
        self._lock = threading.Lock()
        self.frames = {c: 0 for c in self._CLASSES}
        self.ops = {c: 0 for c in self._CLASSES}
        self.nbytes = {c: 0 for c in self._CLASSES}
        self.waiting = 0  # bulk frames parked at the admission gate
        self.dispatched_ops = {c: 0 for c in self._CLASSES}
        self.dispatched_frames = {c: 0 for c in self._CLASSES}
        self.stream_inflight = {s: 0 for s in self._STREAMS}
        self.stream_dispatched = {s: 0 for s in self._STREAMS}

    @classmethod
    def _cls(cls, qos_class: str) -> str:
        return qos_class if qos_class in cls._CLASSES else "bulk"

    def enter(self, qos_class: str, ops: int, nbytes: int = 0) -> None:
        c = self._cls(qos_class)
        with self._lock:
            self.frames[c] += 1
            self.ops[c] += ops
            self.nbytes[c] += nbytes
            self.dispatched_ops[c] += ops
            self.dispatched_frames[c] += 1

    def exit(self, qos_class: str, ops: int, nbytes: int = 0) -> None:
        c = self._cls(qos_class)
        with self._lock:
            self.frames[c] -= 1
            self.ops[c] -= ops
            self.nbytes[c] -= nbytes

    def wait_enter(self) -> None:
        with self._lock:
            self.waiting += 1

    def wait_exit(self) -> None:
        with self._lock:
            self.waiting -= 1

    def stream_enter(self, stream: str, ops: int) -> None:
        s = stream if stream in self._STREAMS else "bulk"
        with self._lock:
            self.stream_inflight[s] += ops
            self.stream_dispatched[s] += ops

    def stream_exit(self, stream: str, ops: int) -> None:
        s = stream if stream in self._STREAMS else "bulk"
        with self._lock:
            self.stream_inflight[s] -= ops

    def stream_rows(self) -> list:
        """``[b"STREAM", name, in-flight ops, dispatched ops]`` a lane
        stream, as CLUSTER QOS appends them; the leading tag keeps them apart
        from the class rows (row[0] the class name), which the occupancy
        balancer reads."""
        with self._lock:
            return [
                [b"STREAM", s.encode(), self.stream_inflight[s],
                 self.stream_dispatched[s]]
                for s in self._STREAMS
            ]

    def census(self, prefix: str = "qos") -> dict:
        """Drain-to-zero gauges only (the cumulative counters are on the
        wire views)."""
        with self._lock:
            out = {f"{prefix}_bulk_waiting": float(self.waiting)}
            for c in self._CLASSES:
                out[f"{prefix}_{c}_inflight_frames"] = float(self.frames[c])
                out[f"{prefix}_{c}_inflight_ops"] = float(self.ops[c])
                out[f"{prefix}_{c}_inflight_bytes"] = float(self.nbytes[c])
            for s in self._STREAMS:
                out[f"{prefix}_stream_{s}_inflight"] = float(self.stream_inflight[s])
            return out

    def wire_row(self) -> list:
        """[in-flight ops i/b, in-flight bytes i/b, dispatched ops i/b]: the
        CLUSTER DEVICES per-lane projection."""
        with self._lock:
            return [
                self.ops["interactive"], self.ops["bulk"],
                self.nbytes["interactive"], self.nbytes["bulk"],
                self.dispatched_ops["interactive"],
                self.dispatched_ops["bulk"],
            ]


# -- dispatch-ahead flush driver -----------------------------------------------


class FlushPipeline:
    """stage -> dispatch -> fetch driver for a stream of flush windows (a
    lane's A/B harness).

    ``submit(fn)``: ``fn()`` stages and dispatches ONE window and returns
    ``(device_values, finish)`` with ``finish(host_tuple) -> result``.

      * overlap on: returns a ReadbackFuture at once; at most ``depth``
        windows stay unforced, so submitting window depth+1 forces the
        oldest, whose readback by then overlapped the younger windows'
        staging and dispatch.
      * overlap off: the strict serial reference, a readback forced at
        every submit.

    ``submit(fn, interactive=True)`` forces the window's readback at once
    instead of parking it behind bulk windows; with ``deadline_s`` set
    (default ``window_deadline()``), a window older than the deadline is
    forced by the next submit.  Neither
    reorders device work, only waits, so results are the same."""

    def __init__(self, *, overlap: Optional[bool] = None, depth: int = 2,
                 deadline_s: Optional[float] = None):
        self.overlap = overlap_enabled() if overlap is None else bool(overlap)
        self.depth = max(1, depth)
        # None follows the process-global default (window_deadline())
        self.deadline_s = _window_deadline_s if deadline_s is None else deadline_s
        self._ring: List[Tuple[ReadbackFuture, float]] = []

    @staticmethod
    def _force(fut: ReadbackFuture) -> None:
        try:
            fut.result()
        except Exception:  # noqa: BLE001 — the error stays on the future
            pass

    def submit(self, fn: Callable[[], Tuple[Sequence[Any], Optional[Callable]]],
               interactive: bool = False) -> ReadbackFuture:
        device, finish = fn()
        fut = ReadbackFuture(device, finish)
        if not self.overlap:
            self._force(fut)
            return fut
        now = time.monotonic()
        if self.deadline_s is not None:
            while self._ring and now - self._ring[0][1] > self.deadline_s:
                self._force(self._ring.pop(0)[0])
        if interactive:
            self._force(fut)
            return fut
        self._ring.append((fut, now))
        if len(self._ring) > self.depth:
            self._force(self._ring.pop(0)[0])
        return fut

    def pending(self) -> int:
        return len(self._ring)

    def drain(self) -> None:
        """Force every still-pending window (end of the stream)."""
        ring, self._ring = self._ring, []
        for fut, _t in ring:
            self._force(fut)


# -- per-position serving lanes ------------------------------------------------

_replica_ns_per_item: Optional[float] = None


def set_replica_occupancy(ns_per_item: Optional[float]) -> Optional[float]:
    """Arm/disarm the modelled device occupancy: with a value set, every
    ``DeviceLane.occupy(n_items)`` holds its lane n_items * ns_per_item
    nanoseconds, the per-chip compute time a device would serialize on its
    stream.  It exists only for A/B measurement on machines without the
    devices (the reference's bench config 5d arms it off the chip); it
    stays disarmed on the card, where the kernels take their own time.
    Returns the previous value."""
    global _replica_ns_per_item
    prev = _replica_ns_per_item
    _replica_ns_per_item = ns_per_item
    return prev


def replica_occupancy() -> Optional[float]:
    return _replica_ns_per_item


class DeviceLane:
    """One position's serving lane: staging pool, flush pipeline, QoS
    ledger, and the occupancy gate (dispatches bound for one position
    serialize; dispatches bound for different positions overlap), plus the
    interactive stream: its own gate, staging slot and dispatch queue."""

    def __init__(self, device, laneset: "LaneSet", depth: int = 2):
        self.device = device
        self.dev_id = getattr(device, "id", 0)
        torch_dev = getattr(device, "device", device)
        pin = torch.device(torch_dev).type == "cuda"
        self.pool = StagingPool(depth=depth, pin=pin)
        self.pipeline = FlushPipeline(depth=depth)
        self.qos = QosLedger()
        self._laneset = laneset
        self._gate = threading.Lock()
        # the interactive stream: depth 1 on both, as interactive windows
        # never park (FlushPipeline forces them at submit) and one slot
        # matches one-at-a-time, latency-bound traffic
        self._igate = threading.Lock()
        self.ipool = StagingPool(depth=1, pin=pin)
        self.ipipeline = FlushPipeline(depth=1)
        self._icond = threading.Condition(threading.Lock())
        self._iwaiting = 0  # interactive dispatches queued or in flight
        self.dispatches = 0
        self.preemptions = 0  # preemption points that yielded
        # fault ledger: consecutive faults/timeouts trip quarantine; a clean
        # readback resets the streak, a passing probe (CLUSTER DEVPROBE)
        # clears the flag
        self.consec_faults = 0
        self.total_faults = 0
        self.quarantined = False
        self.quarantined_at = 0.0
        self.last_fault_kind = ""

    def note_fault(self, kind: str) -> bool:
        """Record one device-layer fault (a failed launch, a readback
        timeout or error, an OOM at growth).  Trips QUARANTINED at the
        consecutive threshold; returns True when this call flipped it."""
        self.total_faults += 1
        self.consec_faults += 1
        self.last_fault_kind = kind
        if not self.quarantined and self.consec_faults >= _quarantine_after:
            self.quarantined = True
            self.quarantined_at = time.monotonic()
            if _obs._tracer is not None:
                cur = _obs.current_trace()
                if cur is not None:
                    now = time.monotonic()
                    cur.add_span("quarantine", now, now, device=self.dev_id)
            return True
        return False

    def note_ok(self) -> None:
        """A device operation completed cleanly: the consecutive-fault
        streak (not the quarantine flag: only a probe clears that) resets."""
        if self.consec_faults:
            self.consec_faults = 0

    def unquarantine(self) -> None:
        """Clear quarantine (the probe-passed path)."""
        self.quarantined = False
        self.consec_faults = 0

    def occupy(self, n_items: int = 0, qos_class: Optional[str] = None,
               nbytes: int = 0) -> "_LaneOccupancy":
        """Context manager bounding one dispatch's occupancy of the lane:
        holds the gate and, with ``set_replica_occupancy`` armed, the
        modelled compute time of `n_items` ops; with `qos_class` (the
        scheduler armed) the dispatch is on the lane's QoS ledger while it
        holds the lane.  With preemption armed an interactive-class
        dispatch holds the interactive gate instead of the bulk one."""
        return _LaneOccupancy(self, n_items, qos_class, nbytes)

    def submit(self, fn, interactive: bool = False) -> ReadbackFuture:
        """Route one flush window: armed interactive windows go through the
        interactive dispatch queue (a parked bulk ring never delays forcing
        them), everything else, and everything when disarmed, through the
        bulk pipeline."""
        if interactive and _preempt:
            return self.ipipeline.submit(fn, interactive=True)
        return self.pipeline.submit(fn, interactive=interactive)

    def interactive_waiting(self) -> int:
        with self._icond:
            return self._iwaiting

    def _ienter(self) -> None:
        with self._icond:
            self._iwaiting += 1

    def _iexit(self) -> None:
        with self._icond:
            self._iwaiting -= 1
            if self._iwaiting <= 0:
                self._icond.notify_all()

    def preempt_point(self, timeout: float = 0.05) -> bool:
        """The preemption point between bulk sub-windows: with preemption
        armed and interactive dispatches queued or in flight on this lane,
        wait up to `timeout` seconds for them, so they launch before the
        next sub-window takes the lane.  The caller holds no lane gate and
        no record lock here, and the wait is bounded, so a stuck client
        cannot stall the bulk stream.  Returns True when it yielded."""
        if not _preempt:
            return False
        yielded = False
        with self._icond:
            if self._iwaiting > 0:
                deadline = time.monotonic() + timeout
                while self._iwaiting > 0:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._icond.wait(left)
                yielded = True
        if yielded:
            self.preemptions += 1
        return yielded


class _LaneOccupancy:
    """One dispatch's hold of a lane.  With tracing armed and a frame trace
    current on the thread, the wait for the lane gate is the frame's
    `stage` span and the hold itself its `dispatch` span (reference
    ``:1388-1416``)."""

    __slots__ = ("_lane", "_n", "_cls", "_nbytes", "_stream", "_gate",
                 "_prev_stream", "_prev_position", "_tcur", "_tmark")

    def __init__(self, lane: DeviceLane, n_items: int,
                 qos_class: Optional[str] = None, nbytes: int = 0):
        self._lane = lane
        self._n = n_items
        self._cls = qos_class
        self._nbytes = nbytes
        # stream selection: the interactive stream only with preemption
        # armed; disarmed, everything serializes through the bulk gate
        if qos_class == "interactive" and _preempt:
            self._stream = "interactive"
            self._gate = lane._igate
        else:
            self._stream = "bulk"
            self._gate = lane._gate
        self._prev_stream = None
        self._prev_position = None
        self._tcur = None
        self._tmark = 0.0

    def __enter__(self) -> DeviceLane:
        # the dispatch chokepoint of the chaos plane: consulted before any
        # ledger entry, so an injected launch failure unwinds with nothing
        # to undo (__exit__ never runs when __enter__ raises)
        plane = _net._fault_plane
        if plane is not None:
            try:
                plane.on_device_dispatch(self._lane.dev_id)
            except BaseException as e:
                self._lane.note_fault("kernel_launch")
                mark_fault_noted(e)
                raise
        if self._cls is not None:
            self._lane.qos.enter(self._cls, self._n, self._nbytes)
        self._lane.qos.stream_enter(self._stream, self._n)
        if self._stream == "interactive":
            # seen by preempt_point from the moment the dispatch queues on
            # the interactive gate, not only once it holds it
            self._lane._ienter()
        if _obs._tracer is not None:
            self._tcur = _obs.current_trace()
        if self._tcur is not None:
            # `stage` = time queued behind the lane gate (ahead of the
            # card); the occupancy hold becomes the `dispatch` span
            t0 = time.monotonic()
            self._gate.acquire()
            self._tmark = time.monotonic()
            self._tcur.add_span(
                "stage", t0, self._tmark,
                device=self._lane.dev_id, items=self._n,
                nbytes=self._nbytes, stream=self._stream,
            )
        else:
            self._gate.acquire()
        self._prev_stream = getattr(_stream_tls, "stream", None)
        _stream_tls.stream = self._stream
        self._prev_position = getattr(_stream_tls, "position", None)
        _stream_tls.position = self._lane.dev_id
        self._lane._laneset._enter()
        self._lane.dispatches += 1
        return self._lane

    def __exit__(self, *exc):
        try:
            ns = _replica_ns_per_item
            if ns is not None and self._n > 0:
                time.sleep(self._n * ns * 1e-9)
        finally:
            if self._tcur is not None:
                self._tcur.add_span(
                    "dispatch", self._tmark, time.monotonic(),
                    device=self._lane.dev_id, items=self._n,
                    nbytes=self._nbytes, stream=self._stream,
                )
            self._lane._laneset._exit()
            _stream_tls.stream = self._prev_stream
            _stream_tls.position = self._prev_position
            self._gate.release()
            if self._stream == "interactive":
                self._lane._iexit()
            self._lane.qos.stream_exit(self._stream, self._n)
            if self._cls is not None:
                self._lane.qos.exit(self._cls, self._n, self._nbytes)
        return False


# every live LaneSet, weakly held (reference ``core/ioplane.py:1185``):
# device faults observed where no lane reference exists (ReadbackFuture,
# the grouped fetch, the registry, a bank's growth) are attributed here
_LANE_SETS: "weakref.WeakSet" = weakref.WeakSet()


def note_device_fault(dev_id: int, kind: str) -> bool:
    """Attribute one device fault to every registered lane for position
    `dev_id`; returns True when any lane newly flipped to QUARANTINED."""
    tripped = False
    for ls in list(_LANE_SETS):
        lane = ls._lanes.get(dev_id)
        if lane is not None and lane.note_fault(kind):
            tripped = True
    return tripped


def note_device_ok(dev_id: int) -> None:
    """A readback on position `dev_id` completed cleanly: reset its lanes'
    consecutive-fault streaks (quarantine itself clears only via probe)."""
    for ls in list(_LANE_SETS):
        lane = ls._lanes.get(dev_id)
        if lane is not None:
            lane.note_ok()


def quarantined_device_ids() -> set:
    """Position ids currently quarantined on ANY live lane set."""
    out = set()
    for ls in list(_LANE_SETS):
        for dev_id, lane in list(ls._lanes.items()):
            if lane.quarantined:
                out.add(dev_id)
    return out


class LaneSet:
    """The engine's per-position lane registry and cross-lane concurrency
    accounting (``peak_concurrent`` > 1 shows that frames routed to
    different positions dispatched at the same time)."""

    def __init__(self, devices: Sequence[Any], depth: int = 2):
        self._lanes = {
            getattr(d, "id", i): DeviceLane(d, self, depth=depth)
            for i, d in enumerate(devices)
        }
        self._lock = threading.Lock()
        self._active = 0
        self.peak_concurrent = 0
        _LANE_SETS.add(self)

    def lane(self, device) -> DeviceLane:
        dev_id = device if isinstance(device, int) else getattr(device, "id", 0)
        lane = self._lanes.get(dev_id)
        if lane is None:  # unknown position (placement grew): a lane for it
            with self._lock:
                lane = self._lanes.get(dev_id)
                if lane is None:
                    lane = self._lanes[dev_id] = DeviceLane(device, self)
        return lane

    def lanes(self) -> List[DeviceLane]:
        return list(self._lanes.values())

    def _enter(self) -> None:
        with self._lock:
            self._active += 1
            if self._active > self.peak_concurrent:
                self.peak_concurrent = self._active

    def _exit(self) -> None:
        with self._lock:
            self._active -= 1

    def active(self) -> int:
        with self._lock:
            return self._active

    def reset_concurrency(self) -> int:
        with self._lock:
            prev, self.peak_concurrent = self.peak_concurrent, 0
            return prev

    def census(self) -> dict:
        """Flat gauges: staging slots and in-flight dispatches return to
        their baseline after a storm."""
        out = {"lanes": len(self._lanes), "active_dispatches": self.active()}
        for dev_id, lane in sorted(self._lanes.items()):
            out[f"lane{dev_id}_staging_slots"] = lane.pool.slot_count()
            out[f"lane{dev_id}_istaging_slots"] = lane.ipool.slot_count()
            out[f"lane{dev_id}_iwaiting"] = lane.interactive_waiting()
            out[f"lane{dev_id}_quarantined"] = int(lane.quarantined)
            out[f"lane{dev_id}_consec_faults"] = lane.consec_faults
            out.update(lane.qos.census(prefix=f"lane{dev_id}_qos"))
        return out

    def clear(self) -> None:
        for lane in self._lanes.values():
            lane.pool.clear()
            lane.ipool.clear()
            lane.pipeline.drain()
            lane.ipipeline.drain()
