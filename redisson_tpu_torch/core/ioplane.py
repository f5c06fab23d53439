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
their own cards' streams and overlap there.  The lane fault counters
(``consec_faults``, ``total_faults``, ``quarantined``) are fields that stay
0 until the operations slice's fault plane (the reference's chaos stall,
lane watchdog and quarantine) sets them.  ``scatter_host_arrays`` waits for
the operations slice.

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

``FlushPipeline``'s window deadline defaults to ``window_deadline()``
(``CONFIG SET qos-interactive-deadline-ms``).  ``STATS.sharded_knn_merges``
counts the sharded vector banks' on-device merges (K19).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

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


# which lane stream the current thread's dispatch occupies ("interactive"
# while an interactive occupancy is held): Engine.staging_pool reads it to
# hand the interactive dispatch its own staging slot
_stream_tls = threading.local()


def current_stream() -> Optional[str]:
    return getattr(_stream_tls, "stream", None)


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
    returned, so holding it is safe."""

    __slots__ = ("_device", "_event", "_finish", "_value", "_error", "_done")

    def __init__(self, device: Sequence[Any], finish: Optional[Callable] = None):
        self._device: tuple = tuple(device)
        devs = {v.device for v in self._device if isinstance(v, torch.Tensor)}
        self._event = record_event(next(iter(devs))) if len(devs) == 1 else None
        self._finish = finish
        self._value = None
        self._error: Optional[BaseException] = None
        self._done = False

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

    def result(self):
        if not self._done:
            was_ready = self.ready()
            t0 = time.perf_counter()
            try:
                host = tuple(_to_host(v) for v in self._device)
            except Exception as e:  # noqa: BLE001 — surfaced below
                STATS.add_readback(time.perf_counter() - t0, was_ready)
                self._error = e
                self._done = True
                self._device = ()
            else:
                STATS.add_readback(time.perf_counter() - t0, was_ready)
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


def gather_device_results(groups: Sequence[Sequence[Any]]) -> List[tuple]:
    """Fetch every device value of `groups` with ONE device->host transfer
    per device: view each value as a contiguous uint8 stream, concatenate
    them on the device, copy the merged stream once, then split and
    reinterpret each piece on the host.  numpy values pass through."""
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
    for device, fis in buckets.items():
        parts = [flat[fi] for fi in fis]
        STATS.count_sync()
        device_stats(device).count_sync()
        merged = _fetch(device, parts)
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


def force_all(futures: Sequence[ReadbackFuture]) -> None:
    """Materialize several ReadbackFutures with ONE grouped transfer (the
    embedded Batch drains its pending groups through here)."""
    todo = [f for f in futures if not f.done()]
    if not todo:
        return
    try:
        host_groups = gather_device_results([f._device for f in todo])
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
    the copy made from it and frees it.  acquire prefers a free slot whose
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

    def acquire(self, shape, dtype=np.uint32) -> Tuple[np.ndarray, Optional[_StageSlot]]:
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
            return np.zeros(shape, dtype), None
        staged, slot.staged = slot.staged, None
        if staged is not None and not staged.query():
            # the double-buffer boundary: the slot's previous copy is still
            # in flight — wait (counted) before touching its bytes
            STATS.count_staging_wait()
            staged.synchronize()
        if slot.buf.nbytes < want:
            self._grow(slot, max(want, 1))
        view = slot.buf[:want].view(dtype).reshape(shape)
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
    fails retryably (-TRYAGAIN) instead of wedging its writer.  Raised by
    the operations slice's lane watchdog; the lanes here never arm it."""


def is_retryable_device_fault(e: BaseException) -> bool:
    """The failure shapes the server's dispatch layer converts to a clean
    retryable ``-TRYAGAIN``: the lane-watchdog timeout, and a RuntimeError
    whose message starts with one of the reference's transient-runtime
    prefixes.  Matched on the message, never the class.  A CUDA error
    matches none of them and replies ``ERR internal``; mapping CUDA failures
    onto retry and ``-OOM`` belongs to the operations slice."""
    if isinstance(e, LaneWatchdogTimeout):
        return True
    if not isinstance(e, RuntimeError):
        return False
    return str(e).lstrip().startswith(
        ("INTERNAL", "UNAVAILABLE", "ABORTED", "CANCELLED",
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
        # fault ledger: set by the operations slice's fault plane; 0 here
        self.consec_faults = 0
        self.total_faults = 0
        self.quarantined = False
        self.last_fault_kind = ""

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
    __slots__ = ("_lane", "_n", "_cls", "_nbytes", "_stream", "_gate",
                 "_prev_stream")

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

    def __enter__(self) -> DeviceLane:
        if self._cls is not None:
            self._lane.qos.enter(self._cls, self._n, self._nbytes)
        self._lane.qos.stream_enter(self._stream, self._n)
        if self._stream == "interactive":
            # seen by preempt_point from the moment the dispatch queues on
            # the interactive gate, not only once it holds it
            self._lane._ienter()
        self._gate.acquire()
        self._prev_stream = getattr(_stream_tls, "stream", None)
        _stream_tls.stream = self._stream
        self._lane._laneset._enter()
        self._lane.dispatches += 1
        return self._lane

    def __exit__(self, *exc):
        try:
            ns = _replica_ns_per_item
            if ns is not None and self._n > 0:
                time.sleep(self._n * ns * 1e-9)
        finally:
            self._lane._laneset._exit()
            _stream_tls.stream = self._prev_stream
            self._gate.release()
            if self._stream == "interactive":
                self._lane._iexit()
            self._lane.qos.stream_exit(self._stream, self._n)
            if self._cls is not None:
                self._lane.qos.exit(self._cls, self._n, self._nbytes)
        return False


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
