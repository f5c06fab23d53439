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

Not ported here: ``FlushPipeline``, ``DeviceLane`` and ``LaneSet`` (the
lanes of multi-device serving), and the device fault plane of the reference
(its chaos stall, lane watchdog and quarantine), which belongs to the
operations slice; ``colocate`` and ``scatter_host_arrays`` wait for the
slices that use them.
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


# -- blocking-sync + readback accounting --------------------------------------


class IOStats:
    """Process-global counters for the plane's observable costs.

    ``blocking_syncs`` counts every host-side wait on device work the plane
    performs (staging waits, forced readbacks, grouped gathers).
    ``readback_exposed_s`` accumulates only the readback wall time spent
    while the device value was not yet ready (the part not hidden)."""

    __slots__ = ("_lock", "blocking_syncs", "readbacks", "readback_wait_s",
                 "readback_exposed_s", "staging_waits")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.blocking_syncs = 0
        self.readbacks = 0
        self.readback_wait_s = 0.0
        self.readback_exposed_s = 0.0
        self.staging_waits = 0

    def count_sync(self, n: int = 1) -> None:
        with self._lock:
            self.blocking_syncs += n

    def count_staging_wait(self) -> None:
        with self._lock:
            self.blocking_syncs += 1
            self.staging_waits += 1

    def add_readback(self, wall_s: float, was_ready: bool) -> None:
        with self._lock:
            self.blocking_syncs += 1
            self.readbacks += 1
            self.readback_wait_s += wall_s
            if not was_ready:
                self.readback_exposed_s += wall_s

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "blocking_syncs": self.blocking_syncs,
                "readbacks": self.readbacks,
                "readback_wait_s": self.readback_wait_s,
                "readback_exposed_s": self.readback_exposed_s,
                "staging_waits": self.staging_waits,
            }


STATS = IOStats()


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


def is_retryable_device_fault(e: BaseException) -> bool:
    """The failure shapes the server's dispatch layer converts to a clean
    retryable ``-TRYAGAIN``: a RuntimeError whose message starts with one of
    the reference's transient-runtime prefixes.  Matched on the message,
    never the class.  A CUDA error matches none of them and replies
    ``ERR internal``; mapping CUDA failures onto retry and ``-OOM`` belongs
    to the operations slice."""
    if not isinstance(e, RuntimeError):
        return False
    return str(e).lstrip().startswith(
        ("INTERNAL", "UNAVAILABLE", "ABORTED", "CANCELLED",
         "DEADLINE_EXCEEDED")
    )


# -- per-class QoS in-flight ledger --------------------------------------------


class QosLedger:
    """Per-deadline-class in-flight accounting: one global ledger on the
    server's WindowScheduler.  Every ``enter`` must be paired with an
    ``exit``: the server's metrics gauges read the in-flight rows.  (The
    reference also keeps one a device lane, with per-stream rows; lanes
    come with the multi-device slice.)"""

    __slots__ = ("_lock", "frames", "ops", "nbytes", "waiting")

    _CLASSES = ("interactive", "bulk")

    def __init__(self):
        self._lock = threading.Lock()
        self.frames = {c: 0 for c in self._CLASSES}
        self.ops = {c: 0 for c in self._CLASSES}
        self.nbytes = {c: 0 for c in self._CLASSES}
        self.waiting = 0  # bulk frames parked at the admission gate

    @classmethod
    def _cls(cls, qos_class: str) -> str:
        return qos_class if qos_class in cls._CLASSES else "bulk"

    def enter(self, qos_class: str, ops: int, nbytes: int = 0) -> None:
        c = self._cls(qos_class)
        with self._lock:
            self.frames[c] += 1
            self.ops[c] += ops
            self.nbytes[c] += nbytes

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
