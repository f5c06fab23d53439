"""Deterministic fault plane: the transport, storage and device faults.

A copy of ``redisson_tpu/chaos/faults.py``: the same seed gives the same
faulted event indices in both packages.  The device faults raise CUDA's
shapes in place of XLA's.

Design constraints:

  * **Seeded and deterministic** — every random choice is drawn from
    ``random.Random(seed)`` at schedule BUILD time (`add_random`), never at
    injection time.  Which event indices fault is a pure function of the
    seed; assertions count injections (`FaultPlane.injected`, per-rule
    `Fault.hits`), never wall clocks.
  * **Through the real layers, not around them** — the plane is consulted
    by ``net/client.py`` ``Connection`` at its three event sites (connect,
    send, recv) and manifests faults as the SAME exception types real
    infrastructure produces, so ``NodeClient``'s retry machinery, pool
    discard, ``ConnectionEventsHub`` edges, and the ``net/detectors.py``
    failure detectors are all exercised, never bypassed:

      - ``refuse_connect``  → ``ConnectionRefusedError`` before the socket
        exists (detector ``on_connect_failed``);
      - ``drop``            → connection closed + ``OSError`` on send
        (detector ``on_command_failed``);
      - ``delay``           → bounded sleep before the frame transmits;
      - ``truncate``        → reply cut mid-frame, then the socket dies
        (parser holds a partial frame; detector ``on_command_failed``);
      - ``partition_out``   → frame silently never leaves (reply timeout,
        detector ``on_command_timeout`` — a one-way partition, outbound);
      - ``partition_in``    → reply silently never arrives (same timeout
        path — a one-way partition, inbound).

**DCN-level partitions**: a one-way partition of a host GROUP —
a rule with ``ports=(p1, p2, ...)`` matches every node in the group and is
counted on the group's own combined event stream, so "the second send to
either DCN-B node is swallowed" is expressible (a per-port rule can't say
that; a global rule also faults intra-group traffic).  Build one with
``FaultSchedule.add_dcn_partition``.

**Storage faults**: the persistence plane (``core/checkpoint``)
consults the SAME installed plane at its two file-I/O event sites:

      - ``enospc``      → ``OSError(ENOSPC)`` raised on the snapshot write;
      - ``torn_write``  → only the first ``torn_at`` bytes (or
        ``torn_frac`` of them) reach the file, but the write REPORTS
        success — the media-lied/power-loss model whose corruption only the
        CRC32 trailer catches at the next load;
      - ``fsync_fail``  → ``OSError(EIO)`` from fsync.

**Device faults**: the device plane (``core/ioplane`` lanes,
``services/vector`` bank growth, ``server/registry`` dispatch) consults the
SAME installed plane at three per-position event sites: the "port" of a
device rule is the mesh position's id, so "kill position 1's third
dispatch" is one ``add("device_kernel", port=1, after=2)``.  The faults
take the shapes CUDA's runtime gives PyTorch:

      - ``device_kernel``  → the dispatch raises ``torch.AcceleratorError``
        with the text of a failed launch (``CUDA error: unspecified launch
        failure``), which ``ioplane.is_retryable_device_fault`` classes
        retryable;
      - ``device_oom``     → an allocation raises ``torch.OutOfMemoryError``
        (``CUDA out of memory. Tried to allocate N bytes``), the class the
        caching allocator raises when the card's memory is exhausted;
      - ``device_hang``    → the readback stalls for ``delay_s`` seconds on
        the host (the hung-DMA model; with the lane watchdog armed the
        stall trips ``LaneWatchdogTimeout``, with it off the transfer just
        takes that long, bounded so tests terminate).  The stall is per
        position, as the reference's is per device, though positions of
        one card share its stream.

Server/coordinator-layer faults (kill / pause / restart a node, stall the
replication stream) live on ``harness.ClusterRunner`` and
``server/replication.ReplicationSource`` — see ``pause_node`` /
``stall_replication`` there; ``server/monitor.HAFailoverCoordinator.kill``
is the coordinator-crash hook; ``server/migration.migrate_slots``'s
``crash_after=`` is the kill-the-migration-coordinator hook.
"""
from __future__ import annotations

import errno
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from redisson_tpu_torch.net import client as _net

# fault kind -> the event stream it rides (connect/send/recv are
# net/client.py Connection sites; storage_* are core/checkpoint.py sites)
_STREAM = {
    "refuse_connect": "connect",
    "drop": "send",
    "delay": "send",
    "partition_out": "send",
    "truncate": "recv",
    "partition_in": "recv",
    "enospc": "storage_write",
    "torn_write": "storage_write",
    "fsync_fail": "storage_fsync",
    "device_kernel": "device_dispatch",
    "device_oom": "device_alloc",
    "device_hang": "device_readback",
}

KINDS = tuple(_STREAM)


def _cuda_launch_error(text: str) -> RuntimeError:
    """The exception torch raises for a failed kernel launch:
    ``torch.AcceleratorError`` (a RuntimeError), or a plain RuntimeError
    with the same text on a torch that lacks the class.  The classifier
    matches either (``ioplane.is_retryable_device_fault``)."""
    cls = getattr(torch, "AcceleratorError", RuntimeError)
    return cls(text)


def _cuda_oom_error(text: str) -> RuntimeError:
    """The exception the caching allocator raises when the card's memory
    is exhausted: ``torch.OutOfMemoryError`` (a RuntimeError)."""
    return torch.OutOfMemoryError(text)


@dataclass
class Fault:
    """One injection rule: fault the matching event stream for the window
    ``[after, after + count)``, counted per-port when ``port`` is set,
    per-GROUP when ``ports`` is set (DCN-level: the rule's window indexes
    the group's combined stream), else over the global stream."""

    kind: str
    port: Optional[int] = None  # None matches every node
    after: int = 0
    count: int = 1
    delay_s: float = 0.05  # kind == "delay" only
    ports: Optional[Tuple[int, ...]] = None  # host GROUP (DCN partition)
    torn_at: Optional[int] = None  # kind == "torn_write": cut at byte k...
    torn_frac: float = 0.5         # ...or at this fraction when torn_at unset
    hits: int = 0          # events this rule actually faulted

    def __post_init__(self):
        if self.kind not in _STREAM:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.ports is not None:
            if self.port is not None:
                raise ValueError("port= and ports= are mutually exclusive")
            self.ports = tuple(sorted(set(self.ports)))

    @property
    def stream(self) -> str:
        return _STREAM[self.kind]


class FaultSchedule:
    """A seeded, deterministic fault program: an ordered rule list.

    ``add`` places a rule at explicit event indices; ``add_random`` draws
    the indices from the schedule's seeded RNG **now** (build time), so two
    schedules built with the same seed and the same call sequence are
    byte-identical programs."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self.faults: List[Fault] = []

    def add(self, kind: str, port: Optional[int] = None, after: int = 0,
            count: int = 1, delay_s: float = 0.05,
            ports: Optional[Sequence[int]] = None,
            torn_at: Optional[int] = None, torn_frac: float = 0.5) -> Fault:
        f = Fault(kind, port=port, after=after, count=count, delay_s=delay_s,
                  ports=tuple(ports) if ports is not None else None,
                  torn_at=torn_at, torn_frac=torn_frac)
        self.faults.append(f)
        return f

    def add_dcn_partition(self, ports: Sequence[int], direction: str = "out",
                          after: int = 0, count: int = 1) -> Fault:
        """One-way partition of a host GROUP (the DCN-level scenario: one
        datacenter's uplink dies in ONE direction).  ``direction="out"``
        swallows frames TO any node in the group; ``"in"`` swallows replies
        FROM them.  The window ``[after, after+count)`` indexes the group's
        combined event stream, so the program stays deterministic no matter
        how traffic interleaves across the group's nodes."""
        if direction not in ("out", "in"):
            raise ValueError("direction must be 'out' or 'in'")
        return self.add(
            "partition_out" if direction == "out" else "partition_in",
            ports=ports, after=after, count=count,
        )

    def add_random(self, kind: str, port: Optional[int] = None, n: int = 1,
                   window: int = 100, delay_s: float = 0.05) -> "FaultSchedule":
        """`n` single-event faults at seed-deterministic indices in
        ``[0, window)`` of the matching stream."""
        for i in sorted(self._rng.sample(range(window), min(n, window))):
            self.add(kind, port=port, after=i, count=1, delay_s=delay_s)
        return self

    def plane(self) -> "FaultPlane":
        return FaultPlane(self)


class FaultPlane:
    """The compiled injector ``net/client.py`` consults.  Thread-safe;
    event counters live here (per stream globally + per (stream, port)),
    so one plane serves every connection of the process."""

    def __init__(self, schedule: Optional[FaultSchedule] = None,
                 exempt_thread_prefixes: Tuple[str, ...] = (
                     "rtpu-failover", "rtpu-ha-failover",
                 )):
        self.schedule = schedule or FaultSchedule()
        # the failover coordinator's OWN probe/promotion links are exempt by
        # default: faulting the failure detector's ground truth makes it
        # declare healthy masters dead, and an unplanned failover of a
        # healthy master loses its unshipped async-replication tail — a real
        # Redis-sentinel semantic, but one that makes zero-acked-write-loss
        # unassertable.  Chaos targets the data plane; pass () to fault the
        # control plane too (and relax the loss assertion accordingly).
        self.exempt_thread_prefixes = tuple(exempt_thread_prefixes)
        self._lock = threading.Lock()
        self._counts: Dict[tuple, int] = {}
        self.injected: Dict[str, int] = {}  # kind -> total injections

    # -- event matching ------------------------------------------------------

    def _on_event(self, stream: str, port: int) -> Optional[Fault]:
        if self.exempt_thread_prefixes and threading.current_thread().name.startswith(
            self.exempt_thread_prefixes
        ):
            return None  # not counted either: exempt streams must not shift
            # the deterministic event indices of the faulted ones
        with self._lock:
            n_global = self._counts.get((stream, None), 0)
            n_port = self._counts.get((stream, port), 0)
            self._counts[(stream, None)] = n_global + 1
            self._counts[(stream, port)] = n_port + 1
            # host-GROUP streams (DCN rules): one combined counter per
            # distinct group this event belongs to, bumped once per event
            # even when several rules share the group
            n_groups: Dict[Tuple[int, ...], int] = {}
            for f in self.schedule.faults:
                if (f.stream == stream and f.ports is not None
                        and port in f.ports and f.ports not in n_groups):
                    n = self._counts.get((stream, f.ports), 0)
                    n_groups[f.ports] = n
                    self._counts[(stream, f.ports)] = n + 1
            for f in self.schedule.faults:
                if f.stream != stream:
                    continue
                if f.ports is not None:
                    if port not in f.ports:
                        continue
                    n = n_groups[f.ports]
                elif f.port is None:
                    n = n_global
                elif f.port == port:
                    n = n_port
                else:
                    continue
                if f.after <= n < f.after + f.count:
                    f.hits += 1
                    self.injected[f.kind] = self.injected.get(f.kind, 0) + 1
                    return f
        return None

    def _on_storage_event(self, stream: str) -> Optional[Fault]:
        """Storage faults are port-less: one global event stream per site
        (indices count snapshot writes/fsyncs, not bytes)."""
        with self._lock:
            n = self._counts.get((stream, None), 0)
            self._counts[(stream, None)] = n + 1
            for f in self.schedule.faults:
                if f.stream != stream:
                    continue
                if f.after <= n < f.after + f.count:
                    f.hits += 1
                    self.injected[f.kind] = self.injected.get(f.kind, 0) + 1
                    return f
        return None

    def events(self, stream: str, port: Optional[int] = None) -> int:
        """Events observed on a stream (globally, or for one port)."""
        with self._lock:
            return self._counts.get((stream, port), 0)

    # -- hooks (net/client.py Connection) ------------------------------------

    def on_connect(self, host: str, port: int) -> None:
        f = self._on_event("connect", port)
        if f is not None and f.kind == "refuse_connect":
            raise ConnectionRefusedError(
                f"[chaos] refused connect to {host}:{port}"
            )

    def on_send(self, conn) -> bool:
        """True → transmit the frame; False → swallow it (outbound
        partition).  May raise (drop) or sleep (delay)."""
        f = self._on_event("send", conn.port)
        if f is None:
            return True
        if f.kind == "delay":
            time.sleep(f.delay_s)
            return True
        if f.kind == "drop":
            conn.close()
            raise OSError(f"[chaos] dropped connection to {conn.host}:{conn.port}")
        if f.kind == "partition_out":
            return False
        return True

    def on_recv(self, conn, data: bytes) -> Optional[bytes]:
        """Returns the bytes to feed the parser (possibly truncated), or
        None to swallow the chunk entirely (inbound partition)."""
        f = self._on_event("recv", conn.port)
        if f is None:
            return data
        if f.kind == "truncate":
            conn.close()  # mid-reply cut: partial frame, then a dead socket
            return data[: len(data) // 2]
        if f.kind == "partition_in":
            return None
        return data

    # -- hooks (core/checkpoint.py storage plane) -----------------------------

    def on_storage_write(self, path: str, data: bytes) -> bytes:
        """Returns the bytes that actually reach stable storage.  May raise
        ``OSError(ENOSPC)`` (disk full) or return a PREFIX of ``data``
        (torn write: the write call reports success but only the head
        landed — the power-loss/media-lied model the CRC32 trailer exists
        to catch)."""
        f = self._on_storage_event("storage_write")
        if f is None:
            return data
        if f.kind == "enospc":
            raise OSError(
                errno.ENOSPC, f"[chaos] No space left on device writing {path!r}"
            )
        if f.kind == "torn_write":
            k = f.torn_at if f.torn_at is not None else int(len(data) * f.torn_frac)
            return data[: max(0, min(k, len(data)))]
        return data

    def on_storage_fsync(self, path: str) -> None:
        """May raise ``OSError(EIO)`` — the fsync-failure mode where the
        kernel reports the flush failed and the caller must treat the file
        as suspect (a failed save, never a silently-accepted one)."""
        f = self._on_storage_event("storage_fsync")
        if f is not None and f.kind == "fsync_fail":
            raise OSError(errno.EIO, f"[chaos] fsync failed for {path!r}")

    # -- hooks (core/ioplane.py device plane) ---------------------------------

    def on_device_dispatch(self, dev_id: int) -> None:
        """May raise the failed-launch ``torch.AcceleratorError`` shape.
        The event stream counts dispatches per position (the rule's
        ``port`` is the position id)."""
        f = self._on_event("device_dispatch", int(dev_id))
        if f is not None and f.kind == "device_kernel":
            raise _cuda_launch_error(
                f"CUDA error: unspecified launch failure "
                f"([chaos] injected on position {dev_id})"
            )

    def on_device_alloc(self, dev_id: int, nbytes: int = 0) -> None:
        """May raise the ``torch.OutOfMemoryError`` shape on a bank
        create/grow allocation (the rule's ``port`` is the position id)."""
        f = self._on_event("device_alloc", int(dev_id))
        if f is not None and f.kind == "device_oom":
            raise _cuda_oom_error(
                f"CUDA out of memory. Tried to allocate {int(nbytes)} bytes "
                f"([chaos] injected on position {dev_id})"
            )

    def on_device_readback(self, dev_id: int) -> float:
        """Returns the stall (seconds) a hung transfer injects on this
        position's readback, 0.0 when unmatched.  The CALLER owns sleeping/raising —
        the lane watchdog bounds the wait instead of this hook wedging the
        writer task from inside the chaos plane."""
        f = self._on_event("device_readback", int(dev_id))
        if f is not None and f.kind == "device_hang":
            return float(f.delay_s)
        return 0.0

    # -- lifecycle -----------------------------------------------------------

    def install(self):
        """Install process-globally; returns the previous plane."""
        return _net.install_fault_plane(self)

    @contextmanager
    def active(self):
        """Context manager: install on enter, restore the prior plane on
        exit (exception-safe — a failing test never leaks chaos into the
        next one)."""
        prev = _net.install_fault_plane(self)
        try:
            yield self
        finally:
            _net.install_fault_plane(prev)
