"""DeviceStore: the registry of named device-resident states.

Every object handle is stateless; its state lives here as a StateRecord
holding tensors (or, for the bucket family, host values) plus metadata
(kind, logical sizes, hash version), keyed by name.  Compound mutations run
under the engine's per-record locks (core/engine.py ``locked`` /
``locked_many``), so each object has one writer at a time.  Kernels update the record's tensors in place, or install a new
tensor where they write out of place (the HLL merges).

A copy of ``redisson_tpu/core/store.py``.  The public getters (``get``,
``get_or_create`` and what reads through them) are the residency plane's
fault-in chokepoint: a WARM or COLD record (``core/residency.py``) is
promoted back to HOT there, after the store lock is released; the
``*_unguarded`` accessors and ``census_records`` never promote.  With
placement on, ``placement_hook`` runs at every install (get_or_create's
new record, put, put_unguarded) and at a RENAME: it names the record's
owner position (``StateRecord.position``) and commits its tensors to that
position's card.  ``claim`` is the stream handoff of a placement over
cards (``core/ioplane.py``, "Streams"): every getter calls it on the
record it returns, and a reader that walks ``_states`` itself calls it
before it reads a record's tensors.  ``absent_guard`` is the slot-migration
window's hook: the server installs one that ASK-redirects any touch of an
ABSENT name in a MIGRATING slot; the ``*_unguarded`` accessors bypass it
for transfer frames (migration and replication) and the vector banks' own
records.  ``on_expired`` is the reference's hook: the server's tracking
table hears of every record the store drops as expired, lazily on access
or in the engine's ``reap_expired`` sweep.
"""
from __future__ import annotations

import fnmatch
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from redisson_tpu_torch.core import residency as _res


@dataclass
class StateRecord:
    kind: str                       # "bloom" | "hll" | "bitset" | "bucket" | ...
    meta: Dict[str, Any] = field(default_factory=dict)
    arrays: Dict[str, Any] = field(default_factory=dict)  # name -> torch.Tensor
    host: Any = None                # host-side python state (dict/list/...)
    version: int = 0                # bumped on every mutation
    expire_at: Optional[float] = None  # epoch seconds, None = persistent
    # creation identity: versions restart at 0 when a name is deleted and
    # recreated, so a cache keyed on the record (the word count's scan views)
    # compares (nonce, version), not the version alone
    nonce: int = field(default_factory=lambda: secrets.randbits(63))
    # the mesh position that owns the record (its slot's, with placement on;
    # server/placement.py), else None
    position: Optional[int] = None
    # residency plane: HOT = tensors on the device, WARM = tensors released
    # with the exact host bytes in `stash`, COLD = stash spilled to the
    # verified container at `cold_path`.  The tier moves only under the
    # record lock and the manager's transition lock; version does NOT bump
    # on a tier change (the content is the same, so replication and
    # migration do not re-ship a demoted record).
    tier: str = _res.HOT
    stash: Optional[Dict[str, Any]] = None   # WARM host mirror (numpy)
    stash_dev: int = -1                      # ledger key the tensors left
    cold_path: Optional[str] = None          # COLD spill file
    cold_bytes: int = 0                      # spilled host bytes (census)
    # the CUDA stream that last used the record's tensors (a lane's, or a
    # card's default stream), with placement over cards; None elsewhere
    stream: Any = field(default=None, repr=False, compare=False)

    def expired(self, now: Optional[float] = None) -> bool:
        return self.expire_at is not None and (now or time.time()) >= self.expire_at


class DeviceStore:
    """Thread-safe name -> StateRecord registry with TTL semantics: expired
    entries read as absent and are dropped when touched."""

    def __init__(self):
        self._lock = threading.RLock()
        self._states: Dict[str, StateRecord] = {}
        # Called with a name whenever an ABSENT name is touched: created
        # (get_or_create / put) or read/deleted as missing (get / delete).
        # The migration window installs one that ASK-redirects absent names
        # in MIGRATING slots: creations must happen on the target, and a
        # record the drain just moved must redirect rather than read as nil
        # (server/server.py _migration_absent_guard).
        self.absent_guard: Optional[Callable[[str], None]] = None
        # Called with the NAMES of expired records the store just dropped.
        # It must not reenter the store: lazy expiry fires it while the
        # store lock is held.
        self.on_expired: Optional[Callable[[list], None]] = None
        # placement hook: called with (name, record) at every install so a
        # placement-enabled engine names the owner position of the record,
        # and with (new name, record, True) at a rename
        self.placement_hook: Optional[Callable[..., None]] = None
        # stream handoff: called with a record before its tensors are used
        # on the thread's current stream (``claim``); None = one stream
        self.stream_hook: Optional[Callable[[StateRecord], None]] = None
        # the residency manager (Engine.enable_residency): the armed
        # `_res._tier_plane` guard routes getter touches here, so several
        # engines in one process never cross-wire.  None = no tiering even
        # while the process-global plane is armed.
        self.residency = None

    def _placed(self, name: str, rec: StateRecord) -> StateRecord:
        if self.placement_hook is not None:
            self.placement_hook(name, rec)
        return rec

    def claim(self, rec: Optional[StateRecord]) -> None:
        """Hand `rec` to the current thread's stream on its card: that
        stream waits for the work queued where the record was last used,
        and its tensors are marked used there, so whoever drops them later
        returns their memory only after both streams passed.  A no-op with
        one stream (no hook)."""
        hook = self.stream_hook
        if hook is not None and rec is not None:
            hook(rec)

    def _reaped(self, name: str) -> None:
        if self.on_expired is not None:
            try:
                self.on_expired([name])
            except Exception:  # noqa: BLE001 — expiry must never fail a read
                pass

    def _live_locked(self, name: str) -> Optional[StateRecord]:
        rec = self._states.get(name)
        if rec is not None and rec.expired():
            del self._states[name]
            rec = None
            self._reaped(name)
        self.claim(rec)
        return rec

    def _get_locked(self, name: str) -> Optional[StateRecord]:
        rec = self._live_locked(name)
        if rec is None and self.absent_guard is not None:
            self.absent_guard(name)
        return rec

    def get(self, name: str) -> Optional[StateRecord]:
        with self._lock:
            rec = self._get_locked(name)
        # the fault-in chokepoint: a WARM/COLD record promotes back to HOT
        # here, OUTSIDE the store lock (promotion takes the record lock and
        # the owner lane's gate).  Disarmed cost: one module-global load
        # and an is-None test.
        plane = _res._tier_plane
        if plane is not None and rec is not None:
            plane.on_record_access(self, name, rec)
        return rec

    def get_or_create(self, name: str, kind: str,
                      factory: Callable[[], StateRecord]) -> StateRecord:
        with self._lock:
            rec = self._get_locked(name)  # the absent guard raises in a window
            if rec is None:
                rec = factory()
                if rec.kind != kind:
                    raise TypeError(f"factory made a {rec.kind}, expected {kind}")
                self._states[name] = self._placed(name, rec)
            elif rec.kind != kind:
                raise TypeError(
                    f"object '{name}' holds a {rec.kind}, requested {kind} "
                    "(WRONGTYPE in the reference)"
                )
        plane = _res._tier_plane
        if plane is not None and rec is not None:
            plane.on_record_access(self, name, rec)
        return rec

    def put(self, name: str, rec: StateRecord) -> None:
        with self._lock:
            # an expired entry is absent: recreating it in a MIGRATING slot
            # must ASK-redirect as get/get_or_create would
            cur = self._states.get(name)
            if (cur is None or cur.expired()) and self.absent_guard is not None:
                self.absent_guard(name)
            self._states[name] = self._placed(name, rec)

    def put_unguarded(self, name: str, rec: StateRecord) -> None:
        """Install bypassing the absent guard: ONLY for migration and
        replication transfer frames, which create records in windowed slots
        (the importing side) or overwrite during a drain."""
        with self._lock:
            self._states[name] = self._placed(name, rec)

    def delete(self, name: str) -> bool:
        with self._lock:
            existed = self._states.pop(name, None) is not None
            if not existed and self.absent_guard is not None:
                self.absent_guard(name)
            return existed

    def delete_unguarded(self, name: str) -> bool:
        """Delete bypassing the absent guard (the drain's own removal)."""
        with self._lock:
            return self._states.pop(name, None) is not None

    def get_unguarded(self, name: str) -> Optional[StateRecord]:
        """get() without the absent guard, for transfer-frame appliers that
        probe absent names; an expired record is dropped and reads as
        absent."""
        with self._lock:
            return self._live_locked(name)

    def census_records(self):
        """Non-expired ``(kind, record)`` pairs in one snapshot: the ledger
        scans read each record's tensors WITHOUT the store lock, so a gauge
        scrape never serializes against the write path."""
        with self._lock:
            return [
                (r.kind, r) for r in list(self._states.values())
                if not r.expired()
            ]

    def keys(self, pattern: Optional[str] = None) -> List[str]:
        """SCAN/KEYS analog: the names of the records that have not expired,
        matching the glob `pattern` when one is given."""
        with self._lock:
            names = [n for n, r in list(self._states.items()) if not r.expired()]
        if pattern is None or pattern == "*":
            return names
        return [n for n in names if fnmatch.fnmatchcase(n, pattern)]

    def exists(self, name: str) -> bool:
        return self.get(name) is not None

    def peek(self, name: str) -> bool:
        """Existence without the absent guard and without dropping an
        expired record: routing decisions (TRYAGAIN against ASK) and the
        drain's own bookkeeping."""
        with self._lock:
            rec = self._states.get(name)
            return rec is not None and not rec.expired()

    def rename(self, old: str, new: str) -> bool:
        with self._lock:
            rec = self._get_locked(old)
            if rec is None:
                return False
            if new != old:
                if self.placement_hook is not None:
                    self.placement_hook(new, rec, True)
                self._states[new] = rec
                del self._states[old]
            return True

    def expire(self, name: str, at: Optional[float]) -> bool:
        with self._lock:
            rec = self._get_locked(name)
            if rec is None:
                return False
            rec.expire_at = at
            return True

    def ttl(self, name: str) -> Optional[float]:
        """Remaining TTL seconds; None if absent or persistent."""
        rec = self.get(name)
        if rec is None or rec.expire_at is None:
            return None
        return max(0.0, rec.expire_at - time.time())

    def reap_expired(self) -> int:
        """Drop every expired record (the engine's sweep); the names go to
        ``on_expired`` after the store lock is released."""
        now = time.time()
        with self._lock:
            reaped = [n for n, r in self._states.items() if r.expired(now)]
            for name in reaped:
                del self._states[name]
        if reaped and self.on_expired is not None:
            try:
                self.on_expired(reaped)
            except Exception:  # noqa: BLE001 — sweep must survive hook bugs
                pass
        return len(reaped)

    def flushall(self) -> None:
        with self._lock:
            self._states.clear()

    def __len__(self):
        with self._lock:
            return len(self._states)
