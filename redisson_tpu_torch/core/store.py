"""DeviceStore: the registry of named device-resident states.

Every object handle is stateless; its state lives here as a StateRecord
holding tensors (or, for the bucket family, host values) plus metadata
(kind, logical sizes, hash version), keyed by name.  Compound mutations run
under the engine's per-record locks (core/engine.py ``locked`` /
``locked_many``), so each object has one writer at a time.  Kernels update the record's tensors in place, or install a new
tensor where they write out of place (the HLL merges).

A copy of ``redisson_tpu/core/store.py`` without its hooks for the migration
window, device placement and the residency tiers, which later slices port.
With no absent guard, the ``*_unguarded`` accessors (which the reference
keeps for transfer frames and the vector banks' own records) behave as
``get``/``put``/``delete`` do.  ``on_expired`` is the reference's hook: the
server's tracking table hears of every record the store drops as expired,
lazily on access or in the engine's ``reap_expired`` sweep.
"""
from __future__ import annotations

import fnmatch
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


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

    def expired(self, now: Optional[float] = None) -> bool:
        return self.expire_at is not None and (now or time.time()) >= self.expire_at


class DeviceStore:
    """Thread-safe name -> StateRecord registry with TTL semantics: expired
    entries read as absent and are dropped when touched."""

    def __init__(self):
        self._lock = threading.RLock()
        self._states: Dict[str, StateRecord] = {}
        # Called with the NAMES of expired records the store just dropped.
        # It must not reenter the store: lazy expiry fires it while the
        # store lock is held.
        self.on_expired: Optional[Callable[[list], None]] = None

    def _reaped(self, name: str) -> None:
        if self.on_expired is not None:
            try:
                self.on_expired([name])
            except Exception:  # noqa: BLE001 — expiry must never fail a read
                pass

    def _get_locked(self, name: str) -> Optional[StateRecord]:
        rec = self._states.get(name)
        if rec is not None and rec.expired():
            del self._states[name]
            rec = None
            self._reaped(name)
        return rec

    def get(self, name: str) -> Optional[StateRecord]:
        with self._lock:
            return self._get_locked(name)

    def get_or_create(self, name: str, kind: str,
                      factory: Callable[[], StateRecord]) -> StateRecord:
        with self._lock:
            rec = self._get_locked(name)
            if rec is None:
                rec = factory()
                if rec.kind != kind:
                    raise TypeError(f"factory made a {rec.kind}, expected {kind}")
                self._states[name] = rec
            elif rec.kind != kind:
                raise TypeError(
                    f"object '{name}' holds a {rec.kind}, requested {kind} "
                    "(WRONGTYPE in the reference)"
                )
            return rec

    def put(self, name: str, rec: StateRecord) -> None:
        with self._lock:
            self._states[name] = rec

    put_unguarded = put

    def delete(self, name: str) -> bool:
        with self._lock:
            return self._states.pop(name, None) is not None

    delete_unguarded = delete

    def get_unguarded(self, name: str) -> Optional[StateRecord]:
        """get() without the reference's absent guard; an expired record is
        dropped and reads as absent."""
        return self.get(name)

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
        """Existence without dropping an expired record."""
        with self._lock:
            rec = self._states.get(name)
            return rec is not None and not rec.expired()

    def rename(self, old: str, new: str) -> bool:
        with self._lock:
            rec = self._get_locked(old)
            if rec is None:
                return False
            if new != old:
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
