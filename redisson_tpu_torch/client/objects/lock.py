"""Lock family: reentrant distributed locks.

Parity targets:
  * RLock — ``org/redisson/RedissonLock.java:102-149,214-224,337-360`` +
    ``RedissonBaseLock.java:106-189``: reentrancy keyed by (client-id,
    thread-id), lease with watchdog renewal every lease/3, unlock message
    wakes waiters on ``redisson_lock__channel:{name}``.
  * RFairLock — ``RedissonFairLock.java``: FIFO grant order via a pending
    queue + per-waiter timeouts.
  * RReadWriteLock — ``RedissonReadWriteLock.java``: shared readers /
    exclusive writer, both reentrant; write-lock downgrade allowed.
  * RFencedLock — ``RedissonFencedLock.java``: monotonically increasing
    fencing token returned on acquire.
  * RSpinLock — ``RedissonSpinLock.java``: exponential-backoff polling, no
    wakeup channel.
  * RMultiLock / RedLock — ``RedissonMultiLock.java`` (512 LoC): acquire N
    locks within a wait budget, unlock all on failure.

The acquisition template is the reference's exactly: atomically
try-compare-and-mutate under the record lock (the Lua), park on a shared wait
entry (the pubsub channel), re-try on wakeup, renew/expire leases (the
watchdog) — with condition variables in place of network pubsub.

A copy of ``redisson_tpu/client/objects/lock.py`` on the port's engine.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord

DEFAULT_LEASE = 30.0  # lockWatchdogTimeout default (config/Config.java:71)


def unlock_channel(name: str) -> str:
    """Canonical unlock-wakeup channel for a lock name — the ONE definition
    both the engine publisher and the remote client's park subscribe to
    (pubsub/LockPubSub.java's redisson_lock__channel:{name})."""
    return f"redisson_lock__channel:{name}"


def _holder_id(engine) -> str:
    """uuid:threadId — the reference's LockName (RedissonBaseLock.getLockName).
    A remote caller's identity (set via engine.impersonate) wins, so locks
    taken over the wire belong to the client thread, not the server worker."""
    override = engine.holder_override()
    if override is not None:
        return override
    eid = getattr(engine, "_client_uuid", None)
    if eid is None:
        with _UUID_INIT_LOCK:
            eid = getattr(engine, "_client_uuid", None)
            if eid is None:
                eid = engine._client_uuid = uuid.uuid4().hex
    return f"{eid}:{threading.get_ident()}"


_UUID_INIT_LOCK = threading.Lock()


class Lock(RExpirable):
    _kind = "lock"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name,
            self._kind,
            lambda: StateRecord(kind=self._kind, host={"owner": None, "count": 0, "lease_until": None, "token": 0}),
        )

    def _wait(self):
        return self._engine.wait_entry(f"__lock__:{self._name}")

    def unlock_channel(self) -> str:
        """The wakeup channel remote waiters park on (the reference's
        redisson_lock__channel:{name}, pubsub/LockPubSub.java)."""
        return unlock_channel(self._name)

    def _publish_unlock(self) -> None:
        # wake REMOTE waiters parked on the unlock channel (LockPubSub's
        # UNLOCK_MESSAGE); in-process waiters ride _wait().signal()
        self._engine.pubsub.publish(self.unlock_channel(), b"0")

    def _expired(self, h) -> bool:
        return h["lease_until"] is not None and time.time() >= h["lease_until"]

    def _try_acquire(self, lease_time: Optional[float]) -> Optional[float]:
        """One atomic attempt (the tryLockInnerAsync Lua,
        RedissonLock.java:214-224).  None = acquired; else remaining ttl."""
        me = _holder_id(self._engine)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            h = rec.host
            if h["owner"] is None or h["count"] == 0 or self._expired(h):
                h["owner"] = me
                h["count"] = 1
                h["token"] += 1
                h["lease_until"] = time.time() + (lease_time or DEFAULT_LEASE)
                self._touch_version(rec)
                return None
            if h["owner"] == me:
                h["count"] += 1
                h["lease_until"] = time.time() + (lease_time or DEFAULT_LEASE)
                self._touch_version(rec)
                return None
            return max(0.0, (h["lease_until"] or time.time()) - time.time())

    def lock(self, lease_time: Optional[float] = None) -> None:
        """Blocking acquire (RedissonLock.lock:102-149 loop)."""
        while True:
            ttl = self._try_acquire(lease_time)
            if ttl is None:
                self._start_watchdog(lease_time)
                return
            self._wait().wait_for(min(ttl, 1.0) if ttl > 0 else 0.05)

    def try_lock(
        self, wait_time: float = 0.0, lease_time: Optional[float] = None
    ) -> bool:
        deadline = time.time() + wait_time
        while True:
            ttl = self._try_acquire(lease_time)
            if ttl is None:
                self._start_watchdog(lease_time)
                return True
            remaining = deadline - time.time()
            if remaining <= 0:
                return False
            self._wait().wait_for(min(remaining, ttl if ttl > 0 else 0.05, 1.0))

    def _start_watchdog(self, lease_time: Optional[float]):
        """scheduleExpirationRenewal (RedissonBaseLock.java:127-189): only when
        no explicit lease was given, renew every DEFAULT_LEASE/3 while held.

        Never started for impersonated (remote OBJCALL) holders: the
        reference's watchdog lives in the CLIENT process precisely so a dead
        client stops renewing and the lease expires — a server-side renewal
        under the client's identity would pin the lock forever.  Remote
        holders renew client-side (RemoteRedisson lock wrapper)."""
        if lease_time is not None or self._engine.holder_override() is not None:
            return
        me = _holder_id(self._engine)
        name = self._name
        engine = self._engine

        def renew() -> bool:
            with engine.locked(name):
                rec = engine.store.get(name)
                if rec is None or rec.host["owner"] != me or rec.host["count"] == 0:
                    return False  # stop renewing
                rec.host["lease_until"] = time.time() + DEFAULT_LEASE
            return True

        # one renewal per (lock, holder) on the SHARED wheel timer — never a
        # timer thread per lock
        engine.start_renewal(name, me, renew, DEFAULT_LEASE / 3)

    def renew_lease(self, lease_time: float = DEFAULT_LEASE) -> bool:
        """One explicit lease extension if still held by the caller — the
        remote client's watchdog tick (the PEXPIRE Lua of
        RedissonBaseLock.renewExpiration, driven client-side over the wire)."""
        me = _holder_id(self._engine)
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None or rec.host["owner"] != me or rec.host["count"] == 0:
                return False
            rec.host["lease_until"] = time.time() + lease_time
            return True

    def unlock(self) -> None:
        """RedissonLock.unlock:337-360: decrement reentrancy; on zero, release
        and publish the wakeup."""
        me = _holder_id(self._engine)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            h = rec.host
            if h["owner"] != me or h["count"] == 0:
                raise RuntimeError(
                    f"attempt to unlock lock '{self._name}' not held by current "
                    f"thread (IllegalMonitorStateException analog)"
                )
            h["count"] -= 1
            if h["count"] == 0:
                h["owner"] = None
                h["lease_until"] = None
            self._touch_version(rec)
            released = h["count"] == 0
        if released:
            # cancelExpirationRenewal (RedissonBaseLock.java) — don't leave a
            # pending wheel entry to discover the release a tick later
            self._engine.cancel_renewal(self._name, me)
            self._wait().signal()
            self._publish_unlock()

    def force_unlock(self) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            held = rec.host["count"] > 0
            rec.host.update(owner=None, count=0, lease_until=None)
            self._touch_version(rec)
        self._engine.cancel_renewal(self._name)  # every holder's watchdog
        self._wait().signal(all_=True)
        self._publish_unlock()
        return held

    def is_locked(self) -> bool:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return False
        h = rec.host
        return h["count"] > 0 and not self._expired(h)

    def is_held_by_current_thread(self) -> bool:
        rec = self._engine.store.get(self._name)
        return (
            rec is not None
            and rec.host["owner"] == _holder_id(self._engine)
            and rec.host["count"] > 0
            and not self._expired(rec.host)
        )

    def get_hold_count(self) -> int:
        rec = self._engine.store.get(self._name)
        if rec is None or rec.host["owner"] != _holder_id(self._engine):
            return 0
        return rec.host["count"]

    def remain_time_to_live_lock(self) -> Optional[float]:
        rec = self._engine.store.get(self._name)
        if rec is None or rec.host["lease_until"] is None:
            return None
        return max(0.0, rec.host["lease_until"] - time.time())

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()
        return False


class FencedLock(Lock):
    """RFencedLock: acquire returns a strictly monotonic fencing token."""

    _kind = "fenced_lock"

    def lock_and_get_token(self, lease_time: Optional[float] = None) -> int:
        self.lock(lease_time)
        return self.get_token()

    def try_lock_and_get_token(
        self, wait_time: float = 0.0, lease_time: Optional[float] = None
    ) -> Optional[int]:
        """Acquire + token in ONE atomic step: the token is read under the
        same record lock that performed the acquire, so a lapsed-lease steal
        between acquire and read cannot hand two holders the same token."""
        deadline = time.time() + wait_time
        while True:
            with self._engine.locked(self._name):
                if self._try_acquire(lease_time) is None:
                    tok = self._rec_or_create().host["token"]
                    self._start_watchdog(lease_time)
                    return int(tok)
            remaining = deadline - time.time()
            if remaining <= 0:
                return None
            self._wait().wait_for(min(remaining, 0.05))

    def get_token(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else rec.host["token"]


class SpinLock(Lock):
    """RSpinLock: no wakeup channel — exponential-backoff polling
    (RedissonSpinLock.java; initial 1ms, x2 up to 64ms)."""

    _kind = "spin_lock"

    def lock(self, lease_time: Optional[float] = None) -> None:
        delay = 0.001
        while self._try_acquire(lease_time) is not None:
            time.sleep(delay)
            delay = min(delay * 2, 0.064)
        self._start_watchdog(lease_time)

    def try_lock(self, wait_time: float = 0.0, lease_time: Optional[float] = None) -> bool:
        deadline = time.time() + wait_time
        delay = 0.001
        while True:
            if self._try_acquire(lease_time) is None:
                self._start_watchdog(lease_time)
                return True
            if time.time() >= deadline:
                return False
            time.sleep(min(delay, max(0.0, deadline - time.time())))
            delay = min(delay * 2, 0.064)


class FairLock(Lock):
    """RFairLock: FIFO ordering of waiters (RedissonFairLock Lua keeps a
    pending-threads list with per-waiter timeouts; here the queue lives in the
    record as (holder_id, refreshed_deadline) pairs).  A waiter refreshes its
    deadline on every acquisition attempt; entries whose deadline lapsed are
    pruned, so a waiter that died mid-wait cannot deadlock the head of the
    queue (the reference's Lua does the same timeout cleanup)."""

    _kind = "fair_lock"
    WAITER_TTL = 5.0  # must exceed the retry loop's longest park (1s)

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name,
            self._kind,
            lambda: StateRecord(
                kind=self._kind,
                host={"owner": None, "count": 0, "lease_until": None, "token": 0, "queue": []},
            ),
        )

    def _try_acquire(self, lease_time: Optional[float]) -> Optional[float]:
        me = _holder_id(self._engine)
        now = time.time()
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            h = rec.host
            h["queue"] = [(w, dl) for w, dl in h["queue"] if dl > now]  # prune dead
            q = h["queue"]
            if h["owner"] == me and h["count"] > 0 and not self._expired(h):
                h["count"] += 1
                h["lease_until"] = now + (lease_time or DEFAULT_LEASE)
                return None
            for i, (w, _dl) in enumerate(q):
                if w == me:
                    q[i] = (me, now + self.WAITER_TTL)  # refresh my deadline
                    break
            else:
                q.append((me, now + self.WAITER_TTL))
            if (h["owner"] is None or h["count"] == 0 or self._expired(h)) and q[0][0] == me:
                q.pop(0)
                h["owner"] = me
                h["count"] = 1
                h["token"] += 1
                h["lease_until"] = now + (lease_time or DEFAULT_LEASE)
                self._touch_version(rec)
                return None
            return max(0.0, (h["lease_until"] or now) - now) or 0.05

    def try_lock(self, wait_time: float = 0.0, lease_time: Optional[float] = None) -> bool:
        ok = super().try_lock(wait_time, lease_time)
        if not ok:  # leave the FIFO queue on timeout (Lua timeout cleanup)
            me = _holder_id(self._engine)
            with self._engine.locked(self._name):
                rec = self._rec_or_create()
                rec.host["queue"] = [(w, dl) for w, dl in rec.host["queue"] if w != me]
        return ok


class ReadWriteLock:
    """RReadWriteLock: returns reader/writer faces over shared state."""

    def __init__(self, engine, name, codec=None):
        self._engine = engine
        self._name = name

    def read_lock(self) -> "ReadLock":
        return ReadLock(self._engine, self._name)

    def write_lock(self) -> "WriteLock":
        return WriteLock(self._engine, self._name)


class _RWBase(RExpirable):
    _kind = "rw_lock"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name,
            self._kind,
            lambda: StateRecord(
                kind=self._kind,
                host={"mode": None, "writer": None, "write_count": 0, "readers": {}},
            ),
        )

    def _wait(self):
        return self._engine.wait_entry(f"__rwlock__:{self._name}")


class ReadLock(_RWBase):
    def try_lock(self, wait_time: float = 0.0) -> bool:
        me = _holder_id(self._engine)
        deadline = time.time() + wait_time
        while True:
            with self._engine.locked(self._name):
                rec = self._rec_or_create()
                h = rec.host
                # readers admitted unless another thread holds write
                if h["write_count"] == 0 or h["writer"] == me:
                    h["readers"][me] = h["readers"].get(me, 0) + 1
                    h["mode"] = "read" if h["write_count"] == 0 else h["mode"]
                    self._touch_version(rec)
                    return True
            if time.time() >= deadline:
                return False
            self._wait().wait_for(min(1.0, deadline - time.time()))

    def lock(self) -> None:
        while not self.try_lock(1.0):
            pass

    def unlock(self) -> None:
        me = _holder_id(self._engine)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            h = rec.host
            n = h["readers"].get(me, 0)
            if n == 0:
                raise RuntimeError("read lock not held by current thread")
            if n == 1:
                del h["readers"][me]
            else:
                h["readers"][me] = n - 1
            if not h["readers"] and h["write_count"] == 0:
                h["mode"] = None
            self._touch_version(rec)
        self._wait().signal(all_=True)

    def is_locked(self) -> bool:
        rec = self._engine.store.get(self._name)
        return rec is not None and bool(rec.host["readers"])

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()
        return False


class WriteLock(_RWBase):
    def try_lock(self, wait_time: float = 0.0) -> bool:
        me = _holder_id(self._engine)
        deadline = time.time() + wait_time
        while True:
            with self._engine.locked(self._name):
                rec = self._rec_or_create()
                h = rec.host
                others_reading = any(r != me for r in h["readers"])
                if (h["write_count"] == 0 or h["writer"] == me) and not others_reading:
                    # allowed: fresh write, write reentrancy, read->write upgrade
                    # only when sole reader (reference blocks upgrade; we allow
                    # sole-reader upgrade which is strictly less deadlock-prone)
                    h["writer"] = me
                    h["write_count"] += 1
                    h["mode"] = "write"
                    self._touch_version(rec)
                    return True
            if time.time() >= deadline:
                return False
            self._wait().wait_for(min(1.0, deadline - time.time()))

    def lock(self) -> None:
        while not self.try_lock(1.0):
            pass

    def unlock(self) -> None:
        me = _holder_id(self._engine)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            h = rec.host
            if h["writer"] != me or h["write_count"] == 0:
                raise RuntimeError("write lock not held by current thread")
            h["write_count"] -= 1
            if h["write_count"] == 0:
                h["writer"] = None
                h["mode"] = "read" if h["readers"] else None
            self._touch_version(rec)
        self._wait().signal(all_=True)

    def is_locked(self) -> bool:
        rec = self._engine.store.get(self._name)
        return rec is not None and rec.host["write_count"] > 0

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()
        return False


class MultiLock:
    """RMultiLock (RedissonMultiLock.java): all-or-nothing acquisition of a
    group of locks within a wait budget; base wait 1.5s per lock like the
    reference's baseWaitTime heuristic."""

    def __init__(self, *locks: Lock):
        if not locks:
            raise ValueError("MultiLock needs at least one lock")
        self._locks = list(locks)

    def try_lock(self, wait_time: float = 0.0, lease_time: Optional[float] = None) -> bool:
        deadline = time.time() + (wait_time or 1.5 * len(self._locks))
        acquired = []
        for lk in self._locks:
            remaining = max(0.0, deadline - time.time())
            if lk.try_lock(remaining, lease_time):
                acquired.append(lk)
            else:
                for a in reversed(acquired):
                    a.unlock()
                return False
        return True

    def lock(self, lease_time: Optional[float] = None) -> None:
        while not self.try_lock(0.0, lease_time):
            time.sleep(0.01)

    def unlock(self) -> None:
        errors = []
        for lk in reversed(self._locks):
            try:
                lk.unlock()
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()
        return False


class RedLock(MultiLock):
    """Deprecated in the reference (RedissonRedLock); kept for API parity —
    identical to MultiLock in a single-authority deployment."""
