"""Semaphores, CountDownLatch, RateLimiter.

Parity targets:
  * RSemaphore — ``org/redisson/RedissonSemaphore.java`` (526 LoC): counter +
    release channel wakeups; trySetPermits/acquire/release/drain/addPermits.
  * RPermitExpirableSemaphore — ``RedissonPermitExpirableSemaphore.java``
    (909 LoC): permits are leased by id with a timeout ZSET; expired leases
    return to the pool; release by permit id.
  * RCountDownLatch — ``RedissonCountDownLatch.java`` + CountDownLatchPubSub:
    trySetCount/countDown/await.
  * RRateLimiter — ``RedissonRateLimiter.java`` (367 LoC): token bucket over
    a sliding interval, OVERALL or PER_CLIENT scope.

Same synchronizer template as lock.py: atomic compare-and-mutate under the
record lock + wait-entry wakeups (the Lua + pubsub pattern).

A copy of ``redisson_tpu/client/objects/semaphore.py`` on the port's engine.
"""
from __future__ import annotations

import time
import uuid
from typing import List, Optional

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord


class Semaphore(RExpirable):
    _kind = "semaphore"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host={"permits": 0})
        )

    def _wait(self):
        return self._engine.wait_entry(f"__sem__:{self._name}")

    def try_set_permits(self, permits: int) -> bool:
        """Initialize the pool only if unset (RedissonSemaphore.trySetPermits)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if rec.meta.get("initialized"):
                return False
            rec.meta["initialized"] = True
            rec.host["permits"] = permits
            self._touch_version(rec)
            return True

    def available_permits(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else rec.host["permits"]

    def try_acquire(self, permits: int = 1, wait_time: float = 0.0) -> bool:
        deadline = time.time() + wait_time
        while True:
            with self._engine.locked(self._name):
                rec = self._rec_or_create()
                if rec.host["permits"] >= permits:
                    rec.host["permits"] -= permits
                    self._touch_version(rec)
                    return True
            remaining = deadline - time.time()
            if remaining <= 0:
                return False
            self._wait().wait_for(min(remaining, 1.0))

    def acquire(self, permits: int = 1) -> None:
        while not self.try_acquire(permits, wait_time=1.0):
            pass

    def release(self, permits: int = 1) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host["permits"] += permits
            self._touch_version(rec)
        self._wait().signal(all_=True)

    def add_permits(self, permits: int) -> None:
        self.release(permits) if permits > 0 else self._reduce(-permits)

    def _reduce(self, permits: int) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host["permits"] -= permits
            self._touch_version(rec)

    def drain_permits(self) -> int:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            n = rec.host["permits"]
            rec.host["permits"] = 0
            if n:
                self._touch_version(rec)
            return n


class PermitExpirableSemaphore(RExpirable):
    """RPermitExpirableSemaphore: leased permits identified by id."""

    _kind = "permit_semaphore"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name,
            self._kind,
            lambda: StateRecord(kind=self._kind, host={"permits": 0, "leases": {}}),
        )

    def _wait(self):
        return self._engine.wait_entry(f"__psem__:{self._name}")

    def _reap(self, rec) -> None:
        now = time.time()
        expired = [pid for pid, exp in rec.host["leases"].items() if exp is not None and now >= exp]
        for pid in expired:
            del rec.host["leases"][pid]
            rec.host["permits"] += 1

    def try_set_permits(self, permits: int) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if rec.meta.get("initialized"):
                return False
            rec.meta["initialized"] = True
            rec.host["permits"] = permits
            self._touch_version(rec)
            return True

    def available_permits(self) -> int:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            return rec.host["permits"]

    def try_acquire(self, wait_time: float = 0.0, lease_time: Optional[float] = None) -> Optional[str]:
        """Returns a permit id, or None on timeout (reference returns the id
        or throws; Optional is the pythonic equivalent)."""
        deadline = time.time() + wait_time
        while True:
            with self._engine.locked(self._name):
                rec = self._rec_or_create()
                self._reap(rec)
                if rec.host["permits"] > 0:
                    rec.host["permits"] -= 1
                    pid = uuid.uuid4().hex
                    rec.host["leases"][pid] = (
                        time.time() + lease_time if lease_time is not None else None
                    )
                    self._touch_version(rec)
                    return pid
            remaining = deadline - time.time()
            if remaining <= 0:
                return None
            self._wait().wait_for(min(remaining, 1.0))

    def acquire(self, lease_time: Optional[float] = None) -> str:
        while True:
            pid = self.try_acquire(wait_time=1.0, lease_time=lease_time)
            if pid is not None:
                return pid

    def release(self, permit_id: str) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            if permit_id not in rec.host["leases"]:
                return False
            del rec.host["leases"][permit_id]
            rec.host["permits"] += 1
            self._touch_version(rec)
        self._wait().signal(all_=True)
        return True

    def update_lease_time(self, permit_id: str, lease_time: float) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            if permit_id not in rec.host["leases"]:
                return False
            rec.host["leases"][permit_id] = time.time() + lease_time
            self._touch_version(rec)
            return True


class CountDownLatch(RExpirable):
    _kind = "count_down_latch"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host={"count": 0})
        )

    def _wait(self):
        return self._engine.wait_entry(f"__latch__:{self._name}")

    def try_set_count(self, count: int) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if rec.host["count"] > 0:
                return False
            rec.host["count"] = count
            self._touch_version(rec)
            return True

    def get_count(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else rec.host["count"]

    def count_down(self) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if rec.host["count"] > 0:
                rec.host["count"] -= 1
                self._touch_version(rec)
            released = rec.host["count"] == 0
        if released:
            self._wait().signal(all_=True)

    def await_(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.time() + timeout
        while self.get_count() > 0:
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                return False
            self._wait().wait_for(min(remaining, 1.0) if remaining is not None else 1.0)
        return True


class RateLimiter(RExpirable):
    """RRateLimiter: token bucket over a sliding interval.

    rate/rate_interval mirror trySetRate(mode, rate, rateInterval, unit);
    modes OVERALL (one shared bucket) and PER_CLIENT (bucket per client
    instance) as in ``api/RateType``.
    """

    _kind = "rate_limiter"
    OVERALL = "OVERALL"
    PER_CLIENT = "PER_CLIENT"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name,
            self._kind,
            lambda: StateRecord(kind=self._kind, host={"buckets": {}}),
        )

    def _wait(self):
        return self._engine.wait_entry(f"__rate__:{self._name}")

    def _client_key(self) -> str:
        rec = self._engine.store.get(self._name)
        if rec is not None and rec.meta.get("mode") == self.PER_CLIENT:
            cid = getattr(self._engine, "_client_uuid", None) or "local"
            return cid
        return "__overall__"

    def try_set_rate(self, mode: str, rate: int, rate_interval: float) -> bool:
        if mode not in (self.OVERALL, self.PER_CLIENT):
            raise ValueError(f"unknown rate mode {mode!r}")
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if "rate" in rec.meta:
                return False
            rec.meta.update(mode=mode, rate=rate, interval=rate_interval)
            self._touch_version(rec)
            return True

    def set_rate(self, mode: str, rate: int, rate_interval: float) -> None:
        """Overwrite the rate config and reset buckets (RRateLimiter.setRate)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.meta.update(mode=mode, rate=rate, interval=rate_interval)
            rec.host["buckets"].clear()
            self._touch_version(rec)

    def _try_take(self, permits: int) -> Optional[float]:
        """None = granted; else seconds until enough tokens refill."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if "rate" not in rec.meta:
                raise RuntimeError(f"RateLimiter '{self._name}' is not initialized")
            rate, interval = rec.meta["rate"], rec.meta["interval"]
            if permits > rate:
                raise ValueError(f"requested {permits} permits > rate {rate}")
            now = time.time()
            key = self._client_key()
            used: List[float] = rec.host["buckets"].setdefault(key, [])
            # sliding window: drop grants older than the interval
            cutoff = now - interval
            while used and used[0] <= cutoff:
                used.pop(0)
            if len(used) + permits <= rate:
                used.extend([now] * permits)
                self._touch_version(rec)
                return None
            need = len(used) + permits - rate
            return max(0.0, used[need - 1] + interval - now)

    def try_acquire(self, permits: int = 1, timeout: float = 0.0) -> bool:
        deadline = time.time() + timeout
        while True:
            delay = self._try_take(permits)
            if delay is None:
                return True
            remaining = deadline - time.time()
            if remaining <= 0:
                return False
            time.sleep(min(delay + 1e-4, remaining))

    def acquire(self, permits: int = 1) -> None:
        while not self.try_acquire(permits, timeout=10.0):
            pass

    def available_permits(self) -> int:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if "rate" not in rec.meta:
                return 0
            now = time.time()
            key = self._client_key()
            used = rec.host["buckets"].get(key, [])
            cutoff = now - rec.meta["interval"]
            live = sum(1 for t in used if t > cutoff)
            return rec.meta["rate"] - live

    def get_config(self) -> dict:
        rec = self._engine.store.get(self._name)
        if rec is None or "rate" not in rec.meta:
            return {}
        return {k: rec.meta[k] for k in ("mode", "rate", "interval")}
