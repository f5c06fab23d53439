"""HashedWheelTimer: one shared timer thread for all scheduled timeouts.

A copy of ``redisson_tpu/utils/timer.py``.  The reference runs every
lock-watchdog renewal, retry timeout and ping schedule on ONE Netty
``HashedWheelTimer`` owned by ``connection/ServiceManager.java``, never a
thread per timeout: 10k held locks with a ``threading.Timer`` chain each
would be 10k timer threads.  A wheel of buckets, one daemon thread ticking
over them, O(1) schedule and cancel.

Precision is bounded by the tick (default 100ms) — fine for watchdog renewals
(10s cadence) and lease expiries; anything needing sub-tick precision should
not ride a wheel timer in the reference either.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional


class Timeout:
    """Handle for one scheduled task (io.netty.util.Timeout analog)."""

    __slots__ = ("fn", "deadline", "_state", "_lock")

    _PENDING, _CANCELLED, _EXPIRED = 0, 1, 2

    def __init__(self, fn: Callable[[], None], deadline: float):
        self.fn = fn
        self.deadline = deadline
        self._state = self._PENDING
        self._lock = threading.Lock()

    def cancel(self) -> bool:
        """O(1): mark dead; the wheel skips cancelled entries at expiry."""
        with self._lock:
            if self._state != self._PENDING:
                return False
            self._state = self._CANCELLED
            return True

    def is_cancelled(self) -> bool:
        return self._state == self._CANCELLED

    def is_expired(self) -> bool:
        return self._state == self._EXPIRED

    def _try_expire(self) -> bool:
        with self._lock:
            if self._state != self._PENDING:
                return False
            self._state = self._EXPIRED
            return True


class HashedWheelTimer:
    """512-bucket wheel, 100ms tick (Netty's defaults are 512 / 100ms too)."""

    def __init__(self, tick: float = 0.1, wheel_size: int = 512):
        self.tick = tick
        self.wheel_size = wheel_size
        self._wheel: List[List[Timeout]] = [[] for _ in range(wheel_size)]
        self._cursor = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self.pending = 0  # observability: live (uncancelled, unexpired) count

    def new_timeout(self, fn: Callable[[], None], delay: float) -> Timeout:
        """Schedule fn to run once after `delay` seconds (worst-case one tick
        late).  fn runs ON the wheel thread: it must be short and non-blocking
        — heavy work should hop to an executor, as in the reference."""
        t = Timeout(fn, time.monotonic() + max(0.0, delay))
        # ceil: a timeout must never fire EARLY (an early lease expiry would
        # release a lock before its lease elapsed -> two holders)
        ticks = max(1, -int(-max(0.0, delay) // self.tick))
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("timer is stopped")
            slot = (self._cursor + ticks) % self.wheel_size
            self._wheel[slot].append(t)
            self.pending += 1
            self._ensure_thread()
        return t

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="rtpu-wheel-timer", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        next_tick = time.monotonic() + self.tick
        while not self._stop.wait(max(0.0, next_tick - time.monotonic())):
            next_tick += self.tick
            with self._lock:
                self._cursor = (self._cursor + 1) % self.wheel_size
                bucket = self._wheel[self._cursor]
                self._wheel[self._cursor] = []
                due = []
                now = time.monotonic()
                for t in bucket:
                    if t.is_cancelled():
                        self.pending -= 1
                    elif t.deadline > now:
                        # not due yet: the cursor arrived early (mid-tick
                        # scheduling skew) or a wheel revolution remains.
                        # Re-place by REMAINING time — parking it in this
                        # bucket again would delay it a full revolution, and
                        # firing now would violate the never-early invariant.
                        rem = max(1, -int(-(t.deadline - now) // self.tick))
                        slot = (self._cursor + rem) % self.wheel_size
                        self._wheel[slot].append(t)
                    else:
                        due.append(t)
            for t in due:
                if t._try_expire():
                    with self._lock:
                        self.pending -= 1
                    try:
                        t.fn()
                    except Exception:  # noqa: BLE001 — a task must not kill the wheel
                        pass
                else:
                    with self._lock:
                        self.pending -= 1

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2.0)
        with self._lock:
            for bucket in self._wheel:
                bucket.clear()
            self.pending = 0
