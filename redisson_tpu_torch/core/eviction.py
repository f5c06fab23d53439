"""EvictionScheduler: self-tuning background expiry sweeps.

Role parity: `eviction/EvictionScheduler.java:33-63` registers one cleanup
task per expiring object (MapCache, SetCache, TimeSeries, JCache, multimap
cache); each `EvictionTask` reschedules itself with a delay that adapts to how
much it actually removed — frequent sweeps while entries are expiring, backing
off toward the max delay when sweeps come up empty (`config/Config.java:83-87`
knobs: minCleanUpDelay=5s, maxCleanUpDelay=30min).

Design here: one daemon thread + a time-ordered heap of tasks instead of a
wheel timer (the sweep cadence is seconds-to-minutes; a heap is exact and
cheap at this rate).  The sweep callables run entirely on the host — they
must never touch the device dispatch path (SURVEY.md §7.3 hard-part 3).

Tuning rule (mirror of EvictionTask.getNextDelay logic): a sweep that removes
at least `keys_limit` entries halves the delay (more work likely pending); a
sweep that removes nothing multiplies it by 1.5; anything in between keeps
the current cadence. Always clamped to [min_delay, max_delay].
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Dict, Optional


class _Task:
    __slots__ = ("name", "sweep", "delay", "dead")

    def __init__(self, name: str, sweep: Callable[[], int], delay: float):
        self.name = name
        self.sweep = sweep
        self.delay = delay
        self.dead = False


class EvictionScheduler:
    KEYS_LIMIT = 100  # removals per sweep that signal "sweep again soon"
    DROP = -1         # sweep return value meaning "unschedule me"

    def __init__(
        self,
        min_delay: float = 5.0,
        max_delay: float = 1800.0,
        start_delay: Optional[float] = None,
    ):
        self.min_delay = min_delay
        self.max_delay = max_delay
        self.start_delay = start_delay if start_delay is not None else min_delay
        self._tasks: Dict[str, _Task] = {}
        self._heap: list = []  # (fire_at, seq, task)
        self._seq = 0
        self._cv = threading.Condition()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self.sweeps = 0          # observability counters
        self.total_removed = 0

    # -- registration --------------------------------------------------------

    def schedule(self, name: str, sweep: Callable[[], int]) -> None:
        """Register (or refresh) a cleanup task for object `name`.

        `sweep()` must return the number of entries it removed.  Idempotent:
        re-registering an object keeps the existing cadence (the reference
        also keys tasks by object name, EvictionScheduler.java:44-52).
        """
        with self._cv:
            if self._closed or name in self._tasks:
                return
            task = _Task(name, sweep, self.start_delay)
            self._tasks[name] = task
            self._push(task, time.time() + task.delay)
            self._ensure_thread()
            self._cv.notify()

    def schedule_for_record(self, engine, name: str, sweep: Callable[[], int]) -> None:
        """Register a sweep tied to a store record's lifetime: once the record
        has existed and is later deleted, the task unschedules itself —
        otherwise per-name tasks for dynamic object names leak forever.
        Recreating the object re-registers through the factory path."""
        seen = [False]

        def guarded() -> int:
            exists = engine.store.exists(name)
            if exists:
                seen[0] = True
                return sweep()
            return self.DROP if seen[0] else 0

        self.schedule(name, guarded)

    def unschedule(self, name: str) -> None:
        with self._cv:
            task = self._tasks.pop(name, None)
            if task is not None:
                task.dead = True

    def _push(self, task: _Task, fire_at: float) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (fire_at, self._seq, task))

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="rtpu-eviction", daemon=True
            )
            self._thread.start()

    # -- the sweep loop ------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._closed and (
                    not self._heap or self._heap[0][0] > time.time()
                ):
                    wait = (
                        self._heap[0][0] - time.time() if self._heap else None
                    )
                    self._cv.wait(timeout=wait)
                if self._closed:
                    return
                _, _, task = heapq.heappop(self._heap)
                if task.dead:
                    continue
            try:
                removed = int(task.sweep() or 0)
            except Exception:  # noqa: BLE001 - a failing sweep must not kill the loop
                removed = 0
            if removed == self.DROP:
                self.unschedule(task.name)
                continue
            self.sweeps += 1
            self.total_removed += removed
            if removed >= self.KEYS_LIMIT:
                task.delay = max(self.min_delay, task.delay / 2.0)
            elif removed == 0:
                task.delay = min(self.max_delay, task.delay * 1.5)
            with self._cv:
                if not task.dead and not self._closed:
                    self._push(task, time.time() + task.delay)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
