"""Distributed executor / scheduler service.

Parity targets (SURVEY.md §2.6):
  * RExecutorService — ``org/redisson/RedissonExecutorService.java:90-289``
    (1,240 LoC): tasks serialized into a task hash `{name}:tasks` + request
    queue; workers (TasksRunnerService) pull, run, ack; task ids; cancel;
    countActiveWorkers; task retry when a worker dies before ack
    (``executor/TasksService.java`` — tasks stay in the hash until completion).
  * RScheduledExecutorService — schedule-with-delay / at-fixed-rate / cron
    (``ScheduledTasksService.java``, ``CronExpression.java``): a scheduler
    ZSET ordered by fire time + transfer of due tasks to the request queue
    (QueueTransferTask.java:83-118).
  * RedissonNode — ``org/redisson/RedissonNode.java``: the worker daemon ==
    `register_workers` here (thread workers in-process; the server exposes
    the same registration for remote worker processes).

Task payloads are pickled callables (the classBody-shipping analog of
``executor/TasksRunnerService.java:192-318`` minus JVM classloading).

A copy of ``redisson_tpu/services/executor.py`` for the port.  One
difference: every thread a service starts (its workers, its fixed-rate,
fixed-delay and cron loops) is its own, and the engine's ``shutdown`` stops
the service and joins them (``Engine.on_shutdown``), so a client that was
shut down leaves no thread behind.
"""
from __future__ import annotations

import pickle
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from redisson_tpu_torch.core.store import StateRecord


class TaskFuture:
    def __init__(self, task_id: str):
        self.task_id = task_id
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self._cancelled = False

    def _complete(self, value):
        self._value = value
        self._event.set()

    def _fail(self, err: BaseException):
        self._error = err
        self._event.set()

    def _cancel(self):
        self._cancelled = True
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def get(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"task {self.task_id} not finished")
        if self._cancelled:
            raise RuntimeError(f"task {self.task_id} was cancelled")
        if self._error is not None:
            raise self._error
        return self._value


@dataclass
class _Task:
    id: str
    payload: bytes                      # pickled (fn, args, kwargs) — opaque to the server
    state: str = "queued"               # queued | running | finished | failed | cancelled
    result: Any = None
    error: Optional[str] = None
    retries: int = 0
    submitted_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None  # set on claim; orphan requeue keys on this
    claimed_by: Optional[str] = None    # worker id (remote workers)
    expires_at: Optional[float] = None  # submit(ttl=...): discard if unstarted


class ExecutorService:
    """One named executor: task registry + request queue + worker pool."""

    MAX_RETRIES = 3

    def __init__(self, engine, name: str):
        self._engine = engine
        self._name = name
        self._futures: Dict[str, TaskFuture] = {}
        self._workers: List[threading.Thread] = []
        self._shutdown = threading.Event()
        self._closer_armed = False

    # -- state --------------------------------------------------------------

    def _rec(self) -> StateRecord:
        return self._engine.store.get_or_create(
            f"{{{self._name}}}:tasks",
            "executor_tasks",
            lambda: StateRecord(kind="executor_tasks", host={"tasks": {}, "queue": [], "workers": 0}),
        )

    def _wait(self):
        return self._engine.wait_entry(f"__exec__:{self._name}")

    # -- submission (RExecutorService.submit / RExecutorService.execute) ----

    def submit(self, fn: Callable, *args, task_id: Optional[str] = None,
               ttl: Optional[float] = None, **kwargs) -> TaskFuture:
        """RExecutorService.submit incl. the id form (submit(id, task) — an
        explicit id makes the task addressable/idempotent across clients)
        and the time-to-live form (submit(task, timeToLive): a task not
        STARTED within `ttl` seconds is discarded and its future fails)."""
        payload = pickle.dumps((fn, args, kwargs), protocol=pickle.HIGHEST_PROTOCOL)
        # the future registers BEFORE the task becomes claimable: an idle
        # worker can claim-and-finish the instant the queue append lands,
        # and a late registration would wait forever on a completed task
        tid = task_id or uuid.uuid4().hex[:16]
        fut = TaskFuture(tid)
        prev = self._futures.get(tid)
        self._futures[tid] = fut
        try:
            self.submit_payload(payload, task_id=tid, ttl=ttl)
        except BaseException:
            # rejected (duplicate-id) submit must not clobber the original
            # submitter's still-pending future
            if prev is not None:
                self._futures[tid] = prev
            else:
                self._futures.pop(tid, None)
            raise
        return fut

    def execute(self, fn: Callable, *args, **kwargs) -> None:
        # fire-and-forget: no future is ever observable, so none registers
        self.submit_payload(
            pickle.dumps((fn, args, kwargs), protocol=pickle.HIGHEST_PROTOCOL)
        )

    def submit_many(self, calls: List[Tuple[Callable, tuple]]) -> List[TaskFuture]:
        return [self.submit(fn, *args) for fn, args in calls]

    def cancel_task(self, task_id: str) -> bool:
        """RExecutorService.cancelTask: queued tasks and not-yet-fired
        one-shot schedules cancel (the fire hook checks the state under the
        same lock, so a cancelled schedule never enqueues); running tasks
        don't — matching the reference's no-interrupt semantics."""
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            task = rec.host["tasks"].get(task_id)
            if task is None or task.state not in ("queued", "scheduled"):
                return False
            task.state = "cancelled"
            if task_id in rec.host["queue"]:
                rec.host["queue"].remove(task_id)
            rec.version += 1
        fut = self._futures.pop(task_id, None)
        if fut:
            fut._cancel()
        self._done_wait().signal(all_=True)  # wake await_task_result pollers
        return True

    # -- workers (TasksRunnerService / RedissonNode.registerWorkers) --------

    def register_workers(self, n: int) -> None:
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            rec.host["workers"] += n
            rec.version += 1  # worker counts must survive failover too
        for _ in range(n):
            self._start_thread(self._worker_loop, f"rtpu-exec-{self._name}")

    def _start_thread(self, target: Callable, name: str) -> None:
        """Start a thread this service owns; the engine's shutdown stops
        the service and joins it."""
        if not self._closer_armed:
            self._closer_armed = True
            self._engine.on_shutdown(self._close)
        t = threading.Thread(target=target, daemon=True, name=name)
        self._workers.append(t)
        t.start()

    def _close(self) -> None:
        self.shutdown()
        for t in self._workers:
            t.join(timeout=5.0)

    REMOTE_WORKER_TTL = 15.0  # heartbeat staleness bound

    def count_active_workers(self) -> int:
        """RedissonExecutorService.countActiveWorkers (:207-224 does a topic
        round-trip; here: in-process threads + live remote heartbeats)."""
        rec = self._engine.store.get(f"{{{self._name}}}:tasks")
        if rec is None:
            return 0
        now = time.time()
        remote = sum(
            1
            for ts in rec.host.get("remote_workers", {}).values()
            if now - ts < self.REMOTE_WORKER_TTL
        )
        return rec.host["workers"] + remote

    def _take_task(self, worker_id: Optional[str] = None) -> Optional[_Task]:
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            while rec.host["queue"]:
                tid = rec.host["queue"].pop(0)
                task = rec.host["tasks"].get(tid)
                if task is None or task.state != "queued":
                    continue
                if task.expires_at is not None and time.time() >= task.expires_at:
                    # submit(ttl=...): unstarted past its TTL — discard and
                    # fail the future (the reference drops the task record)
                    task.state = "failed"
                    task.error = "task expired before execution (time-to-live)"
                    rec.version += 1
                    self._resolve_failure(task)
                    continue
                task.state = "running"
                task.started_at = time.time()
                task.claimed_by = worker_id
                rec.version += 1
                return task
            return None

    def _worker_loop(self):
        while not self._shutdown.is_set():
            task = self._take_task()
            if task is None:
                self._wait().wait_for(0.2)
                continue
            self._run_task(task)

    def _run_task(self, task: _Task):
        # pop, don't get: a completed future is delivered through the
        # caller's own reference; keeping it registered would grow the
        # dict by one entry per task for the service's lifetime
        fut = self._futures.pop(task.id, None)
        try:
            fn, args, kwargs = pickle.loads(task.payload)
            # @RInject analog (misc/Injector): tasks asking for the client get it
            if getattr(fn, "_inject_client", False):
                from redisson_tpu_torch.client.redisson import RedissonTpu

                kwargs = {**kwargs, "client": RedissonTpu(self._engine)}
            result = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - task failures are data
            with self._engine.locked(f"{{{self._name}}}:tasks"):
                rec = self._rec()
                task.retries += 1
                rec.version += 1  # every transition ships to replicas
                if task.retries < self.MAX_RETRIES and isinstance(e, _RetryableError):
                    task.state = "queued"
                    rec.host["queue"].append(task.id)
                    if fut is not None:  # the retry will need it again
                        self._futures[task.id] = fut
                    return
                task.state = "failed"
                task.error = traceback.format_exc()
            if fut:
                fut._fail(e)
            return
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            task.state = "finished"
            task.result = result
            self._rec().version += 1
        if fut:
            fut._complete(result)

    def requeue_orphans(self, max_running_age: float = 60.0) -> int:
        """TasksService re-schedule of orphaned tasks: a task 'running' on a
        dead worker goes back to the queue (the reference keeps tasks in the
        hash until an explicit completion ack).  Age is measured from when
        the task STARTED running (queue wait time must not count)."""
        n = 0
        now = time.time()
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            for task in rec.host["tasks"].values():
                started = task.started_at if task.started_at is not None else task.submitted_at
                if task.state == "running" and now - started > max_running_age:
                    task.state = "queued"
                    task.claimed_by = None  # void the stale claim (fencing)
                    rec.host["queue"].append(task.id)
                    rec.version += 1
                    n += 1
        if n:
            self._wait().signal(all_=True)
        return n

    # -- remote-worker wire surface (RedissonNode / TasksRunnerService) -----
    # Payloads are OPAQUE BYTES to the server: submitters pickle, only the
    # claiming worker unpickles (and only the final consumer unpickles the
    # result) — the server never deserializes task code, mirroring the
    # reference where task classBody bytes pass through Redis untouched.

    def submit_payload(self, payload: bytes, task_id: Optional[str] = None,
                       ttl: Optional[float] = None) -> str:
        """Enqueue an opaque pickled (fn, args, kwargs) payload; returns id.
        `task_id` lets submit() pre-register its future under the id before
        the task is visible to workers; an existing id is rejected
        (submit(id, task) addressability contract).  `ttl` bounds how long
        the task may sit UNSTARTED."""
        task = _Task(
            id=task_id or uuid.uuid4().hex[:16], payload=bytes(payload),
            expires_at=time.time() + ttl if ttl is not None else None,
        )
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            existing = rec.host["tasks"].get(task.id)
            if existing is not None and existing.state in ("queued", "running"):
                raise ValueError(f"task id '{task.id}' is already active")
            rec.host["tasks"][task.id] = task
            rec.host["queue"].append(task.id)
            rec.version += 1
        self._wait().signal()
        if ttl is not None:
            # proactive expiry: with no worker ever claiming, the TTL must
            # still fail the task (and its future) at the deadline — not
            # leave the caller to time out
            self._engine.schedule_timeout(self._expire_due_tasks, ttl + 0.01)
        return task.id

    def _expire_due_tasks(self) -> int:
        """Fail every queued task whose submit-TTL elapsed (claim-time
        checks in _take_task stay as the fallback for late timers)."""
        expired = []
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            now = time.time()
            for tid in list(rec.host["queue"]):
                task = rec.host["tasks"].get(tid)
                if (
                    task is not None and task.state == "queued"
                    and task.expires_at is not None and now >= task.expires_at
                ):
                    task.state = "failed"
                    task.error = "task expired before execution (time-to-live)"
                    rec.host["queue"].remove(tid)
                    rec.version += 1
                    expired.append(task)
        for t in expired:
            self._resolve_failure(t)
        return len(expired)

    def claim_task(self, worker_id: str) -> Optional[Tuple[str, bytes]]:
        """Worker pull: (task_id, payload) or None.  Claiming heartbeats the
        worker for count_active_workers."""
        self.heartbeat(worker_id)
        task = self._take_task(worker_id)
        return None if task is None else (task.id, task.payload)

    @staticmethod
    def _claim_matches(task: "_Task", worker_id: Optional[str]) -> bool:
        """Claim fencing: a worker that lost its claim to an orphan-requeue
        (and a subsequent re-claim by another worker) must not ack the task
        — worker_id is the fencing token (the reference keeps tasks in the
        hash until the CLAIMING runner's ack; lose the claim, lose the ack)."""
        return worker_id is None or task.claimed_by == worker_id

    def complete_task(self, task_id: str, result_bytes: bytes, worker_id: Optional[str] = None) -> bool:
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            task = rec.host["tasks"].get(task_id)
            if task is None or task.state not in ("running", "queued"):
                return False
            if not self._claim_matches(task, worker_id):
                return False  # stale claimant (task was requeued + re-claimed)
            task.state = "finished"
            task.result = bytes(result_bytes)
            rec.version += 1
        fut = self._futures.pop(task_id, None)  # pop: see _run_task
        if fut:
            try:
                fut._complete(pickle.loads(task.result))  # noqa: S301 — submitter-side decode
            except Exception as e:  # noqa: BLE001 — undecodable result must not hang waiters
                fut._fail(RuntimeError(f"task result undecodable: {e}"))
        self._done_wait().signal(all_=True)
        return True

    def fail_task(
        self, task_id: str, error_text: str, retryable: bool = False,
        worker_id: Optional[str] = None,
    ) -> bool:
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            task = rec.host["tasks"].get(task_id)
            if task is None or task.state != "running":
                return False
            if not self._claim_matches(task, worker_id):
                return False  # stale claimant
            task.retries += 1
            rec.version += 1  # every transition ships to replicas
            if retryable and task.retries < self.MAX_RETRIES:
                task.state = "queued"
                task.claimed_by = None
                rec.host["queue"].append(task.id)
                self._wait().signal()
                return True
            task.state = "failed"
            task.error = error_text
        fut = self._futures.pop(task_id, None)  # pop: see _run_task
        if fut:
            fut._fail(RuntimeError(error_text))
        self._done_wait().signal(all_=True)
        return True

    def _resolve_failure(self, task: "_Task") -> None:
        """Fail the local future (if any) for an already-failed task record."""
        fut = self._futures.pop(task.id, None)
        if fut:
            fut._fail(RuntimeError(task.error or "task failed"))
        self._done_wait().signal(all_=True)

    def _done_wait(self):
        return self._engine.wait_entry(f"__exec_done__:{self._name}")

    def await_task_result(self, task_id: str, timeout: float = 60.0):
        """Block until the task finishes; returns the raw result (opaque
        bytes for payload submissions).  Works across processes/handles —
        waiters key off the task record, not an in-process future."""
        deadline = time.time() + timeout
        while True:
            with self._engine.locked(f"{{{self._name}}}:tasks"):
                rec = self._rec()
                task = rec.host["tasks"].get(task_id)
                if task is None:
                    raise KeyError(f"unknown task {task_id}")
                if task.state == "finished":
                    return task.result
                if task.state == "failed":
                    raise RuntimeError(task.error or "task failed")
                if task.state == "cancelled":
                    raise RuntimeError("task was cancelled")
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError(f"task {task_id} not finished within {timeout}s")
            self._done_wait().wait_for(min(remaining, 0.5))

    def renew_claim(self, task_id: str, worker_id: str) -> bool:
        """Visibility renewal for long-running tasks (the reference renews
        task visibility mid-run, TasksRunnerService.java:192-318): bump the
        claim's started_at so requeue_orphans' window measures time since
        the LAST sign of life, not since the claim — a slow-but-healthy
        chunk must not be voided out from under a live worker."""
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            task = rec.host["tasks"].get(task_id)
            if task is None or task.state != "running" or task.claimed_by != worker_id:
                return False
            task.started_at = time.time()
            rec.version += 1
            return True

    def heartbeat(self, worker_id: str) -> None:
        now = time.time()
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            hb = rec.host.setdefault("remote_workers", {})
            hb[worker_id] = now
            # prune long-dead workers so churn can't grow the record forever
            stale = [w for w, ts in hb.items() if now - ts > 4 * self.REMOTE_WORKER_TTL]
            for w in stale:
                del hb[w]

    def task_state(self, task_id: str) -> Optional[str]:
        rec = self._engine.store.get(f"{{{self._name}}}:tasks")
        if rec is None:
            return None
        task = rec.host["tasks"].get(task_id)
        return None if task is None else task.state

    def shutdown(self) -> None:
        self._shutdown.set()
        self._wait().signal(all_=True)

    def delete(self) -> bool:
        self.shutdown()
        return self._engine.store.delete(f"{{{self._name}}}:tasks")


class _RetryableError(Exception):
    """Raise from a task to request re-queue (visibility-timeout analog)."""


def inject_client(fn: Callable) -> Callable:
    """Decorator: task receives a `client=` kwarg (the @RInject analog)."""
    fn._inject_client = True
    return fn


# -- scheduling ---------------------------------------------------------------

class CronExpression:
    """5-field cron (min hour dom mon dow), supporting '*', lists, ranges and
    steps — the subset of ``org/redisson/executor/CronExpression.java`` the
    scheduler surface needs."""

    def __init__(self, expr: str):
        parts = expr.split()
        if len(parts) != 5:
            raise ValueError(f"cron needs 5 fields, got {expr!r}")
        ranges = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]
        self.fields = [self._parse(p, lo, hi) for p, (lo, hi) in zip(parts, ranges)]

    @staticmethod
    def _parse(spec: str, lo: int, hi: int) -> set:
        out = set()
        for part in spec.split(","):
            step = 1
            if "/" in part:
                part, step_s = part.split("/")
                step = int(step_s)
            if part in ("*", ""):
                rng = range(lo, hi + 1)
            elif "-" in part:
                a, b = part.split("-")
                rng = range(int(a), int(b) + 1)
            else:
                rng = range(int(part), int(part) + 1)
            out.update(v for v in rng if (v - lo) % step == 0 and lo <= v <= hi)
        return out

    def matches(self, t: time.struct_time) -> bool:
        mins, hours, doms, mons, dows = self.fields
        return (
            t.tm_min in mins
            and t.tm_hour in hours
            and t.tm_mday in doms
            and t.tm_mon in mons
            and t.tm_wday in {(d - 1) % 7 for d in dows} | ({6} if 0 in dows else set())
        )

    def next_fire(self, after: float) -> float:
        """Next matching minute boundary after `after` (scan cap: 366 days)."""
        t = int(after // 60 + 1) * 60
        for _ in range(366 * 24 * 60):
            if self.matches(time.localtime(t)):
                return float(t)
            t += 60
        raise ValueError("cron expression never fires")


class ScheduledExecutorService(ExecutorService):
    """RScheduledExecutorService: delayed / fixed-rate / cron scheduling.

    Due tasks transfer from the schedule (a fire-time-ordered heap — the
    reference's `{name}:scheduler` ZSET) onto the request queue.
    """

    def __init__(self, engine, name: str):
        super().__init__(engine, name)
        # task id -> wheel Timeout: fire() prunes its own entry and
        # cancel_task cancels+drops, so the map stays bounded by the number
        # of schedules actually pending
        self._timers: Dict[str, Any] = {}

    def cancel_task(self, task_id: str) -> bool:
        ok = super().cancel_task(task_id)
        if ok:
            t = self._timers.pop(task_id, None)
            if t is not None:
                t.cancel()  # no point firing into a cancelled state
        return ok

    def schedule(self, delay: float, fn: Callable, *args, **kwargs) -> TaskFuture:
        """scheduleAsync(task, delay)."""
        payload = pickle.dumps((fn, args, kwargs), protocol=pickle.HIGHEST_PROTOCOL)
        task = _Task(id=uuid.uuid4().hex[:16], payload=payload, state="scheduled")
        fut = TaskFuture(task.id)
        self._futures[task.id] = fut
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            rec = self._rec()
            rec.host["tasks"][task.id] = task
            rec.version += 1  # every transition ships to replicas

        def fire():
            with self._engine.locked(f"{{{self._name}}}:tasks"):
                # prune under the SAME lock schedule() arms under, so a
                # 0-delay fire cannot pop before the timer is stored
                self._timers.pop(task.id, None)
                if task.state != "scheduled":
                    return
                task.state = "queued"
                rec2 = self._rec()
                rec2.host["queue"].append(task.id)
                rec2.version += 1  # scheduled->queued must replicate too
            self._wait().signal()

        # one shared wheel timer, not a thread per scheduled task; fire()
        # takes record locks, so it runs on the timer pool, not the wheel.
        # Keyed by task id so cancel_task can drop the timer and fire()
        # prunes its own entry — an append-only list would grow forever.
        # Armed under the record lock: fire() prunes under the same lock,
        # so even a 0-delay fire observes the stored Timeout.
        with self._engine.locked(f"{{{self._name}}}:tasks"):
            self._timers[task.id] = self._engine.schedule_timeout(fire, delay)
        return fut

    def schedule_at_fixed_rate(self, initial_delay: float, period: float, fn: Callable, *args) -> str:
        """Returns a schedule id; cancel via cancel_scheduled."""
        sid = uuid.uuid4().hex[:12]
        stop = threading.Event()
        self._fixed_rate_stops = getattr(self, "_fixed_rate_stops", {})
        self._fixed_rate_stops[sid] = stop

        def loop():
            nxt = time.time() + initial_delay
            while not stop.is_set() and not self._shutdown.is_set():
                delay = nxt - time.time()
                if delay > 0:
                    stop.wait(delay)
                    if stop.is_set():
                        return
                self.submit(fn, *args)
                nxt += period

        self._start_thread(loop, f"rtpu-sched-{sid}")
        return sid

    def schedule_with_fixed_delay(self, initial_delay: float, delay: float,
                                  fn: Callable, *args) -> str:
        """RScheduledExecutorService.scheduleWithFixedDelay: the next run
        starts `delay` seconds AFTER the previous one FINISHES (fixed-rate
        schedules by wall-clock period instead)."""
        sid = uuid.uuid4().hex[:12]
        stop = threading.Event()
        self._fixed_rate_stops = getattr(self, "_fixed_rate_stops", {})
        self._fixed_rate_stops[sid] = stop

        def loop():
            if initial_delay > 0:
                stop.wait(initial_delay)
            while not stop.is_set() and not self._shutdown.is_set():
                fut = self.submit(fn, *args)
                # completion gates the next delay — wait HOWEVER long the run
                # takes (capping would let a long run overlap the next one),
                # polling so cancel/shutdown still take effect promptly
                while not stop.is_set() and not self._shutdown.is_set():
                    try:
                        fut.get(timeout=1.0)
                        break
                    except TimeoutError:
                        continue
                    except Exception:  # noqa: BLE001 — failed run reschedules
                        break
                if stop.is_set() or self._shutdown.is_set():
                    return
                stop.wait(delay)

        self._start_thread(loop, f"rtpu-sched-{sid}")
        return sid

    def schedule_cron(self, cron_expr: str, fn: Callable, *args) -> str:
        """schedule(task, CronSchedule.of(expr))."""
        cron = CronExpression(cron_expr)
        sid = uuid.uuid4().hex[:12]
        stop = threading.Event()
        self._fixed_rate_stops = getattr(self, "_fixed_rate_stops", {})
        self._fixed_rate_stops[sid] = stop

        def loop():
            while not stop.is_set() and not self._shutdown.is_set():
                nxt = cron.next_fire(time.time())
                if stop.wait(max(0.0, nxt - time.time())):
                    return
                self.submit(fn, *args)

        self._start_thread(loop, f"rtpu-sched-{sid}")
        return sid

    def cancel_scheduled(self, schedule_id: str) -> bool:
        stops = getattr(self, "_fixed_rate_stops", {})
        stop = stops.pop(schedule_id, None)
        if stop is None:
            return False
        stop.set()
        return True

    def shutdown(self) -> None:
        for t in list(self._timers.values()):
            t.cancel()
        self._timers.clear()
        for stop in getattr(self, "_fixed_rate_stops", {}).values():
            stop.set()
        super().shutdown()
