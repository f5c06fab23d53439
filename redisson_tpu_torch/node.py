"""WorkerNode: standalone executor-worker daemon (the RedissonNode analog).

Parity target: ``org/redisson/RedissonNode.java`` — a worker process that
joins the grid, registers executor-service workers, pulls serialized tasks,
runs them, and acks results (``executor/TasksRunnerService.java:54,192,318``:
deserialize classBody, run, renew visibility, store result).

Division of labor: the SERVER process owns the device state and
never deserializes task code (payloads are opaque bytes in the task hash);
the worker node is the party that opts into executing grid code, so IT
unpickles — run worker nodes only against clusters you trust, exactly like
the reference's classBody shipping.  Orphan recovery: tasks claimed by a
worker that dies re-queue after the visibility window (requeue_orphans,
started_at-keyed).

Usage::

    python -m redisson_tpu_torch.node --address tpu://host:6390 \
        --executors redisson_executor --workers 4

A copy of ``redisson_tpu/node.py`` for the port.  Two differences: each
task's claim renewer is joined when the task ends, so ``stop()`` leaves no
thread of the node behind; and ``main`` stops the node cleanly (exit 0) on
SIGINT or SIGTERM however early the signal lands, where the reference's
catches KeyboardInterrupt only once ``start()`` has returned.
"""
from __future__ import annotations

import pickle
import signal
import threading
import time
import traceback
import uuid
from typing import List, Optional, Sequence


class WorkerNode:
    def __init__(
        self,
        address: str,
        executors: Sequence[str] = ("redisson_executor",),
        workers: int = 2,
        poll_interval: float = 0.2,
        orphan_age: float = 60.0,
        password: Optional[str] = None,
    ):
        from redisson_tpu_torch.client.remote import RemoteRedisson

        self.client = RemoteRedisson(address, password=password, timeout=180.0)
        self.executors = list(executors)
        self.n_workers = workers
        self.poll_interval = poll_interval
        self.orphan_age = orphan_age
        self.node_id = uuid.uuid4().hex[:12]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.stats = {"executed": 0, "failed": 0, "requeued": 0}

    # -- wire helpers ---------------------------------------------------------

    def _exec_call(self, executor: str, method: str, *args):
        return self.client.objcall("get_executor_service", executor, method, args, {})

    # -- worker loop (TasksRunnerService.run analog) --------------------------

    def _run_one(self, executor: str, task_id: str, payload: bytes, worker_id: str) -> None:
        # worker_id doubles as the claim-fencing token: if this claim was
        # orphan-requeued while we ran, the ack is rejected server-side.
        # A background renewal ticker keeps the claim visible while the task
        # runs (TasksRunnerService renews task visibility the same way) so a
        # chunk slower than the orphan window isn't voided under a live
        # worker — renewing at 1/3 the window survives two missed ticks.
        stop_renewal = threading.Event()

        def renew_loop():
            while not stop_renewal.wait(max(0.05, self.orphan_age / 3)):
                try:
                    self._exec_call(executor, "renew_claim", task_id, worker_id)
                except Exception:  # noqa: BLE001 — server briefly away; keep trying
                    pass

        renewer = threading.Thread(
            target=renew_loop, daemon=True, name=f"rtpu-renew-{task_id[:8]}"
        )
        renewer.start()
        try:
            try:
                fn, args, kwargs = pickle.loads(payload)  # noqa: S301 — the worker's whole job
                # @RInject analog (services/executor.py inject_client):
                # grid-aware tasks (MapReduce mappers/reducers) get THIS
                # node's client
                if getattr(fn, "_inject_client", False):
                    kwargs = {**kwargs, "client": self.client}
                result = fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — task failures are data
                self.stats["failed"] += 1
                retryable = e.__class__.__name__ == "_RetryableError"
                self._exec_call(
                    executor, "fail_task", task_id,
                    f"{type(e).__name__}: {e}\n{traceback.format_exc()}", retryable,
                    worker_id,
                )
                return
            self._exec_call(
                executor, "complete_task", task_id, pickle.dumps(result), worker_id
            )
            self.stats["executed"] += 1
        finally:
            stop_renewal.set()
            renewer.join(timeout=10.0)

    def _loop(self, wid: int) -> None:
        worker_id = f"{self.node_id}:{wid}"
        idle_rounds = 0
        while not self._stop.is_set():
            claimed = False
            for executor in self.executors:
                try:
                    got = self._exec_call(executor, "claim_task", worker_id)
                except Exception:  # noqa: BLE001 — server briefly away; retry
                    time.sleep(min(1.0, self.poll_interval * 5))
                    continue
                if got is not None:
                    task_id, payload = got
                    self._run_one(executor, task_id, bytes(payload), worker_id)
                    claimed = True
            if claimed:
                idle_rounds = 0
                continue
            idle_rounds += 1
            if wid == 0 and idle_rounds % 50 == 0:
                # periodic orphan sweep rides the idle worker (the reference
                # re-schedules orphaned tasks on a retryInterval timer)
                for executor in self.executors:
                    try:
                        self.stats["requeued"] += self._exec_call(
                            executor, "requeue_orphans", self.orphan_age
                        )
                    except Exception:  # noqa: BLE001
                        pass
            self._stop.wait(self.poll_interval)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "WorkerNode":
        for wid in range(self.n_workers):
            t = threading.Thread(
                target=self._loop, args=(wid,), daemon=True,
                name=f"rtpu-worker-{self.node_id}-{wid}",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self.client.shutdown()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="redisson-tpu worker node")
    ap.add_argument("--address", required=True, help="tpu://host:port of a grid server")
    ap.add_argument("--executors", default="redisson_executor",
                    help="comma-separated executor-service names to serve")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--password", default=None)
    ap.add_argument("--poll-interval", type=float, default=0.2)
    args = ap.parse_args(argv)
    # SIGINT and SIGTERM only set `stopping`, from the first line on: a
    # signal that lands while the node is still being built or started
    # (Thread.start waits for each worker thread to run, and the first
    # worker's heartbeat can make the node visible before the second
    # starts) must stop it as cleanly as one that lands while it serves
    stopping = threading.Event()

    def on_signal(_signum, _frame):
        stopping.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, on_signal)
    node = WorkerNode(
        args.address,
        executors=[e.strip() for e in args.executors.split(",") if e.strip()],
        workers=args.workers,
        poll_interval=args.poll_interval,
        password=args.password,
    )
    try:
        node.start()
        while not stopping.wait(1.0):
            pass
    finally:
        node.stop()


if __name__ == "__main__":
    main()
