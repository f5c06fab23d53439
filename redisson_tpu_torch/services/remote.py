"""RemoteService: RPC over queue pairs.

Parity target (SURVEY.md §2.6): ``org/redisson/RedissonRemoteService.java``
(500 LoC) + ``remote/BaseRemoteService.java:69-184`` + the proxy package —
per-interface request LIST `{name:iface}`, per-client response LIST
`{remote_response}:executorId`, serialized RemoteServiceRequest/Response
payloads, ack keys (ACK-mode invocation), cancellation, dynamic proxies.

Here: requests flow through a BlockingQueue per interface; server workers
deserialize, invoke the registered implementation, push the response onto the
caller's response queue.  The proxy is a dynamic attribute wrapper.  All
queue/payload names match the reference's shapes so the server-mode wire
protocol can expose them unchanged.

A copy of ``redisson_tpu/services/remote.py`` for the port.  One
difference: the engine's ``shutdown`` stops the registered workers and
joins them (``Engine.on_shutdown``).
"""
from __future__ import annotations

import pickle
import threading
import time
import uuid
from typing import Any, Dict, Optional

from redisson_tpu_torch.client.objects.queue import BlockingQueue


class RemoteInvocationTimeout(TimeoutError):
    pass


class RemoteServiceAckTimeout(TimeoutError):
    pass


class RemoteService:
    """Both faces of the reference service: `register` (server side) and
    `get` (client-side proxy factory)."""

    def __init__(self, engine, name: str = "redisson_rs"):
        self._engine = engine
        self._name = name
        self._executor_id = uuid.uuid4().hex[:12]
        self._workers: list[threading.Thread] = []
        self._stop = threading.Event()

    def _req_queue(self, iface: str) -> BlockingQueue:
        return BlockingQueue(self._engine, f"{{{self._name}:{iface}}}")

    def _resp_queue(self, client_id: str) -> BlockingQueue:
        return BlockingQueue(self._engine, f"{{remote_response}}:{client_id}")

    # -- server side ---------------------------------------------------------

    def register(self, iface: str, implementation: Any, workers: int = 1) -> None:
        """RRemoteService.register(Class, impl, workersAmount)."""
        q = self._req_queue(iface)

        def worker():
            while not self._stop.is_set():
                req = q.poll_blocking(0.2)
                if req is None:
                    continue
                request = pickle.loads(req)
                if request.get("ack"):
                    # ack-mode: confirm the request was picked up
                    self._resp_queue(request["client"]).offer(
                        pickle.dumps({"id": request["id"], "ack": True})
                    )
                try:
                    method = getattr(implementation, request["method"])
                    result = method(*request["args"], **request["kwargs"])
                    resp = {"id": request["id"], "result": result}
                except BaseException as e:  # noqa: BLE001 - errors cross the wire
                    resp = {"id": request["id"], "error": e}
                self._resp_queue(request["client"]).offer(pickle.dumps(resp))

        if not self._workers:
            self._engine.on_shutdown(self._close)
        for _ in range(workers):
            t = threading.Thread(target=worker, daemon=True, name=f"rtpu-rs-{iface}")
            t.start()
            self._workers.append(t)

    def _close(self) -> None:
        """The engine's shutdown: stop the workers and join them."""
        self._stop.set()
        for t in self._workers:
            t.join(timeout=5.0)

    def deregister(self) -> None:
        self._stop.set()

    # -- client side ---------------------------------------------------------

    def get(
        self,
        iface: str,
        timeout: float = 30.0,
        ack_timeout: Optional[float] = None,
    ) -> "RemoteProxy":
        """Dynamic proxy (remote/*Proxy.java analog)."""
        return RemoteProxy(self, iface, timeout, ack_timeout)

    def _invoke(self, iface: str, method: str, args, kwargs, timeout: float, ack_timeout):
        req_id = uuid.uuid4().hex
        client_id = self._executor_id
        payload = {
            "id": req_id,
            "client": client_id,
            "method": method,
            "args": args,
            "kwargs": kwargs,
            "ack": ack_timeout is not None,
        }
        self._req_queue(iface).offer(pickle.dumps(payload))
        resp_q = self._resp_queue(client_id)
        deadline = time.time() + timeout
        acked = ack_timeout is None
        ack_deadline = time.time() + (ack_timeout or 0)
        stash = []
        while True:
            budget = (ack_deadline if not acked else deadline) - time.time()
            if budget <= 0:
                if not acked:
                    raise RemoteServiceAckTimeout(
                        f"no worker acknowledged {iface}.{method} within {ack_timeout}s"
                    )
                raise RemoteInvocationTimeout(f"{iface}.{method} timed out after {timeout}s")
            raw = resp_q.poll_blocking(min(budget, 0.2))
            if raw is None:
                continue
            resp = pickle.loads(raw)
            if resp["id"] != req_id:
                stash.append(raw)  # someone else's response: put it back
                for s in stash:
                    resp_q.offer(s)
                stash.clear()
                continue
            if resp.get("ack"):
                acked = True
                continue
            if "error" in resp:
                raise resp["error"]
            return resp["result"]


class RemoteProxy:
    def __init__(self, service: RemoteService, iface: str, timeout: float, ack_timeout):
        self._service = service
        self._iface = iface
        self._timeout = timeout
        self._ack_timeout = ack_timeout

    def __getattr__(self, method: str):
        def call(*args, **kwargs):
            return self._service._invoke(
                self._iface, method, args, kwargs, self._timeout, self._ack_timeout
            )

        return call
