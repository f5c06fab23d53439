"""ElementsSubscribeService: resilient blocking-consumer subscriptions.

Parity target: ``org/redisson/ElementsSubscribeService.java`` — the service
behind RBlockingQueue.subscribeOnElements/subscribeOnLastElements: a consumer
callback fed by a take-loop that RE-SUBSCRIBES itself when the connection
drops or the shard fails over, instead of dying with the socket.

Shape: the loop issues short bounded polls (server-side blocking
rides the slow OBJCALL pool, never a data-plane worker) and treats every
transport error as "re-subscribe after backoff" — on a cluster client the
next objcall re-routes to the promoted master automatically, which IS the
failover re-subscription.

A copy of ``redisson_tpu/services/elements.py`` for the port.  One
difference: ``shutdown`` (which the facades' ``shutdown`` calls) joins the
subscriptions' threads as well as stopping them.
"""
from __future__ import annotations

import threading
import uuid
from typing import Any, Callable, Dict, Optional


class _Subscription:
    def __init__(self, service: "ElementsSubscribeService", sub_id: str,
                 queue_name: str, consumer: Callable[[Any], None],
                 poll_interval: float, last: bool = False):
        self.id = sub_id
        self._service = service
        self._queue_name = queue_name
        self._consumer = consumer
        self._poll_interval = poll_interval
        # last=True: feed from the TAIL of a blocking deque
        # (subscribeOnLastElements / takeLastAsync)
        self._factory = "get_blocking_deque" if last else "get_blocking_queue"
        self._method = "poll_last_blocking" if last else "poll_blocking"
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"rtpu-elements-{queue_name}"
        )
        self.errors = 0
        self.delivered = 0

    def _run(self) -> None:
        client = self._service._client
        backoff = 0.05
        while not self._stop.is_set():
            try:
                if hasattr(client, "objcall"):  # wire clients: slot-routed
                    v = client.objcall(
                        self._factory, self._queue_name, self._method,
                        (self._poll_interval,), {},
                    )
                else:  # embedded facade: straight into the engine
                    handle = getattr(client, self._factory)(self._queue_name)
                    v = getattr(handle, self._method)(self._poll_interval)
                backoff = 0.05  # reachable again
                if v is None:
                    continue
                try:
                    self._consumer(v)
                    self.delivered += 1
                except Exception:  # noqa: BLE001 — consumer bugs must not
                    pass           # kill the subscription (reference behavior)
            except Exception:  # noqa: BLE001 — connection lost / failover in
                # progress: back off, then RE-SUBSCRIBE (the next poll
                # re-routes through the client's redirect machinery)
                self.errors += 1
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 2.0)

    def start(self) -> "_Subscription":
        self._thread.start()
        return self

    def cancel(self) -> None:
        self._stop.set()


class ElementsSubscribeService:
    """One service per client facade; holds every active subscription."""

    def __init__(self, client):
        self._client = client
        self._subs: Dict[str, _Subscription] = {}
        self._lock = threading.Lock()

    def subscribe_on_elements(
        self,
        queue_name: str,
        consumer: Callable[[Any], None],
        poll_interval: float = 1.0,
    ) -> str:
        """Start a resilient consumer on a blocking queue; returns the
        subscription id (RBlockingQueue.subscribeOnElements analog)."""
        return self._subscribe(queue_name, consumer, poll_interval, last=False)

    def subscribe_on_last_elements(
        self,
        deque_name: str,
        consumer: Callable[[Any], None],
        poll_interval: float = 1.0,
    ) -> str:
        """Tail-end consumer on a blocking DEQUE
        (RBlockingDeque.subscribeOnLastElements / takeLastAsync analog)."""
        return self._subscribe(deque_name, consumer, poll_interval, last=True)

    def _subscribe(self, name, consumer, poll_interval, last: bool) -> str:
        sub_id = uuid.uuid4().hex[:12]
        sub = _Subscription(self, sub_id, name, consumer, poll_interval, last=last)
        with self._lock:
            self._subs[sub_id] = sub
        sub.start()
        return sub_id

    def unsubscribe(self, sub_id: str) -> bool:
        with self._lock:
            sub = self._subs.pop(sub_id, None)
        if sub is None:
            return False
        sub.cancel()
        return True

    def subscription(self, sub_id: str) -> Optional[_Subscription]:
        with self._lock:
            return self._subs.get(sub_id)

    def shutdown(self) -> None:
        with self._lock:
            subs = list(self._subs.values())
            self._subs.clear()
        for s in subs:
            s.cancel()
        for s in subs:
            # a stopped loop ends once its current poll (<= poll_interval) returns
            s._thread.join(timeout=s._poll_interval + 5.0)
