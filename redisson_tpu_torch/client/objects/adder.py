"""LongAdder / DoubleAdder: write-optimized distributed counters.

Parity target: ``RedissonBaseAdder.java`` (+ RedissonLongAdder /
RedissonDoubleAdder).  The reference trades read cost for write cost: each
`increment()` only touches a handle-local counter; `sum()` publishes to the
adder's topic, every live handle flushes its local value into the shared
atomic, and the caller then reads the aggregate.  `reset()` follows the same
broadcast pattern.

Here the topic is the engine pub/sub hub, whose delivery is synchronous
in-process — so sum() is: publish "flush" (all handles fold in and zero their
locals), then read the shared counter.  Remote handles attach through the
wire-level pubsub the same way.

A copy of ``redisson_tpu/client/objects/adder.py`` on the port's engine.
"""
from __future__ import annotations

import threading
from typing import Optional

from redisson_tpu_torch.client.objects.bucket import AtomicDouble, AtomicLong


class _BaseAdder:
    _atomic_cls = AtomicLong
    _zero = 0

    def __init__(self, engine, name: str):
        self._engine = engine
        self._name = name
        self._atomic = self._atomic_cls(engine, name)
        self._local = self._zero
        self._local_lock = threading.Lock()
        self._channel = f"redisson_adder:{name}"
        self._listener_id = engine.pubsub.subscribe(self._channel, self._on_msg)

    @property
    def name(self) -> str:
        return self._name

    def _on_msg(self, channel: str, msg) -> None:
        kind = msg[0] if isinstance(msg, (tuple, list)) else msg
        if kind == "flush":
            with self._local_lock:
                pending, self._local = self._local, self._zero
            if pending:
                self._atomic.add_and_get(pending)
        elif kind == "reset":
            with self._local_lock:
                self._local = self._zero
        else:
            return
        if isinstance(msg, (tuple, list)) and len(msg) > 1:
            # ack so the aggregating handle knows this handle folded in
            self._engine.pubsub.publish(msg[1], "ack")

    # -- write path: local only (the whole point of an adder) ---------------

    def add(self, delta) -> None:
        with self._local_lock:
            self._local += delta

    def increment(self) -> None:
        self.add(1)

    def decrement(self) -> None:
        self.add(-1)

    # -- read path: aggregate ------------------------------------------------

    def _broadcast_and_wait(self, kind: str, timeout: float) -> None:
        """Publish `kind` and wait for one ack per receiver — the reference's
        semaphore-counted acknowledge (RedissonBaseAdder.sum waits for every
        live handle before reading).  In-process delivery is synchronous so
        acks usually arrive before publish() returns; wire-attached handles
        ack asynchronously and are bounded by `timeout`."""
        import threading
        import uuid as _uuid

        ack_channel = f"{self._channel}:ack:{_uuid.uuid4().hex}"
        acks = threading.Semaphore(0)
        lid = self._engine.pubsub.subscribe(
            ack_channel, lambda _c, _m: acks.release()
        )
        try:
            receivers = self._engine.pubsub.publish(self._channel, (kind, ack_channel))
            import time as _time

            deadline = None if timeout is None else _time.time() + timeout
            for _ in range(receivers):
                remaining = None if deadline is None else max(0.0, deadline - _time.time())
                if not acks.acquire(timeout=remaining):
                    break
        finally:
            self._engine.pubsub.unsubscribe(ack_channel, lid)

    def sum(self, timeout: float = 1.0):
        self._broadcast_and_wait("flush", timeout)
        return self._atomic.get()

    def reset(self, timeout: float = 1.0) -> None:
        self._broadcast_and_wait("reset", timeout)
        self._atomic.set(self._zero)

    def destroy(self) -> None:
        """Flush and detach (RedissonBaseAdder.destroy parity)."""
        with self._local_lock:
            pending, self._local = self._local, self._zero
        if pending:
            self._atomic.add_and_get(pending)
        self._engine.pubsub.unsubscribe(self._channel, self._listener_id)


class LongAdder(_BaseAdder):
    _atomic_cls = AtomicLong
    _zero = 0


class DoubleAdder(_BaseAdder):
    _atomic_cls = AtomicDouble
    _zero = 0.0
