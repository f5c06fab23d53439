"""Topics: pub/sub messaging objects.

Parity targets:
  * RTopic — ``org/redisson/RedissonTopic.java``: addListener/removeListener/
    publish/countSubscribers over PublishSubscribeService.
  * RPatternTopic — PSUBSCRIBE glob patterns.
  * RShardedTopic — ``RedissonShardedTopic.java``: SSUBSCRIBE; in-process the
    shard channel is the same hub keyed by slot (kept for API parity and for
    mesh-mode routing).
  * RReliableTopic — ``RedissonReliableTopic.java:48+``: stream-backed topic
    where each subscriber tracks its own offset and a watchdog expires dead
    subscribers; messages survive subscriber downtime.

A copy of ``redisson_tpu/client/objects/topic.py`` on the port's engine.
"""
from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from redisson_tpu_torch.client.objects.base import RObject
from redisson_tpu_torch.core.store import StateRecord


class Topic(RObject):
    def publish(self, message: Any) -> int:
        """Returns number of receivers (PUBLISH reply).  The message takes a
        full codec round-trip so listeners observe exactly what a remote
        subscriber would decode."""
        data = self._codec.encode(message)
        return self._engine.pubsub.publish(self._name, self._codec.decode(data))

    def add_listener(self, listener: Callable[[str, Any], None]) -> int:
        return self._engine.pubsub.subscribe(self._name, listener)

    def remove_listener(self, listener_id: int) -> None:
        self._engine.pubsub.unsubscribe(self._name, listener_id)

    def count_subscribers(self) -> int:
        return self._engine.pubsub.subscriber_count(self._name)


class PatternTopic:
    """RPatternTopic: glob-pattern subscription."""

    def __init__(self, engine, pattern: str, codec=None):
        self._engine = engine
        self._pattern = pattern

    def add_listener(self, listener: Callable[[str, Any], None]) -> int:
        return self._engine.pubsub.psubscribe(self._pattern, listener)

    def remove_listener(self, listener_id: int) -> None:
        self._engine.pubsub.punsubscribe(self._pattern, listener_id)


class ShardedTopic(Topic):
    """RShardedTopic: identical delivery semantics in-process; the name maps
    to a keyspace slot so mesh-mode routing can pin it to a shard."""

    def slot(self) -> int:
        from redisson_tpu_torch.utils.crc16 import calc_slot

        return calc_slot(self._name)


class ReliableTopic(RObject):
    """RReliableTopic: durable stream + per-subscriber offsets.

    Subscribers poll from their own offset; messages are retained until every
    live subscriber has consumed them (the reference trims via XTRIM after
    watchdog-checked offsets).  Subscriber liveness uses a watchdog timeout
    (reliableTopicWatchdogTimeout, config/Config.java:77 — default 600s).
    """

    _kind = "reliable_topic"
    WATCHDOG_TIMEOUT = 600.0

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name,
            self._kind,
            lambda: StateRecord(
                kind=self._kind,
                host={"messages": [], "base": 0, "subscribers": {}},  # id -> [offset, last_seen]
            ),
        )

    def publish(self, message: Any) -> int:
        data = self._codec.encode(message)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host["messages"].append(data)
            self._touch_version(rec)
            n = len(rec.host["subscribers"])
        self._engine.wait_entry(f"__rtopic__:{self._name}").signal(all_=True)
        return n

    def add_subscriber(self) -> str:
        sid = uuid.uuid4().hex[:12]
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host["subscribers"][sid] = [
                rec.host["base"] + len(rec.host["messages"]),
                time.time(),
            ]
            self._touch_version(rec)
        return sid

    def remove_subscriber(self, subscriber_id: str) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host["subscribers"].pop(subscriber_id, None)
            self._trim(rec)
            self._touch_version(rec)

    def poll(self, subscriber_id: str, timeout: float = 0.0, max_messages: int = 100) -> List:
        """Fetch messages after this subscriber's offset; advances the offset."""
        deadline = time.time() + timeout
        while True:
            with self._engine.locked(self._name):
                rec = self._rec_or_create()
                sub = rec.host["subscribers"].get(subscriber_id)
                if sub is None:
                    raise KeyError(f"unknown subscriber {subscriber_id}")
                sub[1] = time.time()  # watchdog heartbeat
                base = rec.host["base"]
                start = sub[0] - base
                msgs = rec.host["messages"][start : start + max_messages]
                if msgs:
                    sub[0] += len(msgs)
                    self._reap_dead(rec)
                    self._trim(rec)
                    self._touch_version(rec)
                    return [self._codec.decode(m) for m in msgs]
            if time.time() >= deadline:
                return []
            self._engine.wait_entry(f"__rtopic__:{self._name}").wait_for(
                max(0.0, deadline - time.time())
            )

    def _reap_dead(self, rec) -> None:
        now = time.time()
        dead = [
            sid
            for sid, (_, seen) in rec.host["subscribers"].items()
            if now - seen > self.WATCHDOG_TIMEOUT
        ]
        for sid in dead:
            del rec.host["subscribers"][sid]

    def _trim(self, rec) -> None:
        """Drop messages consumed by every subscriber (XTRIM analog)."""
        subs = rec.host["subscribers"]
        if not subs:
            rec.host["base"] += len(rec.host["messages"])
            rec.host["messages"].clear()
            return
        min_off = min(off for off, _ in subs.values())
        drop = min_off - rec.host["base"]
        if drop > 0:
            rec.host["messages"] = rec.host["messages"][drop:]
            rec.host["base"] = min_off

    def size(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else len(rec.host["messages"])

    def count_subscribers(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else len(rec.host["subscribers"])
