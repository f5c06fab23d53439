"""In-process pub/sub hub: the PublishSubscribeService analog.

Parity target: ``org/redisson/pubsub/PublishSubscribeService.java`` (~900 LoC,
SURVEY.md §2.2) — a subscription registry that (a) fans published messages out
to listeners and (b) wakes blocked synchronizer waiters (LockPubSub /
SemaphorePubSub / CountDownLatchPubSub wire per-object latches to channel
messages, SURVEY.md §3.3).

In embedded mode this is a thread-safe registry + condition variables; in
server mode the same hub backs SUBSCRIBE/PUBLISH across connections.  Message
ordering per channel is preserved under the hub lock (the reference's
`keepPubSubOrder`).
"""
from __future__ import annotations

import fnmatch
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

Listener = Callable[[str, Any], None]


class PubSubHub:
    def __init__(self):
        self._lock = threading.RLock()
        self._channels: Dict[str, List[Tuple[int, Listener]]] = defaultdict(list)
        self._patterns: Dict[str, List[Tuple[int, Listener]]] = defaultdict(list)
        self._next_id = 1
        self._closed = False

    def subscribe(self, channel: str, listener: Listener) -> int:
        with self._lock:
            lid = self._next_id
            self._next_id += 1
            self._channels[channel].append((lid, listener))
            return lid

    def psubscribe(self, pattern: str, listener: Listener) -> int:
        with self._lock:
            lid = self._next_id
            self._next_id += 1
            self._patterns[pattern].append((lid, listener))
            return lid

    def unsubscribe(self, channel: str, listener_id: int) -> None:
        with self._lock:
            subs = self._channels.get(channel, [])
            self._channels[channel] = [(i, l) for i, l in subs if i != listener_id]
            if not self._channels[channel]:
                self._channels.pop(channel, None)

    def punsubscribe(self, pattern: str, listener_id: int) -> None:
        with self._lock:
            subs = self._patterns.get(pattern, [])
            self._patterns[pattern] = [(i, l) for i, l in subs if i != listener_id]
            if not self._patterns[pattern]:
                self._patterns.pop(pattern, None)

    def publish(self, channel: str, message: Any) -> int:
        """Deliver to all channel + matching pattern listeners; returns the
        receiver count (PUBLISH reply semantics)."""
        with self._lock:
            if self._closed:
                return 0
            targets = list(self._channels.get(channel, []))
            ptargets = [
                (pat, lid, fn)
                for pat, subs in self._patterns.items()
                if fnmatch.fnmatchcase(channel, pat)
                for lid, fn in subs
            ]
        n = 0
        for _lid, fn in targets:
            fn(channel, message)
            n += 1
        for _pat, _lid, fn in ptargets:
            fn(channel, message)
            n += 1
        return n

    def subscriber_count(self, channel: str) -> int:
        with self._lock:
            return len(self._channels.get(channel, []))

    def has_listeners(self, channel: str) -> bool:
        """True when a publish to `channel` would reach anyone — exact
        subscribers OR matching pattern subscribers.  Publishers use this to
        skip payload-construction cost; gating on subscriber_count alone
        would silently starve PSUBSCRIBE-only consumers."""
        with self._lock:
            if self._channels.get(channel):
                return True
            return any(
                fnmatch.fnmatchcase(channel, pat)
                for pat, subs in self._patterns.items()
                if subs
            )

    def channels(self) -> List[str]:
        with self._lock:
            return list(self._channels)

    def close(self):
        with self._lock:
            self._closed = True
            self._channels.clear()
            self._patterns.clear()


class WaitEntry:
    """Per-object wait latch: the RedissonLockEntry analog (pubsub/LockPubSub.java).

    Blocked acquirers park on `wait_for`; an unlock/release message wakes one
    (or all) of them.  Built on a condition variable instead of a Redis
    subscription, but the contract is the same: subscribe-once per object,
    wake on message, re-try the acquisition loop.
    """

    def __init__(self):
        self.cond = threading.Condition()
        self._signals = 0
        self._waiters = 0
        self._last_used = time.monotonic()

    def signal(self, all_: bool = False):
        with self.cond:
            self._last_used = time.monotonic()
            self._signals += 1
            if all_:
                self.cond.notify_all()
            else:
                self.cond.notify()

    def wait_for(self, timeout: float | None) -> bool:
        """Wait until signalled; consumes one signal. Returns False on timeout."""
        with self.cond:
            self._last_used = time.monotonic()
            if self._signals > 0:
                self._signals -= 1
                return True
            self._waiters += 1
            try:
                ok = self.cond.wait(timeout)
            finally:
                self._waiters -= 1
                self._last_used = time.monotonic()
            if ok and self._signals > 0:
                self._signals -= 1
            return ok

    def touch(self) -> None:
        """Reset the idle clock — called on every registry fetch so the GC
        can never prune an entry between a caller's wait_entry() lookup and
        its first park (the fetch-to-park window is the race the sweep's
        60s idle threshold must dominate)."""
        with self.cond:
            self._last_used = time.monotonic()

    def idle(self, max_idle: float) -> bool:
        """True when prunable: nobody parked and untouched for `max_idle`
        seconds (the engine's wait-entry GC predicate).  A buffered signal
        does NOT pin the entry — it is a wakeup hint, and every parker in the
        codebase re-checks its condition in a bounded retry loop, so losing a
        stale signal costs one park timeout, never a hang."""
        with self.cond:
            return (
                self._waiters == 0
                and time.monotonic() - self._last_used >= max_idle
            )
