"""Queue family: FIFO/LIFO/blocking/bounded/delayed/priority/ring/transfer.

Parity targets:
  * RQueue / RDeque — LPUSH/RPOP list semantics.
  * RBlockingQueue / RBlockingDeque — ``RedissonBlockingQueue.java``: BLPOP/
    BLMOVE; blocking ops park on a wait entry and survive "reconnects".
  * RBoundedBlockingQueue — ``RedissonBoundedBlockingQueue.java`` (410 LoC):
    capacity enforced via a semaphore-like channel.
  * RDelayedQueue — ``RedissonDelayedQueue.java`` (527 LoC): target queue +
    timeout-ordered buffer + transfer timer (QueueTransferTask.java:83-118).
  * RPriorityQueue/Deque — ``RedissonPriorityQueue.java`` (476 LoC).
  * RRingBuffer — capped queue evicting oldest.
  * RTransferQueue — ``RedissonTransferQueue.java`` (731 LoC): producers may
    wait for consumption.

Blocking is a host-side control-plane concern:
condition-variable wait entries play the role of the pubsub wakeup channels.

A copy of ``redisson_tpu/client/objects/queue.py`` on the port's engine.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Iterable, List, Optional

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.pubsub import WaitEntry
from redisson_tpu_torch.core.store import StateRecord


class Queue(RExpirable):
    _kind = "queue"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host=[])
        )

    def _e(self, v) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw: bytes):
        return self._codec.decode(raw)

    def offer(self, value) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host.append(self._e(value))
            self._touch_version(rec)
        self._signal()
        return True

    def add(self, value) -> bool:
        if not self.offer(value):
            raise OverflowError("queue full")
        return True

    def poll(self):
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if not rec.host:
                return None
            raw = rec.host.pop(0)
            self._touch_version(rec)
            return self._d(raw)

    def poll_many(self, limit: int) -> List:
        out = []
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            while rec.host and len(out) < limit:
                out.append(self._d(rec.host.pop(0)))
            if out:
                self._touch_version(rec)
        return out

    def peek(self):
        rec = self._engine.store.get(self._name)
        if rec is None or not rec.host:
            return None
        return self._d(rec.host[0])

    def element(self):
        v = self.peek()
        if v is None:
            raise LookupError("queue is empty")
        return v

    def remove_head(self):
        v = self.poll()
        if v is None:
            raise LookupError("queue is empty")
        return v

    def contains(self, value) -> bool:
        rec = self._engine.store.get(self._name)
        return rec is not None and self._e(value) in rec.host

    def remove(self, value) -> bool:
        e = self._e(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            try:
                rec.host.remove(e)
            except ValueError:
                return False
            self._touch_version(rec)
            return True

    def size(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else len(rec.host)

    def is_empty(self) -> bool:
        return self.size() == 0

    def read_all(self) -> List:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [self._d(e) for e in list(rec.host)]

    def clear(self) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host.clear()
            self._touch_version(rec)

    def poll_last_and_offer_first_to(self, dest_name: str):
        """RPOPLPUSH (RQueue.pollLastAndOfferFirstTo)."""
        # construct the dest handle FIRST: its ctor applies the NameMapper,
        # and the lock must cover the mapped key it will actually mutate
        dest = type(self)(self._engine, dest_name, self._codec)
        with self._engine.locked_many((self._name, dest._name)):
            rec = self._rec_or_create()
            if not rec.host:
                return None
            raw = rec.host.pop()
            drec = dest._rec_or_create()
            drec.host.insert(0, raw)
            self._touch_version(rec)
            self._touch_version(drec)
        dest._signal()
        return self._d(raw)

    # wakeup plumbing shared with blocking subclasses
    def _wait_entry(self) -> WaitEntry:
        return self._engine.queue_wait_entry(self._name)

    def _signal(self):
        self._wait_entry().signal(all_=True)

    def __len__(self):
        return self.size()


class Deque(Queue):
    _kind = "deque"

    def add_first(self, value) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host.insert(0, self._e(value))
            self._touch_version(rec)
        self._signal()

    def add_last(self, value) -> None:
        self.offer(value)

    def offer_first(self, value) -> bool:
        self.add_first(value)
        return True

    def offer_last(self, value) -> bool:
        return self.offer(value)

    def poll_first(self):
        return self.poll()

    def poll_last(self):
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if not rec.host:
                return None
            raw = rec.host.pop()
            self._touch_version(rec)
            return self._d(raw)

    def peek_first(self):
        return self.peek()

    def peek_last(self):
        rec = self._engine.store.get(self._name)
        if rec is None or not rec.host:
            return None
        return self._d(rec.host[-1])

    # -- RDeque surface: XX pushes + cross-deque moves ---------------

    def add_first_if_exists(self, *values) -> int:
        """RDeque.addFirstIfExists (LPUSHX): push only onto an EXISTING
        deque; returns the new size (0 = absent, nothing pushed)."""
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None or not rec.host:
                return 0
            for v in values:
                rec.host.insert(0, self._e(v))
            self._touch_version(rec)
        self._signal()
        return self.size()

    def add_last_if_exists(self, *values) -> int:
        """RDeque.addLastIfExists (RPUSHX)."""
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None or not rec.host:
                return 0
            for v in values:
                rec.host.append(self._e(v))
            self._touch_version(rec)
        self._signal()
        return self.size()

    def move(self, dest_name: str, src_end: str = "LEFT", dest_end: str = "LEFT"):
        """RDeque.move (LMOVE src dest LEFT|RIGHT LEFT|RIGHT): atomic
        cross-deque transfer; returns the moved value or None."""
        if src_end.upper() not in ("LEFT", "RIGHT") or dest_end.upper() not in ("LEFT", "RIGHT"):
            raise ValueError("ends must be LEFT or RIGHT")
        dest = Deque(self._engine, dest_name, self._codec)
        names = [self._name, dest._name]
        with self._engine.locked_many(names):
            rec = self._engine.store.get(self._name)
            if rec is None or not rec.host:
                return None
            raw = rec.host.pop(0) if src_end.upper() == "LEFT" else rec.host.pop()
            self._touch_version(rec)
            drec = dest._rec_or_create()
            if dest_end.upper() == "LEFT":
                drec.host.insert(0, raw)
            else:
                drec.host.append(raw)
            dest._touch_version(drec)
        dest._signal()
        return self._d(raw)

    def add_first_to(self, dest_name: str):
        """RDeque.addFirstTo: pop this deque's HEAD onto dest's head."""
        return self.move(dest_name, "LEFT", "LEFT")

    def add_last_to(self, dest_name: str):
        """RDeque.addLastTo: pop this deque's HEAD onto dest's tail."""
        return self.move(dest_name, "LEFT", "RIGHT")


class BlockingQueue(Queue):
    """RBlockingQueue: take/poll(timeout) park on the wait entry and are woken
    by offers (the BLPOP + pubsub-wakeup pattern)."""

    _kind = "blocking_queue"

    def take(self):
        return self.poll_blocking(None)

    def _poll_blocking_impl(self, poll_fn, timeout: Optional[float]):
        """One wait policy for every blocking-poll flavor: park the FULL
        remaining budget (the offer side signals the wait entry)."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            v = poll_fn()
            if v is not None:
                return v
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                return None
            self._wait_entry().wait_for(remaining if remaining is not None else 1.0)

    def poll_blocking(self, timeout: Optional[float]):
        return self._poll_blocking_impl(self.poll, timeout)

    def poll_from_any(self, timeout: Optional[float], *other_names: str):
        """BLPOP across several queues (RBlockingQueue.pollFromAny).
        Handles are built ONCE from logical names (the ctor applies the
        NameMapper; re-feeding self._name through it would double-map),
        and the returned name is the logical one the caller passed."""
        pairs = [(self._unmap_name(self._name), self)] + [
            (nm, BlockingQueue(self._engine, nm, self._codec)) for nm in other_names
        ]
        deadline = None if timeout is None else time.time() + timeout
        while True:
            for nm, h in pairs:
                v = h.poll()
                if v is not None:
                    return nm, v
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                return None, None
            self._wait_entry().wait_for(min(0.05, remaining) if remaining else 0.05)

    def poll_last_and_offer_first_to_blocking(self, dest_name: str, timeout: Optional[float]):
        """BRPOPLPUSH."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            v = self.poll_last_and_offer_first_to(dest_name)
            if v is not None:
                return v
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                return None
            self._wait_entry().wait_for(remaining if remaining is not None else 1.0)

    def drain_to(self, collection: list, max_elements: Optional[int] = None) -> int:
        items = self.poll_many(max_elements if max_elements is not None else 1 << 62)
        collection.extend(items)
        return len(items)


class BlockingDeque(BlockingQueue, Deque):
    _kind = "blocking_deque"

    def take_first(self):
        return self.take()

    def take_last(self):
        while True:
            v = self.poll_last()
            if v is not None:
                return v
            self._wait_entry().wait_for(1.0)

    def poll_last_blocking(self, timeout: Optional[float]):
        """Tail-end bounded blocking poll (pollLastAsync with timeout — the
        subscribeOnLastElements feed); shares poll_blocking's wait policy."""
        return self._poll_blocking_impl(self.poll_last, timeout)


class BoundedBlockingQueue(BlockingQueue):
    """RBoundedBlockingQueue: capacity gate on offer (semaphore channel in the
    reference, RedissonBoundedBlockingQueue.java)."""

    _kind = "bounded_blocking_queue"

    def try_set_capacity(self, capacity: int) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if "capacity" in rec.meta:
                return False
            rec.meta["capacity"] = capacity
            return True

    def _capacity(self, rec) -> int:
        return rec.meta.get("capacity", 1 << 62)

    def offer(self, value, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._engine.locked(self._name):
                rec = self._rec_or_create()
                if len(rec.host) < self._capacity(rec):
                    rec.host.append(self._e(value))
                    self._touch_version(rec)
                    self._signal()
                    return True
            if timeout is None:
                return False
            remaining = deadline - time.time()
            if remaining <= 0:
                return False
            self._wait_entry().wait_for(remaining)

    def put(self, value) -> None:
        while not self.offer(value, timeout=1.0):
            pass

    def poll(self):
        v = super().poll()
        if v is not None:
            self._signal()  # wake producers waiting for space
        return v


class PriorityQueue(Queue):
    """RPriorityQueue: heap-ordered by value (or key function)."""

    _kind = "priority_queue"

    def __init__(self, engine, name, codec=None, key=None):
        super().__init__(engine, name, codec)
        self._key = key

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host=[])
        )

    def _hk(self, value):
        return self._key(value) if self._key else value

    def offer(self, value) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            heapq.heappush(rec.host, (self._hk(value), self._e(value)))
            self._touch_version(rec)
        self._signal()
        return True

    def poll(self):
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if not rec.host:
                return None
            _, raw = heapq.heappop(rec.host)
            self._touch_version(rec)
            return self._d(raw)

    def peek(self):
        rec = self._engine.store.get(self._name)
        if rec is None or not rec.host:
            return None
        return self._d(rec.host[0][1])

    def read_all(self) -> List:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [self._d(raw) for _, raw in sorted(rec.host)]

    # The heap stores (sort_key, raw) tuples, not flat raw values, so every
    # list-shaped op inherited from Queue must be re-expressed over tuples.

    def poll_many(self, limit: int) -> List:
        out = []
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            while rec.host and len(out) < limit:
                _, raw = heapq.heappop(rec.host)
                out.append(self._d(raw))
            if out:
                self._touch_version(rec)
        return out

    def contains(self, value) -> bool:
        e = self._e(value)
        rec = self._engine.store.get(self._name)
        return rec is not None and any(raw == e for _, raw in rec.host)

    def remove(self, value) -> bool:
        e = self._e(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for i, (_, raw) in enumerate(rec.host):
                if raw == e:
                    rec.host.pop(i)
                    heapq.heapify(rec.host)
                    self._touch_version(rec)
                    return True
            return False

    def poll_last_and_offer_first_to(self, dest_name: str):
        """Moves the comparator-greatest element to the head of `dest_name`
        (RPOPLPUSH shape; the destination is a priority queue of the same
        type, so "first" means heap order there too)."""
        dest = type(self)(self._engine, dest_name, self._codec, self._key)
        with self._engine.locked_many((self._name, dest._name)):
            rec = self._rec_or_create()
            if not rec.host:
                return None
            i = max(range(len(rec.host)), key=lambda j: rec.host[j])
            hk, raw = rec.host.pop(i)
            heapq.heapify(rec.host)
            drec = dest._rec_or_create()
            heapq.heappush(drec.host, (hk, raw))
            self._touch_version(rec)
            self._touch_version(drec)
        dest._signal()
        return self._d(raw)


class PriorityDeque(PriorityQueue):
    """RPriorityDeque (`RedissonPriorityDeque.java`): deque view over the
    comparator order.  Positional inserts are meaningless on a heap, so
    addFirst/addLast raise — the reference throws
    UnsupportedOperationException("use add or put method")."""

    def add_first(self, value):
        raise NotImplementedError("use add/offer — order is comparator-defined")

    def add_last(self, value):
        raise NotImplementedError("use add/offer — order is comparator-defined")

    offer_first = add_first
    offer_last = add_last

    def poll_first(self):
        return self.poll()

    def peek_first(self):
        return self.peek()

    def poll_last(self):
        """Removes the comparator-greatest element (heap max)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if not rec.host:
                return None
            i = max(range(len(rec.host)), key=lambda j: rec.host[j])
            _, raw = rec.host.pop(i)
            heapq.heapify(rec.host)
            self._touch_version(rec)
            return self._d(raw)

    def peek_last(self):
        rec = self._engine.store.get(self._name)
        if rec is None or not rec.host:
            return None
        return self._d(max(rec.host)[1])

    def read_all_descending(self) -> List:
        """descendingIterator materialized."""
        return list(reversed(self.read_all()))


class PriorityBlockingQueue(PriorityQueue, BlockingQueue):
    """RPriorityBlockingQueue: heap order + parked take/poll(timeout).
    MRO gives heap offer/poll from PriorityQueue and the wait-entry parking
    from BlockingQueue; cross-queue polls are unsupported exactly like the
    reference (`RedissonPriorityBlockingQueue.java` pollFromAny)."""

    def poll_from_any(self, timeout, *other_names):
        raise NotImplementedError("use poll method")

    def poll_last_and_offer_first_to_blocking(self, dest_name, timeout):
        raise NotImplementedError("use poll method")


class PriorityBlockingDeque(PriorityBlockingQueue, PriorityDeque):
    """RPriorityBlockingDeque: blocking + deque views of the heap."""

    def take_first(self):
        return self.poll_blocking(None)

    def take_last(self):
        return self.poll_last_blocking(None)

    def poll_first_blocking(self, timeout: Optional[float]):
        return self.poll_blocking(timeout)

    def poll_last_blocking(self, timeout: Optional[float]):
        return self._poll_blocking_impl(self.poll_last, timeout)


class RingBuffer(Queue):
    """RRingBuffer: fixed capacity, overwrites oldest when full."""

    _kind = "ring_buffer"

    def try_set_capacity(self, capacity: int) -> bool:
        if capacity <= 0:
            # a zero bound would make every offer silently drop its element
            raise ValueError("capacity must be positive")
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if "capacity" in rec.meta:
                return False
            rec.meta["capacity"] = capacity
            self._touch_version(rec)  # the bound must replicate
            return True

    def set_capacity(self, capacity: int) -> None:
        """RRingBuffer.setCapacity: change the bound unconditionally;
        shrinking evicts oldest elements (the buffer's overflow rule)."""
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.meta["capacity"] = capacity
            excess = len(rec.host) - capacity
            if excess > 0:
                del rec.host[:excess]  # one splice, not O(n^2) pops
            self._touch_version(rec)  # meta changed even when nothing trimmed

    def capacity(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else rec.meta.get("capacity", 0)

    def offer(self, value) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            cap = rec.meta.get("capacity")
            if cap is None:
                raise RuntimeError("RingBuffer capacity is not set (trySetCapacity first)")
            rec.host.append(self._e(value))
            while len(rec.host) > cap:
                rec.host.pop(0)
            self._touch_version(rec)
        self._signal()
        return True

    def remaining_capacity(self) -> int:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return 0
        return max(0, rec.meta.get("capacity", 0) - len(rec.host))


class DelayedQueue(Queue):
    """RDelayedQueue: elements become visible in the target queue after their
    delay (RedissonDelayedQueue.java: timeout ZSET + QueueTransferTask)."""

    _kind = "delayed_queue"

    def __init__(self, engine, name, codec=None, destination: Optional[Queue] = None):
        super().__init__(engine, name, codec)
        self._dest = destination

    def offer(self, value, delay: float = 0.0) -> bool:
        fire_at = time.time() + delay
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            heapq.heappush(rec.host, (fire_at, self._e(value)))
            self._touch_version(rec)
        self._schedule_transfer(delay)
        return True

    def _schedule_transfer(self, delay: float):
        # shared wheel timer (QueueTransferTask rides the reference's
        # HashedWheelTimer the same way) — not a thread per offer; the
        # transfer itself runs on the timer pool (it takes record locks)
        self._engine.schedule_timeout(self.transfer_due, max(0.0, delay))

    def transfer_due(self) -> int:
        """QueueTransferTask.pushTask analog: move due elements to the target."""
        if self._dest is None:
            return 0
        moved = 0
        now = time.time()
        with self._engine.locked_many((self._name, self._dest._name)):
            rec = self._rec_or_create()
            drec = self._dest._rec_or_create()
            while rec.host and rec.host[0][0] <= now:
                _, raw = heapq.heappop(rec.host)
                drec.host.append(raw)
                moved += 1
            if moved:
                self._touch_version(rec)
                self._touch_version(drec)
        if moved:
            self._dest._signal()
        return moved

    def poll(self):
        """Poll the *buffer* (not-yet-due elements), earliest first."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if not rec.host:
                return None
            _, raw = heapq.heappop(rec.host)
            self._touch_version(rec)
            return self._d(raw)

    def read_all(self) -> List:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [self._d(raw) for _, raw in sorted(rec.host)]


class TransferQueue(BlockingQueue):
    """RTransferQueue: transfer() blocks until a consumer takes the element."""

    _kind = "transfer_queue"

    def try_transfer(self, value) -> bool:
        """Hand off only if a consumer is already waiting."""
        we = self._wait_entry()
        with we.cond:
            waiting = len(we.cond._waiters) > 0  # type: ignore[attr-defined]
        if not waiting:
            return False
        self.offer(value)
        return True

    def transfer(self, value, timeout: Optional[float] = None) -> bool:
        """Blocks until the element is consumed."""
        marker = self._e(value)
        self.offer(value)
        deadline = None if timeout is None else time.time() + timeout
        while True:
            rec = self._engine.store.get(self._name)
            if rec is None or marker not in rec.host:
                return True
            if deadline is not None and time.time() >= deadline:
                with self._engine.locked(self._name):
                    rec = self._rec_or_create()
                    if marker in rec.host:
                        rec.host.remove(marker)
                        return False
                return True
            time.sleep(0.005)
