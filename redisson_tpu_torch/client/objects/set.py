"""Set family.

Parity targets:
  * RSet — ``org/redisson/RedissonSet.java`` (900 LoC): add/remove/contains,
    SSCAN iteration, union/intersection/diff (+ read/store variants),
    random/pop members, move.
  * RSetCache — ``RedissonSetCache.java`` (1,425 LoC): per-value TTL (the
    reference scores a ZSET by expiry; here expiry is stored per element).
  * RSortedSet / RLexSortedSet — ``RedissonSortedSet.java`` (510 LoC):
    comparator-ordered set.

Elements are codec-encoded (set membership = encoded equality, the reference
contract).

A copy of ``redisson_tpu/client/objects/set.py`` on the port's engine.
"""
from __future__ import annotations

import random
import time
from typing import Any, Iterable, Iterator, List, Optional

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord


class Set(RExpirable):
    _kind = "set"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host=set())
        )

    def _e(self, v) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw: bytes):
        return self._codec.decode(raw)

    def add(self, value) -> bool:
        e = self._e(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if e in rec.host:
                return False
            rec.host.add(e)
            self._touch_version(rec)
            return True

    # -- RSet surface: counted bulk ops, tryAdd, containsEach,
    # -- per-value synchronizers (RSet.java:39-75, 300-337)

    def add_all_counted(self, values: Iterable) -> int:
        """RSet.addAllCounted: number of elements actually ADDED."""
        n = 0
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for v in values:
                e = self._e(v)
                if e not in rec.host:
                    rec.host.add(e)
                    n += 1
            if n:
                self._touch_version(rec)
        return n

    def remove_all_counted(self, values: Iterable) -> int:
        """RSet.removeAllCounted: number of elements actually REMOVED."""
        n = 0
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return 0
            for v in values:
                e = self._e(v)
                if e in rec.host:
                    rec.host.discard(e)
                    n += 1
            if n:
                self._touch_version(rec)
        return n

    def try_add(self, *values) -> bool:
        """RSet.tryAdd: all-or-nothing — adds only when NONE are present."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            encoded = [self._e(v) for v in values]
            if any(e in rec.host for e in encoded):
                return False
            rec.host.update(encoded)
            self._touch_version(rec)
            return True

    def contains_each(self, values: Iterable) -> List:
        """RSet.containsEach: the subset of `values` present in the set."""
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [v for v in values if self._e(v) in rec.host]

    # per-value synchronizers: each value gets its own lock/semaphore/latch
    # namespace derived from the set name + the encoded value (the
    # reference suffixes the value's hash the same way)

    def _value_object_name(self, value, kind: str) -> str:
        import hashlib

        h = hashlib.sha1(self._e(value)).hexdigest()[:16]
        return f"{self._name}:{h}:{kind}"

    def get_lock(self, value):
        from redisson_tpu_torch.client.objects.lock import Lock

        return Lock(self._engine, self._value_object_name(value, "lock"))

    def get_fair_lock(self, value):
        from redisson_tpu_torch.client.objects.lock import FairLock

        return FairLock(self._engine, self._value_object_name(value, "fairlock"))

    def get_read_write_lock(self, value):
        from redisson_tpu_torch.client.objects.lock import ReadWriteLock

        return ReadWriteLock(self._engine, self._value_object_name(value, "rwlock"))

    def get_semaphore(self, value):
        from redisson_tpu_torch.client.objects.semaphore import Semaphore

        return Semaphore(self._engine, self._value_object_name(value, "semaphore"))

    def get_permit_expirable_semaphore(self, value):
        from redisson_tpu_torch.client.objects.semaphore import PermitExpirableSemaphore

        return PermitExpirableSemaphore(
            self._engine, self._value_object_name(value, "psemaphore")
        )

    def get_count_down_latch(self, value):
        from redisson_tpu_torch.client.objects.semaphore import CountDownLatch

        return CountDownLatch(self._engine, self._value_object_name(value, "latch"))

    def add_all(self, values: Iterable) -> bool:
        changed = False
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for v in values:
                e = self._e(v)
                if e not in rec.host:
                    rec.host.add(e)
                    changed = True
            if changed:
                self._touch_version(rec)
        return changed

    def remove(self, value) -> bool:
        e = self._e(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if e not in rec.host:
                return False
            rec.host.discard(e)
            self._touch_version(rec)
            return True

    def remove_all(self, values: Iterable) -> bool:
        changed = False
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for v in values:
                if self._e(v) in rec.host:
                    rec.host.discard(self._e(v))
                    changed = True
            if changed:
                self._touch_version(rec)
        return changed

    def retain_all(self, values: Iterable) -> bool:
        keep = {self._e(v) for v in values}
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            before = len(rec.host)
            rec.host &= keep
            if len(rec.host) != before:
                self._touch_version(rec)
                return True
            return False

    def contains(self, value) -> bool:
        rec = self._engine.store.get(self._name)
        return rec is not None and self._e(value) in rec.host

    def contains_all(self, values: Iterable) -> bool:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return False
        return all(self._e(v) in rec.host for v in values)

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

    def __iter__(self) -> Iterator:
        return iter(self.read_all())

    def __len__(self):
        return self.size()

    def __contains__(self, value):
        return self.contains(value)

    def random_member(self):
        rec = self._engine.store.get(self._name)
        if rec is None or not rec.host:
            return None
        return self._d(random.choice(list(rec.host)))

    def random_members(self, count: int) -> List:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        pool = list(rec.host)
        return [self._d(e) for e in random.sample(pool, min(count, len(pool)))]

    def remove_random(self):
        """SPOP."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if not rec.host:
                return None
            e = random.choice(list(rec.host))
            rec.host.discard(e)
            self._touch_version(rec)
            return self._d(e)

    def move(self, dest_name: str, value) -> bool:
        """SMOVE (RedissonSet.move)."""
        e = self._e(value)
        dest_h = Set(self._engine, dest_name, self._codec)  # maps dest_name
        with self._engine.locked_many((self._name, dest_h._name)):
            rec = self._rec_or_create()
            if e not in rec.host:
                return False
            dest = dest_h._rec_or_create()
            rec.host.discard(e)
            dest.host.add(e)
            self._touch_version(rec)
            self._touch_version(dest)
            return True

    # -- set algebra (SUNION/SINTER/SDIFF + STORE variants) ------------------

    def _others(self, names):
        """`names` are STORED keys (callers map logical operands once)."""
        out = []
        for nm in names:
            rec = self._engine.store.get(nm)
            out.append(set() if rec is None else set(rec.host))
        return out

    def read_union(self, *names: str) -> List:
        names = tuple(self._map_name(n) for n in names)
        with self._engine.locked_many((self._name, *names)):
            rec = self._rec_or_create()
            acc = set(rec.host)
            for s in self._others(names):
                acc |= s
        return [self._d(e) for e in acc]

    def read_intersection(self, *names: str) -> List:
        names = tuple(self._map_name(n) for n in names)
        with self._engine.locked_many((self._name, *names)):
            rec = self._rec_or_create()
            acc = set(rec.host)
            for s in self._others(names):
                acc &= s
        return [self._d(e) for e in acc]

    def read_diff(self, *names: str) -> List:
        names = tuple(self._map_name(n) for n in names)
        with self._engine.locked_many((self._name, *names)):
            rec = self._rec_or_create()
            acc = set(rec.host)
            for s in self._others(names):
                acc -= s
        return [self._d(e) for e in acc]

    def union(self, *names: str) -> int:
        """SUNIONSTORE into this set; returns resulting size."""
        names = tuple(self._map_name(n) for n in names)
        with self._engine.locked_many((self._name, *names)):
            rec = self._rec_or_create()
            acc = set()
            for s in self._others((self._name, *names)):
                acc |= s
            rec.host.clear()
            rec.host |= acc
            self._touch_version(rec)
            return len(rec.host)

    def intersection(self, *names: str) -> int:
        names = tuple(self._map_name(n) for n in names)
        with self._engine.locked_many((self._name, *names)):
            rec = self._rec_or_create()
            sets = self._others((self._name, *names))
            acc = sets[0]
            for s in sets[1:]:
                acc &= s
            rec.host.clear()
            rec.host |= acc
            self._touch_version(rec)
            return len(rec.host)

    def diff(self, *names: str) -> int:
        names = tuple(self._map_name(n) for n in names)
        with self._engine.locked_many((self._name, *names)):
            rec = self._rec_or_create()
            sets = self._others((self._name, *names))
            acc = sets[0]
            for s in sets[1:]:
                acc -= s
            rec.host.clear()
            rec.host |= acc
            self._touch_version(rec)
            return len(rec.host)


class SetCache(RExpirable):
    """RSetCache: add(value, ttl) with per-value expiry."""

    _kind = "set_cache"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host={})
        )

    def _e(self, v) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw: bytes):
        return self._codec.decode(raw)

    def _live(self, rec, e, now=None) -> bool:
        exp = rec.host.get(e, _MISSING)
        if exp is _MISSING:
            return False
        if exp is not None and (now or time.time()) >= exp:
            del rec.host[e]
            return False
        return True

    def add(self, value, ttl: Optional[float] = None) -> bool:
        e = self._e(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            fresh = not self._live(rec, e)
            rec.host[e] = time.time() + ttl if ttl else None
            self._touch_version(rec)
            return fresh

    def contains(self, value) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            return self._live(rec, self._e(value))

    def remove(self, value) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            e = self._e(value)
            live = self._live(rec, e)
            rec.host.pop(e, None)
            if live:
                self._touch_version(rec)
            return live

    def size(self) -> int:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            now = time.time()
            for e in list(rec.host.keys()):
                self._live(rec, e, now)
            return len(rec.host)

    def read_all(self) -> List:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            now = time.time()
            return [self._d(e) for e in list(rec.host.keys()) if self._live(rec, e, now)]

    def reap_expired(self) -> int:
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return 0
            before = len(rec.host)
            now = time.time()
            for e in list(rec.host.keys()):
                self._live(rec, e, now)
            return before - len(rec.host)


_MISSING = object()


class SortedSet(RExpirable):
    """RSortedSet: natural/comparator ordering over distinct values.

    The reference keeps a Redis LIST in sorted order guarded by a lock
    (RedissonSortedSet.java); here a sorted host list under the record lock.
    """

    _kind = "sorted_set"

    def __init__(self, engine, name, codec=None, key=None):
        super().__init__(engine, name, codec)
        self._key = key  # comparator analog: sort key over *decoded* values

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host=[])
        )

    def _sortkey(self, v):
        return self._key(v) if self._key else v

    def add(self, value) -> bool:
        import bisect

        e = self._codec.encode(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            decoded = [self._codec.decode(x) for x in rec.host]
            if value in decoded:
                return False
            keys = [self._sortkey(d) for d in decoded]
            i = bisect.bisect_right(keys, self._sortkey(value))
            rec.host.insert(i, e)
            self._touch_version(rec)
            return True

    def add_all(self, values: Iterable) -> bool:
        changed = False
        for v in values:
            changed |= self.add(v)
        return changed

    def remove(self, value) -> bool:
        e = self._codec.encode(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            try:
                rec.host.remove(e)
            except ValueError:
                return False
            self._touch_version(rec)
            return True

    def contains(self, value) -> bool:
        rec = self._engine.store.get(self._name)
        return rec is not None and self._codec.encode(value) in rec.host

    def size(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else len(rec.host)

    def read_all(self) -> List:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [self._codec.decode(e) for e in list(rec.host)]

    def first(self):
        vals = self.read_all()
        return vals[0] if vals else None

    def last(self):
        vals = self.read_all()
        return vals[-1] if vals else None

    def __iter__(self):
        return iter(self.read_all())


class LexSortedSet(SortedSet):
    """RLexSortedSet: string elements in lexicographic order with range ops."""

    _kind = "lex_sorted_set"

    def __init__(self, engine, name, codec=None):
        from redisson_tpu_torch.client.codec import StringCodec

        super().__init__(engine, name, StringCodec())

    def range(self, from_value: str, from_inclusive: bool, to_value: str, to_inclusive: bool) -> List[str]:
        out = []
        for v in self.read_all():
            lo_ok = v > from_value or (from_inclusive and v == from_value)
            hi_ok = v < to_value or (to_inclusive and v == to_value)
            if lo_ok and hi_ok:
                out.append(v)
        return out

    def range_head(self, to_value: str, inclusive: bool) -> List[str]:
        return [v for v in self.read_all() if v < to_value or (inclusive and v == to_value)]

    def range_tail(self, from_value: str, inclusive: bool) -> List[str]:
        return [v for v in self.read_all() if v > from_value or (inclusive and v == from_value)]

    def count(self, from_value: str, from_inclusive: bool, to_value: str, to_inclusive: bool) -> int:
        return len(self.range(from_value, from_inclusive, to_value, to_inclusive))
