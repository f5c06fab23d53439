"""List: ordered collection with index access.

Parity target: RList — ``org/redisson/BaseRedissonList.java`` (897 LoC) +
``RedissonList.java``: LPUSH/RPUSH/LRANGE/LINDEX/LSET/LINSERT/LREM semantics,
subList, indexOf, trim, fastSet, range reads.

A copy of ``redisson_tpu/client/objects/list.py`` on the port's engine.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator, List as PyList, Optional

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord


class RList(RExpirable):
    _kind = "list"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host=[])
        )

    def _e(self, v) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw: bytes):
        return self._codec.decode(raw)

    def add(self, value) -> bool:
        """RPUSH one element."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host.append(self._e(value))
            self._touch_version(rec)
            return True

    def add_all(self, values: Iterable) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            added = False
            for v in values:
                rec.host.append(self._e(v))
                added = True
            if added:
                self._touch_version(rec)
            return added

    def add_first(self, value) -> None:
        """LPUSH."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host.insert(0, self._e(value))
            self._touch_version(rec)

    def add_at(self, index: int, value) -> None:
        """LINSERT-by-index (reference add(index, element))."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if index < 0 or index > len(rec.host):
                raise IndexError(index)
            rec.host.insert(index, self._e(value))
            self._touch_version(rec)

    def _add_relative(self, pivot, value, after: bool) -> int:
        """LINSERT BEFORE|AFTER pivot; new length, or -1 if pivot absent."""
        ep, ev = self._e(pivot), self._e(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            try:
                i = rec.host.index(ep)
            except ValueError:
                return -1
            rec.host.insert(i + 1 if after else i, ev)
            self._touch_version(rec)
            return len(rec.host)

    def add_after(self, pivot, value) -> int:
        """RList.addAfter (LINSERT AFTER)."""
        return self._add_relative(pivot, value, after=True)

    def add_before(self, pivot, value) -> int:
        """RList.addBefore (LINSERT BEFORE)."""
        return self._add_relative(pivot, value, after=False)

    def sub_list(self, from_index: int, to_index: int) -> PyList:
        """RList.subList materialized (reference returns a live view; a
        snapshot honors the same read semantics without proxy plumbing)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if from_index < 0 or to_index > len(rec.host) or from_index > to_index:
                raise IndexError(f"subList({from_index}, {to_index}) out of bounds")
            return [self._d(e) for e in rec.host[from_index:to_index]]

    def get(self, index: int):
        """LINDEX; raises IndexError out of range (reference throws)."""
        rec = self._engine.store.get(self._name)
        if rec is None:
            raise IndexError(index)
        return self._d(rec.host[index])

    def set(self, index: int, value):
        """LSET; returns previous element."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = rec.host[index]
            rec.host[index] = self._e(value)
            self._touch_version(rec)
            return self._d(old)

    def fast_set(self, index: int, value) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host[index] = self._e(value)
            self._touch_version(rec)

    def remove(self, value) -> bool:
        """LREM count=1."""
        e = self._e(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            try:
                rec.host.remove(e)
            except ValueError:
                return False
            self._touch_version(rec)
            return True

    def remove_at(self, index: int):
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = rec.host.pop(index)
            self._touch_version(rec)
            return self._d(old)

    def remove_count(self, value, count: int) -> bool:
        """LREM with count (sign ignored — removes first |count| occurrences)."""
        e = self._e(value)
        removed = 0
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            while removed < abs(count):
                try:
                    rec.host.remove(e)
                    removed += 1
                except ValueError:
                    break
            if removed:
                self._touch_version(rec)
        return removed > 0

    def index_of(self, value) -> int:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return -1
        try:
            return rec.host.index(self._e(value))
        except ValueError:
            return -1

    def last_index_of(self, value) -> int:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return -1
        e = self._e(value)
        for i in range(len(rec.host) - 1, -1, -1):
            if rec.host[i] == e:
                return i
        return -1

    def contains(self, value) -> bool:
        return self.index_of(value) >= 0

    def size(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else len(rec.host)

    def is_empty(self) -> bool:
        return self.size() == 0

    def read_all(self) -> PyList:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [self._d(e) for e in list(rec.host)]

    def range(self, from_index: int, to_index: int) -> PyList:
        """LRANGE (inclusive bounds, like the reference readAll(from, to))."""
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [self._d(e) for e in rec.host[from_index : to_index + 1]]

    def trim(self, from_index: int, to_index: int) -> None:
        """LTRIM (inclusive)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host[:] = rec.host[from_index : to_index + 1]
            self._touch_version(rec)

    def clear(self) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host.clear()
            self._touch_version(rec)

    def __len__(self):
        return self.size()

    def __iter__(self) -> Iterator:
        return iter(self.read_all())

    def __getitem__(self, index):
        return self.get(index)

    def __setitem__(self, index, value):
        self.fast_set(index, value)
