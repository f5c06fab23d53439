"""Multimaps: key -> many values.

Parity targets:
  * RListMultimap / RSetMultimap — ``RedissonListMultimap*.java`` /
    ``RedissonSetMultimap*.java`` (~4k LoC): per-key value collections,
    get/getAll/put/remove/removeAll/fastRemove, keySet/entries, faceted
    per-key views.
  * Cache variants — per-key TTL (RedissonListMultimapCache / SetMultimapCache).

A copy of ``redisson_tpu/client/objects/multimap.py`` on the port's engine.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord


class _BaseMultimap(RExpirable):
    _kind = "multimap"
    _container = list  # overridden

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name,
            self._kind,
            lambda: StateRecord(kind=self._kind, host={"data": {}, "ttl": {}}),
        )

    def _ek(self, k) -> bytes:
        return self._codec.encode_map_key(k)

    def _ev(self, v) -> bytes:
        return self._codec.encode_map_value(v)

    def _dk(self, raw):
        return self._codec.decode_map_key(raw)

    def _dv(self, raw):
        return self._codec.decode_map_value(raw)

    def _live(self, rec, ek) -> bool:
        exp = rec.host["ttl"].get(ek)
        if exp is not None and time.time() >= exp:
            rec.host["data"].pop(ek, None)
            rec.host["ttl"].pop(ek, None)
            return False
        return ek in rec.host["data"]

    def put(self, key, value) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            ek = self._ek(key)
            self._live(rec, ek)
            bucket = rec.host["data"].setdefault(ek, self._container())
            return self._add(rec, bucket, self._ev(value))

    def put_all(self, key, values: Iterable) -> bool:
        changed = False
        for v in values:
            changed |= self.put(key, v)
        return changed

    def put_all_entries(self, mapping) -> int:
        """Bulk merge {key: [values...]} under ONE lock/one wire frame — the
        batch-first citizen MapReduce mappers use to flush a whole partition
        buffer per call instead of one put per emitted key (the reference's
        Collector.emit writes per emit, mapreduce/Collector.java:56-73)."""
        n = 0
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for key, values in mapping.items():
                ek = self._ek(key)
                self._live(rec, ek)
                bucket = rec.host["data"].setdefault(ek, self._container())
                for v in values:
                    if self._add(rec, bucket, self._ev(v)):
                        n += 1
        return n

    def get_all(self, key) -> List:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            ek = self._ek(key)
            if not self._live(rec, ek):
                return []
            return [self._dv(v) for v in list(rec.host["data"][ek])]

    def remove(self, key, value) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            ek = self._ek(key)
            if not self._live(rec, ek):
                return False
            bucket = rec.host["data"][ek]
            ev = self._ev(value)
            if ev not in bucket:
                return False
            bucket.remove(ev)
            if not bucket:
                del rec.host["data"][ek]
                rec.host["ttl"].pop(ek, None)
            self._touch_version(rec)
            return True

    def replace_values(self, key, values) -> List:
        """RListMultimap.replaceValues: swap the key's whole value
        collection atomically; returns the PREVIOUS values (empty values
        clears the key, matching the reference)."""
        with self._engine.locked(self._name):
            old = self.remove_all(key)
            for v in values:
                self.put(key, v)
            return old

    def remove_all(self, key) -> List:
        """Drops the key; returns its values (RMultimap.removeAll)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            ek = self._ek(key)
            if not self._live(rec, ek):
                return []
            vals = [self._dv(v) for v in rec.host["data"].pop(ek)]
            rec.host["ttl"].pop(ek, None)
            self._touch_version(rec)
            return vals

    def fast_remove(self, *keys) -> int:
        n = 0
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for k in keys:
                ek = self._ek(k)
                if self._live(rec, ek):
                    del rec.host["data"][ek]
                    rec.host["ttl"].pop(ek, None)
                    n += 1
            if n:
                self._touch_version(rec)
        return n

    def contains_key(self, key) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            return self._live(rec, self._ek(key))

    def contains_entry(self, key, value) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            ek = self._ek(key)
            return self._live(rec, ek) and self._ev(value) in rec.host["data"][ek]

    def key_size(self) -> int:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for ek in list(rec.host["data"]):
                self._live(rec, ek)
            return len(rec.host["data"])

    def size(self) -> int:
        """Total number of (key, value) pairs."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            total = 0
            for ek in list(rec.host["data"]):
                if self._live(rec, ek):
                    total += len(rec.host["data"][ek])
            return total

    def read_all_key_set(self) -> List:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            return [self._dk(ek) for ek in list(rec.host["data"]) if self._live(rec, ek)]

    def entries(self) -> List[Tuple]:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            out = []
            for ek in list(rec.host["data"]):
                if self._live(rec, ek):
                    for ev in rec.host["data"][ek]:
                        out.append((self._dk(ek), self._dv(ev)))
            return out

class ListMultimap(_BaseMultimap):
    """RListMultimap: values per key form a list (duplicates kept, order kept)."""

    _kind = "list_multimap"
    _container = list

    def _add(self, rec, bucket: list, ev: bytes) -> bool:
        bucket.append(ev)
        self._touch_version(rec)
        return True


class SetMultimap(_BaseMultimap):
    """RSetMultimap: values per key form a set (encoded uniqueness)."""

    _kind = "set_multimap"
    _container = list  # list-of-unique keeps insertion order deterministic

    def _add(self, rec, bucket: list, ev: bytes) -> bool:
        if ev in bucket:
            return False
        bucket.append(ev)
        self._touch_version(rec)
        return True


class _MultimapCacheMixin:
    """Per-key TTL surface of the cache variants
    (`RedissonListMultimapCache.java` / `RedissonSetMultimapCache.java`):
    the only API the reference adds over the plain multimap is
    `expireKey(key, ttl)`; expiry itself is enforced lazily by `_live` and
    swept by the EvictionScheduler (`eviction/BaseEvictionTask` analog —
    the facade registers `reap_expired` on creation)."""

    def expire_key(self, key, ttl: float) -> bool:
        """RMultimapCache.expireKey — per-key TTL in seconds; False if the
        key is absent (matches the reference's boolean reply)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            ek = self._ek(key)
            if not self._live(rec, ek):
                return False
            rec.host["ttl"][ek] = time.time() + ttl
            self._touch_version(rec)
            return True

    def reap_expired(self) -> int:
        """EvictionScheduler sweep entry point; returns keys removed."""
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return 0
            before = len(rec.host["data"])
            for ek in list(rec.host["data"]):
                self._live(rec, ek)
            return before - len(rec.host["data"])


class ListMultimapCache(_MultimapCacheMixin, ListMultimap):
    """RListMultimapCache: list multimap + per-key TTL."""

    _kind = "list_multimap_cache"


class SetMultimapCache(_MultimapCacheMixin, SetMultimap):
    """RSetMultimapCache: set multimap + per-key TTL."""

    _kind = "set_multimap_cache"
