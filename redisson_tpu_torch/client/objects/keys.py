"""Keys: keyspace administration (RKeys analog).

Parity target: ``org/redisson/RedissonKeys.java`` (545 LoC) — SCAN-based key
iteration, DEL/UNLINK batched per shard, EXPIRE, RANDOMKEY, COUNT, FLUSHDB.
The reference fans these out per master entry via readBatchedAsync /
SlotCallback (``command/CommandAsyncService.java:575-640``); in-process the
store is one registry, and in mesh mode the same surface fans out per shard.

A copy of ``redisson_tpu/client/objects/keys.py`` on the port's engine.
"""
from __future__ import annotations

import random
import time
from typing import Iterable, Iterator, List, Optional


class Keys:
    def __init__(self, engine):
        self._engine = engine

    def _map(self, name: str) -> str:
        """NameMapper applies to the admin surface too (the reference maps
        in RedissonKeys the same way): callers pass LOGICAL names."""
        mapper = getattr(self._engine.config, "name_mapper", None)
        return mapper.map(name) if mapper is not None else name

    def _unmap(self, key: str) -> str:
        mapper = getattr(self._engine.config, "name_mapper", None)
        return mapper.unmap(key) if mapper is not None else key

    def _map_pattern(self, pattern: Optional[str]) -> Optional[str]:
        # patterns are LOGICAL too: prefix mappers compose naturally
        # ("cfg*" -> "t:cfg*"); identity mappers are no-ops
        return None if pattern is None else self._map(pattern)

    def get_keys(self, pattern: Optional[str] = None) -> List[str]:
        """LOGICAL names in and out — results must round-trip into
        get_bucket()/delete() without double-prefixing."""
        return [self._unmap(k) for k in self._engine.store.keys(self._map_pattern(pattern))]

    def get_keys_stream(self, pattern: Optional[str] = None, chunk: int = 10) -> Iterator[str]:
        """Cursor-style iteration (SCAN analog; chunk mirrors COUNT)."""
        for name in self._engine.store.keys(self._map_pattern(pattern)):
            yield self._unmap(name)

    def count(self) -> int:
        return len(self._engine.store.keys())

    def count_exists(self, *names: str) -> int:
        return sum(1 for n in names if self._engine.store.exists(self._map(n)))

    def random_key(self) -> Optional[str]:
        keys = self._engine.store.keys()
        return self._unmap(random.choice(keys)) if keys else None

    def delete(self, *names: str) -> int:
        n = 0
        for nm in names:
            key = self._map(nm)
            with self._engine.locked(key):
                if self._engine.store.delete(key):
                    n += 1
        return n

    def delete_by_pattern(self, pattern: str) -> int:
        n = 0
        for key in self._engine.store.keys(self._map_pattern(pattern)):
            with self._engine.locked(key):
                if self._engine.store.delete(key):
                    n += 1
        return n

    def unlink(self, *names: str) -> int:
        # no async reclamation distinction in-process; same as delete
        return self.delete(*names)

    def expire(self, name: str, seconds: float) -> bool:
        return self._engine.store.expire(self._map(name), time.time() + seconds)

    def remain_time_to_live(self, name: str) -> Optional[float]:
        return self._engine.store.ttl(self._map(name))

    def flushdb(self) -> None:
        self._engine.store.flushall()

    def flushall(self) -> None:
        self._engine.store.flushall()
