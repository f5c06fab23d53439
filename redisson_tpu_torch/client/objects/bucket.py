"""Bucket family: single-value holders and atomic counters, a port of
``redisson_tpu/client/objects/bucket.py``.

  * RBucket: get/set, getAndSet, trySet (SETNX), compareAndSet,
    setIfExists, getAndDelete, the TTL variants.
  * RBuckets: MGET/MSET/MSETNX across keys.
  * RAtomicLong / RAtomicDouble: the INCR family.
  * RIdGenerator: ids from a locally cached allocation block.

These are control-plane objects: host values (``StateRecord.host``) with
compare-and-mutate semantics and no device work.  Redis makes them atomic
with server-side Lua; here every compound op runs under the object's record
lock.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord

_SENTINEL = object()


class Bucket(RExpirable):
    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, "bucket", lambda: StateRecord(kind="bucket", host={"v": _SENTINEL})
        )

    def get(self) -> Any:
        rec = self._engine.store.get(self._name)
        if rec is None or rec.host["v"] is _SENTINEL:
            return None
        return self._codec.decode(rec.host["v"])

    def set(self, value: Any, ttl: Optional[float] = None) -> None:
        data = self._codec.encode(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host["v"] = data
            rec.expire_at = time.time() + ttl if ttl is not None else None
            self._touch_version(rec)

    def get_and_set(self, value: Any) -> Any:
        with self._engine.locked(self._name):
            old = self.get()
            self.set(value)
            return old

    def try_set(self, value: Any, ttl: Optional[float] = None) -> bool:
        """SETNX semantics (RedissonBucket trySet)."""
        with self._engine.locked(self._name):
            if self.get() is not None:
                return False
            self.set(value, ttl)
            return True

    def set_if_exists(self, value: Any) -> bool:
        with self._engine.locked(self._name):
            if self.get() is None:
                return False
            self.set(value)
            return True

    def compare_and_set(self, expect: Any, update: Any) -> bool:
        """CAS via encoded-value equality (RedissonBucket compareAndSet Lua)."""
        with self._engine.locked(self._name):
            cur = self.get()
            if cur != expect:
                return False
            self.set(update)
            return True

    def set_if_absent(self, value: Any, ttl: Optional[float] = None) -> bool:
        """RBucket.setIfAbsent — the modern name for trySet."""
        return self.try_set(value, ttl)

    def set_and_keep_ttl(self, value: Any) -> None:
        """RBucket.setAndKeepTTL (SET ... KEEPTTL): replace the value
        without disturbing the record's expiry."""
        data = self._codec.encode(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host["v"] = data  # expire_at untouched
            self._touch_version(rec)

    def get_and_expire(self, ttl: float) -> Any:
        """RBucket.getAndExpire (GETEX EX): read + set expiry atomically."""
        with self._engine.locked(self._name):
            old = self.get()
            if old is not None:
                self._engine.store.expire(self._name, time.time() + ttl)
            return old

    def get_and_clear_expire(self) -> Any:
        """RBucket.getAndClearExpire (GETEX PERSIST)."""
        with self._engine.locked(self._name):
            old = self.get()
            if old is not None:
                self._engine.store.expire(self._name, None)
            return old

    def get_and_delete(self) -> Any:
        with self._engine.locked(self._name):
            old = self.get()
            self._engine.store.delete(self._name)
            return old

    def size(self) -> int:
        """Encoded payload size in bytes (STRLEN analog)."""
        rec = self._engine.store.get(self._name)
        if rec is None or rec.host["v"] is _SENTINEL:
            return 0
        return len(rec.host["v"])


class Buckets:
    """Multi-key get/set (RBuckets: MGET/MSET; grouping per slot is moot in
    process but the API surface is kept)."""

    def __init__(self, engine, codec=None):
        self._engine = engine
        self._codec = codec or engine.default_codec

    def get(self, *names: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for nm in names:
            v = Bucket(self._engine, nm, self._codec).get()
            if v is not None:
                out[nm] = v
        return out

    def set(self, values: Dict[str, Any]) -> None:
        for nm, v in values.items():
            Bucket(self._engine, nm, self._codec).set(v)

    def try_set(self, values: Dict[str, Any]) -> bool:
        """MSETNX: all-or-nothing if any key exists."""
        handles = {nm: Bucket(self._engine, nm, self._codec) for nm in sorted(values)}
        with self._engine.locked_many([h._name for h in handles.values()]):
            for h in handles.values():
                if h.get() is not None:
                    return False
            for nm, h in handles.items():
                h.set(values[nm])
            return True


class AtomicLong(RExpirable):
    _kind = "atomic_long"
    _zero = 0

    def _coerce(self, v):
        return int(v)

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host={"v": self._zero})
        )

    def get(self):
        rec = self._engine.store.get(self._name)
        return self._zero if rec is None else rec.host["v"]

    def set(self, value) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host["v"] = self._coerce(value)
            self._touch_version(rec)

    def add_and_get(self, delta):
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host["v"] = rec.host["v"] + self._coerce(delta)
            self._touch_version(rec)
            return rec.host["v"]

    def get_and_add(self, delta):
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = rec.host["v"]
            rec.host["v"] = old + self._coerce(delta)
            self._touch_version(rec)
            return old

    def increment_and_get(self):
        return self.add_and_get(1)

    def decrement_and_get(self):
        return self.add_and_get(-1)

    def get_and_increment(self):
        return self.get_and_add(1)

    def get_and_decrement(self):
        return self.get_and_add(-1)

    def compare_and_set(self, expect, update) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if rec.host["v"] != expect:
                return False
            rec.host["v"] = self._coerce(update)
            self._touch_version(rec)
            return True

    def get_and_set(self, value):
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = rec.host["v"]
            rec.host["v"] = self._coerce(value)
            self._touch_version(rec)
            return old

    def get_and_delete(self):
        """RAtomicLong.getAndDelete: read the counter and drop the record
        atomically (a later read restarts from zero)."""
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            old = self._zero if rec is None else rec.host["v"]
            self._engine.store.delete(self._name)
            return old


class AtomicDouble(AtomicLong):
    """RAtomicDouble (INCRBYFLOAT family)."""

    _kind = "atomic_double"
    _zero = 0.0

    def _coerce(self, v):
        return float(v)


class IdGenerator(RExpirable):
    """RIdGenerator: ids handed out from a locally cached allocation block
    refilled from a shared counter."""

    _kind = "id_generator"

    def __init__(self, engine, name, codec=None):
        super().__init__(engine, name, codec)
        self._local_next = 0
        self._local_limit = 0

    def try_init(self, start: int = 0, allocation_size: int = 5000) -> bool:
        with self._engine.locked(self._name):
            if self._engine.store.exists(self._name):
                return False
            self._engine.store.put(
                self._name,
                StateRecord(kind=self._kind, host={"next": start, "block": allocation_size}),
            )
            return True

    def next_id(self) -> int:
        if self._local_next < self._local_limit:
            v = self._local_next
            self._local_next += 1
            return v
        with self._engine.locked(self._name):
            rec = self._engine.store.get_or_create(
                self._name,
                self._kind,
                lambda: StateRecord(kind=self._kind, host={"next": 0, "block": 5000}),
            )
            start = rec.host["next"]
            rec.host["next"] = start + rec.host["block"]
            self._touch_version(rec)
            self._local_next = start + 1
            self._local_limit = start + rec.host["block"]
            return start
