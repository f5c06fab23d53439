"""Object handle base classes.

Every object is a cheap, stateless handle (name + codec) over the engine's
DeviceStore, as in ``redisson_tpu/client/objects/base.py``.  dump, restore,
copy and migrate belong to the checkpoint slice.
"""
from __future__ import annotations

import time
from typing import Optional

from redisson_tpu_torch.client.codec import Codec
from redisson_tpu_torch.core.engine import Engine


class RObject:
    def __init__(self, engine: Engine, name: str, codec: Optional[Codec] = None):
        self._engine = engine
        self._name = name
        self._codec = codec or engine.default_codec

    @property
    def name(self) -> str:
        return self._name

    @property
    def codec(self) -> Codec:
        return self._codec

    def is_exists(self) -> bool:
        return self._engine.store.exists(self._name)

    def delete(self) -> bool:
        with self._engine.locked(self._name):
            return self._engine.store.delete(self._name)

    def rename(self, new_name: str) -> None:
        with self._engine.locked(self._name):
            if not self._engine.store.rename(self._name, new_name):
                raise KeyError(f"object '{self._name}' does not exist")
            self._name = new_name

    def touch(self) -> bool:
        """True if the object exists."""
        return self._engine.store.exists(self._name)

    def _touch_version(self, rec) -> None:
        rec.version += 1


class RExpirable(RObject):
    def expire(self, seconds: float) -> bool:
        return self._engine.store.expire(self._name, time.time() + seconds)

    def expire_at(self, epoch_seconds: float) -> bool:
        return self._engine.store.expire(self._name, epoch_seconds)

    def clear_expire(self) -> bool:
        return self._engine.store.expire(self._name, None)

    def remain_time_to_live(self) -> Optional[float]:
        """Seconds until expiry; None if persistent or absent."""
        return self._engine.store.ttl(self._name)

    # conditional expiry (EXPIRE NX|XX|GT|LT)

    def _expire_if(self, seconds: float, pred) -> bool:
        with self._engine.locked(self._name):
            if not self._engine.store.exists(self._name):
                return False
            if not pred(self._engine.store.ttl(self._name)):
                return False
            return self._engine.store.expire(self._name, time.time() + seconds)

    def expire_if_set(self, seconds: float) -> bool:
        """EXPIRE XX: only when a TTL already exists."""
        return self._expire_if(seconds, lambda cur: cur is not None)

    def expire_if_not_set(self, seconds: float) -> bool:
        """EXPIRE NX: only when the object is persistent."""
        return self._expire_if(seconds, lambda cur: cur is None)

    def expire_if_greater(self, seconds: float) -> bool:
        """EXPIRE GT: only extend (persistent counts as infinite)."""
        return self._expire_if(seconds, lambda cur: cur is not None and seconds > cur)

    def expire_if_less(self, seconds: float) -> bool:
        """EXPIRE LT: only shorten (always applies when persistent)."""
        return self._expire_if(seconds, lambda cur: cur is None or seconds < cur)
