"""Object handle base classes.

Every object is a cheap, stateless handle (name + codec) over the engine's
DeviceStore, as in ``redisson_tpu/client/objects/base.py``, with its name
mapping (``Config.name_mapper``: logical name -> stored key).  Every
handle's codec is reference-aware (``client/codec.ReferenceCodec``): a
handle stored inside another object persists as a typed reference and reads
back as a live handle, and a handle pickles as an inert ``ObjectRef`` under
the reference's module path.  dump, restore, copy_to and migrate share
``core/checkpoint.py``'s single-record codec with the DUMP, RESTORE and COPY
verbs.
"""
from __future__ import annotations

import time
from typing import Optional

from redisson_tpu_torch.client.codec import Codec, ObjectRef, ReferenceCodec, _codec_spec
from redisson_tpu_torch.core.engine import Engine


class RObject:
    def __init__(self, engine: Engine, name: str, codec: Optional[Codec] = None):
        self._engine = engine
        # NameMapper SPI: logical name -> stored key, applied at handle
        # construction as the reference's RedissonObject ctor does
        mapper = getattr(engine.config, "name_mapper", None)
        self._name = mapper.map(name) if mapper is not None else name
        # every handle's codec is reference-aware: storing another handle
        # persists a typed reference, not a serialized copy
        base = codec or engine.default_codec
        if isinstance(base, ReferenceCodec):
            # rebind to THIS engine: a shipped/shared wrapper may carry no
            # engine (pickled to a worker) or a different one
            self._codec = (
                base if base._engine is engine else ReferenceCodec(base.inner, engine)
            )
        else:
            self._codec = ReferenceCodec(base, engine)

    def __reduce__(self):
        # handles bind an engine and never cross a process boundary live;
        # they pickle as inert ObjectRef descriptors under the reference's
        # module path, with the LOGICAL name (resolution re-enters a factory
        # whose ctor maps again) — the remote result path resolves them back
        # into handles bound to the receiving client (client/remote.py)
        from redisson_tpu_torch.net.safe_pickle import wire_module

        codec = self._codec.inner if isinstance(self._codec, ReferenceCodec) else self._codec
        cls = type(self)
        return (
            ObjectRef,
            (wire_module(cls.__module__) or cls.__module__, cls.__name__,
             self._unmap_name(self._name), _codec_spec(codec)),
        )

    @property
    def name(self) -> str:
        return self._name

    @property
    def _home(self):
        """The card (or the CPU) this object's tensors live on: its owner
        position's with placement on (``Engine.home``)."""
        return self._engine.home(self._name)

    @property
    def codec(self) -> Codec:
        return self._codec

    def is_exists(self) -> bool:
        return self._engine.store.exists(self._name)

    def delete(self) -> bool:
        with self._engine.locked(self._name):
            return self._engine.store.delete(self._name)

    def _map_name(self, name: str) -> str:
        """Logical -> stored key for OTHER-object name parameters (dest
        names, combination operands): cross-key ops must address the same
        namespace this handle's own name was mapped into."""
        mapper = getattr(self._engine.config, "name_mapper", None)
        return mapper.map(name) if mapper is not None else name

    def _unmap_name(self, key: str) -> str:
        mapper = getattr(self._engine.config, "name_mapper", None)
        return mapper.unmap(key) if mapper is not None else key

    def rename(self, new_name: str) -> None:
        mapped = self._map_name(new_name)  # stay inside the namespace
        with self._engine.locked(self._name):
            if not self._engine.store.rename(self._name, mapped):
                raise KeyError(f"object '{self._name}' does not exist")
            self._name = mapped

    def touch(self) -> bool:
        """True if the object exists."""
        return self._engine.store.exists(self._name)

    def unlink(self) -> bool:
        """RObject.unlink: in-process reclamation is immediate, so this is
        delete."""
        return self.delete()

    def dump(self) -> bytes:
        """Portable serialized state (RObject.dump / the DUMP verb): the
        single-record codec shared with checkpoints, plus a hash_version
        stamp (core/checkpoint.dump_record)."""
        from redisson_tpu_torch.core import checkpoint

        return checkpoint.dump_record(self._engine, self._name)

    def _restore(self, state: bytes, ttl: Optional[float], replace: bool) -> None:
        from redisson_tpu_torch.core import checkpoint

        checkpoint.restore_record(self._engine, self._name, state, ttl, replace)

    def restore(self, state: bytes, ttl: Optional[float] = None) -> None:
        """RObject.restore: install a dump under this name; BUSYKEY error if
        the name exists (Redis RESTORE semantics)."""
        self._restore(state, ttl, replace=False)

    def restore_and_replace(self, state: bytes, ttl: Optional[float] = None) -> None:
        self._restore(state, ttl, replace=True)

    def copy_to(self, dest_name: str, replace: bool = False) -> bool:
        """RObject.copy: clone this record under `dest_name` (the COPY verb
        and this method share core/checkpoint.clone_record)."""
        from redisson_tpu_torch.core import checkpoint

        return checkpoint.clone_record(
            self._engine, self._name, self._map_name(dest_name), replace
        )

    def migrate(
        self,
        address: str,
        timeout: float = 10.0,
        delete_local: bool = True,
        replace: bool = False,
        password: Optional[str] = None,
        username: Optional[str] = None,
        ssl_context=None,
    ) -> None:
        """RObject.migrate: DUMP here, RESTORE on the node at `address`
        (tpu://host:port), then delete locally — the Redis MIGRATE recipe.
        The remaining TTL is measured here and travels as RESTORE's explicit
        ttl operand (0: persistent), a destination collision is BUSYKEY
        unless `replace`, and secured destinations take credentials/TLS."""
        from redisson_tpu_torch.net.client import NodeClient

        ttl = self._engine.store.ttl(self._name)  # before dump: no expiry race
        blob = self.dump()
        ttl_ms = max(1, int(ttl * 1000)) if ttl is not None else 0
        node = NodeClient(
            address, ping_interval=0, password=password, username=username,
            ssl_context=ssl_context,
        )
        try:
            args = ("RESTORE", self._name, ttl_ms, blob) + (("REPLACE",) if replace else ())
            node.execute(*args, timeout=timeout)  # error replies RAISE RespError
        finally:
            node.close()
        if delete_local:
            self.delete()

    def _record(self):
        return self._engine.store.get(self._name)

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
