"""JCache: the JSR-107 javax.cache surface over MapCache.

Parity target: ``org/redisson/jcache/`` (13 files — JCache, JCacheManager,
JCachingProvider; SURVEY.md §2.7).  The reference implements javax.cache.Cache
on top of the same eviction/TTL machinery as RMapCache; this module mirrors
the JSR-107 contract Python-side: get/put/getAndPut/putIfAbsent/replace/
remove(key[, oldValue])/invoke + ExpiryPolicy (created/updated/accessed TTLs)
+ a CacheManager registry keyed by name.

Semantic notes carried over from the spec (and the reference's JCache.java):
  * `put` returns None; `get_and_put` returns the previous value.
  * `remove(key, old)` only removes on value match.
  * Expiry durations: CREATED applies on insert, UPDATED re-arms on replace,
    ACCESSED re-arms on read (mapped onto MapCache's max_idle).
  * A closed cache raises IllegalStateException analog (RuntimeError).
  * Read/write-through (`jcache/JCache.java:77-104,406-421,1257-1290`):
    a CacheLoader fills misses when `read_through` is set; a CacheWriter is
    invoked BEFORE the cache mutates when `write_through` is set, and a
    writer failure leaves the cache unchanged (CacheWriterException).
  * Entry listeners (`jcache/JCache.java:3154-3312`): created/updated/
    removed/expired events with optional filter, `old_value_required`, and
    a `synchronous` flag — synchronous listeners run inline in the mutating
    call (a listener error propagates to the caller, per spec), async ones
    ride the engine events pool.  `clear()` fires NO events (JSR-107
    distinguishes it from removeAll exactly this way).
  * Statistics mirror CacheStatisticsMXBean: hits/misses/gets/puts/
    removals/evictions + average get/put/remove µs.

A copy of ``redisson_tpu/client/jcache.py``.  No cache starts a thread of
its own: expiry rides the engine's one sweep (``core/eviction.py``), events
its shared events pool, and a manager's caches close when the engine shuts
down (``Engine.on_shutdown``), so their sweeps stop with it.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from redisson_tpu_torch.client.objects.map import MapCache


class CacheException(RuntimeError):
    """javax.cache.CacheException analog."""


class CacheLoaderException(CacheException):
    """Wraps a CacheLoader failure (javax.cache.integration)."""


class CacheWriterException(CacheException):
    """Wraps a CacheWriter failure; the cache is left unmodified."""


class CacheLoader:
    """javax.cache.integration.CacheLoader analog.  Subclass or duck-type
    `load`; `load_all` defaults to per-key loads."""

    def load(self, key):  # pragma: no cover - SPI default
        raise NotImplementedError

    def load_all(self, keys: Iterable) -> Dict:
        return {k: v for k in keys if (v := self.load(k)) is not None}


class CacheWriter:
    """javax.cache.integration.CacheWriter analog (write/delete + bulk)."""

    def write(self, key, value):  # pragma: no cover - SPI default
        raise NotImplementedError

    def delete(self, key):  # pragma: no cover - SPI default
        raise NotImplementedError

    def write_all(self, entries: Dict) -> None:
        for k, v in entries.items():
            self.write(k, v)

    def delete_all(self, keys: Iterable) -> None:
        for k in keys:
            self.delete(k)


class CacheEntryEvent:
    """javax.cache.event.CacheEntryEvent analog (JCacheEntryEvent.java)."""

    __slots__ = ("cache", "event_type", "key", "value", "old_value")

    def __init__(self, cache, event_type, key, value, old_value=None):
        self.cache = cache
        self.event_type = event_type  # 'created'|'updated'|'removed'|'expired'
        self.key = key
        self.value = value
        self.old_value = old_value

    def __repr__(self):
        return (f"CacheEntryEvent({self.event_type}, key={self.key!r}, "
                f"value={self.value!r}, old={self.old_value!r})")


class CacheEntryListenerConfiguration:
    """MutableCacheEntryListenerConfiguration analog.  `listener` is an
    object exposing any of on_created/on_updated/on_removed/on_expired
    (each called with one CacheEntryEvent); `filter(event) -> bool` gates
    delivery; `synchronous` listeners run inline in the mutating call."""

    def __init__(self, listener, filter: Optional[Callable] = None,
                 old_value_required: bool = False, synchronous: bool = False):
        self.listener = listener
        self.filter = filter
        self.old_value_required = old_value_required
        self.synchronous = synchronous


class ExpiryPolicy:
    """Durations in seconds; None = eternal (javax.cache.expiry analog)."""

    def __init__(
        self,
        creation: Optional[float] = None,
        update: Optional[float] = None,
        access: Optional[float] = None,
    ):
        self.creation = creation
        self.update = update
        self.access = access

    @classmethod
    def eternal(cls) -> "ExpiryPolicy":
        return cls()

    @classmethod
    def created(cls, ttl: float) -> "ExpiryPolicy":
        return cls(creation=ttl)

    @classmethod
    def touched(cls, ttl: float) -> "ExpiryPolicy":
        # TouchedExpiryPolicy: any interaction re-arms — maps to max_idle
        return cls(access=ttl)


class CacheConfig:
    def __init__(
        self,
        expiry: Optional[ExpiryPolicy] = None,
        store_by_value: bool = True,
        statistics_enabled: bool = True,
        loader: Optional[CacheLoader] = None,
        writer: Optional[CacheWriter] = None,
        read_through: bool = False,
        write_through: bool = False,
        listener_configurations: Optional[Iterable[CacheEntryListenerConfiguration]] = None,
    ):
        self.expiry = expiry or ExpiryPolicy.eternal()
        self.store_by_value = store_by_value
        self.statistics_enabled = statistics_enabled
        self.loader = loader
        self.writer = writer
        self.read_through = read_through and loader is not None
        self.write_through = write_through and writer is not None
        self.listener_configurations = list(listener_configurations or ())


class CacheStatistics:
    """CacheStatisticsMXBean analog: counters + average op times (µs)."""

    __slots__ = ("hits", "misses", "puts", "removals", "evictions",
                 "_get_ns", "_put_ns", "_remove_ns")

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.hits = self.misses = self.puts = self.removals = 0
        self.evictions = 0
        self._get_ns = self._put_ns = self._remove_ns = 0

    @property
    def gets(self) -> int:
        return self.hits + self.misses

    @property
    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else math.nan

    @property
    def miss_ratio(self) -> float:
        total = self.hits + self.misses
        return self.misses / total if total else math.nan

    def _avg_us(self, total_ns: int, count: int) -> float:
        return (total_ns / count) / 1e3 if count else 0.0

    @property
    def average_get_time_us(self) -> float:
        return self._avg_us(self._get_ns, self.gets)

    @property
    def average_put_time_us(self) -> float:
        return self._avg_us(self._put_ns, self.puts)

    @property
    def average_remove_time_us(self) -> float:
        return self._avg_us(self._remove_ns, self.removals)


class Cache:
    """javax.cache.Cache analog backed by one MapCache record."""

    def __init__(self, manager: "CacheManager", name: str, config: CacheConfig):
        self._manager = manager
        self._name = name
        self._config = config
        self._map = MapCache(manager._engine, f"jcache:{name}")
        manager._engine.eviction.schedule(f"jcache:{name}", self._map.reap_expired)
        self._closed = False
        self.statistics = CacheStatistics()
        self._listeners: List[CacheEntryListenerConfiguration] = []
        for lc in config.listener_configurations:
            self.register_cache_entry_listener(lc)
        # TTL/idle expiry surfaces from MapCache's lazy reap + sweeper, not
        # from this layer, so expired events ride the map's hub channel.
        self._expired_token = self._map.add_entry_listener(
            "expired", self._on_map_expired
        )

    # -- helpers -------------------------------------------------------------

    def _check_open(self):
        if self._closed:
            raise RuntimeError(f"cache '{self._name}' is closed")

    def _stat(self, attr: str, n: int = 1) -> None:
        if self._config.statistics_enabled:
            setattr(self.statistics, attr, getattr(self.statistics, attr) + n)

    def _timed(self, bucket: str, t0: float) -> None:
        if self._config.statistics_enabled:
            ns = int((time.perf_counter() - t0) * 1e9)
            setattr(self.statistics, bucket, getattr(self.statistics, bucket) + ns)

    # -- entry listeners -----------------------------------------------------

    def register_cache_entry_listener(
        self, lc: CacheEntryListenerConfiguration
    ) -> None:
        """JCache.registerCacheEntryListener (jcache/JCache.java:3154-3283)."""
        if lc in self._listeners:
            raise ValueError("listener configuration already registered")
        self._listeners.append(lc)

    def deregister_cache_entry_listener(
        self, lc: CacheEntryListenerConfiguration
    ) -> None:
        try:
            self._listeners.remove(lc)
        except ValueError:
            pass

    def _on_map_expired(self, key, value, _old) -> None:
        self._stat("evictions")
        # EXPIRED events expose the expired value as the old value too
        self._dispatch("expired", key, value, value, force_async=True)

    def _dispatch(self, kind: str, key, value, old, force_async: bool = False) -> None:
        """Deliver one event to every matching listener.  Synchronous
        listeners run inline (errors propagate, per JSR-107 §synchronous);
        async ones ride the engine events pool in FIFO order.  Expiry events
        are always async — they originate on the reap path."""
        if not self._listeners:
            return
        method = f"on_{kind}"
        for lc in self._listeners:
            fn = getattr(lc.listener, method, None)
            if fn is None:
                continue
            ev = CacheEntryEvent(
                self, kind, key, value, old if lc.old_value_required else None
            )
            if lc.filter is not None and not lc.filter(ev):
                continue
            if lc.synchronous and not force_async:
                fn(ev)
            else:
                try:
                    self._manager._engine.events_pool.submit(fn, ev)
                except RuntimeError:
                    pass  # engine shutting down: events are best-effort

    def _after_put(self, key, value, old) -> None:
        if old is None:
            self._dispatch("created", key, value, None)
        else:
            self._dispatch("updated", key, value, old)

    # -- read/write-through --------------------------------------------------

    def _load(self, key):
        """Read-through fill on a miss (jcache/JCache.java:406-421)."""
        try:
            value = self._config.loader.load(key)
        except Exception as e:  # noqa: BLE001 - spec wraps any loader error
            raise CacheLoaderException(f"loader failed for {key!r}") from e
        if value is not None:
            e = self._config.expiry
            old = self._map.put_with_ttl(key, value, ttl=e.creation, max_idle=e.access)
            self._after_put(key, value, old)
        return value

    def _write(self, key, value) -> None:
        """Write-through: the writer runs BEFORE the cache mutates, so a
        failing writer leaves the cache unchanged (jcache/JCache.java:1257-1290)."""
        if self._config.write_through:
            try:
                self._config.writer.write(key, value)
            except Exception as e:  # noqa: BLE001
                raise CacheWriterException(f"writer failed for {key!r}") from e

    def _delete(self, key) -> None:
        if self._config.write_through:
            try:
                self._config.writer.delete(key)
            except Exception as e:  # noqa: BLE001
                raise CacheWriterException(f"writer delete failed for {key!r}") from e

    def _put_with_policy(self, key, value):
        """Spec-accurate expiry arming (JSR-107 §ExpiryPolicy): the creation
        duration governs inserts; the update duration governs overwrites —
        and when the update duration is unspecified, the entry's remaining
        TTL is preserved (CreatedExpiryPolicy.getExpiryForUpdate == null)."""
        e = self._config.expiry
        with self._manager._engine.locked(self._map.name):
            if not self._map.contains_key(key):
                return self._map.put_with_ttl(key, value, ttl=e.creation, max_idle=e.access)
            if e.update is not None:
                return self._map.put_with_ttl(key, value, ttl=e.update, max_idle=e.access)
            remaining = self._map.remain_time_to_live_entry(key)
            return self._map.put_with_ttl(key, value, ttl=remaining, max_idle=e.access)

    @property
    def name(self) -> str:
        return self._name

    # -- JSR-107 surface -----------------------------------------------------

    def get(self, key):
        self._check_open()
        t0 = time.perf_counter()
        v = self._map.get(key)
        self._stat("misses" if v is None else "hits")
        if v is None and self._config.read_through:
            v = self._load(key)
        self._timed("_get_ns", t0)
        return v

    def get_all(self, keys: Iterable) -> Dict:
        self._check_open()
        t0 = time.perf_counter()
        keys = list(keys)
        out = {}
        missing = []
        for k in keys:
            v = self._map.get(k)
            self._stat("misses" if v is None else "hits")
            if v is None:
                missing.append(k)
            else:
                out[k] = v
        if missing and self._config.read_through:
            # bulk fill mirrors JCache.getAll's loadAll path (JCache.java:406)
            try:
                loaded = self._config.loader.load_all(missing)
            except Exception as e:  # noqa: BLE001
                raise CacheLoaderException("loadAll failed") from e
            exp = self._config.expiry
            for k, v in loaded.items():
                if v is None:
                    continue
                old = self._map.put_with_ttl(k, v, ttl=exp.creation, max_idle=exp.access)
                self._after_put(k, v, old)
                out[k] = v
        self._timed("_get_ns", t0)
        return out

    def load_all(self, keys: Iterable, replace_existing: bool = False,
                 completion_listener: Optional[Callable] = None) -> None:
        """Cache.loadAll (jcache/JCache.java:1117-1160): warm the cache from
        the loader; `completion_listener(exc_or_None)` fires when done."""
        self._check_open()
        if self._config.loader is None:
            if completion_listener is not None:
                completion_listener(None)
            return
        targets = list(keys)
        if not replace_existing:
            targets = [k for k in targets if not self._map.contains_key(k)]
        try:
            loaded = self._config.loader.load_all(targets)
        except Exception as e:  # noqa: BLE001 - only LOADER errors wrap; a
            # put/listener failure below is a cache bug and must surface as-is
            exc = CacheLoaderException("loadAll failed")
            exc.__cause__ = e
            if completion_listener is not None:
                completion_listener(exc)
                return
            raise exc from e
        exp = self._config.expiry
        for k, v in loaded.items():
            if v is None:
                continue
            old = self._map.put_with_ttl(k, v, ttl=exp.creation, max_idle=exp.access)
            self._after_put(k, v, old)
        if completion_listener is not None:
            completion_listener(None)

    def contains_key(self, key) -> bool:
        self._check_open()
        return self._map.contains_key(key)

    def put(self, key, value) -> None:
        self.get_and_put(key, value)

    def get_and_put(self, key, value):
        self._check_open()
        t0 = time.perf_counter()
        # writer + cache mutate under ONE record lock (reentrant) so the
        # external store and the cache can't interleave to different orders
        with self._manager._engine.locked(self._map.name):
            self._write(key, value)
            old = self._put_with_policy(key, value)
        self._stat("puts")
        self._timed("_put_ns", t0)
        self._after_put(key, value, old)
        return old

    def put_all(self, entries: Dict) -> None:
        """Bulk write-through rides writer.write_all; a failing writer keeps
        ALL entries out of the cache (jcache/JCache.java:1641 discipline)."""
        self._check_open()
        t0 = time.perf_counter()
        with self._manager._engine.locked(self._map.name):
            if self._config.write_through and entries:
                try:
                    self._config.writer.write_all(dict(entries))
                except Exception as e:  # noqa: BLE001
                    raise CacheWriterException("writeAll failed") from e
            applied = [(k, v, self._put_with_policy(k, v)) for k, v in entries.items()]
        for k, v, old in applied:
            self._stat("puts")
            self._after_put(k, v, old)
        self._timed("_put_ns", t0)

    def put_if_absent(self, key, value) -> bool:
        self._check_open()
        t0 = time.perf_counter()
        e = self._config.expiry
        with self._manager._engine.locked(self._map.name):
            if self._map.contains_key(key):
                return False
            self._write(key, value)
            self._map.put_with_ttl(key, value, ttl=e.creation, max_idle=e.access)
        self._stat("puts")
        self._timed("_put_ns", t0)
        self._dispatch("created", key, value, None)
        return True

    def remove(self, key, old_value=None) -> bool:
        self._check_open()
        t0 = time.perf_counter()
        with self._manager._engine.locked(self._map.name):
            if old_value is not None:
                cur = self._map.get(key)
                if cur != old_value:
                    return False
                self._delete(key)
                ok = self._map.fast_remove(key) > 0
                old = old_value
            else:
                old = self._map.get(key)
                # spec: write-through delete fires even for an absent key
                self._delete(key)
                ok = self._map.fast_remove(key) > 0
        if ok:
            self._stat("removals")
            self._timed("_remove_ns", t0)
            self._dispatch("removed", key, old, old)
        return ok

    def get_and_remove(self, key):
        self._check_open()
        t0 = time.perf_counter()
        with self._manager._engine.locked(self._map.name):
            old = self._map.get(key)
            self._delete(key)
            if old is not None:
                self._map.fast_remove(key)
        if old is not None:
            self._stat("removals")
            self._timed("_remove_ns", t0)
            self._dispatch("removed", key, old, old)
        return old

    def replace(self, key, value, old_value=None) -> bool:
        self._check_open()
        t0 = time.perf_counter()
        if old_value is not None:
            with self._manager._engine.locked(self._map.name):
                if self._map.get(key) != old_value:
                    return False
                self._write(key, value)
                self._put_with_policy(key, value)
            self._stat("puts")
            self._timed("_put_ns", t0)
            self._dispatch("updated", key, value, old_value)
            return True
        with self._manager._engine.locked(self._map.name):
            if not self._map.contains_key(key):
                return False
            self._write(key, value)
            old = self._put_with_policy(key, value)
        self._stat("puts")
        self._timed("_put_ns", t0)
        self._dispatch("updated", key, value, old)
        return True

    def get_and_replace(self, key, value):
        self._check_open()
        t0 = time.perf_counter()
        with self._manager._engine.locked(self._map.name):
            if not self._map.contains_key(key):
                return None
            self._write(key, value)
            old = self._put_with_policy(key, value)
        self._stat("puts")
        self._timed("_put_ns", t0)
        self._dispatch("updated", key, value, old)
        return old

    def remove_all(self, keys: Optional[Iterable] = None) -> None:
        """removeAll DOES notify per key and write-through-deletes, unlike
        clear() (JSR-107 distinguishes them; jcache/JCache.java:1811-1845)."""
        self._check_open()
        t0 = time.perf_counter()
        if keys is None:
            keys = self._map.read_all_keys()
        keys = list(keys)
        if self._config.write_through and keys:
            try:
                self._config.writer.delete_all(list(keys))
            except Exception as e:  # noqa: BLE001
                raise CacheWriterException("deleteAll failed") from e
        for k in keys:
            with self._manager._engine.locked(self._map.name):
                old = self._map.get(k)
                removed = self._map.fast_remove(k) > 0
            if removed:
                self._stat("removals")
                self._dispatch("removed", k, old, old)
        self._timed("_remove_ns", t0)

    def clear(self) -> None:
        # clear() is the event-free, writer-free wipe (JSR-107 §Cache.clear)
        self._check_open()
        self._map.clear()

    def invoke(self, key, processor: Callable[["MutableEntry"], Any]):
        """EntryProcessor: atomic read-modify-write on one entry, with
        read-through on access and write-through + events on apply."""
        self._check_open()
        with self._manager._engine.locked(self._map.name):
            entry = MutableEntry(self, key)
            result = processor(entry)
            entry._apply()
        entry._notify()
        return result

    def invoke_all(self, keys: Iterable, processor: Callable[["MutableEntry"], Any]) -> Dict:
        return {k: self.invoke(k, processor) for k in keys}

    def iterator(self):
        self._check_open()
        return iter(self._map.read_all_entry_set())

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._map.remove_entry_listener(self._expired_token)
            self._listeners.clear()
            try:
                self._manager._engine.eviction.unschedule(f"jcache:{self._name}")
            except RuntimeError:
                pass  # engine already shut down
            self._manager._caches.pop(self._name, None)

    @property
    def closed(self) -> bool:
        return self._closed

    def __iter__(self):
        return self.iterator()


class MutableEntry:
    """javax.cache.processor.MutableEntry analog (JMutableEntry.java).

    `value` triggers a read-through load on a miss (JSR-107 §EntryProcessor);
    set_value/remove are buffered and applied — with write-through — after
    the processor returns, still under the record lock."""

    def __init__(self, cache: Cache, key):
        self._cache = cache
        self.key = key
        self._value = cache._map.get(key)
        self._old = self._value
        self._exists = self._value is not None
        self._loaded = False
        self._op: Optional[str] = None  # None | "set" | "remove"

    @property
    def value(self):
        if (self._value is None and self._op is None and not self._loaded
                and self._cache._config.read_through):
            self._loaded = True
            try:
                self._value = self._cache._config.loader.load(self.key)
            except Exception as e:  # noqa: BLE001
                raise CacheLoaderException(f"loader failed for {self.key!r}") from e
            self._exists = self._value is not None
        return self._value

    def exists(self) -> bool:
        return self._exists

    def set_value(self, value) -> None:
        self._value = value
        self._exists = True
        self._op = "set"

    def remove(self) -> None:
        self._exists = False
        self._op = "remove"

    def _apply(self) -> None:
        if self._op == "set":
            self._cache._write(self.key, self._value)
            self._cache._put_with_policy(self.key, self._value)
            self._cache._stat("puts")
        elif self._op == "remove":
            # write-through delete fires even when the entry was absent from
            # the cache (e.g. remove() after a read-through load) — the
            # processor explicitly removed the external row
            self._cache._delete(self.key)
            if self._old is not None:
                self._cache._map.fast_remove(self.key)
                self._cache._stat("removals")
        elif self._loaded and self._value is not None:
            # a read-through hit inside the processor populates the cache
            self._cache._put_with_policy(self.key, self._value)

    def _notify(self) -> None:
        if self._op == "set":
            self._cache._after_put(self.key, self._value, self._old)
        elif self._op == "remove" and self._old is not None:
            self._cache._dispatch("removed", self.key, self._old, self._old)
        elif self._loaded and self._op is None and self._value is not None:
            self._cache._dispatch("created", self.key, self._value, None)


class CacheManager:
    """javax.cache.CacheManager analog (jcache/JCacheManager role)."""

    def __init__(self, engine):
        self._engine = engine
        self._caches: Dict[str, Cache] = {}
        self._closed = False
        self._closer_registered = False

    def create_cache(self, name: str, config: Optional[CacheConfig] = None) -> Cache:
        if self._closed:
            raise RuntimeError("cache manager is closed")
        if name in self._caches:
            raise ValueError(f"cache '{name}' already exists")
        if not self._closer_registered:
            # the caches' sweeps and listeners stop with the engine
            self._engine.on_shutdown(self.close)
            self._closer_registered = True
        cache = Cache(self, name, config or CacheConfig())
        self._caches[name] = cache
        return cache

    def get_cache(self, name: str) -> Optional[Cache]:
        return self._caches.get(name)

    def get_or_create_cache(self, name: str, config: Optional[CacheConfig] = None) -> Cache:
        return self._caches.get(name) or self.create_cache(name, config)

    def cache_names(self):
        return list(self._caches)

    def destroy_cache(self, name: str) -> None:
        cache = self._caches.pop(name, None)
        if cache is not None:
            cache._map.clear()
            cache.close()

    def close(self) -> None:
        for cache in list(self._caches.values()):
            cache.close()
        self._closed = True
