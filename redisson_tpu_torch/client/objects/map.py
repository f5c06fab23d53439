"""Map / MapCache: the hash-object family, a port of ``redisson_tpu/client/objects/map.py``.

RMap's surface: put/get/fastPut/putIfAbsent/addAndGet/remove/replace,
getAll/putAll/readAll*, the compute family, pattern scans, MapLoader
read-through and MapWriter write-through or write-behind.  Keys and values
are codec-encoded at the boundary (equality is encoded equality), stored in
a host dict inside the record; compound ops run under the record lock.

MapCache adds per-entry TTL and max-idle, entry listeners on the engine's
events pool and the size-bounded LRU/LFU mode; every map hands out per-key
locks, semaphores and latches.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord


class MapLoader:
    """Read-through SPI (org/redisson/api/map/MapLoader)."""

    def load(self, key: Any) -> Any:  # pragma: no cover - interface
        raise NotImplementedError

    def load_all_keys(self) -> Iterable[Any]:  # pragma: no cover - interface
        return []


class MapWriter:
    """Write-through SPI (org/redisson/api/map/MapWriter)."""

    def write(self, entries: Dict[Any, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def delete(self, keys: Iterable[Any]) -> None:  # pragma: no cover
        raise NotImplementedError


class MapOptions:
    """RMap options (org/redisson/api/MapOptions): loader/writer + write mode."""

    WRITE_THROUGH = "WRITE_THROUGH"
    WRITE_BEHIND = "WRITE_BEHIND"

    def __init__(
        self,
        loader: Optional[MapLoader] = None,
        writer: Optional[MapWriter] = None,
        write_mode: str = WRITE_THROUGH,
        write_behind_delay: float = 1.0,
        write_behind_batch_size: int = 50,
    ):
        self.loader = loader
        self.writer = writer
        self.write_mode = write_mode
        self.write_behind_delay = write_behind_delay
        self.write_behind_batch_size = write_behind_batch_size


class Map(RExpirable):
    _kind = "map"

    @property
    def _scan_view_safe(self) -> bool:
        """True when the value set is fully described by (nonce, version) —
        the key for staged device scan views (services/mapreduce._WcScanView).
        Loader-backed maps are excluded: read-through loads insert values
        without a version bump."""
        return self._options.loader is None

    def __init__(self, engine, name, codec=None, options: Optional[MapOptions] = None):
        super().__init__(engine, name, codec)
        self._options = options or MapOptions()
        self._wb_lock = threading.Lock()
        self._wb_queue: List[Tuple[str, Any, Any]] = []  # (op, key, value)
        self._wb_timer = None  # the wheel Timeout of a queued flush

    # -- plumbing -----------------------------------------------------------

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host={})
        )

    def _ek(self, key) -> bytes:
        return self._codec.encode_map_key(key)

    def _ev(self, value) -> bytes:
        return self._codec.encode_map_value(value)

    def _dk(self, data: bytes):
        return self._codec.decode_map_key(data)

    def _dv(self, data: bytes):
        return self._codec.decode_map_value(data)

    def _raw_get(self, rec, ek: bytes):
        return rec.host.get(ek)

    def _raw_get_for_update(self, rec, ek: bytes):
        """NON-TOUCHING value fetch: write paths reading the old value, and
        sampling/warm-up probes (random_keys/random_entries/load_all).
        Same as _raw_get here; MapCache overrides it to skip
        access tracking — none of those callers may refresh max-idle clocks or
        count as LFU reads."""
        return self._raw_get(rec, ek)

    def _raw_put(self, rec, ek: bytes, ev: bytes):
        rec.host[ek] = ev

    def _raw_del(self, rec, ek: bytes) -> bool:
        return rec.host.pop(ek, None) is not None

    def _load_through(self, rec, key, ek: bytes):
        if self._options.loader is None:
            return None
        loaded = self._options.loader.load(key)
        if loaded is not None:
            self._raw_put(rec, ek, self._ev(loaded))
        return loaded

    def _write_through(self, op: str, key, value=None):
        w = self._options.writer
        if w is None:
            return
        if self._options.write_mode == MapOptions.WRITE_BEHIND:
            with self._wb_lock:
                self._wb_queue.append((op, key, value))
                if self._wb_timer is None:
                    # shared wheel timer; the flush runs on the timer pool
                    # (user MapWriter code may block on I/O and wheel
                    # callbacks must stay short)
                    self._wb_timer = self._engine.schedule_timeout(
                        self._flush_write_behind,
                        self._options.write_behind_delay,
                    )
        elif op == "write":
            w.write({key: value})
        else:
            w.delete([key])

    def _flush_write_behind(self):
        """WriteBehindService.java analog: batch queued writes/deletes."""
        with self._wb_lock:
            queue, self._wb_queue = self._wb_queue, []
            self._wb_timer = None
        writes: Dict[Any, Any] = {}
        deletes: List[Any] = []
        for op, key, value in queue:
            if op == "write":
                writes[key] = value
                if key in deletes:
                    deletes.remove(key)
            else:
                writes.pop(key, None)
                deletes.append(key)
        w = self._options.writer
        if w is not None:
            if writes:
                w.write(writes)
            if deletes:
                w.delete(deletes)

    def flush_write_behind(self):
        """Test/shutdown hook: drain the write-behind queue now."""
        with self._wb_lock:
            t = self._wb_timer
        if t is not None:
            t.cancel()
        self._flush_write_behind()

    # -- read surface -------------------------------------------------------

    def get(self, key):
        ek = self._ek(key)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            raw = self._raw_get(rec, ek)
            if raw is None:
                loaded = self._load_through(rec, key, ek)
                return loaded
            return self._dv(raw)

    def get_all(self, keys: Iterable) -> Dict:
        out = {}
        for k in keys:
            v = self.get(k)
            if v is not None:
                out[k] = v
        return out

    def contains_key(self, key) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            return self._raw_get(rec, self._ek(key)) is not None

    def contains_value(self, value) -> bool:
        ev = self._ev(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            return any(raw == ev for raw in rec.host.values())

    def size(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else len(rec.host)

    def is_empty(self) -> bool:
        return self.size() == 0

    def read_all_keys(self) -> List:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [self._dk(ek) for ek in list(rec.host.keys())]

    def read_all_values(self) -> List:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [self._dv(ev) for ev in list(rec.host.values())]

    def read_all_entry_set(self) -> List[Tuple]:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return [(self._dk(k), self._dv(v)) for k, v in list(rec.host.items())]

    def read_all_map(self) -> Dict:
        return dict(self.read_all_entry_set())

    def key_iterator(self, pattern: Optional[str] = None, chunk: int = 10) -> Iterator:
        """HSCAN-cursor analog (iterator/*.java): snapshot-chunked iteration."""
        import fnmatch

        for k in self.read_all_keys():
            if pattern is None or fnmatch.fnmatchcase(str(k), pattern):
                yield k

    def entry_iterator(self) -> Iterator[Tuple]:
        yield from self.read_all_entry_set()

    # -- write surface ------------------------------------------------------

    def put(self, key, value):
        """Returns previous value (RMap.put)."""
        ek, ev = self._ek(key), self._ev(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = self._raw_get_for_update(rec, ek)
            self._raw_put(rec, ek, ev)
            self._touch_version(rec)
        self._write_through("write", key, value)
        return None if old is None else self._dv(old)

    def fast_put(self, key, value) -> bool:
        """True if key is new (RMap.fastPut — skips old-value fetch)."""
        ek, ev = self._ek(key), self._ev(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            is_new = ek not in rec.host
            self._raw_put(rec, ek, ev)
            self._touch_version(rec)
        self._write_through("write", key, value)
        return is_new

    def put_if_absent(self, key, value):
        """Returns existing value, or None if the put happened."""
        ek, ev = self._ek(key), self._ev(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = self._raw_get_for_update(rec, ek)
            if old is not None:
                return self._dv(old)
            self._raw_put(rec, ek, ev)
            self._touch_version(rec)
        self._write_through("write", key, value)
        return None

    def fast_put_if_absent(self, key, value) -> bool:
        return self.put_if_absent(key, value) is None

    def put_all(self, entries: Dict) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for k, v in entries.items():
                self._raw_put(rec, self._ek(k), self._ev(v))
            self._touch_version(rec)
        for k, v in entries.items():
            self._write_through("write", k, v)

    def remove(self, key):
        """Returns removed value (RMap.remove)."""
        ek = self._ek(key)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = self._raw_get_for_update(rec, ek)
            if old is None:
                return None
            self._raw_del(rec, ek)
            self._touch_version(rec)
        self._write_through("delete", key)
        return self._dv(old)

    def fast_remove(self, *keys) -> int:
        n = 0
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for k in keys:
                if self._raw_del(rec, self._ek(k)):
                    n += 1
            if n:
                self._touch_version(rec)
        for k in keys:
            self._write_through("delete", k)
        return n

    def remove_if_equals(self, key, expected) -> bool:
        """RMap.remove(key, value) conditional."""
        ek, ev = self._ek(key), self._ev(expected)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if self._raw_get_for_update(rec, ek) != ev:
                return False
            self._raw_del(rec, ek)
            self._touch_version(rec)
        self._write_through("delete", key)
        return True

    def replace(self, key, value):
        """Set only if present; returns previous value."""
        ek, ev = self._ek(key), self._ev(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = self._raw_get_for_update(rec, ek)
            if old is None:
                return None
            self._raw_put(rec, ek, ev)
            self._touch_version(rec)
        self._write_through("write", key, value)
        return self._dv(old)

    def replace_if_equals(self, key, expected, update) -> bool:
        ek = self._ek(key)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if self._raw_get_for_update(rec, ek) != self._ev(expected):
                return False
            self._raw_put(rec, ek, self._ev(update))
            self._touch_version(rec)
        self._write_through("write", key, update)
        return True

    # -- java.util.Map compute family (RMap.compute*/merge; BaseMapTest
    # -- testCompute*/testMerge).  Built on the public ops under ONE record
    # -- lock so MapWriter/MapLoader/TTL semantics inherit; the functions
    # -- are plain callables (over the wire they travel pickled in the
    # -- OBJCALL frame, the serialized-task discipline).

    def compute(self, key, remapping):
        """remapping(key, old_or_None) -> new value, or None to remove."""
        with self._engine.locked(self._name):
            old = self.get(key)
            new = remapping(key, old)
            if new is None:
                if old is not None:
                    self.fast_remove(key)
                return None
            self.fast_put(key, new)
            return new

    def compute_if_absent(self, key, mapping):
        """mapping(key) computes a value only when absent; returns the
        current value either way (None when mapping returned None)."""
        with self._engine.locked(self._name):
            old = self.get(key)
            if old is not None:
                return old
            new = mapping(key)
            if new is not None:
                self.fast_put(key, new)
            return new

    def compute_if_present(self, key, remapping):
        with self._engine.locked(self._name):
            old = self.get(key)
            if old is None:
                return None
            new = remapping(key, old)
            if new is None:
                self.fast_remove(key)
                return None
            self.fast_put(key, new)
            return new

    def merge(self, key, value, remapping):
        """RMap.merge: absent -> value; present -> remapping(old, value);
        a None result removes the entry."""
        with self._engine.locked(self._name):
            old = self.get(key)
            new = value if old is None else remapping(old, value)
            if new is None:
                self.fast_remove(key)
                return None
            self.fast_put(key, new)
            return new

    # -- XX-style conditional puts (RMap.putIfExists/fastPutIfExists) --------
    # presence checks use _raw_get_for_update like replace(): a write-path
    # probe must neither read-through-load from a MapLoader (the XX contract
    # is about the HASH's contents) nor touch MapCache access tracking

    def put_if_exists(self, key, value):
        """Write only over an EXISTING entry; returns the previous value
        (None = absent, nothing written)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old_raw = self._raw_get_for_update(rec, self._ek(key))
            if old_raw is None:
                return None
            self.fast_put(key, value)
            return self._dv(old_raw)

    def fast_put_if_exists(self, key, value) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if self._raw_get_for_update(rec, self._ek(key)) is None:
                return False
            self.fast_put(key, value)
            return True

    def fast_replace(self, key, value) -> bool:
        """RMap.fastReplace: replace() without returning the old value."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if self._raw_get_for_update(rec, self._ek(key)) is None:
                return False
            self.fast_put(key, value)
            return True

    # -- per-key synchronizers (RMap.getLock(key)/getReadWriteLock(key)/
    # -- getSemaphore/getPermitExpirableSemaphore/getFairLock/
    # -- getCountDownLatch — entry-granular coordination, names derived
    # -- from the encoded key's hash like the reference's suffix scheme)

    def _key_object_name(self, key, kind: str) -> str:
        import hashlib

        h = hashlib.sha1(self._ek(key)).hexdigest()[:16]
        return f"{self._name}:{h}:{kind}"

    def get_lock(self, key):
        from redisson_tpu_torch.client.objects.lock import Lock

        return Lock(self._engine, self._key_object_name(key, "lock"))

    def get_fair_lock(self, key):
        from redisson_tpu_torch.client.objects.lock import FairLock

        return FairLock(self._engine, self._key_object_name(key, "fairlock"))

    def get_read_write_lock(self, key):
        from redisson_tpu_torch.client.objects.lock import ReadWriteLock

        return ReadWriteLock(self._engine, self._key_object_name(key, "rwlock"))

    def get_semaphore(self, key):
        from redisson_tpu_torch.client.objects.semaphore import Semaphore

        return Semaphore(self._engine, self._key_object_name(key, "semaphore"))

    def get_permit_expirable_semaphore(self, key):
        from redisson_tpu_torch.client.objects.semaphore import PermitExpirableSemaphore

        return PermitExpirableSemaphore(
            self._engine, self._key_object_name(key, "psemaphore")
        )

    def get_count_down_latch(self, key):
        from redisson_tpu_torch.client.objects.semaphore import CountDownLatch

        return CountDownLatch(self._engine, self._key_object_name(key, "latch"))

    # -- pattern scans (RMap.keySet/values/entrySet(pattern)) ----------------
    # str(k) matching keeps these agreeing with key_iterator(pattern) for
    # non-string keys; the key-only scan never decodes values

    def _entries_by_pattern(self, pattern: str):
        import fnmatch

        return [
            (k, v) for k, v in self.read_all_entry_set()
            if fnmatch.fnmatchcase(str(k), pattern)
        ]

    def key_set_by_pattern(self, pattern: str) -> List:
        import fnmatch

        return [
            k for k in self.read_all_keys()
            if fnmatch.fnmatchcase(str(k), pattern)
        ]

    def values_by_pattern(self, pattern: str) -> List:
        return [v for _k, v in self._entries_by_pattern(pattern)]

    def entry_set_by_pattern(self, pattern: str) -> List[Tuple[Any, Any]]:
        return self._entries_by_pattern(pattern)

    def add_and_get(self, key, delta):
        """Numeric field increment (RMap.addAndGet / HINCRBY Lua)."""
        ek = self._ek(key)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            raw = self._raw_get_for_update(rec, ek)
            cur = 0 if raw is None else self._dv(raw)
            if not isinstance(cur, (int, float)):
                raise TypeError(f"value at {key!r} is not numeric")
            new = cur + delta
            self._raw_put(rec, ek, self._ev(new))
            self._touch_version(rec)
        self._write_through("write", key, new)
        return new

    def clear(self) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host.clear()
            self._touch_version(rec)

    def value_size(self, key) -> int:
        """Encoded byte size of one value (RMap.valueSize / HSTRLEN)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            raw = self._raw_get(rec, self._ek(key))
            return 0 if raw is None else len(raw)

    def random_keys(self, count: int) -> List:
        """HRANDFIELD-style sample of distinct LIVE keys (RMap.randomKeys) —
        the non-touching probe applies MapCache expiry without refreshing
        access tracking."""
        import random as _random

        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            keys = [
                k for k in list(rec.host.keys())
                # non-touching probe: sampling must not refresh max-idle
                # clocks or inflate LFU hit counts for every live entry
                if self._raw_get_for_update(rec, k) is not None
            ]
        return [self._dk(k) for k in _random.sample(keys, min(count, len(keys)))]

    def random_entries(self, count: int) -> Dict:
        """RMap.randomEntries — live entries only (expired cells reaped)."""
        import random as _random

        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            items = [
                (k, raw) for k in list(rec.host.keys())
                if (raw := self._raw_get_for_update(rec, k)) is not None
            ]
        picked = _random.sample(items, min(count, len(items)))
        return {self._dk(k): self._dv(raw) for k, raw in picked}

    def load_all(self, replace_existing: bool = False) -> int:
        """Warm the map from its MapLoader (RMap.loadAll); returns #loaded."""
        loader = self._options.loader
        if loader is None:
            return 0
        n = 0
        for key in loader.load_all_keys():
            ek = self._ek(key)
            if not replace_existing:
                with self._engine.locked(self._name):
                    rec = self._rec_or_create()
                    if self._raw_get_for_update(rec, ek) is not None:
                        continue
            # the loader may hit a slow backing store: NEVER under the
            # record lock, or every concurrent op on this map stalls per key
            loaded = loader.load(key)
            if loaded is None:
                continue
            with self._engine.locked(self._name):
                rec = self._rec_or_create()
                if not replace_existing and self._raw_get_for_update(rec, ek) is not None:
                    continue  # raced in while we were loading: keep it
                self._raw_put(rec, ek, self._ev(loaded))
                self._touch_version(rec)
                n += 1
        return n

    # dict-protocol sugar
    def __getitem__(self, key):
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __setitem__(self, key, value):
        self.fast_put(key, value)

    def __contains__(self, key):
        return self.contains_key(key)

    def __len__(self):
        return self.size()


class MapCache(Map):
    """RMapCache: per-entry TTL / max-idle (RedissonMapCache.java).

    Entry layout: host[ek] = [ev, expire_at | None, max_idle | None,
    last_access, hit_count].  Expired entries are reaped lazily on access and
    by the EvictionScheduler sweep (eviction.py).  Four-element cells from
    older checkpoints are read transparently (hit_count treated as 0).

    Entry listeners (created/updated/removed/expired) publish on the
    reference's channel names (`RedissonMapCache.java:1767-1787`:
    `redisson_map_cache_<kind>:{name}`) through the engine hub, so embedded
    listeners AND wire pubsub subscribers observe the same events.  Delivery
    is async on the engine's single-worker events pool: mutation order is
    preserved, and user listeners never run under the record lock.

    Size-bounded mode (`trySetMaxSize`/`setMaxSize` + EvictionMode LRU|LFU,
    `RedissonMapCache.java:91-137`): inserts beyond max_size evict the
    least-recently-used (last_access) or least-frequently-used (hit_count)
    live entries, which are announced as `removed` events.
    """

    _kind = "map_cache"
    # TTL/max-idle expiry removes entries WITHOUT bumping the record version
    # (lazy reap on access), so (nonce, version) cannot key a scan view here
    _scan_view_safe = False

    EVENT_KINDS = ("created", "updated", "removed", "expired")

    def _now(self):
        return time.time()

    # -- entry events --------------------------------------------------------

    def entry_event_channel(self, kind: str) -> str:
        return f"redisson_map_cache_{kind}:{self._name}"

    def _emit(self, kind: str, ek: bytes, raw, old_raw=None) -> None:
        """Queue one listener event for async FIFO delivery.  No-op without
        subscribers so the unlistened hot path never pays decode cost."""
        hub = self._engine.pubsub
        ch = self.entry_event_channel(kind)
        if not hub.has_listeners(ch):
            return
        key = self._dk(ek)
        value = None if raw is None else self._dv(raw)
        old = None if old_raw is None else self._dv(old_raw)
        try:
            self._engine.events_pool.submit(hub.publish, ch, (key, value, old))
        except RuntimeError:
            pass  # engine shutting down: events are best-effort

    def add_entry_listener(self, kind: str, fn) -> Tuple[str, int]:
        """RMapCache.addListener analog; `kind` selects the listener
        interface (EntryCreated/Updated/Removed/ExpiredListener).  `fn` is
        called as fn(key, value, old_value); old_value is non-None only for
        'updated'.  Returns a token for remove_entry_listener."""
        if kind not in self.EVENT_KINDS:
            raise ValueError(f"unknown entry event kind: {kind!r}")
        ch = self.entry_event_channel(kind)
        lid = self._engine.pubsub.subscribe(ch, lambda _ch, msg: fn(*msg))
        return (kind, lid)

    def remove_entry_listener(self, token) -> None:
        kind, lid = token
        self._engine.pubsub.unsubscribe(self.entry_event_channel(kind), lid)

    # -- cell machinery ------------------------------------------------------

    def _live(self, rec, ek, touch=True):
        cell = rec.host.get(ek)
        if cell is None:
            return None
        now = self._now()
        if cell[1] is not None and now >= cell[1]:
            del rec.host[ek]
            self._emit("expired", ek, cell[0])
            return None
        if cell[2] is not None and now - cell[3] >= cell[2]:
            del rec.host[ek]
            self._emit("expired", ek, cell[0])
            return None
        if touch:
            cell[3] = now
            if len(cell) > 4:
                cell[4] += 1
        return cell[0]

    def _store_cell(self, rec, ek: bytes, ev: bytes, exp=None, max_idle=None):
        """Write one cell, emitting created|updated and enforcing max_size;
        returns the previous live raw value (None if absent)."""
        old = self._live(rec, ek, touch=False)
        # an update carries the access frequency forward: LFU must rank by
        # read history, and a write resetting it would turn the hottest key
        # into the next eviction victim
        prev = rec.host.get(ek)
        hits = prev[4] if (old is not None and prev is not None and len(prev) > 4) else 0
        rec.host[ek] = [ev, exp, max_idle, self._now(), hits]
        if old is None:
            self._emit("created", ek, ev)
            self._enforce_max_size(rec, keep=ek)
        else:
            self._emit("updated", ek, ev, old)
        return old

    def _raw_get(self, rec, ek: bytes):
        return self._live(rec, ek)

    def _raw_get_for_update(self, rec, ek: bytes):
        # writes fetch the old value WITHOUT touching access tracking:
        # a put must not refresh max-idle or count as an LFU hit
        return self._live(rec, ek, touch=False)

    def contains_value(self, value) -> bool:
        """Cells are [value, exp, idle, ...] lists — the base class's raw
        comparison never matches; compare the LIVE value per cell
        (RMapCache.containsValue skips expired entries the same way)."""
        ev = self._ev(value)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            return any(
                self._live(rec, ek, touch=False) == ev
                for ek in list(rec.host.keys())
            )

    def _raw_put(self, rec, ek: bytes, ev: bytes):
        self._store_cell(rec, ek, ev)

    def _raw_del(self, rec, ek: bytes) -> bool:
        live = self._live(rec, ek, touch=False)
        if live is None:
            return False
        del rec.host[ek]
        self._emit("removed", ek, live)
        return True

    # -- size-bounded mode ---------------------------------------------------

    def try_set_max_size(self, max_size: int, mode: str = "LRU") -> bool:
        """Set the bound only if none exists yet (RMapCache.trySetMaxSize)."""
        self._check_max_size(max_size, mode)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if "max_size" in rec.meta:
                return False
            rec.meta["max_size"] = max_size
            rec.meta["eviction_mode"] = mode
            self._touch_version(rec)  # the bound must replicate/ship
            return True

    def set_max_size(self, max_size: int, mode: str = "LRU") -> None:
        """Set/replace the bound; an already-over-bound map is trimmed on
        the spot (the reference trims on the next write)."""
        self._check_max_size(max_size, mode)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.meta["max_size"] = max_size
            rec.meta["eviction_mode"] = mode
            self._enforce_max_size(rec)
            self._touch_version(rec)

    def get_max_size(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else rec.meta.get("max_size", 0)

    @staticmethod
    def _check_max_size(max_size: int, mode: str) -> None:
        # 0 = unbounded (RedissonMapCache.trySetMaxSizeAsync only rejects
        # negatives); the set-once contract uses key PRESENCE, not truthiness
        if max_size < 0:
            raise ValueError("maxSize should not be negative")
        if mode not in ("LRU", "LFU"):
            raise ValueError(f"unknown eviction mode: {mode!r}")

    def _enforce_max_size(self, rec, keep: Optional[bytes] = None) -> None:
        mx = rec.meta.get("max_size") or 0
        if mx <= 0 or len(rec.host) <= mx:
            return
        # reap dead cells FIRST (emitting their honest 'expired' events):
        # counting them toward the bound would evict live entries while
        # expired ones hold the capacity
        for ek in list(rec.host.keys()):
            self._live(rec, ek, touch=False)
        if len(rec.host) <= mx:
            return
        lfu = rec.meta.get("eviction_mode") == "LFU"

        def rank(item):
            cell = item[1]
            if lfu:
                return cell[4] if len(cell) > 4 else 0
            return cell[3]  # last_access

        victims = sorted(
            (kv for kv in rec.host.items() if kv[0] != keep), key=rank
        )[: len(rec.host) - mx]
        for vek, vcell in victims:
            del rec.host[vek]
            self._emit("removed", vek, vcell[0])

    def put_with_ttl(
        self,
        key,
        value,
        ttl: Optional[float] = None,
        max_idle: Optional[float] = None,
    ):
        """RMapCache.put(key, value, ttl, maxIdle); returns previous value."""
        ek, ev = self._ek(key), self._ev(value)
        now = self._now()
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = self._store_cell(rec, ek, ev, now + ttl if ttl else None, max_idle)
            self._touch_version(rec)
        self._write_through("write", key, value)
        return None if old is None else self._dv(old)

    def put_if_absent_with_ttl(
        self, key, value, ttl: Optional[float] = None, max_idle: Optional[float] = None
    ):
        ek, ev = self._ek(key), self._ev(value)
        now = self._now()
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = self._live(rec, ek, touch=False)
            if old is not None:
                return self._dv(old)
            self._store_cell(rec, ek, ev, now + ttl if ttl else None, max_idle)
            self._touch_version(rec)
        self._write_through("write", key, value)
        return None

    def remain_time_to_live_entry(self, key) -> Optional[float]:
        """Remaining TTL of one entry; None if absent or no TTL."""
        ek = self._ek(key)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if self._live(rec, ek, touch=False) is None:
                return None
            exp = rec.host[ek][1]
            return None if exp is None else max(0.0, exp - self._now())

    def size(self) -> int:
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return 0
            for ek in list(rec.host.keys()):
                self._live(rec, ek, touch=False)
            return len(rec.host)

    def read_all_entry_set(self):
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return []
            out = []
            for ek in list(rec.host.keys()):
                ev = self._live(rec, ek, touch=False)
                if ev is not None:
                    out.append((self._dk(ek), self._dv(ev)))
            return out

    def read_all_keys(self):
        return [k for k, _ in self.read_all_entry_set()]

    def read_all_values(self):
        return [v for _, v in self.read_all_entry_set()]

    def reap_expired(self) -> int:
        """EvictionScheduler sweep entry point; returns entries removed."""
        with self._engine.locked(self._name):
            rec = self._engine.store.get(self._name)
            if rec is None:
                return 0
            before = len(rec.host)
            for ek in list(rec.host.keys()):
                self._live(rec, ek, touch=False)
            return before - len(rec.host)
