"""LocalCachedMap: Map with a per-handle near cache + invalidation topic.

Parity target: RLocalCachedMap (``RedissonLocalCachedMap.java``,
``cache/LocalCacheListener.java:49-290``).  Each handle keeps a bounded local
cache of decoded entries; mutations publish to an invalidation channel
(`redisson_local_cache:{name}` here, mirroring the reference's
`{name}:topic`) so every *other* handle either drops (INVALIDATE) or applies
(UPDATE) the entry.  Messages carry the publishing handle's cache-id, and a
handle ignores its own messages — exactly the reference's excludedId scheme.

Strategies (same names and meanings as the reference enums):
  * SyncStrategy NONE / INVALIDATE / UPDATE
  * ReconnectionStrategy NONE / CLEAR / LOAD  (applied by `on_reconnect()`,
    which the remote client invokes from its watchdog after a re-connect)
  * EvictionPolicy NONE / LRU / LFU — bounded by `cache_size`
  * per-entry `time_to_live` / `max_idle` on the local copies

The local cache is a host-side structure only — reads that hit it never touch
the device path at all, which is the entire point (the reference's Caffeine
near cache saves a network hop; this one saves a dispatch).

A copy of ``redisson_tpu/client/objects/localcache.py``: the same sync
messages on the same channel, so an embedded handle, a wire handle of
either package (``client/remote.py`` RemoteLocalCachedMap) and the
reference's handles stay coherent with each other.
"""
from __future__ import annotations

import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from redisson_tpu_torch.client.objects.map import Map, MapOptions


class EvictionPolicy:
    NONE = "NONE"
    LRU = "LRU"
    LFU = "LFU"


class SyncStrategy:
    NONE = "NONE"
    INVALIDATE = "INVALIDATE"
    UPDATE = "UPDATE"
    # Server-assisted mode: coherence rides the CLIENT TRACKING
    # invalidation plane (tracking/) instead of the hand-rolled topic —
    # writers need not publish anything; the server remembers which
    # connections read the map and pushes RESP3 invalidations on write.
    # Wire handles (client/remote.py RemoteLocalCachedMap) require the
    # facade's tracking plane (client.enable_tracking()); the EMBEDDED
    # handle below has no wire, so it degrades to INVALIDATE topic
    # semantics — in-process peers are coherent either way.
    TRACKING = "TRACKING"


class ReconnectionStrategy:
    NONE = "NONE"
    CLEAR = "CLEAR"
    LOAD = "LOAD"


class LocalCachedMapOptions(MapOptions):
    """Mirror of api/LocalCachedMapOptions defaults (cacheSize=0 unbounded,
    LRU not enforced unless sized, syncStrategy=INVALIDATE)."""

    def __init__(
        self,
        *,
        cache_size: int = 0,
        eviction_policy: str = EvictionPolicy.NONE,
        time_to_live: Optional[float] = None,
        max_idle: Optional[float] = None,
        sync_strategy: str = SyncStrategy.INVALIDATE,
        reconnection_strategy: str = ReconnectionStrategy.NONE,
        **kw,
    ):
        super().__init__(**kw)
        self.cache_size = cache_size
        self.eviction_policy = eviction_policy
        self.time_to_live = time_to_live
        self.max_idle = max_idle
        self.sync_strategy = sync_strategy
        self.reconnection_strategy = reconnection_strategy

    @classmethod
    def defaults(cls) -> "LocalCachedMapOptions":
        return cls()


class _LocalCache:
    """Bounded decoded-entry cache: value + timestamps + LFU hit counter."""

    __slots__ = ("opts", "data")

    def __init__(self, opts: LocalCachedMapOptions):
        self.opts = opts
        # ek -> [value, created_at, last_access, hits]
        self.data: "OrderedDict[bytes, list]" = OrderedDict()

    def get(self, ek: bytes) -> Tuple[bool, Any]:
        cell = self.data.get(ek)
        if cell is None:
            return False, None
        now = time.time()
        o = self.opts
        if (o.time_to_live is not None and now - cell[1] >= o.time_to_live) or (
            o.max_idle is not None and now - cell[2] >= o.max_idle
        ):
            del self.data[ek]
            return False, None
        cell[2] = now
        cell[3] += 1
        if o.eviction_policy == EvictionPolicy.LRU:
            self.data.move_to_end(ek)
        return True, cell[0]

    def put(self, ek: bytes, value: Any) -> None:
        now = time.time()
        prev = self.data.pop(ek, None)
        self.data[ek] = [value, now, now, prev[3] if prev else 0]
        self._evict()

    def _evict(self) -> None:
        o = self.opts
        if o.cache_size <= 0:
            return
        while len(self.data) > o.cache_size:
            if o.eviction_policy == EvictionPolicy.LFU:
                victim = min(self.data, key=lambda k: self.data[k][3])
                del self.data[victim]
            else:  # LRU order (and insertion order for NONE) — head is oldest
                self.data.popitem(last=False)

    def invalidate(self, ek: bytes) -> None:
        self.data.pop(ek, None)

    def clear(self) -> None:
        self.data.clear()

    def __len__(self) -> int:
        return len(self.data)


class LocalCachedMap(Map):
    """Map + near cache.  Sync messages: ("inv", cache_id, [ek...]) |
    ("upd", cache_id, [(ek, ev)...]) | ("clear", cache_id)."""

    _kind = "map"

    def __init__(self, engine, name, codec=None, options: Optional[LocalCachedMapOptions] = None):
        opts = options or LocalCachedMapOptions.defaults()
        super().__init__(engine, name, codec, opts)
        self._lc_opts = opts
        self._cache = _LocalCache(opts)
        self._cache_id = uuid.uuid4().hex
        self._disabled: set = set()  # active tx-commit disable requests
        self._channel = f"redisson_local_cache:{name}"
        self._listener_id = engine.pubsub.subscribe(self._channel, self._on_sync)
        self.hits = 0
        self.misses = 0

    # -- invalidation plumbing ----------------------------------------------

    def _on_sync(self, channel: str, msg) -> None:
        if isinstance(msg, (bytes, bytearray)):
            # wire clients PUBLISH pickled tuples (client/remote.py
            # RemoteLocalCachedMap._broadcast) — same shape after decode
            from redisson_tpu_torch.net.safe_pickle import safe_loads

            try:
                msg = safe_loads(bytes(msg))
            except Exception:  # noqa: BLE001 — foreign frame on our channel
                return
        kind, sender = msg[0], msg[1]
        if sender == self._cache_id:
            return
        if kind == "inv":
            for ek in msg[2]:
                self._cache.invalidate(ek)
        elif kind == "upd":
            for ek, ev in msg[2]:
                self._cache.put(ek, self._dv(ev))
        elif kind == "clear":
            self._cache.clear()
        elif kind == "disable":
            # transaction commit handshake (LocalCachedMapDisable analog):
            # bypass the near cache until the matching enable — with a
            # failsafe timer in case the committer dies mid-commit
            self._disabled.add(sender)
            self._cache.clear()
            self._engine.schedule_timeout(
                lambda: self._disabled.discard(sender), 30.0
            )
        elif kind == "enable":
            self._disabled.discard(sender)
            self._cache.clear()

    def _broadcast(self, kind: str, payload=None) -> None:
        s = self._lc_opts.sync_strategy
        if s == SyncStrategy.NONE:
            return
        if kind == "upd" and s != SyncStrategy.UPDATE:
            # TRACKING degrades to INVALIDATE on the embedded handle (no
            # wire between in-process peers; see SyncStrategy.TRACKING)
            kind, payload = "inv", [ek for ek, _ in payload]
        self._engine.pubsub.publish(self._channel, (kind, self._cache_id, payload))

    # -- read path -----------------------------------------------------------

    def get(self, key):
        if self._disabled:
            # tx-commit window: read through, never serve or populate the
            # near cache (the reference's disabledKeys discipline)
            return super().get(key)
        ek = self._ek(key)
        hit, value = self._cache.get(ek)
        if hit:
            self.hits += 1
            return value
        self.misses += 1
        # read + cache-populate under the record lock: a writer cannot slip a
        # mutation (whose invalidation we'd miss) between our read and the
        # near-cache insert — the reference serializes the same window through
        # its cache-update listener ordering (LocalCacheListener.java)
        with self._engine.locked(self._name):
            value = super().get(key)
            if value is not None:
                self._cache.put(ek, value)
        return value

    def get_all(self, keys) -> Dict:
        if self._disabled:
            return super().get_all(keys)
        out, missing = {}, []
        for k in keys:
            hit, v = self._cache.get(self._ek(k))
            if hit:
                self.hits += 1
                out[k] = v
            else:
                self.misses += 1
                missing.append(k)
        if missing:
            with self._engine.locked(self._name):
                fetched = super().get_all(missing)
                for k, v in fetched.items():
                    self._cache.put(self._ek(k), v)
            out.update(fetched)
        return out

    # -- transaction commit handshake ----------------------------------------

    def tx_disable(self, req_id: str) -> None:
        """Broadcast + locally apply the near-cache disable for a
        transaction commit (disableLocalCacheAsync analog).  Published with
        the REQUEST id as sender so no subscriber — including this handle —
        is excluded by the own-write filter."""
        self._disabled.add(req_id)
        self._cache.clear()
        self._engine.pubsub.publish(self._channel, ("disable", req_id, None))

    def tx_enable(self, req_id: str) -> None:
        self._disabled.discard(req_id)
        self._cache.clear()
        self._engine.pubsub.publish(self._channel, ("enable", req_id, None))

    # -- write path (mutate shared map, update own cache, notify peers) ------

    def put(self, key, value):
        old = super().put(key, value)
        ek = self._ek(key)
        self._cache.put(ek, value)
        self._broadcast("upd", [(ek, self._ev(value))])
        return old

    def fast_put(self, key, value) -> bool:
        created = super().fast_put(key, value)
        ek = self._ek(key)
        self._cache.put(ek, value)
        self._broadcast("upd", [(ek, self._ev(value))])
        return created

    def put_all(self, entries: Dict) -> None:
        super().put_all(entries)
        payload = []
        for k, v in entries.items():
            ek = self._ek(k)
            self._cache.put(ek, v)
            payload.append((ek, self._ev(v)))
        self._broadcast("upd", payload)

    def put_if_absent(self, key, value):
        prev = super().put_if_absent(key, value)
        if prev is None:  # insert happened
            ek = self._ek(key)
            self._cache.put(ek, value)
            self._broadcast("upd", [(ek, self._ev(value))])
        return prev

    # fast_put_if_absent needs no override: Map.fast_put_if_absent delegates
    # to self.put_if_absent, which dispatches to the override above — a second
    # override here would cache and broadcast every insert twice

    def replace(self, key, value):
        old = super().replace(key, value)
        if old is not None:
            ek = self._ek(key)
            self._cache.put(ek, value)
            self._broadcast("upd", [(ek, self._ev(value))])
        return old

    def replace_if_equals(self, key, expected, update) -> bool:
        ok = super().replace_if_equals(key, expected, update)
        if ok:
            ek = self._ek(key)
            self._cache.put(ek, update)
            self._broadcast("upd", [(ek, self._ev(update))])
        return ok

    def remove_if_equals(self, key, expected) -> bool:
        ok = super().remove_if_equals(key, expected)
        if ok:
            ek = self._ek(key)
            self._cache.invalidate(ek)
            self._broadcast("inv", [ek])
        return ok

    def add_and_get(self, key, delta):
        new = super().add_and_get(key, delta)
        ek = self._ek(key)
        self._cache.put(ek, new)
        self._broadcast("upd", [(ek, self._ev(new))])
        return new

    def remove(self, key):
        old = super().remove(key)
        ek = self._ek(key)
        self._cache.invalidate(ek)
        self._broadcast("inv", [ek])
        return old

    def fast_remove(self, *keys) -> int:
        n = super().fast_remove(*keys)
        eks = [self._ek(k) for k in keys]
        for ek in eks:
            self._cache.invalidate(ek)
        self._broadcast("inv", eks)
        return n

    def clear(self) -> None:
        super().clear()
        self._cache.clear()
        self._engine.pubsub.publish(self._channel, ("clear", self._cache_id))

    # -- local-cache view (LocalCacheView analog) ----------------------------

    def cached_size(self) -> int:
        return len(self._cache)

    def cached_keys(self):
        return [self._dk(ek) for ek in list(self._cache.data.keys())]

    def clear_local_cache(self) -> None:
        self._cache.clear()

    def pre_load_cache(self) -> None:
        """Populate the near cache from the shared map (reference's
        ReconnectionStrategy.LOAD warm-up, LocalCacheListener.java:169-186)."""
        for k, v in super().read_all_entry_set():
            self._cache.put(self._ek(k), v)

    def on_reconnect(self) -> None:
        """Apply the configured ReconnectionStrategy after a connection drop —
        a stale near cache must not serve values missed while disconnected."""
        r = self._lc_opts.reconnection_strategy
        if r == ReconnectionStrategy.CLEAR:
            self._cache.clear()
        elif r == ReconnectionStrategy.LOAD:
            self._cache.clear()
            self.pre_load_cache()

    def destroy(self) -> None:
        """Detach from the invalidation channel (RObject.destroy parity)."""
        self._engine.pubsub.unsubscribe(self._channel, self._listener_id)
        self._cache.clear()
