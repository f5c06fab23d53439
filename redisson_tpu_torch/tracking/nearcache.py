"""Client near cache fed by the server's CLIENT TRACKING invalidation plane.

One ``ClientTracking`` per remote facade (``RemoteRedisson`` or
``ClusterRedisson`` — ``client.enable_tracking()``).  The wiring:

  * every node's dedicated pubsub connection (it already has a background
    reader thread) doubles as the **invalidation feed**: its stable
    ``CLIENT ID`` is the REDIRECT target;
  * every pooled DATA connection arms ``CLIENT TRACKING ON REDIRECT
    <feed-id>`` at connect time (``NodeClient.conn_setup``), so any read
    through the facade registers server-side and any write — by anyone —
    pushes an ``invalidate`` frame down the feed;
  * reads of tracked handles (``get_bucket``/``get_map``/``get_set``/
    ``get_bloom_filter`` below) consult one shared bounded-LRU
    ``NearCache`` first; a hit never touches the wire at all.

Coherence disciplines:

  * **populate-vs-invalidate race**: a fetch snapshots the cache GENERATION
    of its name before going to the wire and only populates if no
    invalidation (or flush) bumped it meanwhile — the wire analog of the
    embedded localcache's read+populate-under-the-record-lock.
  * **reconnection CLEAR**: a feed that dies may have dropped invalidation
    frames.  The whole cache flushes, the plane's EPOCH bumps, and every
    data connection armed against the dead feed retires as it releases
    (``ConnectionPool.release_filter``) — a connection whose server-side
    tracking state is gone must never serve another cache-populating read.
    Node-level disconnects (events hub) flush too.
  * **bloom negatives**: a bloom ``contains`` miss is immutable-until-add,
    so negative (and positive — those are immutable outright) lookups are
    cached per (filter, key) and the filter's add stream invalidates them.

A copy of ``redisson_tpu/tracking/nearcache.py``, with the plane's name
listeners (``add_name_listener``) that the local cached map's TRACKING sync
strategy rides.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from redisson_tpu_torch.net import commands as C
from redisson_tpu_torch.net.client import ConnectionError_
from redisson_tpu_torch.net.resp import RespError


class NearCache:
    """Bounded-LRU (name, subkey) -> value cache with per-name generations.

    ``gen(name)`` / ``put(..., gen)`` implement the populate guard: an
    invalidation or flush between the gen snapshot and the put bumps the
    generation, so the stale fetch result is discarded instead of cached.
    """

    def __init__(self, max_entries: int = 65536):
        self._lock = threading.Lock()
        self.max_entries = max_entries
        self._entries: "OrderedDict[Tuple[str, Any], Any]" = OrderedDict()
        self._index: Dict[str, set] = {}  # name -> subkeys present
        self._gens: Dict[str, int] = {}
        self._flush_gen = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0
        self.flushes = 0

    def gen(self, name: str) -> Tuple[int, int]:
        with self._lock:
            return (self._flush_gen, self._gens.get(name, 0))

    def get(self, name: str, sub) -> Tuple[bool, Any]:
        key = (name, sub)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return True, self._entries[key]
            self.misses += 1
            return False, None

    def put(self, name: str, sub, value, gen: Tuple[int, int]) -> bool:
        with self._lock:
            if gen != (self._flush_gen, self._gens.get(name, 0)):
                return False  # an invalidation raced the fetch: stay empty
            self._entries[(name, sub)] = value
            self._entries.move_to_end((name, sub))
            self._index.setdefault(name, set()).add(sub)
            while len(self._entries) > self.max_entries:
                (en, es), _v = self._entries.popitem(last=False)
                subs = self._index.get(en)
                if subs is not None:
                    subs.discard(es)
                    if not subs:
                        del self._index[en]
                self.evictions += 1
            return True

    def invalidate(self, name: str) -> None:
        with self._lock:
            self._gens[name] = self._gens.get(name, 0) + 1
            if len(self._gens) > 4 * max(self.max_entries, 1024):
                # generations must stay monotonic per name for the populate
                # guard, so they cannot be pruned individually — bound the
                # registry by promoting to a full flush instead
                self._flush_locked()
                return
            subs = self._index.pop(name, None)
            if subs:
                for sub in subs:
                    self._entries.pop((name, sub), None)
            self.invalidations += 1

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        self._flush_gen += 1
        self._entries.clear()
        self._index.clear()
        self._gens.clear()
        self.flushes += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "flushes": self.flushes,
            }


def _subkey(tag: str, key) -> Optional[tuple]:
    """Cacheable subkey for a method arg, or None when the arg cannot key a
    dict (unhashable user objects bypass the cache, never break it)."""
    try:
        hash(key)
    except TypeError:
        return None
    return (tag, key)


class _HubListener:
    """events-hub adapter: ANY node-level disconnect flushes the cache (the
    gap may have swallowed invalidations from that node)."""

    def __init__(self, plane: "ClientTracking"):
        self._plane = plane

    def on_connect(self, address: str) -> None:  # noqa: D401 — no-op
        pass

    def on_disconnect(self, address: str) -> None:
        self._plane.connection_lost(address)


class ClientTracking:
    """The client half of the tracking plane: feed arming + the shared
    ``NearCache`` + tracked-handle factories."""

    def __init__(self, client, cache_entries: int = 65536, noloop: bool = False):
        self.client = client
        self.cache = NearCache(cache_entries)
        self.noloop = noloop
        self._lock = threading.RLock()
        # global event counter (stats/telemetry only; the retirement logic
        # is PER-NODE — see _rtpu_feed_epoch below)
        self._epoch = 0
        self._closed = False
        self._name_listeners: Dict[str, List[Callable]] = {}
        self._hub_listener = None
        # future nodes (cluster topology refresh constructs NodeClients from
        # _node_kw) inherit the arming hook automatically
        nk = getattr(client, "_node_kw", None)
        if nk is not None:
            nk["conn_setup"] = self._conn_setup
        # each ShardEntry snapshotted _node_kw at creation: pre-enable
        # entries need the hook injected so replicas they discover LATER
        # arm too (a replica-routed read on an unarmed conn would populate
        # the cache with no server-side registration — stale forever)
        for entry in self._entries():
            entry._node_kw["conn_setup"] = self._conn_setup
        for node in self._nodes():
            self._install(node)
            # arm the feed NOW: lazy arming inside the first read's connect
            # would flush the cache mid-fetch and void that read's populate
            try:
                self._ensure_feed(node)
            except Exception:  # noqa: BLE001 — node down: armed on reconnect
                pass
        hub = getattr(client, "events_hub", None)
        if hub is not None:
            self._hub_listener = hub.add_listener(_HubListener(self))

    # -- wiring ---------------------------------------------------------------

    def _entries(self) -> list:
        entries = getattr(self.client, "entries", None)
        return list(entries()) if callable(entries) else []

    def _nodes(self) -> list:
        node = getattr(self.client, "node", None)
        if node is not None:
            return [node]
        # masters AND replicas: with read_mode=replica/master_slave, reads
        # route to replicas and populate the near cache — those reads must
        # register on the replica's tracking table (REPLPUSH apply
        # invalidates there), so replica connections arm exactly like
        # master ones
        out = []
        for e in self._entries():
            out.append(e.master)
            out.extend(e.replicas.values())
        return out

    def _install(self, node) -> None:
        node.conn_setup = self._conn_setup
        node.pool.release_filter = self._release_ok
        # existing idle connections predate the plane: retire them so every
        # pooled connection goes through the arming handshake
        node.pool.clear_idle()

    def _conn_setup(self, node, conn) -> None:
        if self._closed:
            return
        # nodes created AFTER enable (cluster topology refresh) inherit the
        # setup hook via _node_kw but not the pool filter — install it here
        # (idempotent) so their stale-epoch conns retire on release too
        # (== not `is`: each attribute access mints a fresh bound-method
        # object, so `is` never matches; bound methods compare by
        # __self__/__func__)
        if node.pool.release_filter != self._release_ok:
            node.pool.release_filter = self._release_ok
        feed = self._ensure_feed(node)
        if feed.client_id is None:
            raise ConnectionError_(
                f"tracking feed to {node.address} has no client id"
            )
        args = ["CLIENT", "TRACKING", "ON", "REDIRECT", str(feed.client_id)]
        if self.noloop:
            args.append("NOLOOP")
        # snapshot the node's feed generation AFTER _ensure_feed (which may
        # have bumped it) but BEFORE the arming round-trip: if the feed dies
        # while CLIENT TRACKING is in flight, _on_feed_down bumps the node
        # epoch and this conn — armed against the now-dead feed — must stamp
        # the OLD epoch so _release_ok retires it instead of pooling a conn
        # whose server-side push route delivers nowhere
        epoch = getattr(node, "_rtpu_feed_epoch", 0)
        reply = conn.execute(*args)
        if isinstance(reply, RespError):
            raise reply
        # release retires the conn the moment the node's feed it redirects
        # to is no longer the live one — a conn whose feed died has lost its
        # server-side tracking (redirect-broken), so pooling it would let
        # untracked reads populate the cache invisibly
        conn._rtpu_track_node = node
        conn._rtpu_track_epoch = epoch

    def _ensure_feed(self, node):
        feed = node.pubsub()  # recreated by NodeClient when the old one died
        if not getattr(feed, "_rtpu_inv_armed", False):
            with self._lock:
                if not getattr(feed, "_rtpu_inv_armed", False):
                    # a NEW feed = first enable OR the previous feed ended:
                    # the reconnection-CLEAR sequence, IN THIS ORDER —
                    # (1) bump the node's feed generation (in-use conns
                    #     armed against the old feed retire on release),
                    # (2) clear the node's idle pool (old-feed conns can no
                    #     longer be acquired),
                    # (3) flush the cache (any populate whose gen snapshot
                    #     predates this is voided).
                    # clear_idle BEFORE flush matters: a read whose gen
                    # snapshot post-dates the flush can then only acquire a
                    # freshly-armed conn — flushing first would leave a
                    # window where such a read acquires an old-feed idle
                    # conn and populates an entry no live feed can ever
                    # invalidate.  Together: every populate that survives
                    # was read on a connection whose registrations the LIVE
                    # feed serves.
                    node._rtpu_feed_epoch = getattr(node, "_rtpu_feed_epoch", 0) + 1
                    self._epoch += 1
                    node.pool.clear_idle()
                    self.cache.flush()
                    self._notify(None)
                    feed.add_invalidation_listener(self._on_invalidate)
                    feed.on_disconnect = self._on_feed_down
                    feed._rtpu_inv_armed = True
                    feed._rtpu_inv_node = node
        return feed

    def _release_ok(self, conn) -> bool:
        node = getattr(conn, "_rtpu_track_node", None)
        if node is None:
            return False  # pre-plane conn: retire, a fresh one arms properly
        return (
            getattr(conn, "_rtpu_track_epoch", -1)
            == getattr(node, "_rtpu_feed_epoch", 0)
        )

    # -- invalidation stream --------------------------------------------------

    def _on_invalidate(self, keys) -> None:
        if keys is None:
            # FLUSHALL / flush-everything frame
            self.cache.flush()
            self._notify(None)
            return
        for k in keys:
            name = k.decode() if isinstance(k, (bytes, bytearray)) else str(k)
            self.cache.invalidate(name)
            self._notify(name)

    def _on_feed_down(self, feed) -> None:
        node = getattr(feed, "_rtpu_inv_node", None)
        with self._lock:
            if self._closed:
                return
            # same ordering as the arm path: generation bump first (in-use
            # conns retire on release), then idle clear, then flush — a read
            # whose gen snapshot post-dates the flush must only be able to
            # acquire a freshly-armed conn
            if node is not None:
                node._rtpu_feed_epoch = getattr(node, "_rtpu_feed_epoch", 0) + 1
            self._epoch += 1
        if node is not None:
            node.pool.clear_idle()
        self.cache.flush()
        self._notify(None)

    def connection_lost(self, address: str) -> None:
        """Node-level disconnect (events hub): the gap may have swallowed
        pushes from that node — flush (conn retirement is owned by the
        feed-generation machinery; a data-conn blip with the feed intact
        loses nothing conn-wise)."""
        if self._closed:
            return
        with self._lock:
            self._epoch += 1
        self.cache.flush()
        self._notify(None)

    # -- name listeners (localcache TRACKING mode rides these) ----------------

    def add_name_listener(self, name: str, fn: Callable) -> Callable:
        """fn(name) on that name's invalidation; fn(None) on a full flush."""
        with self._lock:
            self._name_listeners.setdefault(name, []).append(fn)
        return fn

    def remove_name_listener(self, name: str, fn: Callable) -> None:
        with self._lock:
            fns = self._name_listeners.get(name)
            if fns is None:
                return
            try:
                fns.remove(fn)
            except ValueError:
                return
            if not fns:
                del self._name_listeners[name]

    def _notify(self, name: Optional[str]) -> None:
        with self._lock:
            if name is None:
                fns = [f for lst in self._name_listeners.values() for f in lst]
            else:
                fns = list(self._name_listeners.get(name, ()))
        for fn in fns:
            try:
                fn(name)
            except Exception:  # noqa: BLE001 — listener bugs stay contained
                pass

    # -- read-through helper --------------------------------------------------

    def cached_call(self, name: str, sub, fetch: Callable[[], Any],
                    cache_none: bool = False) -> Any:
        hit, v = self.cache.get(name, sub)
        if hit:
            return v
        gen = self.cache.gen(name)
        v = fetch()
        if v is not None or cache_none:
            self.cache.put(name, sub, v, gen)
        return v

    # -- tracked handles ------------------------------------------------------

    def get_bucket(self, name: str, codec=None) -> "TrackedBucket":
        return TrackedBucket(self, name, codec)

    def get_map(self, name: str, codec=None) -> "TrackedMap":
        return TrackedMap(self, name, codec)

    def get_set(self, name: str, codec=None) -> "TrackedSet":
        return TrackedSet(self, name, codec)

    def get_bloom_filter(self, name: str, codec=None) -> "NearBloomFilter":
        return NearBloomFilter(self, name, codec)

    # -- lifecycle ------------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    def stats(self) -> Dict[str, Any]:
        out = self.cache.stats()
        out["epoch"] = self._epoch
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._name_listeners.clear()
        hub = getattr(self.client, "events_hub", None)
        if hub is not None and self._hub_listener is not None:
            hub.remove_listener(self._hub_listener)
        # == not `is` throughout: `self._conn_setup` mints a fresh bound-
        # method object per access, so identity never matches the hook we
        # installed — `is` left every hook in place after close(), and the
        # still-installed _release_ok then closed every unarmed connection
        # on release (one TCP connect per op on a closed plane)
        for node in self._nodes():
            if node.conn_setup == self._conn_setup:
                node.conn_setup = None
            if node.pool.release_filter == self._release_ok:
                node.pool.release_filter = None
        nk = getattr(self.client, "_node_kw", None)
        if nk is not None and nk.get("conn_setup") == self._conn_setup:
            nk.pop("conn_setup", None)
        for entry in self._entries():
            ek = getattr(entry, "_node_kw", None)
            if ek is not None and ek.get("conn_setup") == self._conn_setup:
                ek.pop("conn_setup", None)
        self.cache.flush()


class _TrackedProxyBase:
    """Shared shape of ALL tracked handles: explicit cached read methods +
    a generic fall-through that locally invalidates after any write-method
    (same read/write split the wire router uses).  Every mutator a handle
    does not explicitly wrap MUST land here: under NOLOOP the server
    suppresses the self-write push, so a write slipping through
    undecorated would leave the near cache permanently stale."""

    _plane: ClientTracking
    name: str

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        fn = getattr(self._proxy, method)
        if callable(fn) and C.objcall_is_write(method):
            plane, name = self._plane, self.name

            def call(*a, **kw):
                # invalidate even when the wire call raises: a timeout /
                # dropped reply may still have APPLIED server-side, and
                # under NOLOOP no push will correct the cache for us
                try:
                    return fn(*a, **kw)
                finally:
                    plane.cache.invalidate(name)

            call.__name__ = method
            return call
        return fn


class TrackedBucket(_TrackedProxyBase):
    """RBucket read path over the near cache (value keyed at (name, 'get'));
    mutators outside ``set`` (try_set, delete, compare_and_set,
    get_and_set, ...) ride the base write fall-through."""

    def __init__(self, plane: ClientTracking, name: str, codec=None):
        self._plane = plane
        self.name = name
        self._proxy = plane.client.get_bucket(name, codec)

    def get(self):
        return self._plane.cached_call(self.name, ("get",), self._proxy.get)

    def set(self, value, ttl: Optional[float] = None) -> None:
        if self._plane.noloop and ttl is None:
            # NOLOOP: the server will NOT push our own write back at us, so
            # the freshly-written value can seed our own cache (the
            # excludedId own-write discipline of the reference's localcache).
            # Gen-guarded: a concurrent writer's invalidation between the
            # snapshot and the populate voids it.
            gen = self._plane.cache.gen(self.name)
            try:
                self._proxy.set(value, ttl)
            except BaseException:
                # the write may still have APPLIED (lost reply): drop any
                # cached value — under NOLOOP no push corrects it for us
                self._plane.cache.invalidate(self.name)
                raise
            self._plane.cache.invalidate(self.name)
            gen = (gen[0], gen[1] + 1)  # our own invalidation, just issued
            self._plane.cache.put(self.name, ("get",), value, gen)
            return
        try:
            self._proxy.set(value, ttl)
        finally:
            # own-write invalidation NOW, even on a raised (possibly still
            # applied) call; the server's push also comes unless NOLOOP —
            # arriving later, it just re-invalidates
            self._plane.cache.invalidate(self.name)


class TrackedMap(_TrackedProxyBase):
    """RMap read path (get / get_all / contains_key) over the near cache."""

    def __init__(self, plane: ClientTracking, name: str, codec=None):
        self._plane = plane
        self.name = name
        self._proxy = plane.client.get_map(name, codec)

    def get(self, key):
        sub = _subkey("mget", key)
        if sub is None:
            return self._proxy.get(key)
        return self._plane.cached_call(self.name, sub, lambda: self._proxy.get(key))

    def contains_key(self, key) -> bool:
        sub = _subkey("mhas", key)
        if sub is None:
            return self._proxy.contains_key(key)
        return self._plane.cached_call(
            self.name, sub, lambda: self._proxy.contains_key(key), cache_none=True
        )

    def get_all(self, keys) -> Dict:
        out, missing = {}, []
        cache = self._plane.cache
        for k in keys:
            sub = _subkey("mget", k)
            hit, v = cache.get(self.name, sub) if sub is not None else (False, None)
            if hit and v is not None:
                out[k] = v
            else:
                missing.append(k)
        if missing:
            gen = cache.gen(self.name)
            fetched = self._proxy.get_all(list(missing))
            for k, v in fetched.items():
                sub = _subkey("mget", k)
                if sub is not None and v is not None:
                    cache.put(self.name, sub, v, gen)
            out.update(fetched)
        return out


class TrackedSet(_TrackedProxyBase):
    """RSet membership over the near cache."""

    def __init__(self, plane: ClientTracking, name: str, codec=None):
        self._plane = plane
        self.name = name
        self._proxy = plane.client.get_set(name, codec)

    def contains(self, value) -> bool:
        sub = _subkey("shas", value)
        if sub is None:
            return self._proxy.contains(value)
        return self._plane.cached_call(
            self.name, sub, lambda: self._proxy.contains(value), cache_none=True
        )


class NearBloomFilter(_TrackedProxyBase):
    """Bloom membership over the near cache (the sketch leg of the plane).

    A bloom ``contains`` answer is immutable-until-add for negatives and
    immutable outright for positives, so BOTH cache client-side keyed by
    (filter, key); the filter's add stream (every BF.ADD/MADD is a write on
    the filter name) invalidates the lot — add/add_all/add_each and any
    other mutator ride the base write fall-through.  Read-mostly membership
    traffic answers locally and only pays the wire on invalidation."""

    def __init__(self, plane: ClientTracking, name: str, codec=None):
        self._plane = plane
        self.name = name
        self._proxy = plane.client.get_bloom_filter(name, codec)

    def _sub(self, obj) -> Optional[tuple]:
        if isinstance(obj, (int, np.integer)):
            return ("bf", int(obj))
        if isinstance(obj, bytes):
            return ("bf", obj)
        if isinstance(obj, str):
            return ("bf", obj)
        return _subkey("bf", obj)

    def contains(self, obj) -> bool:
        sub = self._sub(obj)
        if sub is None:
            return self._proxy.contains(obj)
        return bool(self._plane.cached_call(
            self.name, sub, lambda: bool(self._proxy.contains(obj)),
            cache_none=True,
        ))

    def contains_each(self, objs) -> np.ndarray:
        objs = np.asarray(objs)
        if objs.dtype.kind not in "iu":
            return self._proxy.contains_each(objs)
        flat = objs.reshape(-1)
        out = np.zeros(flat.shape[0], dtype=bool)
        cache = self._plane.cache
        miss_idx: List[int] = []
        for i, k in enumerate(flat):
            hit, v = cache.get(self.name, ("bf", int(k)))
            if hit:
                out[i] = v
            else:
                miss_idx.append(i)
        if miss_idx:
            gen = cache.gen(self.name)
            wire = self._proxy.contains_each(flat[miss_idx])
            for j, i in enumerate(miss_idx):
                val = bool(wire[j])
                out[i] = val
                cache.put(self.name, ("bf", int(flat[i])), val, gen)
        return out

    def count_contains(self, objs) -> int:
        return int(self.contains_each(objs).sum())
