"""RemoteRedisson: client/remote mode — the full object surface over the wire.

Role parity: this is what `Redisson.create(config)` gives a JVM app — a
client whose object handles execute on a remote data plane.  Two paths:

  * **Hot path** (sketch/bit tensors): dedicated wire commands whose payloads
    are packed binary batches (BF.MADD64 et al.) — the RBatch flush arrives at
    the server as ONE command and dispatches ONE fused kernel.
  * **Everything else**: `OBJCALL` generic invocation — the client-side proxy
    pickles (args, kwargs), the server executes the same method on its
    embedded handle and ships the pickled result back (the reference ships
    serialized task classBody the same way, executor/TasksRunnerService.java).

Listeners (topics) ride the dedicated pubsub connection.

A copy of ``redisson_tpu/client/remote.py``.  It drives the port's server
and the reference's alike: pickled frames go through ``net/safe_pickle``,
which writes and reads the reference's class names.  Differences:

  * The lock watchdog's wheel timer and renewal pool belong to the facade,
    not to the process, and ``shutdown()`` stops them, so a client that was
    shut down leaves no thread behind.
  * The elements subscribe service's threads are joined by ``shutdown()``.
  * A local cached map's failsafe timer (a transaction commit's disable
    that no enable follows) rides the facade's wheel timer, not a thread of
    its own.
  * The replication methods (``sync_replication``,
    ``replication_state``) are here; the port's server answers their verbs
    with ROADMAP M11.
"""
from __future__ import annotations

import logging
import threading as _threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from redisson_tpu_torch.client.codec import DEFAULT_CODEC, Codec
from redisson_tpu_torch.net import safe_pickle
from redisson_tpu_torch.net.client import NodeClient
from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.net.safe_pickle import safe_loads

logger = logging.getLogger(__name__)

# first-enable CAS for RemoteSurface.enable_tracking (shared across facades:
# the op is once-per-facade, contention is nil)
_tracking_enable_lock = _threading.Lock()

# ObjectRef resolution (RedissonReference over the wire): server-side
# handles pickle as inert ObjectRef descriptors (objects/base.py
# __reduce__); the receiving client rebinds them to LIVE handles through
# its own factories so references read back as objects on every surface.
_REF_FACTORIES = {
    "Map": "get_map", "MapCache": "get_map_cache",
    # LocalCachedMap must rebind as a local-cached handle: resolving it as a
    # plain map would mutate without publishing invalidations, leaving every
    # other client's near cache silently stale
    "LocalCachedMap": "get_local_cached_map",
    "Set": "get_set", "SetCache": "get_set_cache",
    "RList": "get_list", "Queue": "get_queue", "Deque": "get_deque",
    "BlockingQueue": "get_blocking_queue", "BlockingDeque": "get_blocking_deque",
    "PriorityQueue": "get_priority_queue", "PriorityDeque": "get_priority_deque",
    "PriorityBlockingQueue": "get_priority_blocking_queue",
    "PriorityBlockingDeque": "get_priority_blocking_deque",
    "RingBuffer": "get_ring_buffer",
    # DelayedQueue deliberately absent: its factory takes the DESTINATION
    # queue handle, not a name — a by-name rebind can't reconstruct it, so
    # its references stay inert (name + type still identify it)
    "TransferQueue": "get_transfer_queue",
    "ScoredSortedSet": "get_scored_sorted_set",
    "SortedSet": "get_sorted_set", "LexSortedSet": "get_lex_sorted_set",
    "ListMultimap": "get_list_multimap", "SetMultimap": "get_set_multimap",
    "ListMultimapCache": "get_list_multimap_cache",
    "SetMultimapCache": "get_set_multimap_cache",
    "BoundedBlockingQueue": "get_bounded_blocking_queue",
    "Bucket": "get_bucket", "AtomicLong": "get_atomic_long",
    "AtomicDouble": "get_atomic_double", "IdGenerator": "get_id_generator",
    "BitSet": "get_bit_set", "BloomFilter": "get_bloom_filter",
    "HyperLogLog": "get_hyper_log_log", "Geo": "get_geo",
    "TimeSeries": "get_time_series", "Stream": "get_stream",
    "JsonBucket": "get_json_bucket", "BinaryStream": "get_binary_stream",
    "Lock": "get_lock", "FairLock": "get_fair_lock", "SpinLock": "get_spin_lock",
    "FencedLock": "get_fenced_lock", "Semaphore": "get_semaphore",
    "CountDownLatch": "get_count_down_latch", "RateLimiter": "get_rate_limiter",
}

# classes whose handles never decode user values with their codec
# (synchronizers, numeric counters, raw-bit state): the ref's recorded
# codec — every handle carries one, usually the default — is irrelevant,
# so their factories are called name-only.  Everything else MUST honor the
# reference's codec or fail loudly (see resolve_ref).
_CODEC_FREE = {
    "Lock", "FairLock", "SpinLock", "FencedLock", "Semaphore",
    "CountDownLatch", "RateLimiter", "AtomicLong", "AtomicDouble",
    "IdGenerator", "BitSet",
}


def resolve_ref(client, ref):
    """ObjectRef -> live handle via the client's factory; unknown classes
    stay inert (the descriptor itself is still useful: name + type)."""
    from redisson_tpu_torch.client.codec import _codec_from_spec

    factory = getattr(client, _REF_FACTORIES.get(ref.cls, ""), None)
    if factory is None:
        return ref
    codec = _codec_from_spec(ref.codec)
    if ref.codec is not None and codec is None and ref.cls not in _CODEC_FREE:
        # the reference recorded a codec its spec cannot rebuild
        # (CompositeCodec halves, parameterized codecs): resolving with the
        # default codec would silently misdecode — stay inert instead
        return ref
    if (
        codec is not None
        and type(codec) is type(DEFAULT_CODEC)
        and getattr(codec, "inner", None) is None
    ):
        # every handle records a codec, usually the default: passing the
        # default along changes nothing, and name-only keeps codec-less
        # surfaces (async proxies) resolving
        codec = None
    if codec is None or ref.cls in _CODEC_FREE:
        return factory(ref.name)
    # a factory that cannot honor the reference's NON-default codec must
    # FAIL here, not silently decode with the default one — the async
    # surface raises TypeError for exactly that (aio.py make()); swallowing
    # it would turn a StringCodec list into wrongly-JSON-decoded values
    # with no trace
    return factory(ref.name, codec)


def _resolve_refs(client, value):
    """Resolve ObjectRefs at the top level and one container level deep —
    the shapes object methods actually return (scalars, lists, dicts)."""
    from redisson_tpu_torch.client.codec import ObjectRef

    if client is None:
        return value
    if isinstance(value, ObjectRef):
        return resolve_ref(client, value)
    if isinstance(value, list):
        return [resolve_ref(client, v) if isinstance(v, ObjectRef) else v for v in value]
    if isinstance(value, tuple):
        return tuple(resolve_ref(client, v) if isinstance(v, ObjectRef) else v for v in value)
    if isinstance(value, dict):
        return {
            (resolve_ref(client, k) if isinstance(k, ObjectRef) else k):
            (resolve_ref(client, v) if isinstance(v, ObjectRef) else v)
            for k, v in value.items()
        }
    return value


def _unwrap(reply: Any, client=None) -> Any:
    if isinstance(reply, RespError):
        raise reply
    if isinstance(reply, (bytes, bytearray)) and reply[:1] in (b"R", b"E"):
        payload = safe_loads(bytes(reply[1:]))
        if reply[:1] == b"E":
            raise payload
        return _resolve_refs(client, payload)
    return reply


def _unwrap_many(reply: Any, client=None) -> List[Any]:
    """Decode an OBJCALLM reply: list of results with per-op exceptions left
    AS VALUES (batch semantics — the caller decides what to raise)."""
    if isinstance(reply, RespError):
        raise reply
    if not (isinstance(reply, (bytes, bytearray)) and reply[:1] == b"M"):
        raise RespError("ERR bad OBJCALLM reply frame")
    return [_resolve_refs(client, r) for _tag, r in safe_loads(bytes(reply[1:]))]


class RemoteObjectProxy:
    """Generic remote handle: every method call becomes one OBJCALL.

    A non-default `codec` travels with every call (OBJCALL's optional codec
    frame arg) so the server-side handle encodes keys/values exactly like
    the caller's — the reference's getMap(name, codec) contract."""

    def __init__(self, client: "RemoteRedisson", factory: str, name: str,
                 codec: Optional[Codec] = None):
        self._client = client
        self._factory = factory
        self._name = name
        self._codec = codec

    @property
    def name(self) -> str:
        return self._name

    def drain_to(self, collection: list, max_elements: Optional[int] = None) -> int:
        """Out-param methods cannot cross the RPC boundary (the server would
        fill a pickled COPY of `collection`); re-expressed as one poll_many
        wire call whose reply fills the caller's collection locally —
        the reference's drainTo is the same client-side loop shape."""
        items = self.poll_many(max_elements if max_elements is not None else 1 << 62)
        collection.extend(items)
        return len(items)

    def add_entry_listener(self, kind: str, fn):
        """MapCache entry events ride pubsub channels
        (`redisson_map_cache_<kind>:{name}`), so a remote listener is a wire
        SUBSCRIBE — callbacks cannot cross RPC as OBJCALL args.  fn is
        called as fn(key, value, old_value), same as the embedded handle."""
        from redisson_tpu_torch.client.objects.map import MapCache

        if kind not in MapCache.EVENT_KINDS:  # fail fast like the embedded handle
            raise ValueError(f"unknown entry event kind: {kind!r}")
        ch = f"redisson_map_cache_{kind}:{self._name}"

        def wire_listener(_channel: str, payload: bytes) -> None:
            # guarded: an exception here would kill the shared pubsub reader
            # thread and silently end ALL push delivery on this connection
            try:
                fn(*safe_loads(payload))
            except Exception:  # noqa: BLE001 — listener faults must not stop the reader
                logger.exception("entry listener for %s failed", ch)

        # subscribe on the shard that owns the MAP (not the channel string):
        # the engine-hub publish happens on the master serving the map's
        # slot, so that is where has_listeners() must see this subscriber
        self._client.pubsub_for(self._name).subscribe(ch, wire_listener)
        return (ch, wire_listener)

    def remove_entry_listener(self, token) -> None:
        ch, wire_listener = token
        self._client.pubsub_for(self._name).remove_listener(ch, wire_listener)

    def __getattr__(self, method: str) -> Callable:
        if method.startswith("_"):
            raise AttributeError(method)

        def call(*args, **kwargs):
            return self._client.objcall(
                self._factory, self._name, method, args, kwargs, codec=self._codec
            )

        call.__name__ = method
        return call


def int64_blob(keys) -> bytes:
    """The blob wire form for integer key batches (BF.MADD64 family): one
    little-endian i64 buffer — shared by every sync/async blob handle so
    the wire shape cannot drift between surfaces."""
    return np.ascontiguousarray(keys, dtype="<i8").tobytes()


def bool_reply(out) -> np.ndarray:
    """Decode a blob command's per-key byte reply into a bool array."""
    return np.frombuffer(out, np.uint8).astype(bool)


def reserve_exists(err: "RespError") -> bool:
    """True when BF.RESERVE failed because the filter ALREADY EXISTS (the
    RedisBloom 'item exists' wording) — any other error must propagate."""
    return "item exists" in str(err)


class _ObjcallFallback:
    """Unknown methods on the CONCRETE fast-path handles fall through to
    OBJCALL on the matching factory: the typed verbs stay the hot path,
    while the full embedded surface (lifecycle ops, conditional expiry,
    future additions) is reachable without hand-mirroring every method."""

    _FALLBACK_FACTORY: str = ""

    def __getattr__(self, method: str):
        if method.startswith("_") or not self._FALLBACK_FACTORY:
            raise AttributeError(method)

        def call(*args, **kwargs):
            return self._client.objcall(
                self._FALLBACK_FACTORY, self.name, method, args, kwargs,
                # the handle's codec travels like the generic proxy's:
                # a custom-codec handle must not fall back to the default
                codec=getattr(self, "_codec", None),
            )

        call.__name__ = method
        return call


class RemoteBloomFilter(_ObjcallFallback):
    """Hot-path bloom handle (BF.* wire commands; int batches ride blobs)."""

    _FALLBACK_FACTORY = "get_bloom_filter"

    def __init__(self, client: "RemoteRedisson", name: str, codec: Optional[Codec]):
        self._client = client
        self.name = name
        self._codec = codec or DEFAULT_CODEC

    def try_init(self, expected_insertions: int, false_probability: float) -> bool:
        try:
            self._client.execute(
                "BF.RESERVE", self.name, repr(false_probability), expected_insertions
            )
            return True
        except RespError as e:
            if reserve_exists(e):
                return False  # already initialized: the documented False
            raise  # bad params / routing exhaustion must not masquerade

    def _encode_keys(self, objs) -> List[bytes]:
        if isinstance(objs, (bytes, str, int, float)):
            objs = [objs]
        return [o if isinstance(o, bytes) else self._codec.encode(o) for o in objs]

    def add(self, obj) -> bool:
        if isinstance(obj, np.ndarray):
            # embedded-handle parity (objects/bloom.py BloomFilter.add): an
            # array argument is a BATCH — the old path encoded the array to
            # a key list and silently added only its first element
            return bool(self.add_each(obj).any())
        return bool(self._client.execute("BF.ADD", self.name, self._encode_keys(obj)[0]))

    def add_all(self, objs) -> int:
        return int(self.add_each(objs).sum())

    def add_each(self, objs) -> np.ndarray:
        if isinstance(objs, np.ndarray) and objs.dtype.kind in "iu":
            out = self._client.execute("BF.MADD64", self.name, int64_blob(objs))
            return bool_reply(out)
        reply = self._client.execute("BF.MADD", self.name, *self._encode_keys(objs))
        return np.asarray(reply, dtype=bool)

    def contains(self, obj) -> bool:
        return bool(self._client.execute("BF.EXISTS", self.name, self._encode_keys(obj)[0]))

    def contains_each(self, objs) -> np.ndarray:
        if isinstance(objs, np.ndarray) and objs.dtype.kind in "iu":
            out = self._client.execute("BF.MEXISTS64", self.name, int64_blob(objs))
            return bool_reply(out)
        reply = self._client.execute("BF.MEXISTS", self.name, *self._encode_keys(objs))
        return np.asarray(reply, dtype=bool)

    def count_contains(self, objs) -> int:
        return int(self.contains_each(objs).sum())


class RemoteBloomFilterArray(_ObjcallFallback):
    """Multi-tenant bloom bank over the wire (BFA.* blob commands)."""

    _FALLBACK_FACTORY = "get_bloom_filter_array"

    def __init__(self, client: "RemoteRedisson", name: str):
        self._client = client
        self.name = name

    def try_init(self, tenants: int, expected_insertions: int, false_probability: float) -> bool:
        try:
            self._client.execute(
                "BFA.RESERVE", self.name, tenants, expected_insertions, repr(false_probability)
            )
            return True
        except RespError:
            return False

    def _blobs(self, tenant_ids, keys) -> Tuple[bytes, bytes]:
        t = np.ascontiguousarray(np.asarray(tenant_ids), dtype="<i4").tobytes()
        k = np.ascontiguousarray(np.asarray(keys), dtype="<i8").tobytes()
        return t, k

    def add_each(self, tenant_ids, keys) -> np.ndarray:
        t, k = self._blobs(tenant_ids, keys)
        out = self._client.execute("BFA.MADD64", self.name, t, k)
        return np.frombuffer(out, np.uint8).astype(bool)

    def contains(self, tenant_ids, keys) -> np.ndarray:
        t, k = self._blobs(tenant_ids, keys)
        out = self._client.execute("BFA.MEXISTS64", self.name, t, k)
        return np.frombuffer(out, np.uint8).astype(bool)


class RemoteHyperLogLogArray(_ObjcallFallback):
    """Multi-tenant HLL bank over the wire (HLLA.* blob commands — the
    sketch-blob discipline of the bloom bank applied to the HLL bank)."""

    _FALLBACK_FACTORY = "get_hyper_log_log_array"

    def __init__(self, client: "RemoteRedisson", name: str):
        self._client = client
        self.name = name

    def try_init(self, tenants: int) -> bool:
        return bool(self._client.execute("HLLA.RESERVE", self.name, tenants))

    @staticmethod
    def _pair_blobs(a, b) -> Tuple[bytes, bytes]:
        return (
            np.ascontiguousarray(np.asarray(a), dtype="<i4").tobytes(),
            np.ascontiguousarray(np.asarray(b), dtype="<i4").tobytes(),
        )

    def add(self, tenant_ids, keys) -> None:
        t = np.ascontiguousarray(np.asarray(tenant_ids), dtype="<i4").tobytes()
        k = np.ascontiguousarray(np.asarray(keys), dtype="<i8").tobytes()
        self._client.execute("HLLA.MADD64", self.name, t, k)

    def merge_rows(self, dst_ids, src_ids) -> None:
        d, s = self._pair_blobs(dst_ids, src_ids)
        self._client.execute("HLLA.MERGEROWS", self.name, d, s)

    def estimate_all(self) -> np.ndarray:
        out = self._client.execute("HLLA.ESTIMATE", self.name)
        return np.frombuffer(out, "<f8").copy()

    def estimate_union_pairs(self, a_ids, b_ids) -> np.ndarray:
        a, b = self._pair_blobs(a_ids, b_ids)
        out = self._client.execute("HLLA.ESTPAIRS", self.name, a, b)
        return np.frombuffer(out, "<f8").copy()


class RemoteHyperLogLog(_ObjcallFallback):
    _FALLBACK_FACTORY = "get_hyper_log_log"
    def __init__(self, client: "RemoteRedisson", name: str, codec: Optional[Codec]):
        self._client = client
        self.name = name
        self._codec = codec or DEFAULT_CODEC

    def add(self, obj) -> bool:
        data = obj if isinstance(obj, bytes) else self._codec.encode(obj)
        return bool(self._client.execute("PFADD", self.name, data))

    def add_all(self, objs) -> bool:
        if isinstance(objs, np.ndarray) and objs.dtype.kind in "iu":
            blob = np.ascontiguousarray(objs, dtype="<i8").tobytes()
            return bool(self._client.execute("PFADD64", self.name, blob))
        encoded = [o if isinstance(o, bytes) else self._codec.encode(o) for o in objs]
        return bool(self._client.execute("PFADD", self.name, *encoded))

    def count(self) -> int:
        return int(self._client.execute("PFCOUNT", self.name))

    def count_with(self, *names: str) -> int:
        return int(self._client.execute("PFCOUNT", self.name, *names))

    def merge_with(self, *names: str) -> None:
        self._client.execute("PFMERGE", self.name, *names)


class RemoteBitSet(_ObjcallFallback):
    _FALLBACK_FACTORY = "get_bit_set"
    def __init__(self, client: "RemoteRedisson", name: str):
        self._client = client
        self.name = name

    def set(self, index: int, value: bool = True) -> bool:
        return bool(self._client.execute("SETBIT", self.name, index, 1 if value else 0))

    def get(self, index: int) -> bool:
        return bool(self._client.execute("GETBIT", self.name, index))

    def set_each(self, indexes, value: bool = True) -> np.ndarray:
        if not value:
            proxy = RemoteObjectProxy(self._client, "get_bit_set", self.name)
            return proxy.set_each(np.asarray(indexes), False)
        reply = self._client.execute("SETBITS", self.name, *[int(i) for i in indexes])
        return np.asarray(reply, dtype=bool)

    def get_each(self, indexes) -> np.ndarray:
        reply = self._client.execute("GETBITS", self.name, *[int(i) for i in indexes])
        return np.asarray(reply, dtype=bool)

    def cardinality(self) -> int:
        return int(self._client.execute("BITCOUNT", self.name))

    def or_(self, *others: str) -> None:
        self._client.execute("BITOP", "OR", self.name, self.name, *others)

    def and_(self, *others: str) -> None:
        self._client.execute("BITOP", "AND", self.name, self.name, *others)

    def xor(self, *others: str) -> None:
        self._client.execute("BITOP", "XOR", self.name, self.name, *others)


class RemoteBucket(_ObjcallFallback):
    _FALLBACK_FACTORY = "get_bucket"
    def __init__(self, client: "RemoteRedisson", name: str, codec: Optional[Codec]):
        self._client = client
        self.name = name
        self._codec = codec or DEFAULT_CODEC

    def set(self, value: Any, ttl: Optional[float] = None) -> None:
        args = ["SET", self.name, self._codec.encode(value)]
        if ttl is not None:
            args += ["PX", int(ttl * 1000)]
        self._client.execute(*args)

    def get(self) -> Any:
        data = self._client.execute("GET", self.name)
        return None if data is None else self._codec.decode(bytes(data))

    def try_set(self, value: Any, ttl: Optional[float] = None) -> bool:
        args = ["SET", self.name, self._codec.encode(value), "NX"]
        if ttl is not None:
            args += ["PX", int(ttl * 1000)]
        return self._client.execute(*args) is not None

    def delete(self) -> bool:
        return bool(self._client.execute("DEL", self.name))


class RemoteBuckets:
    """RBuckets over the wire (RedissonBuckets.java): every per-name op
    routes by ITS name (cluster-correct — the embedded handle's in-process
    loop becomes per-slot routing for free), and the MSETNX-style try_set
    rides an optimistic transaction so the all-or-nothing contract holds
    atomically even across shards (version preconditions at commit)."""

    def __init__(self, client, codec: Optional[Codec] = None):
        self._client = client
        self._codec = codec

    def get(self, *names: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for nm in names:
            v = self._client.get_bucket(nm, self._codec).get()
            if v is not None:
                out[nm] = v
        return out

    def set(self, values: Dict[str, Any]) -> None:
        for nm, v in values.items():
            self._client.get_bucket(nm, self._codec).set(v)

    def try_set(self, values: Dict[str, Any]) -> bool:
        from redisson_tpu_torch.services.transactions import TransactionException

        for _attempt in range(3):
            tx = self._client.create_transaction()
            if not tx.get_buckets(self._codec).try_set(values):
                tx.rollback()
                return False
            try:
                tx.commit()
                return True
            except TransactionException:
                continue  # a racer created/changed a key: re-probe
        return False


class RemoteTopic:
    def __init__(self, client: "RemoteRedisson", name: str, codec: Optional[Codec]):
        self._client = client
        self.name = name
        self._codec = codec or DEFAULT_CODEC

    def publish(self, message: Any) -> int:
        # same node the subscribers attached to via pubsub_for(name)
        return self._client.publish_for(self.name, self.name, self._codec.encode(message))

    def add_listener(self, listener: Callable[[str, Any], None]) -> Callable[[str, bytes], None]:
        codec = self._codec

        def wire_listener(channel: str, payload: bytes) -> None:
            try:
                value = codec.decode(payload)
            except Exception:  # noqa: BLE001 — non-codec publishers (raw bytes)
                value = payload
            listener(channel, value)

        self._client.pubsub_for(self.name).subscribe(self.name, wire_listener)
        return wire_listener

    def remove_listener(self, token) -> None:
        """RTopic.removeListener(id): detach ONE listener by the token
        add_listener returned (the wire wrapper)."""
        self._client.pubsub_for(self.name).remove_listener(self.name, token)

    def remove_all_listeners(self) -> None:
        self._client.pubsub_for(self.name).unsubscribe(self.name)


class BatchOptions:
    """api/BatchOptions.java parity: execution mode, response timeout,
    retry policy, syncSlaves, skipResult.

    Modes: "IN_MEMORY" (default — ops queue client-side, flush as per-shard
    OBJCALLM frames + coalesced sketch blobs) and "IN_MEMORY_ATOMIC" (the
    MULTI/EXEC analog — the whole group executes under engine.locked_many
    server-side with no interleaving; cluster rule as in the reference:
    every touched object must colocate on one shard, use {hashtags})."""

    IN_MEMORY = "IN_MEMORY"
    IN_MEMORY_ATOMIC = "IN_MEMORY_ATOMIC"

    def __init__(self):
        self.execution_mode = self.IN_MEMORY
        self.response_timeout: Optional[float] = None   # None = client default
        self.retry_attempts: Optional[int] = None       # reads-only retries
        self.retry_interval: float = 0.5
        self.sync_slaves: bool = False                  # WAIT analog: REPLFLUSH
        self.skip_result: bool = False

    @classmethod
    def defaults(cls) -> "BatchOptions":
        return cls()

    def atomic(self) -> "BatchOptions":
        self.execution_mode = self.IN_MEMORY_ATOMIC
        return self


class _BatchObjectProxy:
    """Batch-scoped handle: every method call QUEUES an op and returns its
    result index (resolved by execute())."""

    def __init__(self, batch: "RemoteBatch", factory: str, name: str, codec=None):
        self._batch = batch
        self._factory = factory
        self._name = name
        self._codec = codec

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)

        def call(*args, **kwargs):
            return self._batch._enqueue(
                ("objcall", self._name,
                 (self._factory, self._name, method, args, kwargs, self._codec))
            )

        call.__name__ = method
        return call


class RemoteBatch:
    """RBatch over the wire (CommandBatchService.java:87-151,211-540 at the
    wire layer): the FULL object surface queues through batch-scoped
    proxies and flushes as per-shard OBJCALLM frames (atomic mode:
    OBJCALLMA under the server's locked_many), while same-object bloom
    sketch ops still pre-coalesce into single blob commands — the fastest
    wire form for the north-star workload.

    Results come back in submission order.  Writes keep at-most-once: a
    response timeout raises instead of re-sending (the objcall_many rule)."""

    def __init__(self, client: "RemoteRedisson", options: Optional[BatchOptions] = None):
        self._client = client
        self._options = options or BatchOptions.defaults()
        self._ops: List[Tuple[str, str, Any]] = []  # (kind, name, payload)
        self._executed = False

    # -- batch-scoped handles ------------------------------------------------

    def get_bloom_filter(self, name: str):
        batch = self

        class _B:
            def contains_async(self, keys):
                return batch._enqueue(("bf.contains", name, np.asarray(keys)))

            def add_async(self, keys):
                return batch._enqueue(("bf.add", name, np.asarray(keys)))

        return _B()

    def __getattr__(self, factory: str):
        if factory in _GENERIC_FACTORIES or factory in (
            "get_bucket", "get_bit_set", "get_hyper_log_log", "get_atomic_long",
        ):
            def make(name: str, codec=None, *_a, **_k) -> _BatchObjectProxy:
                return _BatchObjectProxy(self, factory, name, codec)

            return make
        raise AttributeError(factory)

    def _enqueue(self, op: Tuple[str, str, Any]) -> int:
        if self._executed:
            raise RuntimeError("batch already executed")
        self._ops.append(op)
        return len(self._ops) - 1

    # -- execution -------------------------------------------------------------

    def execute(self) -> List[Any]:
        if self._executed:
            raise RuntimeError("batch already executed")
        self._executed = True
        opts = self._options
        timeout = opts.response_timeout
        results: List[Any] = [None] * len(self._ops)

        atomic = opts.execution_mode == BatchOptions.IN_MEMORY_ATOMIC
        # 1) sketch blob fast path: group bf ops per (kind, name).  In
        # ATOMIC mode bf ops must join the locked group instead — the blob
        # commands run outside OBJCALLMA's locked_many, which would let a
        # concurrent writer interleave between the "atomic" batch's sketch
        # and generic ops (the embedded Batch locks bloom groups too)
        blob_groups: Dict[Tuple[str, str], List[int]] = {}
        objcall_idx: List[int] = []
        for i, (kind, name, payload) in enumerate(self._ops):
            if kind in ("bf.contains", "bf.add") and not atomic:
                blob_groups.setdefault((kind, name), []).append(i)
            elif kind in ("bf.contains", "bf.add"):
                method = "contains_each" if kind == "bf.contains" else "add_each"
                self._ops[i] = (
                    "objcall", name,
                    ("get_bloom_filter", name, method, (np.asarray(payload),), {}, None),
                )
                objcall_idx.append(i)
            else:
                objcall_idx.append(i)
        commands: List[Tuple] = []
        layout: List[Tuple[List[int], List[int]]] = []
        for (kind, name), idxs in blob_groups.items():
            keys = np.concatenate([np.asarray(self._ops[i][2]).reshape(-1) for i in idxs])
            blob = np.ascontiguousarray(keys, dtype="<i8").tobytes()
            cmd = "BF.MEXISTS64" if kind == "bf.contains" else "BF.MADD64"
            commands.append((cmd, name, blob))
            layout.append((idxs, [np.asarray(self._ops[i][2]).size for i in idxs]))

        attempts = (opts.retry_attempts if opts.retry_attempts is not None else 0) + 1
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            try:
                if commands:
                    replies = self._client.execute_many(commands, timeout=timeout)
                else:
                    replies = []
                break
            except TimeoutError:
                # the frame was WRITTEN and may have executed: re-sending
                # would double-apply the adds (at-most-once; TimeoutError is
                # an OSError subclass, so this clause must come first)
                raise
            except (ConnectionError, OSError) as e:
                last = e  # pre-write failure: safe to retry
                time.sleep(min(self._options.retry_interval * (attempt + 1), 2.0))
        else:
            assert last is not None
            raise last
        for (idxs, sizes), reply in zip(layout, replies):
            if isinstance(reply, RespError):
                raise reply
            flags = np.frombuffer(reply, np.uint8).astype(bool)
            off = 0
            for i, sz in zip(idxs, sizes):
                results[i] = flags[off : off + sz]
                off += sz

        # 2) generic surface: per-shard OBJCALLM / atomic OBJCALLMA
        if objcall_idx:
            ops = [self._ops[i][2] for i in objcall_idx]
            replies = self._client.objcall_many_batch(ops, atomic=atomic, timeout=timeout)
            for i, r in zip(objcall_idx, replies):
                if isinstance(r, BaseException):
                    raise r
                results[i] = r

        # 3) syncSlaves (WAIT analog): force the replication stream flush on
        # every touched shard before returning
        if opts.sync_slaves:
            names = {name for _k, name, _p in self._ops if name}
            self._client.sync_replication(names, timeout=timeout)

        if opts.skip_result:
            return []
        return results


class RemoteKeys:
    """RKeys over the wire — the full embedded Keys surface on typed verbs
    (RedissonKeys.java roles)."""

    def __init__(self, client: "RemoteRedisson"):
        self._client = client

    def get_keys(self, pattern: str = "*") -> List[str]:
        return [k.decode() for k in self._client.execute("KEYS", pattern)]

    def delete(self, *names: str) -> int:
        return int(self._client.execute("DEL", *names))

    def unlink(self, *names: str) -> int:
        return int(self._client.execute("UNLINK", *names))

    def delete_by_pattern(self, pattern: str) -> int:
        names = self.get_keys(pattern)
        return self.delete(*names) if names else 0

    def count(self) -> int:
        return int(self._client.execute("DBSIZE"))

    def count_exists(self, *names: str) -> int:
        """ONE variadic EXISTS per shard owner (Redis + cmd_exists both sum
        args) instead of a round trip per name; tx_groups collapses to a
        single frame on the single-node client."""
        if not names:
            return 0
        return sum(
            int(self._client.execute("EXISTS", *group))
            for group in self._client.tx_groups(list(names)).values()
        )

    def random_key(self) -> Optional[str]:
        k = self._client.execute("RANDOMKEY")
        return None if k is None else bytes(k).decode()

    def expire(self, name: str, seconds: float) -> bool:
        return bool(self._client.execute("PEXPIRE", name, int(seconds * 1000)))

    def remain_time_to_live(self, name: str) -> Optional[float]:
        ms = int(self._client.execute("PTTL", name))
        return None if ms < 0 else ms / 1000.0

    def flushdb(self) -> None:
        self._client.execute("FLUSHALL")

    def flushall(self) -> None:
        self._client.execute("FLUSHALL")


class RemoteLock(RemoteObjectProxy):
    """Lock proxy with the watchdog in the CLIENT process: a dead client
    stops renewing and the server-side lease expires (the reference runs
    scheduleExpirationRenewal in the client JVM for the same reason,
    RedissonBaseLock.java:127-189).

    Contended acquisition PARKS on the lock's unlock channel and retries on
    the push (RedissonLock.java:120-144 + pubsub/LockPubSub.java — the
    reference parks in the client JVM on a pubsub latch); a bounded poll
    remains as the safety net for a publish lost between the failed try and
    the subscribe (and for lease-expiry takeovers, which publish nothing).
    A blocking server-side lock() would pin a server worker thread for the
    whole wait and collide with the command response timeout."""

    _WATCHDOG_LEASE = 30.0
    _SAFETY_POLL = 0.25  # park cap: lost-publish / lease-expiry safety net

    def __init__(self, client: "RemoteRedisson", factory: str, name: str):
        super().__init__(client, factory, name)
        object.__setattr__(self, "_renew_timer", None)
        object.__setattr__(self, "_held_as", None)  # identity captured at acquire

    def _try_once(self, lease_time) -> bool:
        return self._client.objcall(
            self._factory, self._name, "try_lock", (0.0, lease_time), {}
        )

    class _UnlockPark:
        """Subscription to the unlock channel for ONE contended wait: the
        push sets the event; park() waits push-or-timeout."""

        def __init__(self, client, name: str):
            from redisson_tpu_torch.client.objects.lock import unlock_channel

            self._event = _threading.Event()
            self._channel = unlock_channel(name)
            self._pubsub = None
            self._listener = lambda _ch, _msg: self._event.set()
            try:
                self._pubsub = client.pubsub_for(name)
                self._pubsub.subscribe(self._channel, self._listener)
            except Exception:  # noqa: BLE001 — no pubsub? pure polling still works
                self._pubsub = None

        def park(self, timeout: float) -> None:
            self._event.wait(timeout)
            self._event.clear()

        def close(self) -> None:
            if self._pubsub is not None:
                try:
                    self._pubsub.remove_listener(self._channel, self._listener)
                except Exception:  # noqa: BLE001
                    pass

    def lock(self, lease_time=None) -> None:
        if self._try_once(lease_time):
            if lease_time is None:
                self._start_client_watchdog()
            return
        park = self._UnlockPark(self._client, self._name)
        try:
            while not self._try_once(lease_time):
                park.park(self._SAFETY_POLL)
            if lease_time is None:
                self._start_client_watchdog()
        finally:
            park.close()

    def try_lock(self, wait_time: float = 0.0, lease_time=None) -> bool:
        import time as _time

        if self._try_once(lease_time):
            if lease_time is None:
                self._start_client_watchdog()
            return True
        if wait_time <= 0:
            return False
        deadline = _time.monotonic() + wait_time
        park = self._UnlockPark(self._client, self._name)
        try:
            while True:
                if self._try_once(lease_time):
                    if lease_time is None:
                        self._start_client_watchdog()
                    return True
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                park.park(min(self._SAFETY_POLL, remaining))
        finally:
            park.close()

    def unlock(self) -> None:
        self._stop_client_watchdog()
        self._client.objcall(self._factory, self._name, "unlock", (), {})
        # reentrant holds: if this caller still owns the lock after the
        # unlock, renewal must continue (the reference keeps a per-lock
        # renewal entry count, RedissonBaseLock.unscheduleExpirationRenewal)
        if self._client.objcall(
            self._factory, self._name, "renew_lease", (self._WATCHDOG_LEASE,), {}
        ):
            self._start_client_watchdog()

    def force_unlock(self) -> bool:
        self._stop_client_watchdog()
        return self._client.objcall(self._factory, self._name, "force_unlock", (), {})

    def _start_client_watchdog(self) -> None:
        self._stop_client_watchdog()
        # renewal fires on pool threads, whose get_ident() differs from the
        # acquiring thread — capture the acquirer's identity NOW and renew
        # under it, or the server would refuse every tick
        held_as = self._client.caller_id()
        object.__setattr__(self, "_held_as", held_as)
        timer, pool = self._client.renewal_infra()

        def renew():
            try:
                still_held = self._client.objcall(
                    self._factory, self._name, "renew_lease",
                    (self._WATCHDOG_LEASE,), {}, caller=held_as,
                )
            except Exception:  # noqa: BLE001 — connection loss ends renewal
                still_held = False
            if still_held and self.__dict__.get("_held_as") == held_as:
                t = timer.new_timeout(
                    lambda: pool.submit(renew), self._WATCHDOG_LEASE / 3
                )
                object.__setattr__(self, "_renew_timer", t)

        # the wheel tick only ENQUEUES the renewal; the RPC runs on the pool
        # (a network call must never block the shared wheel thread)
        t = timer.new_timeout(lambda: pool.submit(renew), self._WATCHDOG_LEASE / 3)
        object.__setattr__(self, "_renew_timer", t)

    def _stop_client_watchdog(self) -> None:
        t = self.__dict__.get("_renew_timer")
        object.__setattr__(self, "_held_as", None)
        if t is not None:
            t.cancel()
            object.__setattr__(self, "_renew_timer", None)


# factories served via OBJCALL generic proxies (full L5'/L6' surface)
_GENERIC_FACTORIES = {
    "get_map", "get_map_cache", "get_set", "get_set_cache", "get_sorted_set",
    "get_lex_sorted_set", "get_scored_sorted_set", "get_list", "get_queue",
    "get_deque", "get_blocking_queue", "get_blocking_deque", "get_priority_queue",
    "get_priority_deque", "get_priority_blocking_queue", "get_priority_blocking_deque",
    "get_ring_buffer", "get_transfer_queue", "get_list_multimap", "get_set_multimap",
    "get_list_multimap_cache", "get_set_multimap_cache",
    "get_atomic_long", "get_atomic_double", "get_id_generator", "get_lock",
    "get_fair_lock", "get_spin_lock", "get_fenced_lock", "get_semaphore",
    "get_count_down_latch", "get_rate_limiter", "get_permit_expirable_semaphore",
    "get_stream", "get_time_series",
    "get_geo", "get_binary_stream", "get_json_bucket", "get_buckets",
    "get_bounded_blocking_queue", "get_sharded_bloom_filter_array",
    "get_sharded_hll_array", "get_sharded_bit_set",
}


class RemoteLocalCachedMap:
    """RLocalCachedMap over the wire: a client-side near cache fed by the
    shared invalidation channel (`redisson_local_cache:{name}`).

    Protocol interop with the embedded handle (client/objects/localcache.py):
    messages are (kind, cache_id, payload) tuples; this handle MUTATES the
    plain map and PUBLISHES its own messages carrying its own cache_id — so
    originator exclusion works exactly like the reference's excludedId scheme
    (a client's own writes never evict its own fresh cache entries).  Both
    the subscription and the mutations route by the MAP NAME's slot, so on a
    cluster the invalidation feed lives on the shard that owns the data.
    The map-key codec MUST match the server's default codec (keys align by
    encoded bytes).
    """

    def __init__(self, client, name: str, options=None, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.localcache import (
            LocalCachedMapOptions,
            SyncStrategy,
            _LocalCache,
        )

        self._client = client
        self.name = name
        self._opts = options or LocalCachedMapOptions.defaults()
        self._codec = codec or DEFAULT_CODEC
        self._cache = _LocalCache(self._opts)
        self._cache_id = uuid.uuid4().hex
        self._disabled: set = set()  # active tx-commit disable requests
        self._channel = f"redisson_local_cache:{name}"
        # mutations ride the PLAIN map: this handle owns its own broadcasts
        self._proxy = RemoteObjectProxy(client, "get_map", name)
        self._sync_strategy = self._opts.sync_strategy
        # TRACKING mode: coherence rides the server-assisted
        # invalidation plane — no topic subscription, no write broadcasts.
        # Every OBJCALL read registers the map name on its (tracked) data
        # connection server-side; any write by anyone pushes an invalidate
        # down the facade's feed, which clears this handle's cache.
        self._tracking_mode = self._sync_strategy == SyncStrategy.TRACKING
        self._sync = (
            self._sync_strategy != SyncStrategy.NONE and not self._tracking_mode
        )
        # generation counter: a fetch only populates the cache if no
        # invalidation arrived while it was in flight (the wire analog of the
        # embedded handle's read+populate under the record lock)
        self._gen = 0
        self.hits = 0
        self.misses = 0
        self._pubsub = None
        self._tracking_listener = None
        if self._tracking_mode:
            plane = getattr(client, "tracking", None)
            if plane is None:
                raise RuntimeError(
                    "SyncStrategy.TRACKING requires the facade's tracking "
                    "plane: call client.enable_tracking() first"
                )
            self._tracking_plane = plane
            self._tracking_listener = plane.add_name_listener(
                name, self._on_tracking_invalidate
            )
        elif self._sync:
            # subscribe on the shard that owns the MAP (not the channel
            # string): that is where OBJCALL mutations execute and publish
            self._pubsub = client.pubsub_for(name)
            self._pubsub.subscribe(self._channel, self._on_wire_sync)

    def _on_tracking_invalidate(self, _name) -> None:
        # record-level granularity: any write to the map drops the whole
        # near copy (the plane cannot see which entry changed); _gen guards
        # in-flight fetches exactly like the topic path
        self._gen += 1
        self._cache.clear()

    # -- invalidation feed ----------------------------------------------------

    def _on_wire_sync(self, _channel: str, payload) -> None:
        try:
            msg = safe_loads(bytes(payload)) if isinstance(payload, (bytes, bytearray)) else payload
        except Exception:  # noqa: BLE001 — unknown frame: drop all, stay safe
            self._gen += 1
            self._cache.clear()
            return
        kind, sender = msg[0], msg[1]
        if sender == self._cache_id:
            return  # own write (excludedId scheme)
        self._gen += 1
        if kind == "inv":
            for ek in msg[2]:
                self._cache.invalidate(ek)
        elif kind == "upd":
            for ek, ev in msg[2]:
                self._cache.put(ek, self._codec.decode_map_value(ev))
        elif kind == "clear":
            self._cache.clear()
        elif kind == "disable":
            # transaction commit handshake (LocalCachedMapDisable analog)
            self._disabled.add(sender)
            self._cache.clear()
            # failsafe: the committer died before the enable (on the
            # facade's wheel timer, stopped by its shutdown)
            timer, _pool = self._client.renewal_infra()
            timer.new_timeout(lambda: self._disabled.discard(sender), 30.0)
        elif kind == "enable":
            self._disabled.discard(sender)
            self._cache.clear()

    def _broadcast(self, kind: str, payload) -> None:
        if not self._sync:
            return
        from redisson_tpu_torch.client.objects.localcache import SyncStrategy

        if kind == "upd" and self._sync_strategy != SyncStrategy.UPDATE:
            kind, payload = "inv", [ek for ek, _ in payload]
        blob = safe_pickle.dumps((kind, self._cache_id, payload), protocol=4)
        # route by the MAP name, not the channel string: subscribers attached
        # on the map's slot owner (see __init__), and the channel's own slot
        # differs from the map's
        self._client.publish_for(self.name, self._channel, blob)

    def _ek(self, key) -> bytes:
        return self._codec.encode_map_key(key)

    # -- reads (near cache first) ---------------------------------------------

    def get(self, key):
        if self._disabled:
            # tx-commit window: read through, never serve or populate
            return self._proxy.get(key)
        ek = self._ek(key)
        hit, value = self._cache.get(ek)
        if hit:
            self.hits += 1
            return value
        self.misses += 1
        gen = self._gen
        value = self._proxy.get(key)
        if value is not None and self._gen == gen and not self._disabled:
            # no invalidation raced the fetch: safe to populate
            self._cache.put(ek, value)
        return value

    def get_all(self, keys) -> Dict:
        if self._disabled:
            return self._proxy.get_all(list(keys))
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
            gen = self._gen
            fetched = self._proxy.get_all(missing)
            if self._gen == gen and not self._disabled:
                for k, v in fetched.items():
                    self._cache.put(self._ek(k), v)
            out.update(fetched)
        return out

    # -- transaction commit handshake ----------------------------------------

    def tx_disable(self, req_id: str) -> None:
        """Near-cache disable broadcast for a transaction commit
        (LocalCachedMapDisable analog); sender = the REQUEST id so no
        subscriber — including this handle — is excluded."""
        self._disabled.add(req_id)
        self._cache.clear()
        if self._sync:
            blob = safe_pickle.dumps(("disable", req_id, None), protocol=4)
            self._client.publish_for(self.name, self._channel, blob)

    def tx_enable(self, req_id: str) -> None:
        self._disabled.discard(req_id)
        self._cache.clear()
        if self._sync:
            blob = safe_pickle.dumps(("enable", req_id, None), protocol=4)
            self._client.publish_for(self.name, self._channel, blob)

    def cached_size(self) -> int:
        return len(self._cache)

    # -- writes (mutate shared map, update own cache, notify peers) -----------

    def _seed_own_write(self) -> bool:
        """May a write populate its own cache?  TRACKING mode: NO — without
        NOLOOP the server pops (or, for a write with no prior read, never
        held) our registration when it applies the write, so nothing
        guarantees a later foreign write ever invalidates the seed; WITH
        NOLOOP the self-pushes that would order concurrent own-writes are
        suppressed, and the map-wide ``_gen`` guard cannot tell two own
        writers apart — the loser of the server-side race could cache its
        overwritten value with nothing left to correct it (the
        tracked-handle seed in TrackedBucket.set survives this because the
        NearCache generation is per NAME and invalidate drops entries).
        Topic mode seeds like the reference (excludedId scheme)."""
        return not self._tracking_mode

    def _own_invalidate(self, eks) -> None:
        """Drop our local copies after an own write, bumping ``_gen`` FIRST:
        a concurrent get() that fetched the PRE-write value must fail its
        populate guard, or it would re-cache the stale value right after
        this invalidate — and under tracking+NOLOOP the suppressed
        self-push would never correct it."""
        self._gen += 1
        for ek in eks:
            self._cache.invalidate(ek)

    def _invalidate_on_error(self, eks) -> None:
        """A raised wire write may still have APPLIED (lost reply) — drop
        the local copies: under tracking+NOLOOP the self-push is suppressed
        and in topic mode the broadcast never went out, so nothing else
        would ever correct a stale cached value."""
        self._own_invalidate(eks)

    def put(self, key, value):
        # gen-guarded like get(): an invalidation landing between the wire
        # write and the populate (our own push, or a foreign writer's)
        # voids the populate instead of caching over it
        gen = self._gen
        seed = self._seed_own_write()
        try:
            old = self._proxy.put(key, value)
        except BaseException:
            self._invalidate_on_error([self._ek(key)])
            raise
        ek = self._ek(key)
        if not seed:
            self._own_invalidate([ek])
        elif self._gen == gen and not self._disabled:
            self._cache.put(ek, value)
        self._broadcast("upd", [(ek, self._codec.encode_map_value(value))])
        return old

    def fast_put(self, key, value) -> bool:
        gen = self._gen
        seed = self._seed_own_write()
        try:
            created = self._proxy.fast_put(key, value)
        except BaseException:
            self._invalidate_on_error([self._ek(key)])
            raise
        ek = self._ek(key)
        if not seed:
            self._own_invalidate([ek])
        elif self._gen == gen and not self._disabled:
            self._cache.put(ek, value)
        self._broadcast("upd", [(ek, self._codec.encode_map_value(value))])
        return created

    def put_all(self, entries: Dict) -> None:
        gen = self._gen
        seed = self._seed_own_write()
        try:
            self._proxy.put_all(entries)
        except BaseException:
            self._invalidate_on_error([self._ek(k) for k in entries])
            raise
        payload = []
        populate = seed and self._gen == gen and not self._disabled
        if not seed:
            self._own_invalidate([self._ek(k) for k in entries])
        for k, v in entries.items():
            ek = self._ek(k)
            if populate:
                self._cache.put(ek, v)
            payload.append((ek, self._codec.encode_map_value(v)))
        self._broadcast("upd", payload)

    def remove(self, key):
        ek = self._ek(key)
        try:
            old = self._proxy.remove(key)
        finally:
            self._own_invalidate([ek])
        self._broadcast("inv", [ek])
        return old

    def fast_remove(self, *keys) -> int:
        eks = [self._ek(k) for k in keys]
        try:
            n = self._proxy.fast_remove(*keys)
        finally:
            self._own_invalidate(eks)
        self._broadcast("inv", eks)
        return n

    def clear(self) -> None:
        try:
            self._proxy.clear()
        finally:
            self._gen += 1  # void in-flight populates (see _own_invalidate)
            self._cache.clear()
        if self._sync:
            blob = safe_pickle.dumps(("clear", self._cache_id), protocol=4)
            self._client.publish_for(self.name, self._channel, blob)

    def destroy(self) -> None:
        """Detach the invalidation listener (RObject.destroy parity) — keep
        the shared channel alive for other handles on the same connection."""
        if self._pubsub is not None:
            self._pubsub.remove_listener(self._channel, self._on_wire_sync)
            self._pubsub = None
        if self._tracking_listener is not None:
            self._tracking_plane.remove_name_listener(
                self.name, self._tracking_listener
            )
            self._tracking_listener = None
        self._cache.clear()

    def __getattr__(self, method: str):
        # everything else (size, contains_key, read_all_keys, ...) rides the
        # plain OBJCALL proxy with no near-cache involvement
        return getattr(self._proxy, method)


class RemoteSurface:
    """Handle-factory surface shared by the single-node client and the
    cluster client: every factory only talks through the transport seam
    (execute / execute_many / objcall / pubsub_for / caller_id), so the same
    handle classes ride either routing."""

    # the CLIENT TRACKING near-cache plane (tracking/nearcache.py), None
    # until enable_tracking() arms it
    tracking = None

    def enable_tracking(self, **kw) -> "Any":
        """Arm server-assisted client tracking for this facade: every pooled
        data connection redirects its invalidation stream to the node's
        dedicated feed connection, and the returned ``ClientTracking``
        plane's handles (``get_bucket``/``get_map``/``get_set``/
        ``get_bloom_filter``) answer repeat reads from a process-local
        near cache until someone writes.  Idempotent (kwargs of the first
        call win) — including under concurrent first calls: construction
        arms feeds and registers invalidation listeners, so a racing loser
        plane would leak its listeners for the process lifetime."""
        plane = self.__dict__.get("tracking")
        if plane is None:
            with _tracking_enable_lock:
                plane = self.__dict__.get("tracking")
                if plane is None:
                    from redisson_tpu_torch.tracking.nearcache import ClientTracking

                    plane = self.__dict__["tracking"] = ClientTracking(self, **kw)
        return plane

    def renewal_infra(self):
        """The lock watchdog's wheel timer and renewal pool: ONE timer
        schedules ticks, a small pool runs the renewal RPCs (network calls
        must not block the wheel thread) — never a thread per lock.  Made
        at the first watchdog, stopped by ``shutdown()``."""
        with self.__dict__.setdefault("_renewal_guard", _threading.Lock()):
            infra = self.__dict__.get("_renewal")
            if infra is None:
                from concurrent.futures import ThreadPoolExecutor

                from redisson_tpu_torch.utils.timer import HashedWheelTimer

                infra = self.__dict__["_renewal"] = (
                    HashedWheelTimer(),
                    ThreadPoolExecutor(max_workers=4, thread_name_prefix="rtpu-renew"),
                )
            return infra

    def _stop_renewals(self) -> None:
        infra = self.__dict__.pop("_renewal", None)
        if infra is not None:
            timer, pool = infra
            timer.stop()
            pool.shutdown(wait=True)

    def caller_id(self) -> str:
        """This thread's synchronizer identity (uuid:threadId — the
        reference's LockName, RedissonBaseLock.getLockName)."""
        import uuid as _uuid

        if not hasattr(self, "_client_uuid"):
            object.__setattr__(self, "_client_uuid", _uuid.uuid4().hex)
        return f"{self._client_uuid}:{_threading.get_ident()}"

    def objcall(
        self,
        factory: str,
        name: str,
        method: str,
        args: tuple,
        kwargs: dict,
        caller: Optional[str] = None,
        codec: Optional[Codec] = None,
    ) -> Any:
        payload = safe_pickle.dumps((args, kwargs))
        frame = [
            "OBJCALL", factory, name, method, payload, caller or self.caller_id(),
        ]
        if codec is not None:
            frame.append(safe_pickle.dumps(codec))
        reply = self.execute(*frame)
        return _unwrap(reply, self)

    def objcall_many(
        self, ops: List[Tuple], caller: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> List[Any]:
        """MANY object ops in ONE wire frame + ONE pickle (OBJCALLM — the
        CommandBatchService flush for the generic object surface).  ops =
        [(factory, name, method, args, kwargs[, codec_blob]), ...]; returns
        results aligned with ops, exceptions as values.  The cluster client
        overrides this with per-shard grouping."""
        payload = safe_pickle.dumps([tuple(op) for op in ops])
        reply = self.execute(
            "OBJCALLM", payload, caller or self.caller_id(), timeout=timeout
        )
        return _unwrap_many(reply, self)

    def objcall_many_batch(
        self, ops: List[Tuple], atomic: bool = False, timeout: Optional[float] = None
    ) -> List[Any]:
        """RemoteBatch's generic flush: OBJCALLM, or OBJCALLMA for atomic
        groups (server runs the whole frame under engine.locked_many — the
        MULTI/EXEC analog).  Single-node surface: one frame either way.
        Ops may carry a trailing Codec object; it ships pickled per the
        OBJCALL codec-frame contract."""
        wire_ops = [self._normalize_batch_op(op) for op in ops]
        cmd = "OBJCALLMA" if atomic else "OBJCALLM"
        payload = safe_pickle.dumps(wire_ops)
        reply = self.execute(cmd, payload, self.caller_id(), timeout=timeout)
        return _unwrap_many(reply, self)

    @staticmethod
    def _normalize_batch_op(op: Tuple) -> Tuple:
        op = tuple(op)
        if len(op) > 5:
            codec = op[5]
            if codec is None:
                return op[:5]
            return op[:5] + (safe_pickle.dumps(codec),)
        return op

    def sync_replication(self, names, timeout: Optional[float] = None) -> None:
        """BatchOptions.syncSlaves analog (the WAIT command role): force the
        replication stream to flush before returning, so a replica read
        after the batch sees its writes.  Single-node surface: one
        REPLFLUSH; the cluster client overrides per touched shard."""
        self.execute("REPLFLUSH", timeout=timeout)

    def replication_state(self, timeout: Optional[float] = None) -> dict:
        """Parsed REPLSTATE: {role, applied_offset, staleness_ms,
        view_epoch}.  staleness_ms is time since the node's last applied
        replication push/heartbeat (-1 = never synced); a master answers 0.
        The bounded-staleness read plane's observability probe — soak and
        bench harvest replica lag through this."""
        role, offset, stale_ms, epoch = self.execute(
            "REPLSTATE", timeout=timeout
        )
        return {
            "role": role.decode() if isinstance(role, (bytes, bytearray))
            else str(role),
            "applied_offset": int(offset),
            "staleness_ms": int(stale_ms),
            "view_epoch": int(epoch),
        }

    # -- transactions (transaction/RedissonTransaction.java over the wire) ----

    def create_transaction(self, timeout: Optional[float] = None, options=None):
        from redisson_tpu_torch.services.transactions import (
            RemoteTransaction,
            TransactionOptions,
        )

        if options is None:
            options = TransactionOptions.defaults()
        if timeout is not None:
            options.timeout = timeout
        return RemoteTransaction(self, options)

    def tx_groups(self, names: List[str]) -> Dict[Any, List[str]]:
        """Commit grouping seam: which TXEXEC frame carries which names.
        Single node = one frame; the cluster client groups per slot owner."""
        return {None: list(names)}

    def txexec(
        self, group_key, versions: Dict[str, int], ops: List[Tuple],
        timeout: Optional[float] = None,
    ) -> List[Any]:
        """One atomic commit frame: version preconditions + buffered ops
        under the server's locked_many (see registry cmd_txexec)."""
        reply = self.execute(
            "TXEXEC", safe_pickle.dumps(versions), safe_pickle.dumps(ops),
            self.caller_id(), timeout=timeout,
        )
        return _unwrap_many(reply, self)

    # -- hot-path handles ----------------------------------------------------

    def get_bloom_filter(self, name: str, codec: Optional[Codec] = None) -> "RemoteBloomFilter":
        return RemoteBloomFilter(self, self._map_name(name), codec)

    def get_bloom_filter_array(self, name: str) -> "RemoteBloomFilterArray":
        return RemoteBloomFilterArray(self, self._map_name(name))

    def get_hyper_log_log(self, name: str, codec: Optional[Codec] = None) -> "RemoteHyperLogLog":
        return RemoteHyperLogLog(self, self._map_name(name), codec)

    def get_hyper_log_log_array(self, name: str) -> "RemoteHyperLogLogArray":
        return RemoteHyperLogLogArray(self, self._map_name(name))

    def get_bit_set(self, name: str) -> "RemoteBitSet":
        return RemoteBitSet(self, self._map_name(name))

    def get_bucket(self, name: str, codec: Optional[Codec] = None) -> "RemoteBucket":
        return RemoteBucket(self, self._map_name(name), codec)

    def get_buckets(self, codec: Optional[Codec] = None) -> "RemoteBuckets":
        return RemoteBuckets(self, codec)

    def get_topic(self, name: str, codec: Optional[Codec] = None) -> "RemoteTopic":
        return RemoteTopic(self, self._map_name(name), codec)

    def get_local_cached_map(
        self, name: str, codec: Optional[Codec] = None, options=None
    ) -> "RemoteLocalCachedMap":
        return RemoteLocalCachedMap(self, self._map_name(name), options=options, codec=codec)

    def create_batch(self, options: Optional["BatchOptions"] = None) -> "RemoteBatch":
        return RemoteBatch(self, options)

    def add_connection_listener(self, listener):
        """Register for edge-triggered per-node connect/disconnect events
        (ConnectionEventsHub.java); both facades own an events hub."""
        return self.events_hub.add_listener(listener)

    def remove_connection_listener(self, listener) -> None:
        self.events_hub.remove_listener(listener)

    def get_elements_subscribe_service(self):
        """Resilient blocking-consumer subscriptions (ElementsSubscribeService
        analog): take-loops that re-subscribe across failovers.  setdefault
        keeps the init race-safe: two racing callers must share ONE service
        or the loser's subscription registry becomes unreachable."""
        from redisson_tpu_torch.services.elements import ElementsSubscribeService

        return self.__dict__.setdefault(
            "_elements_service", ElementsSubscribeService(self)
        )

    def get_keys(self) -> "RemoteKeys":
        return RemoteKeys(self)

    def get_live_object_service(self):
        """RLiveObjectService over the wire: the service drives this client's
        own object factories, so every live-object key (map, index sets,
        score sets — all {Cls:...}-hashtagged) routes per key exactly like
        the reference's live objects against a cluster."""
        from redisson_tpu_torch.services.liveobject import LiveObjectService

        return LiveObjectService(self)

    # -- generic surface -----------------------------------------------------

    _LOCK_FACTORIES = {"get_lock", "get_fair_lock", "get_spin_lock", "get_fenced_lock"}

    def _map_name(self, name: str) -> str:
        """NameMapper on the NETWORKED surface: remote handles carry the
        STORED key so OBJCALL payloads, blob fast paths, and pubsub channel
        names (lock unlock channels, invalidation topics) all agree with
        what the server persists."""
        mapper = getattr(getattr(self, "config", None), "name_mapper", None)
        return mapper.map(name) if mapper is not None else name

    def __getattr__(self, factory: str):
        if factory in self._LOCK_FACTORIES:

            def make_lock(name: str, *_a, **_k) -> RemoteLock:
                return RemoteLock(self, factory, self._map_name(name))

            return make_lock
        if factory in _GENERIC_FACTORIES:

            def make(name: str, codec: Optional[Codec] = None, *_a, **_k) -> RemoteObjectProxy:
                return RemoteObjectProxy(self, factory, self._map_name(name), codec)

            return make
        raise AttributeError(factory)


class RemoteRedisson(RemoteSurface):
    """Client-mode facade (the RedissonClient role for a remote data plane)."""

    def __init__(self, address: str, config=None, **node_kw):
        from redisson_tpu_torch.config import Config

        self.config = config or Config()
        ssc = self.config.single_server_config
        kw: Dict[str, Any] = {}
        if ssc is not None:
            kw.update(
                password=ssc.password,
                username=ssc.username,
                client_name=ssc.client_name,
                pool_size=ssc.connection_pool_size,
                min_idle=ssc.connection_minimum_idle_size,
                timeout=ssc.timeout,
                connect_timeout=ssc.connect_timeout,
                retry_attempts=ssc.retry_attempts,
                retry_interval=ssc.retry_interval,
                ping_interval=ssc.ping_connection_interval,
                ssl_context=ssc.build_ssl_context(),
            )
        kw.update(node_kw)
        # config-level SPIs ride every connection of this facade
        kw.setdefault("credentials_resolver", self.config.credentials_resolver)
        kw.setdefault("command_mapper", self.config.command_mapper)
        # ConnectionEventsHub (connection/ConnectionEventsHub.java):
        # edge-triggered connect/disconnect fan-out for this facade
        from redisson_tpu_torch.net.detectors import ConnectionEventsHub

        self.events_hub = kw.setdefault("events_hub", ConnectionEventsHub())
        self.node = NodeClient(address, **kw)

    @classmethod
    def create(cls, config) -> "RemoteRedisson":
        ssc = config.use_single_server()
        return cls(ssc.address, config=config)

    # -- transport seam (handles call these; ClusterRedisson overrides with
    #    slot routing — the CommandAsyncExecutor boundary of the wire client)

    def execute(self, *args, timeout: Optional[float] = None) -> Any:
        return self.node.execute(*args, timeout=timeout)

    def execute_many(self, commands, timeout: Optional[float] = None):
        return self.node.execute_many(commands, timeout=timeout)

    def pubsub_for(self, name: str):
        """Pubsub connection serving `name`'s channel (single node: the one)."""
        return self.node.pubsub()

    def publish_for(self, routing_name: str, channel, payload) -> int:
        """Publish on the node that serves `routing_name`'s subscriptions.

        Must pair with pubsub_for: server pubsub hubs are node-local, so a
        publish landing on any other node is silently lost.  Single node:
        trivially the one node; the cluster override routes by slot."""
        return int(self.execute("PUBLISH", channel, payload) or 0)

    # -- admin ---------------------------------------------------------------

    def ping(self) -> bool:
        return self.node.execute("PING") in (b"PONG", "PONG")

    def info(self) -> str:
        return bytes(self.node.execute("INFO")).decode()

    def shutdown(self) -> None:
        # cancel element subscriptions FIRST: their daemon loops would
        # otherwise retry the closed transport forever
        svc = getattr(self, "_elements_service", None)
        if svc is not None:
            svc.shutdown()
        plane = self.__dict__.get("tracking")
        if plane is not None:
            plane.close()
        self._stop_renewals()
        self.node.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
