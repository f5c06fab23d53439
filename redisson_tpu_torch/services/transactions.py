"""Transactions: optimistic, buffered, all-or-nothing commit — on EVERY facade.

Parity target (SURVEY.md §2.6): ``org/redisson/transaction/RedissonTransaction
.java:49-79`` + the operation package (55 files): operations are buffered
client-side as command descriptors; at commit, per-touched-object locks are
taken, observed versions re-checked (optimistic concurrency), and the buffer
is applied as one atomic group; rollback simply discards the buffer.

Re-design relative to the reference: where the reference acquires per-entry
Redis locks eagerly as operations are buffered and commits via an
IN_MEMORY_ATOMIC batch, this implementation is fully optimistic — reads
record the touched record's VERSION, and commit is a single server-side
frame (``TXEXEC``) that re-verifies every observed version and applies the
buffered ops under ``engine.locked_many``.  That turns conditional ops
(trySet, compareAndSet, putIfAbsent, MSETNX-style buckets) into plain
buffered writes guarded by version preconditions — no lock round trips
while the transaction runs, and ONE wire frame to commit (the TPU-first
shape: the tunnel round trip dominates, so the commit must be one frame).

Facades:
  * ``EmbeddedTransaction`` — in-process engine (client/redisson.py).
  * ``RemoteTransaction`` — single-node AND cluster wire clients: reads ride
    ``OBJCALLV`` (result + observed version), commit rides ``TXEXEC`` frames
    grouped per shard owner.  Cross-shard commits run a check-only phase on
    every owner first, so a conflict existing at commit time aborts with
    nothing applied anywhere; a write racing into the window between one
    shard's check and its apply can still land a partial commit — the same
    per-shard-atomic guarantee level as the reference's cluster batch
    (CommandBatchService per-entry MULTI/EXEC) — and is reported loudly as
    PARTIALLY COMMITTED (see RemoteTransaction._commit_frames).

Transaction-scoped object views give read-your-writes inside the transaction
(the reference's transactional RBucket/RBuckets/RMap/RMapCache/RSet/RSetCache/
RLocalCachedMap wrappers, RedissonTransaction.java:84-196).

A copy of ``redisson_tpu/services/transactions.py``.  Wire frames are
pickled by ``net/safe_pickle.dumps``, under the reference's class names.
"""
from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

from redisson_tpu_torch.net import safe_pickle


class TransactionException(Exception):
    pass


class TransactionOptions:
    """api/TransactionOptions.java:1-166 analog (seconds instead of ms)."""

    __slots__ = (
        "timeout", "response_timeout", "retry_attempts", "retry_interval",
        "sync_slaves", "sync_timeout",
    )

    def __init__(
        self,
        timeout: float = 5.0,
        response_timeout: float = 3.0,
        retry_attempts: int = 3,
        retry_interval: float = 1.5,
        sync_slaves: int = 0,
        sync_timeout: float = 5.0,
    ):
        self.timeout = timeout
        self.response_timeout = response_timeout
        self.retry_attempts = retry_attempts
        self.retry_interval = retry_interval
        self.sync_slaves = sync_slaves
        self.sync_timeout = sync_timeout

    @classmethod
    def defaults(cls) -> "TransactionOptions":
        return cls()


class _Op:
    """One buffered mutation: everything needed to apply it embedded
    (factory+raw name via local handles) or over the wire (mapped name)."""

    __slots__ = ("factory", "name", "mapped", "method", "args", "kwargs", "codec")

    def __init__(self, factory, name, mapped, method, args, kwargs, codec):
        self.factory = factory
        self.name = name
        self.mapped = mapped
        self.method = method
        self.args = args
        self.kwargs = kwargs
        self.codec = codec

    def wire(self) -> tuple:
        base = (self.factory, self.mapped, self.method, self.args, self.kwargs)
        if self.codec is not None:
            return base + (safe_pickle.dumps(self.codec),)
        return base


class BaseTransaction:
    """Facade-independent core: buffering, read-your-writes overlay,
    lifecycle.  Subclasses provide `_map_name`, `_versioned_read`, and
    `_apply_commit`."""

    def __init__(self, options: Optional[TransactionOptions] = None):
        self._options = options or TransactionOptions.defaults()
        self._ops: List[_Op] = []
        self._read_versions: Dict[str, int] = {}  # mapped name -> version
        self._local: Dict[Tuple[str, Any], Any] = {}  # read-your-writes buffer
        self._deleted: Set[Tuple[str, Any]] = set()
        self._lc_views: List["TxLocalCachedMap"] = []
        self._state = "active"
        self._created_at = time.time()

    # -- transactional object views (RedissonTransaction.java:84-196) --------

    def get_bucket(self, name: str, codec=None) -> "TxBucket":
        return TxBucket(self, "get_bucket", name, codec)

    def get_buckets(self, codec=None) -> "TxBuckets":
        return TxBuckets(self, codec)

    def get_map(self, name: str, codec=None) -> "TxMap":
        return TxMap(self, "get_map", name, codec)

    def get_map_cache(self, name: str, codec=None) -> "TxMapCache":
        return TxMapCache(self, "get_map_cache", name, codec)

    def get_set(self, name: str, codec=None) -> "TxSet":
        return TxSet(self, "get_set", name, codec)

    def get_set_cache(self, name: str, codec=None) -> "TxSetCache":
        return TxSetCache(self, "get_set_cache", name, codec)

    def get_local_cached_map(self, from_handle) -> "TxLocalCachedMap":
        """Takes the LIVE handle (RTransaction.getLocalCachedMap(fromInstance)
        signature): the handle carries the near-cache channel used for the
        commit-time disable/enable handshake."""
        view = TxLocalCachedMap(self, from_handle)
        self._lc_views.append(view)
        return view

    # -- buffering ------------------------------------------------------------

    def _check_active(self):
        if self._state != "active":
            raise TransactionException(f"transaction is {self._state}")
        if time.time() - self._created_at > self._options.timeout:
            self._state = "timed_out"
            self._ops.clear()
            self._local.clear()
            raise TransactionException("transaction timed out")

    def _buffer(self, factory, name, method, args=(), kwargs=None, codec=None):
        self._check_active()
        self._ops.append(
            _Op(factory, name, self._map_name(name), method, tuple(args),
                dict(kwargs or {}), codec)
        )

    def _read(self, factory, name, method, args=(), kwargs=None, codec=None):
        """A transactional read: returns the result AND records the record's
        observed version (first observation wins) as a commit precondition."""
        self._check_active()
        mapped = self._map_name(name)
        version, result = self._versioned_read(
            factory, name, mapped, method, tuple(args), dict(kwargs or {}), codec
        )
        self._read_versions.setdefault(mapped, version)
        return result

    # -- lifecycle ------------------------------------------------------------

    def commit(self) -> None:
        self._check_active()
        try:
            self._apply_commit()
        except TransactionException:
            self._state = "rolled_back"
            raise
        self._state = "committed"

    def rollback(self) -> None:
        self._check_active()
        self._ops.clear()
        self._local.clear()
        self._deleted.clear()
        self._read_versions.clear()
        self._state = "rolled_back"

    @property
    def state(self) -> str:
        return self._state

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self._state == "active":
            self.commit()
        elif self._state == "active":
            self.rollback()
        return False

    # -- facade seams ---------------------------------------------------------

    def _map_name(self, name: str) -> str:
        raise NotImplementedError

    def _versioned_read(self, factory, name, mapped, method, args, kwargs, codec):
        raise NotImplementedError

    def _apply_commit(self) -> None:
        raise NotImplementedError


class EmbeddedTransaction(BaseTransaction):
    """In-process transaction over the engine (the original facade)."""

    def __init__(self, engine, timeout: Optional[float] = None,
                 options: Optional[TransactionOptions] = None):
        if options is None:
            options = TransactionOptions.defaults()
        if timeout is not None:  # back-compat: create_transaction(timeout=...)
            options.timeout = timeout
        super().__init__(options)
        self._engine = engine

    def _map_name(self, name: str) -> str:
        mapper = getattr(self._engine.config, "name_mapper", None)
        return mapper.map(name) if mapper is not None else name

    def _handle(self, factory: str, name: str, codec):
        from redisson_tpu_torch.client.redisson import RedissonTpu

        client = RedissonTpu(self._engine)
        if factory == "get_local_cached_map":
            # plain-map application: invalidations are broadcast by the view's
            # commit handshake, and a throwaway LocalCachedMap handle would
            # leak a subscription per committed op
            return getattr(client, "get_map")(name, codec)
        return getattr(client, factory)(name, codec)

    def _versioned_read(self, factory, name, mapped, method, args, kwargs, codec):
        with self._engine.locked(mapped):
            rec = self._engine.store.get(mapped)
            version = 0 if rec is None else rec.version
            handle = self._handle(factory, name, codec)
            return version, getattr(handle, method)(*args, **kwargs)

    def _apply_commit(self) -> None:
        names = sorted({op.mapped for op in self._ops} | set(self._read_versions))
        for view in self._lc_views:
            view._disable_caches()
        try:
            with self._engine.locked_many(names):
                for mapped, seen in self._read_versions.items():
                    rec = self._engine.store.get(mapped)
                    cur = 0 if rec is None else rec.version
                    if cur != seen:
                        raise TransactionException(
                            f"object '{mapped}' changed concurrently "
                            f"(version {seen} -> {cur})"
                        )
                for op in self._ops:
                    handle = self._handle(op.factory, op.name, op.codec)
                    getattr(handle, op.method)(*op.args, **op.kwargs)
        finally:
            for view in self._lc_views:
                view._enable_caches()


# alias kept for existing callers (client/redisson.py, tests)
Transaction = EmbeddedTransaction

_ROUTING_PREFIXES = ("MOVED ", "ASK ", "TRYAGAIN", "CLUSTERDOWN")


class CommitPlan:
    """Pure commit bookkeeping shared by the sync AND async wire
    transactions (no I/O): which TXEXEC frames to send for the names not
    yet committed, and what a mid-commit error means.  Keeping this in ONE
    place is what lets the two event models share the subtle parts —
    check-phase eligibility, no re-send of already-applied frames, loud
    partial-commit classification."""

    def __init__(self, versions: Dict[str, int], wire_ops: List[tuple],
                 op_names: List[str], all_names: List[str]):
        self.versions = versions
        self.wire_ops = wire_ops
        self.op_names = op_names
        self.all_names = list(all_names)
        self.done: Set[str] = set()  # names whose group frame committed

    def remaining(self) -> List[str]:
        return [n for n in self.all_names if n not in self.done]

    def frames(self, groups: Dict[Any, List[str]]) -> List[tuple]:
        """-> [(group_key, names, versions_sub, ops_sub)] with empty frames
        dropped."""
        out = []
        for key, names in groups.items():
            nameset = set(names)
            vsub = {n: self.versions[n] for n in names if n in self.versions}
            osub = [
                op for op, nm in zip(self.wire_ops, self.op_names)
                if nm in nameset
            ]
            if vsub or osub:
                out.append((key, names, vsub, osub))
        return out

    def needs_check_phase(self, frames: List[tuple]) -> bool:
        # one frame is already check+apply atomic; after a partial apply the
        # committed shards' versions are stale, so re-checking would lie
        return len(frames) > 1 and not self.done

    @property
    def partially_applied(self) -> bool:
        return bool(self.done)

    def classify(self, msg: str, attempt: int, attempts: int) -> str:
        """'conflict' | 'partial' | 'retry' | 'raise' for a RespError."""
        if msg.startswith("TXCONFLICT"):
            return "partial" if self.done else "conflict"
        if msg.startswith(_ROUTING_PREFIXES) and attempt < attempts - 1:
            # TXEXEC's whole-frame routing precheck guarantees a bounced
            # frame applied nothing; already-committed frames are excluded
            # from the retry via remaining(), so no double-apply
            return "retry"
        return "raise"

    def partial_error(self, msg: str) -> "TransactionException":
        return TransactionException(
            f"PARTIALLY COMMITTED: {len(self.done)} object(s) "
            f"({sorted(self.done)[:5]}...) were applied before a later "
            f"shard conflicted — {msg.replace('TXCONFLICT ', '', 1)}; "
            "cross-shard commits are per-shard atomic (the reference's "
            "cluster batch guarantee), not globally atomic"
        )


class RemoteTransaction(BaseTransaction):
    """Wire transaction for RemoteRedisson / ClusterRedisson (and the async
    client via a thin awaitable shell): reads ride OBJCALLV, commit rides
    per-shard-owner TXEXEC frames (transaction/RedissonTransaction.java:270-306
    re-expressed as version-checked atomic frames)."""

    def __init__(self, client, options: Optional[TransactionOptions] = None):
        super().__init__(options)
        self._client = client

    def _map_name(self, name: str) -> str:
        return self._client._map_name(name)

    def _versioned_read(self, factory, name, mapped, method, args, kwargs, codec):
        from redisson_tpu_torch.client.remote import _unwrap

        payload = safe_pickle.dumps((args, kwargs))
        frame = [
            "OBJCALLV", factory, mapped, method, payload,
            self._client.caller_id(),
        ]
        if codec is not None:
            frame.append(safe_pickle.dumps(codec))
        reply = self._client.execute(
            *frame, timeout=self._options.response_timeout
        )
        version, result = _unwrap(reply, self._client)
        return version, result

    def _apply_commit(self) -> None:
        versions = dict(self._read_versions)
        wire_ops = [op.wire() for op in self._ops]
        op_names = [op.mapped for op in self._ops]
        all_names = sorted(set(versions) | set(op_names))
        if not all_names:
            return
        for view in self._lc_views:
            view._disable_caches()
        try:
            self._commit_frames(all_names, versions, wire_ops, op_names)
        finally:
            for view in self._lc_views:
                view._enable_caches()
        if self._options.sync_slaves:
            self._client.sync_replication(
                all_names, timeout=self._options.sync_timeout
            )

    def _commit_frames(self, all_names, versions, wire_ops, op_names) -> None:
        """Cross-shard discipline: a check-only phase runs on every owner
        BEFORE any apply, so a conflict that existed at commit time aborts
        with nothing applied anywhere; a write racing between a shard's
        check and its apply can still partially commit (the same per-shard
        exposure as the reference's cluster batch) and is reported loudly
        as PARTIALLY COMMITTED.  Retries after MOVED/ASK only re-send the
        frames that have NOT committed (CommitPlan.remaining), so a
        topology change mid-commit cannot double-apply."""
        from redisson_tpu_torch.net.resp import RespError

        plan = CommitPlan(versions, wire_ops, op_names, all_names)
        attempts = max(1, self._options.retry_attempts)
        timeout = self._options.response_timeout
        for attempt in range(attempts):
            frames = plan.frames(self._client.tx_groups(plan.remaining()))
            if not frames:
                return
            try:
                if plan.needs_check_phase(frames):
                    for key, _names, vsub, _osub in frames:
                        if vsub:
                            self._client.txexec(key, vsub, [], timeout=timeout)
                results: List[Any] = []
                for key, names, vsub, osub in frames:
                    results.extend(
                        self._client.txexec(key, vsub, osub, timeout=timeout)
                    )
                    plan.done.update(names)
                errs = [r for r in results if isinstance(r, BaseException)]
                if errs:
                    # EXEC semantics: other ops applied, no rollback — but
                    # the caller must know (the reference wraps batch
                    # failures in TransactionException the same way)
                    raise TransactionException(
                        f"transaction op failed: {errs[0]!r}"
                    ) from errs[0]
                return
            except RespError as e:
                action = plan.classify(str(e), attempt, attempts)
                if action == "conflict":
                    raise TransactionException(
                        str(e).replace("TXCONFLICT ", "", 1)
                    ) from None
                if action == "partial":
                    raise plan.partial_error(str(e)) from None
                if action == "retry":
                    refresh = getattr(self._client, "refresh_topology", None)
                    if refresh is not None:
                        refresh()
                    time.sleep(min(self._options.retry_interval, 0.25 * (attempt + 1)))
                    continue
                raise


# -- transaction-scoped views -------------------------------------------------


class _TxView:
    def __init__(self, tx: BaseTransaction, factory: str, name: str, codec):
        from redisson_tpu_torch.client.codec import DEFAULT_CODEC

        self._tx = tx
        self._factory = factory
        self._rawname = name
        self._name = tx._map_name(name)
        self._codec = codec
        self._enc = codec or DEFAULT_CODEC

    @property
    def name(self) -> str:
        return self._rawname

    def _buffer(self, method, *args, **kwargs):
        self._tx._buffer(
            self._factory, self._rawname, method, args, kwargs, self._codec
        )

    def _read(self, method, *args, **kwargs):
        return self._tx._read(
            self._factory, self._rawname, method, args, kwargs, self._codec
        )


class TxBucket(_TxView):
    """RedissonTransactionalBucket: get/set/trySet/compareAndSet/getAndSet/
    delete.  Conditional ops read (recording the version precondition) and
    buffer a plain write — the version check at commit enforces the
    condition atomically."""

    def _key(self):
        return (self._name, None)

    def get(self):
        self._tx._check_active()
        key = self._key()
        if key in self._tx._deleted:
            return None
        if key in self._tx._local:
            return self._tx._local[key]
        return self._read("get")

    def set(self, value) -> None:
        key = self._key()
        self._tx._local[key] = value
        self._tx._deleted.discard(key)
        self._buffer("set", value)

    def try_set(self, value) -> bool:
        if self.get() is not None:
            return False
        self.set(value)
        return True

    def compare_and_set(self, expect, update) -> bool:
        cur = self.get()
        if cur != expect:
            return False
        self.set(update)
        return True

    def get_and_set(self, value):
        cur = self.get()
        self.set(value)
        return cur

    def delete(self) -> None:
        key = self._key()
        self._tx._deleted.add(key)
        self._tx._local.pop(key, None)
        self._buffer("delete")


class TxBuckets:
    """RedissonTransactionalBuckets: multi-key get/set/trySet.  trySet is
    MSETNX — all-or-nothing enforced by the per-name version preconditions
    recorded at the existence probe (still atomic cross-shard thanks to the
    check-phase of the grouped commit)."""

    def __init__(self, tx: BaseTransaction, codec=None):
        self._tx = tx
        self._codec = codec

    def _bucket(self, name: str) -> TxBucket:
        return TxBucket(self._tx, "get_bucket", name, self._codec)

    def get(self, *names: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for nm in names:
            v = self._bucket(nm).get()
            if v is not None:
                out[nm] = v
        return out

    def set(self, values: Dict[str, Any]) -> None:
        for nm, v in values.items():
            self._bucket(nm).set(v)

    def try_set(self, values: Dict[str, Any]) -> bool:
        buckets = {nm: self._bucket(nm) for nm in sorted(values)}
        for b in buckets.values():
            if b.get() is not None:
                return False
        for nm, b in buckets.items():
            b.set(values[nm])
        return True


class TxMap(_TxView):
    """RedissonTransactionalMap surface (map/* operations package)."""

    def _key(self, k):
        return (self._name, self._enc.encode_map_key(k))

    def get(self, k):
        self._tx._check_active()
        key = self._key(k)
        if key in self._tx._deleted:
            return None
        if key in self._tx._local:
            return self._tx._local[key]
        return self._read("get", k)

    def get_all(self, keys) -> Dict:
        out = {}
        for k in keys:
            v = self.get(k)
            if v is not None:
                out[k] = v
        return out

    def contains_key(self, k) -> bool:
        return self.get(k) is not None

    def put(self, k, v):
        """Returns the PREVIOUS value (RMap.put contract) — a transactional
        read that records the version precondition."""
        prev = self.get(k)
        self.fast_put(k, v)
        return prev

    def fast_put(self, k, v) -> None:
        key = self._key(k)
        self._tx._local[key] = v
        self._tx._deleted.discard(key)
        self._buffer("fast_put", k, v)

    def put_all(self, entries: Dict) -> None:
        for k, v in entries.items():
            self.fast_put(k, v)

    def put_if_absent(self, k, v):
        prev = self.get(k)
        if prev is not None:
            return prev
        self.fast_put(k, v)
        return None

    def replace(self, k, v):
        prev = self.get(k)
        if prev is None:
            return None
        self.fast_put(k, v)
        return prev

    def replace_if_equals(self, k, expected, update) -> bool:
        if self.get(k) != expected:
            return False
        self.fast_put(k, update)
        return True

    def remove(self, k):
        prev = self.get(k)
        if prev is not None:
            self.fast_remove(k)
        return prev

    def remove_if_equals(self, k, expected) -> bool:
        if self.get(k) != expected:
            return False
        self.fast_remove(k)
        return True

    def fast_remove(self, *keys) -> None:
        for k in keys:
            key = self._key(k)
            self._tx._deleted.add(key)
            self._tx._local.pop(key, None)
        self._buffer("fast_remove", *keys)


class TxMapCache(TxMap):
    """RedissonTransactionalMapCache: TxMap + TTL'd puts."""

    def put_with_ttl(self, k, v, ttl: Optional[float] = None):
        prev = self.get(k)
        key = self._key(k)
        self._tx._local[key] = v
        self._tx._deleted.discard(key)
        self._buffer("put_with_ttl", k, v, ttl=ttl)
        return prev

    def fast_put_with_ttl(self, k, v, ttl: Optional[float] = None) -> None:
        key = self._key(k)
        self._tx._local[key] = v
        self._tx._deleted.discard(key)
        self._buffer("put_with_ttl", k, v, ttl=ttl)


class TxSet(_TxView):
    """RedissonTransactionalSet."""

    def _key(self, v):
        return (self._name, self._enc.encode(v))

    def contains(self, v) -> bool:
        self._tx._check_active()
        key = self._key(v)
        if key in self._tx._deleted:
            return False
        if key in self._tx._local:
            return True
        return bool(self._read("contains", v))

    def add(self, v) -> None:
        key = self._key(v)
        self._tx._local[key] = v
        self._tx._deleted.discard(key)
        self._buffer("add", v)

    def add_all(self, values) -> None:
        for v in values:
            self.add(v)

    def remove(self, v) -> None:
        key = self._key(v)
        self._tx._deleted.add(key)
        self._tx._local.pop(key, None)
        self._buffer("remove", v)


class TxSetCache(TxSet):
    """RedissonTransactionalSetCache: adds carry a TTL."""

    def add(self, v, ttl: Optional[float] = None) -> None:
        key = self._key(v)
        self._tx._local[key] = v
        self._tx._deleted.discard(key)
        if ttl is None:
            self._buffer("add", v)
        else:
            self._buffer("add", v, ttl)  # SetCache.add(value, ttl)


class TxLocalCachedMap(TxMap):
    """RedissonTransactionalLocalCachedMap: the TxMap surface over the
    backing map, plus the commit-time near-cache disable/enable handshake
    (LocalCachedMapDisable/Enable messages, RedissonTransaction.java
    disableLocalCache/enableLocalCache): every subscriber — including the
    committing client — bypasses its near cache from just before the commit
    frame until the enable broadcast, so no client can serve a stale
    near-cache read between apply and invalidation delivery."""

    def __init__(self, tx: BaseTransaction, handle):
        super().__init__(
            tx, "get_local_cached_map", handle.name,
            getattr(handle, "_codec", None),
        )
        self._handle = handle
        self._req_id = uuid.uuid4().hex

    def _disable_caches(self) -> None:
        try:
            self._handle.tx_disable(self._req_id)
        except Exception:  # noqa: BLE001 — handshake is best-effort
            pass

    def _enable_caches(self) -> None:
        try:
            self._handle.tx_enable(self._req_id)
        except Exception:  # noqa: BLE001
            pass
