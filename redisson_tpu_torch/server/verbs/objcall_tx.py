"""Generic object invocation (OBJCALL*) and wire transactions (MULTI/EXEC/WATCH + TXEXEC).

A copy of ``redisson_tpu/server/verbs/objcall_tx.py``, with its cluster
routing prechecks: OBJCALLM checks each op's name, EXEC its whole queue and
TXEXEC its whole frame before anything applies.  Pickled payloads go through ``net/safe_pickle``: results
and exceptions are written under the reference's class names, a tensor as
its numpy array, and an exception of a class outside the builtins and this
package (a CUDA error raised by a kernel) as the nearest builtin exception
with its class name and message, so any client can read every reply.
"""

from typing import Optional

from redisson_tpu_torch.net import safe_pickle
from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.net.safe_pickle import safe_loads
from redisson_tpu_torch.server.registry import REGISTRY, LazyReply, _s, register
from redisson_tpu_torch.server.verbs.common import _exec_tls


def _reply(tag: bytes, value) -> bytes:
    return tag + safe_pickle.dumps(value)

# -- generic object invocation (the classBody-shipping analog) ---------------

def _objcall_resolve(server, factory: str, name: str, codec_blob: Optional[bytes] = None):
    """Resolve the (cached) handle instance for one object call.

    `codec_blob` (optional, pickled Codec) lets remote clients carry a
    non-default codec across the wire — the reference's getMap(name, codec)
    contract; without it every wire handle silently used the server's
    default codec.  The raw blob keys the cache so same-name handles with
    different codecs don't alias."""
    if not factory.startswith(("get_", "create_")):
        raise RespError("ERR bad factory")
    client = server.local_client()
    fn = getattr(client, factory, None)
    if fn is None:
        raise RespError(f"ERR unknown factory '{factory}'")

    def _make():
        kw = {}
        if codec_blob is not None:
            import inspect

            # signature probe, not except-TypeError: a TypeError raised
            # INSIDE an accepting factory must not masquerade as "does not
            # accept a codec"
            try:
                params = inspect.signature(fn).parameters
            except (TypeError, ValueError):
                params = {}
            if "codec" not in params and not any(
                p.kind == p.VAR_KEYWORD for p in params.values()
            ):
                raise RespError(f"ERR factory '{factory}' does not accept a codec")
            kw["codec"] = safe_loads(codec_blob)
        return fn(name, **kw) if name else fn(**kw)

    # handle instances are cached per (factory, name): stateful handles
    # (LocalCachedMap subscribes an invalidation listener, adders register
    # counters) must not accrete one instance per OBJCALL.  create_* stays
    # uncached by contract (fresh object per call).
    if not factory.startswith("get_"):
        return _make()
    cache = server._objcall_handles
    key = (factory, name, codec_blob)
    with server._objcall_handles_lock:
        obj = cache.get(key)
        if obj is None:
            obj = _make()
            cache[key] = obj
            if len(cache) > 4096:  # bounded LRU
                _k, old = cache.popitem(last=False)
                detach = getattr(old, "destroy", None)  # detach-only by contract
                if detach is not None:
                    try:
                        detach()
                    except Exception:  # noqa: BLE001
                        pass
        else:
            cache.move_to_end(key)
    return obj


def _objcall_invoke(server, factory, name, method, call_args, call_kwargs, caller,
                    codec_blob: Optional[bytes] = None):
    """One object-method invocation; returns the raw result (exceptions
    other than protocol errors propagate to the caller for tagging)."""
    obj = _objcall_resolve(server, factory, name, codec_blob)
    m = getattr(obj, method, None)
    if m is None or method.startswith("_"):
        raise RespError(f"ERR unknown method '{method}'")
    with server.engine.impersonate(caller):
        return m(*call_args, **call_kwargs)


@register("OBJCALL")
def cmd_objcall(server, ctx, args):
    """OBJCALL <factory> <name> <method> <pickled (args, kwargs)> [<caller-id>]
    [<pickled codec>] -> pickled result.  factory = RedissonTpu getter name
    ("get_map", ...); caller-id = client uuid:threadId so synchronizer
    identity survives the wire (RedissonBaseLock.getLockName travels
    client->Lua the same way); the optional codec rides the frame so remote
    handles honor getMap(name, codec) semantics."""
    factory, name, method = _s(args[0]), _s(args[1]), _s(args[2])
    call_args, call_kwargs = safe_loads(bytes(args[3])) if len(args) > 3 else ((), {})
    caller = _s(args[4]) if len(args) > 4 and args[4] is not None else None
    codec_blob = bytes(args[5]) if len(args) > 5 and args[5] is not None else None
    try:
        result = _objcall_invoke(
            server, factory, name, method, call_args, call_kwargs, caller, codec_blob
        )
    except RespError:
        raise
    except Exception as e:  # noqa: BLE001 — ship the exception to the caller
        return _reply(b"E", safe_pickle.wire_exception(e))
    return _reply(b"R", result)


@register("OBJCALLM")
def cmd_objcallm(server, ctx, args):
    """OBJCALLM <pickled [(factory, name, method, args, kwargs), ...]> [caller]
    -> b"M" + pickled [("R", result) | ("E", exception), ...].

    The batched object wire (CommandBatchService.java:87-151 made a single
    command): MANY object ops cross the wire as ONE frame and ONE pickle,
    instead of one round trip + pickle per op — the lever that lifts
    OBJCALL-bound cluster throughput.  Per-op routing errors (MOVED/ASK
    during a reshard) come back as tagged entries so the client re-routes
    just those ops."""
    return _objcallm_run(server, ctx, args, atomic=False)


@register("OBJCALLMA")
def cmd_objcallm_atomic(server, ctx, args):
    """Atomic OBJCALLM (BatchOptions IN_MEMORY_ATOMIC / the MULTI-EXEC
    analog, command/CommandBatchService.java:211-540): every op's record
    lock is taken UP FRONT via engine.locked_many, so no other command
    interleaves with the group — Redis EXEC semantics: non-interleaved
    execution, no rollback of ops that already applied when a later op
    errors.  Cluster rule matches the reference: all object names must
    colocate on this node (use {hashtags})."""
    return _objcallm_run(server, ctx, args, atomic=True)


def _objcallm_run(server, ctx, args, atomic: bool):
    ops = safe_loads(bytes(args[0]))
    caller = _s(args[1]) if len(args) > 1 else None
    if atomic:
        names = sorted({str(op[1]) for op in ops if op[1]})
        with server.engine.locked_many(names):
            result = _objcallm_apply(server, ops, caller)
    else:
        result = _objcallm_apply(server, ops, caller)
    # the OBJCALLM frame is keyless on the wire, so the registry's generic
    # tracking hook cannot see its keys — invalidate from the decoded ops
    # (write-methods only; tracking/table.note_objcall_ops)
    _track = getattr(server, "tracking", None)
    if _track is not None and _track.active:
        _track.note_objcall_ops(ops, ctx)
    return result


def _objcallm_apply(server, ops, caller):
    out = []
    for op in ops:
        # 5-tuple (factory, name, method, args, kwargs) or 6-tuple with a
        # trailing pickled-codec blob (same contract as OBJCALL's 6th arg)
        factory, name, method, call_args, call_kwargs = op[:5]
        codec_blob = op[5] if len(op) > 5 else None
        try:
            if server.cluster_view:
                # per-op routing check (the frame itself is keyless)
                server.check_routing(
                    "OBJCALL",
                    [str(factory).encode(), str(name).encode(), str(method).encode()],
                )
            out.append(
                (
                    "R",
                    _objcall_invoke(
                        server, factory, name, method,
                        tuple(call_args), dict(call_kwargs), caller, codec_blob,
                    ),
                )
            )
        except Exception as e:  # noqa: BLE001 — tagged per-op, frame continues
            out.append(("E", safe_pickle.wire_exception(e)))
    return _reply(b"M", out)


# -- transactions over the wire ----------------------------------------------
# Two surfaces, one engine mechanism (record versions + locked_many):
#   * MULTI/EXEC/WATCH/DISCARD/UNWATCH — the Redis-compatible verbs for
#     generic clients (queue in CommandContext, optimistic WATCH versions);
#   * OBJCALLV/TXEXEC — the object-level transaction wire used by
#     RemoteTransaction (transaction/RedissonTransaction.java:49-79 role):
#     reads return the observed record version, commit is ONE atomic frame
#     with version preconditions checked under locked_many.

# EXEC runs its queue on one worker thread; blocking verbs inside a
# transaction must degrade to a single non-blocking probe (Redis semantics:
# BLPOP inside MULTI acts as if the timeout elapsed immediately)


@register("MULTI")
def cmd_multi(server, ctx, args):
    if ctx.multi_queue is not None:
        raise RespError("ERR MULTI calls can not be nested")
    ctx.multi_queue = []
    ctx.multi_error = False
    return "+OK"


@register("DISCARD")
def cmd_discard(server, ctx, args):
    if ctx.multi_queue is None:
        raise RespError("ERR DISCARD without MULTI")
    ctx.multi_queue = None
    ctx.multi_error = False
    ctx.watch_versions.clear()
    return "+OK"


@register("WATCH")
def cmd_watch(server, ctx, args):
    if ctx.multi_queue is not None:
        raise RespError("ERR WATCH inside MULTI is not allowed")
    if not args:
        raise RespError("ERR wrong number of arguments for 'watch' command")
    for a in args:
        name = _s(a)
        rec = server.engine.store.get(name)
        # first observation wins (re-WATCHing a key keeps the original
        # precondition, matching the read-versions discipline)
        ctx.watch_versions.setdefault(name, 0 if rec is None else rec.version)
    return "+OK"


@register("UNWATCH")
def cmd_unwatch(server, ctx, args):
    ctx.watch_versions.clear()
    return "+OK"


@register("RESET")
def cmd_reset(server, ctx, args):
    """Connection state reset (Redis 6.2 RESET): transaction, watches,
    subscriptions stay untouched server-side except tx state (subscription
    teardown rides connection close)."""
    ctx.multi_queue = None
    ctx.multi_error = False
    ctx.watch_versions.clear()
    ctx.asking = False
    return "+RESET"


@register("EXEC")
def cmd_exec(server, ctx, args):
    from redisson_tpu_torch.net import commands as C

    if ctx.multi_queue is None:
        raise RespError("ERR EXEC without MULTI")
    queue, ctx.multi_queue = ctx.multi_queue, None
    poisoned, ctx.multi_error = ctx.multi_error, False
    watches, ctx.watch_versions = dict(ctx.watch_versions), {}
    if poisoned:
        raise RespError(
            "EXECABORT Transaction discarded because of previous errors."
        )
    # routing precheck over the WHOLE group before anything applies: a slot
    # migrated since queue time must bounce the entire EXEC, never half of it
    if server.cluster_view or server.role == "replica":
        for qargs in queue:
            server.check_routing(bytes(qargs[0]).decode().upper(), qargs[1:])
    names = set(watches)
    for qargs in queue:
        for key in C.command_keys(bytes(qargs[0]).decode().upper(), qargs[1:]):
            names.add(key.decode() if isinstance(key, (bytes, bytearray)) else str(key))
    # one EXEC at a time: handlers may take record locks beyond the
    # precomputed key set (derived names), and serializing EXECs removes
    # any cross-transaction lock-order inversion those could introduce
    with server._exec_mutex:
        with server.engine.locked_many(sorted(names)):
            for name, seen in watches.items():
                rec = server.engine.store.get(name)
                cur = 0 if rec is None else rec.version
                if cur != seen:
                    return None  # nil reply: transaction aborted (Redis WATCH)
            results = []
            _exec_tls.in_exec = True
            try:
                for qargs in queue:
                    try:
                        r = REGISTRY.dispatch(server, ctx, qargs)
                        if isinstance(r, LazyReply):
                            # the frame-level lazy materializer only walks
                            # TOP-level results; nested lazies force here
                            r = r.force()
                        if isinstance(r, str) and r.startswith("+"):
                            r = r[1:]  # "+OK" marker is a top-level encoding
                        results.append(r)
                    except RespError as e:
                        results.append(e)  # per-command errors as values
                    except Exception as e:  # noqa: BLE001 — WRONGTYPE et al.
                        results.append(
                            RespError(f"ERR internal: {type(e).__name__}: {e}")
                        )
            finally:
                _exec_tls.in_exec = False
            return results


@register("OBJCALLV")
def cmd_objcallv(server, ctx, args):
    """OBJCALL returning (observed record version, result) — the
    transactional read.  The version is captured UNDER the record lock
    before the method runs, so a concurrent writer cannot slip between
    observation and result (RemoteTransaction records it as the commit
    precondition, the WATCH analog for the object surface)."""
    factory, name, method = _s(args[0]), _s(args[1]), _s(args[2])
    call_args, call_kwargs = safe_loads(bytes(args[3])) if len(args) > 3 else ((), {})
    caller = _s(args[4]) if len(args) > 4 and args[4] is not None else None
    codec_blob = bytes(args[5]) if len(args) > 5 and args[5] is not None else None
    with server.engine.locked(name):
        rec = server.engine.store.get(name)
        version = 0 if rec is None else rec.version
        try:
            result = _objcall_invoke(
                server, factory, name, method, call_args, call_kwargs, caller,
                codec_blob,
            )
        except RespError:
            raise
        except Exception as e:  # noqa: BLE001 — ship the exception to the caller
            return _reply(b"E", safe_pickle.wire_exception(e))
    return _reply(b"R", (version, result))


@register("TXEXEC")
def cmd_txexec(server, ctx, args):
    """TXEXEC <pickled {name: version}> <pickled ops> [caller] — the atomic
    transaction commit frame: version preconditions verified and ops applied
    under ONE locked_many, so the check-then-apply window cannot admit a
    concurrent writer.  Versions mismatching reply TXCONFLICT with NOTHING
    applied; op errors after a passing check are tagged per-op with no
    rollback (EXEC semantics, same as OBJCALLMA).  The version-checked
    OBJCALLMA this extends is the commit path of RemoteTransaction
    (transaction/RedissonTransaction.java:270-306 made one frame)."""
    versions = safe_loads(bytes(args[0]))
    ops = safe_loads(bytes(args[1]))
    caller = _s(args[2]) if len(args) > 2 and args[2] is not None else None
    names = sorted(
        {str(n) for n in versions} | {str(op[1]) for op in ops if op[1]}
    )
    # whole-frame routing precheck BEFORE any lock/apply: a mid-migration
    # frame must bounce atomically (the client refreshes its topology and
    # retries the full commit — nothing has applied)
    if server.cluster_view:
        for n in names:
            server.check_routing(
                "OBJCALL", [b"tx", n.encode(), b"precheck"]
            )
    with server.engine.locked_many(names):
        for name, seen in versions.items():
            rec = server.engine.store.get(str(name))
            cur = 0 if rec is None else rec.version
            if cur != int(seen):
                raise RespError(
                    f"TXCONFLICT object '{name}' changed concurrently "
                    f"(version {seen} -> {cur})"
                )
        result = _objcallm_apply(server, ops, caller)
    # commit applied: invalidate tracked readers of every written object
    # (keyless frame — same rule as OBJCALLM above)
    _track = getattr(server, "tracking", None)
    if _track is not None and _track.active:
        _track.note_objcall_ops(ops, ctx)
    return result


