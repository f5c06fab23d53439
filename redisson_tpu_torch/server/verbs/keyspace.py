"""Keyspace admin, strings/buckets, typed data commands and scan cursors
(RedissonKeys / RedissonBucket / RedissonMap / RSet / RList /
RScoredSortedSet surface): a copy of ``redisson_tpu/server/verbs/keyspace.py``.
"""

import time
from typing import Optional

from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import register, _s, _int
from redisson_tpu_torch.server.verbs.common import (
    _deque,
    _fnum,
    _scan_opts,
    _scan_page,
    _signal_waiters,
    _typed_handle,
)

# -- keyspace admin (RedissonKeys surface) -----------------------------------

@register("KEYS")
def cmd_keys(server, ctx, args):
    pattern = _s(args[0]) if args else "*"
    return [k.encode() for k in server.engine.store.keys(pattern)]


@register("DBSIZE")
def cmd_dbsize(server, ctx, args):
    return len(server.engine.store)


@register("DEL")
def cmd_del(server, ctx, args):
    # Record lock per key: a DEL racing a slot drain must serialize against
    # the in-flight ship (server.py migrate_slot_batch) or the acked delete
    # resurrects from the migrated copy when the slot finalizes.
    def _del(k: str) -> bool:
        with server.engine.locked(k):
            return server.engine.store.delete(k)

    return sum(1 for k in args if _del(_s(k)))


@register("UNLINK")
def cmd_unlink(server, ctx, args):
    return cmd_del(server, ctx, args)


@register("EXISTS")
def cmd_exists(server, ctx, args):
    return sum(1 for k in args if server.engine.store.exists(_s(k)))


def _expire_locked(server, name: str, at) -> int:
    # Same record-lock discipline as DEL: a TTL change racing a slot drain
    # must serialize against the in-flight ship or it silently vanishes.
    with server.engine.locked(name):
        return 1 if server.engine.store.expire(name, at) else 0


@register("EXPIRE")
def cmd_expire(server, ctx, args):
    return _expire_locked(server, _s(args[0]), time.time() + _int(args[1]))


@register("PEXPIRE")
def cmd_pexpire(server, ctx, args):
    return _expire_locked(server, _s(args[0]), time.time() + _int(args[1]) / 1000.0)


@register("PERSIST")
def cmd_persist(server, ctx, args):
    return _expire_locked(server, _s(args[0]), None)


@register("TTL")
def cmd_ttl(server, ctx, args):
    name = _s(args[0])
    if not server.engine.store.exists(name):
        return -2
    ttl = server.engine.store.ttl(name)
    return -1 if ttl is None else int(ttl)


@register("PTTL")
def cmd_pttl(server, ctx, args):
    name = _s(args[0])
    if not server.engine.store.exists(name):
        return -2
    ttl = server.engine.store.ttl(name)
    return -1 if ttl is None else int(ttl * 1000)


@register("RENAME")
def cmd_rename(server, ctx, args):
    src, dst = _s(args[0]), _s(args[1])
    with server.engine.locked_many([src, dst]):
        if not server.engine.store.rename(src, dst):
            raise RespError("ERR no such key")
    return "+OK"


@register("FLUSHALL")
def cmd_flushall(server, ctx, args):
    server.engine.store.flushall()
    return "+OK"


@register("FLUSHDB")
def cmd_flushdb(server, ctx, args):
    # single-keyspace engine: the selected db IS the keyspace
    return cmd_flushall(server, ctx, args)


@register("TYPE")
def cmd_type(server, ctx, args):
    rec = server.engine.store.get(_s(args[0]))
    return ("+" + (rec.kind if rec else "none"))


# -- strings / buckets --------------------------------------------------------

def _bucket(server, name: str):
    from redisson_tpu_torch.client.objects.bucket import Bucket
    from redisson_tpu_torch.client.codec import BytesCodec

    return Bucket(server.engine, name, BytesCodec())


@register("GET")
def cmd_get(server, ctx, args):
    return _bucket(server, _s(args[0])).get()


@register("SET")
def cmd_set(server, ctx, args):
    name = _s(args[0])
    value = bytes(args[1])
    px: Optional[float] = None
    nx = xx = False
    i = 2
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"PX":
            px = _int(args[i + 1]) / 1000.0
            i += 2
        elif opt == b"EX":
            px = float(_int(args[i + 1]))
            i += 2
        elif opt == b"NX":
            nx = True
            i += 1
        elif opt == b"XX":
            xx = True
            i += 1
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    b = _bucket(server, name)
    if nx:
        if not b.try_set(value, ttl=px):
            return None
    elif xx:
        with server.engine.locked(name):
            if not b.set_if_exists(value):
                return None
            if px is not None:
                server.engine.store.expire(name, time.time() + px)
    else:
        b.set(value, ttl=px)
    return "+OK"


@register("INCR")
def cmd_incr(server, ctx, args):
    from redisson_tpu_torch.client.objects.bucket import AtomicLong

    return AtomicLong(server.engine, _s(args[0])).increment_and_get()


@register("INCRBY")
def cmd_incrby(server, ctx, args):
    from redisson_tpu_torch.client.objects.bucket import AtomicLong

    return AtomicLong(server.engine, _s(args[0])).add_and_get(_int(args[1]))


@register("DECR")
def cmd_decr(server, ctx, args):
    from redisson_tpu_torch.client.objects.bucket import AtomicLong

    return AtomicLong(server.engine, _s(args[0])).decrement_and_get()


# -- typed data commands (Redis-compatible wire surface) ----------------------
# The reference registry defines ~447 typed commands (RedisCommands.java);
# the batch-first blob forms are the primary citizens, and
# OBJCALL carries the full object surface — but generic Redis clients speak
# THESE verbs.  Values are raw bytes (BytesCodec), Redis semantics: a typed
# command and a default-codec OBJCALL handle on the same name see different
# encodings, exactly like mixing codecs in the reference.


@register("HSET")
def cmd_hset(server, ctx, args):
    name = _s(args[0])
    m = _typed_handle(server, "get_map", name)
    n = 0
    with server.engine.locked(name):  # multi-field writes land atomically
        for i in range(1, len(args) - 1, 2):
            if m.fast_put(bytes(args[i]), bytes(args[i + 1])):
                n += 1
    return n


@register("HMSET")
def cmd_hmset(server, ctx, args):
    """Deprecated Redis alias of HSET that replies +OK (the reference's
    RedisCommands.HMSET row)."""
    cmd_hset(server, ctx, args)
    return "+OK"


@register("HGET")
def cmd_hget(server, ctx, args):
    return _typed_handle(server, "get_map", _s(args[0])).get(bytes(args[1]))


@register("HMGET")
def cmd_hmget(server, ctx, args):
    m = _typed_handle(server, "get_map", _s(args[0]))
    return [m.get(bytes(f)) for f in args[1:]]


@register("HDEL")
def cmd_hdel(server, ctx, args):
    m = _typed_handle(server, "get_map", _s(args[0]))
    return int(m.fast_remove(*[bytes(f) for f in args[1:]]))


@register("HGETALL")
def cmd_hgetall(server, ctx, args):
    # dict reply: RESP3 map frame `%`, RESP2 flattens to field-value array
    m = _typed_handle(server, "get_map", _s(args[0]))
    return {bytes(k): v for k, v in m.read_all_entry_set()}


@register("HEXISTS")
def cmd_hexists(server, ctx, args):
    return 1 if _typed_handle(server, "get_map", _s(args[0])).contains_key(bytes(args[1])) else 0


@register("HLEN")
def cmd_hlen(server, ctx, args):
    return _typed_handle(server, "get_map", _s(args[0])).size()


@register("HKEYS")
def cmd_hkeys(server, ctx, args):
    return _typed_handle(server, "get_map", _s(args[0])).read_all_keys()


@register("HVALS")
def cmd_hvals(server, ctx, args):
    return _typed_handle(server, "get_map", _s(args[0])).read_all_values()


@register("SADD")
def cmd_sadd(server, ctx, args):
    s = _typed_handle(server, "get_set", _s(args[0]))
    return sum(1 for v in args[1:] if s.add(bytes(v)))


@register("SREM")
def cmd_srem(server, ctx, args):
    s = _typed_handle(server, "get_set", _s(args[0]))
    return sum(1 for v in args[1:] if s.remove(bytes(v)))


@register("SISMEMBER")
def cmd_sismember(server, ctx, args):
    return 1 if _typed_handle(server, "get_set", _s(args[0])).contains(bytes(args[1])) else 0


@register("SMEMBERS")
def cmd_smembers(server, ctx, args):
    # a python set encodes as the RESP3 `~` set frame (RESP2 projects to an
    # array) — the CommandDecoder.java marker for SMEMBERS-family replies
    return set(_typed_handle(server, "get_set", _s(args[0])).read_all())


@register("SCARD")
def cmd_scard(server, ctx, args):
    return _typed_handle(server, "get_set", _s(args[0])).size()



@register("LPUSH")
def cmd_lpush(server, ctx, args):
    d = _deque(server, _s(args[0]))
    for v in args[1:]:
        d.add_first(bytes(v))
    return d.size()


@register("RPUSH")
def cmd_rpush(server, ctx, args):
    d = _deque(server, _s(args[0]))
    for v in args[1:]:
        d.add_last(bytes(v))
    return d.size()


@register("LPOP")
def cmd_lpop(server, ctx, args):
    return _deque(server, _s(args[0])).poll_first()


@register("RPOP")
def cmd_rpop(server, ctx, args):
    return _deque(server, _s(args[0])).poll_last()


@register("LLEN")
def cmd_llen(server, ctx, args):
    return _deque(server, _s(args[0])).size()


@register("LRANGE")
def cmd_lrange(server, ctx, args):
    from redisson_tpu_torch.client.objects.scoredsortedset import _norm_range

    d = _deque(server, _s(args[0]))
    items = d.read_all()
    lo, hi = _norm_range(_int(args[1]), _int(args[2]), len(items))
    return items[lo : hi + 1] if hi >= lo else []


@register("LINDEX")
def cmd_lindex(server, ctx, args):
    items = _deque(server, _s(args[0])).read_all()
    i = _int(args[1])
    if i < 0:
        i += len(items)
    return items[i] if 0 <= i < len(items) else None


@register("ZADD")
def cmd_zadd(server, ctx, args):
    name = _s(args[0])
    z = _typed_handle(server, "get_scored_sorted_set", name)
    n = 0
    with server.engine.locked(name):  # multi-member adds land atomically
        for i in range(1, len(args) - 1, 2):
            if z.add(float(args[i]), bytes(args[i + 1])):
                n += 1
    _signal_waiters(server, name)  # wake parked BZPOPMIN/BZPOPMAX
    return n


@register("ZSCORE")
def cmd_zscore(server, ctx, args):
    # float reply: RESP3 double frame `,`, RESP2 Redis-formatted bulk
    sc = _typed_handle(server, "get_scored_sorted_set", _s(args[0])).get_score(bytes(args[1]))
    return None if sc is None else float(sc)


@register("ZREM")
def cmd_zrem(server, ctx, args):
    z = _typed_handle(server, "get_scored_sorted_set", _s(args[0]))
    return sum(1 for m in args[1:] if z.remove(bytes(m)))


@register("ZCARD")
def cmd_zcard(server, ctx, args):
    return _typed_handle(server, "get_scored_sorted_set", _s(args[0])).size()


@register("ZRANK")
def cmd_zrank(server, ctx, args):
    return _typed_handle(server, "get_scored_sorted_set", _s(args[0])).rank(bytes(args[1]))


@register("ZINCRBY")
def cmd_zincrby(server, ctx, args):
    z = _typed_handle(server, "get_scored_sorted_set", _s(args[0]))
    return float(z.add_score(bytes(args[2]), float(args[1])))


@register("ZRANGE")
def cmd_zrange(server, ctx, args):
    z = _typed_handle(server, "get_scored_sorted_set", _s(args[0]))
    withscores = len(args) > 3 and bytes(args[3]).upper() == b"WITHSCORES"
    lo, hi = _int(args[1]), _int(args[2])
    if withscores:
        out = []
        for member, score in z.entry_range(lo, hi):
            out += [member, _fnum(score)]
        return out
    return z.value_range(lo, hi)


@register("MGET")
def cmd_mget(server, ctx, args):
    # atomic snapshot across keys (Redis executes MGET as one step): without
    # all locks, a reader interleaving a concurrent MSET could see a torn
    # half-old half-new multi-key view
    names = [_s(k) for k in args]
    with server.engine.locked_many(names):
        return [_bucket(server, n).get() for n in names]


@register("MSET")
def cmd_mset(server, ctx, args):
    # ALL record locks up front (engine.locked_many): Redis MSET is atomic —
    # a concurrent MGET must never observe a torn multi-key write
    names = [_s(args[i]) for i in range(0, len(args) - 1, 2)]
    with server.engine.locked_many(names):
        for i in range(0, len(args) - 1, 2):
            _bucket(server, _s(args[i])).set(bytes(args[i + 1]))
    return "+OK"


@register("GETSET")
def cmd_getset(server, ctx, args):
    return _bucket(server, _s(args[0])).get_and_set(bytes(args[1]))


@register("GETDEL")
def cmd_getdel(server, ctx, args):
    name = _s(args[0])
    with server.engine.locked(name):
        v = _bucket(server, name).get()
        server.engine.store.delete(name)
        return v


@register("APPEND")
def cmd_append(server, ctx, args):
    name = _s(args[0])
    with server.engine.locked(name):
        b = _bucket(server, name)
        cur = b.get() or b""
        new = bytes(cur) + bytes(args[1])
        b.set(new)
        return len(new)


@register("STRLEN")
def cmd_strlen(server, ctx, args):
    v = _bucket(server, _s(args[0])).get()
    return 0 if v is None else len(bytes(v))


# -- typed surface expansion (strings / keys / scan cursors) ------------------
# Same contract as the block above: BytesCodec values, Redis reply shapes,
# record locks for compound read-modify-write.  Reference definitions:
# client/protocol/RedisCommands.java (SETNX:188, SETRANGE/GETRANGE:199-201,
# INCRBYFLOAT:214, SCAN:531, EXPIREAT:340).





@register("SETNX")
def cmd_setnx(server, ctx, args):
    return 1 if _bucket(server, _s(args[0])).try_set(bytes(args[1])) else 0


@register("SETEX")
def cmd_setex(server, ctx, args):
    ttl = _int(args[1])
    if ttl <= 0:
        raise RespError("ERR invalid expire time in 'setex' command")
    _bucket(server, _s(args[0])).set(bytes(args[2]), ttl=float(ttl))
    return "+OK"


@register("PSETEX")
def cmd_psetex(server, ctx, args):
    ttl = _int(args[1])
    if ttl <= 0:
        raise RespError("ERR invalid expire time in 'psetex' command")
    _bucket(server, _s(args[0])).set(bytes(args[2]), ttl=ttl / 1000.0)
    return "+OK"


@register("GETEX")
def cmd_getex(server, ctx, args):
    name = _s(args[0])
    # parse the FULL option list before touching state: a trailing syntax
    # error must leave the TTL unchanged (Redis validates then applies)
    actions = []
    i = 1
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"EX":
            actions.append(lambda n=name, s=_int(args[i + 1]): server.engine.store.expire(n, time.time() + s))
            i += 2
        elif opt == b"PX":
            actions.append(lambda n=name, ms=_int(args[i + 1]): server.engine.store.expire(n, time.time() + ms / 1000.0))
            i += 2
        elif opt == b"EXAT":
            actions.append(lambda n=name, at=float(_int(args[i + 1])): server.engine.store.expire(n, at))
            i += 2
        elif opt == b"PXAT":
            actions.append(lambda n=name, at=_int(args[i + 1]) / 1000.0: server.engine.store.expire(n, at))
            i += 2
        elif opt == b"PERSIST":
            actions.append(lambda n=name: server.engine.store.expire(n, None))
            i += 1
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    with server.engine.locked(name):
        v = _bucket(server, name).get()
        if v is None:
            return None
        for act in actions:
            act()
        return v


@register("GETRANGE")
def cmd_getrange(server, ctx, args):
    v = _bucket(server, _s(args[0])).get()
    if v is None:
        return b""
    data = bytes(v)
    from redisson_tpu_torch.client.objects.scoredsortedset import _norm_range

    lo, hi = _norm_range(_int(args[1]), _int(args[2]), len(data))
    return data[lo : hi + 1] if hi >= lo else b""


@register("SETRANGE")
def cmd_setrange(server, ctx, args):
    name = _s(args[0])
    off = _int(args[1])
    if off < 0:
        raise RespError("ERR offset is out of range")
    patch = bytes(args[2])
    with server.engine.locked(name):
        b = _bucket(server, name)
        cur = bytearray(bytes(b.get() or b""))
        if len(cur) < off + len(patch):
            cur.extend(b"\x00" * (off + len(patch) - len(cur)))
        cur[off : off + len(patch)] = patch
        b.set(bytes(cur))
        return len(cur)


@register("INCRBYFLOAT")
def cmd_incrbyfloat(server, ctx, args):
    name = _s(args[0])
    with server.engine.locked(name):
        b = _bucket(server, name)
        cur = b.get()
        try:
            new = (float(cur) if cur is not None else 0.0) + float(args[1])
        except ValueError:
            raise RespError("ERR value is not a valid float")
        b.set(_fnum(new))
        return _fnum(new)


@register("DECRBY")
def cmd_decrby(server, ctx, args):
    from redisson_tpu_torch.client.objects.bucket import AtomicLong

    return AtomicLong(server.engine, _s(args[0])).add_and_get(-_int(args[1]))


@register("MSETNX")
def cmd_msetnx(server, ctx, args):
    # all-or-nothing: every key must be absent (Redis MSETNX contract)
    names = [_s(args[i]) for i in range(0, len(args) - 1, 2)]
    with server.engine.locked_many(names):
        if any(server.engine.store.exists(n) for n in names):
            return 0
        for i in range(0, len(args) - 1, 2):
            _bucket(server, _s(args[i])).set(bytes(args[i + 1]))
        return 1


@register("EXPIREAT")
def cmd_expireat(server, ctx, args):
    return _expire_locked(server, _s(args[0]), float(_int(args[1])))


@register("PEXPIREAT")
def cmd_pexpireat(server, ctx, args):
    return _expire_locked(server, _s(args[0]), _int(args[1]) / 1000.0)


def _expiretime(server, name: str, ms: bool):
    if not server.engine.store.exists(name):
        return -2
    ttl = server.engine.store.ttl(name)
    if ttl is None:
        return -1
    at = time.time() + ttl
    return int(at * 1000) if ms else int(at)


@register("EXPIRETIME")
def cmd_expiretime(server, ctx, args):
    return _expiretime(server, _s(args[0]), ms=False)


@register("PEXPIRETIME")
def cmd_pexpiretime(server, ctx, args):
    return _expiretime(server, _s(args[0]), ms=True)


@register("RANDOMKEY")
def cmd_randomkey(server, ctx, args):
    import random

    ks = list(server.engine.store.keys())
    return random.choice(ks).encode() if ks else None


@register("TOUCH")
def cmd_touch(server, ctx, args):
    return sum(1 for k in args if server.engine.store.exists(_s(k)))


@register("SCAN")
def cmd_scan(server, ctx, args):
    pattern, count, _ = _scan_opts(args, 1)
    ks = sorted(server.engine.store.keys(pattern))
    return _scan_page([k.encode() for k in ks], _int(args[0]), count)


