"""RESP command streams over the port's verb families, and the means to
hold two servers' replies to them against each other.

``mixed_stream(seed, scale)`` builds the stream from a seed (numpy): bloom
filters (reserve, coalescible BF.MADD64 / BF.MEXISTS64 runs, the per-key
and multi-key verbs, BF.INFO), a bloom bank (BFA.*), HyperLogLogs (PFADD,
PFADD64, PFCOUNT, PFMERGE) and an HLL bank (HLLA.*), bit sets (config 5's
SETBITSB and BITOP OR/XOR, SETBIT, GETBIT, BITCOUNT, GETBITS(B),
BITFIELD), strings, counters and hashes, the connection verbs, an unknown
verb and a wrong-arity call.  ``scale`` multiplies the key counts.

``collections_stream(seed, scale)`` reaches every set, list, sorted-set
and hash-extra verb, the multi-pops and the blocking verbs (timed-out and
served), RENAMENX, BITPOS and SORT, with their error replies, and the
keyspace verbs (TYPE, KEYS, SCAN, EXPIRE, RENAME, DEL) over those records.

``replies(host, port, waves)`` sends each wave as one pipelined write on
one connection and returns, per wave, the raw reply bytes and the parsed
replies; ``reply_spans(raw)`` splits a wave's raw bytes reply by reply.
``compare(cmds, got, want)`` lists the replies that differ, holding
PFCOUNT to the PFCOUNT contract (``ops/hll.py``: the integers may differ by
one more than the float32 tolerance, 1e-6 of the estimate or m * 2**-20 in
linear counting) and the float64 blobs of HLLA.ESTIMATE / HLLA.ESTPAIRS to
that tolerance, and the verbs whose replies are unordered or random to
their contracts (``UNORDERED_VERBS``, ``RANDOM_VERBS``): SMEMBERS, SINTER,
SUNION and SDIFF reply the same members as a multiset; SPOP, SRANDMEMBER,
HRANDFIELD and ZRANDMEMBER reply members of the stored set (with their
stored values or scores), distinct for a positive count and at most that
many, exactly |count| of them for a negative one, nil or empty when the
key holds nothing.  Every other reply must be equal.

Run both servers on the same stream, e.g. a card server against a CPU one::

    waves = [stream, [("HELLO", "3")] + stream]
    want = replies(cpu_host, cpu_port, waves)
    got = replies(card_host, card_port, waves)
"""
from __future__ import annotations

import socket
from typing import List, Sequence, Tuple

import numpy as np

from redisson_tpu_torch.net import resp

# verbs whose replies are held to the HLL estimator's contract, not to bytes
ESTIMATE_VERBS = frozenset((b"PFCOUNT", b"HLLA.ESTIMATE", b"HLLA.ESTPAIRS"))
# verbs that reply a Python set's members (order is the set's) and verbs
# that draw from `random`: held to their contracts, not to bytes
UNORDERED_VERBS = frozenset((b"SMEMBERS", b"SINTER", b"SUNION", b"SDIFF"))
RANDOM_VERBS = frozenset((b"SPOP", b"SRANDMEMBER", b"HRANDFIELD", b"ZRANDMEMBER"))
HLL_M = 1 << 14  # the registers of a counter at the default p = 14
EST_RTOL = 1e-6


def _i8(a) -> bytes:
    return np.ascontiguousarray(a, "<i8").tobytes()


def _i4(a) -> bytes:
    return np.ascontiguousarray(a, "<i4").tobytes()


def mixed_stream(seed: int = 0, scale: int = 1, estimates: bool = False) -> List[tuple]:
    """The command stream.  With ``estimates``, it also asks HLLA.ESTIMATE
    and HLLA.ESTPAIRS and a PFCOUNT past 1e5 distinct keys, whose replies
    only the contract (``compare``) holds equal."""
    rng = np.random.default_rng(seed)
    n = 64 * scale
    cmds: List[tuple] = [
        ("PING",), ("PING", "hello"), ("ECHO", "echo"), ("SELECT", "0"),
        ("CLIENT", "SETNAME", "mixed"), ("CLIENT", "GETNAME"),
    ]
    # bloom filters of one geometry: runs of BF.MADD64 and BF.MEXISTS64 fuse
    filters = [f"bf:{i}" for i in range(6)]
    cmds += [("BF.RESERVE", f, "0.01", str(40 * n)) for f in filters]
    added = {f: rng.integers(-2**62, 2**62, n) for f in filters}
    cmds += [("BF.MADD64", f, _i8(added[f])) for f in filters]
    for f in filters:
        probe = np.concatenate([added[f][: n // 2], rng.integers(-2**62, 2**62, n // 2)])
        cmds.append(("BF.MEXISTS64", f, _i8(probe)))
    cmds += [
        ("BF.ADD", "bf:0", "alpha"), ("BF.ADD", "bf:0", "alpha"),
        ("BF.MADD", "bf:0", "beta", "gamma", "alpha"),
        ("BF.EXISTS", "bf:0", "beta"), ("BF.EXISTS", "bf:0", "absent"),
        ("BF.MEXISTS", "bf:0", "gamma", "delta"), ("BF.INFO", "bf:0"),
        ("BF.MEXISTS64", "bf:none", _i8([1, 2])),
    ]
    # a bloom bank
    tenants = 16
    t = rng.integers(0, tenants, 4 * n)
    k = rng.integers(-2**62, 2**62, 4 * n)
    cmds += [
        ("BFA.RESERVE", "bfa", str(tenants), str(20 * n), "0.01"),
        ("BFA.MADD64", "bfa", _i4(t), _i8(k)),
        ("BFA.MEXISTS64", "bfa", _i4(t), _i8(np.concatenate([k[: 2 * n], k[2 * n:] + 1]))),
        ("BFA.MEXISTS64", "bfa", _i4([]), _i8([])),
    ]
    # HyperLogLogs, below 1e5 distinct: PFCOUNT replies are identical
    words = [f"w{i}" for i in range(3 * n)]
    cmds += [
        ("PFADD", "hll:1", *words[: 2 * n]), ("PFADD", "hll:2", *words[n:]),
        ("PFADD", "hll:1", *words[:8]), ("PFADD", "hll:empty"),
        ("PFCOUNT", "hll:1"), ("PFCOUNT", "hll:1", "hll:2"),
        ("PFMERGE", "hll:3", "hll:1", "hll:2"), ("PFCOUNT", "hll:3"),
        ("PFADD64", "hll:4", _i8(rng.integers(0, 2**40, 20 * n))), ("PFCOUNT", "hll:4"),
    ]
    # an HLL bank
    ht = rng.integers(0, 32, 16 * n)
    hk = rng.integers(-2**62, 2**62, 16 * n)
    cmds += [
        ("HLLA.RESERVE", "hlla", "32"),
        ("HLLA.MADD64", "hlla", _i4(ht), _i8(hk)),
        ("HLLA.MERGEROWS", "hlla", _i4([0, 1, 2]), _i4([3, 4, 5])),
    ]
    # bit sets: config 5's SETBITSB twice a tenant, then BITOP OR/XOR
    bitsets = [f"bits:{i}" for i in range(4)]
    for b in bitsets:
        for _ in range(2):
            cmds.append(("SETBITSB", b, _i4(rng.integers(0, 10_000, 500))))
    cmds += [
        ("BITOP", "OR", "bits:or", *bitsets), ("BITOP", "XOR", "bits:xor", *bitsets),
        ("BITOP", "AND", "bits:and", *bitsets[:2]), ("BITOP", "NOT", "bits:not", "bits:0"),
        ("BITCOUNT", "bits:or"), ("BITCOUNT", "bits:xor"), ("BITCOUNT", "bits:none"),
        ("SETBIT", "bits:s", "7", "1"), ("SETBIT", "bits:s", "7", "0"),
        ("SETBIT", "bits:s", "70", "1"), ("GETBIT", "bits:s", "70"), ("GETBIT", "bits:s", "3"),
        ("SETBITS", "bits:s", "1", "2", "3"), ("GETBITS", "bits:s", "0", "1", "2", "3", "4"),
        ("GETBITSB", "bits:0", _i4(rng.integers(0, 10_000, 8 * n))),
        ("GETBITSB", "bits:or", _i4(rng.integers(0, 10_000, 8 * n))),
        ("BITFIELD", "bits:f", "SET", "u8", "0", "200", "GET", "u8", "0",
         "INCRBY", "u8", "0", "100", "OVERFLOW", "SAT", "INCRBY", "i8", "8", "200",
         "OVERFLOW", "FAIL", "INCRBY", "u4", "#5", "40", "GET", "i4", "#1"),
        ("BITFIELD_RO", "bits:f", "GET", "u8", "0", "GET", "i16", "4"),
    ]
    # strings, counters, hashes, the keyspace
    cmds += [
        ("SET", "k1", "v1"), ("GET", "k1"), ("GET", "missing"),
        ("SET", "k2", "v2", "NX"), ("SET", "k2", "v3", "XX"), ("GET", "k2"),
        ("INCR", "ctr"), ("INCRBY", "ctr", "41"), ("DECR", "ctr"),
        ("MSET", "m1", "a", "m2", "b"), ("MGET", "m1", "m2", "missing"),
        ("APPEND", "m1", "cd"), ("STRLEN", "m1"), ("GETRANGE", "m1", "1", "-1"),
        ("HSET", "h1", "f1", "v1", "f2", "v2"), ("HGET", "h1", "f2"), ("HGETALL", "h1"),
        ("HLEN", "h1"), ("HEXISTS", "h1", "f9"), ("HDEL", "h1", "f1"), ("HKEYS", "h1"),
        ("TYPE", "ctr"), ("TYPE", "bf:0"), ("TYPE", "hll:1"), ("TYPE", "bits:s"),
        ("TYPE", "h1"), ("TYPE", "missing"),
        ("EXISTS", "k1", "ctr", "missing"), ("RENAME", "ctr", "ctr2"),
        ("RENAME", "nothing", "x"), ("DEL", "k1", "missing"), ("EXISTS", "k1"),
        ("PTTL", "k2"), ("TTL", "missing"),
        ("TOTALLY-BOGUS-CMD", "x"), ("GET",),
    ]
    if estimates:
        cmds += [
            ("HLLA.ESTIMATE", "hlla"),
            ("HLLA.ESTPAIRS", "hlla", _i4(rng.integers(0, 32, 40)), _i4(rng.integers(0, 32, 40))),
            ("PFADD64", "hll:big", _i8(np.arange(400_000 * scale))), ("PFCOUNT", "hll:big"),
            ("PFCOUNT", "hll:big", "hll:4"),
        ]
    return cmds



def collections_stream(seed: int = 0, scale: int = 1) -> List[tuple]:
    """The collections stream (see the module docstring); ``scale``
    multiplies the member counts."""
    rng = np.random.default_rng(seed)
    n = 16 * scale

    def words(prefix, k):
        return [f"{prefix}{int(i)}" for i in rng.permutation(10 * k)[:k]]

    def scores(k):
        return [str(float(x)) for x in np.round(rng.normal(0, 50, k), 1)]

    a, b, c = words("m", 2 * n), words("m", 2 * n), words("m", n)
    cmds: List[tuple] = [
        # sets
        ("SADD", "s:a", *a), ("SADD", "s:a", *a[:4], "extra"), ("SADD", "s:b", *b), ("SADD", "s:c", *c),
        ("SREM", "s:a", a[0], "absent"), ("SISMEMBER", "s:a", a[1]), ("SISMEMBER", "s:a", a[0]),
        ("SCARD", "s:a"), ("SCARD", "s:none"), ("SMEMBERS", "s:a"), ("SMEMBERS", "s:none"),
        ("SMISMEMBER", "s:a", a[0], a[1], "absent"),
        ("SINTER", "s:a", "s:b"), ("SUNION", "s:a", "s:b", "s:c"), ("SDIFF", "s:a", "s:b"),
        ("SINTERSTORE", "s:i", "s:a", "s:b"), ("SUNIONSTORE", "s:u", "s:a", "s:c"),
        ("SDIFFSTORE", "s:d", "s:a", "s:c"), ("SCARD", "s:i"), ("SCARD", "s:u"), ("SMEMBERS", "s:d"),
        ("SINTERCARD", "2", "s:a", "s:b"), ("SINTERCARD", "2", "s:a", "s:b", "LIMIT", "1"),
        ("SINTERCARD", "2", "s:a", "s:b", "LIMIT", "-1"), ("SINTERCARD", "2", "s:a", "s:b", "BOGUS", "1"),
        ("SMOVE", "s:a", "s:c", a[2]), ("SMOVE", "s:a", "s:c", "absent"), ("SISMEMBER", "s:c", a[2]),
        ("SSCAN", "s:a", "0"), ("SSCAN", "s:a", "0", "COUNT", "5", "MATCH", "m1*"),
        ("SSCAN", "s:a", "5", "COUNT", "100"), ("SSCAN", "s:a", "0", "BOGUS"),
        ("SRANDMEMBER", "s:b"), ("SRANDMEMBER", "s:b", "5"), ("SRANDMEMBER", "s:b", "-7"),
        ("SRANDMEMBER", "s:b", str(10 * n)), ("SRANDMEMBER", "s:none"), ("SRANDMEMBER", "s:none", "-3"),
        ("SADD", "s:pop", *c), ("SPOP", "s:pop"), ("SPOP", "s:pop", "3"), ("SCARD", "s:pop"),
        ("SPOP", "s:pop", str(10 * n)), ("SCARD", "s:pop"), ("SPOP", "s:none"),
        # lists
        ("RPUSH", "l:a", *a[:n]), ("LPUSH", "l:a", "h1", "h2"), ("LLEN", "l:a"), ("LRANGE", "l:a", "0", "-1"),
        ("LRANGE", "l:a", "-3", "-1"), ("LRANGE", "l:a", "5", "2"), ("LINDEX", "l:a", "0"),
        ("LINDEX", "l:a", "-1"), ("LINDEX", "l:a", "999"), ("LPOP", "l:a"), ("RPOP", "l:a"),
        ("LPOP", "l:none"), ("LPUSHX", "l:a", "x1", "x2"), ("RPUSHX", "l:a", "y1"), ("LPUSHX", "l:none", "z"),
        ("RPUSHX", "l:none", "z"), ("LSET", "l:a", "1", "set1"), ("LSET", "l:a", "-1", "setlast"),
        ("LSET", "l:a", "999", "x"), ("LSET", "l:none", "0", "x"),
        ("LINSERT", "l:a", "BEFORE", "set1", "ins-b"), ("LINSERT", "l:a", "AFTER", "set1", "ins-a"),
        ("LINSERT", "l:a", "AFTER", "absent", "x"), ("LINSERT", "l:a", "MIDDLE", "set1", "x"),
        ("LINSERT", "l:none", "BEFORE", "p", "x"),
        ("RPUSH", "l:r", "v", "w", "v", "x", "v", "w", "v"), ("LREM", "l:r", "2", "v"),
        ("LREM", "l:r", "-1", "v"), ("LREM", "l:r", "0", "w"), ("LRANGE", "l:r", "0", "-1"),
        ("LREM", "l:none", "0", "v"),
        ("RPUSH", "l:p", "a", "b", "c", "b", "d", "b"), ("LPOS", "l:p", "b"), ("LPOS", "l:p", "b", "RANK", "2"),
        ("LPOS", "l:p", "b", "RANK", "-1"), ("LPOS", "l:p", "b", "COUNT", "0"),
        ("LPOS", "l:p", "b", "COUNT", "2", "RANK", "2"), ("LPOS", "l:p", "zz"), ("LPOS", "l:p", "zz", "COUNT", "0"),
        ("LPOS", "l:p", "b", "RANK", "0"), ("LPOS", "l:p", "b", "BOGUS", "1"), ("LPOS", "l:none", "b"),
        ("LTRIM", "l:a", "1", "-2"), ("LRANGE", "l:a", "0", "-1"), ("LTRIM", "l:none", "0", "1"),
        ("LMOVE", "l:a", "l:b", "LEFT", "RIGHT"), ("LMOVE", "l:a", "l:b", "RIGHT", "LEFT"),
        ("LMOVE", "l:a", "l:b", "UP", "LEFT"), ("LMOVE", "l:none", "l:b", "LEFT", "LEFT"),
        ("RPOPLPUSH", "l:a", "l:b"), ("RPOPLPUSH", "l:none", "l:b"), ("LRANGE", "l:b", "0", "-1"),
        ("LMPOP", "2", "l:none", "l:b", "LEFT"), ("LMPOP", "2", "l:none", "l:b", "RIGHT", "COUNT", "2"),
        ("LMPOP", "1", "l:none", "LEFT"), ("LMPOP", "0", "l:b", "LEFT"), ("LMPOP", "1", "l:b", "MIDDLE"),
        ("LMPOP", "1", "l:b", "LEFT", "COUNT"), ("LMPOP", "5", "l:b", "LEFT"),
        # blocking verbs, each once served and once timed out
        ("BLPOP", "l:none", "l:a", "0.05"), ("BRPOP", "l:a", "0.05"), ("BLPOP", "l:none", "0.05"),
        ("BRPOP", "l:none", "l:none2", "0.02"),
        ("BLMOVE", "l:a", "l:c", "LEFT", "LEFT", "0.05"), ("BLMOVE", "l:none", "l:c", "LEFT", "RIGHT", "0.02"),
        ("BLMOVE", "l:a", "l:c", "LEFT", "SIDEWAYS", "0.02"),
        ("BRPOPLPUSH", "l:a", "l:c", "0.05"), ("BRPOPLPUSH", "l:none", "l:c", "0.02"),
        ("LRANGE", "l:c", "0", "-1"),
        ("BLMPOP", "0.05", "2", "l:none", "l:a", "LEFT", "COUNT", "2"), ("BLMPOP", "0.02", "1", "l:none", "RIGHT"),
        ("BLMPOP", "nan", "1", "l:a", "LEFT"), ("BLMPOP", "-1", "1", "l:a", "LEFT"),
        ("BLMPOP", "0.1", "0", "l:a", "LEFT"), ("BLMPOP", "0.1", "3", "l:a", "LEFT"), ("BLMPOP", "0.1", "1"),
        # hash extras
        ("HSET", "h:a", *[x for i in range(n) for x in (f"f{i}", str(i * 3))]),
        ("HSETNX", "h:a", "f0", "no"), ("HSETNX", "h:a", "new", "yes"), ("HGET", "h:a", "new"),
        ("HINCRBY", "h:a", "f1", "10"), ("HINCRBY", "h:a", "cnt", "-4"), ("HINCRBY", "h:a", "new", "1"),
        ("HINCRBY", "h:a", "f1", "x"), ("HINCRBYFLOAT", "h:a", "f2", "1.5"), ("HINCRBYFLOAT", "h:a", "fl", "2"),
        ("HINCRBYFLOAT", "h:a", "fl", "0.25"), ("HINCRBYFLOAT", "h:a", "new", "1"),
        ("HSTRLEN", "h:a", "new"), ("HSTRLEN", "h:a", "absent"),
        ("HSCAN", "h:a", "0"), ("HSCAN", "h:a", "0", "MATCH", "f1*", "COUNT", "50"),
        ("HSCAN", "h:a", "0", "NOVALUES", "COUNT", "3"), ("HSCAN", "h:none", "0"),
        ("HSET", "h:r", *[x for i in range(8) for x in (f"r{i}", f"v{i}")]),
        ("HRANDFIELD", "h:r"), ("HRANDFIELD", "h:r", "3"), ("HRANDFIELD", "h:r", "-5", "WITHVALUES"),
        ("HRANDFIELD", "h:r", "20", "WITHVALUES"), ("HRANDFIELD", "h:none"), ("HRANDFIELD", "h:none", "2"),
    ]
    zm = words("z", 3 * n)
    zs = scores(3 * n)
    cmds += [
        # sorted sets
        ("ZADD", "z:a", *[x for m, sc in zip(zm[:2 * n], zs) for x in (sc, m)]),
        ("ZADD", "z:a", "1", "tie-b", "1", "tie-a", "1", "tie-c", "99.5", "top", "-99.5", "bottom"),
        ("ZADD", "z:inf", "inf", "top", "-inf", "bottom", "0", "mid"), ("ZSCORE", "z:inf", "top"),
        ("ZRANGE", "z:inf", "0", "-1"), ("ZRANGE", "z:inf", "0", "-1", "WITHSCORES"), ("ZRANK", "z:inf", "mid"),
        ("ZMSCORE", "z:inf", "bottom", "mid"), ("ZCOUNT", "z:inf", "-inf", "(0"),
        ("ZADD", "z:b", *[x for m, sc in zip(zm[n:], zs[n:]) for x in (sc, m)]),
        ("ZADD", "z:a", "notafloat", "m"), ("ZADD", "z:a", "1"),
        ("ZCARD", "z:a"), ("ZCARD", "z:none"), ("ZSCORE", "z:a", zm[0]), ("ZSCORE", "z:a", "top"),
        ("ZSCORE", "z:a", "absent"), ("ZRANK", "z:a", "tie-b"), ("ZRANK", "z:a", "absent"),
        ("ZREVRANK", "z:a", "tie-b"), ("ZREVRANK", "z:a", "top"),
        ("ZINCRBY", "z:a", "2.5", "tie-a"), ("ZINCRBY", "z:a", "-1", "new"), ("ZINCRBY", "z:a", "0.1", "tie-c"),
        ("ZRANGE", "z:a", "0", "-1"), ("ZRANGE", "z:a", "0", "4", "WITHSCORES"), ("ZRANGE", "z:a", "-3", "-1"),
        ("ZRANGE", "z:none", "0", "-1"), ("ZREVRANGE", "z:a", "0", "9", "WITHSCORES"),
        ("ZREVRANGE", "z:a", "-2", "-1"), ("ZREVRANGE", "z:a", "5", "1"),
        ("ZCOUNT", "z:a", "-inf", "+inf"), ("ZCOUNT", "z:a", "(0", "50"), ("ZCOUNT", "z:a", "1", "1"),
        ("ZRANGEBYSCORE", "z:a", "-inf", "+inf"), ("ZRANGEBYSCORE", "z:a", "(0", "40", "WITHSCORES"),
        ("ZRANGEBYSCORE", "z:a", "-100", "100", "LIMIT", "2", "5"),
        ("ZRANGEBYSCORE", "z:a", "-100", "100", "LIMIT", "3", "-1", "WITHSCORES"),
        ("ZRANGEBYSCORE", "z:a", "0", "1", "BOGUS"),
        ("ZREVRANGEBYSCORE", "z:a", "+inf", "-inf", "WITHSCORES"), ("ZREVRANGEBYSCORE", "z:a", "50", "(0"),
        ("ZMSCORE", "z:a", "top", "absent", zm[1]), ("ZMSCORE", "z:none", "x"),
        ("ZPOPMIN", "z:a"), ("ZPOPMAX", "z:a", "2"), ("ZPOPMIN", "z:none"),
        ("ZRANDMEMBER", "z:b"), ("ZRANDMEMBER", "z:b", "4"), ("ZRANDMEMBER", "z:b", "-6", "WITHSCORES"),
        ("ZRANDMEMBER", "z:b", str(20 * n), "WITHSCORES"), ("ZRANDMEMBER", "z:none"),
        ("ZSCAN", "z:a", "0"), ("ZSCAN", "z:a", "0", "MATCH", "z1*", "COUNT", "100"),
        ("ZUNIONSTORE", "z:u", "2", "z:a", "z:b"),
        ("ZUNIONSTORE", "z:uw", "2", "z:a", "z:b", "WEIGHTS", "2", "0.5", "AGGREGATE", "MAX"),
        ("ZINTERSTORE", "z:i", "2", "z:a", "z:b", "AGGREGATE", "MIN"),
        ("ZUNIONSTORE", "z:x", "2", "z:a", "z:b", "AGGREGATE", "AVG"),
        ("ZRANGE", "z:u", "0", "-1", "WITHSCORES"), ("ZRANGE", "z:uw", "0", "-1", "WITHSCORES"),
        ("ZRANGE", "z:i", "0", "-1", "WITHSCORES"),
        ("ZUNION", "2", "z:a", "z:b", "WITHSCORES"), ("ZINTER", "2", "z:a", "z:b", "WEIGHTS", "1", "3"),
        ("ZDIFF", "2", "z:a", "z:b"), ("ZDIFF", "2", "z:a", "z:b", "WITHSCORES"),
        ("ZDIFF", "2", "z:a", "z:b", "WEIGHTS", "1", "1"), ("ZUNION", "0", "z:a"), ("ZINTER", "3", "z:a"),
        ("ZINTERCARD", "2", "z:a", "z:b"), ("ZINTERCARD", "2", "z:a", "z:b", "LIMIT", "2"),
        ("ZINTERCARD", "2", "z:a", "z:b", "LIMIT", "-2"),
        ("ZDIFFSTORE", "z:d", "2", "z:a", "z:b"), ("ZCARD", "z:d"),
        ("ZRANGESTORE", "z:r1", "z:a", "0", "5"), ("ZRANGESTORE", "z:r2", "z:a", "(0", "50", "BYSCORE", "LIMIT", "1", "3"),
        ("ZRANGESTORE", "z:r3", "z:a", "50", "-50", "BYSCORE", "REV"),
        ("ZRANGESTORE", "z:r4", "z:a", "0", "5", "LIMIT", "0", "1"),
        ("ZRANGE", "z:r2", "0", "-1", "WITHSCORES"), ("ZRANGE", "z:r3", "0", "-1"),
        ("ZADD", "z:lex", *[x for m in "abcdefg" for x in ("0", m)]),
        ("ZLEXCOUNT", "z:lex", "-", "+"), ("ZLEXCOUNT", "z:lex", "[b", "(f"), ("ZLEXCOUNT", "z:lex", "+", "-"),
        ("ZRANGEBYLEX", "z:lex", "(a", "[d"), ("ZRANGEBYLEX", "z:lex", "-", "+", "LIMIT", "1", "2"),
        ("ZRANGEBYLEX", "z:lex", "b", "d"), ("ZREVRANGEBYLEX", "z:lex", "[e", "-"),
        ("ZREVRANGEBYLEX", "z:lex", "+", "(b", "LIMIT", "0", "3"),
        ("ZRANGESTORE", "z:r5", "z:lex", "[b", "[e", "BYLEX"), ("ZRANGE", "z:r5", "0", "-1"),
        ("ZREMRANGEBYLEX", "z:lex", "[a", "(c"), ("ZRANGE", "z:lex", "0", "-1"),
        ("ZREMRANGEBYSCORE", "z:b", "-inf", "(0"), ("ZREMRANGEBYRANK", "z:b", "0", "1"),
        ("ZREMRANGEBYRANK", "z:b", "-2", "-1"), ("ZRANGE", "z:b", "0", "-1", "WITHSCORES"),
        ("ZREM", "z:a", "top", "bottom", "absent"),
        ("ZMPOP", "2", "z:none", "z:a", "MIN"), ("ZMPOP", "1", "z:a", "MAX", "COUNT", "3"),
        ("ZMPOP", "1", "z:none", "MIN"), ("ZMPOP", "1", "z:a", "MEDIAN"), ("ZMPOP", "-1", "z:a", "MIN"),
        ("BZPOPMIN", "z:none", "z:a", "0.05"), ("BZPOPMAX", "z:a", "0.05"), ("BZPOPMIN", "z:none", "0.02"),
        ("BZPOPMAX", "z:none", "0.02"),
        ("BZMPOP", "0.05", "1", "z:a", "MAX", "COUNT", "2"), ("BZMPOP", "0.02", "1", "z:none", "MIN"),
        ("BZMPOP", "inf", "1", "z:a", "MIN"), ("BZMPOP", "0.1", "2", "z:a", "MIN"),
        # RENAMENX, BITPOS, SORT, COPY
        ("RENAMENX", "s:i", "s:i2"), ("RENAMENX", "s:u", "s:c"), ("RENAMENX", "s:none", "x"),
        ("SETBIT", "bp", "5", "1"), ("SETBIT", "bp", "17", "1"), ("BITPOS", "bp", "1"), ("BITPOS", "bp", "0"),
        ("BITPOS", "bp", "1", "1"), ("BITPOS", "bp", "1", "0", "0"), ("BITPOS", "bp", "0", "0", "-1"),
        ("BITPOS", "bp", "2"), ("BITPOS", "bp", "1", "0", "1", "2"), ("BITPOS", "bp:none", "0"),
        ("RPUSH", "l:n", *[str(int(x)) for x in rng.integers(-100, 100, n)], "3.5"),
        ("SORT", "l:n"), ("SORT", "l:n", "DESC", "LIMIT", "1", "4"), ("SORT", "l:p", "ALPHA"),
        ("SORT", "l:p"), ("SORT", "s:c", "ALPHA", "DESC"), ("SORT", "l:n", "STORE", "l:sorted"),
        ("LRANGE", "l:sorted", "0", "-1"), ("SORT", "l:none"), ("SORT", "l:n", "BOGUS"),
        # wrong types and arities
        ("SADD", "l:a", "x"), ("LPUSH", "s:a", "x"), ("ZADD", "h:a", "1", "x"), ("HSETNX", "z:a", "f", "v"),
        ("SMEMBERS", "z:a"), ("LRANGE", "h:a", "0", "1"), ("SADD",), ("ZRANGE", "z:a"),
        # the keyspace over the new records
        ("TYPE", "s:a"), ("TYPE", "l:a"), ("TYPE", "z:a"), ("TYPE", "l:sorted"), ("TYPE", "h:a"),
        ("KEYS", "s:*"), ("KEYS", "z:r*"), ("SCAN", "0", "MATCH", "l:*", "COUNT", "100"),
        ("EXISTS", "s:a", "l:a", "z:a", "none"),
        ("EXPIRE", "l:p", "100"), ("TTL", "l:p"), ("PERSIST", "l:p"), ("TTL", "l:p"),
        ("RENAME", "z:d", "z:d2"), ("ZCARD", "z:d2"), ("DEL", "s:a", "l:a", "z:a", "h:a", "none"),
        ("EXISTS", "s:a", "l:a", "z:a", "h:a"), ("SCARD", "s:a"), ("LLEN", "l:a"),
    ]
    return cmds

def replies(host: str, port: int, waves: Sequence[Sequence[tuple]],
            timeout: float = 120.0) -> List[Tuple[bytes, list]]:
    """Send each wave as one pipelined write on one connection; return
    (raw reply bytes, parsed replies) per wave."""
    out = []
    with socket.create_connection((host, port), timeout=timeout) as s:
        parser = resp.RespParser(use_native=False)
        for wave in waves:
            s.sendall(resp.encode_commands(list(wave)))
            raw, got = [], []
            while len(got) < len(wave):
                data = s.recv(1 << 20)
                if not data:
                    raise ConnectionError("server closed the connection early")
                raw.append(data)
                got += parser.feed(data)
            out.append((b"".join(raw), got))
    return out



_LINE_TYPES = frozenset(b"+-:_#,(")
_BLOB_TYPES = frozenset(b"$!=")
_AGG_TYPES = frozenset(b"*~>")


def reply_spans(raw: bytes) -> List[bytes]:
    """Split a wave's raw reply bytes into one byte string a reply (RESP2
    and RESP3 frames; a RESP3 attribute counts with the reply it annotates).
    Bytes that stop inside a reply raise ValueError."""
    out, pos = [], 0

    def skip(p: int) -> int:
        t = raw[p]
        end = raw.index(b"\r\n", p)
        if t in _LINE_TYPES:
            return end + 2
        n = int(raw[p + 1:end])
        if t in _BLOB_TYPES:
            return end + 2 if n < 0 else end + 2 + n + 2
        if t in _AGG_TYPES or t == ord("%") or t == ord("|"):
            count = max(n, 0) * (2 if t in (ord("%"), ord("|")) else 1)
            p = end + 2
            for _ in range(count):
                p = skip(p)
            return skip(p) if t == ord("|") else p
        raise ValueError(f"unknown RESP type byte {chr(t)!r} at {p}")

    while pos < len(raw):
        nxt = skip(pos)
        if nxt > len(raw):
            raise ValueError("truncated reply")
        out.append(raw[pos:nxt])
        pos = nxt
    return out

def _verb(cmd) -> bytes:
    v = cmd[0]
    return (v if isinstance(v, bytes) else str(v).encode()).upper()


def _estimates_agree(verb: bytes, got, want) -> bool:
    if verb == b"PFCOUNT":
        if not (isinstance(got, int) and isinstance(want, int)):
            return got == want
        return abs(got - want) <= 1 + max(EST_RTOL * abs(want), HLL_M * 2.0**-20)
    if not (isinstance(got, bytes) and isinstance(want, bytes)) or len(got) != len(want):
        return got == want
    g = np.frombuffer(got, "<f8")
    w = np.frombuffer(want, "<f8")
    tol = np.maximum(EST_RTOL * np.abs(w), HLL_M * 2.0**-20)
    return bool((np.abs(g - w) <= tol).all())



def _b(x) -> bytes:
    return x if isinstance(x, bytes) else str(x).encode()


def _fnum(x: float) -> bytes:
    return (str(int(x)) if float(x) == int(x) else repr(float(x))).encode()


class _Stored:
    """What one server's set, hash and sorted-set writes left under each key
    (SADD/SREM, HSET/HDEL, ZADD/ZREM, DEL, and the members its own SPOP
    replies removed): the members the random verbs may draw."""

    def __init__(self):
        self.keys: dict = {}

    def apply(self, cmd, reply) -> None:
        verb, args = _verb(cmd), [_b(a) for a in cmd[1:]]
        if not args:
            return
        key = args[0]
        if verb == b"SPOP" and not isinstance(reply, resp.RespError):
            for m in reply if isinstance(reply, list) else [reply]:
                self.keys.get(key, {}).pop(m, None)
        if verb == b"SADD":
            self.keys.setdefault(key, {}).update(dict.fromkeys(args[1:]))
        elif verb == b"HSET" and len(args) % 2 == 1:
            self.keys.setdefault(key, {}).update(zip(args[1::2], args[2::2]))
        elif verb == b"ZADD" and len(args) % 2 == 1:
            try:
                pairs = [(m, _fnum(float(sc))) for sc, m in zip(args[1::2], args[2::2])]
            except (ValueError, OverflowError):  # the server refuses it, or
                return  # no random verb samples the key
            self.keys.setdefault(key, {}).update(pairs)
        elif verb in (b"SREM", b"HDEL", b"ZREM"):
            for m in args[1:]:
                self.keys.get(key, {}).pop(m, None)
        elif verb == b"DEL":
            for k in args:
                self.keys.pop(k, None)


def _drawn(verb: bytes, cmd, got, stored: dict) -> bool:
    """`got` holds the contract of a random verb over the stored members."""
    args = [_b(a) for a in cmd[1:]]
    if len(args) == 1:  # one member, or nil from an empty key
        return got is None if not stored else got in stored
    if not isinstance(got, list):
        return False
    count = int(args[1])
    with_values = len(args) > 2 and args[2].upper() in (b"WITHVALUES", b"WITHSCORES")
    if with_values:
        if len(got) % 2:
            return False
        picked = got[0::2]
        if any(stored.get(m) != v for m, v in zip(got[0::2], got[1::2])):
            return False
    else:
        picked = got
    if not all(m in stored for m in picked):
        return False
    if verb == b"SPOP" or count >= 0:
        return len(set(picked)) == len(picked) == min(abs(count), len(stored))
    return len(picked) == (-count if stored else 0)


def _multiset(x) -> list:
    return sorted(x) if isinstance(x, (list, set)) else x

def compare(cmds: Sequence[tuple], got: list, want: list) -> List[str]:
    """The replies of `got` that differ from `want` (one wave each), with
    the estimate, unordered and random verbs held to their contracts."""
    bad = []
    if len(got) != len(want):
        return [f"{len(got)} replies against {len(want)}"]
    stored_g, stored_w = _Stored(), _Stored()
    for i, (cmd, g, w) in enumerate(zip(cmds, got, want)):
        verb = _verb(cmd)
        if isinstance(w, resp.RespError):
            same = isinstance(g, resp.RespError) and g.args == w.args
        elif verb in ESTIMATE_VERBS:
            same = _estimates_agree(verb, g, w)
        elif verb in UNORDERED_VERBS:
            same = type(g) is type(w) and _multiset(g) == _multiset(w)
        elif verb in RANDOM_VERBS:
            key = _b(cmd[1])
            same = (type(g) is type(w) and _drawn(verb, cmd, g, stored_g.keys.get(key, {}))
                    and _drawn(verb, cmd, w, stored_w.keys.get(key, {})))
        else:
            same = type(g) is type(w) and g == w
        stored_g.apply(cmd, g)
        stored_w.apply(cmd, w)
        if not same:
            bad.append(f"#{i} {verb.decode()}: {g!r:.120} against {w!r:.120}")
    return bad
