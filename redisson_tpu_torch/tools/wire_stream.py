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

``objcall_stream(seed, scale)`` holds the generic object calls (OBJCALL,
OBJCALLM, OBJCALLMA, OBJCALLV) and the wire transactions (MULTI/EXEC with
WATCH, TXEXEC), each reply a pickle or a RESP value.

``services_stream(seed, scale, shas)`` returns two lists, the set-up and
the queries, over streams (X*: explicit IDs, consumer groups and the PEL,
a timed-out XREAD and XREADGROUP BLOCK, one ``XADD *``), geo sets (GEO*),
JSON documents (JSON.*), search indexes (FT.*: a FLAT COSINE index with
TEXT, TAG and NUMERIC fields and an IVF L2 index with a TAG field, KNN
plain, hybrid with a TAG filter and paged by a cursor, FT.MSEARCH, an
aggregation paged by FT.CURSOR, the aliases, synonyms, dictionaries,
FT.CONFIG, FT.SPELLCHECK, FT.INFO) and the script verbs (EVALSHA, SCRIPT,
FCALL, FCALL_RO, FUNCTION, EVAL) over the scripts and the function library
that ``load_scripts`` registers server-side (``shas`` is its reply).
``train_ivf(src, dst, index)`` trains the IVF banks of `index` on one
server's search service and installs them in the other's, so two servers
(two packages, or the card and the CPU, whose k-means may differ in the
last bits) score the same cells: call it between the set-up and the
queries.

``replies(host, port, waves)`` sends each wave as one pipelined write on
one connection and returns, per wave, the raw reply bytes and the parsed
replies; ``reply_spans(raw)`` splits a wave's raw bytes reply by reply.
``compare(cmds, got, want)`` lists the replies that differ, holding
PFCOUNT to the PFCOUNT contract (``ops/hll.py``: the integers may differ by
one more than the float32 tolerance, 1e-6 of the estimate or m * 2**-20 in
linear counting) and the float64 blobs of HLLA.ESTIMATE / HLLA.ESTPAIRS to
that tolerance, the clock's fields to their contracts (``CLOCK_VERBS``:
the ID that ``XADD *`` takes from the clock is an ID, ``<ms>-<seq>``; an
extended XPENDING row's idle milliseconds are the clock's, the row's
other fields equal), the KNN replies (``knn_agree``: FT.MSEARCH, and
FT.SEARCH with a KNN arm) to the search contract (ids equal outside
near-ties: where two distances lie within ``KNN_TIE`` of each other the
ids may trade places, and the last tied group may hold other ids of the
same distance; scores equal, except that two distances on either side of
a rounding boundary of the ``%.4f`` text differ by one in the last
digit), and the verbs whose replies are unordered or random to
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

import json
import re
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
# verbs with a field read from the clock (XADD *'s ID, XPENDING's idle ms)
CLOCK_VERBS = frozenset((b"XADD", b"XPENDING"))
# two KNN distances closer than this may trade places in a reply: the
# %.4f text's last digit, plus the float32 rounding of one distance
KNN_TIE = 1e-4 + 1e-6


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

def objcall_stream(seed: int = 0, scale: int = 1) -> List[tuple]:
    """Generic object calls and the wire transactions: OBJCALL on maps,
    buckets, counters, lists, sorted sets, bloom filters, HyperLogLogs,
    bit sets and a lock (two caller identities), with a codec frame, its
    error replies (unknown method, bad arguments, bad factory), an OBJCALLM
    and an OBJCALLMA batch with a failing op, OBJCALLV, MULTI/EXEC (plain,
    WATCH clean and aborted, EXECABORT, DISCARD, nesting, a blocking pop
    inside EXEC), RESET, and TXEXEC committed and refused (TXCONFLICT).
    Payloads are pickled as every client pickles them
    (``net/safe_pickle.dumps``: the reference's class names)."""
    from redisson_tpu_torch.client.codec import StringCodec
    from redisson_tpu_torch.net.safe_pickle import dumps as P

    rng = np.random.default_rng(seed)
    n = 16 * scale
    me, other = "c0ffee:1", "beef:2"

    def oc(factory, name, method, *args, caller=me, **kw):
        return ("OBJCALL", factory, name, method, P((args, kw)), caller)

    keys = [f"k{i}" for i in range(n)]
    vals = [int(v) for v in rng.integers(0, 1000, n)]
    ints = rng.integers(-2**62, 2**62, 4 * n)
    cmds: List[tuple] = [oc("get_map", "oc:m", "put", k, v) for k, v in zip(keys, vals)]
    cmds += [oc("get_map", "oc:m", "get", k) for k in keys[::3]]
    cmds += [oc("get_map", "oc:m", "read_all_map"), oc("get_map", "oc:m", "size"),
             oc("get_map", "oc:m", "remove", keys[0]), oc("get_map", "oc:m", "put_if_absent", keys[1], -1)]
    cmds += [oc("get_bucket", "oc:b", "set", {"a": [1, 2.5, "x"]}), oc("get_bucket", "oc:b", "get"),
             oc("get_bucket", "oc:b", "compare_and_set", {"a": [1, 2.5, "x"]}, "y"),
             oc("get_bucket", "oc:b", "get_and_delete")]
    cmds += [oc("get_atomic_long", "oc:al", "add_and_get", v) for v in vals[:4]]
    cmds += [oc("get_atomic_double", "oc:ad", "add_and_get", 0.25), oc("get_atomic_long", "oc:al", "get")]
    cmds += [oc("get_list", "oc:l", "add_all", vals), oc("get_list", "oc:l", "read_all"),
             oc("get_list", "oc:l", "get", 3), oc("get_list", "oc:l", "sub_list", 1, 4)]
    cmds += [oc("get_queue", "oc:q", "offer", v) for v in vals[:3]]
    cmds += [oc("get_queue", "oc:q", "poll"), oc("get_queue", "oc:q", "poll_many", 5)]
    cmds += [oc("get_scored_sorted_set", "oc:z", "add", float(v), k) for k, v in zip(keys, vals)]
    cmds += [oc("get_scored_sorted_set", "oc:z", "entry_range", 0, -1),
             oc("get_scored_sorted_set", "oc:z", "rank", keys[2])]
    # the sketches over OBJCALL: the typed handles' fallback route
    cmds += [oc("get_bloom_filter", "oc:bf", "try_init", 40 * n, 0.01),
             oc("get_bloom_filter", "oc:bf", "add_all", [f"e{i}" for i in range(n)]),
             oc("get_bloom_filter", "oc:bf", "add_each", ints[:n]),
             oc("get_bloom_filter", "oc:bf", "contains_each", ints[: 2 * n]),
             oc("get_bloom_filter", "oc:bf", "count_contains", [f"e{i}" for i in range(2 * n)]),
             oc("get_bloom_filter", "oc:bf", "get_size"),
             oc("get_hyper_log_log", "oc:h", "add_all", [f"h{i}" for i in range(3 * n)]),
             oc("get_hyper_log_log", "oc:h", "count"),
             oc("get_bit_set", "oc:bs", "set_each", rng.integers(0, 4096, n)),
             oc("get_bit_set", "oc:bs", "get_each", np.arange(64)),
             oc("get_bit_set", "oc:bs", "cardinality")]
    # a lock: the holder is the caller, so another caller is refused
    cmds += [oc("get_lock", "oc:lock", "try_lock"), oc("get_lock", "oc:lock", "try_lock", caller=other),
             oc("get_lock", "oc:lock", "is_held_by_current_thread"),
             oc("get_lock", "oc:lock", "get_hold_count"), oc("get_lock", "oc:lock", "unlock"),
             oc("get_lock", "oc:lock", "is_locked")]
    # the codec frame: a StringCodec map
    cmds += [oc("get_map", "oc:ms", "put", "a", "b") + (P(StringCodec()),),
             oc("get_map", "oc:ms", "get", "a") + (P(StringCodec()),),
             ("HGETALL", "oc:ms")]
    # error replies: unknown and private methods, bad arguments, bad factory
    cmds += [oc("get_map", "oc:m", "no_such_method"), oc("get_map", "oc:m", "_rec"),
             oc("get_map", "oc:m", "put"), oc("get_list", "oc:l", "get", 10**6),
             ("OBJCALL", "bad_factory", "x", "y", P(((), {})), me),
             ("OBJCALL", "get_nothing", "x", "y", P(((), {})), me),
             ("SET", "oc:str", "v"), oc("get_map", "oc:str", "get", "a")]
    ops = [("get_map", "oc:m", "get", (k,), {}) for k in keys[:4]]
    ops += [("get_map", "oc:m", "bogus", (), {}), ("get_atomic_long", "oc:al", "increment_and_get", (), {}),
            ("get_map", "oc:ms", "get", ("a",), {}, P(StringCodec()))]
    cmds += [("OBJCALLM", P(ops), me), ("OBJCALLMA", P(ops), me)]
    cmds += [("OBJCALLV", "get_map", "oc:m", "get", P(((keys[3],), {})), me),
             ("OBJCALLV", "get_bucket", "oc:absent", "get", P(((), {})), me)]
    # MULTI/EXEC
    cmds += [("MULTI",), ("INCRBY", "tx:a", "1"), ("INCR", "tx:a"), ("GET", "tx:a"), ("HSET", "oc:m", "f", "v"),
             ("SET", "tx:s", "v"), ("GET", "tx:s"), ("EXEC",)]
    cmds += [("WATCH", "tx:a"), ("MULTI",), ("INCR", "tx:a"), ("EXEC",)]
    cmds += [("WATCH", "tx:a"), ("INCR", "tx:a"), ("MULTI",), ("INCR", "tx:a"), ("EXEC",), ("GET", "tx:a")]
    cmds += [("WATCH", "tx:a"), ("UNWATCH",), ("INCR", "tx:a"), ("MULTI",), ("INCR", "tx:a"), ("EXEC",)]
    cmds += [("MULTI",), ("SET", "tx:b", "1"), ("NOSUCHVERB",), ("EXEC",), ("GET", "tx:b")]
    cmds += [("MULTI",), ("SET", "tx:c", "1"), ("DISCARD",), ("GET", "tx:c"), ("DISCARD",), ("EXEC",)]
    cmds += [("MULTI",), ("MULTI",), ("WATCH", "x"), ("BLPOP", "tx:none", "5"), ("LPUSH", "tx:l", "a"),
             ("EXEC",)]
    cmds += [("WATCH", "tx:a"), ("MULTI",), ("SET", "tx:d", "1"), ("RESET",), ("EXEC",)]
    # TXEXEC: committed on versions seen as absent, refused on a stale one
    tx_ops = [("get_bucket", "tx:bucket", "set", ("v1",), {}), ("get_map", "tx:map", "put", ("a", 1), {}),
              ("get_map", "oc:m", "bogus", (), {})]
    cmds += [("TXEXEC", P({"tx:bucket": 0, "tx:map": 0}), P(tx_ops), me),
             oc("get_bucket", "tx:bucket", "get"),
             ("TXEXEC", P({"tx:bucket": 0}), P(tx_ops[:1]), me),
             ("TXEXEC", P({}), P([("get_atomic_long", "tx:n", "increment_and_get", (), {})]), me)]
    return cmds


# -- the services stream: streams, geo, JSON, search and scripts ---------------

SCRIPT_LIBRARY = "wire_stream_lib"


def script_transfer(ctx, keys, args):
    """Move args[0] units from counter keys[0] to counter keys[1] when the
    source holds them; reply the destination's count, else 0."""
    n = int(args[0])
    src, dst = ctx.get_atomic_long(keys[0]), ctx.get_atomic_long(keys[1])
    if src.get() < n:
        return 0
    src.add_and_get(-n)
    return dst.add_and_get(n)


def script_map_fields(ctx, keys, args):
    """Put args as field/value pairs into map keys[0]; reply its fields."""
    m = ctx.get_map(keys[0])
    for f, v in zip(args[0::2], args[1::2]):
        m.put(bytes(f).decode(), bytes(v).decode())
    return [k.encode() for k in sorted(m.read_all_map())]


def function_sum(ctx, keys, args):
    """FCALL: the sum of the integer args."""
    return sum(int(a) for a in args)


def function_list_len(ctx, keys, args):
    """FCALL_RO: the length of list keys[0]."""
    return ctx.get_list(keys[0]).size()


def load_scripts(client) -> List[str]:
    """Register the stream's scripts and its function library on the
    embedded facade of a server's engine (either package's); the digests
    the stream's EVALSHA calls use."""
    shas = [client.get_script().script_load(f) for f in (script_transfer, script_map_fields)]
    client.get_function().load(
        SCRIPT_LIBRARY, {"fn_sum": function_sum, "fn_list_len": function_list_len}, replace=True
    )
    return shas


def train_ivf(src, dst, index: str) -> None:
    """Sync `index` on two servers' search services, train its IVF banks
    on `src` and install the centroids and assignments in `dst` (a sharded
    bank's shard by shard)."""
    src.sync(index)
    dst.sync(index)
    for field, bank in src._idx(index).vectors.banks.items():
        other = dst._idx(index).vectors.banks[field]
        for sb, db in zip(getattr(bank, "shards", [bank]), getattr(other, "shards", [other])):
            if sb._ivf is None or not sb.rows:
                continue
            sb.retrain()
            ivf, out = sb._ivf, db._ivf
            out.centroids, out.assign = ivf.centroids.copy(), ivf.assign.copy()
            out.trained_rows, out.trains = ivf.trained_rows, ivf.trains
            out.dirty_rows.clear()
            out.cells, out.cells_stale = None, True


def f32_blob(v) -> bytes:
    """A FLOAT32 vector field's bytes (little-endian), or Q stacked queries'."""
    return np.ascontiguousarray(v, "<f4").tobytes()


def services_stream(seed: int, scale: int, shas: Sequence[str]) -> Tuple[List[tuple], List[tuple]]:
    """(set-up, queries) over the streams, geo, JSON, search and script
    verbs; `scale` multiplies the entry, member and document counts; `shas`
    are ``load_scripts``' digests."""
    rng = np.random.default_rng(seed)
    dim = 16
    n = 24 * scale
    setup: List[tuple] = []
    q: List[tuple] = []
    # -- streams: explicit IDs (auto IDs come from the clock) -----------------
    for i in range(n):
        setup.append(("XADD", "st:a", f"{i + 1}-{i % 3}", "f", str(int(rng.integers(1000))), "g", f"v{i}"))
    setup += [("XADD", "st:a", "1-0", "f", "dup"), ("XADD", "st:a", "0-0", "f", "zero")]
    for i in range(12):
        setup.append(("XADD", "st:b", "MAXLEN", "~", "8", f"{100 + i}-1", "i", str(i)))
    setup += [("XADD", "st:none", "NOMKSTREAM", "5-1", "f", "v"), ("XADD", "st:auto", "*", "f", "v"),
              ("XGROUP", "CREATE", "st:a", "g1", "0"), ("XGROUP", "CREATE", "st:a", "g2", "$"),
              ("XGROUP", "CREATE", "st:a", "g1", "0")]
    mid = f"{n // 2}-{(n // 2 - 1) % 3}"
    q += [("XLEN", "st:a"), ("XLEN", "st:b"), ("XRANGE", "st:a", "-", "+", "COUNT", "5"),
          ("XRANGE", "st:a", "3", mid), ("XREVRANGE", "st:a", "+", "-", "COUNT", "4"),
          ("XREAD", "COUNT", "3", "STREAMS", "st:a", "st:b", "0", "105-1"),
          ("XREAD", "STREAMS", "st:b", "$"), ("XREAD", "BLOCK", "20", "STREAMS", "st:b", "999-1"),
          ("XREAD", "STREAMS", "st:a"),
          ("XREADGROUP", "GROUP", "g1", "c1", "COUNT", "4", "STREAMS", "st:a", ">"),
          ("XREADGROUP", "GROUP", "g1", "c2", "COUNT", "3", "STREAMS", "st:a", ">"),
          ("XREADGROUP", "GROUP", "g1", "c1", "STREAMS", "st:a", "0"),
          ("XREADGROUP", "GROUP", "g2", "c1", "BLOCK", "20", "STREAMS", "st:a", ">"),
          ("XREADGROUP", "GROUP", "nog", "c1", "STREAMS", "st:a", ">"),
          ("XACK", "st:a", "g1", "1-0", "2-1", "99-9"),
          ("XPENDING", "st:a", "g1"), ("XPENDING", "st:a", "g1", "-", "+", "10"),
          ("XPENDING", "st:a", "g1", "-", "+", "10", "c2"),
          ("XPENDING", "st:a", "g1", "IDLE", "3600000", "-", "+", "10"),
          ("XCLAIM", "st:a", "g1", "c3", "0", "3-2", "JUSTID"),
          ("XCLAIM", "st:a", "g1", "c3", "0", "4-0"),
          ("XAUTOCLAIM", "st:a", "g1", "c4", "0", "0", "COUNT", "2", "JUSTID"),
          ("XAUTOCLAIM", "st:a", "g1", "c4", "3600000", "0"),
          ("XINFO", "STREAM", "st:a"), ("XINFO", "GROUPS", "st:a"), ("XINFO", "CONSUMERS", "st:a", "g1"),
          ("XGROUP", "CREATECONSUMER", "st:a", "g1", "c9"), ("XGROUP", "DELCONSUMER", "st:a", "g1", "c9"),
          ("XGROUP", "SETID", "st:a", "g2", "0"),
          ("XREADGROUP", "GROUP", "g2", "c1", "COUNT", "2", "NOACK", "STREAMS", "st:a", ">"),
          ("XPENDING", "st:a", "g2"), ("XGROUP", "DESTROY", "st:a", "g2"),
          ("XDEL", "st:b", "104-1", "110-1", "1-1"), ("XTRIM", "st:b", "MAXLEN", "5"),
          ("XTRIM", "st:b", "MINID", "109-1"), ("XRANGE", "st:b", "-", "+"),
          ("XINFO", "STREAM", "st:none"), ("XADD", "st:a", "f"), ("XGROUP", "NOPE", "st:a"),
          ("XLEN", "st:auto")]
    # -- geo ------------------------------------------------------------------
    lon = rng.uniform(-20.0, 30.0, 2 * n)
    lat = rng.uniform(30.0, 60.0, 2 * n)
    geo = ["GEOADD", "geo:a"]
    for i in range(2 * n):
        geo += [f"{lon[i]:.6f}", f"{lat[i]:.6f}", f"p{i}"]
    setup += [tuple(geo), ("GEOADD", "geo:a", "13.361389", "38.115556", "Palermo",
                           "15.087269", "37.502669", "Catania"),
              ("GEOADD", "geo:bad", "200", "10", "x")]
    q += [("GEOPOS", "geo:a", "p0", "p3", "nosuch"), ("GEODIST", "geo:a", "Palermo", "Catania"),
          ("GEODIST", "geo:a", "Palermo", "Catania", "km"), ("GEODIST", "geo:a", "p1", "p2", "mi"),
          ("GEODIST", "geo:a", "p1", "p2", "ft"), ("GEODIST", "geo:a", "p1", "nosuch"),
          ("GEOSEARCH", "geo:a", "FROMLONLAT", "15", "37", "BYRADIUS", "200", "km", "ASC"),
          ("GEOSEARCH", "geo:a", "FROMLONLAT", "5", "45", "BYRADIUS", "900", "km", "ASC", "COUNT", "6",
           "WITHDIST", "WITHCOORD"),
          ("GEOSEARCH", "geo:a", "FROMMEMBER", "p4", "BYBOX", "1500", "1000", "km", "DESC", "WITHDIST"),
          ("GEOSEARCHSTORE", "geo:out", "geo:a", "FROMLONLAT", "5", "45", "BYRADIUS", "800", "km",
           "COUNT", "5"),
          ("GEOSEARCHSTORE", "geo:dist", "geo:a", "FROMLONLAT", "0", "50", "BYRADIUS", "700", "km",
           "STOREDIST"),
          ("GEOSEARCHSTORE", "geo:x", "geo:a", "FROMMEMBER", "p5", "BYRADIUS", "800", "km"),
          ("GEOSEARCH", "geo:out", "FROMLONLAT", "5", "45", "BYRADIUS", "5000", "km", "ASC", "WITHDIST"),
          ("GEOPOS", "geo:dist", "p1", "p2"),
          ("GEORADIUS", "geo:a", "15", "37", "200", "km", "WITHDIST", "ASC"),
          ("GEORADIUS_RO", "geo:a", "10", "40", "500", "km", "COUNT", "3", "ASC"),
          ("GEORADIUSBYMEMBER", "geo:a", "Palermo", "200", "km", "ASC"),
          ("GEORADIUSBYMEMBER_RO", "geo:a", "p6", "600", "km", "WITHCOORD", "ASC"),
          ("GEORADIUS", "geo:a", "15", "37", "200", "km", "STORE", "geo:st"),
          ("GEOSEARCH", "geo:st", "FROMLONLAT", "15", "37", "BYRADIUS", "300", "km", "ASC"),
          ("GEORADIUS_RO", "geo:a", "15", "37", "200", "km", "STORE", "x"),
          ("GEOSEARCH", "geo:a", "BYRADIUS", "10", "km"), ("TYPE", "geo:a")]
    # -- JSON documents ---------------------------------------------------------
    doc = {"a": {"b": [1, 2]}, "s": "hi", "n": 4, "t": True, "o": {"x": 1, "y": [3, 4]}}
    setup += [("JSON.SET", "j:d", "$", json.dumps(doc)), ("JSON.SET", "j:e", "$", json.dumps([1, "x", None]))]
    q += [("JSON.GET", "j:d"), ("JSON.GET", "j:d", "$.a.b"), ("JSON.GET", "j:d", "$.s", "$.n"),
          ("JSON.TYPE", "j:d", "$.a"), ("JSON.TYPE", "j:d", "$.t"), ("JSON.NUMINCRBY", "j:d", "$.n", "2.5"),
          ("JSON.STRAPPEND", "j:d", "$.s", json.dumps("!")), ("JSON.STRLEN", "j:d", "$.s"),
          ("JSON.ARRAPPEND", "j:d", "$.a.b", "3", "4"), ("JSON.ARRINSERT", "j:d", "$.a.b", "0", "0"),
          ("JSON.ARRLEN", "j:d", "$.a.b"), ("JSON.ARRINDEX", "j:d", "$.a.b", "3"),
          ("JSON.ARRPOP", "j:d", "$.a.b"), ("JSON.ARRTRIM", "j:d", "$.a.b", "1", "2"),
          ("JSON.OBJKEYS", "j:d"), ("JSON.OBJLEN", "j:d", "$.o"), ("JSON.TOGGLE", "j:d", "$.t"),
          ("JSON.MERGE", "j:d", "$.o", json.dumps({"z": 9, "x": None})), ("JSON.GET", "j:d", "$.o"),
          ("JSON.SET", "j:d", "$.new", json.dumps([5]), "NX"), ("JSON.SET", "j:d", "$.new", "6", "NX"),
          ("JSON.SET", "j:d", "$.absent", "1", "XX"), ("JSON.CLEAR", "j:d", "$.o"),
          ("JSON.DEL", "j:d", "$.new"), ("JSON.GET", "j:d"), ("JSON.GET", "j:e", "$"),
          ("JSON.ARRLEN", "j:d", "$.s"), ("JSON.NUMINCRBY", "j:d", "$.s", "1"),
          ("JSON.GET", "j:d", "$.nosuch.deep"), ("JSON.SET", "j:d", "$", "not json"),
          ("JSON.SET", "j:d", "$", "1", "MAYBE"), ("JSON.GET", "j:none"), ("JSON.DEL", "j:e"),
          ("JSON.TYPE", "j:e")]
    # -- search: a FLAT COSINE index and an IVF L2 index -----------------------
    docs = rng.standard_normal((4 * n, dim)).astype(np.float32)
    setup.append(("FT.CREATE", "idx:f", "ON", "HASH", "PREFIX", "1", "doc:", "SCHEMA", "title", "TEXT",
                  "tag", "TAG", "price", "NUMERIC", "SORTABLE", "emb", "VECTOR", "FLAT", "6",
                  "TYPE", "FLOAT32", "DIM", str(dim), "DISTANCE_METRIC", "COSINE"))
    for i in range(4 * n):
        setup.append(("HSET", f"doc:{i}", "title", f"word{i % 7} item{i % 13}", "tag", "abc"[i % 3],
                      "price", str(i), "emb", f32_blob(docs[i])))
    centers = rng.standard_normal((8, dim)).astype(np.float32)
    iv = (centers[rng.integers(8, size=16 * n)] + 0.3 * rng.standard_normal((16 * n, dim))).astype(np.float32)
    setup.append(("FT.CREATE", "idx:i", "ON", "HASH", "PREFIX", "1", "iv:", "SCHEMA", "tag", "TAG",
                  "emb", "VECTOR", "IVF", "12", "TYPE", "FLOAT32", "DIM", str(dim),
                  "DISTANCE_METRIC", "L2", "NLIST", "8", "NPROBE", "2", "TRAIN_MIN", str(8 * n)))
    for i in range(16 * n):
        setup.append(("HSET", f"iv:{i}", "tag", "xy"[i % 2], "emb", f32_blob(iv[i])))
    setup += [("FT.CREATE", "idx:f", "SCHEMA", "t", "TEXT"), ("FT.CREATE", "idx:bad", "SCHEMA", "v", "GEO")]
    qv = docs[:3] + 0.05
    # a KNN page whose rest the queries read by cursor 1: a KNN reply (and
    # its cursor) is made at the frame's readback, after later commands of
    # the same frame dispatched
    setup.append(("FT.SEARCH", "idx:f", "*=>[KNN 5 @emb $v]", "PARAMS", "2", "v", f32_blob(qv[1]), "NOCONTENT",
                  "WITHCURSOR", "COUNT", "2"))
    qi = iv[:8] + 0.05
    knn = "*=>[KNN 5 @emb $v]"
    q += [("FT.SEARCH", "idx:f", "@title:word3", "SORTBY", "price", "DESC", "LIMIT", "0", "5",
           "NOCONTENT"),
          ("FT.SEARCH", "idx:f", "@tag:{b} @price:[10 (60]", "NOCONTENT", "LIMIT", "0", "50"),
          ("FT.SEARCH", "idx:f", "item4 @price:[-inf 40]", "SORTBY", "price", "LIMIT", "0", "3"),
          ("FT.SEARCH", "idx:f", knn, "PARAMS", "2", "v", f32_blob(qv[0]), "NOCONTENT"),
          ("FT.SEARCH", "idx:f", "*=>[KNN 4 @emb $v AS dist]", "PARAMS", "2", "v", f32_blob(qv[1]), "NOCONTENT"),
          ("FT.SEARCH", "idx:f", "(@tag:{a})=>[KNN 6 @emb $v]", "PARAMS", "2", "v", f32_blob(qv[2]),
           "NOCONTENT"),
          ("FT.SEARCH", "idx:f", "(@price:[0 30])=>[KNN 3 @emb $v]", "PARAMS", "2", "v", f32_blob(qv[0])),
          ("FT.CURSOR", "READ", "idx:f", "1", "COUNT", "2"), ("FT.CURSOR", "READ", "idx:f", "1"),
          ("FT.MSEARCH", "idx:f", "*=>[KNN 10 @emb $v]", "PARAMS", "2", "v", f32_blob(qv)),
          ("FT.MSEARCH", "idx:f", "(@tag:{b})=>[KNN 4 @emb $v]", "PARAMS", "2", "v", f32_blob(qv)),
          ("FT.MSEARCH", "idx:i", "*=>[KNN 10 @emb $v]", "PARAMS", "2", "v", f32_blob(qi)),
          ("FT.MSEARCH", "idx:i", "*=>[KNN 10 @emb $v]", "PARAMS", "2", "v", f32_blob(qi), "NPROBE", "4"),
          ("FT.SEARCH", "idx:i", "(@tag:{x})=>[KNN 5 @emb $v]", "PARAMS", "2", "v", f32_blob(qi[0]),
           "NOCONTENT"),
          ("FT.SEARCH", "idx:i", knn, "PARAMS", "2", "v", f32_blob(qi[1]), "NOCONTENT", "NPROBE", "8"),
          ("FT.SEARCH", "idx:f", knn, "PARAMS", "2", "v", b"\x00" * 6),
          ("FT.SEARCH", "idx:f", knn, "PARAMS", "2", "w", f32_blob(qv[0])),
          ("FT.SEARCH", "idx:f", knn, "PARAMS", "2", "v", f32_blob(qv[0]), "NPROBE", "2"),
          ("FT.MSEARCH", "idx:f", "@tag:{a}"), ("FT.SEARCH", "idx:none", "*"),
          ("FT.AGGREGATE", "idx:f", "*", "GROUPBY", "1", "@tag", "REDUCE", "count", "0", "AS", "n",
           "REDUCE", "avg", "1", "@price", "AS", "avg", "REDUCE", "max", "1", "@price", "AS", "hi",
           "SORTBY", "2", "@n", "DESC"),
          ("FT.AGGREGATE", "idx:f", "@price:[0 60]", "GROUPBY", "1", "@title", "REDUCE", "sum", "1",
           "@price", "AS", "s", "WITHCURSOR", "COUNT", "2"),
          ("FT.CURSOR", "READ", "idx:f", "2", "COUNT", "3"), ("FT.CURSOR", "READ", "idx:f", "2"),
          ("FT.CURSOR", "DEL", "idx:f", "2"), ("FT.CURSOR", "READ", "idx:f", "77"),
          ("FT.INFO", "idx:f"), ("FT.INFO", "idx:i"), ("FT._LIST",),
          ("FT.ALIASADD", "al:f", "idx:f"), ("FT.SEARCH", "al:f", "word2", "NOCONTENT", "LIMIT", "0", "4"),
          ("FT.ALIASADD", "al:f", "idx:f"), ("FT.ALIASUPDATE", "al:f", "idx:i"), ("FT.ALIASDEL", "al:f"),
          ("FT.ALIASDEL", "al:f"),
          ("FT.SYNUPDATE", "idx:f", "g1", "word1", "item2"), ("FT.SYNDUMP", "idx:f"),
          ("FT.SEARCH", "idx:f", "@title:word1", "NOCONTENT", "LIMIT", "0", "100"),
          ("FT.CONFIG", "SET", "MINPREFIX", "3"), ("FT.CONFIG", "GET", "MINPREFIX"), ("FT.CONFIG", "GET", "*"),
          ("FT.DICTADD", "dict:a", "wordy", "itemz"), ("FT.DICTDUMP", "dict:a"),
          ("FT.DICTDEL", "dict:a", "itemz", "absent"),
          ("FT.SPELLCHECK", "idx:f", "wrod1", "DISTANCE", "2", "TERMS", "INCLUDE", "dict:a"),
          ("FT.ALTER", "idx:f", "SCHEMA", "ADD", "extra", "TAG"), ("HSET", "doc:x", "extra", "q", "title", "zz"),
          ("FT.SEARCH", "idx:f", "@extra:{q}", "NOCONTENT")]
    # -- scripts and functions registered server-side --------------------------
    q += [("INCRBY", "sc:a", "10"), ("EVALSHA", shas[0], "2", "sc:a", "sc:b", "4"),
          ("EVALSHA", shas[0], "2", "sc:a", "sc:b", "40"), ("GET", "sc:b"),
          ("EVALSHA", shas[1], "1", "sc:m", "f1", "v1", "f2", "v2"), ("HGETALL", "sc:m"),
          ("EVALSHA", "f" * 40, "0"), ("EVALSHA", shas[0], "-1"), ("EVALSHA", shas[0], "3", "a"),
          ("EVAL", "return 1", "0"), ("SCRIPT", "EXISTS", shas[0], shas[1], "e" * 40),
          ("SCRIPT", "LOAD", "return 1"), ("SCRIPT", "NOPE"),
          ("RPUSH", "sc:l", "a", "b", "c"), ("FCALL", "fn_sum", "0", "1", "2", "39"),
          ("FCALL_RO", "fn_list_len", "1", "sc:l"), ("FCALL", "fn_absent", "0"),
          ("FUNCTION", "LIST"), ("FUNCTION", "LOAD", "x"), ("FUNCTION", "NOPE")]
    return setup, q


def _knn_rows(cmd, reply):
    """A KNN reply's rows: one [(id, score text, other fields)] list a query."""
    if _verb(cmd) == b"FT.MSEARCH":
        return [[(r[i], r[i + 1], None) for i in range(0, len(r), 2)] for r in reply[1:]]
    if len(reply) == 2 and isinstance(reply[0], list):  # WITHCURSOR: [[n, [id, flds]...], cid]
        rows = reply[0][1:]
        pairs = [(r[0], r[1]) for r in rows]
    else:
        pairs = list(zip(reply[1::2], reply[2::2]))
    out = []
    for doc, flat in pairs:
        score = flat[-1]
        out.append((doc, score, tuple(flat[:-1])))
    return [out]


def knn_agree(cmd, got, want) -> bool:
    """A KNN reply held to the search contract (see the module docstring)."""
    if isinstance(want, resp.RespError) or not isinstance(got, list) or not isinstance(want, list):
        return _equal(got, want)
    if len(got) != len(want) or (_verb(cmd) == b"FT.MSEARCH" and got[0] != want[0]):
        return False
    if not (len(want) == 2 and isinstance(want[0], list)) and _verb(cmd) == b"FT.SEARCH":
        if got[0] != want[0]:  # the hit count
            return False
    elif len(want) == 2 and isinstance(want[0], list) and (got[1] != want[1] or got[0][0] != want[0][0]):
        return False  # the cursor id and the page's row count
    for g_rows, w_rows in zip(_knn_rows(cmd, got), _knn_rows(cmd, want)):
        if len(g_rows) != len(w_rows):
            return False
        gs = [float(r[1]) for r in g_rows]
        ws = [float(r[1]) for r in w_rows]
        if any(abs(a - b) > KNN_TIE for a, b in zip(gs, ws)):
            return False
        # groups of near-tied distances: ids equal as sets inside a group,
        # the last group (it touches the k cut) may hold other tied ids
        start = 0
        while start < len(ws):
            end = start + 1
            while end < len(ws) and ws[end] - ws[end - 1] <= KNN_TIE:
                end += 1
            g_ids = {r[0] for r in g_rows[start:end]}
            w_ids = {r[0] for r in w_rows[start:end]}
            if end < len(ws) and g_ids != w_ids:
                return False
            if end - start == 1 and end < len(ws) and (g_rows[start][0], g_rows[start][2]) != (
                    w_rows[start][0], w_rows[start][2]):
                return False  # a lone row: its id and fields match
            start = end
    return True


def _clock_agree(cmd, got, want) -> bool:
    """XADD * and extended XPENDING under the clock contracts."""
    args = [_b(a).upper() for a in cmd[1:]]
    if _verb(cmd) == b"XADD":
        if b"*" not in args:
            return _equal(got, want)
        ok = re.compile(rb"\d+-\d+")
        return all(isinstance(x, bytes) and ok.fullmatch(x) for x in (got, want))
    if len(cmd) <= 3 or not isinstance(want, list) or not isinstance(got, list):
        return _equal(got, want)  # the summary form holds no clock field
    if len(got) != len(want):
        return False
    return all(isinstance(g, list) and len(g) == 4 and g[:2] == w[:2] and g[3] == w[3]
               and isinstance(g[2], int) and g[2] >= 0 for g, w in zip(got, want))


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

def _equal(g, w) -> bool:
    """Equal replies: the same types and values, errors (an EXEC reply's
    too) by their text."""
    if type(g) is not type(w):
        return False
    if isinstance(w, resp.RespError):
        return g.args == w.args
    if isinstance(w, list):
        return len(g) == len(w) and all(_equal(a, b) for a, b in zip(g, w))
    return g == w


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
        elif verb in CLOCK_VERBS:
            same = _clock_agree(cmd, g, w)
        elif verb == b"FT.MSEARCH" or (verb == b"FT.SEARCH" and b"KNN" in _b(cmd[2]).upper()):
            same = knn_agree(cmd, g, w)
        elif verb in UNORDERED_VERBS:
            same = type(g) is type(w) and _multiset(g) == _multiset(w)
        elif verb in RANDOM_VERBS:
            key = _b(cmd[1])
            same = (type(g) is type(w) and _drawn(verb, cmd, g, stored_g.keys.get(key, {}))
                    and _drawn(verb, cmd, w, stored_w.keys.get(key, {})))
        else:
            same = _equal(g, w)
        stored_g.apply(cmd, g)
        stored_w.apply(cmd, w)
        if not same:
            bad.append(f"#{i} {verb.decode()}: {g!r:.120} against {w!r:.120}")
    return bad
