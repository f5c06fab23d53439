"""A mixed RESP command stream over the port's four verb families, and the
means to hold two servers' replies to it against each other.

``mixed_stream(seed, scale)`` builds the stream from a seed (numpy): bloom
filters (reserve, coalescible BF.MADD64 / BF.MEXISTS64 runs, the per-key
and multi-key verbs, BF.INFO), a bloom bank (BFA.*), HyperLogLogs (PFADD,
PFADD64, PFCOUNT, PFMERGE) and an HLL bank (HLLA.*), bit sets (config 5's
SETBITSB and BITOP OR/XOR, SETBIT, GETBIT, BITCOUNT, GETBITS(B),
BITFIELD), strings, counters and hashes, the connection verbs, an unknown
verb and a wrong-arity call.  ``scale`` multiplies the key counts.

``replies(host, port, waves)`` sends each wave as one pipelined write on
one connection and returns, per wave, the raw reply bytes and the parsed
replies.  ``compare(cmds, got, want)`` lists the replies that differ,
holding PFCOUNT to the PFCOUNT contract (``ops/hll.py``: the integers may
differ by one more than the float32 tolerance, 1e-6 of the estimate or
m * 2**-20 in linear counting) and the float64 blobs of HLLA.ESTIMATE /
HLLA.ESTPAIRS to that tolerance; every other reply must be equal.

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


def compare(cmds: Sequence[tuple], got: list, want: list) -> List[str]:
    """The replies of `got` that differ from `want` (one wave each), with
    the estimate verbs held to their contract."""
    bad = []
    if len(got) != len(want):
        return [f"{len(got)} replies against {len(want)}"]
    for i, (cmd, g, w) in enumerate(zip(cmds, got, want)):
        verb = _verb(cmd)
        if isinstance(w, resp.RespError):
            same = isinstance(g, resp.RespError) and g.args == w.args
        elif verb in ESTIMATE_VERBS:
            same = _estimates_agree(verb, g, w)
        else:
            same = type(g) is type(w) and g == w
        if not same:
            bad.append(f"#{i} {verb.decode()}: {g!r:.120} against {w!r:.120}")
    return bad
