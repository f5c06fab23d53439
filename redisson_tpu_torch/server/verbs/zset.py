"""Sorted sets: ZADD family, lex ranges, combination reads, range stores
(RScoredSortedSet wire surface), with RENAMENX, BITPOS and SORT: a copy of
``redisson_tpu/server/verbs/zset.py``.  COPY clones a record of any kind
through ``core/checkpoint.clone_record``.
"""

from typing import Dict

from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import register, _s, _int
from redisson_tpu_torch.server.verbs.collections import _set
from redisson_tpu_torch.server.verbs.common import (
    _bitset,
    _deque,
    _fnum,
    _glob_match,
    _scan_opts,
    _scan_page,
    _znumkeys,
    _zset,
)

# -- typed surface expansion (sorted sets) -----------------------------------


def _zbound(raw: bytes):
    """Parse a ZRANGEBYSCORE bound: -inf/+inf, (exclusive, or inclusive."""
    s = bytes(raw)
    inc = True
    if s.startswith(b"("):
        inc = False
        s = s[1:]
    if s in (b"-inf", b"+inf", b"inf"):
        return (float("-inf") if s == b"-inf" else float("inf")), inc
    return float(s), inc


@register("ZCOUNT")
def cmd_zcount(server, ctx, args):
    lo, lo_inc = _zbound(args[1])
    hi, hi_inc = _zbound(args[2])
    return _zset(server, _s(args[0])).count(lo, lo_inc, hi, hi_inc)


def _zrangebyscore(server, args, reverse: bool):
    z = _zset(server, _s(args[0]))
    if reverse:  # ZREVRANGEBYSCORE takes max first
        hi, hi_inc = _zbound(args[1])
        lo, lo_inc = _zbound(args[2])
    else:
        lo, lo_inc = _zbound(args[1])
        hi, hi_inc = _zbound(args[2])
    withscores = False
    offset, limit = 0, None
    i = 3
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"WITHSCORES":
            withscores = True
            i += 1
        elif opt == b"LIMIT":
            offset, limit = _int(args[i + 1]), _int(args[i + 2])
            i += 3
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    from redisson_tpu_torch.client.objects.scoredsortedset import _in_score

    entries = [
        (m, sc)
        for m, sc in z.entry_range(0, -1)
        if _in_score(sc, lo, lo_inc, hi, hi_inc)
    ]
    if reverse:
        entries.reverse()
    if limit is not None and limit >= 0:
        entries = entries[offset : offset + limit]
    elif offset:
        entries = entries[offset:]
    out = []
    for m, sc in entries:
        out += [m, _fnum(sc)] if withscores else [m]
    return out


@register("ZRANGEBYSCORE")
def cmd_zrangebyscore(server, ctx, args):
    return _zrangebyscore(server, args, reverse=False)


@register("ZREVRANGEBYSCORE")
def cmd_zrevrangebyscore(server, ctx, args):
    return _zrangebyscore(server, args, reverse=True)


@register("ZREVRANGE")
def cmd_zrevrange(server, ctx, args):
    z = _zset(server, _s(args[0]))
    withscores = len(args) > 3 and bytes(args[3]).upper() == b"WITHSCORES"
    entries = z.entry_range(0, -1)
    entries.reverse()
    from redisson_tpu_torch.client.objects.scoredsortedset import _norm_range

    lo, hi = _norm_range(_int(args[1]), _int(args[2]), len(entries))
    entries = entries[lo : hi + 1] if hi >= lo else []
    out = []
    for m, sc in entries:
        out += [m, _fnum(sc)] if withscores else [m]
    return out


@register("ZREVRANK")
def cmd_zrevrank(server, ctx, args):
    return _zset(server, _s(args[0])).rev_rank(bytes(args[1]))


def _zpop(server, args, first: bool):
    z = _zset(server, _s(args[0]))
    n = _int(args[1]) if len(args) > 1 else 1
    out = []
    for _ in range(n):
        entry = z.poll_first_entry() if first else z.poll_last_entry()
        if entry is None:
            break
        m, sc = entry
        out += [m, _fnum(sc)]
    return out


@register("ZPOPMIN")
def cmd_zpopmin(server, ctx, args):
    return _zpop(server, args, first=True)


@register("ZPOPMAX")
def cmd_zpopmax(server, ctx, args):
    return _zpop(server, args, first=False)


@register("ZMSCORE")
def cmd_zmscore(server, ctx, args):
    z = _zset(server, _s(args[0]))
    out = []
    for m in args[1:]:
        sc = z.get_score(bytes(m))
        out.append(None if sc is None else float(sc))
    return out


@register("ZRANDMEMBER")
def cmd_zrandmember(server, ctx, args):
    import random

    z = _zset(server, _s(args[0]))
    entries = z.entry_range(0, -1)
    if len(args) == 1:
        return random.choice(entries)[0] if entries else None
    n = _int(args[1])
    withscores = len(args) > 2 and bytes(args[2]).upper() == b"WITHSCORES"
    if n >= 0:
        picked = random.sample(entries, min(n, len(entries)))
    else:
        picked = [random.choice(entries) for _ in range(-n)] if entries else []
    out = []
    for m, sc in picked:
        out += [m, _fnum(sc)] if withscores else [m]
    return out


@register("ZREMRANGEBYSCORE")
def cmd_zremrangebyscore(server, ctx, args):
    lo, lo_inc = _zbound(args[1])
    hi, hi_inc = _zbound(args[2])
    return _zset(server, _s(args[0])).remove_range_by_score(lo, lo_inc, hi, hi_inc)


@register("ZREMRANGEBYRANK")
def cmd_zremrangebyrank(server, ctx, args):
    return _zset(server, _s(args[0])).remove_range_by_rank(_int(args[1]), _int(args[2]))


@register("ZSCAN")
def cmd_zscan(server, ctx, args):
    pattern, count, _ = _scan_opts(args, 2)
    entries = sorted(_zset(server, _s(args[0])).entry_range(0, -1))
    if pattern is not None:
        entries = [e for e in entries if _glob_match(pattern, e[0].decode(errors="replace"))]
    cur, page = _scan_page(entries, _int(args[1]), count)
    flat = []
    for m, sc in page:
        flat += [m, _fnum(sc)]
    return [cur, flat]


def _zstore(server, args, op: str):
    """ZUNIONSTORE/ZINTERSTORE dest numkeys key... [WEIGHTS w...]
    [AGGREGATE SUM|MIN|MAX] — computed in the handler so WEIGHTS compose
    (the handle-level union/intersection don't carry weights)."""
    dest = _s(args[0])
    n = _int(args[1])
    names = [_s(k) for k in args[2 : 2 + n]]
    weights = [1.0] * n
    agg = "SUM"
    i = 2 + n
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"WEIGHTS":
            weights = [float(args[i + 1 + j]) for j in range(n)]
            i += 1 + n
        elif opt == b"AGGREGATE":
            agg = _s(args[i + 1]).upper()
            if agg not in ("SUM", "MIN", "MAX"):
                raise RespError("ERR syntax error")
            i += 2
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    with server.engine.locked_many([dest, *names]):
        maps = []
        for nm, w in zip(names, weights):
            maps.append({m: sc * w for m, sc in _zset(server, nm).entry_range(0, -1)})
        if op == "union":
            acc: Dict[bytes, float] = {}
            for mp in maps:
                for m, sc in mp.items():
                    if m in acc:
                        acc[m] = sc + acc[m] if agg == "SUM" else (min if agg == "MIN" else max)(acc[m], sc)
                    else:
                        acc[m] = sc
        else:  # intersection
            keys = set(maps[0]) if maps else set()
            for mp in maps[1:]:
                keys &= set(mp)
            acc = {}
            for m in keys:
                vals = [mp[m] for mp in maps]
                acc[m] = sum(vals) if agg == "SUM" else (min(vals) if agg == "MIN" else max(vals))
        server.engine.store.delete(dest)
        z = _zset(server, dest)
        for m, sc in acc.items():
            z.add(sc, m)
        return len(acc)


@register("ZUNIONSTORE")
def cmd_zunionstore(server, ctx, args):
    return _zstore(server, args, "union")


@register("ZINTERSTORE")
def cmd_zinterstore(server, ctx, args):
    return _zstore(server, args, "intersection")


# -- generic verbs (RedisCommands.java rows toward full verb parity) ---------

@register("COPY")
def cmd_copy(server, ctx, args):
    """COPY src dst [REPLACE] — record-level clone, any object kind
    (core/checkpoint.clone_record: tensors deep-copy on their device)."""
    from redisson_tpu_torch.core import checkpoint

    src, dst = _s(args[0]), _s(args[1])
    replace = any(bytes(a).upper() == b"REPLACE" for a in args[2:])
    return 1 if checkpoint.clone_record(server.engine, src, dst, replace) else 0


@register("RENAMENX")
def cmd_renamenx(server, ctx, args):
    src, dst = _s(args[0]), _s(args[1])
    with server.engine.locked_many([src, dst]):
        if not server.engine.store.exists(src):
            raise RespError("ERR no such key")
        if server.engine.store.exists(dst):
            return 0
        server.engine.store.rename(src, dst)
    return 1


@register("BITPOS")
def cmd_bitpos(server, ctx, args):
    """BITPOS key bit [start [end]] — byte-indexed range, Redis semantics:
    searching for 0 with NO explicit end treats the value as right-padded
    with zeros (position past the last byte); with an explicit end, -1."""
    bit = _int(args[1])
    if bit not in (0, 1):
        raise RespError("ERR The bit argument must be 1 or 0.")
    if len(args) > 4:
        raise RespError("ERR syntax error")
    data = _bitset(server, _s(args[0])).to_byte_array()
    nbytes = len(data)
    start = _int(args[2]) if len(args) > 2 else 0
    has_end = len(args) > 3
    end = _int(args[3]) if has_end else nbytes - 1
    if start < 0:
        start = max(0, nbytes + start)
    if end < 0:
        end = nbytes + end
    end = min(end, nbytes - 1)
    want = bool(bit)
    # bit order matches SETBIT/GETBIT's indexing (LSB-first within a byte,
    # the BitSet layout) so BITPOS(SETBIT(i)) == i on this surface
    for byte_i in range(start, end + 1):
        b = data[byte_i]
        for bit_i in range(8):
            if bool((b >> bit_i) & 1) == want:
                return byte_i * 8 + bit_i
    if not want and not has_end and start <= nbytes:
        return nbytes * 8  # zeros continue past the stored bytes
    return -1


@register("SORT")
def cmd_sort(server, ctx, args):
    """SORT key [LIMIT off cnt] [ASC|DESC] [ALPHA] [STORE dest] over list or
    set records (the RedissonList/SortedSet sort surface)."""
    name = _s(args[0])
    off, cnt, desc, alpha, store = 0, None, False, False, None
    i = 1
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"LIMIT":
            off, cnt = _int(args[i + 1]), _int(args[i + 2])
            i += 3
        elif opt in (b"ASC", b"DESC"):
            desc = opt == b"DESC"
            i += 1
        elif opt == b"ALPHA":
            alpha = True
            i += 1
        elif opt == b"STORE":
            store = _s(args[i + 1])
            i += 2
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    rec = server.engine.store.get(name)
    if rec is None:
        vals = []
    elif rec.kind == "set":
        vals = [bytes(v) for v in _set(server, name).read_all()]
    else:
        vals = [bytes(v) for v in _deque(server, name).read_all()]
    if alpha:
        vals.sort(reverse=desc)
    else:
        try:
            vals.sort(key=float, reverse=desc)
        except ValueError:
            raise RespError("ERR One or more scores can't be converted into double")
    if cnt is not None:
        vals = vals[off : off + cnt] if cnt >= 0 else vals[off:]
    if store is None:
        return vals
    with server.engine.locked(store):
        server.engine.store.delete(store)
        d = _deque(server, store)
        for v in vals:
            d.add_last(v)
    return len(vals)


# -- lex ranges over sorted sets ---------------------------------------------

def _lex_bound(raw):
    """Returns (value|None, inclusive).  None value = unbounded (-/+)."""
    s = bytes(raw)
    if s in (b"-", b"+"):
        return None, True
    if s.startswith(b"["):
        return s[1:], True
    if s.startswith(b"("):
        return s[1:], False
    raise RespError("ERR min or max not valid string range item")


def _lex_slice(server, name: str, lo_raw, hi_raw):
    lo, lo_inc = _lex_bound(lo_raw)
    hi, hi_inc = _lex_bound(hi_raw)
    lo_unbounded = bytes(lo_raw) == b"-"
    hi_unbounded = bytes(hi_raw) == b"+"
    if bytes(lo_raw) == b"+" or bytes(hi_raw) == b"-":
        return []  # inverted unbounded forms select nothing
    members = sorted(bytes(m) for m, _ in _zset(server, name).entry_range(0, -1))
    out = []
    for m in members:
        if not lo_unbounded:
            if m < lo or (m == lo and not lo_inc):
                continue
        if not hi_unbounded:
            if m > hi or (m == hi and not hi_inc):
                continue
        out.append(m)
    return out


@register("ZLEXCOUNT")
def cmd_zlexcount(server, ctx, args):
    return len(_lex_slice(server, _s(args[0]), args[1], args[2]))


@register("ZRANGEBYLEX")
def cmd_zrangebylex(server, ctx, args):
    out = _lex_slice(server, _s(args[0]), args[1], args[2])
    return _apply_limit(out, args, 3)


@register("ZREVRANGEBYLEX")
def cmd_zrevrangebylex(server, ctx, args):
    # note the reversed bound order: ZREVRANGEBYLEX key max min
    out = _lex_slice(server, _s(args[0]), args[2], args[1])
    out.reverse()
    return _apply_limit(out, args, 3)


@register("ZREMRANGEBYLEX")
def cmd_zremrangebylex(server, ctx, args):
    name = _s(args[0])
    with server.engine.locked(name):
        victims = _lex_slice(server, name, args[1], args[2])
        z = _zset(server, name)
        for m in victims:
            z.remove(m)
    return len(victims)


def _apply_limit(out, args, at):
    if len(args) > at:
        if bytes(args[at]).upper() != b"LIMIT" or len(args) < at + 3:
            raise RespError("ERR syntax error")
        off, cnt = _int(args[at + 1]), _int(args[at + 2])
        out = out[off : off + cnt] if cnt >= 0 else out[off:]
    return out


# -- zset combination reads + range store ------------------------------------


def _zcombine(server, names, op, weights=None, agg="SUM"):
    fold = sum if agg == "SUM" else (min if agg == "MIN" else max)
    weights = weights or [1.0] * len(names)
    maps = [
        {m: sc * w for m, sc in _zset(server, nm).entry_range(0, -1)}
        for nm, w in zip(names, weights)
    ]
    if not maps:
        return {}
    if op == "union":
        acc: dict = {}
        for mp in maps:
            for m, sc in mp.items():
                acc[m] = fold((acc[m], sc)) if m in acc else sc
        return acc
    if op == "inter":
        keys = set(maps[0])
        for mp in maps[1:]:
            keys &= set(mp)
        return {m: fold(mp[m] for mp in maps) for m in keys}
    # diff: first minus membership of the rest, scores from the first
    drop = set()
    for mp in maps[1:]:
        drop |= set(mp)
    return {m: sc for m, sc in maps[0].items() if m not in drop}


def _zcombo_read(server, ctx, args, op):
    n, names, i = _znumkeys(server, args)
    weights, agg, withscores = None, "SUM", False
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"WITHSCORES":
            withscores = True
            i += 1
        elif opt == b"WEIGHTS" and op != "diff":  # ZDIFF takes no modifiers
            if len(args) < i + 1 + n:
                raise RespError("ERR syntax error")
            weights = [float(args[i + 1 + j]) for j in range(n)]
            i += 1 + n
        elif opt == b"AGGREGATE" and op != "diff":
            agg = _s(args[i + 1]).upper() if len(args) > i + 1 else ""
            if agg not in ("SUM", "MIN", "MAX"):
                raise RespError("ERR syntax error")
            i += 2
        else:
            # unknown trailing args must ERROR, never silently drop —
            # a typo'd WITHSCORES would otherwise return wrong-shaped data
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    with server.engine.locked_many(names):
        acc = _zcombine(server, names, op, weights, agg)
    out = []
    for m, sc in sorted(acc.items(), key=lambda kv: (kv[1], kv[0])):
        out += [m, _fnum(sc)] if withscores else [m]
    return out


@register("ZDIFF")
def cmd_zdiff(server, ctx, args):
    return _zcombo_read(server, ctx, args, "diff")


@register("ZINTER")
def cmd_zinter(server, ctx, args):
    return _zcombo_read(server, ctx, args, "inter")


@register("ZUNION")
def cmd_zunion(server, ctx, args):
    return _zcombo_read(server, ctx, args, "union")


@register("ZINTERCARD")
def cmd_zintercard(server, ctx, args):
    """ZINTERCARD numkeys key... [LIMIT n] — intersection cardinality
    without materializing the member list on the wire."""
    _n, names, i = _znumkeys(server, args, 0)
    limit = 0
    if i < len(args):
        if bytes(args[i]).upper() != b"LIMIT" or i + 1 >= len(args):
            raise RespError("ERR syntax error")
        limit = _int(args[i + 1])
        if limit < 0:
            raise RespError("ERR LIMIT can't be negative")
    with server.engine.locked_many(names):
        acc = _zcombine(server, names, "inter")
    card = len(acc)
    return min(card, limit) if limit else card


@register("ZDIFFSTORE")
def cmd_zdiffstore(server, ctx, args):
    dest = _s(args[0])
    _n, names, _i = _znumkeys(server, args, 1)
    with server.engine.locked_many([dest, *names]):
        acc = _zcombine(server, names, "diff")
        server.engine.store.delete(dest)
        z = _zset(server, dest)
        for m, sc in acc.items():
            z.add(sc, m)
    return len(acc)


@register("ZRANGESTORE")
def cmd_zrangestore(server, ctx, args):
    """ZRANGESTORE dst src min max [BYSCORE|BYLEX] [REV] [LIMIT off cnt]."""
    dst, src = _s(args[0]), _s(args[1])
    by, rev = b"INDEX", False
    limit_at = None
    i = 4
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt in (b"BYSCORE", b"BYLEX"):
            by = opt
            i += 1
        elif opt == b"REV":
            rev = True
            i += 1
        elif opt == b"LIMIT":
            limit_at = i
            i += 3
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    if limit_at is not None and by == b"INDEX":
        raise RespError("ERR syntax error, LIMIT is only supported in combination with either BYSCORE or BYLEX")
    with server.engine.locked_many([dst, src]):
        lo_raw, hi_raw = (args[3], args[2]) if rev else (args[2], args[3])
        if by == b"BYLEX":
            members = _lex_slice(server, src, lo_raw, hi_raw)
            z = _zset(server, src)
            entries = [(m, z.get_score(m) or 0.0) for m in members]
        elif by == b"BYSCORE":
            lo, lo_inc = _zbound(lo_raw)
            hi, hi_inc = _zbound(hi_raw)
            entries = [
                (bytes(m), sc)
                for m, sc in _zset(server, src).entry_range(0, -1)
                if (sc > lo or (sc == lo and lo_inc)) and (sc < hi or (sc == hi and hi_inc))
            ]
        else:
            all_entries = _zset(server, src).entry_range(0, -1)
            from redisson_tpu_torch.client.objects.scoredsortedset import _norm_range

            start, stop = _int(args[2]), _int(args[3])
            if rev:
                all_entries.reverse()
            lo_i, hi_i = _norm_range(start, stop, len(all_entries))
            entries = [
                (bytes(m), sc) for m, sc in
                (all_entries[lo_i : hi_i + 1] if hi_i >= lo_i else [])
            ]
        if rev and by != b"INDEX":
            entries.reverse()
        if limit_at is not None:
            off, cnt = _int(args[limit_at + 1]), _int(args[limit_at + 2])
            entries = entries[off : off + cnt] if cnt >= 0 else entries[off:]
        server.engine.store.delete(dst)
        z = _zset(server, dst)
        for m, sc in entries:
            z.add(sc, m)
    return len(entries)


