"""Hashes, sets, lists/deques, multi-pops + blocking family (RedissonMap /
RSet / RList / RDeque wire surface): a copy of
``redisson_tpu/server/verbs/collections.py``.

BLMPOP and BZMPOP live here too: the reference registers them in
``server/verbs/admin.py``, a module the port has not ported yet (ROADMAP
M11); their handlers are the reference's.  The blocking verbs run on the
server's slow pool (``server.py`` ``_SLOW_COMMANDS``).
"""


from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import register, _s, _int
from redisson_tpu_torch.server.verbs.common import (
    _block_loop,
    _deque,
    _fnum,
    _glob_match,
    _scan_opts,
    _scan_page,
    _typed_handle,
    _znumkeys,
    _zset,
)

# -- typed surface expansion (hashes) ----------------------------------------

@register("HSETNX")
def cmd_hsetnx(server, ctx, args):
    m = _typed_handle(server, "get_map", _s(args[0]))
    return 1 if m.fast_put_if_absent(bytes(args[1]), bytes(args[2])) else 0


def _hash_incr(server, args, parse, fmt):
    name = _s(args[0])
    field = bytes(args[1])
    m = _typed_handle(server, "get_map", name)
    with server.engine.locked(name):
        cur = m.get(field)
        try:
            new = (parse(cur) if cur is not None else parse(b"0")) + parse(args[2])
        except ValueError:
            raise RespError("ERR hash value is not a number")
        m.fast_put(field, fmt(new))
        return new


@register("HINCRBY")
def cmd_hincrby(server, ctx, args):
    return _hash_incr(server, args, _int, lambda v: str(v).encode())


@register("HINCRBYFLOAT")
def cmd_hincrbyfloat(server, ctx, args):
    return _fnum(_hash_incr(server, args, float, _fnum))


@register("HSTRLEN")
def cmd_hstrlen(server, ctx, args):
    v = _typed_handle(server, "get_map", _s(args[0])).get(bytes(args[1]))
    return 0 if v is None else len(bytes(v))


@register("HRANDFIELD")
def cmd_hrandfield(server, ctx, args):
    import random

    m = _typed_handle(server, "get_map", _s(args[0]))
    entries = m.read_all_entry_set()
    if len(args) == 1:
        return random.choice(entries)[0] if entries else None
    n = _int(args[1])
    withvalues = len(args) > 2 and bytes(args[2]).upper() == b"WITHVALUES"
    if n >= 0:  # distinct fields, at most n
        picked = random.sample(entries, min(n, len(entries)))
    else:  # repeats allowed, exactly |n|
        picked = [random.choice(entries) for _ in range(-n)] if entries else []
    out = []
    for k, v in picked:
        out += [k, v] if withvalues else [k]
    return out


@register("HSCAN")
def cmd_hscan(server, ctx, args):
    pattern, count, novalues = _scan_opts(args, 2)
    m = _typed_handle(server, "get_map", _s(args[0]))
    entries = sorted(m.read_all_entry_set())
    if pattern is not None:
        entries = [e for e in entries if _glob_match(pattern, e[0].decode(errors="replace"))]
    cur, page = _scan_page(entries, _int(args[1]), count)
    flat = []
    for k, v in page:
        flat += [k] if novalues else [k, v]
    return [cur, flat]


# -- typed surface expansion (sets) ------------------------------------------

def _set(server, name: str):
    return _typed_handle(server, "get_set", name)


@register("SPOP")
def cmd_spop(server, ctx, args):
    s = _set(server, _s(args[0]))
    if len(args) == 1:
        v = s.remove_random()
        return None if v is None else bytes(v)
    return [bytes(v) for v in (s.remove_random() for _ in range(_int(args[1]))) if v is not None]


@register("SRANDMEMBER")
def cmd_srandmember(server, ctx, args):
    import random

    s = _set(server, _s(args[0]))
    if len(args) == 1:
        v = s.random_member()
        return None if v is None else bytes(v)
    n = _int(args[1])
    members = s.read_all()
    if n >= 0:
        return random.sample(members, min(n, len(members)))
    return [random.choice(members) for _ in range(-n)] if members else []


@register("SMISMEMBER")
def cmd_smismember(server, ctx, args):
    s = _set(server, _s(args[0]))
    return [1 if s.contains(bytes(m)) else 0 for m in args[1:]]


@register("SMOVE")
def cmd_smove(server, ctx, args):
    return 1 if _set(server, _s(args[0])).move(_s(args[1]), bytes(args[2])) else 0


@register("SINTER")
def cmd_sinter(server, ctx, args):
    # set combination replies are RESP3 `~` set frames, like SMEMBERS
    return set(_set(server, _s(args[0])).read_intersection(*[_s(n) for n in args[1:]]))


@register("SUNION")
def cmd_sunion(server, ctx, args):
    return set(_set(server, _s(args[0])).read_union(*[_s(n) for n in args[1:]]))


@register("SDIFF")
def cmd_sdiff(server, ctx, args):
    return set(_set(server, _s(args[0])).read_diff(*[_s(n) for n in args[1:]]))


def _set_store(server, args, op: str):
    # Redis *STORE semantics: result = op over the SOURCES only, dest is
    # overwritten (its old content never participates).  The handle-level
    # union/intersection/diff include self, so compute via the first
    # source's read_* form and write the result — all under one lock scope
    # (record RLocks are re-entrant per thread, so the nested handle locks
    # are safe)
    dest = _s(args[0])
    srcs = [_s(n) for n in args[1:]]
    with server.engine.locked_many([dest, *srcs]):
        result = getattr(_set(server, srcs[0]), op)(*srcs[1:])
        server.engine.store.delete(dest)
        d = _set(server, dest)
        if result:
            d.add_all(bytes(v) for v in result)
        return len(result)


@register("SINTERSTORE")
def cmd_sinterstore(server, ctx, args):
    return _set_store(server, args, "read_intersection")


@register("SUNIONSTORE")
def cmd_sunionstore(server, ctx, args):
    return _set_store(server, args, "read_union")


@register("SDIFFSTORE")
def cmd_sdiffstore(server, ctx, args):
    return _set_store(server, args, "read_diff")


@register("SINTERCARD")
def cmd_sintercard(server, ctx, args):
    n = _int(args[0])
    names = [_s(k) for k in args[1 : 1 + n]]
    limit = None
    if len(args) > 1 + n:
        if bytes(args[1 + n]).upper() != b"LIMIT":
            raise RespError("ERR syntax error")
        limit = _int(args[2 + n])
        if limit < 0:
            raise RespError("ERR LIMIT can't be negative")
    inter = _set(server, names[0]).read_intersection(*names[1:])
    card = len(inter)
    return min(card, limit) if limit not in (None, 0) else card


@register("SSCAN")
def cmd_sscan(server, ctx, args):
    pattern, count, _ = _scan_opts(args, 2)
    members = sorted(bytes(v) for v in _set(server, _s(args[0])).read_all())
    if pattern is not None:
        members = [m for m in members if _glob_match(pattern, m.decode(errors="replace"))]
    return _scan_page(members, _int(args[1]), count)


# -- typed surface expansion (lists) -----------------------------------------
# Compound list edits operate on the queue record's host list directly under
# the record lock (the handle exposes the safe subset; Redis list verbs like
# LINSERT/LREM need positional surgery).

def _list_edit(server, name: str):
    d = _deque(server, name)
    rec = d._rec_or_create()
    return d, rec


@register("LPUSHX")
def cmd_lpushx(server, ctx, args):
    name = _s(args[0])
    with server.engine.locked(name):
        if not server.engine.store.exists(name):
            return 0
        d = _deque(server, name)
        for v in args[1:]:
            d.add_first(bytes(v))
        return d.size()


@register("RPUSHX")
def cmd_rpushx(server, ctx, args):
    name = _s(args[0])
    with server.engine.locked(name):
        if not server.engine.store.exists(name):
            return 0
        d = _deque(server, name)
        for v in args[1:]:
            d.add_last(bytes(v))
        return d.size()


@register("LSET")
def cmd_lset(server, ctx, args):
    name = _s(args[0])
    with server.engine.locked(name):
        if not server.engine.store.exists(name):
            raise RespError("ERR no such key")
        d, rec = _list_edit(server, name)
        i = _int(args[1])
        if i < 0:
            i += len(rec.host)
        if not 0 <= i < len(rec.host):
            raise RespError("ERR index out of range")
        rec.host[i] = bytes(args[2])
        d._touch_version(rec)
        return "+OK"


@register("LINSERT")
def cmd_linsert(server, ctx, args):
    name = _s(args[0])
    where = bytes(args[1]).upper()
    if where not in (b"BEFORE", b"AFTER"):
        raise RespError("ERR syntax error")
    pivot, elem = bytes(args[2]), bytes(args[3])
    with server.engine.locked(name):
        if not server.engine.store.exists(name):
            return 0
        d, rec = _list_edit(server, name)
        try:
            i = rec.host.index(pivot)
        except ValueError:
            return -1
        rec.host.insert(i if where == b"BEFORE" else i + 1, elem)
        d._touch_version(rec)
        return len(rec.host)


@register("LREM")
def cmd_lrem(server, ctx, args):
    name = _s(args[0])
    n, target = _int(args[1]), bytes(args[2])
    with server.engine.locked(name):
        if not server.engine.store.exists(name):
            return 0
        d, rec = _list_edit(server, name)
        items = rec.host
        removed = 0
        if n == 0:
            before = len(items)
            rec.host = [v for v in items if v != target]
            removed = before - len(rec.host)
        elif n > 0:
            out = []
            for v in items:
                if v == target and removed < n:
                    removed += 1
                else:
                    out.append(v)
            rec.host = out
        else:
            out = []
            for v in reversed(items):
                if v == target and removed < -n:
                    removed += 1
                else:
                    out.append(v)
            rec.host = out[::-1]
        if removed:
            d._touch_version(rec)
        return removed


@register("LTRIM")
def cmd_ltrim(server, ctx, args):
    from redisson_tpu_torch.client.objects.scoredsortedset import _norm_range

    name = _s(args[0])
    with server.engine.locked(name):
        if not server.engine.store.exists(name):
            return "+OK"
        d, rec = _list_edit(server, name)
        lo, hi = _norm_range(_int(args[1]), _int(args[2]), len(rec.host))
        rec.host = rec.host[lo : hi + 1] if hi >= lo else []
        d._touch_version(rec)
        return "+OK"


@register("LPOS")
def cmd_lpos(server, ctx, args):
    name = _s(args[0])
    target = bytes(args[1])
    rank, num = 1, None
    i = 2
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"RANK":
            rank = _int(args[i + 1])
            if rank == 0:
                raise RespError("ERR RANK can't be zero")
            i += 2
        elif opt == b"COUNT":
            num = _int(args[i + 1])
            i += 2
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    if not server.engine.store.exists(name):
        return None if num is None else []
    items = [bytes(v) for v in _deque(server, name).read_all()]
    order = range(len(items)) if rank > 0 else range(len(items) - 1, -1, -1)
    skip = abs(rank) - 1
    hits = []
    for idx in order:
        if items[idx] != target:
            continue
        if skip:
            skip -= 1
            continue
        hits.append(idx)
        if num is None:  # single-answer form: first match wins
            break
        if num != 0 and len(hits) >= num:  # COUNT 0 = all matches
            break
    if num is None:
        return hits[0] if hits else None
    return hits


def _list_move(server, src: str, dst: str, from_left: bool, to_left: bool):
    with server.engine.locked_many((src, dst)):
        s = _deque(server, src)
        v = s.poll_first() if from_left else s.poll_last()
        if v is None:
            return None
        d = _deque(server, dst)
        (d.add_first if to_left else d.add_last)(bytes(v))
        return bytes(v)


@register("LMOVE")
def cmd_lmove(server, ctx, args):
    wherefrom = bytes(args[2]).upper()
    whereto = bytes(args[3]).upper()
    if wherefrom not in (b"LEFT", b"RIGHT") or whereto not in (b"LEFT", b"RIGHT"):
        raise RespError("ERR syntax error")
    return _list_move(
        server, _s(args[0]), _s(args[1]), wherefrom == b"LEFT", whereto == b"LEFT"
    )


@register("RPOPLPUSH")
def cmd_rpoplpush(server, ctx, args):
    return _list_move(server, _s(args[0]), _s(args[1]), False, True)


# -- multi-pops + blocking family --------------------------------------------



def _bpop(server, args, first: bool):
    names = [_s(k) for k in args[:-1]]
    timeout = float(args[-1])

    def poll_once():
        for nm in names:
            v = _deque(server, nm).poll_first() if first else _deque(server, nm).poll_last()
            if v is not None:
                return [nm.encode(), bytes(v)]
        return None

    return _block_loop(server, names[0], poll_once, timeout)


@register("BLPOP")
def cmd_blpop(server, ctx, args):
    return _bpop(server, args, first=True)


@register("BRPOP")
def cmd_brpop(server, ctx, args):
    return _bpop(server, args, first=False)


@register("BLMOVE")
def cmd_blmove(server, ctx, args):
    src, dst = _s(args[0]), _s(args[1])
    wherefrom = bytes(args[2]).upper()
    whereto = bytes(args[3]).upper()
    if wherefrom not in (b"LEFT", b"RIGHT") or whereto not in (b"LEFT", b"RIGHT"):
        raise RespError("ERR syntax error")
    timeout = float(args[4])

    def poll_once():
        return _list_move(server, src, dst, wherefrom == b"LEFT", whereto == b"LEFT")

    return _block_loop(server, src, poll_once, timeout)


@register("BRPOPLPUSH")
def cmd_brpoplpush(server, ctx, args):
    src, dst = _s(args[0]), _s(args[1])
    timeout = float(args[2])

    def poll_once():
        return _list_move(server, src, dst, False, True)

    return _block_loop(server, src, poll_once, timeout)


@register("LMPOP")
def cmd_lmpop(server, ctx, args):
    """LMPOP numkeys key... LEFT|RIGHT [COUNT n]."""
    _n, names, i = _znumkeys(server, args)
    where = bytes(args[i]).upper()
    if where not in (b"LEFT", b"RIGHT"):
        raise RespError("ERR syntax error")
    count = 1
    if len(args) > i + 1:
        if bytes(args[i + 1]).upper() != b"COUNT" or len(args) <= i + 2:
            raise RespError("ERR syntax error")
        count = _int(args[i + 2])
    for nm in names:
        with server.engine.locked(nm):  # the COUNT batch pops atomically
            d = _deque(server, nm)
            popped = []
            for _ in range(count):
                v = d.poll_first() if where == b"LEFT" else d.poll_last()
                if v is None:
                    break
                popped.append(bytes(v))
        if popped:
            return [nm.encode(), popped]
    return None


def _zpop_entry(server, name: str, first: bool):
    z = _zset(server, name)
    entries = z.entry_range(0, 0) if first else z.entry_range(-1, -1)
    if not entries:
        return None
    m, sc = entries[0]
    z.remove(m)
    return bytes(m), sc


@register("ZMPOP")
def cmd_zmpop(server, ctx, args):
    """ZMPOP numkeys key... MIN|MAX [COUNT n]."""
    _n, names, i = _znumkeys(server, args)
    which = bytes(args[i]).upper()
    if which not in (b"MIN", b"MAX"):
        raise RespError("ERR syntax error")
    count = 1
    if len(args) > i + 1:
        if bytes(args[i + 1]).upper() != b"COUNT" or len(args) <= i + 2:
            raise RespError("ERR syntax error")
        count = _int(args[i + 2])
    for nm in names:
        with server.engine.locked(nm):
            flat = []
            for _ in range(count):
                e = _zpop_entry(server, nm, which == b"MIN")
                if e is None:
                    break
                flat += [e[0], _fnum(e[1])]
        if flat:
            return [nm.encode(), flat]
    return None


def _bzpop(server, args, first: bool):
    names = [_s(k) for k in args[:-1]]
    timeout = float(args[-1])

    def poll_once():
        for nm in names:
            with server.engine.locked(nm):
                e = _zpop_entry(server, nm, first)
            if e is not None:
                return [nm.encode(), e[0], _fnum(e[1])]
        return None

    return _block_loop(server, names[0], poll_once, timeout)


@register("BZPOPMIN")
def cmd_bzpopmin(server, ctx, args):
    return _bzpop(server, args, first=True)


@register("BZPOPMAX")
def cmd_bzpopmax(server, ctx, args):
    return _bzpop(server, args, first=False)


# -- BLMPOP / BZMPOP ---------------------------------------------------------

def _bmpop_prelude(args):
    """Shared BLMPOP/BZMPOP validation: timeout + numkeys BEFORE any
    delegation, so malformed input replies a syntax error, never ERR
    internal."""
    import math as _math

    if len(args) < 4:
        raise RespError("ERR wrong number of arguments")
    try:
        timeout = float(args[0])
    except (TypeError, ValueError):
        raise RespError("ERR timeout is not a float or out of range")
    if not _math.isfinite(timeout) or timeout < 0:
        # NaN would make every deadline comparison False: park forever
        raise RespError("ERR timeout is not a float or out of range")
    rest = args[1:]
    n = _int(rest[0])
    if n <= 0:
        raise RespError("ERR numkeys should be greater than 0")
    if len(rest) < 1 + n + 1:
        raise RespError("ERR Number of keys is greater than number of args")
    return timeout, rest, _s(rest[1])


@register("BLMPOP")
def cmd_blmpop(server, ctx, args):
    """BLMPOP timeout numkeys key... LEFT|RIGHT [COUNT n]."""
    timeout, rest, first_key = _bmpop_prelude(args)

    def poll_once():
        return cmd_lmpop(server, ctx, rest)

    return _block_loop(server, first_key, poll_once, timeout)


@register("BZMPOP")
def cmd_bzmpop(server, ctx, args):
    """BZMPOP timeout numkeys key... MIN|MAX [COUNT n]."""
    timeout, rest, first_key = _bmpop_prelude(args)

    def poll_once():
        return cmd_zmpop(server, ctx, rest)

    return _block_loop(server, first_key, poll_once, timeout)
