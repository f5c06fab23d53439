"""Streams (XADD family, RedissonStream parity) and geo (RedissonGeo parity) verbs.

One module per verb family, shared preludes in verbs/common.py so
numkeys/syntax validation cannot diverge between families.

A copy of ``redisson_tpu/server/verbs/streamgeo.py`` for the port's server.
XREAD and XREADGROUP with BLOCK run on the server's slow pool and unpark
when the server stops (``server._closing``), as the collections' waits do.
"""

import time

from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import register, _s, _int
from redisson_tpu_torch.server.verbs.common import _fnum, _typed_handle

# -- typed stream verbs (XADD family — RedissonStream.java wire parity) ------

def _stream(server, name: str):
    return _typed_handle(server, "get_stream", name)


def _stream_cmd(fn):
    """Map stream-handle exceptions to Redis reply shapes: BUSYGROUP /
    NOGROUP pass through verbatim (clients pattern-match those prefixes),
    anything else becomes a plain ERR instead of 'ERR internal: ...'."""
    import functools

    @functools.wraps(fn)
    def wrapper(server, ctx, args):
        try:
            return fn(server, ctx, args)
        except ValueError as e:
            msg = str(e)
            raise RespError(msg if msg.startswith("BUSYGROUP") else f"ERR {msg}")
        except KeyError as e:
            msg = str(e.args[0]) if e.args else str(e)
            raise RespError(msg if msg.startswith("NOGROUP") else f"ERR {msg}")
        except IndexError:
            raise RespError("ERR syntax error")

    return wrapper


def _xentries(d) -> list:
    """Dict[id, fields] -> Redis XRANGE reply shape [[id, [f, v, ...]], ...]."""
    out = []
    for i, fields in d.items():
        flat = []
        for k, v in fields.items():
            flat += [k, v]
        out.append([i.encode() if isinstance(i, str) else i, flat])
    return out


@register("XADD")
@_stream_cmd
def cmd_xadd(server, ctx, args):
    """XADD key [NOMKSTREAM] [MAXLEN|MINID [~|=] threshold] <id|*> f v ..."""
    name = _s(args[0])
    i = 1
    nomkstream = False
    trim_kind, trim_arg = None, None
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"NOMKSTREAM":
            nomkstream = True
            i += 1
        elif opt in (b"MAXLEN", b"MINID"):
            j = i + 1
            if bytes(args[j]) in (b"~", b"="):  # approximate == exact here
                j += 1
            trim_kind, trim_arg = opt, args[j]
            i = j + 1
        else:
            break
    if i >= len(args) or (len(args) - i - 1) % 2 != 0 or len(args) - i - 1 == 0:
        raise RespError("ERR wrong number of arguments for 'xadd' command")
    if nomkstream and not server.engine.store.exists(name):
        return None
    entry_id = _s(args[i])
    fields = {bytes(args[j]): bytes(args[j + 1]) for j in range(i + 1, len(args) - 1, 2)}
    st = _stream(server, name)
    try:
        rid = st.add(fields, id=None if entry_id == "*" else entry_id)
    except ValueError as e:
        raise RespError(f"ERR {e}")
    if trim_kind == b"MAXLEN":
        st.trim(_int(trim_arg))
    elif trim_kind == b"MINID":
        st.trim_by_min_id(_s(trim_arg))
    return rid.encode()


@register("XLEN")
@_stream_cmd
def cmd_xlen(server, ctx, args):
    return _stream(server, _s(args[0])).size()


def _xrange(server, args, reverse: bool):
    count = None
    if len(args) > 3:
        if bytes(args[3]).upper() != b"COUNT":
            raise RespError("ERR syntax error")
        count = _int(args[4])
    st = _stream(server, _s(args[0]))
    a, b = _s(args[1]), _s(args[2])
    d = st.rev_range(a, b, count) if reverse else st.range(a, b, count)
    return _xentries(d)


@register("XRANGE")
@_stream_cmd
def cmd_xrange(server, ctx, args):
    return _xrange(server, args, reverse=False)


@register("XREVRANGE")
@_stream_cmd
def cmd_xrevrange(server, ctx, args):
    return _xrange(server, args, reverse=True)


@register("XDEL")
@_stream_cmd
def cmd_xdel(server, ctx, args):
    return _stream(server, _s(args[0])).remove(*[_s(i) for i in args[1:]])


@register("XTRIM")
@_stream_cmd
def cmd_xtrim(server, ctx, args):
    kind = bytes(args[1]).upper()
    j = 2
    if bytes(args[j]) in (b"~", b"="):
        j += 1
    st = _stream(server, _s(args[0]))
    if kind == b"MAXLEN":
        return st.trim(_int(args[j]))
    if kind == b"MINID":
        return st.trim_by_min_id(_s(args[j]))
    raise RespError("ERR syntax error")


def _xread_streams(args, i):
    rest = args[i:]
    if not rest or len(rest) % 2:
        raise RespError("ERR Unbalanced XREAD list of streams: for each stream key an ID or '$' must be specified.")
    nk = len(rest) // 2
    return [_s(k) for k in rest[:nk]], [_s(v) for v in rest[nk:]]


@register("XREAD")
@_stream_cmd
def cmd_xread(server, ctx, args):
    """XREAD [COUNT n] [BLOCK ms] STREAMS key... id...  ('$' = from now)."""
    import time as _t

    count, block = None, None
    i = 0
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"COUNT":
            count = _int(args[i + 1])
            i += 2
        elif opt == b"BLOCK":
            block = _int(args[i + 1]) / 1000.0
            i += 2
        elif opt == b"STREAMS":
            i += 1
            break
        else:
            raise RespError("ERR syntax error")
    else:
        raise RespError("ERR syntax error")
    names, ids = _xread_streams(args, i)
    resolved = []
    for nm, fid in zip(names, ids):
        if fid == "$":
            fid = _stream(server, nm).last_id() or "0"
        resolved.append(fid)
    deadline = None if block is None else _t.time() + block
    while True:
        out = []
        for nm, fid in zip(names, resolved):
            d = _stream(server, nm).read(from_id=fid, count=count, timeout=0.0)
            if d:
                out.append([nm.encode(), _xentries(d)])
        if out:
            return out
        if deadline is None or _t.time() >= deadline or getattr(server, "_closing", False):
            return None  # no BLOCK, timed out, or the server is stopping
        server.engine.wait_entry(f"__stream__:{names[0]}").wait_for(
            min(0.05, max(0.0, deadline - _t.time()))
        )


@register("XGROUP")
@_stream_cmd
def cmd_xgroup(server, ctx, args):
    sub = bytes(args[0]).upper()
    st = _stream(server, _s(args[1]))
    if sub == b"CREATE":
        # MKSTREAM tolerated: records are created on first touch anyway
        st.create_group(_s(args[2]), from_id=_s(args[3]) if len(args) > 3 else "$")
        return "+OK"
    if sub == b"DESTROY":
        st.remove_group(_s(args[2]))
        return 1
    if sub == b"CREATECONSUMER":
        return 1 if st.create_consumer(_s(args[2]), _s(args[3])) else 0
    if sub == b"DELCONSUMER":
        return st.remove_consumer(_s(args[2]), _s(args[3]))
    if sub == b"SETID":
        st.set_group_id(_s(args[2]), _s(args[3]))
        return "+OK"
    raise RespError(f"ERR Unknown XGROUP subcommand or wrong number of arguments for '{_s(args[0])}'")


@register("XREADGROUP")
@_stream_cmd
def cmd_xreadgroup(server, ctx, args):
    """XREADGROUP GROUP g consumer [COUNT n] [BLOCK ms] [NOACK] STREAMS k id."""
    if bytes(args[0]).upper() != b"GROUP":
        raise RespError("ERR syntax error")
    group, consumer = _s(args[1]), _s(args[2])
    count, block, noack = None, None, False
    i = 3
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"COUNT":
            count = _int(args[i + 1])
            i += 2
        elif opt == b"BLOCK":
            block = _int(args[i + 1]) / 1000.0
            i += 2
        elif opt == b"NOACK":
            noack = True
            i += 1
        elif opt == b"STREAMS":
            i += 1
            break
        else:
            raise RespError("ERR syntax error")
    else:
        raise RespError("ERR syntax error")
    names, ids = _xread_streams(args, i)
    import time as _t

    deadline = None if block is None else _t.time() + block
    while True:
        out = []
        for nm, fid in zip(names, ids):
            st = _stream(server, nm)
            # non-blocking sweep across ALL streams: blocking inside one
            # stream would starve data already waiting in the next
            d = st.read_group(group, consumer, count=count, timeout=0.0, from_id=fid)
            if d:
                if noack:
                    st.ack(group, *d.keys())
                out.append([nm.encode(), _xentries(d)])
        if out:
            return out
        if deadline is None or _t.time() >= deadline or getattr(server, "_closing", False):
            return None  # no BLOCK, timed out, or the server is stopping
        server.engine.wait_entry(f"__stream__:{names[0]}").wait_for(
            min(0.05, max(0.0, deadline - _t.time()))
        )


@register("XACK")
@_stream_cmd
def cmd_xack(server, ctx, args):
    return _stream(server, _s(args[0])).ack(_s(args[1]), *[_s(i) for i in args[2:]])


@register("XPENDING")
@_stream_cmd
def cmd_xpending(server, ctx, args):
    st = _stream(server, _s(args[0]))
    group = _s(args[1])
    if len(args) == 2:  # summary form
        s = st.pending_summary(group)
        consumers = [
            [c.encode(), str(n).encode()] for c, n in sorted(s["consumers"].items())
        ]
        return [
            s["total"],
            s["min_id"].encode() if s["min_id"] else None,
            s["max_id"].encode() if s["max_id"] else None,
            consumers or None,
        ]
    # extended: [IDLE ms] start end count [consumer]
    i = 2
    min_idle = 0.0
    if bytes(args[i]).upper() == b"IDLE":
        min_idle = _int(args[i + 1]) / 1000.0
        i += 2
    lo, hi, count = _s(args[i]), _s(args[i + 1]), _int(args[i + 2])
    consumer = _s(args[i + 3]) if len(args) > i + 3 else None
    # idle filters BEFORE count (scanning order): counting first could
    # return empty while matching idle entries exist past the cut
    rows = st.pending_range(group, lo, hi, count=None, consumer=consumer)
    rows = [r for r in rows if r["idle"] >= min_idle][:count]
    return [
        [r["id"].encode(), r["consumer"].encode(),
         int(r["idle"] * 1000), r["delivered"]]
        for r in rows
    ]


@register("XCLAIM")
@_stream_cmd
def cmd_xclaim(server, ctx, args):
    st = _stream(server, _s(args[0]))
    group, consumer = _s(args[1]), _s(args[2])
    min_idle = _int(args[3]) / 1000.0
    ids = []
    justid = force = False
    i = 4
    while i < len(args):
        a = bytes(args[i]).upper()
        if a == b"JUSTID":
            justid = True
            i += 1
        elif a == b"FORCE":
            force = True
            i += 1
        elif a in (b"IDLE", b"TIME", b"RETRYCOUNT", b"LASTID"):
            # PEL metadata knobs: accepted for wire compatibility; delivery
            # stamps are managed server-side
            i += 2
        else:
            ids.append(_s(args[i]))
            i += 1
    claimed = st.claim(group, consumer, min_idle, *ids, force=force)
    if justid:
        return [i.encode() for i in claimed]
    return _xentries(claimed)


@register("XAUTOCLAIM")
@_stream_cmd
def cmd_xautoclaim(server, ctx, args):
    st = _stream(server, _s(args[0]))
    group, consumer = _s(args[1]), _s(args[2])
    min_idle = _int(args[3]) / 1000.0
    start = _s(args[4])
    count = 100
    justid = False
    i = 5
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"COUNT":
            count = _int(args[i + 1])
            i += 2
        elif opt == b"JUSTID":
            justid = True
            i += 1
        else:
            raise RespError("ERR syntax error")
    cursor, claimed = st.auto_claim(group, consumer, min_idle, start_id=start, count=count)
    body = [i.encode() for i in claimed] if justid else _xentries(claimed)
    return [cursor.encode(), body, []]


@register("XINFO")
@_stream_cmd
def cmd_xinfo(server, ctx, args):
    sub = bytes(args[0]).upper()
    st = _stream(server, _s(args[1]))
    if sub == b"STREAM":
        last = st.last_id()
        return [
            b"length", st.size(),
            b"last-generated-id", (last or "0-0").encode(),
            b"groups", len(st.list_groups()),
        ]
    if sub == b"GROUPS":
        out = []
        for g in st.list_groups():
            s = st.pending_summary(g)
            out.append([
                b"name", g.encode(),
                b"consumers", len(st.list_consumers(g)),
                b"pending", s["total"],
            ])
        return out
    if sub == b"CONSUMERS":
        group = _s(args[2])
        s = st.pending_summary(group)
        return [
            [b"name", c.encode(), b"pending", s["consumers"].get(c, 0)]
            for c in st.list_consumers(group)
        ]
    raise RespError(f"ERR syntax error in XINFO {_s(args[0])}")


# -- typed geo verbs (RedissonGeo.java wire parity) --------------------------

def _geo(server, name: str):
    return _typed_handle(server, "get_geo", name)


@register("GEOADD")
def cmd_geoadd(server, ctx, args):
    if (len(args) - 1) % 3:
        raise RespError("ERR syntax error")
    g = _geo(server, _s(args[0]))
    n = 0
    for i in range(1, len(args), 3):
        n += g.add(float(args[i]), float(args[i + 1]), bytes(args[i + 2]))
    return n


@register("GEOPOS")
def cmd_geopos(server, ctx, args):
    g = _geo(server, _s(args[0]))
    pos = g.pos(*[bytes(m) for m in args[1:]])
    out = []
    for m in args[1:]:
        p = pos.get(bytes(m))
        out.append(None if p is None else [repr(p[0]).encode(), repr(p[1]).encode()])
    return out


@register("GEODIST")
def cmd_geodist(server, ctx, args):
    unit = _s(args[3]).lower() if len(args) > 3 else "m"
    d = _geo(server, _s(args[0])).dist(bytes(args[1]), bytes(args[2]), unit=unit)
    return None if d is None else _fnum(round(d, 4))


@register("GEOSEARCH")
def cmd_geosearch(server, ctx, args):
    """GEOSEARCH key <FROMMEMBER m | FROMLONLAT lon lat>
    <BYRADIUS r unit | BYBOX w h unit> [ASC|DESC] [COUNT n [ANY]]
    [WITHCOORD] [WITHDIST]."""
    g = _geo(server, _s(args[0]))
    i = 1
    member, lonlat = None, None
    shape = None
    order, count = "ASC", None
    withcoord = withdist = False
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"FROMMEMBER":
            member = bytes(args[i + 1])
            i += 2
        elif opt == b"FROMLONLAT":
            lonlat = (float(args[i + 1]), float(args[i + 2]))
            i += 3
        elif opt == b"BYRADIUS":
            shape = ("radius", float(args[i + 1]), _s(args[i + 2]).lower())
            i += 3
        elif opt == b"BYBOX":
            shape = ("box", float(args[i + 1]), float(args[i + 2]), _s(args[i + 3]).lower())
            i += 4
        elif opt in (b"ASC", b"DESC"):
            order = _s(args[i]).upper()
            i += 1
        elif opt == b"COUNT":
            count = _int(args[i + 1])
            i += 2
            if i < len(args) and bytes(args[i]).upper() == b"ANY":
                i += 1
        elif opt == b"WITHCOORD":
            withcoord = True
            i += 1
        elif opt == b"WITHDIST":
            withdist = True
            i += 1
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    if shape is None or (member is None and lonlat is None):
        raise RespError("ERR syntax error")
    if member is not None:
        p = g.pos(member).get(member)
        if p is None:
            raise RespError("ERR could not decode requested zset member")
        lonlat = p
    if shape[0] == "radius":
        pairs = list(
            g.search_radius_with_distance(
                lonlat[0], lonlat[1], shape[1], unit=shape[2], count=count, order=order
            ).items()
        )
        pairs.sort(key=lambda p: p[1], reverse=order == "DESC")  # dicts drop order
    else:
        from redisson_tpu_torch.client.objects.geo import _UNITS, _haversine_m

        members = g.search_box(lonlat[0], lonlat[1], shape[1], shape[2], unit=shape[3])
        u = _UNITS[shape[3]]
        pairs = []
        for m in members:
            p = g.pos(m).get(m)
            dm = float(_haversine_m(lonlat[0], lonlat[1], p[0], p[1])) if p else 0.0
            pairs.append((m, dm / u))
        pairs.sort(key=lambda t: t[1], reverse=order == "DESC")
        if count is not None:
            pairs = pairs[:count]
    out = []
    for m, dist in pairs:
        m = m if isinstance(m, (bytes, bytearray)) else str(m).encode()
        if not (withcoord or withdist):
            out.append(m)
            continue
        row = [m]
        if withdist:
            row.append(_fnum(round(dist, 4)))
        if withcoord:
            p = g.pos(m).get(m)
            row.append([repr(p[0]).encode(), repr(p[1]).encode()] if p else None)
        out.append(row)
    return out


@register("GEOSEARCHSTORE")
def cmd_geosearchstore(server, ctx, args):
    """GEOSEARCHSTORE dest src FROMLONLAT lon lat BYRADIUS r unit — the
    store-variant subset the reference's searchStore covers."""
    dest, src = _s(args[0]), _s(args[1])
    if bytes(args[2]).upper() != b"FROMLONLAT" or bytes(args[5]).upper() != b"BYRADIUS":
        raise RespError("ERR syntax error (only FROMLONLAT ... BYRADIUS supported)")
    g = _geo(server, src)
    return g.store_search_radius_to(
        dest, float(args[3]), float(args[4]), float(args[6]), unit=_s(args[7]).lower()
    )


def _georadius(server, ctx, args, by_member: bool, allow_store: bool = True):
    """Legacy GEORADIUS[BYMEMBER] translated onto the GEOSEARCH engine
    (Redis 6.2 deprecates these in favor of GEOSEARCH; the reference's
    RedissonGeo still drives them — client/protocol/RedisCommands.java
    GEORADIUS defs).  STORE/STOREDIST subset: plain STORE only."""
    key = args[0]
    if by_member:
        head = [key, b"FROMMEMBER", args[1]]
        i = 4
        radius, unit = args[2], args[3]
    else:
        head = [key, b"FROMLONLAT", args[1], args[2]]
        i = 5
        radius, unit = args[3], args[4]
    head += [b"BYRADIUS", radius, unit]
    store = None
    tail = []
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt in (b"WITHCOORD", b"WITHDIST", b"ASC", b"DESC"):
            tail.append(args[i])
            i += 1
        elif opt == b"WITHHASH":
            i += 1  # geohash integers are not materialized here; ignored
        elif opt == b"COUNT":
            tail += [args[i], args[i + 1]]
            i += 2
            if i < len(args) and bytes(args[i]).upper() == b"ANY":
                tail.append(args[i])
                i += 1
        elif opt in (b"STORE", b"STOREDIST"):
            if not allow_store:
                raise RespError(
                    "ERR STORE option in GEORADIUS is not compatible with "
                    "the _RO variant"
                )
            if opt == b"STOREDIST":
                raise RespError("ERR STOREDIST is not supported; use STORE")
            store = _s(args[i + 1])
            i += 2
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    if store is not None:
        g = _geo(server, _s(key))
        if by_member:
            p = g.pos(bytes(args[1])).get(bytes(args[1]))
            if p is None:
                raise RespError("ERR could not decode requested zset member")
            lon, lat = p
        else:
            lon, lat = float(args[1]), float(args[2])
        return g.store_search_radius_to(
            store, lon, lat, float(radius), unit=_s(unit).lower()
        )
    return cmd_geosearch(server, ctx, head + tail)


@register("GEORADIUS")
def cmd_georadius(server, ctx, args):
    return _georadius(server, ctx, args, by_member=False)


@register("GEORADIUS_RO")
def cmd_georadius_ro(server, ctx, args):
    return _georadius(server, ctx, args, by_member=False, allow_store=False)


@register("GEORADIUSBYMEMBER")
def cmd_georadiusbymember(server, ctx, args):
    return _georadius(server, ctx, args, by_member=True)


@register("GEORADIUSBYMEMBER_RO")
def cmd_georadiusbymember_ro(server, ctx, args):
    return _georadius(server, ctx, args, by_member=True, allow_store=False)


