"""Connection handshake + pub/sub verbs (BaseConnectionHandler /
PublishSubscribeService parity): a copy of
``redisson_tpu/server/verbs/connection.py``, replying the same bytes."""

import pickle

from redisson_tpu_torch.net.resp import Push, RespError
from redisson_tpu_torch.server.registry import register, _s, _int
from redisson_tpu_torch.version import __version__ as VERSION
from redisson_tpu_torch.server.verbs.common import _glob_match

# -- connection handshake (BaseConnectionHandler.java:59-122 parity) ---------

@register("PING")
def cmd_ping(server, ctx, args):
    if args:
        return args[0]
    return "+PONG"


@register("ECHO")
def cmd_echo(server, ctx, args):
    return args[0]


@register("READONLY")
def cmd_readonly(server, ctx, args):
    """READONLY — arm replica reads for this connection (Redis cluster
    parity).  A cluster replica serves keyed reads only to connections
    that declared READONLY; everyone else is -MOVED to the master
    (server.check_routing of the reference).  No-op on masters, like
    Redis: the port's single-device server is always one."""
    if args:
        raise RespError("ERR wrong number of arguments for 'readonly' command")
    ctx.readonly = True
    return "+OK"


@register("READWRITE")
def cmd_readwrite(server, ctx, args):
    if args:
        raise RespError("ERR wrong number of arguments for 'readwrite' command")
    ctx.readonly = False
    return "+OK"


@register("AUTH")
def cmd_auth(server, ctx, args):
    """AUTH <password> | AUTH <username> <password> — the ACL form matches
    the reference handshake (BaseConnectionHandler.java:59-122 sends
    username+password when a username is configured).  "default" aliases
    the server-level password, like Redis ACL's default user."""
    if len(args) >= 2:
        username, password = _s(args[-2]), _s(args[-1])
    else:
        username, password = "default", _s(args[-1])
    if username == "default":
        # with ACL users configured but NO default password, the default
        # user is DISABLED — `AUTH anything` must not bypass the user gate
        if server.password is not None:
            ok = password == server.password
        else:
            ok = not server.users
    else:
        expected = server.users.get(username)
        ok = expected is not None and password == expected
    if ok:
        ctx.authenticated = True
        ctx.username = username
        return "+OK"
    raise RespError("WRONGPASS invalid username-password pair")


@register("HELLO")
def cmd_hello(server, ctx, args):
    """HELLO [protover [AUTH user pass]] — the real protocol switch
    (config/Config.java:57-99 protocol knob; CommandDecoder.java markers).
    This wire is RESP3-native by default; HELLO 2 downgrades the connection
    to the strict RESP2 projection (maps flatten, pushes become arrays)."""
    i = 0
    if args and bytes(args[0]).isdigit():
        ver = _int(args[0])
        if ver not in (2, 3):
            raise RespError("NOPROTO unsupported protocol version")
        ctx.proto = ver
        i = 1
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"AUTH" and i + 2 < len(args):
            cmd_auth(server, ctx, [args[i + 1], args[i + 2]])
            i += 3
        elif opt == b"SETNAME" and i + 1 < len(args):
            ctx.name = _s(args[i + 1])
            i += 2
        else:
            raise RespError(f"ERR unknown HELLO option '{_s(args[i])}'")
    return {
        b"server": b"redisson-tpu",
        b"version": VERSION.encode(),
        b"proto": ctx.proto,
        b"id": ctx.client_id,
        b"mode": server.mode.encode(),
        b"role": b"master" if server.role == "master" else b"replica",
    }


@register("SELECT")
def cmd_select(server, ctx, args):
    _int(args[0])  # single logical db: accept and ignore, like db 0 only
    return "+OK"


@register("CLIENT")
def cmd_client(server, ctx, args):
    sub = bytes(args[0]).upper() if args else b""
    if sub == b"SETNAME":
        ctx.name = _s(args[1])
        return "+OK"
    if sub == b"GETNAME":
        return ctx.name.encode() if ctx.name else b""
    if sub == b"ID":
        # STABLE identity for this connection's whole life (the redirect
        # target of CLIENT TRACKING REDIRECT; minting a fresh id per call
        # made redirect impossible to express)
        return ctx.client_id
    if sub == b"INFO":
        return _client_info_line(server, ctx)
    if sub == b"TRACKING":
        return _client_tracking(server, ctx, args[1:])
    if sub == b"QOS":
        return _client_qos(server, ctx, args[1:])
    if sub == b"TRACKINGINFO":
        st = server.tracking.state_of(ctx)
        from redisson_tpu_torch.tracking.table import ConnTracking

        if st is None:
            st = ConnTracking()
        return {
            b"flags": st.flags(),
            b"redirect": st.redirect if st.redirect is not None else -1,
            b"prefixes": [p.encode() for p in st.prefixes],
            b"keys": st.nkeys,
        }
    return "+OK"


def _client_info_line(server, ctx) -> bytes:
    """CLIENT INFO: the Redis one-line key=value shape (the fields this
    wire actually has; resp= is the negotiated protocol, tracking flags
    from the table)."""
    from redisson_tpu_torch.tracking.table import ConnTracking

    st = server.tracking.state_of(ctx)
    flags = b"|".join((st or ConnTracking()).flags())
    redirect = st.redirect if (st is not None and st.redirect) else -1
    return (
        f"id={ctx.client_id} name={ctx.name or ''} resp={ctx.proto} "
        f"user={ctx.username or 'default'} "
        f"tracking={flags.decode()} redirect={redirect} "
        f"sub={len(ctx.subscriptions)} psub={len(ctx.psubscriptions)}"
    ).encode()


def _client_tracking(server, ctx, args):
    """CLIENT TRACKING ON|OFF [REDIRECT <client-id>] [BCAST]
    [PREFIX <prefix>]... [NOLOOP] — the server-assisted caching switch
    (tracking/table.py; Redis 6 semantics for the options this wire
    supports)."""
    if not args:
        raise RespError("ERR wrong number of arguments for 'client|tracking'")
    mode = bytes(args[0]).upper()
    if mode not in (b"ON", b"OFF"):
        raise RespError("ERR syntax error in CLIENT TRACKING (ON|OFF expected)")
    redirect = None
    bcast = False
    noloop = False
    prefixes = []
    i = 1
    while i < len(args):
        opt = bytes(args[i]).upper()
        if opt == b"REDIRECT" and i + 1 < len(args):
            redirect = _int(args[i + 1])
            i += 2
        elif opt == b"BCAST":
            bcast = True
            i += 1
        elif opt == b"PREFIX" and i + 1 < len(args):
            prefixes.append(_s(args[i + 1]))
            i += 2
        elif opt == b"NOLOOP":
            noloop = True
            i += 1
        else:
            raise RespError(f"ERR unknown CLIENT TRACKING option '{_s(args[i])}'")
    if prefixes and not bcast:
        raise RespError(
            "ERR PREFIX option requires BCAST mode to be enabled"
        )
    if mode == b"OFF":
        server.tracking.disable(ctx)
        return "+OK"
    if redirect == 0:
        redirect = None  # Redis: REDIRECT 0 = no redirection
    if redirect is None and ctx.proto < 3:
        # Redis's own refusal: without RESP3 push frames the invalidation
        # could only arrive as a PLAIN array interleaved into the reply
        # stream, desyncing every later reply on this connection
        raise RespError(
            "ERR Client tracking is only supported in RESP3 mode or when "
            "a redirection client is specified via the 'REDIRECT' option"
        )
    server.tracking.enable(
        ctx, bcast=bcast, prefixes=prefixes, redirect=redirect, noloop=noloop
    )
    return "+OK"


def _client_qos(server, ctx, args):
    """CLIENT QOS CLASS <interactive|bulk|auto> [TENANT <t>] |
    CLIENT QOS TENANT <t> | CLIENT QOS GET — the deadline-class/tenant
    declaration of the QoS plane.  CLASS
    pins this connection's frames to a deadline class (auto restores the
    size heuristic); TENANT names the token bucket its ops are charged to
    (default: the frame's key {hashtag}).  GET reports the connection's
    declared state plus its tenant's live bucket level and shed count."""
    if not args:
        raise RespError("ERR wrong number of arguments for 'client|qos'")
    sub = bytes(args[0]).upper()
    if sub == b"CLASS":
        if len(args) < 2:
            raise RespError("ERR CLIENT QOS CLASS expects a class")
        cls = _s(args[1]).lower()
        if cls not in ("interactive", "bulk", "auto"):
            raise RespError(
                "ERR CLIENT QOS CLASS expects interactive|bulk|auto"
            )
        ctx.qos_class = None if cls == "auto" else cls
        rest = args[2:]
        if rest:
            if len(rest) != 2 or bytes(rest[0]).upper() != b"TENANT":
                raise RespError("ERR syntax error in CLIENT QOS CLASS")
            ctx.tenant = _s(rest[1]) or None
        return "+OK"
    if sub == b"TENANT":
        if len(args) != 2:
            raise RespError("ERR CLIENT QOS TENANT expects a tenant name")
        ctx.tenant = _s(args[1]) or None
        return "+OK"
    if sub == b"GET":
        sched = server.scheduler
        tenant = ctx.tenant or "default"
        level = 0.0
        sheds = 0
        for name, lvl, _adm, shed_ops, _sf, _w in sched.tenant_table():
            if name == tenant:
                level, sheds = lvl, shed_ops
                break
        return {
            b"class": (ctx.qos_class or "auto").encode(),
            b"tenant": tenant.encode(),
            b"armed": 1 if sched.armed else 0,
            b"bucket-level": int(level),
            b"shed-ops": sheds,
        }
    raise RespError(f"ERR unknown CLIENT QOS subcommand '{_s(args[0])}'")


@register("QUIT")
def cmd_quit(server, ctx, args):
    raise ConnectionResetError("client quit")


# -- pubsub ------------------------------------------------------------------

@register("SUBSCRIBE")
def cmd_subscribe(server, ctx, args):
    out = []
    for ch_raw in args:
        ch = _s(ch_raw)
        if ch not in ctx.subscriptions:
            push = ctx.push

            def listener(channel, msg, _push=push):
                _push(Push([b"message", channel.encode(), msg if isinstance(msg, bytes) else pickle.dumps(msg)]))

            ctx.subscriptions[ch] = server.engine.pubsub.subscribe(ch, listener)
        out.append(Push([b"subscribe", ch_raw, ctx.subscription_count()]))
    return out


@register("UNSUBSCRIBE")
def cmd_unsubscribe(server, ctx, args):
    chans = [_s(a) for a in args] or list(ctx.subscriptions)
    out = []
    for ch in chans:
        lid = ctx.subscriptions.pop(ch, None)
        if lid is not None:
            server.engine.pubsub.unsubscribe(ch, lid)
        out.append(Push([b"unsubscribe", ch.encode(), ctx.subscription_count()]))
    return out


@register("PSUBSCRIBE")
def cmd_psubscribe(server, ctx, args):
    out = []
    for pat_raw in args:
        pat = _s(pat_raw)
        if pat not in ctx.psubscriptions:
            push = ctx.push

            def listener(channel, msg, _push=push, _pat=pat):
                _push(Push([
                    b"pmessage", _pat.encode(), channel.encode(),
                    msg if isinstance(msg, bytes) else pickle.dumps(msg),
                ]))

            ctx.psubscriptions[pat] = server.engine.pubsub.psubscribe(pat, listener)
        out.append(Push([b"psubscribe", pat_raw, ctx.subscription_count()]))
    return out


@register("PUNSUBSCRIBE")
def cmd_punsubscribe(server, ctx, args):
    pats = [_s(a) for a in args] or list(ctx.psubscriptions)
    out = []
    for pat in pats:
        lid = ctx.psubscriptions.pop(pat, None)
        if lid is not None:
            server.engine.pubsub.punsubscribe(pat, lid)
        out.append(Push([b"punsubscribe", pat.encode(), ctx.subscription_count()]))
    return out


@register("PUBLISH")
def cmd_publish(server, ctx, args):
    return server.engine.pubsub.publish(_s(args[0]), bytes(args[1]))


@register("PUBSUB")
def cmd_pubsub(server, ctx, args):
    """PUBSUB CHANNELS [pattern] | NUMSUB [ch...] | NUMPAT |
    SHARDCHANNELS [pattern] | SHARDNUMSUB [ch...] — hub introspection
    (RedissonTopic.countSubscribers / getChannelNames role)."""
    hub = server.engine.pubsub
    sub = bytes(args[0]).upper() if args else b""
    if sub in (b"CHANNELS", b"SHARDCHANNELS"):
        prefix = _SHARD_NS if sub == b"SHARDCHANNELS" else ""
        pattern = _s(args[1]) if len(args) > 1 else "*"
        out = []
        for ch in hub.channels():
            if prefix:
                if not ch.startswith(prefix):
                    continue
                ch = ch[len(prefix):]
            elif ch.startswith(_SHARD_NS):
                continue  # shard channels live in their own namespace
            if _glob_match(pattern, ch):
                out.append(ch.encode())
        return sorted(out)
    if sub in (b"NUMSUB", b"SHARDNUMSUB"):
        prefix = _SHARD_NS if sub == b"SHARDNUMSUB" else ""
        out = []
        for raw in args[1:]:
            ch = _s(raw)
            out += [raw, hub.subscriber_count(prefix + ch)]
        return out
    if sub == b"NUMPAT":
        return len(hub._patterns)
    raise RespError(f"ERR Unknown PUBSUB subcommand '{_s(args[0]) if args else ''}'")


# sharded pubsub (Redis 7 SPUBLISH/SSUBSCRIBE): shard channels are a
# SEPARATE namespace (a PUBLISH must not reach an SSUBSCRIBE listener) —
# modeled as a reserved hub-channel prefix.  Slot routing happens client-
# side by channel name, same as the plain-SUBSCRIBE slot routing the
# cluster client already does (RedissonShardedTopic semantic parity).
_SHARD_NS = "__shard__:"


@register("SSUBSCRIBE")
def cmd_ssubscribe(server, ctx, args):
    out = []
    for ch_raw in args:
        ch = _s(ch_raw)
        hubch = _SHARD_NS + ch
        if hubch not in ctx.subscriptions:
            push = ctx.push

            def listener(channel, msg, _push=push, _ch=ch):
                _push(Push([
                    b"smessage", _ch.encode(),
                    msg if isinstance(msg, bytes) else pickle.dumps(msg),
                ]))

            ctx.subscriptions[hubch] = server.engine.pubsub.subscribe(hubch, listener)
        out.append(Push([b"ssubscribe", ch_raw, ctx.subscription_count()]))
    return out


@register("SUNSUBSCRIBE")
def cmd_sunsubscribe(server, ctx, args):
    chans = [_s(a) for a in args] or [
        c[len(_SHARD_NS):] for c in ctx.subscriptions if c.startswith(_SHARD_NS)
    ]
    out = []
    for ch in chans:
        lid = ctx.subscriptions.pop(_SHARD_NS + ch, None)
        if lid is not None:
            server.engine.pubsub.unsubscribe(_SHARD_NS + ch, lid)
        out.append(Push([b"sunsubscribe", ch.encode(), ctx.subscription_count()]))
    return out


@register("SPUBLISH")
def cmd_spublish(server, ctx, args):
    return server.engine.pubsub.publish(_SHARD_NS + _s(args[0]), bytes(args[1]))


