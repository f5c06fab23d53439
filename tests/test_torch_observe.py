"""The observability and durability verbs against the reference server's,
on the CPU.

One command stream goes to a ``redisson_tpu`` server and to a port server,
in RESP2 and in RESP3:

  * the durability stream: DUMP of every record kind the stream makes,
    RESTORE under new names (with a TTL, with and without REPLACE, BUSYKEY,
    the error forms), COPY (with and without REPLACE), SAVE to a path,
    LASTSAVE and RESTORESTATE.  Every reply's bytes must be equal, DUMP's
    blobs included;
  * the observability stream: ROLE, TRACE CONFIG, SLOWLOG LEN/GET/RESET,
    LATENCY LATEST/HISTORY/RESET, METRICS and TRACE GET.  The replies are
    equal outside their times: a SLOWLOG or LATENCY entry's timestamp and
    durations, a METRICS timer's seconds (and ``dropped_pushes``, a count
    over the whole process), and TRACE's times are left out
    (and SLOWLOG's entry ids, which count on across the process, compared
    from the reply's oldest),
    and TRACE's span trees are compared as shapes (verb, command count,
    class, tenant and the span names of each frame).  The port's own spans,
    ``encode`` (the reply encoding) and ``launch`` (the host side of a
    kernel launch on the card), which the reference does not record, are
    left out of every comparison (SLOWLOG's stage list, LATENCY's events,
    METRICS's ``stage_*`` timers, TRACE's span names); the count LATENCY
    RESET replies first depends on what earlier tests of the process put in
    each package's tracer, so only its type is compared.

A traced frame on a ``devices=2`` server carries the lane's ``stage`` and
``dispatch`` spans on both packages, and ``tools/trace_dump`` reads the
port's ring.  Tolerance: none.
"""
import io
import os
import re
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from redisson_tpu.observe import trace as ref_obs
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.observe import trace as port_obs
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.tools import trace_dump
from redisson_tpu_torch.tools import wire_stream as W


@pytest.fixture(autouse=True)
def _disarm_tracing():
    saved = (port_obs.tracing_enabled(), ref_obs.tracing_enabled())
    yield
    port_obs.set_tracing(saved[0])
    ref_obs.set_tracing(saved[1])


def _servers(**kw):
    return (lambda: RefServerThread(port=0, **kw),
            lambda: ServerThread(port=0, device="cpu", **kw))


def _drive(make, proto, waves_of):
    """Send the waves `waves_of(previous replies)` yields, one pipelined
    write each, on one connection; returns the raw reply spans and parsed
    replies of every wave."""
    with make() as st:
        host, port = st.server.host, st.server.port
        import socket

        out = []
        with socket.create_connection((host, port), timeout=120) as s:
            parser = resp.RespParser(use_native=False)
            prev = []
            gen = waves_of(proto)
            wave = next(gen)
            while True:
                s.sendall(resp.encode_commands(list(wave)))
                raw, got = [], []
                while len(got) < len(wave):
                    data = s.recv(1 << 20)
                    assert data, "server closed the connection early"
                    raw.append(data)
                    got += parser.feed(data)
                out.append((W.reply_spans(b"".join(raw)), got))
                prev = got
                # let the frame's trace finish before the next wave reads
                # the ring (a trace ends once its reply is written)
                time.sleep(0.05)
                try:
                    wave = gen.send(prev)
                except StopIteration:
                    break
        return out


# -- the durability stream -------------------------------------------------------

_KEYS = ["s1", "l1", "h1", "z1", "bf1", "hll1", "bits1", "ctr1"]


def _durability_waves(path):
    def waves(proto):
        if proto == 3:
            yield [("HELLO", "3")]
        rng = np.random.default_rng(21)
        keys = rng.integers(0, 1 << 60, 300)
        yield [("SET", "s1", "v1"), ("RPUSH", "l1", "a", "b", "c"), ("HSET", "h1", "f", "v", "g", "w"),
               ("ZADD", "z1", "1.5", "a", "2", "b"), ("BF.RESERVE", "bf1", "0.01", "1000"),
               ("BF.MADD64", "bf1", W._i8(keys)), ("PFADD", "hll1", "a", "b", "c", "d"),
               ("SETBIT", "bits1", "7", "1"), ("INCRBY", "ctr1", "41")]
        dumps = yield [("DUMP", k) for k in _KEYS] + [("DUMP", "nokey")]
        blobs = dict(zip(_KEYS, dumps))
        yield ([("RESTORE", f"{k}:r", "0", blobs[k]) for k in _KEYS]
               + [("RESTORE", "s1:r", "0", blobs["s1"]),                 # BUSYKEY
                  ("RESTORE", "s1:r", "0", blobs["s1"], "REPLACE"),
                  ("RESTORE", "s1:t", "100000", blobs["s1"]), ("EXISTS", "s1:t"),
                  ("RESTORE", "s1:p", "0", blobs["s1"], "PERSIST"), ("TTL", "s1:p"),
                  ("RESTORE", "x", "-1", blobs["s1"]), ("RESTORE", "x", "0", blobs["s1"], "BOGUS"),
                  ("RESTORE", "x", "0", b"garbage")])
        yield [("GET", "s1:r"), ("LRANGE", "l1:r", "0", "-1"), ("HGETALL", "h1:r"),
               ("ZRANGE", "z1:r", "0", "-1", "WITHSCORES"), ("BF.MEXISTS64", "bf1:r", W._i8(keys[:64])),
               ("PFCOUNT", "hll1:r"), ("GETBIT", "bits1:r", "7"), ("GET", "ctr1:r"), ("TYPE", "bf1:r")]
        yield [("COPY", "s1", "s1:c"), ("COPY", "s1", "s1:c"), ("SET", "s1", "v2"),
               ("COPY", "s1", "s1:c", "REPLACE"), ("GET", "s1:c"), ("COPY", "nokey", "x"),
               ("COPY", "bf1", "bf1:c"), ("BF.MADD64", "bf1:c", W._i8(keys[:8] + 1)),
               ("BF.MEXISTS64", "bf1", W._i8(keys[:8] + 1)), ("BF.MEXISTS64", "bf1:c", W._i8(keys[:8] + 1)),
               ("COPY", "hll1", "hll1:c"), ("PFADD", "hll1:c", "e"), ("PFCOUNT", "hll1"), ("PFCOUNT", "hll1:c"),
               ("COPY", "z1", "z1:c"), ("ZRANGE", "z1:c", "0", "-1")]
        yield [("SAVE",), ("SAVE", path), ("LASTSAVE",), ("CONFIG", "SET", "checkpoint-path", path),
               ("DEL", "s1", "l1", "bf1"), ("EXISTS", "s1", "l1", "bf1")]
        yield [("RESTORESTATE",), ("GET", "s1"), ("LRANGE", "l1", "0", "-1"),
               ("BF.MEXISTS64", "bf1", W._i8(keys[:64])), ("RESTORESTATE", path + ".missing"),
               ("DBSIZE",)]
    return waves


@pytest.mark.parametrize("proto", [2, 3])
def test_durability_stream_replies_equal_the_reference(tmp_path, proto):
    path = str(tmp_path / "wire.ckpt")
    got = []
    for make in _servers():
        got.append(_drive(make, proto, _durability_waves(path)))
        for p in (path, path + ".1", path + ".2"):
            if os.path.exists(p):
                os.unlink(p)
    want, have = got
    assert len(have) == len(want)
    for i, ((ws, wv), (hs, hv)) in enumerate(zip(want, have)):
        assert len(hs) == len(ws), f"wave {i}"
        for j, (h, w) in enumerate(zip(hs, ws)):
            assert h == w, f"wave {i} reply {j}: {h[:200]!r} != {w[:200]!r}"
    # the stream reached what it should: a blob per record, a BUSYKEY, the
    # restored state read back after RESTORESTATE
    dumps = want[2 if proto == 3 else 1][1]
    assert all(isinstance(b, bytes) and len(b) > 50 for b in dumps[:-1]) and dumps[-1] is None
    assert any("BUSYKEY" in str(r) for r in want[3 if proto == 3 else 2][1])


# -- the observability stream ---------------------------------------------------------


def _obs_waves(proto):
    if proto == 3:
        yield [("HELLO", "3")]
    # the tracer's knobs are the process's: an earlier test of the process
    # may have moved them, so the stream sets each before it reads them
    yield [("CONFIG", "SET", "trace-enabled", "yes"), ("CONFIG", "SET", "slowlog-log-slower-than", "0"),
           ("CONFIG", "SET", "trace-ring-capacity", "512"), ("CONFIG", "SET", "slowlog-max-len", "128"),
           ("TRACE", "RESET"), ("SLOWLOG", "RESET"), ("LATENCY", "RESET")]
    keys = np.arange(500, dtype=np.int64) * 7919
    yield [("SET", "a", "1"), ("GET", "a"), ("BF.RESERVE", "bf", "0.01", "1000")]
    yield [("BF.MADD64", "bf", W._i8(keys)), ("BF.MEXISTS64", "bf", W._i8(keys))]
    yield [("BF.MEXISTS64", "bf", W._i8(keys))]
    yield [("ROLE",), ("TRACE", "CONFIG", "GET"), ("TRACE", "CONFIG", "SET", "trace-ring-capacity", "512"),
           ("TRACE", "CONFIG", "SET", "nope", "1"), ("TRACE", "BOGUS"), ("SLOWLOG", "BOGUS"),
           ("LATENCY", "BOGUS"), ("LATENCY", "HISTORY")]
    yield [("SLOWLOG", "LEN")]
    yield [("SLOWLOG", "GET", "3"), ("SLOWLOG", "GET")]
    yield [("LATENCY", "LATEST"), ("LATENCY", "HISTORY", "total"), ("LATENCY", "HISTORY", "nope")]
    yield [("TRACE", "GET", "20"), ("TRACE", "GET", "50", "BY", "dispatch")]
    yield [("METRICS",)]
    yield [("SLOWLOG", "RESET"), ("SLOWLOG", "LEN"), ("LATENCY", "RESET", "total"), ("TRACE", "RESET"),
           ("TRACE", "GET"), ("CONFIG", "SET", "trace-enabled", "no")]


PORT_ONLY_SPANS = {b"encode", b"launch"}


def _times_out(cmd, reply):
    """`reply` with its times and the port's own spans left out (see the
    module docstring)."""
    verb = cmd[0].upper() if isinstance(cmd[0], str) else cmd[0]
    sub = cmd[1].upper() if len(cmd) > 1 and isinstance(cmd[1], str) else None
    if verb == "SLOWLOG" and sub == "GET":
        # entry ids count on across SLOWLOG RESET, as Redis's do: compared
        # from the reply's first
        base = reply[-1][0] if reply else 0
        return [[e[0] - base, e[3], [st for st, _us in e[4] if st not in PORT_ONLY_SPANS]] for e in reply]
    if verb == "LATENCY" and sub == "LATEST":
        return [e[0] for e in reply if e[0] not in PORT_ONLY_SPANS]
    if verb == "LATENCY" and sub == "HISTORY" and isinstance(reply, list):
        return len(reply)
    if verb == "LATENCY" and sub == "RESET" and len(cmd) == 2:
        return type(reply)
    if verb == "TRACE" and sub == "GET":
        # shapes: (verb, commands, class, tenant, span names), as a multiset
        return sorted(repr([t[3], t[4], t[5], t[6], [sp[0] for sp in t[7] if sp[0] not in PORT_ONLY_SPANS]])
                      for t in reply)
    if verb == "METRICS":
        text = reply.decode() if isinstance(reply, bytes) else str(reply)
        # timers' seconds are times; dropped_pushes counts the whole
        # process's client pushes, whatever earlier tests of it dropped
        return [re.sub(r"(_seconds|^rtpu_dropped_pushes) .*$", r"\1 T", line) for line in text.splitlines()
                if not re.match(r"rtpu_stage_(encode|launch)_", line)]
    return reply


@pytest.mark.parametrize("proto", [2, 3])
def test_observability_stream_replies_equal_the_reference(proto):
    runs = [_drive(make, proto, _obs_waves) for make in _servers()]
    waves = list(_obs_waves(proto))
    flat = [c for w in waves for c in w]
    # the generator above needs no replies, so its waves are the ones sent
    (want, have) = ([(s, v) for ws, wv in run for s, v in zip(ws, wv)] for run in runs)
    assert len(have) == len(want) == len(flat)
    for cmd, (hs, hv), (ws, wv) in zip(flat, have, want):
        if _times_out(cmd, wv) is wv:
            assert hs == ws, f"{cmd[:3]}: {hs[:300]!r} != {ws[:300]!r}"
        else:
            assert _times_out(cmd, hv) == _times_out(cmd, wv), cmd[:3]
    first = {}
    for c, (_s, v) in zip(flat, have):
        first.setdefault(c[:2], v)
    # the stream read populated rings: frames in the slowlog, rows in
    # LATENCY LATEST, spans in TRACE, stage timers in METRICS
    assert first[("SLOWLOG", "LEN")] >= 4
    assert len(first[("LATENCY", "LATEST")]) >= 4
    assert len(first[("TRACE", "GET")]) >= 5
    metrics = bytes(first[("METRICS",)]).decode()
    assert "rtpu_stage_dispatch_count" in metrics and "rtpu_record_bytes_dev0" in metrics


# -- spans of a devices= server -------------------------------------------------------


def _traced_frame_spans(make):
    with make() as st, st.client() as c:
        c.execute("CONFIG", "SET", "trace-enabled", "yes")
        c.execute("TRACE", "RESET")
        names = [f"t{{{i}}}" for i in range(6)]
        c.execute_many([("BF.RESERVE", n, "0.01", "1000") for n in names])
        keys = W._i8(np.arange(64) * 31)
        c.execute_many([("BF.MEXISTS64", n, keys) for n in names] + [("SET", "k", "v")])
        c.execute("BF.MEXISTS64", names[0], keys)
        time.sleep(0.1)
        traces = c.execute("TRACE", "GET", "10")
        c.execute("CONFIG", "SET", "trace-enabled", "no")
    return sorted(
        (bytes(t[3]).decode(), int(t[4]),
         sorted(bytes(sp[0]).decode() for sp in t[7] if bytes(sp[0]) not in PORT_ONLY_SPANS))
        for t in traces
    )


@pytest.mark.parametrize("devices", [2, 1])
def test_a_traced_frame_on_a_devices_server_has_stage_and_dispatch_spans(devices):
    want, got = (_traced_frame_spans(make) for make in _servers(devices=devices))
    assert got == want
    frames = [spans for verb, n, spans in got if verb == "BF.MEXISTS64"]
    assert frames and all("stage" in s and "dispatch" in s for s in frames)


def test_trace_dump_reads_the_port_s_ring():
    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        c.execute("CONFIG", "SET", "trace-enabled", "yes")
        c.execute("TRACE", "RESET")
        c.execute("BF.RESERVE", "td", "0.01", "1000")
        c.execute_many([("BF.MADD64", "td", W._i8(np.arange(32))), ("GET", "td:x")])
        time.sleep(0.1)
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert trace_dump.main(["--port", str(st.port), "--n", "5"]) == 0
        text = buf.getvalue()
        entries = trace_dump.fetch(st.server.host, st.port, 5, "total")
        c.execute("CONFIG", "SET", "trace-enabled", "no")
    assert "BF.MADD64" in text
    for entry in entries:
        lines = trace_dump.render_trace(entry).splitlines()
        assert lines[0].startswith(f"trace {entry[0]}")
        names = [ln.split()[0] for ln in lines[1:]]
        assert names == [bytes(sp[0]).decode() for sp in entry[7] if not bytes(sp[0]).endswith(b".member")]
        assert {"parse", "dispatch", "reply"} <= set(names)


def test_the_port_registers_every_verb_but_the_replication_ones():
    """The slice's 14 verbs are registered, and the replication verbs and
    WAIT since; with IMPORTRECORDS (the migration slice) the port registers
    every one of the reference's 290 verbs."""
    import redisson_tpu.server.server  # noqa: F401 — registers the verbs
    import redisson_tpu_torch.server.server  # noqa: F401
    from redisson_tpu.server import registry as ref_registry
    from redisson_tpu_torch.server import registry as port_registry

    ref, port = set(ref_registry.REGISTRY._handlers), set(port_registry.REGISTRY._handlers)
    assert port - ref == set()
    assert ref - port == set() and len(port) == 290
    assert {b"REPLFLUSH", b"REPLPING", b"REPLPUSH", b"REPLPUSHSEG", b"REPLREGISTER",
            b"REPLSNAPSHOT", b"REPLSTATE", b"WAIT", b"REPLICAOF", b"REPLICAS"} <= port
    assert {b"ROLE", b"METRICS", b"TRACE", b"SLOWLOG", b"LATENCY", b"SAVE", b"BGSAVE", b"BGREWRITEAOF",
            b"LASTSAVE", b"SHUTDOWN", b"RESTORESTATE", b"DUMP", b"RESTORE", b"COPY"} <= port
