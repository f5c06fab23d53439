"""The port's RESP server (redisson_tpu_torch.server) against the reference
server (redisson_tpu.server) on the CPU: one command stream sent to each,
before and after HELLO 3, gets the same reply bytes; the HLL estimates hold
their contract; a run of BF blob commands takes one fused call; expiry,
pub/sub and tracking pushes, the CLI and the refusals."""
import hashlib
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu_torch.core import coalesce as CO
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.net.client import Connection
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.server import registry
from redisson_tpu_torch.server.verbs import sketch as SK
from redisson_tpu_torch.tools import wire_stream as W

ROOT = Path(__file__).resolve().parent.parent


def _both(waves, **kw):
    """The replies of a fresh reference server, then of a fresh port
    server on the CPU, to `waves` on one connection each."""
    out = []
    for make in (lambda: RefServerThread(port=0, **kw), lambda: ServerThread(port=0, device="cpu", **kw)):
        with make() as st:
            out.append(W.replies(st.server.host, st.server.port, waves))
    return out


def test_reply_digest_matches_the_reference():
    stream = W.mixed_stream(seed=0)
    waves = [stream, [("HELLO", "3")] + stream]
    want, got = _both(waves)
    for wave, (graw, g), (wraw, w) in zip(waves, got, want):
        assert W.compare(wave, g, w) == []
        assert hashlib.sha256(graw).hexdigest() == hashlib.sha256(wraw).hexdigest()
    # the stream reaches every family: coalesced runs, errors, RESP3 maps
    assert any(isinstance(r, resp.RespError) for r in got[0][1])
    assert isinstance(got[1][1][0], dict) and got[1][1][0][b"proto"] == 3


@pytest.mark.parametrize("kw", [{"qos": False}, {"overlap": False}, {"dispatch_ahead": 1}],
                         ids=["qos_off", "overlap_off", "one_frame_ahead"])
def test_reply_digest_matches_the_reference_with_a_plane_off(kw):
    """The QoS plane disarmed, the serial readback, and one frame in
    flight a connection: each keeps the reference's reply bytes."""
    stream = W.mixed_stream(seed=0)
    waves = [stream, [("HELLO", "3")] + stream]
    want, got = _both(waves, **kw)
    for wave, (graw, g), (wraw, w) in zip(waves, got, want):
        assert W.compare(wave, g, w) == []
        assert graw == wraw


def test_estimates_hold_their_contracts():
    stream = W.mixed_stream(seed=1, estimates=True)
    waves = [stream, [("HELLO", "3")] + stream]
    want, got = _both(waves)
    for wave, (_, g), (_, w) in zip(waves, got, want):
        assert W.compare(wave, g, w) == []
    replies = dict(zip((c[0] for c in stream), got[0][1]))
    assert replies["HLLA.ESTIMATE"] and len(replies["HLLA.ESTIMATE"]) == 32 * 8
    big = [r for c, r in zip(stream, got[0][1]) if c[:2] == ("PFCOUNT", "hll:big")]
    assert abs(big[0] - 400_000) < 0.02 * 400_000
    # the contract's tolerance is tight: a PFCOUNT one past it fails
    assert W.compare([("PFCOUNT", "x")], [400_000 + 3], [400_000]) != []


def _filters(conn, names, capacity=5000):
    conn.execute_many([("BF.RESERVE", n, "0.01", str(capacity)) for n in names])


def test_a_run_of_blob_commands_is_one_fused_call(monkeypatch):
    calls = []
    real = SK.coalesce_bloom_run

    def spy(server, ctx, cmds):
        calls.append(len(cmds))
        return real(server, ctx, cmds)

    monkeypatch.setattr(SK, "coalesce_bloom_run", spy)
    rng = np.random.default_rng(5)
    names = [f"f{i}" for i in range(16)]
    keys = [rng.integers(-2**62, 2**62, 64) for _ in names]
    probes = [np.concatenate([k[:32], rng.integers(-2**62, 2**62, 32)]) for k in keys]
    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        _filters(c, names)
        add = c.execute_many([("BF.MADD64", n, W._i8(k)) for n, k in zip(names, keys)])
        assert calls == [16] and all(r == b"\x01" * 64 for r in add)
        run = c.execute_many([("BF.MEXISTS64", n, W._i8(p)) for n, p in zip(names, probes)])
        assert calls == [16, 16]
        singles = [c.execute("BF.MEXISTS64", n, W._i8(p)) for n, p in zip(names, probes)]
        assert calls == [16, 16]  # a frame of one command is no run
    assert run == singles
    assert all(r[:32] == b"\x01" * 32 for r in run)


def test_a_run_larger_than_one_read_still_fuses(monkeypatch):
    """Config 5's blobs (10,000 keys, 80 KB) exceed the server's 64 KiB
    read: the frame is read to a command boundary before it dispatches."""
    calls = []
    real = SK.coalesce_bloom_run
    monkeypatch.setattr(SK, "coalesce_bloom_run",
                        lambda server, ctx, cmds: calls.append(len(cmds)) or real(server, ctx, cmds))
    names = [f"big{i}" for i in range(8)]
    keys = [np.arange(i * 10_000, (i + 1) * 10_000, dtype=np.int64) * 2654435761 for i in range(8)]
    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        _filters(c, names, 10_000)
        replies = c.execute_many([("BF.MADD64", n, W._i8(k)) for n, k in zip(names, keys)]
                                 + [("BF.MEXISTS64", n, W._i8(k)) for n, k in zip(names, keys)])
    assert calls == [8, 8]
    assert all(r == b"\x01" * 10_000 for r in replies[8:])


def test_a_kernel_failure_in_a_fused_run_replies_errors_per_command(monkeypatch):
    """The port keeps its choice against the reference's fallback: a fused
    contains run whose kernel fails (injected at the kernel wrapper the
    fused path launches, ``kernels.bloom_probe``) replies ``ERR internal``
    for every command of the run, counts each in ``stats["errors"]``, and
    never re-dispatches the run command by command."""
    names = [f"kf{i}" for i in range(5)]
    frame = [("BF.MEXISTS64", n, W._i8(np.arange(16))) for n in names]
    dispatched = []
    real_dispatch = registry.Registry.dispatch

    def counting(self, server, ctx, args):
        dispatched.append(bytes(args[0]))
        return real_dispatch(self, server, ctx, args)

    def failing_kernel(*a, **k):
        raise RuntimeError("injected kernel failure")

    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        _filters(c, names)
        assert c.execute_many(frame) == [b"\x00" * 16] * 5  # the fused run works
        monkeypatch.setattr(registry.Registry, "dispatch", counting)
        monkeypatch.setattr(K, "bloom_probe", failing_kernel)
        errors = st.server.stats["errors"]
        got = c.execute_many(frame)
        assert [str(e) for e in got] == ["ERR internal: RuntimeError: injected kernel failure"] * 5
        assert st.server.stats["errors"] == errors + 5
        assert dispatched == []  # no per-command dispatch ran
        monkeypatch.undo()
        assert c.execute_many(frame) == [b"\x00" * 16] * 5


def test_a_failed_fused_run_replies_errors_and_is_never_redispatched(monkeypatch):
    """Only an ineligible run takes the per-command route; any other
    failure of the fused launch replies one error a command."""
    names = [f"g{i}" for i in range(4)]
    frame = [("BF.MEXISTS64", n, W._i8(np.arange(8))) for n in names]
    real_contains = CO.fused_bloom_contains_async
    dispatched = []
    real_dispatch = registry.Registry.dispatch

    def counting(self, server, ctx, args):
        dispatched.append(bytes(args[0]))
        return real_dispatch(self, server, ctx, args)

    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        _filters(c, names)
        monkeypatch.setattr(registry.Registry, "dispatch", counting)
        want = c.execute_many(frame)  # the fused run
        assert dispatched == [] and want == [b"\x00" * 8] * 4

        def ineligible(*a, **k):
            raise CO.CoalesceIneligible("mixed geometry")

        monkeypatch.setattr(CO, "fused_bloom_contains_async", ineligible)
        assert c.execute_many(frame) == want  # per command, same replies
        assert dispatched == [b"BF.MEXISTS64"] * 4

        def broken(*a, **k):
            raise RuntimeError("launch failed")

        monkeypatch.setattr(CO, "fused_bloom_contains_async", broken)
        errors = st.server.stats["errors"]
        got = c.execute_many(frame)
        assert [str(e) for e in got] == ["ERR internal: RuntimeError: launch failed"] * 4
        assert dispatched == [b"BF.MEXISTS64"] * 4  # nothing re-dispatched
        assert st.server.stats["errors"] == errors + 4
        monkeypatch.setattr(CO, "fused_bloom_add_async", broken)
        got = c.execute_many([("BF.MADD64", n, W._i8(np.arange(8))) for n in names])
        assert all(isinstance(e, resp.RespError) for e in got)
        assert dispatched == [b"BF.MEXISTS64"] * 4

        # the frame's one grouped readback fails: every device reply of the
        # frame replies the error, nothing is copied reply by reply
        monkeypatch.setattr(CO, "fused_bloom_contains_async", real_contains)

        def no_copy(*a, **k):
            raise RuntimeError("copy failed")

        monkeypatch.setattr(ioplane, "gather_device_results", no_copy)
        errors = st.server.stats["errors"]
        got = c.execute_many(frame + [("PING",)])
        assert [str(e) for e in got[:4]] == ["ERR internal: RuntimeError: copy failed"] * 4
        assert got[4] == b"PONG" and st.server.stats["errors"] == errors + 4
        assert dispatched == [b"BF.MEXISTS64"] * 4 + [b"PING"]  # the run fused


def test_a_complete_command_waits_for_the_partial_one_behind_it():
    """A frame is read to a command boundary: a complete command ahead of
    a partial one is answered only once the rest arrives (the reference
    answers it at once), with the same reply bytes."""
    big = resp.encode_command("BF.MEXISTS64", "f", W._i8(np.arange(10_000)))  # 80 KB
    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        _filters(c, ["f"], 10_000)
        with socket.create_connection((st.server.host, st.server.port)) as s:
            parser = resp.RespParser(use_native=False)
            s.sendall(resp.encode_command("PING") + big[:1000])
            s.settimeout(0.5)
            with pytest.raises(socket.timeout):
                s.recv(1 << 16)
            s.sendall(big[1000:])
            raw, got = _read_values(s, parser, 2)
    assert raw.startswith(b"+PONG\r\n") and got[1] == b"\x00" * 10_000


def test_expiry_matches_the_reference():
    waves = [[("SET", "k", "v"), ("SET", "keep", "v"), ("PEXPIRE", "k", "50"), ("PTTL", "keep")],
             [("EXISTS", "k"), ("DBSIZE",), ("KEYS", "*"), ("GET", "k"), ("TTL", "k")]]
    out = []
    for make in (lambda: RefServerThread(port=0), lambda: ServerThread(port=0, device="cpu")):
        with make() as st:
            first = W.replies(st.server.host, st.server.port, waves[:1])
            time.sleep(0.15)
            out.append(first + W.replies(st.server.host, st.server.port, waves[1:]))
    assert [raw for raw, _ in out[1]] == [raw for raw, _ in out[0]]
    assert out[1][1][1][:2] == [0, 1]


def test_the_store_reaper_tells_tracking():
    with ServerThread(port=0, device="cpu") as st:
        store = st.server.engine.store
        assert store.on_expired == st.server.tracking.note_expired
        seen = []
        store.on_expired = seen.extend
        with st.client() as c:
            c.execute("SET", "a", "1", "PX", "20")
            time.sleep(0.05)
            assert st.server.engine.eviction is not None
            assert store.reap_expired() == 1 and seen == ["a"]


def _read_values(sock, parser, n, timeout=30.0):
    sock.settimeout(timeout)
    raw, got = b"", []
    while len(got) < n:
        data = sock.recv(1 << 16)
        assert data, "server closed early"
        raw += data
        got += parser.feed(data)
    return raw, got


def _pubsub_and_tracking(make):
    """The raw bytes a subscriber and a tracking client receive."""
    with make() as st:
        addr = (st.server.host, st.server.port)
        sub, pub, trk = (socket.create_connection(addr) for _ in range(3))
        parsers = [resp.RespParser(use_native=False) for _ in range(3)]
        try:
            out = []
            sub.sendall(resp.encode_command("SUBSCRIBE", "news", "more"))
            out.append(_read_values(sub, parsers[0], 2)[0])
            pub.sendall(resp.encode_commands([("PUBLISH", "news", "hello"), ("PUBLISH", "none", "x")]))
            out.append(_read_values(pub, parsers[1], 2)[0])
            out.append(_read_values(sub, parsers[0], 1)[0])
            trk.sendall(resp.encode_commands([("HELLO", "3"), ("CLIENT", "TRACKING", "on"),
                                              ("SET", "t", "1"), ("GET", "t")]))
            out.append(_read_values(trk, parsers[2], 4)[0])
            pub.sendall(resp.encode_command("SET", "t", "2"))
            out.append(_read_values(pub, parsers[1], 1)[0])
            out.append(_read_values(trk, parsers[2], 1)[0])  # the invalidation push
            return out
        finally:
            for s in (sub, pub, trk):
                s.close()


def test_pubsub_and_tracking_pushes_match_the_reference():
    want = _pubsub_and_tracking(lambda: RefServerThread(port=0))
    got = _pubsub_and_tracking(lambda: ServerThread(port=0, device="cpu"))
    assert got == want
    assert got[-1].startswith(b">2\r\n$10\r\ninvalidate")


def test_cli_serves_on_the_cpu():
    r, w = os.pipe()
    proc = subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch.server", "--device", "cpu", "--port", "0",
         "--ready-fd", str(w)], cwd=ROOT, pass_fds=(w,), stderr=subprocess.PIPE)
    os.close(w)
    try:
        with os.fdopen(r) as f:
            line = f.readline().split()
        assert line[0] == "READY" and int(line[3]) == proc.pid
        conn = Connection(line[1], int(line[2]), timeout=30)
        assert conn.execute("PING") == b"PONG"
        conn.close()
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0


def test_without_a_card_the_default_device_raises(monkeypatch):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "redisson_tpu_torch.server", "--port", "0"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServerThread()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServerThread(port=0, device="cuda:0")


@pytest.mark.parametrize("kw, milestone", [({"journal_dir": "/tmp/j"}, "M11"),
                                           ({"journal_dir": "/tmp/j", "checkpoint_path": "/tmp/x"},
                                            "M11")])
def test_left_out_arguments_refuse(kw, milestone):
    """Migration journals wait for M11 part 4, also beside a checkpoint
    path (which is served)."""
    with pytest.raises(NotImplementedError, match=milestone):
        ServerThread(port=0, device="cpu", **kw)


@pytest.mark.parametrize("devices", [2, "all", 1])
def test_devices_argument_places_the_slots(devices):
    """devices= maps the slot table onto that many positions ("all": the
    CPU's configured positions) and serves: CLUSTER DEVICES lists each
    position's slots."""
    from redisson_tpu_torch.parallel import mesh

    n = mesh.cpu_positions() if devices == "all" else devices
    with ServerThread(port=0, device="cpu", devices=devices) as st:
        assert st.server.engine.placement.n_devices == n
        with st.client() as c:
            reply = c.execute("CLUSTER", "DEVICES")
            assert reply[0] == n and sum(row[1] for row in reply[1:]) == 16384
            assert c.execute("SET", "k", "v") in (b"OK", "OK") and c.execute("GET", "k") == b"v"


def test_cluster_mode_and_advertised_host_are_served():
    """mode= and advertise_host= are taken: HELLO reports the mode, and a
    node is named by its advertised host in CLUSTER SLOTS."""
    with ServerThread(port=0, device="cpu", mode="cluster", advertise_host="10.0.0.1") as st:
        with st.client() as c:
            assert c.execute("HELLO", "3")[b"mode"] == b"cluster"
            (lo, hi, (host, port, nid)), = c.execute("CLUSTER", "SLOTS")
        assert (lo, hi, host, port) == (0, 16383, b"10.0.0.1", st.port)
        assert nid == st.server.node_id.encode()


def _race(fn, threads: int) -> None:
    """Run fn on `threads` threads at once with a short switch interval."""
    workers = [threading.Thread(target=fn) for _ in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in workers)


def test_tags_of_threaded_calls_are_distinct():
    """kernels._tagged_state under 1,000 calls from 20 threads: no two
    calls share a tag (a stand-in stream key: torch.cuda.current_stream
    needs a card)."""
    tags, lock = [], threading.Lock()
    stand_in = object()

    def calls():
        mine = [K._tagged_state("test_tags", torch.device("cpu"), 4, stream=stand_in)[1]
                for _ in range(50)]
        with lock:
            tags.extend(mine)

    _race(calls, 20)
    assert len(tags) == 1000 and len(set(tags)) == 1000


def test_launch_counts_are_not_lost_under_threads():
    K.reset_launches()

    def count():
        for _ in range(500):
            K.count_launch("bloom_probe")

    _race(count, 16)
    assert K.launches["bloom_probe"] == 8000
    K.reset_launches()


def test_a_frames_device_replies_leave_in_one_grouped_copy():
    """Every device reply of a frame (bit reads and writes, bank probes, a
    fused run, an HLL estimate) comes to the host in one grouped transfer:
    one blocking sync a frame in ioplane.STATS."""
    frame = [("SETBITSB", "b", W._i4([1, 5, 9])), ("GETBITSB", "b", W._i4([1, 2, 5])),
             ("BFA.MEXISTS64", "bank", W._i4([0, 1]), W._i8([7, 8])),
             ("BF.MEXISTS64", "f0", W._i8([1, 2])), ("BF.MEXISTS64", "f1", W._i8([3])),
             ("HLLA.ESTIMATE", "h"), ("BITOP", "OR", "b2", "b")]
    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        _filters(c, ["f0", "f1"])
        c.execute_many([("BFA.RESERVE", "bank", "2", "100", "0.01"), ("HLLA.RESERVE", "h", "4")])
        for n in (1, 2):
            ioplane.STATS.reset()
            replies = c.execute_many(frame)
            assert ioplane.STATS.snapshot()["blocking_syncs"] == 1, n
        assert replies[:2] == [b"\x01\x01\x01", b"\x01\x00\x01"] and replies[-1] == 2
        assert len(replies[5]) == 4 * 8


# -- the collections and the blocking plane -----------------------------------


def _registered(*modules):
    """The verbs the port registers from `modules` (server/verbs/*)."""
    return {v for v, fn in registry.REGISTRY._handlers.items()
            if fn.__module__.rsplit(".", 1)[-1] in modules}


KEYSPACE_COLLECTION_VERBS = {
    v.encode() for v in ("SADD SREM SISMEMBER SMEMBERS SCARD LPUSH RPUSH LPOP RPOP LLEN LRANGE LINDEX "
                         "ZADD ZSCORE ZREM ZCARD ZRANK ZINCRBY ZRANGE").split()}


def test_collections_stream_matches_the_reference():
    """Every set, list, sorted-set and hash-extra verb, the multi-pops and
    the blocking verbs, RESP2 then RESP3: the reference's reply bytes, but
    for the unordered and random verbs, which hold compare's contracts."""
    stream = W.collections_stream(seed=3)
    waves = [stream, [("HELLO", "3")] + stream]
    want, got = _both(waves)
    loose = W.UNORDERED_VERBS | W.RANDOM_VERBS
    for wave, (graw, g), (wraw, w) in zip(waves, got, want):
        assert W.compare(wave, g, w) == []
        gs, ws = W.reply_spans(graw), W.reply_spans(wraw)
        assert len(gs) == len(ws) == len(wave)
        assert [i for i, c in enumerate(wave) if W._verb(c) not in loose and gs[i] != ws[i]] == []
        assert sum(isinstance(r, resp.RespError) for r in g) > 30  # the error replies are reached
    assert isinstance(got[1][1][[c[0] for c in waves[1]].index("SMEMBERS")], set)  # RESP3 `~` frames
    reached = {W._verb(c) for c in stream}
    assert _registered("collections", "zset") | KEYSPACE_COLLECTION_VERBS <= reached
    assert KEYSPACE_COLLECTION_VERBS <= _registered("keyspace")


def test_compare_holds_the_random_verbs_to_their_contracts():
    cmds = [("SADD", "s", "a", "b", "c"), ("SMEMBERS", "s"), ("SRANDMEMBER", "s", "2"),
            ("SRANDMEMBER", "s", "-4"), ("SPOP", "s"), ("SPOP", "s", "5")]
    want = [3, [b"a", b"b", b"c"], [b"a", b"b"], [b"a"] * 4, b"c", [b"b", b"a"]]
    assert W.compare(cmds, [3, [b"c", b"a", b"b"], [b"c", b"a"], [b"b", b"b", b"c", b"a"], b"a",
                            [b"c", b"b"]], want) == []
    for at, bad in ((1, [b"a", b"b"]),          # SMEMBERS: another multiset
                    (2, [b"a", b"a"]),          # a repeat under a positive count
                    (2, [b"a", b"z"]),          # a member never stored
                    (3, [b"a"] * 3),            # |count| members for a negative count
                    (5, [b"c", b"a"])):         # SPOP: a member it popped before
        assert W.compare(cmds, want[:at] + [bad] + want[at + 1:], want) != []


def _send(sock, *cmd):
    sock.sendall(resp.encode_commands([cmd]))


def _read_reply(sock, timeout=10.0) -> bytes:
    """One reply's raw bytes; b"" when the server closed the connection."""
    sock.settimeout(timeout)
    buf = b""
    while True:
        try:
            spans = W.reply_spans(buf)
            if spans:
                return spans[0]
        except (ValueError, IndexError):
            pass
        data = sock.recv(65536)
        if not data:
            return buf
        buf += data


def _parked(server, n, timeout=5.0):
    """Wait until `n` blocking handlers are parked on the slow pool."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if sum(1 for t in threading.enumerate() if t.name.startswith("rtpu-slow")) >= n:
            time.sleep(0.1)  # the handler reaches its wait entry
            return
        time.sleep(0.01)
    raise AssertionError(f"{n} blocking handlers never parked")


def _blocking_scenarios(st) -> list:
    """Raw reply bytes of blocking verbs woken from another connection,
    timed out, and after HELLO 3."""
    host, port = st.server.host, st.server.port
    out = []
    with socket.create_connection((host, port)) as a, socket.create_connection((host, port)) as b:
        for park, wake in ((("BLPOP", "q", "q2", "5"), ("RPUSH", "q2", "v1", "v2")),
                           (("BZPOPMIN", "z", "5"), ("ZADD", "z", "1.5", "m", "2", "n")),
                           (("BLMOVE", "src", "dst", "LEFT", "RIGHT", "5"), ("RPUSH", "src", "x", "y")),
                           (("BRPOPLPUSH", "src2", "dst", "5"), ("LPUSH", "src2", "p")),
                           (("BZMPOP", "5", "1", "z2", "MAX", "COUNT", "2"), ("ZADD", "z2", "1", "a", "3", "b")),
                           (("BLMPOP", "5", "2", "l1", "l2", "RIGHT"), ("RPUSH", "l2", "r1", "r2"))):
            t0 = time.time()
            _send(a, *park)
            _parked(st.server, 1)
            _send(b, *wake)
            out += [_read_reply(b), _read_reply(a), time.time() - t0 < 4]
        for cmd in (("LRANGE", "dst", "0", "-1"), ("ZRANGE", "z", "0", "-1", "WITHSCORES"),
                    ("BLPOP", "none", "0.1"), ("BZPOPMAX", "none", "0.1"), ("HELLO", "3"),
                    ("BLPOP", "none", "0.1"), ("BZPOPMIN", "z", "0.1"), ("BLMOVE", "none", "x", "LEFT", "LEFT", "0.1")):
            _send(a, *cmd)
            out.append(_read_reply(a) if cmd[0] != "HELLO" else bool(_read_reply(a)))
    return out


def test_blocking_verbs_woken_and_timed_out_match_the_reference():
    got = []
    for make in (lambda: RefServerThread(port=0), lambda: ServerThread(port=0, device="cpu")):
        with make() as st:
            got.append(_blocking_scenarios(st))
    assert got[1] == got[0]
    assert got[1][1] == b"*2\r\n$2\r\nq2\r\n$2\r\nv1\r\n" and got[1][2]
    assert got[1][-3] == b"_\r\n"  # the RESP3 nil of a timed-out BLPOP


def test_more_parked_waiters_than_workers_leave_ping_answered():
    with ServerThread(port=0, device="cpu", workers=2) as st:
        host, port = st.server.host, st.server.port
        waiters = [socket.create_connection((host, port)) for _ in range(6)]
        try:
            for i, w in enumerate(waiters):
                _send(w, "BLPOP", f"jobs{i % 2}", "10")
            _parked(st.server, 6)
            with st.client() as c:
                t0 = time.time()
                assert c.execute("PING") == b"PONG"
                assert time.time() - t0 < 1.0
                assert c.execute("RPUSH", "jobs0", "a", "b", "c") == 3
                assert c.execute("RPUSH", "jobs1", "d", "e", "f") == 3
            got = sorted(_read_reply(w) for w in waiters)
        finally:
            for w in waiters:
                w.close()
    assert [g.split(b"\r\n")[-2] for g in got] == [b"a", b"b", b"c", b"d", b"e", b"f"]


def test_stop_unparks_a_waiter():
    """stop() unparks a BLPOP parked forever: the reference and the port
    both end the connection (at most the nil reply first), and the parked
    handler returns."""
    seen = []
    for make in (lambda: RefServerThread(port=0), lambda: ServerThread(port=0, device="cpu")):
        st = make().start()
        a = socket.create_connection((st.server.host, st.server.port))
        try:
            _send(a, "BLPOP", "never", "0")
            _parked(st.server, 1)
            slow = [t for t in threading.enumerate() if t.name.startswith("rtpu-slow")]
            st.stop()
            seen.append(_read_reply(a, timeout=5.0))
            for t in slow:
                t.join(5.0)
            assert not any(t.is_alive() for t in slow)
            assert st.server._closing
        finally:
            a.close()
    assert all(s in (b"", b"*-1\r\n") for s in seen), seen


def test_set_verbs_are_served_and_copy_waits_for_checkpoints():
    """COPY came with the checkpoints: it clones the set, which then lives
    on its own."""
    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        assert c.execute("SADD", "s", "a", "b") == 2
        assert c.execute("SCARD", "s") == 2
        assert c.execute("COPY", "s", "t") == 1
        assert c.execute("COPY", "s", "t") == 0
        assert c.execute("SADD", "t", "c") == 1
        assert sorted(c.execute("SMEMBERS", "t")) == [b"a", b"b", b"c"]
        assert c.execute("SCARD", "s") == 2


def _collection_invalidations(make):
    """The raw bytes a tracking client receives while another connection
    writes the set, list and sorted set it read (a pop among the writes)."""
    with make() as st:
        addr = (st.server.host, st.server.port)
        trk, w = (socket.create_connection(addr) for _ in range(2))
        tp, wp = resp.RespParser(use_native=False), resp.RespParser(use_native=False)
        try:
            w.sendall(resp.encode_commands([("SADD", "s", "a"), ("RPUSH", "l", "x", "y"), ("ZADD", "z", "1", "m")]))
            out = [_read_values(w, wp, 3)[0]]
            trk.sendall(resp.encode_commands([("HELLO", "3"), ("CLIENT", "TRACKING", "on"), ("SMEMBERS", "s"),
                                              ("LRANGE", "l", "0", "-1"), ("ZRANGE", "z", "0", "-1")]))
            out.append(_read_values(trk, tp, 5)[0])
            for cmd in (("SADD", "s", "b"), ("LPOP", "l"), ("ZINCRBY", "z", "2", "m")):
                w.sendall(resp.encode_command(*cmd))
                out.append(_read_values(w, wp, 1)[0])
                out.append(_read_values(trk, tp, 1)[0])  # the invalidation push
            return out
        finally:
            trk.close()
            w.close()


def test_collection_writes_invalidate_tracked_keys_as_the_reference_does():
    want = _collection_invalidations(lambda: RefServerThread(port=0))
    got = _collection_invalidations(lambda: ServerThread(port=0, device="cpu"))
    assert got == want
    assert [g[:14] for g in got[3::2]] == [b">2\r\n$10\r\ninval"] * 3
