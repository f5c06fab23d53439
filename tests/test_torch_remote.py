"""The port's wire clients (redisson_tpu_torch.client.remote / .aio) against
the reference's, on the CPU.

One op stream goes through a client to a server of each package, in all
four pairings: the port's RemoteRedisson (and AsyncRemoteRedisson) to a
port ServerThread(device="cpu"), the reference's clients to a reference
ServerThread, and each package's client to the other's server.  Every
result must equal the reference pair's, and the port server's stored
records the reference server's.  The stream covers the typed sketch
handles, generic OBJCALL proxies (and the typed handles' OBJCALL
fallback), an OBJCALLM batch, a RemoteBatch (plain and atomic),
MULTI/EXEC with WATCH (clean and aborted), a RemoteTransaction committed
by TXEXEC and one refused (TXCONFLICT), a lock held over the wire against a
second client, and a topic.  The HLLA estimates are held to queue 3's
contract (``tools/wire_stream.EST_RTOL``); every other result is equal.

Also: the OBJCALL stream of ``tools/wire_stream.objcall_stream`` gets the
reference server's reply bytes in RESP2 and RESP3; no R/E/M reply names a
torch global, even for a method returning a tensor or raising a torch
error; and shutting a sync, an async and a tracked client down leaves no
thread of theirs behind."""
import asyncio
import pickle
import pickletools
import threading
import time

import numpy as np
import pytest
import torch

import redisson_tpu.client.aio as ref_aio
import redisson_tpu.client.remote as ref_remote
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu_torch import state
from redisson_tpu_torch.client import aio as port_aio
from redisson_tpu_torch.client import remote as port_remote
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.net.safe_pickle import safe_loads
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.server.server import TpuServer
from redisson_tpu_torch.tools import wire_stream as W

TIMEOUT = 60.0
CLIENTS = {"port": (port_remote.RemoteRedisson, port_aio.AsyncRemoteRedisson),
           "ref": (ref_remote.RemoteRedisson, ref_aio.AsyncRemoteRedisson)}


def _server(pkg):
    return ServerThread(port=0, device="cpu") if pkg == "port" else RefServerThread(port=0)


def _norm(v):
    """A result comparable across packages: arrays as (dtype, list),
    exceptions as (type name, message)."""
    if isinstance(v, np.ndarray):
        return ("b" if v.dtype == np.bool_ else v.dtype.str), v.tolist()
    if isinstance(v, (np.integer, np.bool_)):
        return v.item()
    if isinstance(v, BaseException):
        return ("raised", type(v).__name__, str(v))
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


def call(fn, *args, **kw):
    try:
        return _norm(fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the exception is the result
        return _norm(e)


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


NAMES = ["rs:bf", "rs:bfs", "rs:bfa", "rs:hlla", "rs:h", "rs:h2", "rs:bits", "rs:bits2", "rs:map",
         "rs:list", "rs:al", "rs:z", "rs:bucket", "rs:w", "rs:tx:b", "rs:tx:m", "rs:tx:c", "rs:batch:m",
         "rs:batch:al", "rs:q"]


def drive_sync(cls, address, seed=0):
    """The op stream through `cls` (a RemoteRedisson of either package);
    returns (results, estimates)."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-2**62, 2**62, 600)
    tenants = rng.integers(0, 8, 600).astype(np.int32)
    out, est = [], []
    c = cls(address, timeout=TIMEOUT)
    c2 = cls(address, timeout=TIMEOUT)
    try:
        # the typed sketch handles (blob verbs) and their OBJCALL fallback
        bf = c.get_bloom_filter("rs:bf")
        out += [call(bf.try_init, 5000, 0.01), call(bf.try_init, 5000, 0.01),
                call(bf.add_each, ints[:300]), call(bf.contains_each, ints[150:450]),
                call(bf.add, "one"), call(bf.contains, "one"), call(bf.contains, "two"),
                call(bf.add_all, ["a", "b", "c"]), call(bf.count_contains, ["a", "z"]),
                call(bf.get_expected_insertions), call(bf.get_size), call(bf.get_hash_iterations)]
        bfs = c.get_bloom_filter("rs:bfs")
        out += [call(bfs.try_init, 100, 0.5), call(bfs.add_each, ["x", "y"]),
                call(bfs.contains_each, ["x", "q"])]
        bfa = c.get_bloom_filter_array("rs:bfa")
        out += [call(bfa.try_init, 8, 1000, 0.01), call(bfa.add_each, tenants[:300], ints[:300]),
                call(bfa.contains, tenants[150:450], ints[150:450])]
        hlla = c.get_hyper_log_log_array("rs:hlla")
        out += [call(hlla.try_init, 8), call(hlla.add, tenants, ints), call(hlla.merge_rows, [0], [1])]
        est += [hlla.estimate_all(), hlla.estimate_union_pairs([0, 2], [3, 4])]
        h = c.get_hyper_log_log("rs:h")
        h2 = c.get_hyper_log_log("rs:h2")
        out += [call(h.add, "k"), call(h.add_all, [f"k{i}" for i in range(200)]),
                call(h.add_all, ints[:500]), call(h2.add_all, ["k", "other"]), call(h.count),
                call(h.count_with, "rs:h2"), call(h.merge_with, "rs:h2"), call(h.count)]
        bits = c.get_bit_set("rs:bits")
        b2 = c.get_bit_set("rs:bits2")
        idx = rng.integers(0, 5000, 64)
        out += [call(bits.set, 7), call(bits.get, 7), call(bits.get, 8), call(bits.set_each, idx),
                call(bits.get_each, idx[:32] + 1), call(bits.set_each, idx[:8], False),
                call(bits.cardinality), call(b2.set_each, rng.integers(0, 5000, 64)),
                call(bits.or_, "rs:bits2"), call(bits.cardinality), call(bits.xor, "rs:bits2"),
                call(bits.cardinality), call(bits.length)]
        # generic OBJCALL proxies
        m = c.get_map("rs:map")
        out += [call(m.put, "a", 1), call(m.put, "b", [1, "x"]), call(m.get, "a"), call(m.read_all_map),
                call(m.put_if_absent, "a", 5), call(m.remove, "b"), call(m.size), call(m.nope)]
        lst = c.get_list("rs:list")
        out += [call(lst.add_all, [3, 1, 2]), call(lst.read_all), call(lst.get, 9)]
        al = c.get_atomic_long("rs:al")
        out += [call(al.add_and_get, 5), call(al.increment_and_get)]
        z = c.get_scored_sorted_set("rs:z")
        out += [call(z.add, 2.0, "b"), call(z.add, 1.0, "a"), call(z.entry_range, 0, -1)]
        bucket = c.get_bucket("rs:bucket")
        out += [call(bucket.set, {"v": 1}), call(bucket.get), call(bucket.try_set, 2),
                call(bucket.get_and_set, 3), call(bucket.get)]
        q = c.get_queue("rs:q")
        out += [call(q.offer, "j1"), call(q.offer, "j2"), call(q.poll)]
        # one OBJCALLM frame
        out.append(call(c.objcall_many, [("get_map", "rs:map", "get", ("a",), {}),
                                          ("get_map", "rs:map", "bogus", (), {}),
                                          ("get_atomic_long", "rs:al", "get", (), {})]))
        # RemoteBatch: blob groups and generic ops, then an atomic one
        b = c.create_batch()
        bb = b.get_bloom_filter("rs:bf")
        b.get_map("rs:batch:m").put("k", "v")
        bb.contains_async(ints[:10])
        bb.add_async(ints[590:])
        b.get_atomic_long("rs:batch:al").add_and_get(3)
        b.get_map("rs:batch:m").get("k")
        bb.contains_async(ints[585:])
        out.append(call(b.execute))
        opts = type(c.create_batch()._options).defaults().atomic()
        b = c.create_batch(opts)
        b.get_atomic_long("rs:batch:al").increment_and_get()
        b.get_bloom_filter("rs:bf").contains_async(ints[:4])
        out.append(call(b.execute))
        # MULTI/EXEC with WATCH: clean, then aborted by another client's write
        conn = c.node.pool.acquire()
        try:
            out.append(call(conn.execute_many, [("WATCH", "rs:w"), ("MULTI",), ("INCR", "rs:w"),
                                                ("BF.MADD64", "rs:bf", W._i8(ints[:3])),
                                                ("BF.MEXISTS64", "rs:bf", W._i8(ints[:3])), ("EXEC",)]))
            out.append(call(conn.execute, "WATCH", "rs:w"))
            out.append(call(c2.execute, "INCR", "rs:w"))
            out.append(call(conn.execute_many, [("MULTI",), ("INCR", "rs:w"), ("EXEC",), ("GET", "rs:w")]))
        finally:
            c.node.pool.release(conn)
        # transactions: committed by TXEXEC, then refused on a racing write
        tx = c.create_transaction()
        txb = tx.get_bucket("rs:tx:b")
        out += [call(txb.get), call(txb.set, "t1"), call(tx.get_map("rs:tx:m").put, "x", 1),
                call(tx.get_map("rs:tx:m").get, "x"), call(tx.commit), tx.state,
                call(c.get_bucket("rs:tx:b").get)]
        tx = c.create_transaction()
        out += [call(tx.get_bucket("rs:tx:b").get), call(c2.get_bucket("rs:tx:b").set, "racer"),
                call(tx.get_bucket("rs:tx:b").set, "lost"), call(tx.commit), tx.state,
                call(c.get_bucket("rs:tx:b").get)]
        tx = c.create_transaction()
        out += [call(tx.get_buckets().try_set, {"rs:tx:c": 1}), call(tx.commit),
                call(c.get_buckets().try_set, {"rs:tx:c": 2})]
        # a lock held over the wire: another client is refused, then takes it
        lk = c.get_lock("rs:lock")
        other = c2.get_lock("rs:lock")
        out += [call(lk.try_lock), call(lk.try_lock), call(other.try_lock), call(lk.is_locked),
                call(lk.get_hold_count), call(lk.unlock), call(lk.unlock), call(other.try_lock),
                call(other.unlock)]
        # a topic: the listener on one client hears the other's publish
        got = []
        t = c.get_topic("rs:topic")
        t.add_listener(lambda ch, msg: got.append((ch, msg)))
        time.sleep(0.2)
        out.append(call(c2.get_topic("rs:topic").publish, {"hello": [1, 2]}))
        assert _wait(lambda: len(got) == 1)
        out.append(got)
        out.append(call(c.get_keys().count_exists, "rs:map", "rs:none", "rs:bf"))
    finally:
        c2.shutdown()
        c.shutdown()
    return out, est


def drive_async(cls, address, seed=0):
    """The async stream through `cls` (an AsyncRemoteRedisson)."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-2**62, 2**62, 600)
    tenants = rng.integers(0, 8, 600).astype(np.int32)

    async def acall(coro_fn, *args, **kw):
        try:
            return _norm(await coro_fn(*args, **kw))
        except Exception as e:  # noqa: BLE001
            return _norm(e)

    async def main():
        out, est = [], []
        c = await cls.connect(address, timeout=TIMEOUT)
        c2 = await cls.connect(address, timeout=TIMEOUT)
        try:
            bf = c.get_bloom_filter("rs:bf")
            out += [await acall(bf.try_init, 5000, 0.01), await acall(bf.add_each, ints[:300]),
                    await acall(bf.contains_each, ints[150:450]), await acall(bf.add_all, ints[:5]),
                    await acall(bf.get_size)]
            # pipelined: several contains frames gathered on one connection
            flags = await asyncio.gather(*(bf.contains_each(ints[i * 50:(i + 1) * 50]) for i in range(6)))
            out.append(_norm(list(flags)))
            bfa = c.get_bloom_filter_array("rs:bfa")
            out += [await acall(bfa.try_init, 8, 1000, 0.01), await acall(bfa.add_each, tenants[:300], ints[:300]),
                    await acall(bfa.contains, tenants[150:450], ints[150:450])]
            hlla = c.get_hyper_log_log_array("rs:hlla")
            out += [await acall(hlla.try_init, 8), await acall(hlla.add, tenants, ints),
                    await acall(hlla.merge_rows, [0], [1])]
            est += [await hlla.estimate_all(), await hlla.estimate_union_pairs([0, 2], [3, 4])]
            bits = c.get_bit_set("rs:bits")
            idx = rng.integers(0, 5000, 64)
            out += [await acall(bits.set, 7), await acall(bits.set_each, idx), await acall(bits.get_each, idx + 1),
                    await acall(bits.set_each, idx[:8], False), await acall(bits.cardinality),
                    await acall(bits.length)]
            m = c.get_map("rs:map")
            out += [await acall(m.put, "a", 1), await acall(m.get, "a"), await acall(m.read_all_map),
                    await acall(m.nope)]
            h = c.get_hyper_log_log("rs:h")
            out += [await acall(h.add_all, [f"k{i}" for i in range(200)]), await acall(h.count)]
            out.append(await acall(c.execute, "PFCOUNT", "rs:h"))
            # MULTI/EXEC with WATCH on the multiplexed connection
            out.append(_norm(await c.node.execute_pipeline([("WATCH", "rs:w"), ("MULTI",), ("INCR", "rs:w"),
                                                            ("EXEC",)])))
            out.append(await acall(c.execute, "WATCH", "rs:w"))
            out.append(await acall(c2.execute, "INCR", "rs:w"))
            out.append(_norm(await c.node.execute_pipeline([("MULTI",), ("INCR", "rs:w"), ("EXEC",),
                                                            ("GET", "rs:w")])))
            # transactions
            tx = c.create_transaction()
            out += [await acall(tx.get_bucket("rs:tx:b").get), await acall(tx.get_bucket("rs:tx:b").set, "t1"),
                    await acall(tx.get_map("rs:tx:m").put, "x", 1), await acall(tx.commit), tx.state]
            tx = c.create_transaction()
            out += [await acall(tx.get_bucket("rs:tx:b").get),
                    await acall(c2.get_bucket("rs:tx:b").set, "racer"),
                    await acall(tx.get_bucket("rs:tx:b").set, "lost"), await acall(tx.commit), tx.state,
                    await acall(c.get_bucket("rs:tx:b").get)]
            # a lock over the wire: one identity per async client
            out += [await acall(c.get_lock("rs:lock").try_lock), await acall(c2.get_lock("rs:lock").try_lock),
                    await acall(c.get_lock("rs:lock").unlock), await acall(c2.get_lock("rs:lock").try_lock),
                    await acall(c2.get_lock("rs:lock").unlock)]
            # a topic
            qu = await c.subscribe("rs:topic")
            await asyncio.sleep(0.2)
            out.append(await acall(c2.execute, "PUBLISH", "rs:topic", b"hi"))
            out.append(_norm(await asyncio.wait_for(qu.get(), TIMEOUT)))
        finally:
            await c2.aclose()
            await c.aclose()
        return out, est

    return asyncio.run(main())


def _stored(server, names):
    """The records under `names` in the reference's layout."""
    port = isinstance(server, TpuServer)
    out = {}
    for name in names:
        rec = server.engine.store.get(name)
        if rec is None:
            out[name] = None
            continue
        if port:
            kind, meta, arrays, host = state.to_reference(rec)
        else:
            kind, meta, arrays, host = rec.kind, dict(rec.meta), rec.arrays, rec.host
        out[name] = (kind, meta, {k: np.asarray(v).tolist() for k, v in arrays.items()}, host)
    return out


def _run(drive, client_pkg, server_pkg, flavour):
    with _server(server_pkg) as st:
        res, est = drive(CLIENTS[client_pkg][flavour], st.address)
        return res, est, _stored(st.server, NAMES)


def _estimates_agree(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.allclose(g, w, rtol=W.EST_RTOL, atol=0)


@pytest.fixture(scope="module")
def reference_runs():
    return {f: _run(d, "ref", "ref", f) for f, d in ((0, drive_sync), (1, drive_async))}


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "port"), ("port", "ref"), ("ref", "port")],
                         ids=["port_client_port_server", "port_client_ref_server", "ref_client_port_server"])
@pytest.mark.parametrize("flavour", [0, 1], ids=["sync", "async"])
def test_op_stream_matches_the_reference_pair(reference_runs, client_pkg, server_pkg, flavour):
    want, want_est, want_state = reference_runs[flavour]
    got, got_est, got_state = _run((drive_sync, drive_async)[flavour], client_pkg, server_pkg, flavour)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    _estimates_agree(got_est, want_est)
    assert got_state == want_state
    # the stream reached the refusals: a WATCH abort, a TXCONFLICT, a held lock
    flat = repr(got)
    assert "TransactionException" in flat and "None" in flat


def test_objcall_stream_reply_bytes_match_the_reference():
    stream = W.objcall_stream(seed=0)
    waves = [stream, [("HELLO", "3")] + stream]
    out = []
    for pkg in ("ref", "port"):
        with _server(pkg) as st:
            out.append(W.replies(st.server.host, st.server.port, waves))
    want, got = out
    for wave, (graw, g), (wraw, w) in zip(waves, got, want):
        assert W.compare(wave, g, w) == []
        assert graw == wraw
    # the stream reached pickled results, shipped exceptions and refusals
    tags = {bytes(r[:1]) for r in got[0][1] if isinstance(r, bytes)}
    assert {b"R", b"E", b"M"} <= tags
    assert any(isinstance(r, resp.RespError) and "TXCONFLICT" in str(r) for r in got[0][1])


def _payloads(resp_error, codec):
    """Wire payloads built from one package's classes."""
    big = np.arange(200_000, dtype=np.int64)
    return {
        "error": resp_error("ERR x"),
        "objcallm": [("R", 1), ("E", resp_error("WRONGTYPE y")), ("R", big), ("R", {"a": [1, resp_error("z")]})],
        "codec_frame": ((("k", 1), {"codec": codec.StringCodec()}), codec.JsonCodec()),
        "repeats": [codec.JsonCodec(), codec.JsonCodec(), ValueError("v"), np.zeros(70_000, bool), b"x" * 200_000],
        "plain": {"n": 1, "f": 2.5, "s": "t", "b": b"\x00", "t": (1, None, True)},
    }


@pytest.mark.parametrize("case", ["error", "objcallm", "codec_frame", "repeats", "plain"])
def test_wire_pickles_equal_the_reference_pickles(case):
    """safe_pickle.dumps of the port's classes gives the bytes pickle.dumps
    gives for the reference's (the C pickler where no port class occurs,
    the Python one with wire names where one does), and round-trips."""
    from redisson_tpu.client import codec as ref_codec
    from redisson_tpu.net.resp import RespError as RefRespError
    from redisson_tpu_torch.client import codec as port_codec
    from redisson_tpu_torch.net import safe_pickle

    got = safe_pickle.dumps(_payloads(resp.RespError, port_codec)[case])
    want = pickle.dumps(_payloads(RefRespError, ref_codec)[case])
    assert got == want
    # the reference's bytes read into the port's classes write back the same
    assert safe_pickle.dumps(safe_loads(want)) == want


def _globals(blob: bytes):
    """The module names a pickle's GLOBAL / STACK_GLOBAL opcodes name."""
    names, strings = [], []
    for op, arg, _pos in pickletools.genops(blob):
        if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE"):
            strings.append(arg)
        elif op.name == "STACK_GLOBAL":
            names.append(strings[-2])
        elif op.name == "GLOBAL":
            names.append(arg.split(" ")[0])
    return names


def test_no_reply_names_a_torch_global(monkeypatch):
    """Every R/E/M reply of the OBJCALL stream, and of a method returning a
    tensor or raising a torch error, names only wire globals."""
    from redisson_tpu_torch.client.objects.bitset import BitSet
    from redisson_tpu_torch.client.objects.map import Map

    monkeypatch.setattr(BitSet, "as_tensor", lambda self: torch.arange(4, dtype=torch.int32), raising=False)

    def oom(self, *a):
        raise torch.OutOfMemoryError("CUDA out of memory (planted)")

    monkeypatch.setattr(Map, "planted_oom", oom, raising=False)
    stream = W.objcall_stream(seed=1)
    with ServerThread(port=0, device="cpu") as st:
        [(_raw, replies)] = W.replies(st.server.host, st.server.port, [stream])
        c = port_remote.RemoteRedisson(st.address, timeout=TIMEOUT)
        try:
            tensor = c.get_bit_set("g:bits").as_tensor()
            with pytest.raises(RuntimeError, match="OutOfMemoryError: CUDA out of memory"):
                c.get_map("g:map").planted_oom()
            no_args = pickle.dumps(((), {}))
            raw_tensor = c.execute("OBJCALL", "get_bit_set", "g:bits", "as_tensor", no_args, "me:1")
            raw_oom = c.execute("OBJCALL", "get_map", "g:map", "planted_oom", no_args, "me:1")
        finally:
            c.shutdown()
    assert isinstance(tensor, np.ndarray) and tensor.tolist() == [0, 1, 2, 3]
    blobs = [bytes(r) for c, r in zip(stream, replies)
             if c[0].startswith(("OBJCALL", "TXEXEC")) and isinstance(r, bytes)]
    blobs += [bytes(raw_tensor), bytes(raw_oom)]
    assert len(blobs) > 30
    for blob in blobs:
        names = _globals(blob[1:])
        assert not [n for n in names if n == "torch" or n.startswith(("torch.", "redisson_tpu_torch"))], names
        safe_loads(blob[1:])  # every reply reads back through the port's unpickler
    assert type(safe_loads(bytes(raw_oom)[1:])) is RuntimeError


# the server's own pools grow as it serves; the test counts the others
_SERVER_POOLS = ("rtpu-srv", "rtpu-qos", "rtpu-slow")


def _threads():
    return {t for t in threading.enumerate() if t.is_alive() and not t.name.startswith(_SERVER_POOLS)}


def test_shutdown_leaves_no_client_thread_behind():
    """A sync client (with a held lock's watchdog and a topic listener), an
    async client and a tracked client: after shutdown the live threads are
    the ones that ran before."""
    with ServerThread(port=0, device="cpu") as st:
        c = port_remote.RemoteRedisson(st.address, timeout=TIMEOUT)
        c.get_bucket("warm").set(1)
        c.shutdown()
        time.sleep(0.2)
        before = _threads()
        c = port_remote.RemoteRedisson(st.address, timeout=TIMEOUT, ping_interval=0.5)
        lk = c.get_lock("th:lock")
        assert lk.try_lock()
        c.get_topic("th:topic").add_listener(lambda ch, m: None)
        tracked = c.enable_tracking()
        tb = tracked.get_bucket("th:b")
        tb.set("x")
        assert tb.get() == "x" and tb.get() == "x"
        during = _threads() - before
        assert any(t.name.startswith("rtpu-pubsub") for t in during)
        assert any(t.name.startswith("rtpu-ping") for t in during)
        assert any(t.name.startswith("rtpu-wheel-timer") for t in during)
        c.shutdown()

        async def aio():
            a = await port_aio.AsyncRemoteRedisson.connect(st.address, timeout=TIMEOUT)
            await a.get_map("th:m").put("k", 1)
            await a.subscribe("th:ch")
            await a.aclose()

        asyncio.run(aio())
        assert _wait(lambda: not (_threads() - before), timeout=5.0), _threads() - before


def test_the_reference_suites_bind_the_port_classes():
    """tests/_torch_port_suite.py runs the reference's suites on the port:
    their module-level names and the imports inside their test bodies bind
    the port's classes, and their servers are port servers on the CPU."""
    from tests import _torch_port_suite as PS

    ns = PS.load("test_aio", {}, "probe")
    assert ns["AsyncRemoteRedisson"] is port_aio.AsyncRemoteRedisson and ns["RespError"] is resp.RespError
    assert ns["ServerThread"] is PS.CpuServerThread
    with ns["ServerThread"](port=0) as st:
        assert isinstance(st.server, TpuServer) and st.server.engine.device.type == "cpu"
    # an import inside a test body: `from redisson_tpu.client.remote import ...`
    assert PS._import("redisson_tpu.client.remote", fromlist=("RemoteRedisson",)) is port_remote
    c = PS._port_module("redisson_tpu").create()
    assert c.engine.device.type == "cpu"
    c.shutdown()
