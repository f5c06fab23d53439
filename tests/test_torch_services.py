"""Streams, geo, JSON, search and the script verbs over the wire, and the
services with the port's own worker node, on the CPU.

  * One command stream (``tools/wire_stream.services_stream``: X*, GEO*,
    JSON.*, FT.* with a FLAT and an IVF index, EVALSHA/SCRIPT/FCALL/FUNCTION
    on scripts registered server-side) goes to a port server and to a
    reference server; the replies are equal in RESP2 and RESP3, byte for
    byte outside the stated contracts (an extended XPENDING row's idle
    milliseconds, the ID of ``XADD *``, KNN near-ties), and the IVF index
    the reference trained is installed in the port's before the queries.
  * Each package's RemoteRedisson drives the other's server with the same
    results as on its own: streams, geo, JSON, live objects, the executor.
  * The port's worker node (``python -m redisson_tpu_torch.node``) runs
    MapReduce and ``word_count(executor=...)`` in two processes, with the
    reference's results; a killed worker's task re-runs on the survivor.
  * Shut-down facades and stopped nodes leave no thread behind.
"""
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.client.redisson import RedissonTpu as RefRedissonTpu
from redisson_tpu.client.remote import RemoteRedisson as RefRemote
from redisson_tpu.node import WorkerNode as RefWorkerNode
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu.services import mapreduce as RMR
from redisson_tpu_torch.client.redisson import RedissonTpu
from redisson_tpu_torch.client.remote import RemoteRedisson
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.node import WorkerNode
from redisson_tpu_torch.server.server import ServerThread
from redisson_tpu_torch.services import mapreduce as MR
from redisson_tpu_torch.services.liveobject import entity
from redisson_tpu_torch.tools import wire_stream as W
from tests import _mr_tasks

ROOT = Path(__file__).resolve().parent.parent


def square(x):
    return x * x


def _servers():
    return RefServerThread(port=0), ServerThread(port=0, device="cpu")


# -- the wire stream against the reference ------------------------------------


@pytest.mark.parametrize("scale", [1, 2])
def test_services_stream_matches_the_reference_in_resp2_and_resp3(scale):
    rs, ps = _servers()
    with rs, ps:
        shas = W.load_scripts(RefRedissonTpu(rs.server.engine))
        assert W.load_scripts(RedissonTpu(ps.server.engine)) == shas
        setup, queries = W.services_stream(seed=scale, scale=scale, shas=shas)
        want = W.replies("127.0.0.1", rs.port, [setup])
        got = W.replies("127.0.0.1", ps.port, [setup])
        assert W.compare(setup, got[0][1], want[0][1]) == []
        W.train_ivf(RefRedissonTpu(rs.server.engine).get_search(),
                    RedissonTpu(ps.server.engine).get_search(), "idx:i")
        waves = [queries, [("HELLO", "3")] + queries]
        want = W.replies("127.0.0.1", rs.port, waves)
        got = W.replies("127.0.0.1", ps.port, waves)
    for cmds, (graw, g), (wraw, w) in zip(waves, got, want):
        assert W.compare(cmds, g, w) == []
        spans_g, spans_w = W.reply_spans(graw), W.reply_spans(wraw)
        assert len(spans_g) == len(spans_w) == len(cmds)
        differ = {W._verb(cmds[i]) for i, (a, b) in enumerate(zip(spans_g, spans_w)) if a != b}
        # bytes differ only where a contract holds: XPENDING's idle ms and
        # XADD *'s clock ID (every KNN reply here is byte-equal on the CPU)
        assert differ <= W.CLOCK_VERBS, differ
    # the stream reached every family: a KNN reply, a geo distance, a
    # script's reply, a JSON document and a consumer group's entries
    by_verb = {}
    for cmd, r in zip(queries, want[0][1]):
        by_verb.setdefault(W._verb(cmd), []).append(r)
    assert any(isinstance(r, list) and r and r[0] == 3 for r in by_verb[b"FT.MSEARCH"])
    assert b"166.2743" in by_verb[b"GEODIST"]
    assert by_verb[b"EVALSHA"][:3] == [4, 0, [b"f1", b"f2"]] and 42 in by_verb[b"FCALL"]
    assert not all(isinstance(r, resp.RespError) for r in by_verb[b"XREADGROUP"])


def test_knn_contract_allows_near_ties_and_rounding_and_nothing_else():
    cmd = ("FT.MSEARCH", "i", "*=>[KNN 3 @e $v]")
    want = [1, [b"a", b"0.1000", b"b", b"0.2000", b"c", b"0.2000"]]
    # tied ids trade places, and the tied group at the k cut holds another id
    assert W.knn_agree(cmd, [1, [b"a", b"0.1000", b"c", b"0.2000", b"b", b"0.2000"]], want)
    assert W.knn_agree(cmd, [1, [b"a", b"0.1000", b"b", b"0.2000", b"d", b"0.2000"]], want)
    # one distance on either side of a rounding boundary
    assert W.knn_agree(cmd, [1, [b"a", b"0.1001", b"b", b"0.2000", b"c", b"0.2000"]], want)
    # a different id outside a tie, a score off by more than one digit, a
    # missing row
    assert not W.knn_agree(cmd, [1, [b"z", b"0.1000", b"b", b"0.2000", b"c", b"0.2000"]], want)
    assert not W.knn_agree(cmd, [1, [b"a", b"0.1003", b"b", b"0.2000", b"c", b"0.2000"]], want)
    assert not W.knn_agree(cmd, [1, [b"a", b"0.1000", b"b", b"0.2000"]], want)
    # FT.SEARCH's shape: the count, then id and fields with the score last
    scmd = ("FT.SEARCH", "i", "*=>[KNN 2 @e $v]")
    swant = [2, b"a", [b"t", b"x", b"__e_score", b"0.5000"], b"b", [b"t", b"y", b"__e_score", b"0.7000"]]
    assert W.knn_agree(scmd, list(swant), swant)
    assert not W.knn_agree(scmd, [2, b"a", [b"t", b"q", b"__e_score", b"0.5000"]] + swant[3:], swant)
    assert W.compare([scmd], [list(swant)], [swant]) == []


def test_clock_contract_holds_ids_and_pending_rows():
    assert W.compare([("XADD", "s", "*", "f", "v")], [b"17-0"], [b"18-3"]) == []
    assert W.compare([("XADD", "s", "*", "f", "v")], [b"x"], [b"18-3"]) != []
    assert W.compare([("XADD", "s", "5-1", "f", "v")], [b"5-2"], [b"5-1"]) != []
    cmd = ("XPENDING", "s", "g", "-", "+", "10")
    assert W.compare([cmd], [[[b"1-1", b"c1", 7, 1]]], [[[b"1-1", b"c1", 9, 1]]]) == []
    assert W.compare([cmd], [[[b"1-1", b"c2", 7, 1]]], [[[b"1-1", b"c1", 9, 1]]]) != []
    assert W.compare([cmd], [[[b"1-1", b"c1", 7, 2]]], [[[b"1-1", b"c1", 9, 1]]]) != []


def test_ft_create_with_shards_replies_the_error_naming_m8():
    """SHARDS n > 1 is served since the sharded banks came (it replied an
    error naming the slice before): FT.CREATE replies as the reference's
    server does, SHARDS 2 OK, SHARDS 0 and -2 the reference's errors
    (tests/test_torch_vector_sharded.py holds the queries)."""
    stream = [("FT.CREATE", f"sh{n}", "SCHEMA", "v", "VECTOR", "FLAT", "8", "TYPE", "FLOAT32",
               "DIM", "4", "DISTANCE_METRIC", "L2", "SHARDS", n) for n in ("2", "0", "-2")]
    stream.append(("FT._LIST",))
    rs, ps = _servers()
    with rs, ps:
        want = W.replies("127.0.0.1", rs.port, [stream])
        got = W.replies("127.0.0.1", ps.port, [stream])
    assert got[0][0] == want[0][0]
    assert got[0][1][0] == b"OK" and got[0][1][-1] == [b"sh2"]
    assert all(isinstance(r, resp.RespError) for r in got[0][1][1:3])


@pytest.mark.parametrize("wrapper", ["knn_score", "knn_select"])
def test_a_failing_knn_kernel_replies_an_error_not_a_slower_path(monkeypatch, wrapper):
    """A KNN kernel that raises reaches the client as an error reply for
    FT.SEARCH and FT.MSEARCH; the next command is served."""
    from redisson_tpu_torch.core import kernels as K

    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        c.execute("FT.CREATE", "kf", "ON", "HASH", "PREFIX", "1", "kf:", "SCHEMA", "emb", "VECTOR", "FLAT", "6",
                  "TYPE", "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2")
        for i in range(8):
            c.execute("HSET", f"kf:{i}", "emb", W.f32_blob([i, 0, 0, 0]))

        def broken(*_a, **_k):
            raise RuntimeError("the kernel failed")

        monkeypatch.setattr(K, wrapper, broken)
        q = W.f32_blob([[1, 0, 0, 0], [2, 0, 0, 0]])
        for cmd in (("FT.MSEARCH", "kf", "*=>[KNN 3 @emb $v]", "PARAMS", "2", "v", q),
                    ("FT.SEARCH", "kf", "*=>[KNN 3 @emb $v]", "PARAMS", "2", "v", q[:16], "NOCONTENT")):
            got = c.execute(*cmd)
            assert isinstance(got, resp.RespError) and "the kernel failed" in str(got), got
        assert c.execute("PING") == b"PONG"
        monkeypatch.undo()
        assert c.execute("FT.SEARCH", "kf", "*=>[KNN 1 @emb $v]", "PARAMS", "2", "v", q[:16],
                         "NOCONTENT")[:2] == [1, b"kf:1"]


def test_parked_xreads_leave_ping_answered_and_unpark_on_stop():
    """XREAD and XREADGROUP BLOCK park on the slow pool: more parked readers
    than the shared pool's workers leave PING answered; stop() unparks them
    all (nil, then the connection closes) long before their BLOCK ends."""
    st = ServerThread(port=0, device="cpu", workers=2).start()
    host, port = "127.0.0.1", st.port
    W.replies(host, port, [[("XADD", "xs", "1-1", "f", "v"), ("XGROUP", "CREATE", "xs", "g", "$")]])
    results = []

    def park(cmd):
        try:
            results.append(W.replies(host, port, [[cmd]], timeout=60)[0][1][0])
        except (ConnectionError, OSError) as e:
            results.append(e)

    cmds = [("XREAD", "BLOCK", "60000", "STREAMS", "xs", "$")] * 3
    cmds += [("XREADGROUP", "GROUP", "g", f"c{i}", "BLOCK", "60000", "STREAMS", "xs", ">") for i in range(3)]
    threads = [threading.Thread(target=park, args=(c,)) for c in cmds]
    for t in threads:
        t.start()
    time.sleep(0.5)
    assert W.replies(host, port, [[("PING",)]], timeout=10)[0][1] == [b"PONG"]
    t0 = time.time()
    st.stop()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    assert time.time() - t0 < 20
    assert len(results) == 6 and all(r is None or isinstance(r, (ConnectionError, OSError)) for r in results)


def test_an_xadd_wakes_a_parked_xread():
    with ServerThread(port=0, device="cpu") as st:
        out = []
        t = threading.Thread(target=lambda: out.append(
            W.replies("127.0.0.1", st.port, [[("XREAD", "BLOCK", "10000", "STREAMS", "xw", "0")]])[0][1][0]))
        t.start()
        time.sleep(0.3)
        W.replies("127.0.0.1", st.port, [[("XADD", "xw", "7-1", "f", "wake")]])
        t.join(timeout=10)
        assert out == [[[b"xw", [[b"7-1", [b"f", b"wake"]]]]]]


# -- each package's client against the other's server -------------------------


@entity(id_field="uid", indexed=("city", "age"))
class Person:
    def __init__(self, uid=None, name=None, city=None, age=None):
        self.uid, self.name, self.city, self.age = uid, name, city, age


def _wire_ops(client):
    """Streams, geo, JSON, live objects and the executor through a wire
    client (a worker node runs the executor's tasks)."""
    out = []
    st = client.get_stream("x:st")
    out += [st.add({"a": "1"}, id="1-1"), st.add({"b": "2"}, id="2-1"), st.add({"c": "3"}, id="3-1")]
    st.create_group("g", from_id="0")
    out += [st.size(), st.range("-", "+"), st.rev_range("+", "-", 2),
            st.read_group("g", "c1", count=2), st.ack("g", "1-1"), st.pending_summary("g"),
            [(r["id"], r["consumer"], r["delivered"]) for r in st.pending_range("g", "-", "+")],
            st.list_groups(), st.trim(2), st.range()]
    geo = client.get_geo("x:geo")
    out += [geo.add(13.361389, 38.115556, "Palermo"), geo.add_all({"Catania": (15.087269, 37.502669),
                                                                    "Rome": (12.4964, 41.9028)}),
            round(geo.dist("Palermo", "Catania", "km"), 6), geo.search_radius(15, 37, 200, "km"),
            sorted(geo.search_member_radius("Rome", 600, "km")), geo.size()]
    jb = client.get_json_bucket("x:json")
    jb.set("$", {"a": {"b": [1, 2]}, "n": 3, "s": "x"})
    out += [jb.get("$.a.b"), jb.array_append("$.a.b", 3), jb.increment_and_get("$.n", 2),
            jb.string_append("$.s", "yz"), jb.object_keys("$"), jb.type("$.a"), jb.get()]
    ts = client.get_time_series("x:ts")
    ts.add(1.0, "a")
    ts.add(3.0, "c")
    ts.add(2.0, "b")
    out += [ts.size(), ts.range(0, 10), ts.first(), ts.last_timestamp()]
    lo = client.get_live_object_service()
    conditions = sys.modules[type(lo).__module__].Conditions  # the client's own package
    for p in (Person(1, "ann", "rome", 30), Person(2, "bob", "oslo", 41), Person(3, "cy", "rome", 52)):
        lo.persist(p)
    ann = lo.get(Person, 1)
    ann.age = 31
    out += [lo.is_exists(Person, 2), sorted(p.uid for p in lo.find(Person, city="rome")),
            sorted(p.uid for p in lo.find(Person, conditions.gt("age", 35))), lo.get(Person, 1).age,
            lo.delete(Person, 2), lo.is_exists(Person, 2)]
    tids = [client.objcall("get_executor_service", "redisson_executor", "submit_payload",
                           (pickle.dumps((square, (i,), {})),), {}) for i in range(5)]
    out.append([pickle.loads(bytes(client.objcall("get_executor_service", "redisson_executor",
                                                  "await_task_result", (t, 30.0), {}))) for t in tids])
    return out


def _pairing(server_cls, client_cls, node_cls, **server_kw):
    with server_cls(port=0, **server_kw) as st:
        node = node_cls(st.address, workers=2, poll_interval=0.05).start()
        client = client_cls(st.address, timeout=30.0)
        try:
            return _wire_ops(client)
        finally:
            client.shutdown()
            node.stop()


def test_each_package_client_drives_the_other_server_with_the_same_results():
    ref = _pairing(RefServerThread, RefRemote, RefWorkerNode)
    port_on_ref = _pairing(RefServerThread, RemoteRedisson, WorkerNode)
    ref_on_port = _pairing(ServerThread, RefRemote, RefWorkerNode, device="cpu")
    port = _pairing(ServerThread, RemoteRedisson, WorkerNode, device="cpu")
    assert port_on_ref == ref
    assert ref_on_port == ref
    assert port == ref
    assert ref[-1] == [0, 1, 4, 9, 16]


# -- threads ---------------------------------------------------------------------


class Calc:
    def add(self, a, b):
        return a + b


def _settles_to(before: set, deadline: float = 15.0, server_pools=()) -> set:
    """The names of the threads still alive beyond `before` (the threads
    alive then, by identity: a thread an earlier test left running may
    share a name with a new one) once things settle, less the server's own
    pools (they grow on demand and end with the server)."""
    def extra():
        return {t.name for t in threading.enumerate()
                if t not in before and not t.name.startswith(tuple(server_pools))}

    end = time.time() + deadline
    while extra() and time.time() < end:
        time.sleep(0.05)
    return extra()


def test_an_embedded_facade_with_every_service_shuts_down_to_no_thread():
    before = set(threading.enumerate())
    c = redisson_tpu_torch.create(device="cpu")
    ex = c.get_executor_service("thr")
    ex.register_workers(2)
    assert ex.submit(square, 7).get(10) == 49
    sch = c.get_scheduled_executor_service("thr_s")
    sch.register_workers(1)
    assert sch.schedule(0.01, square, 3).get(10) == 9
    sch.schedule_at_fixed_rate(0.0, 0.05, square, 2)
    sch.schedule_with_fixed_delay(0.0, 0.05, square, 2)
    sch.schedule_cron("* * * * *", square, 1)
    rs = c.get_remote_service()
    rs.register("Calc", Calc(), workers=2)
    assert rs.get("Calc").add(2, 3) == 5
    got = []
    es = c.get_elements_subscribe_service()
    es.subscribe_on_elements("thr_q", got.append, poll_interval=0.1)
    c.get_blocking_queue("thr_q").offer(5)
    end = time.time() + 10
    while not got and time.time() < end:
        time.sleep(0.02)
    assert got == [5]
    assert len({t.name for t in threading.enumerate() if t not in before}) >= 8
    c.shutdown()
    assert _settles_to(before) == set()


def test_a_remote_facade_and_a_node_leave_no_thread():
    with ServerThread(port=0, device="cpu") as st:
        before = set(threading.enumerate())
        c = RemoteRedisson(st.address, timeout=30.0)
        node = WorkerNode(st.address, workers=2, poll_interval=0.05).start()
        got = []
        c.get_elements_subscribe_service().subscribe_on_elements("rq", got.append, poll_interval=0.1)
        c.get_blocking_queue("rq").offer(1)
        tid = c.objcall("get_executor_service", "redisson_executor", "submit_payload",
                        (pickle.dumps((_mr_tasks.slow_echo, ("n", 0.2), {})),), {})
        assert pickle.loads(bytes(c.objcall("get_executor_service", "redisson_executor",
                                            "await_task_result", (tid, 30.0), {}))) == "done-n"
        end = time.time() + 10
        while not got and time.time() < end:
            time.sleep(0.02)
        assert got == [1]
        node.stop()
        c.shutdown()
        # the server engine's sweeper starts with the queue's first wait
        # entry and, like its pools, ends with the server
        assert _settles_to(before, server_pools=("rtpu-srv", "rtpu-qos", "rtpu-slow", "rtpu-eviction")) == set()


# -- the port's worker node in its own processes --------------------------------


def _spawn_node(address: str, workers: int = 1):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch.node", "--address", address,
         "--workers", str(workers), "--poll-interval", "0.05"],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGINT)  # the node's main stops its workers
    for p in procs:
        try:
            p.wait(timeout=15)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


@pytest.fixture()
def nodes2():
    """A port CPU server and two port worker-node processes (one worker
    thread each)."""
    with ServerThread(port=0, device="cpu") as st:
        procs = [_spawn_node(st.address), _spawn_node(st.address)]
        client = RemoteRedisson(st.address, timeout=60.0)
        try:
            end = time.time() + 60
            while _active_workers(client) < 2:
                assert time.time() < end, "the worker nodes never came up"
                assert all(p.poll() is None for p in procs), "a worker node exited"
                time.sleep(0.1)
            yield st, procs, client
        finally:
            client.shutdown()
            _stop(procs)


class _Executor:
    """The coordinator's view of a wire executor service."""

    def __init__(self, client, name="redisson_executor"):
        self._client, self._name = client, name

    def _call(self, method, *args):
        return self._client.objcall("get_executor_service", self._name, method, args, {})

    def submit_payload(self, payload):
        return self._call("submit_payload", payload)

    def task_state(self, task_id):
        return self._call("task_state", task_id)

    def await_task_result(self, task_id, timeout):
        return self._call("await_task_result", task_id, timeout)

    def requeue_orphans(self, age):
        return self._call("requeue_orphans", age)


def _active_workers(client) -> int:
    return client.objcall("get_executor_service", "redisson_executor", "count_active_workers", (), {})


def _claim_nodes(st) -> set:
    rec = st.server.engine.store.get("{redisson_executor}:tasks")
    return {t.claimed_by.split(":")[0] for t in rec.host["tasks"].values() if t.claimed_by}


def _reference_mapreduce(values: dict, collator=None):
    ref = redisson_tpu.create()
    try:
        m = ref.get_map("src")
        m.put_all(values)
        return ref.get_map_reduce(_mr_tasks.wc_mapper, _mr_tasks.wc_reducer, collator, workers=3).execute(m)
    finally:
        ref.shutdown()


def test_mapreduce_in_two_node_processes_with_a_result_map_and_a_collator(nodes2):
    st, _procs, client = nodes2
    values = {f"k{i}": "alpha beta " + ("gamma " * (i % 3)) for i in range(60)}
    m = client.get_map("mr:src")
    m.put_all(values)
    out_map = client.get_map("mr:out")
    ex = _Executor(client)
    result = MR.MapReduce(None, _mr_tasks.wc_mapper, _mr_tasks.wc_reducer, workers=6, executor=ex).execute(
        m, result_map=out_map)
    assert result == _reference_mapreduce(values) == {"alpha": 60, "beta": 60, "gamma": 60}
    assert out_map.read_all_map() == result
    total = MR.MapReduce(None, _mr_tasks.wc_mapper, _mr_tasks.wc_reducer, collator=lambda d: sum(d.values()),
                         workers=4, executor=ex).execute(m)
    assert total == _reference_mapreduce(values, lambda d: sum(d.values())) == 180
    assert len(_claim_nodes(st)) >= 2, "the tasks ran in one process"
    # the coordinator's cleanup task removes the partitions
    end = time.time() + 10
    while client.get_keys().get_keys("mr:*:c*") and time.time() < end:
        time.sleep(0.1)
    assert not client.get_keys().get_keys("mr:*:c*")


def test_word_count_on_node_processes_equals_the_embedded_count(nodes2):
    _st, _procs, client = nodes2
    rng_words = ["w%d" % (i * 7 % 23) for i in range(400)]
    values = {f"d{i}": " ".join(rng_words[i % 37: i % 37 + 9]) for i in range(200)}
    m = client.get_map("wc:src")
    m.put_all(values)
    counts = MR.word_count(m, workers=4, executor=_Executor(client))
    emb = redisson_tpu_torch.create(device="cpu")
    ref = redisson_tpu.create()
    try:
        em = emb.get_map("wc")
        em.put_all(values)
        rm = ref.get_map("wc")
        rm.put_all(values)
        assert counts == MR.word_count(em) == RMR.word_count(rm)
    finally:
        emb.shutdown()
        ref.shutdown()


def test_a_killed_node_task_reruns_on_the_survivor_with_the_same_result(nodes2):
    st, procs, client = nodes2
    values = {f"k{i}": "w1 w2" for i in range(40)}
    m = client.get_map("mr:chaos")
    m.put_all(values)
    ex = _Executor(client)
    mr = MR.MapReduce(None, _mr_tasks.slow_wc_mapper, _mr_tasks.wc_reducer, workers=4, executor=ex).timeout(120.0)
    done, killed = threading.Event(), threading.Event()

    def running():
        rec = st.server.engine.store.get("{redisson_executor}:tasks")
        return 0 if rec is None else sum(1 for t in rec.host["tasks"].values()
                                         if t.state == "running" and t.claimed_by)

    def assassin():
        end = time.time() + 30
        while time.time() < end and not done.is_set():
            if running() >= 2:
                procs[0].send_signal(signal.SIGKILL)
                procs[0].wait(timeout=10)
                killed.set()
                return
            time.sleep(0.02)

    def sweeper():
        while not done.is_set():
            try:
                ex.requeue_orphans(1.5)
            except Exception:  # noqa: BLE001 — a sweep races the coordinator's calls
                pass
            time.sleep(0.3)

    ta, ts = threading.Thread(target=assassin), threading.Thread(target=sweeper)
    ta.start()
    ts.start()
    try:
        result = mr.execute(m)
    finally:
        done.set()
        ta.join(10)
        ts.join(10)
    assert killed.is_set(), "the worker was never killed mid-task"
    assert result == _reference_mapreduce(values) == {"w1": 40, "w2": 40}


def test_a_mapper_rerun_emits_no_duplicates():
    """A mapper chunk run twice (a requeued clone) writes under its own run
    id; reducers read only the acked run, so nothing doubles."""
    c = redisson_tpu_torch.create(device="cpu")
    try:
        m = c.get_map("mr:rerun")
        m.put_all({f"k{i}": "dup words dup" for i in range(10)})
        keys = m.read_all_keys()
        runs = [MR._mr_map_task("mr:rerun", keys, _mr_tasks.wc_mapper, 2, "jobX", 0, None, client=c)["run"]
                for _ in range(2)]
        assert runs[0] != runs[1]
        out = {}
        for pi in range(2):
            out.update(MR._mr_reduce_task("jobX", pi, [(0, runs[-1])], _mr_tasks.wc_reducer, None, None,
                                          client=c))
        assert out == {"dup": 20, "words": 10}
        assert MR._mr_cleanup_task("jobX", client=c) >= 1
        assert not c.get_keys().get_keys("mr:jobX:*")
    finally:
        c.shutdown()


def test_the_node_main_stops_on_sigint():
    with ServerThread(port=0, device="cpu") as st:
        p = _spawn_node(st.address, workers=2)
        c = RemoteRedisson(st.address, timeout=30.0)
        try:
            end = time.time() + 60
            while _active_workers(c) < 1:
                assert time.time() < end and p.poll() is None
                time.sleep(0.1)
        finally:
            c.shutdown()
            p.send_signal(signal.SIGINT)
            assert p.wait(timeout=20) == 0


# a node whose main thread is still inside start() when its first worker's
# heartbeat makes it visible: the second worker thread's start waits
_SLOW_START_NODE = """
import sys, time
from redisson_tpu_torch import node

start = node.WorkerNode.start


def slow_start(self):
    out = start(self)
    time.sleep(3.0)  # a main thread starved after its workers run
    return out


node.WorkerNode.start = slow_start
node.main(sys.argv[1:])
"""


def test_the_node_main_stops_on_a_sigint_that_lands_during_start():
    """A SIGINT that lands while the node's main thread is still in start()
    (under load, Thread.start waits while the first worker already
    heartbeats) stops it with exit 0, as one that lands while it serves."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with ServerThread(port=0, device="cpu") as st:
        p = subprocess.Popen(
            [sys.executable, "-c", _SLOW_START_NODE, "--address", st.address, "--workers", "2",
             "--poll-interval", "0.05"],
            env=env, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        c = RemoteRedisson(st.address, timeout=30.0)
        try:
            end = time.time() + 60
            while _active_workers(c) < 1:
                assert time.time() < end and p.poll() is None
                time.sleep(0.1)
        finally:
            c.shutdown()
            p.send_signal(signal.SIGINT)
            rc = p.wait(timeout=20)
            err = p.stderr.read().decode(errors="replace")
            p.stderr.close()
        assert rc == 0, err[-2000:]


# -- the host paths the port reworked: geo's packed coordinates, the stream's
# -- bisected group reads ---------------------------------------------------------


def _geo_stream_ops(client, seed: int) -> list:
    """Searches interleaved with adds, moves, removes, renames and deletes
    of a geo set, and group reads interleaved with adds, trims, deletes and
    acks of a stream: every reply."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    g = client.get_geo("hp:geo")
    for step in range(12):
        for i in rng.integers(0, 300, 40).tolist():
            g.add(float(rng.uniform(-10, 30)), float(rng.uniform(35, 60)), f"m{i}")
        for i in rng.integers(0, 300, 10).tolist():
            g.remove(f"m{i}")
        lon, lat = float(rng.uniform(0, 20)), float(rng.uniform(40, 55))
        out.append(g.search_radius(lon, lat, 400, "km", count=8))
        out.append(sorted(g.search_box(lon, lat, 900, 600, "km")))
        if step == 5:
            g.rename("hp:geo2")
            g = client.get_geo("hp:geo2")
        if step == 8:
            g.delete()
    s = client.get_stream("hp:st")
    nxt = 1
    for step in range(10):
        for _ in range(int(rng.integers(5, 30))):
            s.add({"i": str(nxt)}, id=f"{nxt}-0")
            nxt += 1
        if step == 0:
            s.create_group("g", from_id="0")
        got = s.read_group("g", f"c{step % 3}", count=int(rng.integers(1, 12)))
        out.append(list(got))
        if got and step % 2:
            out.append(s.ack("g", *list(got)[:2]))
        if step == 4:
            out.append(s.trim(20))
        if step == 6:
            out.append(s.remove(*[f"{i}-0" for i in range(nxt - 8, nxt - 4)]))
        if step == 7:
            s.set_group_id("g", "0")
    out.append(s.pending_summary("g"))
    return out


def test_geo_and_stream_host_paths_match_the_reference():
    for seed in range(3):
        ref, port = redisson_tpu.create(), redisson_tpu_torch.create(device="cpu")
        try:
            assert _geo_stream_ops(port, seed) == _geo_stream_ops(ref, seed)
        finally:
            ref.shutdown()
            port.shutdown()
