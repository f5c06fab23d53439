"""The port's collection objects against the reference's, on the CPU: for
each family a numpy-seeded op stream goes through redisson_tpu.create() and
through redisson_tpu_torch.create(device="cpu"), and every reply and the
stored encoded contents must be equal, under the codecs test_torch_map.py
uses.  The families: lists, the twelve queue classes, the four set
classes, the scored sorted set, the multimaps, the topics, the adders,
Keys and MapCache.

Stored contents compare the records' kind, meta and host value, with the
wall-clock instants they hold (entry expiries, last access, a delayed
element's due time, a subscriber's heartbeat) reduced to whether they are
set, and a subscriber's random id to its offset."""
import threading
import time

import numpy as np
import pytest

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.client import codec as rcodec
from redisson_tpu_torch import state
from redisson_tpu_torch.client import codec as tcodec


@pytest.fixture()
def clients():
    j = redisson_tpu.create()
    t = redisson_tpu_torch.create(device="cpu")
    yield j, t
    j.shutdown()
    t.shutdown()


def call(fn, *args, **kw):
    """fn's reply, or the name of the exception it raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — the exception type is the reply
        return ("raised", type(e).__name__)


def _sorted(x):
    return sorted(x, key=repr)


def stored(client, *names):
    """The records under `names`: kind, meta and host, instants reduced."""
    out = {}
    for name in names:
        rec = client.engine.store.get(name)
        if rec is None:
            out[name] = None
            continue
        h = rec.host
        kind = rec.kind
        if kind == "set_cache":
            h = {k: v is None for k, v in h.items()}
        elif kind == "map_cache":
            h = {k: [c[0], c[1] is None, c[2], c[4] if len(c) > 4 else 0] for k, c in h.items()}
        elif kind == "delayed_queue":
            h = [raw for _, raw in sorted(h)]
        elif kind.endswith("multimap_cache"):
            h = {"data": h["data"], "ttl": _sorted(h["ttl"])}
        elif kind == "reliable_topic":
            h = {**h, "subscribers": sorted(off for off, _ in h["subscribers"].values())}
        elif isinstance(h, (set, frozenset)):
            h = _sorted(h)
        elif kind.endswith("multimap"):
            h = {"data": {k: _sorted(v) if isinstance(v, set) else v for k, v in h["data"].items()},
                 "ttl": h["ttl"]}
        out[name] = (kind, dict(rec.meta), h)
    return out


def both(clients, stream, codec=None, seed=0):
    """`stream(client, codec, rng)` through both packages: (reference, port)."""
    j, t = clients
    rc = getattr(rcodec, codec)() if codec else None
    tc = getattr(tcodec, codec)() if codec else None
    return stream(j, rc, np.random.default_rng(seed)), stream(t, tc, np.random.default_rng(seed))


CODECS = ["JsonCodec", "PickleCodec"]


def words(rng, n, prefix="w"):
    return [f"{prefix}{int(i)}" for i in rng.integers(0, 4 * n, n)]


# -- lists --------------------------------------------------------------------


def list_stream(c, codec, rng):
    items = words(rng, 12)
    lst = c.get_list("l", codec=codec)
    out = [lst.size(), lst.read_all(), call(lst.get, 0), lst.add(items[0]), lst.add_all(items[1:8]),
           lst.add_all([]), call(lst.add_first, "head"), call(lst.add_at, 2, "at2"), call(lst.add_at, 99, "x"),
           lst.add_after("at2", "after"), lst.add_before("head", "before"), lst.add_after("absent", "x"),
           call(lst.sub_list, 1, 4), call(lst.sub_list, 4, 1), lst.get(-1), call(lst.get, 99),
           lst.set(0, "set0"), call(lst.set, 99, "x")]
    lst.fast_set(1, "fast1")
    lst.add_all([items[2], items[2], items[2]])
    out += [lst.remove(items[2]), lst.remove("absent"), lst.remove_at(0), call(lst.remove_at, 99),
            lst.remove_count(items[2], -5), lst.index_of(items[3]), lst.last_index_of(items[3]),
            lst.index_of("absent"), lst.contains(items[4]), lst.range(1, 3), lst.range(-2, -1), len(lst),
            list(lst), lst[0]]
    lst[0] = "item0"
    lst.trim(1, 5)
    out += [lst.read_all(), lst.is_empty()]
    snap = stored(c, "l")
    lst.clear()
    out += [lst.size(), lst.is_exists(), lst.delete(), lst.is_exists()]
    return out, snap


@pytest.mark.parametrize("codec", CODECS + ["StringCodec"])
def test_list_stream_equals_the_reference(clients, codec):
    ref, got = both(clients, list_stream, codec)
    assert got == ref


# -- queues -------------------------------------------------------------------


def queue_stream(c, codec, rng):
    v = [int(x) for x in rng.integers(-50, 50, 24)]
    out = []
    q = c.get_queue("q", codec=codec)
    out += [q.poll(), q.peek(), call(q.element), call(q.remove_head), q.offer(v[0]), q.add(v[1]),
            q.offer(v[2]), q.peek(), q.element(), q.contains(v[1]), q.remove(v[1]), q.remove(999),
            q.size(), q.read_all(), q.poll_many(5), q.poll(), q.is_empty(), len(q)]
    q.offer(v[3])
    q.offer(v[4])
    out += [q.poll_last_and_offer_first_to("q2"), c.get_queue("q2", codec=codec).read_all(), q.remove_head()]
    d = c.get_deque("d", codec=codec)
    d.add_first(v[5])
    d.add_last(v[6])
    out += [d.offer_first(v[7]), d.offer_last(v[8]), d.peek_first(), d.peek_last(), d.read_all(),
            d.add_first_if_exists(v[9], v[10]), d.add_last_if_exists(v[11]),
            c.get_deque("d:none", codec=codec).add_first_if_exists(1), d.poll_first(), d.poll_last(),
            d.move("d2", "LEFT", "RIGHT"), d.move("d2", "RIGHT", "LEFT"), call(d.move, "d2", "UP", "LEFT"),
            d.add_first_to("d2"), d.add_last_to("d2"), c.get_deque("d2", codec=codec).read_all(), d.read_all()]
    bq = c.get_blocking_queue("bq", codec=codec)
    bq.offer(v[12])
    bq.offer(v[13])
    out += [bq.take(), bq.poll_blocking(0.01), bq.poll_blocking(0.01)]
    c.get_blocking_queue("bq:o", codec=codec).offer(v[14])
    out += [bq.poll_from_any(0.01, "bq:none", "bq:o"), bq.poll_from_any(0.01, "bq:none")]
    bq.offer(v[15])
    bq.offer(v[16])
    out += [bq.poll_last_and_offer_first_to_blocking("bq:dst", 0.01),
            bq.poll_last_and_offer_first_to_blocking("bq:none2", 0.01)]
    sink = []
    out += [bq.drain_to(sink), sink]
    bd = c.get_blocking_deque("bd", codec=codec)
    for x in v[17:21]:
        bd.add_last(x)
    out += [bd.take_first(), bd.take_last(), bd.poll_last_blocking(0.01), bd.poll_first(),
            bd.poll_last_blocking(0.01)]
    bb = c.get_bounded_blocking_queue("bb", codec=codec)
    out += [bb.try_set_capacity(2), bb.try_set_capacity(5), bb.offer(1), bb.offer(2), bb.offer(3),
            bb.offer(3, timeout=0.01), bb.poll(), bb.offer(3)]
    bb.put(4) if bb.size() < 2 else None
    out += [bb.read_all()]
    pq = c.get_priority_queue("pq", codec=codec)
    for x in v[:10]:
        pq.offer(x)
    out += [pq.peek(), pq.poll(), pq.read_all(), pq.contains(v[3]), pq.remove(v[3]), pq.remove(999),
            pq.poll_many(3), pq.poll_last_and_offer_first_to("pq2"),
            c.get_priority_queue("pq2", codec=codec).read_all(), pq.size()]
    pd = c.get_priority_deque("pd", codec=codec)
    for x in v[10:18]:
        pd.offer(x)
    out += [pd.poll_first(), pd.peek_first(), pd.poll_last(), pd.peek_last(), pd.read_all_descending(),
            call(pd.add_first, 1), call(pd.offer_last, 1)]
    pbq = c.get_priority_blocking_queue("pbq", codec=codec)
    for x in v[18:22]:
        pbq.offer(x)
    out += [pbq.take(), pbq.poll_blocking(0.01), call(pbq.poll_from_any, 0.01, "x"),
            call(pbq.poll_last_and_offer_first_to_blocking, "x", 0.01), pbq.read_all()]
    pbd = c.get_priority_blocking_deque("pbd", codec=codec)
    for x in v[:6]:
        pbd.offer(x)
    out += [pbd.take_first(), pbd.take_last(), pbd.poll_first_blocking(0.01), pbd.poll_last_blocking(0.01),
            pbd.read_all()]
    rb = c.get_ring_buffer("rb", codec=codec)
    out += [call(rb.offer, 1), call(rb.try_set_capacity, 0), rb.try_set_capacity(3), rb.try_set_capacity(4),
            rb.capacity(), rb.remaining_capacity()]
    for x in v[:5]:
        rb.offer(x)
    out += [rb.read_all(), rb.remaining_capacity()]
    rb.set_capacity(2)
    out += [rb.read_all(), rb.capacity(), call(rb.set_capacity, -1)]
    tq = c.get_transfer_queue("tq", codec=codec)
    out += [tq.try_transfer(v[0]), tq.size(), tq.transfer(v[1], timeout=0.02), tq.size()]
    got = []
    th = threading.Thread(target=lambda: got.append(tq.take()))
    th.start()
    for _ in range(200):  # the consumer parks on the queue's wait entry
        we = c.engine.queue_wait_entry("tq")
        with we.cond:
            if we.cond._waiters:
                break
        time.sleep(0.005)
    out += [tq.transfer(v[2], timeout=5.0)]
    th.join(5.0)
    out += [got, th.is_alive()]
    snap = stored(c, "q", "q2", "d", "d2", "bq", "bq:dst", "bd", "bb", "pq", "pq2", "pd", "pbq", "pbd", "rb", "tq")
    return out, snap


@pytest.mark.parametrize("codec", CODECS)
def test_queue_family_stream_equals_the_reference(clients, codec):
    ref, got = both(clients, queue_stream, codec)
    assert got == ref


def delayed_stream(c, codec, rng):
    dest = c.get_blocking_queue("dest", codec=codec)
    dq = c.get_delayed_queue(dest)
    out = [dq.name, dq.offer("now", 0.0), dq.offer("later", 60.0), dq.offer("later2", 30.0)]
    out.append(dest.poll_blocking(5.0))  # moved by the wheel timer
    out += [dq.read_all(), dq.size(), dq.transfer_due(), dq.poll(), dq.read_all()]
    return out, stored(c, dq.name, "dest")


def test_delayed_queue_rides_the_wheel_and_equals_the_reference(clients):
    ref, got = both(clients, delayed_stream, "JsonCodec")
    assert got == ref
    assert got[0][4] == "now"
    assert clients[1].engine._timer is not None  # the port's transfer rode the wheel


# -- sets ---------------------------------------------------------------------


def set_stream(c, codec, rng):
    a, b = words(rng, 12), words(rng, 12)
    s = c.get_set("s", codec=codec)
    t = c.get_set("t", codec=codec)
    out = [s.add(a[0]), s.add(a[0]), s.add_all(a[1:6]), s.add_all_counted(a[4:9]), s.try_add("x", a[0]),
           s.try_add("x", "y"), s.remove_all_counted(["x", "zz"]), s.contains_each([a[1], "zz", "y"]),
           s.remove(a[1]), s.remove("zz"), s.contains(a[2]), s.contains_all([a[2], a[3]]),
           s.contains_all([a[2], "zz"]), s.size(), _sorted(s.read_all()), s.is_empty()]
    t.add_all(b[:6] + a[2:4])
    out += [_sorted(s.read_union("t")), _sorted(s.read_intersection("t")), _sorted(s.read_diff("t")),
            s.move("t", a[5]), s.move("t", "zz"), s.remove_all(["y", "zz"]), s.retain_all(a[2:9]),
            _sorted(s.read_all())]
    out += [c.get_set("u1", codec=codec).union("s", "t"), c.get_set("u2", codec=codec).intersection("s", "t"),
            c.get_set("u3", codec=codec).diff("s", "t")]
    r = s.random_member()
    out += [r in s.read_all(), len(s.random_members(3)), s.get_lock(a[2]).name, s.get_fair_lock(a[2]).name,
            s.get_read_write_lock(a[2])._name, s.get_semaphore(a[2]).name,
            s.get_permit_expirable_semaphore(a[2]).name, s.get_count_down_latch(a[2]).name]
    r = c.get_set("r", codec=codec)  # random removals: replies and size only
    r.add_all(a)
    before = r.read_all()
    popped = r.remove_random()
    out += [popped in before, popped not in r.read_all(), r.size()]
    sc = c.get_set_cache("sc", codec=codec)
    out += [sc.add(a[0]), sc.add(a[1], ttl=60.0), sc.add(a[2], ttl=0.001), sc.add(a[0]), sc.contains(a[1])]
    time.sleep(0.01)
    out += [sc.contains(a[2]), sc.size(), _sorted(sc.read_all()), sc.remove(a[0]), sc.remove("zz"),
            sc.reap_expired()]
    ss = c.get_sorted_set("ss", codec=codec)
    nums = [int(x) for x in rng.integers(0, 100, 10)]
    out += [ss.add(nums[0]), ss.add(nums[0]), ss.add_all(nums[1:]), ss.remove(nums[2]), ss.remove(-1),
            ss.contains(nums[3]), ss.size(), ss.read_all(), ss.first(), ss.last()]
    lex = c.get_lex_sorted_set("lex")
    lex.add_all(list("hgfedcba"))
    out += [lex.range("b", True, "e", False), lex.range_head("c", True), lex.range_tail("f", False),
            lex.count("a", False, "z", True), lex.read_all()]
    return out, stored(c, "s", "t", "u1", "u2", "u3", "sc", "ss", "lex")


@pytest.mark.parametrize("codec", CODECS)
def test_set_family_stream_equals_the_reference(clients, codec):
    ref, got = both(clients, set_stream, codec)
    assert got == ref


# -- the scored sorted set ---------------------------------------------------


def zset_stream(c, codec, rng):
    m = words(rng, 20, "z")
    sc = [float(x) for x in np.round(rng.normal(0, 10, 20), 2)]
    z = c.get_scored_sorted_set("z", codec=codec)
    y = c.get_scored_sorted_set("y", codec=codec)
    out = [z.add(sc[0], m[0]), z.add(sc[1], m[0]), z.add_all(dict(zip(m[1:10], sc[1:10]))),
           z.add_all_if_absent({m[1]: 99.0, "new1": 5.0}), z.add_all_if_exist({m[2]: 1.5, "nope": 1.0}),
           z.add_all_if_greater({m[3]: 100.0, m[4]: -100.0}), z.add_all_if_less({m[5]: -100.0, m[6]: 100.0}),
           z.add_if_absent(1.0, m[7]), z.add_if_exists(2.0, m[7]), z.add_if_greater(-50.0, m[8]),
           z.add_if_less(-50.0, m[8]), z.add_score(m[9], 2.5), z.add_score("fresh", 1.0),
           z.add_score_and_get_rank(m[1], 0.5), z.add_score_and_get_rev_rank(m[2], -0.5),
           z.first_entry(), z.last_entry(), z.rank_entry(m[3]), z.rev_rank_entry(m[3]), z.rank_entry("zz"),
           z.get_score(m[4]), z.get_score("zz"), z.contains(m[5]), z.size(), z.rank(m[6]), z.rev_rank(m[6]),
           z.value_range(0, -1), z.value_range(0, 3, reverse=True), z.entry_range(2, 5),
           z.value_range_by_score(-5.0, True, 5.0, False), z.count(-5.0, True, 5.0, True), z.first(), z.last(),
           z.first_score(), z.last_score(), z.read_all(), z.value_range_reversed(0, 2),
           z.entry_range_reversed(0, 2), z.add_and_get_rank(0.0, "mid"), z.add_and_get_rev_rank(0.1, "mid2"),
           z.replace("mid", "mid-renamed"), z.replace("zz", "x")]
    y.add_all(dict(zip(m[5:15], sc[5:15])))
    out += [z.read_union("y"), z.read_intersection("y", aggregate="MAX"), z.read_diff("y"),
            z.count_intersection("y"), z.count_intersection("y", limit=2),
            c.get_scored_sorted_set("zu", codec=codec).union("z", "y", aggregate="MIN"),
            c.get_scored_sorted_set("zi", codec=codec).intersection("z", "y"),
            c.get_scored_sorted_set("zd", codec=codec).diff("z", "y")]
    out += [z.poll_first(), z.poll_last(), z.poll_first_entry(), z.poll_last_entry(), z.poll_first_many(2),
            z.poll_last_many(2), z.take_first(), z.take_last(), z.poll_first_blocking(0.01),
            z.remove(m[9]), z.remove("zz"), z.remove_all([m[1], m[2], "zz"]), z.remove_range_by_rank(0, 1),
            z.remove_range_by_score(-1000.0, True, -5.0, False), z.retain_all(m[:12]), z.read_all()]
    r = z.random_member()
    out += [r is None or r in z.read_all(), len(z.random_entries(2))]
    n = c.get_scored_sorted_set("n", codec=codec)
    n.add_all({3: 1.0, 1: 2.0, 2: 3.0})
    out += [n.read_sort(), n.read_sort("DESC", 0, 2), n.read_sort_alpha(), n.sort_to("n:sorted", "DESC"),
            c.get_list("n:sorted", codec=codec).read_all()]
    return out, stored(c, "z", "y", "zu", "zi", "zd", "n")


@pytest.mark.parametrize("codec", CODECS)
def test_scored_sorted_set_stream_equals_the_reference(clients, codec):
    ref, got = both(clients, zset_stream, codec)
    assert got == ref


# -- multimaps ----------------------------------------------------------------


def multimap_stream(c, codec, rng):
    out = []
    names = []
    for getter in ("get_list_multimap", "get_set_multimap", "get_list_multimap_cache", "get_set_multimap_cache"):
        name = getter[4:]
        names.append(name)
        mm = getattr(c, getter)(name, codec=codec)
        vals = words(rng, 10)
        out += [mm.put("k1", vals[0]), mm.put("k1", vals[0]), mm.put_all("k1", vals[1:4]),
                mm.put_all("k2", vals[4:7]), mm.put_all_entries({"k3": vals[7], "k4": vals[8]}),
                _sorted(mm.get_all("k1")), mm.get_all("none"), mm.remove("k1", vals[1]), mm.remove("k1", "zz"),
                _sorted(mm.replace_values("k2", [vals[9], vals[9]])), _sorted(mm.get_all("k2")),
                _sorted(mm.remove_all("k3")), mm.fast_remove("k4", "none"), mm.contains_key("k1"),
                mm.contains_entry("k1", vals[0]), mm.contains_entry("k1", "zz"), mm.key_size(), mm.size(),
                _sorted(mm.read_all_key_set()), _sorted(mm.entries())]
        if getter.endswith("cache"):
            out += [mm.expire_key("k1", 60.0), mm.expire_key("none", 1.0), mm.expire_key("k2", 0.001)]
            time.sleep(0.01)
            out += [mm.reap_expired(), mm.contains_key("k2"), mm.key_size()]
    return out, stored(c, *names)


@pytest.mark.parametrize("codec", CODECS)
def test_multimap_stream_equals_the_reference(clients, codec):
    ref, got = both(clients, multimap_stream, codec)
    assert got == ref


# -- topics and adders --------------------------------------------------------


def topic_stream(c, codec, rng):
    heard = []
    t = c.get_topic("news", codec=codec)
    out = [t.count_subscribers(), t.publish("nobody")]
    lid = t.add_listener(lambda ch, msg: heard.append(("t", ch, msg)))
    pt = c.get_pattern_topic("ne*", codec=codec)
    pid = pt.add_listener(lambda ch, msg: heard.append(("p", ch, msg)))
    msgs = [int(x) for x in rng.integers(0, 1000, 5)]
    for m in msgs:
        out.append(t.publish({"m": m}))
    out += [t.count_subscribers()]
    t.remove_listener(lid)
    pt.remove_listener(pid)
    out += [t.publish("gone"), heard]
    st = c.get_sharded_topic("shard{a}", codec=codec)
    out += [st.slot(), st.publish("x")]
    rt = c.get_reliable_topic("rt", codec=codec)
    out += [rt.publish("before"), rt.size()]
    s1 = rt.add_subscriber()
    out += [rt.publish("a"), rt.publish("b")]
    s2 = rt.add_subscriber()
    out += [rt.publish("c"), rt.count_subscribers(), rt.poll(s1), rt.poll(s2, max_messages=5), rt.poll(s1),
            rt.poll(s1, timeout=0.01), rt.size(), call(rt.poll, "nobody")]
    rt.remove_subscriber(s2)
    out += [rt.count_subscribers(), rt.size()]
    return out, stored(c, "rt")


@pytest.mark.parametrize("codec", CODECS)
def test_topic_stream_equals_the_reference(clients, codec):
    ref, got = both(clients, topic_stream, codec)
    assert got == ref


def adder_stream(c, codec, rng):
    out = []
    for getter, deltas in (("get_long_adder", [int(x) for x in rng.integers(-9, 9, 12)]),
                           ("get_double_adder", [float(x) for x in np.round(rng.normal(0, 3, 12), 3)])):
        a, b = getattr(c, getter)(getter), getattr(c, getter)(getter)
        for i, d in enumerate(deltas):
            (a if i % 2 else b).add(d)
        a.increment()
        b.decrement()
        out += [a.name, a.sum(), b.sum()]
        a.add(deltas[0])
        b.reset()
        out += [a.sum(), b.sum()]
        a.add(5)
        a.destroy()
        out += [b.sum()]
        b.destroy()
    return out, stored(c, "get_long_adder", "get_double_adder")


def test_adder_stream_equals_the_reference(clients):
    ref, got = both(clients, adder_stream)
    assert got == ref


# -- Keys and MapCache --------------------------------------------------------


def keys_stream(c, codec, rng):
    k = c.get_keys()
    for i, name in enumerate(words(rng, 8, "key:")):
        c.get_list(name).add(i)
    c.get_set("other").add(1)
    c.get_scored_sorted_set("z:1").add(1.0, "m")
    out = [sorted(k.get_keys()), sorted(k.get_keys("key:*")), sorted(k.get_keys_stream("z*")), k.count(),
           k.count_exists("other", "z:1", "none"), k.random_key() in k.get_keys(), k.delete("other", "none"),
           k.delete_by_pattern("key:1*"), k.unlink("z:1"), k.expire("key:2", 100.0) if "key:2" in k.get_keys()
           else None, k.remain_time_to_live("none"), k.count()]
    ttl = [k.remain_time_to_live(n) for n in sorted(k.get_keys())]
    out += [[t is None or 90 < t <= 100 for t in ttl]]
    snap = sorted(k.get_keys())
    k.flushdb()
    out += [k.count(), snap]
    return out, {}


def test_keys_stream_equals_the_reference(clients):
    ref, got = both(clients, keys_stream)
    assert got == ref


def map_cache_stream(c, codec, rng):
    events = []
    mc = c.get_map_cache("mc", codec=codec)
    tokens = [mc.add_entry_listener(kind, lambda k, v, o, kind=kind: events.append((kind, k, v, o)))
              for kind in ("created", "updated", "removed", "expired")]
    vals = [int(x) for x in rng.integers(0, 100, 12)]
    out = [call(mc.add_entry_listener, "bogus", print), mc.put("a", vals[0]), mc.put("a", vals[1]),
           mc.put_with_ttl("t", vals[2], 60.0), mc.put_with_ttl("gone", vals[3], 0.001),
           mc.put_if_absent_with_ttl("t", 1, 60.0), mc.put_if_absent_with_ttl("u", vals[4], 60.0),
           mc.fast_put("b", vals[5]), mc.get("a"), mc.contains_value(vals[5]), mc.contains_value(-1)]
    time.sleep(0.01)
    out += [mc.get("gone"), mc.size(), _sorted(mc.read_all_keys()), _sorted(mc.read_all_values()),
            _sorted(mc.read_all_entry_set()), mc.remain_time_to_live_entry("a"),
            50 < mc.remain_time_to_live_entry("t") <= 60.0, mc.remove("b"), mc.reap_expired(),
            mc.try_set_max_size(3), mc.try_set_max_size(5), mc.get_max_size(), call(mc.try_set_max_size, -1),
            call(mc.set_max_size, 2, "MRU")]
    for i in range(5):
        mc.put(f"f{i}", vals[6 + i])
        mc.get("a")  # keep "a" recently used
    out += [mc.size(), _sorted(mc.read_all_keys())]
    mc.set_max_size(2, "LFU")
    out += [mc.size(), mc.get_max_size()]
    c.engine.events_pool.submit(lambda: None).result(5.0)  # the events before it are delivered
    for tok in tokens:
        mc.remove_entry_listener(tok)
    return out + [events], stored(c, "mc")


@pytest.mark.parametrize("codec", CODECS)
def test_map_cache_stream_equals_the_reference(clients, codec):
    ref, got = both(clients, map_cache_stream, codec)
    assert got == ref
    assert got[0][-1]  # listeners heard events, on the events pool


def test_per_key_synchronizers_of_a_map_equal_the_reference(clients):
    def stream(c, codec, rng):
        m = c.get_map("m", codec=codec)
        names = [m.get_lock("k").name, m.get_fair_lock("k").name, m.get_read_write_lock("k")._name,
                 m.get_semaphore("k").name, m.get_permit_expirable_semaphore("k").name,
                 m.get_count_down_latch(1).name]
        m.get_semaphore("k").try_set_permits(2)
        return names, stored(c, names[3])

    ref, got = both(clients, stream, "JsonCodec")
    assert got == ref


def test_host_record_kinds_carry_across():
    """state.from_reference and to_reference carry the host-only records
    (lists, sets, sorted sets, queues, multimaps, synchronizers)."""
    j = redisson_tpu.create()
    try:
        j.get_list("l").add_all([1, "a"])
        j.get_scored_sorted_set("z").add(1.5, "m")
        j.get_set_multimap("mm").put("k", "v")
        for name in ("l", "z", "mm"):
            rec = j.engine.store.get(name)
            port = state.from_reference(rec.kind, rec.meta, {}, "cpu", rec.host)
            assert state.to_reference(port) == (rec.kind, rec.meta, {}, rec.host)
    finally:
        j.shutdown()
