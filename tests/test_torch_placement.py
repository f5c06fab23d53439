"""Slot placement over mesh positions (server/placement.py) and the server's
devices= serving, against the reference on the CPU.

The reference's SlotPlacement spans its 8 XLA host devices, the port's 8
CPU positions: owner tables, spread plans and plan_frame partitions are
equal.  A port server with devices=8 gives a reference server's
(devices=8) reply bytes for config 5's stream (bench.py's
``_mixed_cluster_cmds``) in RESP2 and RESP3, and a devices=1 port server's.
CLUSTER DEVICES and DEVMOVE over the wire equal the reference's (labels
aside: a JAX device's name against a position's).  Where the reference
asserts a tensor's device, the port holds the record's owner position: on
torch's one CPU device the positions share one tensor device."""
import numpy as np
import pytest

import bench
import redisson_tpu_torch
from redisson_tpu.server.placement import SlotPlacement as RefPlacement
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu_torch.client.objects.bitset import BitSet
from redisson_tpu_torch.client.objects.hyperloglog import HyperLogLog
from redisson_tpu_torch.core import coalesce as CO
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core.engine import Engine
from redisson_tpu_torch.core.store import StateRecord
from redisson_tpu_torch.parallel import mesh as TM
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.server.placement import PlacementStaleEpoch, SlotPlacement
from redisson_tpu_torch.services.mapreduce import word_count
from redisson_tpu_torch.tools import wire_stream as W
from redisson_tpu_torch.utils.crc16 import calc_slot

TM.set_cpu_positions(8)


def _config5(tag: str, tenants: int = 8, per: int = 1500):
    cmds, _ops = bench._mixed_cluster_cmds(np.random.default_rng(11), tenants, per)(tag)
    return cmds


def _distinct(placement, n, prefix):
    out, seen = [], set()
    for i in range(10_000):
        name = f"{prefix}{i}"
        d = placement.device_id_for_name(name)
        if d not in seen:
            seen.add(d)
            out.append(name)
        if len(out) == n:
            return out
    raise AssertionError("not enough distinct positions")


def test_owner_table_spread_plan_and_frame_plans_equal_the_reference():
    ref, port = RefPlacement(), SlotPlacement()
    assert port.n_devices == ref.n_devices == 8
    np.testing.assert_array_equal(port.owner_snapshot(), ref.owner_snapshot())
    assert port.slot_counts() == ref.slot_counts()
    for n in (1, 3, 4, 8):
        assert port.spread_plan(n) == ref.spread_plan(n)
    assert port.device_span(6, 5) == ref.device_span(6, 5)
    cmds = [[a if isinstance(a, bytes) else str(a).encode() for a in c] for c in _config5("p")]
    cmds += [[b"SET", b"x", b"1"], [b"DEL", b"x"], [b"GET", b"y"], [b"PFCOUNT", b"a", b"b"],
             [b"PING"], [b"BITOP", b"OR", b"d", b"s1", b"s2"]]
    for c in cmds:
        assert port.device_index_for_command(c) == ref.device_index_for_command(c)
    for single in (False, True):
        assert port.plan_frame(cmds, single_device_ok=single) == ref.plan_frame(cmds, single_device_ok=single)
        assert port.plan_frame(cmds[:1], single) == ref.plan_frame(cmds[:1], single)
    moves = port.spread_plan(4)
    for slot, dev in moves.items():
        assert port.assign(slot, dev, epoch=3) == ref.assign(slot, dev, epoch=3)
    np.testing.assert_array_equal(port.owner_snapshot(), ref.owner_snapshot())
    assert port.plan_frame(cmds) == ref.plan_frame(cmds)
    with pytest.raises(PlacementStaleEpoch, match="STALEEPOCH"):
        port.assign(next(iter(moves)), 0, epoch=2)
    assert port.moves == ref.moves


def test_config5_reply_bytes_equal_the_reference_and_one_position():
    """Config 5's stream on a port server with devices=8, a reference
    server with devices=8 and a port server with devices=1: the same reply
    bytes, RESP2 then RESP3."""
    waves = [_config5("a"), [("HELLO", "3")] + _config5("b")]
    got = {}
    for name, make in (("ref8", lambda: RefServerThread(port=0, devices=8)),
                       ("port8", lambda: ServerThread(port=0, device="cpu", devices=8)),
                       ("port1", lambda: ServerThread(port=0, device="cpu", devices=1))):
        with make() as st:
            got[name] = W.replies(st.server.host, st.server.port, waves)
            if name == "port8":
                lanes = st.server.engine.lanes
                assert sum(lane.dispatches for lane in lanes.lanes()) > 0
                assert sum(1 for lane in lanes.lanes() if lane.dispatches) > 1
    for w, wave in enumerate(waves):
        spans = {k: W.reply_spans(v[w][0]) for k, v in got.items()}
        assert len(spans["ref8"]) == len(wave)
        assert spans["port8"] == spans["ref8"], w
        assert spans["port1"] == spans["ref8"], w
    # every probe of the stream found, every SETBITSB answered
    probes = [r for c, r in zip(waves[0], got["port8"][0][1]) if c[0] == "BF.MEXISTS64"]
    assert probes and all(np.frombuffer(r, np.uint8).all() for r in probes)


def _devices_rows(reply):
    """CLUSTER DEVICES without the labels (a JAX device's name, a
    position's): [n, [id, slots, [QOS...], [FAULTS...]]...]."""
    return [reply[0]] + [[row[0], row[1]] + row[3:] for row in reply[1:]]


def test_cluster_devices_and_devmove_over_the_wire_equal_the_reference():
    small = [("SET", f"k{i}", f"v{i}") for i in range(40)] + [("PFADD", f"h{i}", "a", "b") for i in range(12)]
    script = []
    got = {}
    for name, make in (("ref", lambda: RefServerThread(port=0, devices=8)),
                       ("port", lambda: ServerThread(port=0, device="cpu", devices=8))):
        with make() as st:
            with st.client() as c:
                c.execute_many(small)
                before = c.execute("CLUSTER", "DEVICES")
                slot = calc_slot(b"h3")
                out = [c.execute("CLUSTER", "DEVMOVE", 5, "EPOCH", 9, slot),
                       c.execute("CLUSTER", "DEVMOVE", 5, "EPOCH", 9, slot),
                       c.execute("CLUSTER", "DEVMOVE", 2, "EPOCH", 8, slot),
                       c.execute("CLUSTER", "DEVMOVE", 2, slot, calc_slot(b"k7")),
                       c.execute("CLUSTER", "DEVMOVE", 99, slot),
                       c.execute("PFCOUNT", "h3"), c.execute("GET", "k7")]
                labels = [row[2] for row in before[1:]]
                got[name] = (_devices_rows(before), [str(o) if isinstance(o, Exception) else o for o in out],
                             _devices_rows(c.execute("CLUSTER", "DEVICES")))
                script.append((name, labels, st.server.engine.placement.device_id_for_slot(slot)))
    assert got["port"] == got["ref"]
    assert got["port"][1][0] >= 1 and got["port"][1][2].startswith("STALEEPOCH")
    assert [s[2] for s in script] == [2, 2]
    assert script[1][1] == [f"cpu/position {i}".encode() for i in range(8)]
    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        assert c.execute("CLUSTER", "DEVICES") == [0]
        assert "placement is not enabled" in str(c.execute("CLUSTER", "DEVMOVE", 1, 5))
        assert "placement is not enabled" in str(c.execute("CLUSTER", "DEVPROBE", 1))
        q = c.execute("CLUSTER", "QOS")
        assert q[0] == 1 and [bytes(r[0]) for r in q[3:5]] == [b"interactive", b"bulk"]


@pytest.fixture()
def engine():
    eng = Engine(device="cpu")
    eng.enable_placement()
    yield eng
    eng.shutdown()


def test_records_are_owned_by_their_slots_position(engine):
    """The port's hold of test_device_sharding's device-identity tests: the
    owner position of a record at every install, and a fenced move."""
    p = engine.placement
    names = _distinct(p, 4, "own")
    for name in names:
        HyperLogLog(engine, name).add_all([f"{name}:{j}" for j in range(20)])
        assert engine.store.get(name).position == p.device_id_for_name(name)
    engine.store.put_unguarded("imp0", StateRecord(kind="bitset", meta={}, arrays={}))
    assert engine.store.get("imp0").position == p.device_id_for_name("imp0")
    name = names[0]
    before = engine.store.get(name).arrays["regs"].clone()
    count = HyperLogLog(engine, name).count()
    slot = calc_slot(name.encode())
    src = p.device_id_for_slot(slot)
    dst = (src + 3) % p.n_devices
    assert engine.move_slot_records(slot, dst, epoch=10) >= 1
    rec = engine.store.get(name)
    assert rec.position == dst and bool((rec.arrays["regs"] == before).all())
    assert HyperLogLog(engine, name).count() == count
    with pytest.raises(PlacementStaleEpoch, match="STALEEPOCH"):
        engine.move_slot_records(slot, src, epoch=9)
    assert engine.store.get(name).position == dst
    with pytest.raises(NotImplementedError, match="more than one device"):
        Engine(device="cpu").enable_placement(devices=[TM.Position(0, __import__("torch").device("meta"))])


def test_cross_position_merges_match_one_position_and_gather_nothing_on_the_host():
    placed, plain = Engine(device="cpu"), Engine(device="cpu")
    placed.enable_placement()
    try:
        names = _distinct(placed.placement, 4, "hu")
        rng = np.random.default_rng(3)
        for name in names:
            keys = [f"{name}:{int(k)}" for k in rng.integers(0, 1 << 40, 300)]
            HyperLogLog(placed, name).add_all(keys)
            HyperLogLog(plain, name).add_all(keys)
        ioplane.STATS.reset()
        assert HyperLogLog(placed, names[0]).count_with(*names[1:]) == \
            HyperLogLog(plain, names[0]).count_with(*names[1:])
        HyperLogLog(placed, names[0]).merge_with(*names[1:])
        assert placed.store.get(names[0]).position == placed.placement.device_id_for_name(names[0])
        a, b = _distinct(placed.placement, 2, "bo")
        BitSet(placed, a).set_each(np.array([1, 5, 9]))
        BitSet(placed, b).set_each(np.array([2, 5, 100]))
        BitSet(placed, a).or_(b)
        got = np.asarray(BitSet(placed, a).get_each(np.arange(128)))
        assert sorted(np.nonzero(got)[0].tolist()) == [1, 2, 5, 9, 100]
        assert ioplane.STATS.snapshot()["host_colocations"] == 0
    finally:
        placed.shutdown()
        plain.shutdown()


def test_word_count_spreads_chunks_over_the_positions():
    from redisson_tpu_torch.client.codec import StringCodec
    from redisson_tpu_torch.core import kernels as K

    c = redisson_tpu_torch.create(device="cpu")
    try:
        c._engine.enable_placement()
        m = c.get_map("ds:wc", codec=StringCodec())
        rng = np.random.default_rng(5)
        vocab = [f"w{i}" for i in range(40)]
        m.put_all({f"d{i}": " ".join(vocab[j] for j in rng.integers(0, 40, 6)) for i in range(3000)})
        calls = []
        real = K.wc_extract_words_auto
        K.wc_extract_words_auto = lambda *a, **k: (calls.append(a[0].device), real(*a, **k))[1]
        try:
            ioplane.STATS.reset()
            counts = word_count(m)
        finally:
            K.wc_extract_words_auto = real
        assert sum(counts.values()) == 3000 * 6
        assert len(calls) == 8  # a chunk a position
        assert ioplane.STATS.snapshot()["host_colocations"] == 0
    finally:
        c.shutdown()


def test_coalesced_runs_fuse_a_position_at_a_time():
    c = redisson_tpu_torch.create(device="cpu")
    try:
        engine = c._engine
        engine.enable_placement()
        a, b = _distinct(engine.placement, 2, "cx")
        home = engine.placement.device_id_for_name("sd0")
        same = [n for n in (f"sd{i}" for i in range(2000)) if engine.placement.device_id_for_name(n) == home][:3]
        for name in (a, b, *same):
            assert c.get_bloom_filter(name).try_init(20_000, 0.01)
        with pytest.raises(CO.CoalesceIneligible, match="span"):
            CO.fused_bloom_add_async(engine, [a, b], [np.arange(10, dtype=np.int64)] * 2)
        keys = [np.arange(50, dtype=np.int64) * (i + 1) for i in range(3)]
        newly, lengths = CO.fused_bloom_add_async(engine, same, keys)
        assert list(lengths) == [50, 50, 50]
        for name, k in zip(same, keys):
            assert c.get_bloom_filter(name).contains_each(k).all()
    finally:
        c.shutdown()


def test_lanes_count_dispatches_and_peak_concurrency():
    lanes = ioplane.LaneSet(TM.local_devices("cpu", count=3))
    import threading

    barrier = threading.Barrier(3)

    def hold(i):
        with lanes.lane(i).occupy(10, qos_class="bulk", nbytes=64):
            barrier.wait(timeout=10)

    threads = [threading.Thread(target=hold, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert lanes.reset_concurrency() == 3 and lanes.peak_concurrent == 0
    assert [lane.dispatches for lane in lanes.lanes()] == [1, 1, 1]
    assert lanes.lane(0).qos.wire_row() == [0, 0, 0, 0, 0, 10]
    census = lanes.census()
    assert census["lanes"] == 3 and census["active_dispatches"] == 0 and census["lane2_quarantined"] == 0
    assert ioplane.is_retryable_device_fault(ioplane.LaneWatchdogTimeout("slow readback"))
    prev = ioplane.set_replica_occupancy(1000.0)
    try:
        assert ioplane.replica_occupancy() == 1000.0
    finally:
        ioplane.set_replica_occupancy(prev)
    pipe = ioplane.FlushPipeline(overlap=True, depth=1)
    import torch

    futs = [pipe.submit(lambda i=i: ((torch.tensor([i]),), lambda h: int(h[0][0]))) for i in range(3)]
    assert pipe.pending() == 1 and futs[0].done()
    pipe.drain()
    assert [f.result() for f in futs] == [0, 1, 2]
