"""The port's live slot migration, journals and device rebalance against the
reference's, on the CPU.

  * One command stream (SETSLOT MIGRATING / IMPORTING / STABLE / NODE with
    EPOCH, a stale EPOCH, WINDOWS, MIGRATESLOT, MIGRATESLOTS, IMPORTRECORDS,
    and keyed commands that get ASK, TRYAGAIN and MOVED) goes to a
    reference pair of masters and to a port pair: their reply bytes are
    equal, RESP2 and RESP3, once each node's address, port and ID are
    replaced by its index.
  * The IMPORTRECORDS blob of the same records is byte-identical between
    the packages.
  * A journaled migration killed at each phase by one package's coordinator
    is resumed by the other's ``resume_migrations``; both directions reach
    the same view and bit-identical bloom-bank and HLL planes.
  * A device rebalance over the CPU's 8 positions, killed at each phase and
    resumed, leaves every record at the reference's owner position with
    planes equal bit for bit.

Every input is made from a numpy seed.
"""
import os
import socket

import numpy as np
import pytest

from redisson_tpu.harness import ClusterRunner as RefClusterRunner
from redisson_tpu.server import migration as ref_mig
from redisson_tpu.server import replication as ref_replication
from redisson_tpu.server.migration_journal import ImportJournal as RefImportJournal
from redisson_tpu.server.migration_journal import MigrationJournal as RefMigrationJournal
from redisson_tpu_torch.harness import ClusterRunner
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.net.client import Connection
from redisson_tpu_torch.parallel import mesh
from redisson_tpu_torch.server import migration as port_mig
from redisson_tpu_torch.server import replication as port_replication
from redisson_tpu_torch.server.migration_journal import ImportJournal, MigrationJournal
from redisson_tpu_torch.tools import wire_stream as W
from redisson_tpu_torch.utils.crc16 import calc_slot
from tests._torch_port_suite import time_limit

# the most seconds a test that starts two clusters may take
PAIR_TEST_S = 120
SEED = 2026
# config 5's shape, cut to a few tenants: a bloom bank and an HLL bank
BANK_TENANTS, BANK_PER, HLL_COUNTERS, OPS = 8, 200, 16, 2000


def _tag_on(runner, mi: int, prefix: str) -> str:
    """A hashtag whose slot master mi owns."""
    lo, hi = runner.slot_ranges[mi]
    return next(t for t in (f"{prefix}{i}" for i in range(100_000)) if lo <= calc_slot(t.encode()) <= hi)


def _normalize(raw: bytes, runner) -> bytes:
    """Reply bytes with each master's host:port, port and node ID replaced by
    its index (the only bytes that differ between two clusters)."""
    for i, m in enumerate(runner.masters):
        srv = m.server.server
        raw = raw.replace(f"{srv.host}:{srv.port}".encode(), b"<m%d>" % i)
        raw = raw.replace(srv.node_id.encode(), b"<id%d>" % i)
        raw = raw.replace(b":%d\r\n" % srv.port, b":<p%d>\r\n" % i)
    return raw


class _Stepper:
    """One raw connection a node; each step sends one command to one node
    and reads its one reply (raw bytes and parsed)."""

    def __init__(self, runner, proto: int):
        self.socks, self.parsers = [], []
        for m in runner.masters:
            srv = m.server.server
            s = socket.create_connection((srv.host, srv.port), timeout=60)
            self.socks.append(s)
            self.parsers.append(resp.RespParser(use_native=False))
            if proto == 3:
                self.step(len(self.socks) - 1, ("HELLO", "3"))

    def step(self, node: int, cmd: tuple):
        s, parser = self.socks[node], self.parsers[node]
        s.sendall(resp.encode_commands([cmd]))
        raw, got = [], []
        while not got:
            data = s.recv(1 << 20)
            if not data:
                raise ConnectionError("server closed the connection early")
            raw.append(data)
            got += parser.feed(data)
        return b"".join(raw), got[0]

    def close(self):
        for s in self.socks:
            s.close()


def _imported_blob(tag: str) -> bytes:
    """An IMPORTRECORDS blob of one bucket in the migrating slot, made by
    the reference's serializer (either package's target applies it)."""
    from redisson_tpu.server.server import ServerThread as RefServerThread

    with RefServerThread(port=0) as st, st.client() as c:
        c.execute("SET", f"{{{tag}}}imp", "imported")
        blob, shipped = ref_replication.serialize_records(st.server.engine, [f"{{{tag}}}imp"],
                                                          include_live=False)
    assert shipped
    return blob


def _migration_steps(runner, tag: str, blob: bytes) -> list:
    """(node, command) steps of one migration window by hand, node 0 the
    source and node 1 the target."""
    a, b = (m.server.server for m in runner.masters)
    src, dst, dst_id = a.address(), b.address(), b.node_id
    slot = calc_slot(tag.encode())
    k = [f"{{{tag}}}{c}" for c in "abc"]
    return [
        (0, ("SET", k[0], "1")), (0, ("SET", k[1], "2")), (0, ("SET", k[2], "3")),
        (1, ("CLUSTER", "SETSLOT", slot, "IMPORTING", src, "EPOCH", 5)),
        (0, ("CLUSTER", "SETSLOT", slot, "MIGRATING", dst, "EPOCH", 5)),
        (0, ("CLUSTER", "SETSLOT", slot, "MIGRATING", dst, "EPOCH", 4)),  # stale
        (0, ("CLUSTER", "WINDOWS")), (1, ("CLUSTER", "WINDOWS")),
        (0, ("CLUSTER", "MIGRATESLOT", slot, 1)),
        (0, ("GET", k[0])),                      # moved already: ASK
        (0, ("RENAME", k[1], k[0])),             # split across the window: TRYAGAIN
        (0, ("GET", k[1])),                      # still here: served
        (0, ("SET", f"{{{tag}}}new", "x")),      # a creation in the window: ASK
        (0, ("DEL", k[0])),                      # absent: ASK
        (1, ("GET", k[0])),                      # not asked: MOVED to the source
        (1, ("ASKING",)), (1, ("GET", k[0])),    # asked: served
        (0, ("CLUSTER", "MIGRATESLOTS", "EPOCH", 3, slot)),  # stale
        (0, ("CLUSTER", "MIGRATESLOTS", "EPOCH", 5, slot)),
        (0, ("CLUSTER", "MIGRATESLOTS", "EPOCH", 5, slot)),  # nothing left
        (0, ("CLUSTER", "MIGRATESLOT", (slot + 1) % 16384)),  # not MIGRATING
        (1, ("IMPORTRECORDS", "EPOCH", 5, "SOURCE", src, blob)),
        (1, ("CLUSTER", "WINDOWS")),
        (1, ("IMPORTRECORDS", "EPOCH")),         # malformed
        (0, ("CLUSTER", "SETSLOT", slot, "NODE", dst, dst_id, "EPOCH", 5)),
        (1, ("CLUSTER", "SETSLOT", slot, "NODE", dst, dst_id, "EPOCH", 5)),
        (0, ("CLUSTER", "WINDOWS")), (1, ("CLUSTER", "WINDOWS")),
        (0, ("GET", k[1])),                      # the view moved: MOVED
        (1, ("MGET", *k)), (1, ("GET", f"{{{tag}}}imp")),
        (1, ("CLUSTER", "COUNTKEYSINSLOT", slot)),
        (0, ("CLUSTER", "SETSLOT", slot, "STABLE", "EPOCH", 2)),  # stale
        (0, ("CLUSTER", "SETSLOT", slot, "BOGUS")),
        (0, ("CLUSTER", "SLOTS")), (1, ("CLUSTER", "SLOTS")),
    ]


@pytest.mark.parametrize("proto", [2, 3])
def test_migration_stream_reply_bytes_match_the_reference(tmp_path, proto):
    blob_tag = None
    with time_limit(PAIR_TEST_S):
        out = []
        for name, make in (("ref", RefClusterRunner), ("port", ClusterRunner)):
            kw = {} if name == "ref" else {"device": "cpu"}
            runner = make(masters=2, journal_dir=str(tmp_path / name), **kw).run()
            try:
                tag = _tag_on(runner, 0, "mg")
                if blob_tag is None:
                    blob_tag = (tag, _imported_blob(tag))
                assert blob_tag[0] == tag
                stepper = _Stepper(runner, proto)
                try:
                    got = [(node, *stepper.step(node, cmd))
                           for node, cmd in _migration_steps(runner, tag, blob_tag[1])]
                finally:
                    stepper.close()
                out.append([(node, _normalize(raw, runner), reply) for node, raw, reply in got])
            finally:
                runner.shutdown()
        want, got = out
        assert len(got) == len(want)
        for i, (w, g) in enumerate(zip(want, got)):
            assert g[:2] == w[:2], (i, w, g)
        # the stream reached what it means to
        errors = [str(r) for _n, _raw, r in got if isinstance(r, Exception)]
        for head in ("ASK ", "TRYAGAIN", "MOVED ", "STALEEPOCH", "ERR slot"):
            assert any(e.startswith(head) for e in errors), head
        windows = [r for _n, _raw, r in got if isinstance(r, list) and r and isinstance(r[0], list)]
        assert any(bytes(row[0]) == b"IMPORTJOURNAL" for rows in windows for row in rows)


def test_importrecords_blob_is_the_references(tmp_path):
    """The same records (a bloom bank, an HLL bank, a bit set, a bucket, a
    hash), made by the same commands on each package's server, serialize to
    the same IMPORTRECORDS blob, byte for byte, once each record's nonce
    (drawn at random when a record is made) is the same seeded value on
    both sides; the port's target installs the reference's blob and
    serializes it back unchanged."""
    from redisson_tpu.server.server import ServerThread as RefServerThread
    from redisson_tpu_torch.server import ServerThread

    rng = np.random.default_rng(SEED)
    tenants = rng.integers(0, BANK_TENANTS, OPS).astype(np.int32)
    keys = rng.integers(-2**62, 2**62, OPS)
    counters = rng.integers(0, HLL_COUNTERS, OPS).astype(np.int32)
    bits = rng.integers(0, 100_000, 500).astype(np.int64)
    cmds = [("BFA.RESERVE", "{b}bank", BANK_TENANTS, BANK_PER, "0.01"),
            ("BFA.MADD64", "{b}bank", W._i4(tenants), W._i8(keys)),
            ("HLLA.RESERVE", "{b}hll", HLL_COUNTERS),
            ("HLLA.MADD64", "{b}hll", W._i4(counters), W._i8(keys)),
            ("SETBITSB", "{b}bits", W._i8(bits), 1),
            ("SET", "{b}s", "v"), ("HSET", "{b}h", "f", "1", "g", "2")]
    names = ["{b}bank", "{b}hll", "{b}bits", "{b}s", "{b}h"]
    blobs = []
    for make, kw in ((RefServerThread, {}), (ServerThread, {"device": "cpu"})):
        with make(port=0, **kw) as st, st.client() as c:
            for cmd in cmds:
                reply = c.execute(*cmd)
                assert not isinstance(reply, Exception), (cmd, reply)
            nonces = np.random.default_rng(SEED + 1).integers(1, 2**62, len(names))
            for name, nonce in zip(names, nonces):
                st.server.engine.store.get_unguarded(name).nonce = int(nonce)
            serialize = ref_replication if make is RefServerThread else port_replication
            blob, shipped = serialize.serialize_records(st.server.engine, names, include_live=False)
            assert sorted(n for n, _nonce, _ver in shipped) == sorted(names)
            blobs.append(blob)
    ref_blob, port_blob = blobs
    assert port_blob == ref_blob
    # and the port's target installs the reference's blob as its own
    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        assert c.execute("IMPORTRECORDS", ref_blob) == len(names)
        again, _ = port_replication.serialize_records(st.server.engine, names, include_live=False)
    assert again == ref_blob


def _fill(conn, tag: str) -> None:
    rng = np.random.default_rng(SEED)
    conn.execute("BFA.RESERVE", f"{{{tag}}}bank", BANK_TENANTS, BANK_PER, "0.01")
    conn.execute("BFA.MADD64", f"{{{tag}}}bank", W._i4(rng.integers(0, BANK_TENANTS, OPS).astype(np.int32)),
                 W._i8(rng.integers(-2**62, 2**62, OPS)))
    conn.execute("HLLA.RESERVE", f"{{{tag}}}hll", HLL_COUNTERS)
    conn.execute("HLLA.MADD64", f"{{{tag}}}hll", W._i4(rng.integers(0, HLL_COUNTERS, OPS).astype(np.int32)),
                 W._i8(rng.integers(-2**62, 2**62, OPS)))
    conn.execute("SET", f"{{{tag}}}s", "payload")


def _planes(runner, tag: str) -> dict:
    """{holder index, name: plane bytes} of the tag's records, wherever
    they are."""
    out = {}
    for i, m in enumerate(runner.masters):
        store = m.server.server.engine.store
        for name, key in ((f"{{{tag}}}bank", "bits"), (f"{{{tag}}}hll", "regs")):
            rec = store.get_unguarded(name)
            if rec is not None:
                arr = rec.arrays[key]
                arr = arr.cpu().numpy() if hasattr(arr, "cpu") else np.asarray(arr)
                out[(i, name)] = arr.tobytes()
    return out


def _view(runner) -> list:
    """Each node's CLUSTER SLOTS, addresses and IDs by master index."""
    out = []
    for m in runner.masters:
        srv = m.server.server
        raw, = W.replies(srv.host, srv.port, [[("CLUSTER", "SLOTS")]])
        out.append(_normalize(raw[0], runner))
    return out


_PHASES = [("PLANNED", "rolled_back"), ("WINDOW_OPEN", "completed"),
           ("DRAINING:1", "completed"), ("VIEW_COMMITTED", "completed")]


@pytest.mark.parametrize("phase, expect", _PHASES)
def test_a_journal_killed_in_one_package_resumes_in_the_other(tmp_path, phase, expect):
    """Reference servers, the reference's coordinator killed at the phase and
    the port's resume_migrations; then port servers, the port's coordinator
    killed at the phase and the reference's resume: the same action, the
    same views, and the same planes on the same holder, bit for bit."""
    runs = []
    with time_limit(PAIR_TEST_S):
        for name, make, kw, first, then in (
                ("ref", RefClusterRunner, {}, ref_mig, port_mig),
                ("port", ClusterRunner, {"device": "cpu"}, port_mig, ref_mig)):
            jd = str(tmp_path / name)
            runner = make(masters=2, journal_dir=jd, **kw).run()
            try:
                tag = _tag_on(runner, 0, "mj")
                src, dst = (m.server.server for m in runner.masters)
                c = Connection(src.host, src.port, timeout=60.0)
                try:
                    _fill(c, tag)
                finally:
                    c.close()
                before = _planes(runner, tag)
                with pytest.raises(first.CoordinatorKilled):
                    first.migrate_slots(src.address(), dst.address(), [calc_slot(tag.encode())],
                                        journal_dir=jd, crash_after=phase)
                results = then.resume_migrations(jd)
                assert [r["action"] for r in results] == [expect], (name, results)
                assert not MigrationJournal.in_flight(jd) and not RefMigrationJournal.in_flight(jd)
                assert not ImportJournal.in_flight(jd) and not RefImportJournal.in_flight(jd)
                for m in runner.masters:
                    assert not m.server.server.migrating_slots and not m.server.server.importing_slots
                holder = 0 if expect == "rolled_back" else 1
                after = _planes(runner, tag)
                assert after == {(holder, n): v for (_i, n), v in before.items()}, name
                owner = runner.masters[holder].server.server
                c = Connection(owner.host, owner.port, timeout=60.0)
                try:
                    assert c.execute("GET", f"{{{tag}}}s") == b"payload"
                finally:
                    c.close()
                runs.append((tag, _view(runner), after))
            finally:
                runner.shutdown()
    (ref_tag, ref_view, ref_planes), (port_tag, port_view, port_planes) = runs
    assert ref_tag == port_tag and port_view == ref_view and port_planes == ref_planes


def test_journal_files_read_the_same_in_both_packages(tmp_path):
    """A coordinator journal and an import journal (with a torn tail) written
    by one package open in the other with the same entries, phase, epoch
    and batches; a new journal's epoch continues past both."""
    rng = np.random.default_rng(SEED)
    blob = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    for writer, reader in ((RefMigrationJournal, MigrationJournal), (MigrationJournal, RefMigrationJournal)):
        jd = str(tmp_path / writer.__module__.split(".")[0])
        j = writer.create(jd, "127.0.0.1:1", "127.0.0.1:2")
        j.append("PLANNED", source="127.0.0.1:1", target="127.0.0.1:2", slots=[7, 9], epoch=j.epoch,
                 old_view=[[0, 16383, "127.0.0.1", 1, "a"]], new_view=[[0, 16383, "127.0.0.1", 2, "b"]])
        j.append("WINDOW_OPEN")
        j.append("DRAINING", moved=3, sweep=1, batch=3)
        imp_writer = RefImportJournal if writer is RefMigrationJournal else ImportJournal
        imp_reader = ImportJournal if reader is MigrationJournal else RefImportJournal
        ij = imp_writer.open_for(jd, "127.0.0.1:2", j.epoch, source="127.0.0.1:1")
        ij.append_batch(blob)
        with open(j.path, "ab") as f:
            f.write(b'{"phase":"STAB')  # a torn tail
        [got] = reader.in_flight(jd)
        assert got.entries == reader.open(j.path).entries == writer.open(j.path).entries
        assert (got.phase, got.epoch, got.latest("moved")) == ("DRAINING", j.epoch, 3)
        [gij] = imp_reader.in_flight(jd)
        assert gij.batch_blobs() == [blob] and (gij.target, gij.source) == ("127.0.0.1:2", "127.0.0.1:1")
        got.append("STABLE", moved=3)
        assert writer.open(j.path).phase == "STABLE" and not writer.in_flight(jd)
        assert reader.create(jd, "x", "y").epoch == j.epoch + 1


def _rebalance_engine(package: str):
    if package == "ref":
        from redisson_tpu.core.engine import Engine as RefEngine

        engine = RefEngine()
    else:
        from redisson_tpu_torch.core.engine import Engine

        engine = Engine(device="cpu")
    engine.enable_placement()
    return engine


def _rebalance_state(engine, package: str, names) -> dict:
    """{name: (owner position of its slot, the position its record is on,
    its registers' bytes)}."""
    p = engine.placement
    out = {}
    for name in names:
        rec = engine.store.get(name)
        if package == "ref":
            from redisson_tpu.core import ioplane as ref_ioplane

            on = p.devices.index(ref_ioplane.device_of(rec.arrays["regs"]))
            regs = np.asarray(rec.arrays["regs"])
        else:
            on = rec.position
            regs = rec.arrays["regs"].cpu().numpy()
        out[name] = (p.device_id_for_slot(calc_slot(name.encode())), on, regs.tobytes())
    return out


@pytest.mark.parametrize("phase", ["PLANNED", "DRAINING:1", "STABLE"])
def test_device_rebalance_killed_and_resumed_matches_the_reference(tmp_path, phase):
    """The reference's engine on JAX's 8 CPU devices and the port's on the
    CPU's 8 positions hold the same HLL records; each package's
    rebalance_devices of the same plan (a batch of 2 slots, so DRAINING:1
    falls mid-plan), killed at the phase and resumed by its own
    resume_device_rebalances: the same actions, every record owned and held
    by the same position, registers equal bit for bit and unchanged; a
    stale coordinator is refused."""
    from redisson_tpu.client.objects.hyperloglog import HyperLogLog as RefHyperLogLog
    from redisson_tpu.server.placement import PlacementStaleEpoch as RefStale
    from redisson_tpu_torch.client.objects.hyperloglog import HyperLogLog
    from redisson_tpu_torch.server.placement import PlacementStaleEpoch

    assert mesh.cpu_positions() == 8
    rng = np.random.default_rng(SEED)
    names = [f"reb{i}" for i in range(6)]
    items = {n: [f"{n}:{int(k)}" for k in rng.integers(0, 1 << 40, 50)] for n in names}
    slots = sorted({calc_slot(n.encode()) for n in names})
    out = {}
    for package, mig, hll, stale in (("ref", ref_mig, RefHyperLogLog, RefStale),
                                     ("port", port_mig, HyperLogLog, PlacementStaleEpoch)):
        engine = _rebalance_engine(package)
        try:
            for n in names:
                hll(engine, n).add_all(items[n])
            before = _rebalance_state(engine, package, names)
            p = engine.placement
            targets = {s: (p.device_id_for_slot(s) + 3) % p.n_devices for s in slots}
            jd = str(tmp_path / package)
            with pytest.raises(mig.CoordinatorKilled):
                mig.rebalance_devices(engine, targets, journal_dir=jd, crash_after=phase, batch=2)
            results = mig.resume_device_rebalances(engine, jd)
            actions = [(r["action"], r["moved"], r["stale_slots"]) for r in results]
            epoch = max(j.epoch for j in MigrationJournal.scan(jd))
            with pytest.raises(stale):
                engine.move_slot_records(slots[0], 0, epoch=epoch - 1)
            state = _rebalance_state(engine, package, names)
            out[package] = (actions, state, [p.device_id_for_slot(s) for s in slots])
            for n in names:
                assert state[n][0] == state[n][1] == targets[calc_slot(n.encode())], (package, n)
                assert state[n][2] == before[n][2], (package, n)
        finally:
            engine.shutdown()
    assert out["port"] == out["ref"]
    assert out["port"][0] == ([] if phase == "STABLE" else [("completed", len(names), 0)])
