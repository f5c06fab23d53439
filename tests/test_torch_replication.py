"""The port's replication (redisson_tpu_torch/server/replication.py) against
the reference's (redisson_tpu/server/replication.py) on the CPU: K24's block
patch and K23's packed upload bit for bit, the block diff and its full-ship
rules, the wire payload both ways, a delta refused before any write, the
restricted decode of REPLPUSH, and replication over loopback between the two
packages' servers in both pairings."""
import hashlib
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu.core import ioplane as ref_ioplane
from redisson_tpu.core.checkpoint import _loads as ref_loads
from redisson_tpu.server import replication as ref_repl
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core.engine import Engine
from redisson_tpu_torch.core.store import StateRecord
from redisson_tpu_torch.harness import ClusterRunner, _exec
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.net import safe_pickle
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.server import replication as repl
from redisson_tpu_torch.tools import wire_stream as W


def _rng(seed):
    return np.random.default_rng(seed)


def _plane(rng, dtype, n):
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(n).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


# -- K24: the block patch -------------------------------------------------------


def _delta(rng, base, idx):
    be = repl._block_elems(base.dtype)
    nblocks = -(-base.size // be)
    idx = np.asarray(idx, np.int32)
    return {
        "idx": idx,
        "data": _plane(rng, base.dtype, idx.size * be).reshape(idx.size, be),
        "shape": base.shape, "dtype": str(base.dtype), "nblocks": nblocks,
    }


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
@pytest.mark.parametrize("case", ["one", "many", "partial_last", "repeated", "sixty_pct"])
def test_apply_array_delta_matches_the_reference_bit_for_bit(dtype, case):
    rng = _rng(11)
    n = 256 * 97 + 13  # not a whole number of 256-byte blocks for any dtype
    base = _plane(rng, dtype, n)
    nblocks = -(-n // repl._block_elems(base.dtype))
    idx = {
        "one": lambda: [5],
        "many": lambda: rng.choice(nblocks - 1, 40, replace=False),
        "partial_last": lambda: [0, nblocks - 1],
        # a repeated index keeps its LAST data, as the reference's scatter
        # does on the CPU
        "repeated": lambda: [3, 9, 3, nblocks - 1, nblocks - 1],
        "sixty_pct": lambda: rng.choice(nblocks, int(0.6 * nblocks), replace=False),
    }[case]()
    d = _delta(rng, base, idx)
    repl._validate_array_delta("r", "a", torch.from_numpy(base), d)
    want = np.asarray(ref_repl._apply_array_delta(jnp.asarray(base), d))
    cur = torch.from_numpy(base.copy())
    got = repl._apply_array_delta(cur, d)
    assert got.dtype == cur.dtype and tuple(got.shape) == base.shape
    assert got.numpy().tobytes() == want.tobytes()
    assert torch.equal(cur, torch.from_numpy(base))  # the record's plane is untouched


def test_apply_array_delta_keeps_a_2d_plane_and_bool():
    rng = _rng(12)
    bank = rng.integers(0, 2, (7, 301), dtype=np.uint8)
    d = _delta(rng, bank, [0, 8])
    want = np.asarray(ref_repl._apply_array_delta(jnp.asarray(bank), d))
    assert repl._apply_array_delta(torch.from_numpy(bank), d).numpy().tobytes() == want.tobytes()
    flags = rng.integers(0, 2, 1000).astype(bool)
    d = _delta(rng, flags.view(np.uint8), [1, 3])
    d["data"] = d["data"].astype(bool)
    d["dtype"] = "bool"
    got = repl._apply_array_delta(torch.from_numpy(flags), d)
    want = np.asarray(ref_repl._apply_array_delta(jnp.asarray(flags), d))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def test_out_of_range_and_mismatched_deltas_are_refused_like_the_reference():
    rng = _rng(13)
    cur = _plane(rng, np.int32, 1000)
    nb = -(-cur.size // repl._block_elems(cur.dtype))
    bad = [
        dict(_delta(rng, cur, [0]), idx=np.asarray([nb], np.int32)),
        dict(_delta(rng, cur, [0]), idx=np.asarray([-1], np.int32)),
        dict(_delta(rng, cur, [0]), shape=(999,)),
        dict(_delta(rng, cur, [0]), dtype="uint32"),
        dict(_delta(rng, cur, [0]), nblocks=nb + 1),
    ]
    for d in bad:
        with pytest.raises(ValueError) as ref_err:
            ref_repl._validate_array_delta("r", "a", jnp.asarray(cur), d)
        with pytest.raises(ValueError) as port_err:
            repl._validate_array_delta("r", "a", torch.from_numpy(cur), d)
        assert str(port_err.value).split(":")[0] == str(ref_err.value).split(":")[0]


def test_a_delta_failing_on_its_second_array_writes_nothing():
    """Every array of an item is validated before any patch: a bad second
    array leaves the first one, and the record, as they were."""
    rng = _rng(14)
    eng = Engine(device="cpu")
    try:
        a = _plane(rng, np.uint8, 5000)
        b = _plane(rng, np.int32, 3000)
        rec = StateRecord(kind="blob", arrays={"a": torch.from_numpy(a.copy()),
                                               "b": torch.from_numpy(b.copy())}, host={"h": 1})
        rec.version = 4
        eng.store.put("rec", rec)
        nb = -(-b.size // repl._block_elems(b.dtype))
        good = _delta(rng, a, [0, 3])
        bad = dict(_delta(rng, b, [1]), idx=np.asarray([nb + 2], np.int32))
        item = {"name": "rec", "kind": "blob", "meta": {}, "version": 5, "nonce": rec.nonce,
                "expire_at": None, "host_pickled": safe_pickle.dumps({"h": 2}, protocol=4),
                "delta_base": 4, "arrays_delta": {"a": good, "b": bad}}
        blob = repl._wire_payload([item], None)
        with pytest.raises(ValueError, match="block index out of range"):
            repl.apply_records(eng, blob)
        kept = eng.store.get_unguarded("rec")
        assert kept is rec and kept.version == 4 and kept.host == {"h": 1}
        assert torch.equal(kept.arrays["a"], torch.from_numpy(a))
        assert torch.equal(kept.arrays["b"], torch.from_numpy(b))
        # the same item with a good second array applies both
        item["arrays_delta"]["b"] = _delta(rng, b, [1])
        assert repl.apply_records(eng, repl._wire_payload([item], None)) == 1
        got = eng.store.get_unguarded("rec")
        want_a = np.asarray(ref_repl._apply_array_delta(jnp.asarray(a), good))
        assert got.version == 5 and np.array_equal(got.arrays["a"].numpy(), want_a)
    finally:
        eng.shutdown()


# -- K23: the packed upload ------------------------------------------------------


def _odd_arrays(rng):
    return {
        "a_bool": rng.integers(0, 2, 13).astype(bool),
        "b_u8": rng.integers(0, 256, (3, 7), dtype=np.uint8),
        "c_i32": rng.integers(-2**31, 2**31, 5, dtype=np.int32),
        "d_f32": rng.standard_normal((3, 3)).astype(np.float32),
        "e_i64": rng.integers(-2**62, 2**62, 7, dtype=np.int64),
        "f_empty": np.zeros((0, 4), np.float32),
        "g_u8": rng.integers(0, 256, 9, dtype=np.uint8),
    }


def test_scatter_host_arrays_matches_the_reference_bit_for_bit():
    arrays = _odd_arrays(_rng(21))
    # the reference packs back to back: most of its offsets are not
    # multiples of 16, the port's are
    layout, total = ioplane.scatter_layout(arrays)
    assert all(off % ioplane.SCATTER_ALIGN == 0 for _, off, *_ in layout)
    # JAX without x64 truncates int64, so the reference takes the rest and
    # the int64 array is held to its own per-array copy
    wide = {k: v for k, v in arrays.items() if v.dtype == np.int64}
    want = ref_ioplane.scatter_host_arrays(
        {k: v for k, v in arrays.items() if k not in wide}, jax.devices("cpu")[0])
    want.update({k: torch.from_numpy(v).numpy() for k, v in wide.items()})
    got = ioplane.scatter_host_arrays(arrays, "cpu")
    assert set(got) == set(want) == set(arrays) and wide
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.numpy().dtype == w.dtype and v.numpy().shape == w.shape, k
        assert v.numpy().tobytes() == w.tobytes(), k
    # through a staging pool: one slot, committed after the copy
    pool = ioplane.StagingPool(depth=1)
    got = ioplane.scatter_host_arrays(arrays, "cpu", pool)
    assert pool.slot_count() == 1 and not pool._slots[0].busy
    assert all(np.array_equal(got[k].numpy(), np.asarray(want[k])) for k in arrays)


def test_hydration_falls_back_only_for_host_packing_errors():
    eng = Engine(device="cpu")
    try:
        ok = {"x": np.arange(10, dtype=np.int32)}
        got = repl._hydrate_full_arrays(eng, "r", ok)
        assert eng.hydration_stats["records_packed"] == 1 and torch.equal(got["x"], torch.arange(10, dtype=torch.int32))
        # a byte order torch has no dtype for: placed one array at a time
        big = {"x": np.arange(10, dtype=">i4"), "y": np.ones(3, np.uint8)}
        got = repl._hydrate_full_arrays(eng, "r", big)
        assert eng.hydration_stats["records_fallback"] == 1
        assert got["x"].tolist() == list(range(10)) and got["y"].tolist() == [1, 1, 1]
    finally:
        eng.shutdown()


# -- the block diff and the wire payload ------------------------------------------


def _norm(d):
    if d is None:
        return None
    return {k: None if v is None else {kk: (vv.tobytes() if isinstance(vv, np.ndarray) else vv)
                                       for kk, vv in v.items()} for k, v in d.items()}


def test_encode_record_delta_matches_the_reference():
    rng = _rng(31)
    a = _plane(rng, np.uint32, 65536)
    b = rng.standard_normal(5000).astype(np.float32)
    few = a.copy()
    few[[3, 900, 65535]] ^= 1
    cases = [
        ({"x": few, "y": b}, {"x": a, "y": b}),                    # a delta, one array unchanged
        ({"x": a + 1, "y": b}, {"x": a, "y": b}),                  # > 60% of the blocks: full
        ({"x": a[:100], "y": b}, {"x": a, "y": b}),                # a shape change: full
        ({"x": a.view(np.int32), "y": b}, {"x": a, "y": b}),       # a dtype change: full
        ({"z": a, "y": b}, {"x": a, "y": b}),                      # the array set changed: full
        ({"x": a, "y": b}, {"x": a.copy(), "y": b.copy()}),        # nothing changed
    ]
    # exactly at and just past the 60% rule
    nb = 65536 // 64
    at = a.copy()
    at[np.arange(int(0.6 * nb)) * 64] ^= 1
    past = a.copy()
    past[np.arange(int(0.6 * nb) + 1) * 64] ^= 1
    cases += [({"x": at}, {"x": a}), ({"x": past}, {"x": a})]
    for cur, base in cases:
        want = ref_repl._encode_record_delta({"arrays": cur}, {"arrays": base})
        got = repl._encode_record_delta({"arrays": cur}, {"arrays": base})
        assert _norm(got) == _norm(want)
    assert repl._encode_record_delta({"arrays": {"x": at}}, {"arrays": {"x": a}}) is not None
    assert repl._encode_record_delta({"arrays": {"x": past}}, {"arrays": {"x": a}}) is None


def test_wire_payload_decodes_in_the_other_package():
    rng = _rng(41)
    records = [{"name": "r1", "kind": "bloom", "meta": {"m": 800, "k": 3}, "version": 7,
                "nonce": 99, "expire_at": None, "host_pickled": pickle.dumps({"n": 1}, protocol=4),
                "arrays": {"bits": np.zeros(100_000, np.uint8)}},
               {"name": "r2", "kind": "blob", "meta": {}, "version": 1, "nonce": 5,
                "expire_at": 1.5, "host_pickled": pickle.dumps(None, protocol=4),
                "arrays": {"v": rng.standard_normal(64).astype(np.float32)}}]
    for live, offset in ((["r1", "r2"], 12), (None, None)):
        for blob, decode in (
            (ref_repl._wire_payload(records, live, offset=offset, ts=3.0),
             lambda b: safe_pickle.safe_loads(repl._unwire_payload(b))),
            (repl._wire_payload(records, live, offset=offset, ts=3.0),
             lambda b: ref_loads(ref_repl._unwire_payload(b))),
        ):
            assert blob[:4] == b"RLZ4"  # the zero plane compresses
            payload = decode(blob)
            assert payload.get("live") == live and payload.get("repl_offset") == offset
            for got, want in zip(payload["records"], records):
                assert {k: v for k, v in got.items() if k != "arrays"} == \
                       {k: v for k, v in want.items() if k != "arrays"}
                for k, v in want["arrays"].items():
                    assert got["arrays"][k].dtype == v.dtype and np.array_equal(got["arrays"][k], v)
    # an incompressible payload ships raw, and both packages read it
    noise = [dict(records[1], arrays={"v": rng.integers(0, 256, 4096, dtype=np.uint8)})]
    raw = repl._wire_payload(noise, None)
    assert raw[:1] == b"\x80"
    assert np.array_equal(ref_loads(ref_repl._unwire_payload(raw))["records"][0]["arrays"]["v"],
                          noise[0]["arrays"]["v"])


# -- the restricted decode of REPLPUSH ----------------------------------------------


class _Exec:
    """Pickles as a call of ``numpy.testing._private.utils.runstring``,
    which execs its string: loading it writes `marker`."""

    def __init__(self, marker):
        self.marker = str(marker)

    def __reduce__(self):
        from numpy.testing._private.utils import runstring

        return runstring, (f"open({self.marker!r}, 'w').write('ran')", {})


@pytest.mark.parametrize("where", ["payload", "host_state"])
def test_replpush_of_a_numpy_gadget_replies_an_error_and_runs_nothing(tmp_path, where):
    marker = tmp_path / "ran"
    gadget = pickle.dumps(_Exec(marker), protocol=4)
    if where == "payload":
        blob = gadget
    else:
        blob = pickle.dumps({"format": 1, "records": [
            {"name": "rp:gadget", "kind": "bucket", "meta": {}, "version": 1, "nonce": 1,
             "expire_at": None, "host_pickled": gadget, "arrays": {}}]}, protocol=4)
    with ServerThread(port=0, device="cpu") as st:
        st.server.role = "replica"  # REPLPUSH applies only on a replica
        with socket.create_connection((st.server.host, st.server.port), timeout=60) as s:
            s.sendall(resp.encode_commands([("REPLPUSH", blob), ("EXISTS", "rp:gadget")]))
            parser, got = resp.RespParser(use_native=False), []
            while len(got) < 2:
                data = s.recv(1 << 16)
                assert data, "server closed the connection early"
                got += parser.feed(data)
    assert isinstance(got[0], resp.RespError) and "forbidden" in str(got[0]), got[0]
    assert got[1] == 0
    assert not marker.exists()


# -- replication over loopback, the two packages paired ------------------------------


def _writes(seed):
    """One command stream over bloom filters, a bloom bank, HLLs, an HLL
    bank, bit sets, a map (hash) and a vector bank (an FT index's)."""
    rng = _rng(seed)
    out = [c for c in W.mixed_stream(seed=seed) if c[0] not in ("TOTALLY-BOGUS-CMD",)]
    dim = 8
    out.append(("FT.CREATE", "idx:v", "ON", "HASH", "PREFIX", "1", "vd:", "SCHEMA",
                "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(dim),
                "DISTANCE_METRIC", "L2"))
    vecs = rng.standard_normal((48, dim)).astype(np.float32)
    out += [("HSET", f"vd:{i}", "emb", W.f32_blob(vecs[i])) for i in range(48)]
    out.append(("FT.SEARCH", "idx:v", "*=>[KNN 3 @emb $v]", "PARAMS", "2", "v",
                W.f32_blob(vecs[0]), "NOCONTENT"))
    return out


def _reads(seed):
    rng = _rng(seed + 1)
    probe = rng.integers(-2**62, 2**62, 64)
    reads = [("BF.MEXISTS64", f"bf:{i}", W._i8(probe)) for i in range(6)]
    reads += [("BF.EXISTS", "bf:0", "alpha"), ("BF.INFO", "bf:0"),
              ("BFA.MEXISTS64", "bfa", W._i4(rng.integers(0, 16, 64)), W._i8(probe)),
              ("PFCOUNT", "hll:1"), ("PFCOUNT", "hll:1", "hll:2"), ("PFCOUNT", "hll:3"),
              ("PFCOUNT", "hll:4"), ("BITCOUNT", "bits:or"), ("BITCOUNT", "bits:xor"),
              ("GETBITSB", "bits:0", W._i4(rng.integers(0, 10_000, 128))),
              ("GETBIT", "bits:s", "70"), ("BITFIELD_RO", "bits:f", "GET", "u8", "0"),
              ("HGETALL", "h1"), ("HKEYS", "h1"), ("GET", "k2"), ("MGET", "m1", "m2", "x"),
              ("EXISTS", "k1", "ctr2", "bfa", "hlla", "h1"), ("TYPE", "hlla"), ("TYPE", "bfa"),
              ("DBSIZE",)]
    return reads


def _digest(st, waves):
    return [hashlib.sha256(raw).hexdigest() for raw, _ in W.replies(st.server.host, st.server.port, waves)]


def _vector_records(engine):
    return {n: engine.store.get_unguarded(n) for n in engine.store.keys()
            if engine.store.get_unguarded(n).kind == "vector_bank"}


@pytest.mark.parametrize("pairing", ["ref_master_port_replica", "port_master_ref_replica"])
def test_cross_package_replication_gives_the_masters_reply_digest(pairing):
    make_ref = lambda: RefServerThread(port=0)  # noqa: E731
    make_port = lambda: ServerThread(port=0, device="cpu")  # noqa: E731
    mk_master, mk_replica = (make_ref, make_port) if pairing.startswith("ref") else (make_port, make_ref)
    with mk_master() as master, mk_replica() as replica:
        with replica.client() as c:
            _exec(c, "REPLICAOF", master.server.host, master.server.port, timeout=120.0)
        W.replies(master.server.host, master.server.port, [_writes(7)])
        with master.client() as c:
            _exec(c, "REPLFLUSH", timeout=120.0)  # the shipper may have swept first
            assert _exec(c, "WAIT", 1, 100) == 1
        reads = _reads(7)
        # HELLO's reply names the connection: its wave stays out of the digest
        waves = [reads, [("HELLO", "3")], reads]
        got, want = _digest(replica, waves), _digest(master, waves)
        assert (got[0], got[2]) == (want[0], want[2])
        # the keyspace and the vector bank arrived whole
        assert sorted(replica.server.engine.store.keys()) == sorted(master.server.engine.store.keys())
        mv, rv = _vector_records(master.server.engine), _vector_records(replica.server.engine)
        assert mv and set(mv) == set(rv)
        for n, rec in mv.items():
            for k, v in rec.arrays.items():
                assert np.asarray(rv[n].arrays[k]).tobytes() == np.asarray(v).tobytes(), (n, k)
        with replica.client() as c:
            role = _exec(c, "ROLE")
            assert role[0] == b"slave" and role[2] == master.server.port
            # the client is the replica package's: its error is a reply
            assert "READONLY" in str(c.execute("SET", "k1", "x"))


# -- the port's own pair: deltas, divergence, the replica read stream ------------------


def _pair():
    runner = ClusterRunner(masters=1, replicas_per_master=1, device="cpu").run()
    return runner, runner.masters[0].server, runner.replicas[0].server


def test_replica_plane_divergence_is_refused_and_full_ships():
    """A replica whose plane was re-padded (a shape change without a
    version bump) refuses the block delta; the master then full-ships and
    the replica holds exactly the master's plane."""
    runner, master, replica = _pair()
    try:
        with master.client() as c:
            _exec(c, "BF.RESERVE", "bf:div", "0.01", "100000")
            _exec(c, "BF.MADD64", "bf:div", W._i8(np.arange(200)))
            src = master.server.replication_source()
            src.flush()
            _exec(c, "BF.MADD64", "bf:div", W._i8(np.arange(200, 250)))
            src.flush()
            assert src.stats["records_delta"] >= 1
            rec = replica.server.engine.store.get_unguarded("bf:div")
            akey = next(iter(rec.arrays))
            rec.arrays[akey] = torch.nn.functional.pad(rec.arrays[akey], (0, 256))
            _exec(c, "BF.MADD64", "bf:div", W._i8(np.arange(250, 300)))
            mver = master.server.engine.store.get_unguarded("bf:div").version
            n_full = src.stats["records_full"]
            src.flush()  # the delta is refused
            assert replica.server.engine.store.get_unguarded("bf:div").version < mver
            src.flush()  # the retry full-ships
            assert src.stats["records_full"] > n_full
        m = master.server.engine.store.get_unguarded("bf:div")
        r = replica.server.engine.store.get_unguarded("bf:div")
        assert r.version == m.version and torch.equal(r.arrays[akey], m.arrays[akey])
    finally:
        runner.shutdown()


_SEED = [
    ("SET", "s:k", "payload"), ("RPUSH", "l:k", *[f"e{i}" for i in range(32)]),
    ("HSET", "h:k", *[x for i in range(16) for x in (f"f{i}", f"v{i}")]),
    ("SADD", "set:k", *[f"m{i}" for i in range(24)]),
    ("ZADD", "z:k", *[x for i in range(24) for x in (str(i * 0.5), f"z{i}")]),
    ("BF.RESERVE", "bf:k", "0.01", "10000"),
    ("BF.MADD64", "bf:k", (np.arange(64, dtype=np.int64) * 2654435761).tobytes()),
    ("PFADD", "hll:k", *[f"p{i}" for i in range(48)]),
    ("XADD", "x:k", "1-1", "a", "1"), ("JSON.SET", "j:k", "$", '{"a": 1, "b": [2, 3]}'),
]
_READS = [
    ("GET", "s:k"), ("MGET", "s:k", "missing"), ("LRANGE", "l:k", "0", "-1"),
    ("HGETALL", "h:k"), ("SMEMBERS", "set:k"), ("ZRANGE", "z:k", "0", "-1", "WITHSCORES"),
    ("BF.MEXISTS64", "bf:k", (np.arange(16, dtype=np.int64) * 2654435761).tobytes()),
    ("BF.INFO", "bf:k"), ("PFCOUNT", "hll:k"), ("XRANGE", "x:k", "-", "+"),
    ("JSON.GET", "j:k", "$"), ("TYPE", "z:k"),
]


def test_readonly_replica_replies_the_masters_bytes():
    """The read stream of the reference's read-scaling A/B, against the
    port's master and its READONLY replica in one cluster."""
    runner, master, replica = _pair()
    try:
        with master.client() as c:
            for cmd in _SEED:
                _exec(c, *cmd)
            assert _exec(c, "REPLFLUSH") >= 1
        before = replica.server.stats["replica_reads"]
        for proto in ([], [("HELLO", "3")]):
            pre = proto + [("READONLY",)]
            got = [W.replies(st.server.host, st.server.port, [pre, _READS])[1][0]
                   for st in (master, replica)]
            assert got[0] == got[1]
        assert replica.server.stats["replica_reads"] - before == 2 * len(_READS)
    finally:
        runner.shutdown()
