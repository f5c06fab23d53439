"""Checkpoints and DUMP blobs across the two packages, on the CPU.

The same records are made in a ``redisson_tpu`` engine (JAX on the CPU) and
in a port engine from one seeded numpy stream: one record of every kind the
reference's ``tests/test_checkpoint.py`` and ``tests/test_objects.py`` save
(bloom, bloom array, HLL, HLL array, bit set, bucket, map, sorted set,
list, stream, a sharded bloom bank and a bucket with a TTL).  A checkpoint
file written by either package's ``core/checkpoint.save`` must load in the
other's ``load``, and a ``dump_record`` blob of either must restore in the
other's ``restore_record``: the loaded record's kind, meta, version, nonce,
expiry, host state and arrays (dtype, shape and bytes) equal the saved
record's, and the loaded objects answer contains and PFCOUNT exactly as the
saved ones do.  Tolerance: none; every comparison is exact, except a float32
HLL estimate compared ACROSS the packages, which keeps PERF.md section 2's
contract (1e-6 relative: the two estimators sum the register histogram in
another order); within one package it is exact too.
"""
import os
import pickle
import time

import numpy as np
import pytest

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.config import Config as RefConfig
from redisson_tpu.core import checkpoint as ref_ckpt
from redisson_tpu_torch.config import Config as PortConfig
from redisson_tpu_torch.core import checkpoint as port_ckpt
from redisson_tpu_torch.core import residency as port_residency
from redisson_tpu_torch.parallel import mesh as port_mesh

port_mesh.set_cpu_positions(8)

SEED = 20
TENANTS = 4


def _config(cls):
    cfg = cls()
    cfg.mesh.dp, cfg.mesh.shard, cfg.mesh.n_devices = 1, 4, 4
    return cfg


def _ref():
    return redisson_tpu.create(_config(RefConfig))


def _port():
    return redisson_tpu_torch.create(_config(PortConfig), "cpu")


def _keys(n, salt=0):
    return np.random.default_rng(SEED + salt).integers(0, 1 << 62, n, dtype=np.int64)


def _tenants(n):
    return (np.arange(n) % TENANTS).astype(np.int32)


# -- one populate / probe pair a kind: the same calls on either client -------


def _bloom(c):
    bf = c.get_bloom_filter("ck:bloom")
    bf.try_init(10_000, 0.01)
    bf.add_all(_keys(700))


def _bloom_q(c):
    return c.get_bloom_filter("ck:bloom").contains_each(np.concatenate([_keys(700), _keys(300, 1)]))


def _bloom_array(c):
    ba = c.get_bloom_filter_array("ck:bfa")
    ba.try_init(TENANTS, 5_000, 0.01)
    ba.add_each(_tenants(600), _keys(600, 2))


def _bloom_array_q(c):
    probe = np.concatenate([_keys(600, 2), _keys(200, 3)])
    return c.get_bloom_filter_array("ck:bfa").contains(_tenants(800), probe)


def _hll(c):
    c.get_hyper_log_log("ck:hll").add_all(_keys(5_000, 4))


def _hll_q(c):
    return c.get_hyper_log_log("ck:hll").count()


def _hll_array(c):
    ha = c.get_hyper_log_log_array("ck:hlla")
    ha.try_init(TENANTS, 10)
    ha.add(_tenants(4_000), _keys(4_000, 5))


def _hll_array_q(c):
    return c.get_hyper_log_log_array("ck:hlla").estimate_all()


def _bitset(c):
    c.get_bit_set("ck:bits").set_each(np.unique(_keys(300, 6) % 50_000))


def _bitset_q(c):
    bs = c.get_bit_set("ck:bits")
    return bs.get_each(np.arange(50_000)), bs.cardinality()


def _bucket(c):
    c.get_bucket("ck:bucket").set({"v": [1, 2.5, "x", b"\x00\xff"]})


def _bucket_q(c):
    return c.get_bucket("ck:bucket").get()


def _map(c):
    m = c.get_map("ck:map")
    for i, k in enumerate(_keys(50, 7)):
        m.put(f"k{k}", i)


def _map_q(c):
    return dict(c.get_map("ck:map").read_all_map())


def _zset(c):
    z = c.get_scored_sorted_set("ck:zset")
    for i, k in enumerate(_keys(40, 8)):
        z.add(float(k % 1000) / 7.0, f"m{i}")


def _zset_q(c):
    return c.get_scored_sorted_set("ck:zset").entry_range(0, -1)


def _list(c):
    lst = c.get_list("ck:list")
    for k in _keys(30, 9):
        lst.add(int(k % 997))


def _list_q(c):
    return c.get_list("ck:list").read_all()


def _stream(c):
    s = c.get_stream("ck:stream")
    for i, k in enumerate(_keys(12, 10)):
        s.add({"i": str(i), "k": str(int(k))}, id=f"{i + 1}-0")


def _stream_q(c):
    return c.get_stream("ck:stream").range("-", "+")


def _sharded_bloom(c):
    sb = c.get_sharded_bloom_filter_array("ck:sbloom")
    sb.try_init(TENANTS, expected_insertions=5_000, false_probability=0.01)
    sb.add_each(_tenants(512), _keys(512, 11))


def _sharded_bloom_q(c):
    probe = np.concatenate([_keys(512, 11), _keys(256, 12)])
    return c.get_sharded_bloom_filter_array("ck:sbloom").contains_each(_tenants(768), probe)


def _ttl(c):
    b = c.get_bucket("ck:ttl")
    b.set("expiring")
    b.expire(3600.0)


def _ttl_q(c):
    return c.get_bucket("ck:ttl").get()


KINDS = {
    "bloom": ("ck:bloom", _bloom, _bloom_q),
    "bloom_array": ("ck:bfa", _bloom_array, _bloom_array_q),
    "hll": ("ck:hll", _hll, _hll_q),
    "hll_array": ("ck:hlla", _hll_array, _hll_array_q),
    "bitset": ("ck:bits", _bitset, _bitset_q),
    "bucket": ("ck:bucket", _bucket, _bucket_q),
    "map": ("ck:map", _map, _map_q),
    "sorted_set": ("ck:zset", _zset, _zset_q),
    "list": ("ck:list", _list, _list_q),
    "stream": ("ck:stream", _stream, _stream_q),
    "sharded_bloom": ("ck:sbloom", _sharded_bloom, _sharded_bloom_q),
    "ttl": ("ck:ttl", _ttl, _ttl_q),
}


def _host_arrays(rec):
    """A record's arrays as host numpy, whichever package holds it."""
    if rec.arrays and type(next(iter(rec.arrays.values()))).__module__.startswith(("torch", "redisson_tpu_torch")):
        return port_residency.record_host_arrays(rec)
    return {k: np.asarray(v) for k, v in rec.arrays.items()}


def _same_value(a, b, cross=False):
    """Equal answers; `cross` (the two packages' answers) holds a float32
    estimate to the 1e-6 relative contract."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if cross and a.dtype == np.float32 and b.dtype == np.float32:
            return a.shape == b.shape and bool(np.allclose(a, b, rtol=1e-6, atol=0))
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_same_value(x, y, cross) for x, y in zip(a, b))
    return a == b


def _assert_same_record(got, want, nonce=True, version=True, expiry=True):
    """`expiry=False`: two records made by separate calls, whose expiries
    are their own clocks' reading plus the same TTL."""
    assert got.kind == want.kind
    assert got.meta == want.meta
    if version:
        assert got.version == want.version
    if nonce:
        assert got.nonce == want.nonce
    if expiry:
        assert got.expire_at == want.expire_at
    else:
        assert (got.expire_at is None) == (want.expire_at is None)
        assert got.expire_at is None or abs(got.expire_at - want.expire_at) < 60
    assert pickle.dumps(got.host, protocol=4) == pickle.dumps(want.host, protocol=4) \
        or got.host == want.host
    ga, wa = _host_arrays(got), _host_arrays(want)
    assert sorted(ga) == sorted(wa)
    for k in wa:
        assert ga[k].dtype == wa[k].dtype, k
        assert ga[k].shape == wa[k].shape, k
        assert ga[k].tobytes() == wa[k].tobytes(), k


@pytest.fixture(scope="module")
def pair():
    """A reference and a port client, each holding every kind, made from the
    same inputs."""
    ref, port = _ref(), _port()
    for _name, make, _q in KINDS.values():
        make(ref)
        make(port)
    yield ref, port
    ref.shutdown()
    port.shutdown()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_both_packages_hold_the_same_state(pair, kind):
    """The starting point: the same calls made the same arrays and host
    state in both packages, and the same answers."""
    ref, port = pair
    name, _make, query = KINDS[kind]
    _assert_same_record(port._engine.store.get(name), ref._engine.store.get(name),
                        nonce=False, version=False, expiry=False)
    assert _same_value(query(port), query(ref), cross=True)


def _saved_by(src, path, save):
    assert save(src._engine, path) == len(KINDS)


@pytest.fixture(scope="module")
def files(pair, tmp_path_factory):
    ref, port = pair
    d = tmp_path_factory.mktemp("ckpt")
    paths = {"ref": str(d / "ref.ckpt"), "port": str(d / "port.ckpt")}
    _saved_by(ref, paths["ref"], ref_ckpt.save)
    _saved_by(port, paths["port"], port_ckpt.save)
    return paths


@pytest.fixture(scope="module")
def loaded(files):
    """A fresh port client loaded from the reference's file, and a fresh
    reference client loaded from the port's."""
    port_from_ref, ref_from_port = _port(), _ref()
    assert port_ckpt.load(port_from_ref._engine, files["ref"]) == len(KINDS)
    assert ref_ckpt.load(ref_from_port._engine, files["port"]) == len(KINDS)
    yield port_from_ref, ref_from_port
    port_from_ref.shutdown()
    ref_from_port.shutdown()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_reference_checkpoint_loads_in_the_port(pair, loaded, kind):
    ref, _port_c = pair
    port_from_ref = loaded[0]
    name, _make, query = KINDS[kind]
    _assert_same_record(port_from_ref._engine.store.get(name), ref._engine.store.get(name))
    assert _same_value(query(port_from_ref), query(_port_c))
    assert _same_value(query(port_from_ref), query(ref), cross=True)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_port_checkpoint_loads_in_the_reference(pair, loaded, kind):
    _ref_c, port = pair
    ref_from_port = loaded[1]
    name, _make, query = KINDS[kind]
    _assert_same_record(ref_from_port._engine.store.get(name), port._engine.store.get(name))
    assert _same_value(query(ref_from_port), query(_ref_c))
    assert _same_value(query(ref_from_port), query(port), cross=True)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dump_blobs_restore_in_the_other_package(pair, kind):
    """DUMP of either package RESTOREs in the other, under a new name; the
    restored record carries the blob's kind, meta, host state, arrays and
    expiry (a fresh version and nonce, as RESTORE makes a new record)."""
    ref, port = pair
    name, _make, query = KINDS[kind]
    for src, dst, restore in ((ref, port, port_ckpt.restore_record),
                              (port, ref, ref_ckpt.restore_record)):
        blob = (ref_ckpt if src is ref else port_ckpt).dump_record(src._engine, name)
        restore(dst._engine, name + ":restored", blob)
        got = dst._engine.store.get(name + ":restored")
        _assert_same_record(got, src._engine.store.get(name), nonce=False, version=False)
        with pytest.raises(ValueError, match="BUSYKEY"):
            restore(dst._engine, name + ":restored", blob)
        # the restored record answers as the source: put it under the name
        # the probe reads, in a fresh client of the destination's package
        fresh = _port() if dst is port else _ref()
        try:
            restore(fresh._engine, name, blob)
            assert _same_value(query(fresh), query(dst))
            assert _same_value(query(fresh), query(src), cross=True)
        finally:
            fresh.shutdown()
        dst._engine.store.delete(name + ":restored")


def test_the_file_format_is_the_reference_s(files):
    """Magic, CRC trailer, format, hash version and the record field set."""
    for path in files.values():
        data = open(path, "rb").read()
        assert data.startswith(port_ckpt.MAGIC) and port_ckpt.MAGIC == ref_ckpt.MAGIC
        assert data[-12:-4] == port_ckpt.TRAILER_MAGIC == ref_ckpt.TRAILER_MAGIC
    ref_payload = ref_ckpt.read_verified(files["ref"])
    port_payload = port_ckpt.read_verified(files["port"])
    assert port_payload["format"] == ref_payload["format"] == 1
    assert port_payload["hash_version"] == ref_payload["hash_version"]
    assert {r["name"] for r in port_payload["records"]} == {r["name"] for r in ref_payload["records"]}
    for r in port_payload["records"]:
        assert set(r) == {"name", "kind", "meta", "version", "nonce", "expire_at",
                          "host_pickled", "arrays"}
        # no class of the port's package is named in the file
        assert b"redisson_tpu_torch" not in r["host_pickled"]
    assert b"redisson_tpu_torch" not in open(files["port"], "rb").read()


def test_hash_version_is_checked_on_load_and_restore(pair, files, monkeypatch):
    from redisson_tpu_torch.utils import hashing as H

    _ref_c, port = pair
    blob = port_ckpt.dump_record(port._engine, "ck:bloom")
    monkeypatch.setattr(H, "HASH_VERSION", H.HASH_VERSION + 1)
    fresh = _port()
    try:
        with pytest.raises(ValueError, match="hash_version"):
            port_ckpt.load(fresh._engine, files["ref"])
        with pytest.raises(ValueError, match="hash_version"):
            port_ckpt.restore_record(fresh._engine, "x", blob)
    finally:
        fresh.shutdown()


def test_a_port_record_holding_torch_state_crosses_as_numpy(pair, tmp_path):
    """A tensor that reached a record's host state is written as the numpy
    array of its values (safe_pickle), which the reference reads."""
    import torch

    from redisson_tpu_torch.core.store import StateRecord

    _ref_c, port = pair
    port._engine.store.put("ck:tensor-host", StateRecord(
        kind="bucket", host={"t": torch.arange(5, dtype=torch.int32)}))
    try:
        blob = port_ckpt.dump_record(port._engine, "ck:tensor-host")
        ref = _ref()
        try:
            ref_ckpt.restore_record(ref._engine, "ck:tensor-host", blob)
            host = ref._engine.store.get("ck:tensor-host").host
            assert isinstance(host["t"], np.ndarray) and host["t"].tolist() == [0, 1, 2, 3, 4]
        finally:
            ref.shutdown()
    finally:
        port._engine.store.delete("ck:tensor-host")


def test_clone_copies_on_the_device_and_lives_on_its_own(pair):
    """COPY: the clone's tensors are new tensors (a write to one side never
    reaches the other), its sharded plane new parts."""
    _ref_c, port = pair
    for name in ("ck:bloom", "ck:sbloom"):
        assert port_ckpt.clone_record(port._engine, name, name + ":copy")
        assert not port_ckpt.clone_record(port._engine, name, name + ":copy")
        src, dst = port._engine.store.get(name), port._engine.store.get(name + ":copy")
        _assert_same_record(dst, src, nonce=False, version=False)
        for k, v in src.arrays.items():
            parts = getattr(v, "parts", None)
            if parts is None:
                assert dst.arrays[k].data_ptr() != v.data_ptr()
            else:
                assert all(a.data_ptr() != b.data_ptr()
                           for a, b in zip(dst.arrays[k].parts.flat, parts.flat))
        port._engine.store.delete(name + ":copy")


def test_expired_records_are_not_loaded(tmp_path):
    port = _port()
    try:
        port.get_bucket("ck:gone").set("v")
        port.get_bucket("ck:kept").set("v")
        path = str(tmp_path / "exp.ckpt")
        port_ckpt.save(port._engine, path)
        payload = port_ckpt.read_verified(path)
        for r in payload["records"]:
            if r["name"] == "ck:gone":
                r["expire_at"] = time.time() - 1
        _write_checkpoint(path, pickle.dumps(payload, protocol=4))
        fresh = _port()
        try:
            assert port_ckpt.load(fresh._engine, path) == 1
            assert fresh.get_bucket("ck:kept").get() == "v"
            assert not fresh._engine.store.exists("ck:gone")
        finally:
            fresh.shutdown()
    finally:
        port.shutdown()
        assert not os.path.exists(str(tmp_path / "exp.ckpt.1"))


def _write_checkpoint(path, pickled):
    """A file in the checkpoint format around `pickled`: magic, body and a
    CRC trailer that verifies."""
    import struct
    import zlib

    body = ref_ckpt.MAGIC + pickled
    with open(path, "wb") as f:
        f.write(body + ref_ckpt.TRAILER_MAGIC + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


class _Exec:
    """Pickles as a call of ``numpy.testing._private.utils.runstring``,
    which execs its string: loading it writes `marker`."""

    def __init__(self, marker):
        self.marker = str(marker)

    def __reduce__(self):
        from numpy.testing._private.utils import runstring

        return runstring, (f"open({self.marker!r}, 'w').write('ran')", {})


def _dump_blob(host_pickled):
    from redisson_tpu_torch.utils import hashing as H

    return pickle.dumps({"format": 1, "hash_version": H.HASH_VERSION, "kind": "bucket",
                         "meta": {}, "expire_at": None, "host_pickled": host_pickled,
                         "arrays": {}}, protocol=4)


@pytest.mark.parametrize("where", ["blob", "host_state"])
def test_restore_of_a_numpy_gadget_replies_an_error_and_runs_nothing(tmp_path, where):
    """RESTORE decodes client bytes: numpy is reachable only by the globals
    that array pickles name, so a blob naming another numpy callable (at
    the top or inside the record's host state) is refused unrun."""
    import socket

    from redisson_tpu_torch.net import resp
    from redisson_tpu_torch.server import ServerThread

    marker = tmp_path / "ran"
    gadget = pickle.dumps(_Exec(marker), protocol=4)
    blob = gadget if where == "blob" else _dump_blob(gadget)
    with ServerThread(port=0, device="cpu") as st:
        with socket.create_connection((st.server.host, st.server.port), timeout=60) as s:
            s.sendall(resp.encode_commands([("RESTORE", "ck:gadget", "0", blob),
                                            ("EXISTS", "ck:gadget")]))
            parser, got = resp.RespParser(use_native=False), []
            while len(got) < 2:
                data = s.recv(1 << 16)
                assert data, "server closed the connection early"
                got += parser.feed(data)
    assert isinstance(got[0], resp.RespError), got[0]
    assert got[1] == 0
    assert not marker.exists()


@pytest.mark.parametrize("where", ["payload", "host_state"])
def test_load_of_a_numpy_gadget_file_raises_and_runs_nothing(tmp_path, where):
    marker = tmp_path / "ran"
    gadget = pickle.dumps(_Exec(marker), protocol=4)
    path = str(tmp_path / "gadget.ckpt")
    if where == "payload":
        _write_checkpoint(path, gadget)
    else:
        from redisson_tpu_torch.utils import hashing as H

        _write_checkpoint(path, pickle.dumps({
            "format": 1, "saved_at": time.time(), "hash_version": H.HASH_VERSION,
            "records": [{"name": "ck:gadget", "kind": "bucket", "meta": {}, "version": 0,
                         "nonce": 1, "expire_at": None, "host_pickled": gadget,
                         "arrays": {}}]}, protocol=4))
    port = _port()
    try:
        with pytest.raises(port_ckpt.CheckpointCorruptError if where == "payload"
                           else pickle.UnpicklingError, match="forbidden"):
            port_ckpt.load(port._engine, path)
        assert not port._engine.store.exists("ck:gadget")
    finally:
        port.shutdown()
    assert not marker.exists()


def test_shutdown_save_ends_a_supervised_node_and_its_restart_restores_it(tmp_path):
    """SHUTDOWN SAVE over the wire saves and ends the server process; the
    supervisor's restart passes --restore and the node answers the write
    made after the last SAVE, which only SHUTDOWN's generation holds."""
    from redisson_tpu_torch.cluster.supervisor import ClusterSupervisor

    with ClusterSupervisor(masters=1, base_dir=str(tmp_path), platform="cpu") as sup:
        node = sup.masters[0]
        with sup.conn(node) as c:
            assert c.execute("SET", "{ck}:a", "1") == b"OK"
            assert c.execute("SAVE") == b"OK"
            assert c.execute("SET", "{ck}:b", "2") == b"OK"
            try:
                reply = c.execute("SHUTDOWN", "SAVE")
            except (ConnectionError, EOFError):
                reply = b"OK"  # the connection closed as the server stopped
            assert reply == b"OK"
        assert sup.wait_exit(node, 60.0) == 0
        assert os.path.exists(node.checkpoint_path + ".1")
        sup.restart(node)
        with sup.conn(node) as c:
            assert c.execute("GET", "{ck}:a") == b"1"
            assert c.execute("GET", "{ck}:b") == b"2"
