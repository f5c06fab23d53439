"""The port's sharded objects (ShardedBloomFilterArray, ShardedHllArray,
ShardedBitSet) against the reference's, on the CPU: embedded on dp 1 x
shard 8 and dp 2 x shard 4, through live reshards 4 -> 8 -> 4, and over
OBJCALL (each package's RemoteRedisson against its own server).  The
reference runs on its 8 XLA host devices, the port on 8 CPU positions.
Flags, planes, registers, old bits and cardinalities are equal bit for
bit; estimates follow tests/test_torch_kernels.py's contract.  Also the
state carried across for the sharded kinds, and dryrun_multichip at a small
size."""
import numpy as np
import pytest

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.client import remote as ref_remote
from redisson_tpu.config import Config as RefConfig
from redisson_tpu.core.store import StateRecord as RefRecord
from redisson_tpu.parallel.manager import MeshManager as RefMeshManager
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu_torch import graft_entry, state
from redisson_tpu_torch.client import remote as port_remote
from redisson_tpu_torch.config import Config as PortConfig
from redisson_tpu_torch.parallel import mesh as TM
from redisson_tpu_torch.parallel.manager import MeshManager as PortMeshManager
from redisson_tpu_torch.server import ServerThread
from tests.test_torch_kernels import _assert_estimates

TM.set_cpu_positions(8)

GEOMETRIES = [(1, 8), (2, 4)]


def _clients(dp, shard):
    out = []
    for cfg_cls, make in ((RefConfig, redisson_tpu.create),
                          (PortConfig, lambda c: redisson_tpu_torch.create(c, "cpu"))):
        cfg = cfg_cls()
        cfg.mesh.dp, cfg.mesh.shard = dp, shard
        out.append(make(cfg))
    return out


@pytest.fixture(params=GEOMETRIES, ids=lambda g: f"dp{g[0]}x{g[1]}")
def pair(request):
    ref, port = _clients(*request.param)
    yield ref, port
    ref.shutdown()
    port.shutdown()


def _keys(rng, n, tenants):
    ks = rng.integers(0, 1 << 60, n).astype(np.int64)
    t = rng.integers(0, tenants, n).astype(np.int32)
    d = n // 8
    if d:
        ks[n - d:], t[n - d:] = ks[:d], t[:d]  # repeats in one batch
    return t, ks


def _plane(client, name, key):
    arr = client._engine.store.get(name).arrays[key]
    return arr.numpy() if hasattr(arr, "parts") else np.asarray(arr)


def _reshard_both(ref, port, dp, shard):
    RefMeshManager.of(ref._engine).reshard(dp=dp, shard=shard)
    PortMeshManager.of(port._engine).reshard(dp=dp, shard=shard)


def test_sharded_bloom_array_matches_reference(pair):
    ref, port = pair
    rng = np.random.default_rng(1)
    T = 7
    r, p = ref.get_sharded_bloom_filter_array("bf"), port.get_sharded_bloom_filter_array("bf")
    assert r.try_init(T, 20_000, 0.01) and p.try_init(T, 20_000, 0.01)
    assert not p.try_init(T, 20_000, 0.01)
    assert (p.get_size(), p.get_hash_iterations(), p.tenants(), p.shards()) == \
        (r.get_size(), r.get_hash_iterations(), r.tenants(), r.shards())
    for n in (600, 1500, 1):
        t, ks = _keys(rng, n, T)
        np.testing.assert_array_equal(p.add_each(t, ks), r.add_each(t, ks))
    t, ks = _keys(rng, 3000, T)
    np.testing.assert_array_equal(p.contains_each(t, ks), r.contains_each(t, ks))
    assert p.add(t[:100], ks[:100]) == r.add(t[:100], ks[:100])
    np.testing.assert_array_equal(_plane(port, "bf", "bits"), _plane(ref, "bf", "bits"))
    np.testing.assert_array_equal(p.tenant_bit_counts(), r.tenant_bit_counts())
    p.clear_tenant(3)
    r.clear_tenant(3)
    np.testing.assert_array_equal(_plane(port, "bf", "bits"), _plane(ref, "bf", "bits"))
    with pytest.raises(IndexError):
        p.clear_tenant(T)
    with pytest.raises(TypeError):
        p.add_each(t[:2], ["a", "b"])
    assert p.contains_each(t[:0], ks[:0]).shape == (0,)


def test_sharded_hll_array_matches_reference(pair):
    ref, port = pair
    rng = np.random.default_rng(2)
    T = 11
    r, p = ref.get_sharded_hll_array("h"), port.get_sharded_hll_array("h")
    assert r.try_init(T, p=9) and p.try_init(T, p=9)
    for n in (5000, 777):
        t, ks = _keys(rng, n, T)
        p.add_each(t, ks)
        r.add_each(t, ks)
    np.testing.assert_array_equal(_plane(port, "h", "regs"), _plane(ref, "h", "regs"))
    _assert_estimates(p.estimate_all(), r.estimate_all())
    assert p.estimate(4) == r.estimate(4)
    p.clear_tenant(4)
    r.clear_tenant(4)
    np.testing.assert_array_equal(_plane(port, "h", "regs"), _plane(ref, "h", "regs"))


def test_sharded_bit_set_matches_reference(pair):
    ref, port = pair
    rng = np.random.default_rng(3)
    size = 100_000
    names = ("a", "b")
    for name in names:
        assert ref.get_sharded_bit_set(name).try_init(size)
        assert port.get_sharded_bit_set(name).try_init(size)
    r, p = ref.get_sharded_bit_set("a"), port.get_sharded_bit_set("a")
    assert (p.size(), p.plane_width(), p.shards()) == (r.size(), r.plane_width(), r.shards())
    for value, n in ((True, 3000), (True, 700), (False, 900)):
        idx = rng.integers(0, size, n)
        np.testing.assert_array_equal(p.set_each(idx, value), r.set_each(idx, value))
        assert p.cardinality() == r.cardinality()
    probe = rng.integers(0, size, 5000)
    np.testing.assert_array_equal(p.get_each(probe), r.get_each(probe))
    assert (p.set(17), p.get(17)) == (r.set(17), r.get(17))
    other_idx = rng.integers(0, size, 2000)
    port.get_sharded_bit_set("b").set_each(other_idx)
    ref.get_sharded_bit_set("b").set_each(other_idx)
    for op in ("or_", "xor", "and_"):
        getattr(p, op)("b")
        getattr(r, op)("b")
        np.testing.assert_array_equal(_plane(port, "a", "bits"), _plane(ref, "a", "bits"))
    p.not_()
    r.not_()
    assert p.cardinality() == r.cardinality()
    np.testing.assert_array_equal(_plane(port, "a", "bits"), _plane(ref, "a", "bits"))
    with pytest.raises(IndexError):
        p.set_each(np.array([size]))
    p.clear()
    r.clear()
    assert p.cardinality() == r.cardinality() == 0


def test_reshard_round_trips_match_reference():
    """4 -> 8 -> 4 with writes on every geometry: planes, registers and
    replies equal the reference's after each reshard."""
    ref, port = _clients(2, 4)
    try:
        rng = np.random.default_rng(4)
        T = 6
        for c in (ref, port):
            assert c.get_sharded_bloom_filter_array("rb").try_init(T, 40_000, 0.01)
            assert c.get_sharded_hll_array("rh").try_init(T, p=8)
            assert c.get_sharded_bit_set("rs").try_init(1 << 18)
        for dp, shard in ((2, 4), (1, 8), (2, 4)):
            _reshard_both(ref, port, dp, shard)
            t, ks = _keys(rng, 900, T)
            idx = rng.integers(0, 1 << 18, 700)
            got = [(c.get_sharded_bloom_filter_array("rb").add_each(t, ks),
                    c.get_sharded_hll_array("rh").add_each(t, ks),
                    c.get_sharded_bit_set("rs").set_each(idx),
                    c.get_sharded_bloom_filter_array("rb").contains_each(t[::-1].copy(), ks[::-1].copy()),
                    c.get_sharded_bit_set("rs").cardinality())
                   for c in (ref, port)]
            for a, b in zip(*got):
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
            for name, key in (("rb", "bits"), ("rh", "regs"), ("rs", "bits")):
                np.testing.assert_array_equal(_plane(port, name, key), _plane(ref, name, key))
            assert PortMeshManager.of(port._engine).n_shard == shard
        with pytest.raises(ValueError):
            PortMeshManager.of(port._engine).reshard(dp=5, shard=2)
    finally:
        ref.shutdown()
        port.shutdown()


def test_sharded_objects_over_objcall_match_reference():
    """Each package's RemoteRedisson against its own server: the sharded
    objects' replies over OBJCALL are equal."""
    rng = np.random.default_rng(5)
    t, ks = _keys(rng, 400, 4)
    idx = rng.integers(0, 50_000, 300)
    got = {}
    for pkg, server, client in (("ref", RefServerThread(port=0), ref_remote.RemoteRedisson),
                                ("port", ServerThread(port=0, device="cpu"), port_remote.RemoteRedisson)):
        with server as st:
            c = client(st.address, timeout=60.0)
            try:
                bf = c.get_sharded_bloom_filter_array("wbf")
                h = c.get_sharded_hll_array("wh")
                bs = c.get_sharded_bit_set("wbs")
                got[pkg] = [bf.try_init(4, 10_000, 0.01), bf.get_size(), bf.shards(), bf.add_each(t, ks),
                            bf.contains_each(t, ks[::-1].copy()), h.try_init(4, p=10), h.add_each(t, ks),
                            h.estimate_all(), bs.try_init(50_000), bs.set_each(idx), bs.get_each(idx[::2].copy()),
                            bs.cardinality()]
            finally:
                c.shutdown()
    for i, (a, b) in enumerate(zip(got["ref"], got["port"])):
        if i == 7:
            _assert_estimates(b, a)
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=f"reply {i}")


@pytest.mark.parametrize("kind, key", [("sharded_bloom_array", "bits"), ("sharded_hll_array", "regs"),
                                       ("sharded_bitset", "bits")])
def test_state_carries_sharded_planes_both_ways(kind, key):
    ref, port = _clients(2, 4)
    try:
        rng = np.random.default_rng(6)
        t, ks = _keys(rng, 700, 8)
        make = {"sharded_bloom_array": lambda c: (c.get_sharded_bloom_filter_array("s").try_init(8, 9000, 0.01),
                                                  c.get_sharded_bloom_filter_array("s").add_each(t, ks)),
                "sharded_hll_array": lambda c: (c.get_sharded_hll_array("s").try_init(8, p=8),
                                                c.get_sharded_hll_array("s").add_each(t, ks)),
                "sharded_bitset": lambda c: (c.get_sharded_bit_set("s").try_init(1 << 16),
                                             c.get_sharded_bit_set("s").set_each(ks % (1 << 16)))}[kind]
        make(ref)
        rrec = ref._engine.store.get("s")
        gathered = np.asarray(rrec.arrays[key])
        mesh = PortMeshManager.of(port._engine).mesh
        rec = state.from_reference(kind, rrec.meta, {key: gathered}, "cpu", mesh=mesh)
        assert rec.arrays[key].mesh is mesh
        port._engine.store.put("s", rec)
        np.testing.assert_array_equal(_plane(port, "s", key), gathered)
        if kind == "sharded_bloom_array":
            np.testing.assert_array_equal(port.get_sharded_bloom_filter_array("s").contains_each(t, ks),
                                          ref.get_sharded_bloom_filter_array("s").contains_each(t, ks))
        # and back: the port's plane as the reference's record
        make(port) if kind != "sharded_bloom_array" else None
        k2, meta, arrays, host = state.to_reference(port._engine.store.get("s"))
        assert k2 == kind
        ref._engine.store.put("s2", RefRecord(kind=kind, meta=meta, arrays={key: arrays[key]}, host=host))
        np.testing.assert_array_equal(np.asarray(ref._engine.store.get("s2").arrays[key]),
                                      _plane(port, "s", key))
        with pytest.raises(ValueError):
            state.from_reference(kind, rrec.meta, {key: gathered}, "cpu")
    finally:
        ref.shutdown()
        port.shutdown()


def test_dryrun_multichip_on_cpu_positions():
    out = graft_entry.dryrun_multichip(8, "cpu")
    assert out["mesh"] == {"dp": 2, "shard": 4} and out["lost_probes"] == 0
    assert out["acked_batches"] == 12 and out["reshards"] == "4->8->4"
