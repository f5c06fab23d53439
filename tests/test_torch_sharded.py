"""The sharded sketch programs (K12) and the cross-device merge (K13) of the
port against ``redisson_tpu.parallel`` on the CPU.

The reference runs on its 8 XLA host devices (tests/conftest.py) and the
port on 8 CPU positions (``parallel/mesh.set_cpu_positions``), at dp 1 x
shard 8 and dp 2 x shard 4, on inputs made from a seed with numpy.  Planes,
registers, flags, old bits and cardinalities are equal bit for bit;
estimates follow the PFCOUNT contract of tests/test_torch_kernels.py.
Each case covers a stored width above the hash domain (width > m), a batch
with repeated keys (the sharded add reads every probe before the batch
writes any), and a batch padded past n_valid.  The windowed plain functions
are held to the whole-plane ones, and merge_across_devices to the
reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu.parallel import manager as JMM
from redisson_tpu.parallel import mesh as JM
from redisson_tpu.parallel import sharded as JS
from redisson_tpu.utils import hashing as JH
from redisson_tpu_torch.core import kernels as TK
from redisson_tpu_torch.parallel import manager as TMM
from redisson_tpu_torch.parallel import mesh as TM
from redisson_tpu_torch.parallel import sharded as TS
from tests.test_torch_kernels import _assert_estimates

TM.set_cpu_positions(8)

GEOMETRIES = [(1, 8), (2, 4)]
K_HASH, T = 5, 6


def _meshes(dp):
    return (JM.make_mesh(8, dp=dp, devices=jax.devices()[:8]),
            TM.make_mesh(8, dp=dp, devices=TM.local_devices("cpu", count=8)))


def _padded(m, shard):
    """A stored width above m: m rounded up to 128 a shard, one more row of
    lanes a shard beyond that."""
    step = 128 * shard
    return -(-m // step) * step + step


def _jax_ops(mesh, *arrays, b):
    sb = JM.batch_sharding(mesh)
    return [jax.device_put(np.pad(a, (0, b - a.shape[0])), sb) for a in arrays]


def _batch(rng, n, tenants, repeat=0):
    keys = rng.integers(0, 1 << 62, n).astype(np.int64)
    if repeat:
        keys[-repeat:] = keys[:repeat]  # the same keys twice in one batch
    tenant = rng.integers(0, tenants, n).astype(np.int32)
    if repeat:
        tenant[-repeat:] = tenant[:repeat]
    return tenant, keys


@pytest.mark.parametrize("dp, shard", GEOMETRIES)
def test_sharded_bloom_matches_reference(dp, shard):
    rng = np.random.default_rng(11 + dp)
    m = 3000                       # the hash domain
    width = _padded(m, shard)      # stored width > m, a shard multiple
    jmesh, tmesh = _meshes(dp)
    jadd, jcontains = JS.make_sharded_bloom_kernels(jmesh, K_HASH, m, T, width)
    tadd, tcontains = TS.make_sharded_bloom_kernels(tmesh, K_HASH, m, T, width)
    jbits = jax.device_put(jnp.zeros((T, width), jnp.uint8), JM.state_sharding(jmesh))
    tbits = TS.ShardedPlane.zeros((T, width), tmesh, 1)
    mgr = TMM.MeshManager(mesh=tmesh)
    geom = TMM.Geometry(tmesh, 0)
    added = []
    for n, repeat in ((300, 40), (517, 100), (64, 64)):
        tenant, keys = _batch(rng, n, T, repeat)
        lo, hi = JH.int_keys_to_u32_pair(keys)
        batch, nv = mgr.pad_batch(tenant, lo, hi, geom)
        assert batch.n > nv  # padded past n_valid
        jt, jl, jh = _jax_ops(jmesh, tenant, lo, hi, b=batch.n)
        jbits, jnewly = jadd(jbits, jt, jl, jh, nv)
        tbits, tnewly = tadd(tbits, batch, nv)
        np.testing.assert_array_equal(tnewly.numpy(), np.asarray(jnewly))
        np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
        added.append((tenant, keys))
    # contains on added keys, absent keys and a padded batch
    for tenant, keys in added + [_batch(rng, 700, T)]:
        lo, hi = JH.int_keys_to_u32_pair(keys)
        batch, nv = mgr.pad_batch(tenant, lo, hi, geom)
        jt, jl, jh = _jax_ops(jmesh, tenant, lo, hi, b=batch.n)
        np.testing.assert_array_equal(tcontains(tbits, batch, nv).numpy(),
                                      np.asarray(jcontains(jbits, jt, jl, jh, nv)))
    # pad columns [m, width) were never addressed
    assert not tbits.numpy()[:, m:].any()
    # every dp replica holds the same plane
    for d in range(dp):
        np.testing.assert_array_equal(
            torch.cat(list(tbits.parts[d]), dim=1).numpy(), tbits.numpy())


def test_sharded_add_reports_repeated_keys_newly_both_times():
    """Two equal keys in one add batch both report newly added: every probe
    is read from the plane as it stood before the batch."""
    _, tmesh = _meshes(2)
    tadd, _ = TS.make_sharded_bloom_kernels(tmesh, K_HASH, 1024, 2, 1024)
    bits = TS.ShardedPlane.zeros((2, 1024), tmesh, 1)
    keys = np.array([7, 7, 9, 7], np.int64)
    lo, hi = JH.int_keys_to_u32_pair(keys)
    batch, nv = TMM.MeshManager(mesh=tmesh).pad_batch(np.zeros(4, np.int32), lo, hi,
                                                      TMM.Geometry(tmesh, 0))
    _, newly = tadd(bits, batch, nv)
    assert newly.numpy()[:4].tolist() == [True, True, True, True]
    _, newly = tadd(bits, batch, nv)
    assert not newly.numpy().any()


@pytest.mark.parametrize("dp, shard", GEOMETRIES)
def test_sharded_hll_matches_reference(dp, shard):
    rng = np.random.default_rng(21 + dp)
    p, tenants = 8, 11
    rows = -(-tenants // shard) * shard  # pad rows past the tenants
    jmesh, tmesh = _meshes(dp)
    jadd, jest = JS.make_sharded_hll_kernels(jmesh, p, rows)
    tadd, test_ = TS.make_sharded_hll_kernels(tmesh, p, rows)
    jregs = jax.device_put(jnp.zeros((rows, 1 << p), jnp.uint8),
                           jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(JM.SHARD_AXIS, None)))
    tregs = TS.ShardedPlane.zeros((rows, 1 << p), tmesh, 0)
    mgr, geom = TMM.MeshManager(mesh=tmesh), TMM.Geometry(tmesh, 0)
    for n in (900, 333, 2048):
        tenant, keys = _batch(rng, n, tenants, repeat=50)
        lo, hi = JH.int_keys_to_u32_pair(keys)
        batch, nv = mgr.pad_batch(tenant, lo, hi, geom)
        jt, jl, jh = _jax_ops(jmesh, tenant, lo, hi, b=batch.n)
        jregs = jadd(jregs, jt, jl, jh, nv)
        tregs = tadd(tregs, batch, nv)
        np.testing.assert_array_equal(tregs.numpy(), np.asarray(jregs))
    assert not tregs.numpy()[tenants:].any()
    _assert_estimates(test_(tregs).numpy(), np.asarray(jest(jregs)))


@pytest.mark.parametrize("dp, shard", GEOMETRIES)
def test_sharded_bitset_matches_reference(dp, shard):
    rng = np.random.default_rng(31 + dp)
    m = 5000
    width = _padded(m, shard)  # > m
    jmesh, tmesh = _meshes(dp)
    (jset, jclear), jget, jcard = JS.make_sharded_bitset_kernels(jmesh, m, width)
    (tset, tclear), tget, tcard = TS.make_sharded_bitset_kernels(tmesh, m, width)
    jbits = jax.device_put(jnp.zeros((width,), jnp.uint8),
                           jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(JM.SHARD_AXIS)))
    tbits = TS.ShardedPlane.zeros((width,), tmesh, 0)
    mgr, geom = TMM.MeshManager(mesh=tmesh), TMM.Geometry(tmesh, 0)

    def both(idx):
        batch, nv = mgr.pad_indexes(idx, geom)
        sb = JM.batch_sharding(jmesh)
        jidx = jax.device_put(np.pad(idx.astype(np.int32), (0, batch.n - nv)), sb)
        return batch, nv, jidx

    for step, (n, setting) in enumerate(((700, True), (300, True), (450, False), (900, True))):
        idx = rng.integers(0, m, n)
        idx[-20:] = idx[:20]  # repeated indexes in one batch
        batch, nv, jidx = both(idx)
        jbits, jold = (jset if setting else jclear)(jbits, jidx, nv)
        tbits, told = (tset if setting else tclear)(tbits, batch, nv)
        np.testing.assert_array_equal(told.numpy(), np.asarray(jold), err_msg=f"step {step}")
        np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits), err_msg=f"step {step}")
        assert tcard(tbits) == int(jcard(jbits))
        probe = rng.integers(0, m, 513)
        batch, nv, jidx = both(probe)
        np.testing.assert_array_equal(tget(tbits, batch, nv).numpy(), np.asarray(jget(jbits, jidx, nv)))
    assert not tbits.numpy()[m:].any()


@pytest.mark.parametrize("newly", [False, True])
def test_windowed_bloom_plain_equals_whole_plane(newly):
    """A plane cut into column windows: each window's probe and set (plain)
    combine (AND, or OR for newly) to the whole plane's results."""
    rng = np.random.default_rng(5)
    tenants, width, shards, m = 3, 1536, 4, 1400
    whole = torch.from_numpy((rng.random((tenants, width)) < 0.4).astype(np.uint8))
    whole[:, m:] = 0
    keys = rng.integers(0, 1 << 62, 500).astype(np.int64)
    lo, hi = JH.int_keys_to_u32_pair(keys)
    kb = TK.Keys(n=500, tenant=torch.from_numpy(rng.integers(0, tenants, 500).astype(np.int32)),
                 lo=torch.from_numpy(lo.view(np.int32)), hi=torch.from_numpy(hi.view(np.int32)))
    w = width // shards
    parts = [whole[:, s * w:(s + 1) * w].contiguous() for s in range(shards)]
    got = [TK.bloom_probe_plain(parts[s], w, kb, 450, K_HASH, m, newly=newly, col_lo=s * w)
           for s in range(shards)]
    fold = torch.logical_or if newly else torch.logical_and
    combined = got[0]
    for g in got[1:]:
        combined = fold(combined, g)
    want = TK.bloom_probe_plain(whole.clone(), width, kb, 450, K_HASH, m, newly=newly)
    np.testing.assert_array_equal(combined.numpy(), want.numpy())
    for s in range(shards):
        TK.bloom_set_plain(parts[s], w, kb, 450, K_HASH, m, col_lo=s * w)
    TK.bloom_set_plain(whole, width, kb, 450, K_HASH, m)
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(), whole.numpy())


def test_windowed_hll_and_bitset_plain_equal_whole_plane():
    rng = np.random.default_rng(6)
    p, rows, shards = 6, 8, 4
    keys = rng.integers(0, 1 << 62, 900).astype(np.int64)
    lo, hi = JH.int_keys_to_u32_pair(keys)
    kb = TK.Keys(n=900, tenant=torch.from_numpy(rng.integers(0, rows, 900).astype(np.int32)),
                 lo=torch.from_numpy(lo.view(np.int32)), hi=torch.from_numpy(hi.view(np.int32)))
    whole = torch.zeros((rows, 1 << p), dtype=torch.uint8)
    TK.hll_add_plain(whole, 1 << p, kb, 800, p)
    t_local = rows // shards
    parts = [torch.zeros((t_local, 1 << p), dtype=torch.uint8) for _ in range(shards)]
    for s in range(shards):
        TK.hll_add_plain(parts[s], 1 << p, kb, 800, p, row_lo=s * t_local)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), whole.numpy())

    size, w = 4096, 1024
    bits = torch.from_numpy((rng.random(size) < 0.5).astype(np.uint8))
    bparts = [bits[s * w:(s + 1) * w].clone() for s in range(4)]
    idx = torch.from_numpy(rng.integers(0, size, 700).astype(np.int32))
    got = torch.zeros(700, dtype=torch.uint8)
    for s in range(4):
        got = torch.maximum(got, TK.bitset_get_plain(bparts[s], idx, lo=s * w))
    np.testing.assert_array_equal(got.numpy(), TK.bitset_get_plain(bits, idx).numpy())
    old = torch.zeros(700, dtype=torch.uint8)
    for s in range(4):
        old = torch.maximum(old, TK.bitset_set_plain(bparts[s], idx, 650, 1, lo=s * w)[1])
    _, want_old = TK.bitset_set_plain(bits, idx, 650, 1)
    np.testing.assert_array_equal(old.numpy(), want_old.numpy())
    np.testing.assert_array_equal(torch.cat(bparts).numpy(), bits.numpy())


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_merge_across_devices_matches_reference(dtype):
    rng = np.random.default_rng(8)
    arrays = [rng.integers(0, 100, (16, 64)).astype(dtype) for _ in range(5)]
    devs = jax.devices()
    want = np.asarray(JMM.merge_across_devices(
        [jax.device_put(a, devs[i % 3]) for i, a in enumerate(arrays)]))
    got = TMM.merge_across_devices([torch.from_numpy(a) for a in arrays])
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        TMM.merge_across_devices([])


def test_mesh_positions_and_manager_cache():
    assert len(TM.local_devices("cpu")) == 8
    mesh = TM.make_mesh(8, dp=2, devices=TM.local_devices("cpu"))
    assert mesh.shape == {"dp": 2, "shard": 4}
    assert [p.id for p in mesh.devices.flat] == list(range(8))
    with pytest.raises(ValueError):
        TM.make_mesh(8, dp=3, devices=TM.local_devices("cpu"))
    with pytest.raises(ValueError):
        TM.make_mesh(9, devices=TM.local_devices("cpu"))
    assert TM.device_ring(4, 3, 5) == [3, 0, 1, 2, 3]
    table = TM.SlotTable(4)
    assert table.shard_of_slot(0) == 0 and table.shard_of_slot(16383) == 3
    mgr = TMM.MeshManager(device="cpu")
    mgr.reshard(2, 4)
    a = mgr.bloom_kernels(7, 1024, 4, 1024)
    assert mgr.bloom_kernels(7, 1024, 4, 1024) is a and mgr.kernel_builds == 1
    mgr.reshard(1, 8)
    b = mgr.bloom_kernels(7, 1024, 4, 1024)
    mgr.reshard(2, 4)
    assert mgr.bloom_kernels(7, 1024, 4, 1024) is a  # the warm pool, across epochs
    assert b is not a and mgr.kernel_builds == 2
