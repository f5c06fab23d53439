"""The port's RBatch boundary (core/batch.py, core/coalesce.py) against the
JAX package's on the CPU: every batch verb, overlapped and serial; the fused
run and the fused pair against per-group dispatch and against the JAX
Batch; mixed geometry falling back per group; a repeated add name refused;
atomic and skip_result; and the local batch and coalescing cases of
tests/test_perf_smoke.py and tests/test_batch_options.py run on both
packages.  Replies and states must be identical; nothing here is a float
compared with a tolerance.
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.core import coalesce as JCO
from redisson_tpu.core import ioplane as JIO
from redisson_tpu_torch import state
from redisson_tpu_torch.client.redisson import RedissonTpu as TorchClient
from redisson_tpu_torch.core import batch as TB
from redisson_tpu_torch.core import coalesce as TCO
from redisson_tpu_torch.core import ioplane as TIO
from redisson_tpu_torch.core import kernels as TK

PACKAGES = {
    "jax": (redisson_tpu.create, JIO, JCO),
    "torch": (lambda: redisson_tpu_torch.create(device="cpu"), TIO, TCO),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """(create, ioplane module, coalesce module) of one package."""
    return PACKAGES[request.param]


def _norm(v):
    """A reply as (numpy dtype, list) / plain value, comparable across packages."""
    if isinstance(v, np.ndarray):
        return ("b" if v.dtype == np.bool_ else v.dtype.str), v.tolist()
    if isinstance(v, (np.integer, np.bool_)):
        return v.item()
    return v


def _record(client, name):
    rec = client.engine.store.get(name)
    if rec is None:
        return None
    if isinstance(client, TorchClient):
        kind, meta, arrays, host = state.to_reference(rec)
    else:
        kind, meta, host = rec.kind, dict(rec.meta), rec.host
        arrays = {k: np.asarray(v) for k, v in rec.arrays.items()}
    return kind, meta, {k: v.tolist() for k, v in arrays.items()}, host


def _every_verb_batch(c, rng, skip_result=False, atomic=False):
    """One batch through every verb of the Batch: a coalesced add run and
    contains run, an add-then-contains pair, byte keys, a bank, bit sets
    (set to 1 and to 0, get), HLL, buckets and an atomic counter.  Returns
    (futures, names touched)."""
    for i in range(4):
        assert c.get_bloom_filter(f"ev:bf{i}").try_init(20_000, 0.01)
    assert c.get_bloom_filter("ev:pair").try_init(5_000, 0.01)
    assert c.get_bloom_filter("ev:bytes").try_init(5_000, 0.01)
    assert c.get_bloom_filter_array("ev:bank").try_init(tenants=8, expected_insertions=1000,
                                                        false_probability=0.01)
    keysets = [rng.integers(0, 1 << 60, 150 + 30 * i).astype(np.int64) for i in range(4)]
    tk = rng.integers(0, 1 << 60, 200).astype(np.int64)
    tt = (tk % 8).astype(np.int32)
    idx = rng.integers(0, 4000, 120).astype(np.int64)
    b = c.create_batch(skip_result=skip_result, atomic=atomic)
    futs = []
    for i in range(4):
        futs.append(b.get_bloom_filter(f"ev:bf{i}").add_async(keysets[i]))
    for i in range(4):
        futs.append(b.get_bloom_filter(f"ev:bf{i}").contains_async(keysets[i][::2]))
    pair = b.get_bloom_filter("ev:pair")
    futs.append(pair.add_async(keysets[0][:90]))
    futs.append(pair.contains_async(np.concatenate([keysets[0][:40], keysets[1][:40]])))
    futs.append(b.get_bloom_filter("ev:bytes").add_async(["a", "b", 7, "a"]))
    futs.append(b.get_bloom_filter("ev:bytes").contains_async(["a", "zz", 7]))
    futs.append(b.get_bloom_filter("ev:bytes").contains_async("single"))
    ba = b.get_bloom_filter_array("ev:bank")
    futs.append(ba.add_async(tt, tk))
    futs.append(ba.contains_async(tt, tk + (np.arange(200) % 2)))
    bs = b.get_bit_set("ev:bits")
    futs.append(bs.set_async(idx, True))
    futs.append(bs.get_async(idx))
    futs.append(bs.set_async(idx[:30], False))
    futs.append(b.get_bit_set("ev:bits2").get_async(idx))
    futs.append(b.get_hyper_log_log("ev:hll").add_all_async(tk))
    futs.append(b.get_bucket("ev:bucket").set_async({"v": 1}))
    futs.append(b.get_bucket("ev:bucket").get_async())
    futs.append(b.get_atomic_long("ev:ctr").add_and_get_async(41))
    futs.append(b.get_atomic_long("ev:ctr").add_and_get_async(-1))
    res = b.execute()
    names = [f"ev:bf{i}" for i in range(4)] + ["ev:pair", "ev:bytes", "ev:bank", "ev:bits", "ev:hll", "ev:bucket", "ev:ctr"]
    return res, futs, names


def _run_every_verb(create, io, overlap, **kw):
    prev = io.set_overlap(overlap)
    try:
        c = create()
        try:
            res, futs, names = _every_verb_batch(c, np.random.default_rng(11), **kw)
            replies = [_norm(f.get()) for f in futs]
            return [_norm(r) for r in res.responses], replies, [_record(c, n) for n in names]
        finally:
            c.shutdown()
    finally:
        io.set_overlap(prev)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode", ["plain", "skip_result", "atomic"])
def test_every_verb_matches_the_jax_batch(overlap, mode):
    kw = {"skip_result": mode == "skip_result", "atomic": mode == "atomic"}
    want = _run_every_verb(*PACKAGES["jax"][:2], overlap, **kw)
    got = _run_every_verb(*PACKAGES["torch"][:2], overlap, **kw)
    assert got == want
    responses, replies, _ = got
    assert responses == ([] if mode == "skip_result" else replies)


@pytest.mark.parametrize("mode", ["plain", "skip_result", "atomic"])
def test_overlapped_batch_is_identical_to_serial(mode):
    kw = {"skip_result": mode == "skip_result", "atomic": mode == "atomic"}
    assert _run_every_verb(*PACKAGES["torch"][:2], True, **kw) == \
        _run_every_verb(*PACKAGES["torch"][:2], False, **kw)


def test_every_reference_verb_has_a_port():
    from redisson_tpu.core import batch as JB

    assert set(TB._DISPATCH) == set(JB._DISPATCH)
    assert set(TB._DISPATCH_LAZY) == set(JB._DISPATCH_LAZY)
    for cls in ("BatchBloom", "BatchBloomArray", "BatchHll", "BatchBitSet", "BatchBucket", "BatchAtomicLong"):
        jm = {n for n in vars(getattr(JB, cls)) if not n.startswith("__")}
        tm = {n for n in vars(getattr(TB, cls)) if not n.startswith("__")}
        assert tm == jm, cls
    jb = {n for n in vars(JB.Batch) if n.startswith("get_")}
    assert jb <= {n for n in vars(TB.Batch) if n.startswith("get_")}


def _fused_counts(monkeypatch, co):
    calls = {"add": 0, "contains": 0, "pair": 0}
    for verb, name in (("add", "fused_bloom_add_async"), ("contains", "fused_bloom_contains_async"),
                       ("pair", "fused_bloom_pair_async")):
        real = getattr(co, name)

        def counted(*a, _real=real, _verb=verb, **k):
            calls[_verb] += 1
            return _real(*a, **k)

        monkeypatch.setattr(co, name, counted)
    return calls


def test_local_batch_coalesces_cross_filter_runs(pkg, monkeypatch):
    """A run of same-verb bloom ops against different same-geometry filters
    is ONE fused dispatch, and every reply scatters back to its issuer with
    its own length (tests/test_batch_options.py, on both packages)."""
    create, _io, co = pkg
    calls = _fused_counts(monkeypatch, co)
    client = create()
    try:
        F = 5
        for i in range(F):
            assert client.get_bloom_filter(f"co:{i}").try_init(20_000, 0.01)
        b = client.create_batch()
        adds, probes = [], []
        for i in range(F):
            bf = b.get_bloom_filter(f"co:{i}")
            adds.append((i, bf.add_async(np.arange(i * 1000, i * 1000 + 100 + i, dtype=np.int64))))
        for i in range(F):
            bf = b.get_bloom_filter(f"co:{i}")
            probes.append((i, bf.contains_async(np.arange(i * 1000, i * 1000 + 150 + i, dtype=np.int64))))
        b.execute()
        assert calls == {"add": 1, "contains": 1, "pair": 0}, calls
        for i, fut in adds:
            assert fut.get() == 100 + i
        for i, fut in probes:
            got = np.asarray(fut.get())
            assert got.shape[0] == 150 + i
            assert got[: 100 + i].all() and not got[100 + i :].any()
    finally:
        client.shutdown()


def test_local_batch_mixed_geometry_falls_back_per_group(pkg, monkeypatch):
    create, _io, co = pkg
    calls = _fused_counts(monkeypatch, co)
    client = create()
    try:
        assert client.get_bloom_filter("mix:a").try_init(10_000, 0.01)
        assert client.get_bloom_filter("mix:b").try_init(90_000, 0.001)
        b = client.create_batch()
        fa = b.get_bloom_filter("mix:a").add_async(np.arange(50, dtype=np.int64))
        fb = b.get_bloom_filter("mix:b").add_async(np.arange(60, dtype=np.int64))
        ca = b.get_bloom_filter("mix:a").contains_async(np.arange(70, dtype=np.int64))
        cb = b.get_bloom_filter("mix:b").contains_async(np.arange(80, dtype=np.int64))
        b.execute()
        assert calls == {"add": 1, "contains": 1, "pair": 0}  # tried, refused
        assert fa.get() == 50 and fb.get() == 60
        ga, gb = np.asarray(ca.get()), np.asarray(cb.get())
        assert ga[:50].all() and not ga[50:].any()
        assert gb[:60].all() and not gb[60:].any()
    finally:
        client.shutdown()


def test_local_batch_atomic_mode(pkg):
    """atomic=True holds every record lock for the whole execute: a
    concurrent writer cannot interleave between the batch's ops."""
    create, _io, _co = pkg
    client = create()
    try:
        stop = threading.Event()
        al_outside = client.get_atomic_long("local:atom")

        def noise():
            while not stop.is_set():
                al_outside.increment_and_get()

        t = threading.Thread(target=noise)
        t.start()
        try:
            for _ in range(10):
                b = client.create_batch(atomic=True)
                al = b.get_atomic_long("local:atom")
                futs = [al.add_and_get_async(1) for _ in range(15)]
                b.execute()
                vals = [f.get() for f in futs]
                assert vals == list(range(vals[0], vals[0] + 15))
        finally:
            stop.set()
            t.join(10)
    finally:
        client.shutdown()


def test_atomic_fused_run_retakes_record_locks():
    """atomic holds locked_many over every name and the fused run takes it
    again: the record locks are re-entrant."""
    c = redisson_tpu_torch.create(device="cpu")
    try:
        for i in range(3):
            c.get_bloom_filter(f"ra:{i}").try_init(1000, 0.01)
        b = c.create_batch(atomic=True)
        futs = [b.get_bloom_filter(f"ra:{i}").add_async(np.arange(10, dtype=np.int64) + i) for i in range(3)]
        b.execute()
        assert [f.get() for f in futs] == [10, 10, 10]
        assert isinstance(c.engine._acquire_entry("x")[0], type(threading.RLock()))
    finally:
        c.shutdown()


def test_fused_pair_matches_serial_and_sees_the_adds(pkg):
    create, io, co = pkg

    def run(overlap):
        prev = io.set_overlap(overlap)
        try:
            c = create()
            try:
                assert c.get_bloom_filter("ovp:bf").try_init(10_000, 0.01)
                rng = np.random.default_rng(3)
                add = rng.integers(0, 1 << 60, 100).astype(np.int64)
                probe = np.concatenate([add[:40], rng.integers(0, 1 << 60, 60).astype(np.int64)])
                b = c.create_batch()
                f_add = b.get_bloom_filter("ovp:bf").add_async(add)
                f_probe = b.get_bloom_filter("ovp:bf").contains_async(probe)
                b.execute()
                return f_add.get(), np.asarray(f_probe.get()).tolist(), _record(c, "ovp:bf")
            finally:
                c.shutdown()
        finally:
            io.set_overlap(prev)

    added_a, found_a, state_a = run(True)
    added_b, found_b, state_b = run(False)
    assert added_a == added_b == 100
    assert found_a == found_b and state_a == state_b
    assert all(found_a[:40])  # the probe observed the adds (pair fusion)


def test_skip_result_resolves_lazily_on_demand(pkg):
    """skip_result drops the batch-level drain; a later fut.get() still
    resolves its readback on its own (demand-driven D2H)."""
    create, io, _co = pkg
    prev = io.set_overlap(True)
    try:
        c = create()
        try:
            assert c.get_bloom_filter("ovs:bf").try_init(5_000, 0.01)
            keys = np.arange(64, dtype=np.int64) * 2654435761
            b = c.create_batch(skip_result=True)
            fut = b.get_bloom_filter("ovs:bf").add_async(keys)
            bits = b.get_bit_set("ovs:bits").set_async(np.arange(5))
            assert b.execute().responses == []
            assert fut.done() and bits.done()
            assert fut.get() == 64
            assert np.asarray(bits.get()).tolist() == [0] * 5
        finally:
            c.shutdown()
    finally:
        io.set_overlap(prev)


def test_batch_errors_land_on_futures_and_execute_once(pkg):
    create, _io, _co = pkg
    c = create()
    try:
        b = c.create_batch()
        missing = b.get_bloom_filter("nope").contains_async(np.arange(3, dtype=np.int64))
        ok = b.get_atomic_long("n").add_and_get_async(2)
        b2 = c.create_batch()
        with pytest.raises(RuntimeError):
            b.execute()  # the failed future raises when the replies are read
        assert ok.get() == 2
        with pytest.raises(RuntimeError):
            missing.get()
        with pytest.raises(RuntimeError):
            b.execute()
        with pytest.raises(RuntimeError):
            b.get_bucket("x").get_async()
        assert b2.execute().responses == []
    finally:
        c.shutdown()


# -- the coalescer on its own (tests/test_perf_smoke.py cases) ---------------------


def test_fused_add_contains_bit_identical_to_unfused_pair():
    """One fused program == add then contains, bit for bit, on the port;
    and the same as the JAX package's fused program."""
    from redisson_tpu.core import kernels as JK
    from redisson_tpu.ops import bittensor as jbt
    from redisson_tpu.utils import hashing as JH

    m, k = 95_851, 7
    rng = np.random.default_rng(5)
    pre = rng.integers(0, 1 << 60, 500).astype(np.int64)
    add = rng.integers(0, 1 << 60, 300).astype(np.int64)
    probe = np.concatenate([add[:150], rng.integers(0, 1 << 60, 150).astype(np.int64)])

    def pack(keys):
        lo, hi = JH.int_keys_to_u32_pair(keys)
        size = TK.bucket_size(keys.shape[0])
        return JK.pack_rows(lo, hi, size=size), TK.pack_rows(lo, hi, size=size, device="cpu"), keys.shape[0]

    (jpre, tpre, n_pre), (jadd, tadd, n_add), (jprobe, tprobe, n_probe) = pack(pre), pack(add), pack(probe)
    base = np.asarray(JK.bloom_add_packed(jbt.make(m), jpre, JK.valid_n(n_pre), k, m)[0])

    bits_a = torch.from_numpy(base.copy())
    _, newly_a = TK.bloom_add_packed(bits_a, tadd, n_add, k, m)
    found_a = TK.bloom_contains_packed(bits_a, tprobe, n_probe, k, m)
    bits_b, newly_b, found_b = TK.bloom_fused_add_contains(torch.from_numpy(base.copy()), tadd, n_add,
                                                           tprobe, n_probe, k, m)
    jbits, jnewly, jfound = JK.bloom_fused_add_contains(jnp.asarray(base), jadd, JK.valid_n(n_add),
                                                        jprobe, JK.valid_n(n_probe), k, m)
    for a, b, j in ((bits_a, bits_b, jbits), (newly_a, newly_b, jnewly), (found_a, found_b, jfound)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(b.numpy(), np.asarray(j))
    assert found_b[:150].all()


def test_coalesced_run_matches_per_filter_dispatch_and_the_reference():
    j = redisson_tpu.create()
    t = redisson_tpu_torch.create(device="cpu")
    try:
        rng = np.random.default_rng(7)
        names, keys_list = [], []
        for i in range(6):
            name = f"perf:co{i}"
            for c in (j, t):
                assert c.get_bloom_filter(name).try_init(20_000, 0.01)
            names.append(name)
            keys_list.append(rng.integers(0, 1 << 60, 200 + 40 * i).astype(np.int64))
        jnewly, jlengths = JCO.fused_bloom_add_async(j._engine, names, keys_list)
        newly, lengths = TCO.fused_bloom_add_async(t.engine, names, keys_list)
        assert lengths == jlengths
        np.testing.assert_array_equal(newly.numpy(), np.asarray(jnewly))
        off = 0
        for i, (name, keys) in enumerate(zip(names, keys_list)):
            assert newly[off : off + lengths[i]].all(), f"{name}: fused add lost keys"
            off += lengths[i]
            assert t.get_bloom_filter(name).contains_each(keys).all()
            assert _record(t, name) == _record(j, name)
        probes = [np.concatenate([keys[:50], rng.integers(0, 1 << 60, 50).astype(np.int64)]) for keys in keys_list]
        jfound, _ = JCO.fused_bloom_contains_async(j._engine, names, probes)
        found, lengths = TCO.fused_bloom_contains_async(t.engine, names, probes)
        np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
        off = 0
        for i, (name, probe) in enumerate(zip(names, probes)):
            np.testing.assert_array_equal(found[off : off + lengths[i]].numpy(),
                                          t.get_bloom_filter(name).contains_each(probe))
            off += lengths[i]
    finally:
        j.shutdown()
        t.shutdown()


def test_fused_add_leaves_every_record_its_own_storage():
    """The stacked add copies each row back into its record's plane: no two
    records share (and pin) one storage, and each plane keeps its identity."""
    t = redisson_tpu_torch.create(device="cpu")
    try:
        names = [f"own:{i}" for i in range(5)]
        for n in names:
            t.get_bloom_filter(n).try_init(10_000, 0.01)
        planes = [t.engine.store.get(n).arrays["bits"] for n in names]
        TCO.fused_bloom_add_async(t.engine, names, [np.arange(100, dtype=np.int64) + i for i in range(5)])
        after = [t.engine.store.get(n).arrays["bits"] for n in names]
        assert all(a is b for a, b in zip(planes, after))
        ptrs = {p.untyped_storage().data_ptr() for p in after}
        assert len(ptrs) == len(names)
        assert all(int(p.sum()) > 0 for p in after)
    finally:
        t.shutdown()


def test_coalesce_ineligible_on_mixed_geometry_and_repeated_add_names(pkg):
    create, _io, co = pkg
    c = create()
    try:
        assert c.get_bloom_filter("perf:g1").try_init(10_000, 0.01)
        assert c.get_bloom_filter("perf:g2").try_init(90_000, 0.01)
        engine = c._engine
        ten = np.arange(10, dtype=np.int64)
        with pytest.raises(co.CoalesceIneligible):
            co.fused_bloom_add_async(engine, ["perf:g1", "perf:g2"], [ten, ten])
        with pytest.raises(co.CoalesceIneligible):
            co.fused_bloom_add_async(engine, ["perf:g1", "perf:g1"], [ten, ten])
        with pytest.raises(co.CoalesceIneligible):
            co.fused_bloom_contains_async(engine, ["perf:g1", "perf:none"], [ten, ten])
        with pytest.raises(co.CoalesceIneligible):
            co.fused_bloom_pair_async(engine, "perf:g1", ["a"], ten)
        with pytest.raises(co.CoalesceIneligible):
            co.fused_bloom_contains_async(engine, ["perf:g1"], [ten[:0]])
    finally:
        c.shutdown()


def test_repeated_add_name_in_a_batch_falls_back_per_group(pkg, monkeypatch):
    """Two add groups on one filter under different codecs form a run that
    names the filter twice: the run is refused and each group sees the
    adds before it."""
    create, _io, co = pkg
    calls = _fused_counts(monkeypatch, co)
    c = create()
    try:
        assert c.get_bloom_filter("dup").try_init(10_000, 0.01)
        b = c.create_batch()
        f1 = b.get_bloom_filter("dup").add_async(np.arange(20, dtype=np.int64))
        f2 = b.get_bloom_filter("dup", codec=object()).add_async(np.arange(30, dtype=np.int64))
        b.execute()
        assert calls["add"] == 1
        assert (f1.get(), f2.get()) == (20, 10)
    finally:
        c.shutdown()


# -- bit-set runs: each level of groups on distinct records in one upload and
#    one launch a verb (core/batch.py _bitset_run) ------------------------------


@pytest.mark.parametrize("names, want", [
    ([], []),
    (["a"], [[0]]),
    (["a", "b", "c"], [[0, 1, 2]]),
    (["a", "a", "b", "b"], [[0, 2], [1, 3]]),  # fanout: each record set, then read
    (["a", "b", "a", "a", "c", "b"], [[0, 1, 4], [2, 5], [3]]),
])
def test_bitset_levels_split_a_run_by_repeated_records(names, want):
    assert TB.bitset_levels(names) == want


def _bitset_case(b, c, case, rng):
    """Queue one case's bit-set ops on batch b of client c; returns
    (futures, names to compare)."""
    futs = []
    idx = lambda n, hi=100_000: rng.integers(0, hi, n)  # noqa: E731
    if case == "interleaved":
        names = [f"lv:{i}" for i in range(12)]
        for n in names:
            futs.append(b.get_bit_set(n).set_async(idx(500)))
            futs.append(b.get_bit_set(n).get_async(idx(500)))
        for n in names[:3]:  # a second op joins each get group
            futs.append(b.get_bit_set(n).get_async(idx(40)))
        return futs, names
    if case == "renamed":
        x, y, z = (b.get_bit_set(n) for n in ("rn:x", "rn:y", "rn:z"))
        a = idx(300, 5000)
        futs += [x.set_async(a), y.get_async(idx(50, 5000)), x.get_async(a[::-1]), z.set_async(idx(80, 5000), False),
                 x.set_async(a[:100], False), y.set_async(a), x.get_async(a), z.get_async(idx(80, 5000))]
        return futs, ["rn:x", "rn:y", "rn:z"]
    if case == "value_false":
        c.get_bit_set("vf:a").set_each(np.arange(0, 6000, 3))
        for n in ("vf:a", "vf:b", "vf:c"):
            futs.append(b.get_bit_set(n).set_async(idx(200, 6000), False))
            futs.append(b.get_bit_set(n).get_async(np.arange(0, 6000, 7)))
            futs.append(b.get_bit_set(n).set_async(idx(200, 6000), True))
        return futs, ["vf:a", "vf:b", "vf:c"]
    if case == "missing":
        c.get_bit_set("ms:pre").set_each(idx(100, 1000))
        futs += [b.get_bit_set("ms:1").get_async(idx(20)), b.get_bit_set("ms:pre").get_async(np.arange(1000)),
                 b.get_bit_set("ms:2").get_async(idx(30)), b.get_bit_set("ms:1").set_async(idx(20)),
                 b.get_bit_set("ms:e").set_async(np.zeros(0, np.int64)),
                 b.get_bit_set("ms:f").get_async(np.zeros(0, np.int64)), b.get_bit_set("ms:1").get_async(idx(20))]
        return futs, ["ms:1", "ms:2", "ms:pre", "ms:e", "ms:f"]
    if case == "growth":
        c.get_bit_set("gr:h").set_each(idx(50))
        big = np.array([5, (1 << 20) + 77, (3 << 20) + 1], np.int64)
        futs += [b.get_bit_set("gr:g").set_async(big), b.get_bit_set("gr:h").get_async([(2 << 20) + 9, 3, 1 << 20]),
                 b.get_bit_set("gr:g").get_async(np.array([(3 << 20) + 1, (1 << 20) + 77, 6, 5 << 20])),
                 b.get_bit_set("gr:h").set_async([(2 << 20) + 9]), b.get_bit_set("gr:h").get_async([(2 << 20) + 9])]
        return futs, ["gr:g", "gr:h"]
    assert case == "out_of_range"
    futs += [b.get_bit_set("oor:a").set_async(idx(100)), b.get_bit_set("oor:bad").set_async([5, -1]),
             b.get_bit_set("oor:a").get_async(idx(100)), b.get_bit_set("oor:bad2").get_async([2**31 - 1]),
             b.get_bit_set("oor:c").set_async(idx(100)), b.get_bit_set("oor:c").get_async(idx(100))]
    return futs, ["oor:a", "oor:bad", "oor:bad2", "oor:c"]


BITSET_CASES = ["interleaved", "renamed", "value_false", "missing", "growth", "out_of_range"]


def _run_bitset_case(create, io, case, overlap):
    prev = io.set_overlap(overlap)
    try:
        c = create()
        try:
            b = c.create_batch()
            futs, names = _bitset_case(b, c, case, np.random.default_rng(BITSET_CASES.index(case)))
            try:
                b.execute()
            except ValueError:  # the out-of-range group's error, raised by the replies
                pass
            replies = []
            for f in futs:
                try:
                    replies.append(_norm(f.get()))
                except ValueError as e:
                    replies.append(("error", str(e)))
            return replies, [_record(c, n) for n in names]
        finally:
            c.shutdown()
    finally:
        io.set_overlap(prev)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("case", BITSET_CASES)
def test_bitset_runs_match_the_jax_batch(case, overlap, monkeypatch):
    """Runs of bit-set groups (many records set then read; one record named
    again; value False; missing records and empty groups; growth past
    1 MiB; an out-of-range group among valid ones): replies and records
    equal to the JAX Batch's, every level one bitset_groups call."""
    calls = []
    real = TK.bitset_groups
    monkeypatch.setattr(TK, "bitset_groups", lambda *a, **k: calls.append(len(a[0])) or real(*a, **k))
    want = _run_bitset_case(*PACKAGES["jax"][:2], case, overlap)
    got = _run_bitset_case(*PACKAGES["torch"][:2], case, overlap)
    assert got == want
    if case == "interleaved":
        assert calls == [12, 12]  # level 0: the 12 sets; level 1: the 12 gets
    if case == "out_of_range":
        assert [r[0] == "error" for r in got[0]] == [False, True, False, True, False, False]
