"""One op stream through redisson_tpu.create() and through
redisson_tpu_torch.create(device="cpu"): every reply and the final planes and
register banks (read through state.to_reference) must be equal.  Estimates
are float32 and agree to a relative 1e-6 (see tests/test_torch_kernels.py);
PFCOUNT integers must be identical."""
import time

import numpy as np
import pytest
import torch

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu_torch import state

EST_RTOL = 1e-6


@pytest.fixture()
def clients():
    j = redisson_tpu.create()
    t = redisson_tpu_torch.create(device="cpu")
    yield j, t
    j.shutdown()
    t.shutdown()


def _state(client, name):
    """(kind, meta, numpy arrays, host value) of a record of either package."""
    rec = client.engine.store.get(name)
    if isinstance(client, redisson_tpu.client.redisson.RedissonTpu):
        return rec.kind, dict(rec.meta), {k: np.asarray(v) for k, v in rec.arrays.items()}, rec.host
    return state.to_reference(rec)


def _same_state(j, t, name):
    jk, jm, ja, jh = _state(j, name)
    tk, tm, ta, th = _state(t, name)
    assert (jk, jm, jh) == (tk, tm, th)
    assert ja.keys() == ta.keys()
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k])


def _both(j, t, fn):
    """Run fn on both clients; return (reference reply, port reply)."""
    return fn(j), fn(t)


def _eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind == "b"
        np.testing.assert_array_equal(b, a)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        assert a == b


def _eq_est(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(b, a, rtol=EST_RTOL, atol=0)
    assert [round(float(x)) for x in a] == [round(float(x)) for x in b]


def _tenant_of(keys, tenants):
    return ((keys * 40503) % tenants).astype(np.int32)


def _bank_stream(j, t, name, rng, tenants=16):
    """Populate through a window (a repeated flush object included), then
    single-flush adds and contains, sync and windowed."""
    keys = np.arange(0, 40_000, dtype=np.int64) * 2654435761
    flushes = [(_tenant_of(keys[i:i + 8000], tenants), keys[i:i + 8000]) for i in range(0, 40_000, 8000)]
    flushes.insert(2, flushes[0])  # same objects twice: composed on the device
    flushes.append((flushes[1][0][:333], flushes[1][1][:333]))  # a short flush: repeat-padded
    _eq(*_both(j, t, lambda c: c.get_bloom_filter_array(name).add_flushes(flushes)))
    present = rng.choice(keys, 5000)
    absent = rng.integers(1 << 50, 1 << 60, 5000)
    q = np.where(np.arange(10_000) % 2 == 0, present[:10_000 // 2].repeat(2), absent.repeat(2)[:10_000])
    qt = _tenant_of(q, tenants)
    found = _both(j, t, lambda c: c.get_bloom_filter_array(name).contains(qt, q))
    _eq(*found)
    assert found[1][0::2].all()  # no false negatives
    _eq(*_both(j, t, lambda c: c.get_bloom_filter_array(name).contains(qt, q)))  # cached query buffer
    more = rng.integers(-(2**63), 2**63 - 1, 3000)
    mt = _tenant_of(np.abs(more), tenants)
    _eq(*_both(j, t, lambda c: c.get_bloom_filter_array(name).add_each(mt, more)))
    _eq(*_both(j, t, lambda c: c.get_bloom_filter_array(name).add(mt[:1000], more[:1000] + 1)))
    window = [(qt, q), (mt, more), (qt, q)]
    _eq(*_both(j, t, lambda c: c.get_bloom_filter_array(name).contains_flushes(window)))
    _eq(*_both(j, t, lambda c: c.get_bloom_filter_array(name).tenant_bit_counts()))
    _same_state(j, t, name)


def test_bloom_bank_stream(clients):
    j, t = clients
    for c in clients:
        assert c.get_bloom_filter_array("bank").try_init(16, 10_000, 0.01)
        assert not c.get_bloom_filter_array("bank").try_init(16, 10_000, 0.01)
    _eq(*_both(j, t, lambda c: (c.get_bloom_filter_array("bank").get_size(),
                                c.get_bloom_filter_array("bank").get_hash_iterations())))
    _bank_stream(j, t, "bank", np.random.default_rng(0))
    for c in clients:
        c.get_bloom_filter_array("bank").clear_tenant(3)
    _same_state(j, t, "bank")


def test_bloom_bank_invalid_tenant_ids(clients):
    """Tenant ids outside [0, T) give what the JAX package gives: negative ids
    count from the end once, others read as present and write nothing."""
    j, t = clients
    for c in clients:
        c.get_bloom_filter_array("b").try_init(4, 1000, 0.01)
    ids = np.array([-1, -4, -5, 4, 5, 2**31 - 1, -(2**31), 0, 3], np.int32)
    keys = np.arange(len(ids), dtype=np.int64) + 11
    _eq(*_both(j, t, lambda c: c.get_bloom_filter_array("b").add_each(ids, keys)))
    _eq(*_both(j, t, lambda c: c.get_bloom_filter_array("b").contains(ids, keys + 1)))
    _same_state(j, t, "b")


def test_bloom_filter_stream(clients):
    j, t = clients
    for c in clients:
        assert c.get_bloom_filter("f").try_init(10_000, 0.01)
    keys = np.arange(5000, dtype=np.int64) * 31 - 70_000
    _eq(*_both(j, t, lambda c: c.get_bloom_filter("f").add_all(keys)))
    _eq(*_both(j, t, lambda c: c.get_bloom_filter("f").add_each(keys[:300])))
    objs = ["alpha", "beta", "alpha", 17, 2.5, {"k": [1, 2]}, "", "x" * 40]
    _eq(*_both(j, t, lambda c: c.get_bloom_filter("f").add_all(objs)))
    _eq(*_both(j, t, lambda c: c.get_bloom_filter("f").add_each(["gamma", "alpha"])))
    _eq(*_both(j, t, lambda c: c.get_bloom_filter("f").contains_each(objs + ["nope", 18])))
    _eq(*_both(j, t, lambda c: c.get_bloom_filter("f").contains_each(np.arange(-70_000, -60_000, dtype=np.int64))))
    _eq(*_both(j, t, lambda c: [c.get_bloom_filter("f").contains(o) for o in ("alpha", "zeta", 17)]))
    _eq(*_both(j, t, lambda c: c.get_bloom_filter("f").count_contains(["alpha", "zeta"])))
    _eq(*_both(j, t, lambda c: c.get_bloom_filter("f").count()))
    _eq(*_both(j, t, lambda c: (c.get_bloom_filter("f").get_size(), c.get_bloom_filter("f").get_hash_iterations())))
    _same_state(j, t, "f")


def test_bloom_filter_string_codec(clients):
    from redisson_tpu.client.codec import StringCodec as JString
    from redisson_tpu_torch.client.codec import StringCodec as TString

    j, t = clients
    fj, ft = j.get_bloom_filter("s", JString()), t.get_bloom_filter("s", TString())
    for f in (fj, ft):
        f.try_init(1000, 0.03)
    words = [f"w{i}" for i in range(200)]
    _eq(fj.add_all(words), ft.add_all(words))
    _eq(fj.contains_each(words[::3] + ["w999"]), ft.contains_each(words[::3] + ["w999"]))
    _same_state(j, t, "s")


def test_hll_array_stream(clients):
    j, t = clients
    rng = np.random.default_rng(7)
    for c in clients:
        assert c.get_hyper_log_log_array("h").try_init(64)
    for _ in range(3):
        ids = rng.integers(0, 64, 30_000).astype(np.int32)
        keys = rng.integers(0, 1 << 60, 30_000)
        for c in clients:
            c.get_hyper_log_log_array("h").add(ids, keys)
    _same_state(j, t, "h")
    # duplicate dsts: three rounds, each reading sources from the pre-call bank
    dst, src = [0, 0, 0, 1, 5, 9], [1, 2, 3, 0, 0, 63]
    for c in clients:
        c.get_hyper_log_log_array("h").merge_rows(dst, src)
    _same_state(j, t, "h")
    for c in clients:
        c.get_hyper_log_log_array("h").merge_rows(np.arange(0, 64, 2), np.arange(1, 64, 2))
    _same_state(j, t, "h")
    _eq_est(*_both(j, t, lambda c: c.get_hyper_log_log_array("h").estimate_all()))
    _eq_est(*_both(j, t, lambda c: c.get_hyper_log_log_array("h").estimate_union_pairs([0, 1, 63], [2, 2, 0])))
    for c in clients:
        with pytest.raises(ValueError):
            c.get_hyper_log_log_array("h").merge_rows([64], [0])


def test_hyperloglog_stream(clients):
    j, t = clients
    for c in clients:
        c.get_hyper_log_log("a").add_all([f"user:{i}" for i in range(3000)])
        c.get_hyper_log_log("a").add_all(np.arange(100_000, dtype=np.int64))
        c.get_hyper_log_log("b").add_all(np.arange(50_000, 150_000, dtype=np.int64))
        c.get_hyper_log_log("b").add(b"raw-bytes")
        c.get_hyper_log_log("c").create_if_absent()
    _eq(*_both(j, t, lambda c: [c.get_hyper_log_log(n).count() for n in ("a", "b", "c", "missing")]))
    _eq(*_both(j, t, lambda c: c.get_hyper_log_log("a").count_with("b", "c", "missing")))
    for c in clients:
        c.get_hyper_log_log("c").merge_with("a", "b", "c", "missing")
    _eq(*_both(j, t, lambda c: c.get_hyper_log_log("c").count()))
    for name in ("a", "b", "c"):
        _same_state(j, t, name)


def test_state_carried_from_the_reference(clients):
    """Both packages start from a JAX-built state carried across by
    from_reference, then run the same ops."""
    j, t = clients
    j.get_bloom_filter_array("bank").try_init(16, 10_000, 0.01)
    keys = np.arange(20_000, dtype=np.int64) * 977
    j.get_bloom_filter_array("bank").add(_tenant_of(keys, 16), keys)
    j.get_hyper_log_log_array("h").try_init(8)
    j.get_hyper_log_log_array("h").add(np.arange(5000, dtype=np.int32) % 8, np.arange(5000, dtype=np.int64))
    for name in ("bank", "h"):
        kind, meta, arrays, host = _state(j, name)
        t.engine.store.put(name, state.from_reference(kind, meta, arrays, "cpu", host))
        _same_state(j, t, name)
    _bank_stream(j, t, "bank", np.random.default_rng(1))
    for c in clients:
        c.get_hyper_log_log_array("h").add(np.arange(900, dtype=np.int32) % 8, np.arange(900, dtype=np.int64) + 7)
        c.get_hyper_log_log_array("h").merge_rows([1, 1], [2, 3])
    _same_state(j, t, "h")
    _eq_est(*_both(j, t, lambda c: c.get_hyper_log_log_array("h").estimate_all()))


def test_window_layout_matches_the_reference(clients):
    """Padding: a flush's slack repeats its last entry, and repeated flush
    objects are composed on the device into the same layout."""
    j, t = clients
    for c in clients:
        c.get_bloom_filter_array("w").try_init(4, 1000, 0.01)
    rng = np.random.default_rng(3)
    f1 = (rng.integers(0, 4, 300).astype(np.int32), rng.integers(0, 2**62, 300))
    f2 = (rng.integers(0, 4, 17).astype(np.int32), rng.integers(0, 2**62, 17))
    for window in ([f1, f2], [f1, f2, f1]):
        jb, jbb, jl = j.get_bloom_filter_array("w")._pack_flush_window(window)
        tb, tbb, tl = t.get_bloom_filter_array("w")._pack_flush_window(window)
        assert (jbb, jl) == (tbb, tl)
        np.testing.assert_array_equal(tb.numpy().view(np.uint32), np.asarray(jb))


def test_query_buffers_are_never_written(clients):
    """A cached query buffer keeps its bytes across dispatches."""
    _, t = clients
    bank = t.get_bloom_filter_array("q")
    bank.try_init(4, 1000, 0.01)
    keys = np.arange(5000, dtype=np.int64)
    ids = (keys % 4).astype(np.int32)
    bank.add(ids, keys)
    first = bank.contains(ids, keys)
    cached = list(t.engine.query_cache._entries.values())
    assert len(cached) == 1
    snapshot = cached[0].clone()
    bank.add(ids, keys + 1)
    assert (bank.contains(ids, keys) == first).all()
    assert torch.equal(cached[0], snapshot)


def test_object_lifecycle(clients):
    for c in clients:
        bf = c.get_bloom_filter("life")
        bf.try_init(100, 0.01)
        assert bf.is_exists() and bf.touch()
        assert bf.remain_time_to_live() is None
        assert bf.expire_if_not_set(100) and not bf.expire_if_not_set(100)
        assert 0 < bf.remain_time_to_live() <= 100
        assert bf.expire_if_less(50) and not bf.expire_if_greater(10)
        assert bf.clear_expire() and bf.remain_time_to_live() is None
        bf.rename("life2")
        assert bf.name == "life2" and not c.get_bloom_filter("life").is_exists()
        assert bf.expire_at(time.time() - 1)
        assert not bf.is_exists()  # expired reads as absent
        h = c.get_hyper_log_log("gone")
        h.add("x")
        assert h.delete() and not h.delete() and h.count() == 0

