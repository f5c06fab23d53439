"""The port's BitSet programs (plain PyTorch route, CPU) against the JAX
package's on the same seeded numpy inputs, and BitSet and bucket-family op
streams through both create()s, final states included.

Planes, old bits and replies must be equal bit for bit; there is no float in
any of it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.core import kernels as JK
from redisson_tpu_torch import state
from redisson_tpu_torch.client.redisson import RedissonTpu as TorchClient
from redisson_tpu_torch.core import kernels as TK
from redisson_tpu_torch.ops import bittensor as bt

SIZE = 4096


def _plane(seed, fill=0.3):
    return (np.random.default_rng(seed).random(SIZE) < fill).astype(np.uint8)


def _indexes(seed, n):
    """Indexes in range, duplicates, negatives in [-SIZE, -1], and indexes
    outside the plane at both ends."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, SIZE, n).astype(np.int32)
    idx[n // 2 : n // 2 + n // 8] = idx[: n // 8]  # duplicates
    edge = [-1, -SIZE, -SIZE - 1, SIZE, SIZE - 1, 0, 2**31 - 1, -(2**31), 5, 5, -4091]
    idx[: len(edge)] = edge
    return idx


def _jax_set(plane, idx, n_valid, value):
    bits, old = JK.bitset_set(jnp.asarray(plane), jnp.asarray(idx), JK.valid_n(n_valid),
                              jnp.full(idx.shape, value, jnp.uint8))
    return np.asarray(bits), np.asarray(old)


@pytest.mark.parametrize("n", [1, 64, 1000])
def test_bitset_get_matches_reference(n):
    plane, idx = _plane(n), _indexes(n + 1, max(n, 16))[:n]
    got = TK.bitset_get(torch.from_numpy(plane.copy()), torch.from_numpy(idx))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(JK.bitset_get(jnp.asarray(plane), jnp.asarray(idx))))


@pytest.mark.parametrize("n_valid", [0, 1, 300, 512, 10**6])
@pytest.mark.parametrize("value", [0, 1])
def test_bitset_set_matches_reference(n_valid, value):
    """Every old bit is the pre-batch bit (duplicates both report it), masked
    ops read 0 and write nothing, negatives wrap once, the rest outside the
    plane are dropped."""
    plane, idx = _plane(n_valid + value), _indexes(7 * n_valid + value, 512)
    want_bits, want_old = _jax_set(plane, idx, n_valid, value)
    bits = torch.from_numpy(plane.copy())
    out_bits, old = TK.bitset_set(bits, torch.from_numpy(idx), n_valid, value)
    assert out_bits is bits and old.dtype == torch.uint8
    np.testing.assert_array_equal(old.numpy(), want_old)
    np.testing.assert_array_equal(bits.numpy(), want_bits)


def test_bitset_set_reports_pre_batch_bits_for_repeated_indexes():
    plane = np.zeros(SIZE, np.uint8)
    plane[5] = 1
    idx = np.array([5, 5, 9, 9, -1, 9], np.int32)
    want_bits, want_old = _jax_set(plane, idx, 6, 1)
    bits = torch.from_numpy(plane.copy())
    _, old = TK.bitset_set(bits, torch.from_numpy(idx), 6, 1)
    assert old.tolist() == want_old.tolist() == [1, 1, 0, 0, 0, 0]
    np.testing.assert_array_equal(bits.numpy(), want_bits)


@pytest.mark.parametrize("n_valid", [4001, 5000])
@pytest.mark.parametrize("value", [0, 1])
def test_bitset_set_repeats_far_apart_report_pre_batch_bits(n_valid, value):
    """A batch of 5,000 ops (past the card's one-block form) whose indexes
    repeat far apart (op i and op 4,000 + i): both report the pre-batch bit,
    whether the later op is masked or not."""
    rng = np.random.default_rng(value + n_valid)
    plane = _plane(n_valid + 3 * value)
    idx = rng.integers(-SIZE, SIZE, 5000).astype(np.int32)
    idx[4000:4100] = idx[:100]
    idx[4999] = idx[0]
    want_bits, want_old = _jax_set(plane, idx, n_valid, value)
    bits = torch.from_numpy(plane.copy())
    _, old = TK.bitset_set(bits, torch.from_numpy(idx), n_valid, value)
    np.testing.assert_array_equal(old.numpy(), want_old)
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    lanes = np.where(idx[:100] < 0, idx[:100] + SIZE, idx[:100])
    live = min(100, n_valid - 4000)
    np.testing.assert_array_equal(old.numpy()[4000:4000 + live], plane[lanes[:live]])
    assert not old.numpy()[n_valid:].any()


# -- the multi-plane table form (kernels.bitset_groups) -------------------------

# (plane size, ops, value: None reads): planes of different sizes, one past
# 1 MiB, one-op groups, a repeat-heavy group, both values
GROUPS = [(SIZE, 300, None), (SIZE + 3, 1, 1), ((1 << 20) + 4096, 700, 1), (100, 50, 0), (SIZE, 1, None),
          (2 * SIZE, 400, 0), (7, 20, None)]


def _groups(seed):
    rng = np.random.default_rng(seed)
    planes, idx, values = [], [], []
    for size, n, value in GROUPS:
        planes.append((rng.random(size) < 0.4).astype(np.uint8))
        a = rng.integers(-2 * size, 2 * size, n).astype(np.int32)  # negative and out-of-plane
        a[n // 2:] = a[: n - n // 2]  # repeats
        idx.append(a)
        values.append(value)
    return planes, idx, values


@pytest.mark.parametrize("seed", [0, 1])
def test_bitset_groups_plain_matches_the_jax_programs_plane_by_plane(seed):
    """bitset_groups on CPU planes (its plain version) against a loop of the
    JAX package's bitset_get / bitset_set, one plane at a time: replies in
    group order and every plane, bit for bit."""
    planes, idx, values = _groups(seed)
    tp = [torch.from_numpy(p.copy()) for p in planes]
    out, firsts = TK.bitset_groups(tp, idx, values)
    assert firsts == list(np.cumsum([0] + [a.size for a in idx])[:-1])
    for p, a, v, t, f in zip(planes, idx, values, tp, firsts):
        if v is None:
            want_bits, want = p, np.asarray(JK.bitset_get(jnp.asarray(p), jnp.asarray(a)))
        else:
            want_bits, want = _jax_set(p, a, a.size, v)
        np.testing.assert_array_equal(out.numpy()[f:f + a.size], want)
        np.testing.assert_array_equal(t.numpy(), want_bits)


def _model_launches(buf, n_groups, total, planes, n_get_groups, n_get):
    """csrc/bitset.cu's two table launches, modelled in numpy on the packed
    upload: the plane of a group is planes[its address]; each op finds its
    group by its uploaded id and checks it lies in that group's ops."""
    table = buf[: TK.BITSET_GROUP_WORDS * n_groups].view(np.int64).reshape(n_groups, 4)
    ops = buf[TK.BITSET_GROUP_WORDS * n_groups:][:total]
    gids = buf[TK.BITSET_GROUP_WORDS * n_groups:][total:]
    out = np.zeros(total, np.uint8)
    writes = []
    for base, lo, hi in ((0, 0, n_get), (n_get_groups, n_get, total)):
        for i in range(lo, hi):
            addr, size, fc, vv = (int(x) for x in table[base + gids[i]])
            first, count, valid, value = fc & 0xFFFFFFFF, fc >> 32, vv & 0xFFFFFFFF, vv >> 32
            t = i - lo - first
            assert 0 <= t < count and valid == count
            j = int(ops[i]) + size if ops[i] < 0 else int(ops[i])
            if 0 <= j < size:
                out[i] = planes[addr][j]
                if base:
                    writes.append((addr, j, value))
    for addr, j, value in writes:  # every read of a set launch before its writes
        planes[addr][j] = value
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_bitset_pack_drives_the_kernels_model_like_the_plain_version(seed):
    """bitset_pack's table, indexes and group ids, read back by a numpy
    model of the kernels: the same replies (at the firsts it reports) and
    planes as the plain version; gets before sets in the upload."""
    planes, idx, values = _groups(seed)
    want_planes = [torch.from_numpy(p.copy()) for p in planes]
    want, _ = TK.bitset_groups(want_planes, idx, values)
    total = sum(a.size for a in idx)
    buf = np.zeros(TK.BITSET_GROUP_WORDS * len(planes) + 2 * total, np.int32)
    firsts, n_get_groups, n_get, max_set = TK.bitset_pack(buf, [(g, p.size) for g, p in enumerate(planes)],
                                                          idx, values)
    assert n_get_groups == sum(v is None for v in values)
    assert n_get == sum(a.size for a, v in zip(idx, values) if v is None)
    assert max_set == max(a.size for a, v in zip(idx, values) if v is not None)
    model = [p.copy() for p in planes]
    got = _model_launches(buf, len(planes), total, model, n_get_groups, n_get)
    for a, f, g in zip(idx, firsts, range(len(idx))):
        w0 = int(np.cumsum([0] + [x.size for x in idx])[g])
        np.testing.assert_array_equal(got[f:f + a.size], want.numpy()[w0:w0 + a.size])
    for m, w in zip(model, want_planes):
        np.testing.assert_array_equal(m, w.numpy())


def test_bitset_groups_refuses_bad_tables():
    p = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError):
        TK.bitset_groups([], [], [])
    with pytest.raises(ValueError):
        TK.bitset_groups([p], [np.zeros(2, np.int32)], [None, 1])
    with pytest.raises(ValueError):
        TK.bitset_groups([p, p], [np.zeros(1, np.int32)], [None, None])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bittensor_ops_match_reference(seed):
    from redisson_tpu.ops import bittensor as jbt

    a, b = _plane(seed, 0.4), _plane(seed + 10, 0.6)
    ta, tb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    nbits = SIZE - 100 - seed
    for jf, tf in ((jbt.bit_and, bt.bit_and), (jbt.bit_or, bt.bit_or), (jbt.bit_xor, bt.bit_xor)):
        np.testing.assert_array_equal(tf(ta, tb).numpy(), np.asarray(jf(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(bt.bit_not(ta, nbits).numpy(), np.asarray(jbt.bit_not(jnp.asarray(a), nbits)))
    for value in (0, 1):
        assert TK.bitset_bitpos(ta, value, nbits) == int(JK.bitset_bitpos(jnp.asarray(a), value, nbits))
    assert TK.bitset_popcount(ta, nbits) == int(JK.bitset_popcount(jnp.asarray(a), nbits))
    assert TK.bitset_length(ta) == int(JK.bitset_length(jnp.asarray(a)))
    zero = np.zeros(SIZE, np.uint8)
    assert TK.bitset_length(torch.from_numpy(zero)) == int(JK.bitset_length(jnp.asarray(zero))) == 0
    assert TK.bitset_bitpos(torch.from_numpy(zero), 1, nbits) == int(JK.bitset_bitpos(jnp.asarray(zero), 1, nbits))


# -- object streams through both create()s --------------------------------------


@pytest.fixture()
def clients():
    j = redisson_tpu.create()
    t = redisson_tpu_torch.create(device="cpu")
    yield j, t
    j.shutdown()
    t.shutdown()


def _record(client, name):
    rec = client.engine.store.get(name)
    if isinstance(client, TorchClient):
        return state.to_reference(rec)
    return rec.kind, dict(rec.meta), {k: np.asarray(v) for k, v in rec.arrays.items()}, rec.host


def _same_record(j, t, name):
    jk, jm, ja, jh = _record(j, name)
    tk, tm, ta, th = _record(t, name)
    assert (jk, jm, jh) == (tk, tm, th)
    assert ja.keys() == ta.keys()
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k])


def _norm(v):
    if isinstance(v, np.ndarray):
        return v.dtype.str, v.tolist()
    return v


def _bitset_stream(c):
    rng = np.random.default_rng(3)
    out = []
    a = c.get_bit_set("bs:a")
    out.append(a.set(7))
    out.append(a.set(7))
    out.append(a.get(7))
    out.append(a.clear_bit(7))
    idx = rng.integers(0, 50_000, 600)
    out.append(_norm(a.set_each(idx)))
    out.append(_norm(a.set_each(idx[:100], False)))
    out.append(_norm(a.get_each(np.concatenate([idx, idx[:7] + 1]))))
    out.append(_norm(a.get_each(np.zeros(0, np.int64))))
    a.set_range(100, 140)
    out += [a.cardinality(), a.length(), a.size(), a.bitpos(True), a.bitpos(False)]
    out.append(a.set((1 << 20) + 5))  # past the default plane: grows by doubling
    out += [a.size(), a.length()]
    b = c.get_bit_set("bs:b")
    b.set_each(rng.integers(0, 3_000_000, 300))
    a.or_("bs:b")
    out += [a.cardinality(), a.size()]
    a.and_("bs:b", "bs:missing")
    out.append(a.cardinality())
    b.xor("bs:a")
    b.not_()
    out += [b.cardinality(), b.bitpos(False)]
    data = b.to_byte_array()
    out.append(len(data))
    d = c.get_bit_set("bs:d")
    d.from_byte_array(data[:1000])
    out += [d.cardinality(), d.length()]
    with pytest.raises(ValueError):
        a.set_each(np.array([-1]))
    with pytest.raises(ValueError):
        a.get_each(np.array([2**31]))
    e = c.get_bit_set("bs:empty")
    out += [e.cardinality(), e.length(), e.size(), e.bitpos(True), e.bitpos(False),
            e.to_byte_array(), _norm(e.get_each(np.arange(3)))]
    return out


def test_bitset_stream_matches_reference(clients):
    j, t = clients
    assert _bitset_stream(j) == _bitset_stream(t)
    for name in ("bs:a", "bs:b", "bs:d"):
        _same_record(j, t, name)


def _bucket_stream(c):
    out = []
    b = c.get_bucket("bk:a")
    out.append(b.get())
    b.set({"x": [1, 2]})
    out += [b.get(), b.size(), b.get_and_set("two"), b.try_set("no"), b.set_if_exists("three"),
            b.compare_and_set("three", 4), b.compare_and_set("zz", 5), b.get()]
    b.set_and_keep_ttl(9)
    out += [b.get_and_expire(100), b.remain_time_to_live() is not None, b.get_and_clear_expire(),
            b.remain_time_to_live()]
    n = c.get_bucket("bk:new")
    out += [n.set_if_exists(1), n.try_set("first"), n.set_if_absent("second"), n.get()]
    out.append(c.get_bucket("bk:gone").get_and_delete())
    bs = c.get_buckets()
    bs.set({"bk:m1": 1, "bk:m2": "two"})
    out += [bs.get("bk:m1", "bk:m2", "bk:none"), bs.try_set({"bk:m2": 0, "bk:m3": 3}),
            bs.try_set({"bk:m3": 3, "bk:m4": 4}), bs.get("bk:m3", "bk:m4")]
    al = c.get_atomic_long("al")
    out += [al.get(), al.increment_and_get(), al.add_and_get(41), al.get_and_add(-2),
            al.decrement_and_get(), al.get_and_increment(), al.get_and_decrement(),
            al.compare_and_set(40, 7), al.compare_and_set(1, 2), al.get_and_set(11), al.get()]
    ad = c.get_atomic_double("ad")
    out += [ad.add_and_get(1.5), ad.get_and_add(0.25), ad.get(), ad.compare_and_set(1.75, 3)]
    out.append(c.get_atomic_long("al:del").get_and_delete())
    g = c.get_id_generator("ids")
    out += [g.try_init(100, 3), g.try_init(0, 1)]
    out += [g.next_id() for _ in range(7)]
    g2 = c.get_id_generator("ids")
    out += [g2.next_id() for _ in range(2)]
    out.append([g.next_id() for _ in range(3)] == [g.next_id() - 3 + i for i in range(3)])
    return out


def test_bucket_family_stream_matches_reference(clients):
    j, t = clients
    assert _bucket_stream(j) == _bucket_stream(t)
    for name in ("bk:a", "bk:new", "bk:m1", "bk:m2", "bk:m3", "bk:m4", "al", "ad", "ids"):
        _same_record(j, t, name)


def test_bitset_and_bucket_state_carried_from_the_reference(clients):
    """Records built by the JAX package, carried across by from_reference,
    then the same ops on both."""
    j, t = clients
    j.get_bit_set("cs:bits").set_each(np.arange(0, 3000, 7))
    j.get_bucket("cs:b").set("v")
    j.get_atomic_long("cs:n").add_and_get(5)
    for name in ("cs:bits", "cs:b", "cs:n"):
        t.engine.store.put(name, state.from_reference(*_record(j, name)[:3], "cpu", _record(j, name)[3]))
        _same_record(j, t, name)
    for c in clients:
        c.get_bit_set("cs:bits").set_each(np.arange(1, 3000, 11))
        c.get_atomic_long("cs:n").add_and_get(2)
    assert _norm(j.get_bit_set("cs:bits").get_each(np.arange(40))) == \
        _norm(t.get_bit_set("cs:bits").get_each(np.arange(40)))
    assert j.get_bucket("cs:b").get() == t.get_bucket("cs:b").get() == "v"
    for name in ("cs:bits", "cs:n"):
        _same_record(j, t, name)
