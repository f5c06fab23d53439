"""Each device program of the port's sketch path (plain PyTorch route, CPU)
against the JAX program it replaces, on the same inputs.

Planes, registers, flags, bitmaps and counts must be equal bit for bit.
Estimates are float32 and agree to a relative 1e-6: the JAX program sums
float32 exp2(-r) terms in its backend's order with its backend's float32
exp2 and log, and XLA:CPU's float32 exp2 is not exact even for integer r,
while the port sums the exact powers of two in float64 and rounds each log
once.  So the PFCOUNT integer (the rounded estimate) can differ from the one
XLA:CPU gives once estimates pass about 1e5 (at p = 14, 6 of 218 rows in
[1e5, 1e6), 35 of 211 in [1e6, 1e7) and 201 of 455 at 1e7 and above, in a
probe of register states drawn over 1 to 1e9; PERF.md section 2).  The
counters these tests build stay below 1e5, and there the integers are
checked equal too.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu.core import kernels as JK
from redisson_tpu.utils import hashing as JH
from redisson_tpu_torch.core import kernels as TK

T, W, B, K_HASH = 4, 1024, 256, 7
P = 10  # HLL precision for the small banks (m = 1024)
EST_RTOL = 1e-6


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def _np(x):
    """JAX result -> numpy; the port's result -> numpy with uint32 bitmaps."""
    if isinstance(x, torch.Tensor):
        a = x.numpy()
        return a.view(np.uint32) if a.dtype == np.int32 and a.ndim == 1 and x.numel() <= B // 32 else a
    return np.asarray(x)


def _keys_hitting(col, m, k=K_HASH, want=8):
    """Keys one of whose k probes lands on column `col` of an m-wide row."""
    cand = np.arange(1, 400_000, dtype=np.int64) * 7919
    lo, hi = JH.int_keys_to_u32_pair(cand)
    idx = JH.bloom_indexes(*JH.hash_u64_pair(lo, hi, np), k, m, np)
    hits = cand[(idx == col).any(axis=1)]
    assert len(hits) >= want
    return hits[:want]


def _bank_case(name):
    """(plane (T, W) u8, tenant (B,) int32, keys (B,) int64, n_valid, m)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    plane = (rng.random((T, W)) < 0.5).astype(np.uint8)
    n = 200
    tenant = rng.integers(0, T, B).astype(np.int32)
    keys = rng.integers(-(2**63), 2**63 - 1, B, dtype=np.int64)
    keys[n:] = 0
    tenant[n:] = 0
    m = W
    if name == "n_valid_0":
        n = 0
    elif name == "duplicates":
        keys[100:200] = keys[:100]
        tenant[100:200] = tenant[:100]
    elif name == "last_column":
        plane[:] = 1
        plane[:, W - 1] = 0
        keys[:8] = _keys_hitting(W - 1, m)
    elif name == "last_tenant":
        tenant[:n] = T - 1
    elif name == "bad_tenants":
        # negative ids count from the end once; ids whose int32 product
        # tenant*W wraps land back inside the plane (2**22 * 1024 = 2**32)
        bad = [-1, -T, -T - 1, T, T + 1, 2**31 - 1, -(2**31), 2**22, 2**22 + 1, -(2**22) + 2]
        tenant[: len(bad)] = bad
    elif name == "stacked_width":
        m = W - 100  # hash domain narrower than the physical row
    return plane, tenant, keys, n, m


BANK_CASES = ["random", "n_valid_0", "duplicates", "last_column", "last_tenant", "bad_tenants",
              "stacked_width"]


def _tlh(tenant, keys):
    lo, hi = JH.int_keys_to_u32_pair(keys)
    return np.stack([tenant.view(np.uint32), lo, hi])


BANK_FORMS = {
    "add": ("bloom_bank_add_packed", True),
    "add_count": ("bloom_bank_add_packed_count", True),
    "add_bits": ("bloom_bank_add_packed_bits", True),
    "contains": ("bloom_bank_contains_packed", False),
    "contains_bits": ("bloom_bank_contains_packed_bits", False),
}


@pytest.mark.parametrize("case", BANK_CASES)
@pytest.mark.parametrize("form", list(BANK_FORMS))
def test_bloom_bank_packed(form, case):
    name, mutates = BANK_FORMS[form]
    plane, tenant, keys, n, m = _bank_case(case)
    tlh = _tlh(tenant, keys)
    j = getattr(JK, name)(jnp.asarray(plane), jnp.asarray(tlh), n, K_HASH, m)
    tp = _t(plane)
    t = getattr(TK, name)(tp, _t(tlh), n, K_HASH, m)
    if mutates:
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(_np(t[1]), _np(j[1]))
        assert t[0] is tp  # updated in place
    else:
        np.testing.assert_array_equal(_np(t), _np(j))
        np.testing.assert_array_equal(tp.numpy(), plane)  # a probe writes nothing


@pytest.mark.parametrize("case", ["random", "duplicates", "bad_tenants"])
@pytest.mark.parametrize("name", ["bloom_bank_add_u64", "bloom_bank_contains_u64"])
def test_bloom_bank_unpacked(name, case):
    plane, tenant, keys, n, m = _bank_case(case)
    lo, hi = JH.int_keys_to_u32_pair(keys)
    j = getattr(JK, name)(jnp.asarray(plane), jnp.asarray(tenant), jnp.asarray(lo), jnp.asarray(hi), n, K_HASH, m)
    t = getattr(TK, name)(_t(plane), _t(tenant), _t(lo), _t(hi), n, K_HASH, m)
    for a, b in zip(t if isinstance(t, tuple) else (t,), j if isinstance(j, tuple) else (j,)):
        np.testing.assert_array_equal(_np(a), _np(b))


def _single_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    m = 3000
    size = 3072  # padded_size(3000)
    plane = (rng.random(size) < 0.5).astype(np.uint8)
    plane[m:] = 0
    keys = rng.integers(-(2**63), 2**63 - 1, B, dtype=np.int64)
    n = 230
    if name == "n_valid_0":
        n = 0
    elif name == "duplicates":
        keys[115:230] = keys[:115]
    elif name == "last_column":
        plane[:m] = 1
        plane[m - 1] = 0
        keys[:8] = _keys_hitting(m - 1, m)
    return plane, keys, n, m


SINGLE_CASES = ["random", "n_valid_0", "duplicates", "last_column"]
SINGLE_FORMS = ["bloom_add_packed", "bloom_add_packed_count", "bloom_contains_packed",
                "bloom_contains_packed_bits", "bloom_add_u64_masked", "bloom_contains_u64_masked"]


@pytest.mark.parametrize("case", SINGLE_CASES)
@pytest.mark.parametrize("name", SINGLE_FORMS)
def test_bloom_single_u64(name, case):
    plane, keys, n, m = _single_case(case)
    lo, hi = JH.int_keys_to_u32_pair(keys)
    if name.endswith("_masked"):
        j = getattr(JK, name)(jnp.asarray(plane), jnp.asarray(lo), jnp.asarray(hi), n, K_HASH, m)
        t = getattr(TK, name)(_t(plane), _t(lo), _t(hi), n, K_HASH, m)
    else:
        lh = np.stack([lo, hi])
        j = getattr(JK, name)(jnp.asarray(plane), jnp.asarray(lh), n, K_HASH, m)
        t = getattr(TK, name)(_t(plane), _t(lh), n, K_HASH, m)
    for a, b in zip(t if isinstance(t, tuple) else (t,), j if isinstance(j, tuple) else (j,)):
        np.testing.assert_array_equal(_np(a), _np(b))


def _byte_keys(seed, n=100, w=8):
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(int(x)) for x in rng.integers(0, 18, n)]
    keys[:3] = [b"", b"abcd", keys[3]]  # empty, exact word, and a duplicate
    words, nbytes = JH.pack_keys(keys)
    return np.pad(words, ((0, w - words.shape[0]), (0, 128 - n))), np.pad(nbytes, (0, 128 - n))


@pytest.mark.parametrize("n_valid", [0, 57, 100])
@pytest.mark.parametrize("name", ["bloom_add_bytes_masked", "bloom_contains_bytes_masked"])
def test_bloom_single_bytes(name, n_valid):
    plane, _, _, m = _single_case("random")
    words, nbytes = _byte_keys(n_valid)
    j = getattr(JK, name)(jnp.asarray(plane), jnp.asarray(words), jnp.asarray(nbytes), n_valid, K_HASH, m)
    t = getattr(TK, name)(_t(plane), _t(words), _t(nbytes), n_valid, K_HASH, m)
    for a, b in zip(t if isinstance(t, tuple) else (t,), j if isinstance(j, tuple) else (j,)):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("n_add,n_probe", [(0, 200), (200, 0), (150, 230)])
@pytest.mark.parametrize("name", ["bloom_fused_add_contains", "bloom_fused_add_contains_bits"])
def test_bloom_fused_add_contains(name, n_add, n_probe):
    """The probes see the adds: probing the added keys finds all of them."""
    plane, keys, _, m = _single_case("random")
    add = np.stack(JH.int_keys_to_u32_pair(keys))
    probe = np.stack(JH.int_keys_to_u32_pair(np.concatenate([keys[:128], keys[::-1][:128] + 1])))
    j = getattr(JK, name)(jnp.asarray(plane), jnp.asarray(add), n_add, jnp.asarray(probe), n_probe, K_HASH, m)
    t = getattr(TK, name)(_t(plane), _t(add), n_add, _t(probe), n_probe, K_HASH, m)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_window_from_unique():
    uniq = np.random.default_rng(0).integers(0, 2**32, (3, 3, 64), dtype=np.uint64).astype(np.uint32)
    idx = np.array([0, 2, 2, 1, 0], np.int32)
    j = JK.window_from_unique(jnp.asarray(uniq), jnp.asarray(idx))
    t = TK.window_from_unique(_t(uniq), torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j))


# -- HLL ---------------------------------------------------------------------

def _hll_bank(seed):
    return np.random.default_rng(seed).integers(0, 9, (T, 1 << P)).astype(np.uint8)


@pytest.mark.parametrize("case", ["random", "n_valid_0", "duplicates", "last_tenant", "bad_tenants"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "u64"])
def test_hll_bank_add(packed, case):
    _, tenant, keys, n, _ = _bank_case(case)
    regs = _hll_bank(1)
    lo, hi = JH.int_keys_to_u32_pair(keys)
    if packed:
        tlh = _tlh(tenant, keys)
        j = JK.hll_bank_add_packed(jnp.asarray(regs), jnp.asarray(tlh), n, P)
        t = TK.hll_bank_add_packed(_t(regs), _t(tlh), n, P)
    else:
        j = JK.hll_bank_add_u64(jnp.asarray(regs), jnp.asarray(tenant), jnp.asarray(lo), jnp.asarray(hi), n, P)
        t = TK.hll_bank_add_u64(_t(regs), _t(tenant), _t(lo), _t(hi), n, P)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("n_valid", [0, 100, 256])
@pytest.mark.parametrize("form", ["packed", "u64", "bytes"])
def test_hll_single_add(form, n_valid):
    regs = _hll_bank(2)[0]
    keys = np.random.default_rng(3).integers(-(2**63), 2**63 - 1, B, dtype=np.int64)
    keys[128:] = keys[:128]
    lo, hi = JH.int_keys_to_u32_pair(keys)
    if form == "packed":
        lh = np.stack([lo, hi])
        j = JK.hll_add_packed(jnp.asarray(regs), jnp.asarray(lh), n_valid, P)
        t = TK.hll_add_packed(_t(regs), _t(lh), n_valid, P)
    elif form == "u64":
        j = JK.hll_add_u64(jnp.asarray(regs), jnp.asarray(lo), jnp.asarray(hi), n_valid, P)
        t = TK.hll_add_u64(_t(regs), _t(lo), _t(hi), n_valid, P)
    else:
        words, nbytes = _byte_keys(n_valid)
        n_valid = min(n_valid, 128)
        j = JK.hll_add_bytes(jnp.asarray(regs), jnp.asarray(words), jnp.asarray(nbytes), n_valid, P)
        t = TK.hll_add_bytes(_t(regs), _t(words), _t(nbytes), n_valid, P)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_hll_bank_merge_map_is_out_of_place():
    regs = _hll_bank(4)
    src_map = np.array([2, 1, 0, 2], np.int32)  # two rows take row 2; row 2 takes row 0
    j = JK.hll_bank_merge_map(jnp.asarray(regs), jnp.asarray(src_map))
    before = _t(regs)
    t = TK.hll_bank_merge_map(before, _t(src_map))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(before.numpy(), regs)  # the input bank is untouched


def test_hll_bank_merge_map_from_reads_the_snapshot():
    regs, snap = _hll_bank(5), _hll_bank(6)
    src_map = np.array([3, 3, 1, 0], np.int32)
    j = JK.hll_bank_merge_map_from(jnp.asarray(regs), jnp.asarray(snap), jnp.asarray(src_map))
    t = TK.hll_bank_merge_map_from(_t(regs), _t(snap), _t(src_map))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_hll_merge():
    a, b = _hll_bank(7)[0], _hll_bank(8)[0]
    np.testing.assert_array_equal(TK.hll_merge(_t(a), _t(b)).numpy(),
                                  np.asarray(JK.hll_merge(jnp.asarray(a), jnp.asarray(b))))


def _realistic_bank(rows, p, seed):
    """Registers of counters holding 0..~3m distinct keys (both estimator
    ranges), built by the JAX package's own add program."""
    rng = np.random.default_rng(seed)
    m = 1 << p
    regs = jnp.zeros((rows, m), jnp.uint8)
    per_row = np.concatenate([[0, 1, 2], rng.integers(3, 3 * m, rows - 3)])
    tenant = np.repeat(np.arange(rows, dtype=np.int32), per_row)
    keys = rng.integers(-(2**63), 2**63 - 1, tenant.shape[0], dtype=np.int64)
    b = JK.bucket_size(max(1, tenant.shape[0]))
    lo, hi = JH.int_keys_to_u32_pair(keys)
    tlh = np.zeros((3, b), np.uint32)
    tlh[0, : len(tenant)], tlh[1, : len(keys)], tlh[2, : len(keys)] = tenant.view(np.uint32), lo, hi
    return np.asarray(JK.hll_bank_add_packed(regs, jnp.asarray(tlh), len(keys), p))


def _assert_estimates(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=EST_RTOL, atol=0)
    assert [int(round(float(x))) for x in got.reshape(-1)] == [int(round(float(x))) for x in want.reshape(-1)]


@pytest.mark.parametrize("p", [4, 10, 14])
def test_hll_estimate_bank(p):
    regs = _realistic_bank(24, p, p)
    _assert_estimates(TK.hll_estimate(_t(regs)).numpy(), JK.hll_estimate(jnp.asarray(regs)))


def test_hll_estimate_single_and_union():
    regs = _realistic_bank(8, 14, 1)
    for r in range(8):
        _assert_estimates(TK.hll_estimate(_t(regs[r])).numpy(), JK.hll_estimate(jnp.asarray(regs[r])))
    _assert_estimates(TK.hll_estimate_union(_t(regs[3]), _t(regs[5])).numpy(),
                      JK.hll_estimate_union(jnp.asarray(regs[3]), jnp.asarray(regs[5])))


def test_hll_estimate_union_pairs_with_ids_beyond_both_ends():
    regs = _realistic_bank(10, 14, 2)
    a = np.array([0, 1, 9, -1, -10, -11, 10, 55, 3], np.int32)
    b = np.array([9, 9, 0, 2, 11, 4, -3, 1, 3], np.int32)
    want = JK.hll_bank_estimate_union_pairs(jnp.asarray(regs), jnp.asarray(a), jnp.asarray(b))
    _assert_estimates(TK.hll_bank_estimate_union_pairs(_t(regs), _t(a), _t(b)).numpy(), want)


def _drawn_registers(cardinalities, p, rng):
    """Register states of counters holding each of `cardinalities` distinct
    keys, drawn without hashing them: a register's key count is Poisson
    (n / m) and its value the largest of that many ranks (P(rank <= r) =
    1 - 2**-r), capped at 33 as clz32 + 1 is."""
    m = 1 << p
    regs = np.zeros((len(cardinalities), m), np.uint8)
    for row, n in enumerate(cardinalities):
        c = rng.poisson(n / m, m).astype(np.float64)
        u = rng.random(m)
        with np.errstate(divide="ignore"):
            r = np.ceil(-np.log2(-np.expm1(np.log(u) / np.maximum(c, 1))))
        regs[row] = np.where(c > 0, np.clip(r, 1, 33), 0).astype(np.uint8)
    return regs


def test_hll_estimate_agrees_over_cardinalities_1_to_1e9():
    """Estimates over counters of 1 to 1e9 keys at p = 14, drawn
    log-uniformly from a fixed seed.  The raw estimate and the large-range
    correction agree to a relative 1e-6.  Linear counting, m * (log m -
    log zeros), agrees to m * 2**-20: one float32 ulp of a log in [8, 16)
    (XLA:CPU's float32 log is not correctly rounded), 3.1e-6 of an
    estimate of 5,000, where the two logs nearly cancel.  The rounded
    integers are not compared: above about 1e5 they can differ (module
    docstring)."""
    p = 14
    m = 1 << p
    rng = np.random.default_rng(2026)
    card = np.concatenate([[1, 2, 10, 1e5, 1e9], 10 ** rng.uniform(0, 9, 195)])
    regs = _drawn_registers(card, p, rng)
    got = TK.hll_estimate(_t(regs)).numpy()
    want = np.asarray(JK.hll_estimate(jnp.asarray(regs)))
    linear = (want <= 2.5 * m) & (regs == 0).any(axis=1)
    np.testing.assert_allclose(got[~linear], want[~linear], rtol=EST_RTOL, atol=0)
    np.testing.assert_allclose(got[linear], want[linear], rtol=0, atol=m * 2.0**-20)
    # the draw spans both ranges and the large-range correction
    assert linear.sum() > 50 and (~linear).sum() > 50
    assert want.min() < 10 and want.max() > 5e8


@pytest.mark.parametrize("p", [10, 12, 14])
def test_pfcount_integer_contract(p):
    """The PFCOUNT reply is the float32 estimate rounded, and it differs from
    the JAX package's rounded estimate by at most one more than the float
    tolerance of test_hll_estimate_agrees_over_cardinalities_1_to_1e9
    (1e-6 of the estimate, m * 2**-20 in linear counting), over 300
    register states drawn log-uniformly over 1 to 1e9 keys.  At p = 14 the
    integers are identical below 1e5."""
    m = 1 << p
    rng = np.random.default_rng(400 + p)
    regs = _drawn_registers(10 ** rng.uniform(0, 9, 300), p, rng)
    got = TK.hll_estimate(_t(regs)).numpy()
    want = np.asarray(JK.hll_estimate(jnp.asarray(regs)))
    linear = (want <= 2.5 * m) & (regs == 0).any(axis=1)
    tol = np.where(linear, m * 2.0**-20, EST_RTOL * np.abs(want.astype(np.float64)))
    ours = np.array([int(round(float(x))) for x in got], np.float64)
    theirs = np.array([int(round(float(x))) for x in want], np.float64)
    finite = np.isfinite(want)
    assert finite.all() and np.isfinite(got).all()
    assert (np.abs(ours - theirs) <= 1 + tol).all()
    if p == 14:
        small = want < 1e5
        assert small.sum() > 50
        np.testing.assert_array_equal(ours[small], theirs[small])


def test_hll_estimate_of_unusual_registers():
    """Registers no hash produces (up to 255), the large-range correction,
    empty counters, and a saturated counter (NaN in both packages)."""
    regs = np.zeros((5, 1 << 14), np.uint8)
    regs[1] = 14
    regs[2, ::7] = 255
    regs[3, :100] = 1
    regs[4] = 33
    got, want = TK.hll_estimate(_t(regs)).numpy(), np.asarray(JK.hll_estimate(jnp.asarray(regs)))
    _assert_estimates(got[:4], want[:4])
    assert np.isnan(got[4]) and np.isnan(want[4])


# -- ops: the plain building blocks ------------------------------------------

def test_bittensor_packed_form_matches():
    from redisson_tpu.ops import bittensor as jbt
    from redisson_tpu_torch.ops import bittensor as tbt

    bits = (np.random.default_rng(9).random(3000) < 0.3).astype(np.uint8)
    data = tbt.to_packed(bits, 2999)
    assert data == jbt.to_packed(bits, 2999)
    np.testing.assert_array_equal(tbt.from_packed(data, 2999), jbt.from_packed(data, 2999))
    assert tbt.popcount(_t(bits), 2999) == int(jbt.popcount(jnp.asarray(bits), 2999))
    assert tbt.padded_size(2999) == jbt.padded_size(2999) and tbt.padded_size(0) == jbt.padded_size(0)


def test_hll_ops_add_bank_merge_union_match():
    from redisson_tpu.ops import hll as jh
    from redisson_tpu_torch.ops import hll as th

    rng = np.random.default_rng(10)
    regs = rng.integers(0, 9, (T, 64)).astype(np.uint8)
    tenant = np.array([0, 3, -1, -4, -5, 4, 2, 2], np.int32)
    idx = np.array([0, 63, 5, 6, 7, 1, -1, -65], np.int32)
    rho = rng.integers(1, 30, 8).astype(np.uint8)
    want = jh.add_bank(jnp.asarray(regs), jnp.asarray(tenant), jnp.asarray(idx), jnp.asarray(rho))
    got = th.add_bank(_t(regs), _t(tenant).long(), _t(idx).long(), _t(rho))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(th.merge(_t(regs[0]), _t(regs[1])).numpy(),
                                  np.asarray(jh.merge(jnp.asarray(regs[0]), jnp.asarray(regs[1]))))
    big = _realistic_bank(5, 14, 11)
    _assert_estimates(th.estimate_union(_t(big[3]), _t(big[4])).numpy(),
                      jh.estimate_union(jnp.asarray(big[3]), jnp.asarray(big[4])))
    assert (th.m_of(14), th.alpha(16), th.alpha(32), th.alpha(64), th.alpha(128)) == \
        (jh.m_of(14), jh.alpha(16), jh.alpha(32), jh.alpha(64), jh.alpha(128))
