"""The port's bloom add dispatch on the CPU: every add form goes through
kernels.bloom_add and equals the JAX program on the same numpy inputs
(planes and newly results bit for bit), and the host helpers of the card's
kernels (the multiply-high modulo constant, the fused add's chunk plan and
its size dispatch) hold at their edges.

On the CPU every route is the plain version; the card's routes are held to
it by tests/test_torch_cuda.py and chip_smoke.py.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu.core import kernels as JK
from redisson_tpu.utils import hashing as JH
from redisson_tpu_torch.core import kernels as TK

T, W, B, K_HASH = 6, 2048, 512, 7


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _bits(x):
    """A bitmap as uint32 words from either package."""
    return _np(x).view(np.uint32) if _np(x).dtype == np.int32 else _np(x)


def _case(name):
    """(plane (T, W) u8, tenant, keys, n_valid, m) for a bank add."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    plane = (rng.random((T, W)) < 0.4).astype(np.uint8)
    n = 400
    tenant = rng.integers(0, T, B).astype(np.int32)
    keys = rng.integers(-(2**63), 2**63 - 1, B, dtype=np.int64)
    keys[n:], tenant[n:] = 0, 0
    m = W
    if name == "n_valid_0":
        n = 0
    elif name == "duplicates":
        keys[200:400], tenant[200:400] = keys[:200], tenant[:200]
    elif name == "wrapping_tenants":
        # 2**21 * 2048 = 2**32: the int32 product wraps back to row 0
        bad = [2**21, 2**21 + 1, 2**21 + T - 1, -(2**21), 2**31 - 1, -(2**31), -1, -T, T, T - 1]
        tenant[: len(bad)] = bad
        keys[len(bad): 2 * len(bad)] = keys[: len(bad)]  # the same keys in valid rows
    elif name == "narrow_m":
        m = W - 77
    return plane, tenant, keys, n, m


CASES = ["random", "n_valid_0", "duplicates", "wrapping_tenants", "narrow_m"]


@pytest.fixture()
def spy(monkeypatch):
    """Counts the calls of kernels.bloom_add (every add form must reach it)."""
    calls = []
    real = TK.bloom_add

    def counted(*args, **kwargs):
        calls.append(args[3])
        return real(*args, **kwargs)

    monkeypatch.setattr(TK, "bloom_add", counted)
    return calls


BANK_FORMS = ["bloom_bank_add_packed", "bloom_bank_add_packed_count", "bloom_bank_add_packed_bits",
              "bloom_bank_add_u64"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", BANK_FORMS)
def test_bank_add_forms_go_through_bloom_add(spy, form, case):
    plane, tenant, keys, n, m = _case(case)
    lo, hi = JH.int_keys_to_u32_pair(keys)
    if form == "bloom_bank_add_u64":
        j = JK.bloom_bank_add_u64(jnp.asarray(plane), jnp.asarray(tenant), jnp.asarray(lo), jnp.asarray(hi),
                                  n, K_HASH, m)
        t = TK.bloom_bank_add_u64(_t(plane), _t(tenant), _t(lo), _t(hi), n, K_HASH, m)
    else:
        tlh = np.stack([tenant.view(np.uint32), lo, hi])
        j = getattr(JK, form)(jnp.asarray(plane), jnp.asarray(tlh), n, K_HASH, m)
        t = getattr(TK, form)(_t(plane), _t(tlh), n, K_HASH, m)
    assert spy == [n]
    np.testing.assert_array_equal(_np(t[0]), _np(j[0]))
    np.testing.assert_array_equal(_bits(t[1]), _bits(j[1]))


SINGLE_FORMS = ["bloom_add_packed", "bloom_add_packed_count", "bloom_add_u64_masked", "bloom_add_bytes_masked"]


@pytest.mark.parametrize("case", ["random", "n_valid_0", "duplicates"])
@pytest.mark.parametrize("form", SINGLE_FORMS)
def test_single_add_forms_go_through_bloom_add(spy, form, case):
    plane, _, keys, n, _ = _case(case)
    plane = plane.reshape(-1)
    m = plane.shape[0] - 5
    if form == "bloom_add_bytes_masked":
        rng = np.random.default_rng(len(case))
        raw = [rng.bytes(int(x)) for x in rng.integers(0, 20, B)]
        if case == "duplicates":
            raw[200:400] = raw[:200]
        words, nbytes = JH.pack_keys(raw)
        j = JK.bloom_add_bytes_masked(jnp.asarray(plane), jnp.asarray(words), jnp.asarray(nbytes), n, K_HASH, m)
        t = TK.bloom_add_bytes_masked(_t(plane), _t(words), _t(nbytes), n, K_HASH, m)
    elif form == "bloom_add_u64_masked":
        lo, hi = JH.int_keys_to_u32_pair(keys)
        j = JK.bloom_add_u64_masked(jnp.asarray(plane), jnp.asarray(lo), jnp.asarray(hi), n, K_HASH, m)
        t = TK.bloom_add_u64_masked(_t(plane), _t(lo), _t(hi), n, K_HASH, m)
    else:
        lh = np.stack(JH.int_keys_to_u32_pair(keys))
        j = getattr(JK, form)(jnp.asarray(plane), jnp.asarray(lh), n, K_HASH, m)
        t = getattr(TK, form)(_t(plane), _t(lh), n, K_HASH, m)
    assert spy == [n]
    np.testing.assert_array_equal(_np(t[0]), _np(j[0]))
    np.testing.assert_array_equal(_bits(t[1]), _bits(j[1]))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("out", [TK.FLAGS, TK.BITS, TK.COUNT])
@pytest.mark.parametrize("fn", ["bloom_add", "bloom_add_fused"])
def test_add_wrappers_match_the_jax_bank_add(fn, out, case):
    """Both wrappers, in each result form, against the JAX bank add (whose
    flags give the bitmap and the count)."""
    plane, tenant, keys, n, m = _case(case)
    lo, hi = JH.int_keys_to_u32_pair(keys)
    tlh = np.stack([tenant.view(np.uint32), lo, hi])
    j_plane, j_newly = JK.bloom_bank_add_packed(jnp.asarray(plane), jnp.asarray(tlh), n, K_HASH, m)
    j_newly = np.asarray(j_newly)
    tp = _t(plane)
    got = getattr(TK, fn)(tp, W, TK.Keys(n=B, tenant=_t(tenant), lo=_t(lo), hi=_t(hi)), n, K_HASH, m, out)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(j_plane))
    if out == TK.FLAGS:
        np.testing.assert_array_equal(got.numpy(), j_newly)
    elif out == TK.BITS:
        np.testing.assert_array_equal(_bits(got), np.packbits(j_newly, bitorder="little").view(np.uint32))
    else:
        assert int(got) == int(j_newly.sum())


def test_duplicate_keys_both_report_newly():
    """The read-before-write contract: equal keys in one batch both report
    newly, on a zeroed plane and through every wrapper."""
    keys = np.array([5, 5, 9, 5, 0, 0, 0, 0], np.int64)
    lo, hi = JH.int_keys_to_u32_pair(keys)
    for fn in (TK.bloom_add, TK.bloom_add_fused, TK.bloom_add_plain):
        plane = torch.zeros(1024, dtype=torch.uint8)
        kb = TK.Keys(n=8, lo=_t(lo), hi=_t(hi))
        assert fn(plane, 1024, kb, 4, 5, 1000).tolist() == [True] * 4 + [False] * 4
        assert fn(plane, 1024, kb, 4, 5, 1000).tolist() == [False] * 8


# -- host helpers of the card's kernels ---------------------------------------

EDGE_M = [1, 2, 3, 7, 1000, 96_256, 95_850_583, 2**16 + 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1]


@pytest.mark.parametrize("m", EDGE_M)
def test_fastmod_gives_the_remainder_at_edge_values(m):
    magic = TK.fastmod_magic(m)
    xs = {0, 1, 2, m - 1, m, m + 1, 2 * m - 1, 2 * m, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1}
    xs |= {(m * q + r) & 0xFFFFFFFF for q in (1, 3, 2**32 // m) for r in (-1, 0, 1)}
    xs |= set(np.random.default_rng(m % 2**32).integers(0, 2**32, 2000).tolist())
    for x in sorted(x for x in xs if 0 <= x < 2**32):
        assert TK.fastmod(x, magic, m) == x % m, (x, m)


def test_fastmod_magic_edges():
    assert TK.fastmod_magic(1) == 0  # ceil(2**64 / 1) wraps; x % 1 is still 0
    assert TK.fastmod_magic(2) == 2**63
    assert TK.fastmod_magic(3) == -(-(2**64) // 3)
    assert TK.fastmod_magic(2**32 - 1) == -(-(2**64) // (2**32 - 1))
    for bad in (0, -1, 2**32, 2**40):
        with pytest.raises(ValueError):
            TK.fastmod_magic(bad)


def test_fused_add_chunk_plan():
    c = 1 << TK.ADD_CHUNK_LOG2
    assert TK.add_chunks(1) == 1
    assert TK.add_chunks(c) == 1
    assert TK.add_chunks(c + 1) == 2
    assert TK.add_chunks(95_851_520) == -(-95_851_520 // c)  # config 1
    assert TK.add_chunks(96_256_000) == -(-96_256_000 // c)  # config 2
    assert TK.add_chunks(c * TK.ADD_MAX_BINS) == TK.ADD_MAX_BINS


def test_size_dispatch_rule():
    size = 96_256_000  # config 2's bank: 3,008,000 sectors
    sectors = size // 32
    # the smallest n_valid at or above the measured crossover takes the fused add
    n_min = -(-int(TK.FUSED_ADD_PROBES_PER_SECTOR * sectors) // K_HASH)
    while K_HASH * n_min < TK.FUSED_ADD_PROBES_PER_SECTOR * sectors:
        n_min += 1
    assert TK.use_fused_add(size, n_min, K_HASH)
    assert not TK.use_fused_add(size, n_min - 1, K_HASH)
    assert not TK.use_fused_add(size, 0, K_HASH)
    assert TK.use_fused_add(size, 10_485_760, K_HASH)  # config 2's populate window
    assert not TK.use_fused_add(size, 1000, K_HASH)  # a small sync add
    # more probes than the uint32-indexed entries take: the pair
    assert not TK.use_fused_add(size, TK.FUSED_ADD_MAX_PROBES // K_HASH + 1, K_HASH)
    # a plane that fits in L2: the pair at any batch size
    small = TK.FUSED_ADD_MIN_PLANE
    assert not TK.use_fused_add(small, small, K_HASH)
    assert TK.use_fused_add(small + 1024, small, K_HASH)
    # a plane of more chunks than a block's histogram holds: the pair
    largest = (1 << TK.ADD_CHUNK_LOG2) * TK.ADD_MAX_BINS
    assert TK.use_fused_add(largest, largest // 32, K_HASH)
    assert not TK.use_fused_add(largest + 1, largest // 32, K_HASH)
    assert not TK.use_fused_add(TK.BANK_MAX_CELLS, 2**28, K_HASH)


def test_fused_add_refuses_what_it_cannot_take():
    keys = TK.Keys(n=32, lo=torch.zeros(32, dtype=torch.int32), hi=torch.zeros(32, dtype=torch.int32))
    meta = torch.zeros(1024, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        TK.bloom_add_fused(meta, 1024, keys, 10, 3, 1000)
    with pytest.raises(ValueError):
        TK.bloom_add(meta, 1024, keys, 10, 3, 1000)


def test_fused_add_ops_per_block():
    # csrc/bloom.cu ops_per_block: two ops per thread of a 1024-thread block,
    # fewer when the staged entries and the per-chunk words outgrow 160 KB
    assert TK.add_ops_per_block(TK.add_chunks(95_851_520), K_HASH) == 2048  # config 1
    assert TK.add_ops_per_block(TK.ADD_MAX_BINS, K_HASH) == (160 * 1024 - 8 * TK.ADD_MAX_BINS) // (10 * K_HASH)
    assert TK.add_ops_per_block(1, 8192) == (160 * 1024 - 32) // (10 * 8192)
    # a k so large that not one op's probes fit: the pair, never a launch
    huge_k = (160 * 1024 - 8 * TK.ADD_MAX_BINS) // 10 + 1
    assert TK.add_ops_per_block(TK.ADD_MAX_BINS, huge_k) == 0
    size = (1 << TK.ADD_CHUNK_LOG2) * TK.ADD_MAX_BINS
    assert TK.use_fused_add(size, size // 32, K_HASH)
    assert not TK.use_fused_add(size, size // 32, huge_k)
