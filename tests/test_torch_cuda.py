"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small adversarial sizes.

Needs a CUDA card and nvcc; without a card every test skips.  This file
imports neither JAX nor the JAX package, so it runs on a machine without
them; from the repository root:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py sets up JAX for the other test files.)
Plain versus JAX is covered on the CPU by tests/test_torch_kernels.py.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.utils import hashing as H
import _wc_edges as E  # tests/ is on the path of a test module

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _u64(rng, n, b, dev, tenants=0, dup=True):
    keys = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    if dup and n >= 4:
        keys[n // 2:] = keys[: n - n // 2]
    keys[:2] = [0, -1][: min(2, n)]
    lo, hi = np.zeros(b, np.uint32), np.zeros(b, np.uint32)
    lo[:n], hi[:n] = H.int_keys_to_u32_pair(keys)
    if not tenants:
        return K.Keys(n=b, lo=K.stage(lo, dev), hi=K.stage(hi, dev))
    t = np.zeros(b, np.int32)
    t[:n] = rng.integers(0, tenants, n)
    bad = [-1, tenants, tenants - 1, 2**31 - 1, -(2**31), -tenants, -tenants - 1]
    t[: min(n, len(bad))] = bad[: min(n, len(bad))]
    return K.Keys(n=b, tenant=K.stage(t, dev), lo=K.stage(lo, dev), hi=K.stage(hi, dev))


def _bytes(rng, n, dev, width=8):
    keys = [rng.bytes(int(rng.integers(0, 18))) for _ in range(n)]
    keys[: min(n, 3)] = [b"", b"a", b"abcd"][: min(n, 3)]
    words, nbytes = H.pack_keys(keys)
    words = K.pad_to(words, width, axis=0) if width else words[:0]
    return K.Keys(n=n, words=K.stage(words, dev),
                  nbytes=K.stage(nbytes, dev))


def _cases(dev):
    rng = np.random.default_rng(0)
    T, W = 5, 2048
    bank = (torch.rand((T, W), device=dev) < 0.6).to(torch.uint8)
    bank[:, -1] = 0  # the last physical column holds zeros a probe must see
    plane = (torch.rand(4096, device=dev) < 0.6).to(torch.uint8)
    return [
        ("bank", bank, W, _u64(rng, 900, 1024, dev, tenants=T), 2048),
        ("bank-narrow-m", bank, W, _u64(rng, 300, 512, dev, tenants=T), 2000),
        ("plane-u64", plane, plane.numel(), _u64(rng, 1000, 1024, dev), 4093),
        ("plane-bytes", plane, plane.numel(), _bytes(rng, 256, dev), 4096),
        ("plane-bytes-zero-width", plane, plane.numel(), _bytes(rng, 64, dev, width=0), 4096),
    ]


@pytest.mark.parametrize("n_valid", [0, 1, 700, 10**6])
def test_bloom_probe_matches_plain(dev, n_valid):
    for name, plane, width, kb, m in _cases(dev):
        for newly in (False, True):
            for out in (K.FLAGS, K.BITS, K.COUNT):
                if out == K.BITS and kb.n % 32:
                    continue
                got = K.bloom_probe(plane, width, kb, n_valid, 7, m, newly, out)
                want = K.bloom_probe_plain(plane, width, kb, n_valid, 7, m, newly, out)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (name, newly, out)


@pytest.mark.parametrize("n_valid", [0, 1, 700, 10**6])
def test_bloom_set_matches_plain(dev, n_valid):
    for name, plane, width, kb, m in _cases(dev):
        a, b = plane.clone(), plane.clone()
        K.bloom_set(a, width, kb, n_valid, 7, m)
        K.bloom_set_plain(b, width, kb, n_valid, 7, m)
        torch.cuda.synchronize()
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n_valid", [0, 1, 700, 10**6])
def test_bloom_add_fused_matches_plain(dev, n_valid):
    for name, plane, width, kb, m in _cases(dev):
        for out in (K.FLAGS, K.BITS, K.COUNT):
            if out == K.BITS and kb.n % 32:
                continue
            a, b = plane.clone(), plane.clone()
            got = K.bloom_add_fused(a, width, kb, n_valid, 7, m, out)
            want = K.bloom_add_plain(b, width, kb, n_valid, 7, m, out)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, out)
            assert torch.equal(a, b), (name, out)


def _keys_probing(positions, m, k, dev, want=64):
    """u64 keys (single plane, domain m) one of whose k probes lands on one
    of `positions`, found among candidates hashed on the card."""
    cand = np.arange(1, 1 << 20, dtype=np.int64) * 2654435761
    lo, hi = H.int_keys_to_u32_pair(cand)
    h1, h2 = H.hash_u64_pair(K.stage(lo, dev), K.stage(hi, dev))
    idx = H.bloom_indexes(h1, h2, k, m)
    hit = torch.isin(idx, torch.tensor(positions, device=dev)).any(dim=1).cpu().numpy()
    assert hit.sum() >= want
    return cand[hit][:want]


def test_bloom_add_fused_at_chunk_boundaries(dev):
    """Probes on both sides of every chunk boundary of a 4-chunk plane,
    with duplicate keys, and a plane whose size is not a multiple of 16."""
    log2, k = K.ADD_CHUNK_LOG2, 7
    for size in (4 << log2, (4 << log2) - 8):
        m = size
        edges = [c * (1 << log2) + d for c in range(1, 4) for d in (-1, 0)] + [size - 1]
        keys = _keys_probing(edges, m, k, dev)
        keys = np.concatenate([keys, keys[:16]])
        lo, hi = np.zeros(128, np.uint32), np.zeros(128, np.uint32)
        lo[: len(keys)], hi[: len(keys)] = H.int_keys_to_u32_pair(keys)
        kb = K.Keys(n=128, lo=K.stage(lo, dev), hi=K.stage(hi, dev))
        plane = torch.zeros(size, dtype=torch.uint8, device=dev)
        plane[::3] = 1
        plane[edges] = 0
        a, b = plane.clone(), plane.clone()
        got = K.bloom_add_fused(a, size, kb, len(keys), k, m, K.BITS)
        want = K.bloom_add_plain(b, size, kb, len(keys), k, m, K.BITS)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(a, b)
        assert bool((a[edges] == 1).all())


@pytest.mark.parametrize("m", [1, 3, 4093, 2**31 + 1, 2**32 - 1])
def test_fast_modulo_at_edge_domains(dev, m):
    """The multiply-high modulo on the card for domains from 1 to 2**32 - 1,
    through the unrolled (k = 7) and the generic (k = 5) kernels; probes
    past the plane read as 1 and are dropped."""
    rng = np.random.default_rng(m)
    plane = (torch.rand(4096, device=dev) < 0.5).to(torch.uint8)
    kb = _u64(rng, 1000, 1024, dev)
    a, b = plane.clone(), plane.clone()
    for k in (5, 7):
        assert torch.equal(K.bloom_probe(plane, 4096, kb, 1000, k, m, out=K.BITS),
                           K.bloom_probe_plain(plane, 4096, kb, 1000, k, m, out=K.BITS))
        assert torch.equal(K.bloom_add_fused(a, 4096, kb, 1000, k, m, K.COUNT),
                           K.bloom_add_plain(b, 4096, kb, 1000, k, m, K.COUNT))
        assert torch.equal(a, b)
        K.bloom_set(a, 4096, kb, 1000, k + 1, m)
        K.bloom_set_plain(b, 4096, kb, 1000, k + 1, m)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_bank_add_reads_the_plane_before_the_batch(dev):
    """Equal keys in one batch both report newly (two-phase add)."""
    bits = torch.zeros((3, 1024), dtype=torch.uint8, device=dev)
    tlh = K.stage(np.array([[1, 1, 2, 0], [7, 7, 9, 0], [0, 0, 0, 0]], np.uint32), dev)
    _, newly = K.bloom_bank_add_packed(bits, tlh, 3, 5, 1024)
    torch.cuda.synchronize()
    assert newly.tolist() == [True, True, True, False]
    _, newly = K.bloom_bank_add_packed(bits, tlh, 3, 5, 1024)
    assert newly.tolist() == [False, False, False, False]


@pytest.mark.parametrize("n_valid", [0, 1, 700, 10**6])
def test_hll_add_matches_plain(dev, n_valid):
    rng = np.random.default_rng(1)
    T, m = 6, 1 << 10
    bank = torch.randint(0, 9, (T, m), dtype=torch.uint8, device=dev)
    one = torch.randint(0, 9, (m,), dtype=torch.uint8, device=dev)
    cases = [(bank, m, _u64(rng, 900, 1024, dev, tenants=T)),
             (one, m, _u64(rng, 900, 1024, dev)),
             (one, m, _bytes(rng, 300, dev)),
             (one, m, _bytes(rng, 40, dev, width=0))]
    for regs, width, kb in cases:
        a, b = regs.clone(), regs.clone()
        K.hll_add(a, width, kb, n_valid, 10)
        K.hll_add_plain(b, width, kb, n_valid, 10)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_hll_rows_matches_plain(dev):
    rng = np.random.default_rng(2)
    T, m = 9, 1 << 10
    x = torch.randint(0, 34, (T, m), dtype=torch.uint8, device=dev)
    x[0] = 0                      # empty counter: linear counting, zeros = m
    x[1] = 255                    # registers no hash produces still estimate
    x[2, :5] = 0                  # a few zeros
    y = torch.randint(0, 34, (T + 2, m), dtype=torch.uint8, device=dev)
    a = torch.from_numpy(rng.integers(-T - 2, T + 2, 40).astype(np.int32)).to(dev)
    b = torch.from_numpy(rng.integers(-T - 4, T + 4, 40).astype(np.int32)).to(dev)
    ident = torch.arange(T, dtype=torch.int32, device=dev)
    for args in [(x, None, None, None), (x, y[:T], None, None), (x, y, a, b), (x, x, ident, a[:T]),
                 (x[:1], None, None, None)]:
        for with_out in (False, True):
            p_rows = args[0].shape[0] if args[2] is None else args[2].shape[0]
            out_k = torch.empty((p_rows, m), dtype=torch.uint8, device=dev) if with_out else None
            out_p = torch.empty_like(out_k) if with_out else None
            est_k = K.hll_rows(*args, out=out_k, estimate=True)
            est_p = K.hll_rows_plain(*args, out=out_p, estimate=True)
            torch.cuda.synchronize()
            # bit for bit; a saturated counter's estimate is NaN in both
            torch.testing.assert_close(est_k, est_p, rtol=0, atol=0, equal_nan=True)
            if with_out:
                assert torch.equal(out_k, out_p)


def _rows_cases(rng, dev, p):
    """(name, bank) pairs of an odd number of rows at width 2**p."""
    m = 1 << p
    T = 7
    unusual = torch.from_numpy(rng.integers(0, 256, (T, m)).astype(np.uint8)).to(dev)
    unusual[3] = 33                        # saturated: NaN in both versions
    unusual[4, ::3] = 0
    mixed = torch.from_numpy(rng.integers(0, 6, (T, m)).astype(np.uint8)).to(dev)
    mixed[1] = torch.from_numpy(rng.integers(0, 34, m).astype(np.uint8)).to(dev)
    return [("zeros", torch.zeros((T, m), dtype=torch.uint8, device=dev)),
            ("ones", torch.ones((T, m), dtype=torch.uint8, device=dev)),  # every lane on one bin
            ("fours", torch.full((T, m), 4, dtype=torch.uint8, device=dev)),  # one shared bin
            ("unusual up to 255", unusual),
            ("ranks 0-5", mixed)]


def _rows_equal(args, m, dev, with_out):
    p_rows = args[0].shape[0] if args[2] is None else args[2].shape[0]
    out_k = torch.empty((p_rows, m), dtype=torch.uint8, device=dev) if with_out else None
    out_p = torch.empty_like(out_k) if with_out else None
    est_k = K.hll_rows(*args, out=out_k, estimate=True)
    est_p = K.hll_rows_plain(*args, out=out_p, estimate=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(est_k, est_p, rtol=0, atol=0, equal_nan=True)
    if with_out:
        assert torch.equal(out_k, out_p)


@pytest.mark.parametrize("p", [4, 10, 14, 18])
def test_hll_rows_register_distributions(dev, p):
    """Estimates and merges of banks whose registers all sit on one value
    (the worst contention for a shared histogram), of registers no hash
    produces and of a saturated row, at widths 16 to 2**18, bit for bit."""
    rng = np.random.default_rng(p)
    m = 1 << p
    for name, x in _rows_cases(rng, dev, p):
        y = x.flip(0).contiguous()
        a = torch.from_numpy(rng.integers(-9, 9, 5).astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(-9, 9, 5).astype(np.int32)).to(dev)
        for args in [(x, None, None, None), (x, y, None, None), (x, y, a, b), (x[2:3], y[:1], None, None)]:
            for with_out in (False, True):
                _rows_equal(args, m, dev, with_out)


def test_hll_rows_four_byte_aligned_banks(dev):
    """Banks that are only 4-byte aligned, or whose width is not a multiple
    of 16, take the kernel's 4-byte loads and stores."""
    rng = np.random.default_rng(7)
    m = 1 << 12
    buf = torch.empty(5 * m + 16, dtype=torch.uint8, device=dev)
    x = buf[4: 4 + 5 * m].view(5, m)
    x.copy_(torch.from_numpy(rng.integers(0, 12, (5, m)).astype(np.uint8)))
    y = torch.from_numpy(rng.integers(0, 12, (5, m)).astype(np.uint8)).to(dev)
    out_buf = torch.empty(5 * m + 16, dtype=torch.uint8, device=dev)
    out = out_buf[12: 12 + 5 * m].view(5, m)
    assert x.data_ptr() % 16 == 4 and out.data_ptr() % 16 == 12
    _rows_equal((x, y, None, None), m, dev, False)
    want = torch.empty_like(y)
    K.hll_rows(x, y, out=out)
    K.hll_rows_plain(x, y, out=want)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    narrow = torch.from_numpy(rng.integers(0, 40, (3, 20)).astype(np.uint8)).to(dev)  # m % 16 == 4
    _rows_equal((narrow, narrow.flip(0).contiguous(), None, None), 20, dev, True)


def test_hll_rows_merge_forms_at_config3_shape(dev):
    """merge map, merge from a snapshot and union pairs over a 10,000 x
    16,384 bank (config 3), and PFMERGE of one row."""
    rng = np.random.default_rng(8)
    T, m = 10_000, 1 << 14
    u = torch.rand((T, m), device=dev)
    regs = torch.clamp(torch.floor(-torch.log2(u)) * (u < 0.9), 0, 33).to(torch.uint8)
    del u
    snap = regs.roll(1, 0)
    src_map = torch.from_numpy(rng.integers(0, T, T).astype(np.int32)).to(dev)
    pa = torch.from_numpy(rng.integers(-3, T + 3, 5000).astype(np.int32)).to(dev)
    pb = torch.from_numpy(rng.integers(-3, T + 3, 5000).astype(np.int32)).to(dev)
    for args in [(regs, regs, None, src_map), (regs, snap, None, src_map)]:
        out_k, out_p = torch.empty_like(regs), torch.empty_like(regs)
        K.hll_rows(*args, out=out_k)
        K.hll_rows_plain(*args, out=out_p)
        torch.cuda.synchronize()
        assert torch.equal(out_k, out_p)
    torch.testing.assert_close(K.hll_bank_estimate_union_pairs(regs, pa, pb),
                               K.hll_rows_plain(regs, regs, pa, pb, estimate=True), rtol=0, atol=0)
    torch.testing.assert_close(K.hll_estimate(regs), K.hll_rows_plain(regs, estimate=True), rtol=0, atol=0)
    assert torch.equal(K.hll_merge(regs[3], regs[9]), torch.maximum(regs[3], regs[9]))


def _keys_on_registers(registers, p, dev, want):
    """u64 keys (one counter of 2**p registers) whose register is in
    `registers`, found among candidates hashed on the card."""
    cand = np.arange(1, 1 << 20, dtype=np.int64) * 2654435761
    lo, hi = H.int_keys_to_u32_pair(cand)
    h1, _ = H.hash_u64_pair(K.stage(lo, dev), K.stage(hi, dev))
    hit = torch.isin(h1 & ((1 << p) - 1), torch.tensor(registers, device=dev)).cpu().numpy()
    assert hit.sum() >= want
    return cand[hit][:want]


def _add_equal(regs, width, keys, n_valid, p, tenant=None):
    b = -(-max(len(keys), 1) // 32) * 32
    lo, hi = np.zeros(b, np.uint32), np.zeros(b, np.uint32)
    lo[: len(keys)], hi[: len(keys)] = H.int_keys_to_u32_pair(np.asarray(keys, np.int64))
    t = None
    if tenant is not None:
        tt = np.zeros(b, np.int32)
        tt[: len(keys)] = tenant
        t = K.stage(tt, regs.device)
    kb = K.Keys(n=b, tenant=t, lo=K.stage(lo, regs.device), hi=K.stage(hi, regs.device))
    a, c = regs.clone(), regs.clone()
    K.hll_add(a, width, kb, n_valid, p)
    K.hll_add_plain(c, width, kb, n_valid, p)
    torch.cuda.synchronize()
    assert torch.equal(a, c)
    return a


def test_hll_add_contended_words_and_registers(dev):
    """Many ops on the four registers of one 32-bit word and on one register
    (different keys, so different ranks, and exact duplicates), into a zeroed
    counter and one whose word is already partly filled."""
    p = 10
    word = _keys_on_registers([4, 5, 6, 7], p, dev, 200)
    one = _keys_on_registers([9], p, dev, 100)
    keys = np.concatenate([word, one, word[:50], one[:50]])
    for start in (0, 3):
        regs = torch.zeros(1 << p, dtype=torch.uint8, device=dev)
        regs[4:10] = torch.tensor([start, 0, start, 0, 0, start], dtype=torch.uint8)
        for n_valid in (0, 1, len(keys)):
            got = _add_equal(regs, 1 << p, keys, n_valid, p)
            assert n_valid < len(keys) or bool((got[4:8] > 0).all())


def test_hll_add_last_row_and_outside_tenants(dev):
    """Every op in the bank's last row, and tenant ids outside it."""
    p, T = 10, 6
    rng = np.random.default_rng(9)
    bank = torch.randint(0, 3, (T, 1 << p), dtype=torch.uint8, device=dev)
    keys = rng.integers(-(2**63), 2**63 - 1, 4000, dtype=np.int64)
    _add_equal(bank, 1 << p, keys, len(keys), p, tenant=np.full(len(keys), T - 1, np.int32))
    outside = np.array([-1, T, -T, -T - 1, 2**31 - 1, -(2**31), 2**22, 2**22 + 1] * 500, np.int32)
    _add_equal(bank, 1 << p, keys, len(keys), p, tenant=outside)
    _add_equal(bank, 1 << p, keys, 0, p, tenant=outside)


@pytest.mark.parametrize("keys_per_register", [0.0, 6.0])
def test_hll_add_bank_larger_than_l2(dev, keys_per_register):
    """A 64 MB bank, zeroed or filled as counters of ~6 keys a register
    leave it (most ops then meet a register that already holds their rank),
    fed twice, with tenant ids inside and outside it."""
    m, T = 1 << 14, 4096
    rng = np.random.default_rng(11)
    u = torch.rand((T, m), device=dev, dtype=torch.float64)
    bank = torch.zeros((T, m), dtype=torch.uint8, device=dev)
    if keys_per_register:
        bank = torch.clamp(torch.ceil(torch.log2(keys_per_register / -torch.log(u))), 0, 33).to(torch.uint8)
    keys = rng.integers(-(2**63), 2**63 - 1, 200_000, dtype=np.int64)
    tenant = rng.integers(-2, T + 2, len(keys)).astype(np.int32)
    for _ in range(2):
        bank = _add_equal(bank, m, keys, len(keys), 14, tenant=tenant)
        keys = keys[::-1].copy() + 1


def test_hll_add_one_dense_counter(dev):
    """1M ops into one 16 KB counter (a large add_all on one RHyperLogLog):
    every register takes ~61 ops."""
    rng = np.random.default_rng(10)
    regs = torch.zeros(1 << 14, dtype=torch.uint8, device=dev)
    keys = rng.integers(-(2**63), 2**63 - 1, 1 << 20, dtype=np.int64)
    got = _add_equal(regs, 1 << 14, keys, len(keys), 14)
    assert bool((got > 0).all())


def test_hll_rows_refuses_in_place(dev):
    x = torch.zeros((2, 64), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        K.hll_rows(x, x, None, torch.zeros(2, dtype=torch.int32, device=dev), out=x)


def test_wrappers_raise_on_mixed_devices_and_count_launches(dev):
    bits = torch.zeros(1024, dtype=torch.uint8, device=dev)
    lh_cpu = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.bloom_contains_packed_bits(bits, lh_cpu, 10, 3, 1000)
    K.reset_launches()
    lh = lh_cpu.to(dev)
    plane = torch.zeros(1 << 26, dtype=torch.uint8, device=dev)
    big = K.stage(np.random.default_rng(4).integers(0, 2**32, (2, 1 << 18), dtype=np.uint64)
                  .astype(np.uint32), dev)
    assert not K.use_fused_add(plane.numel(), 10, 3) and K.use_fused_add(plane.numel(), 1 << 18, 3)
    K.bloom_add_packed(plane, lh, 10, 3, 1000)             # small: probe + set
    K.bloom_add_packed(plane, big, 1 << 18, 3, 1 << 26)    # large: the fused add
    K.bloom_contains_packed_bits(bits, lh, 10, 3, 1000)
    K.hll_estimate(torch.zeros(1 << 10, dtype=torch.uint8, device=dev))
    K.hll_add_packed(torch.zeros(1 << 10, dtype=torch.uint8, device=dev), lh, 10, 10)
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    K.bitset_set(bits, idx, 8, 1)
    K.bitset_get(bits, idx)
    K.bitset_get(bits, idx[:0])  # an empty batch launches nothing
    text = torch.full((512,), 32, dtype=torch.uint8, device=dev)
    text[:3] = 97
    ha, hb, st = K.wc_extract_words_auto(text, 1, 256, 0)
    K.wc_extract_words(text, torch.ones(4, dtype=torch.int32, device=dev), 1, 0)
    K.wc_sort_runs(ha, hb, st, 16)
    K.segment_reduce(idx, idx, 4)
    with pytest.raises(ValueError):
        K.wc_sort_runs(ha, hb.cpu(), st, 16)
    with pytest.raises(ValueError):
        K.segment_reduce(idx.cpu(), idx, 4)
    bank = torch.randn((64, 8), device=dev)
    bias = torch.zeros(64, device=dev)
    q = torch.randn((4, 8), device=dev)
    K.knn_topk(bank, bias, q, 64, 3, "L2")                  # score + select
    cells = torch.arange(64, dtype=torch.int32, device=dev).reshape(4, 16)
    K.knn_ivf_topk(bank, bias, bank[:4].clone(), cells, q, 64, 3, 2, "IP")  # 2 x (score|ivf + select)
    K.kmeans_step(bank, torch.ones(64, device=dev), bank[:4].clone())
    with pytest.raises(ValueError):
        K.knn_topk(bank, bias.cpu(), q, 64, 3, "L2")
    with pytest.raises(ValueError):
        K.knn_select(q, 9)
    assert K.launches == {"bloom_probe": 2, "bloom_set": 1, "bloom_add": 1, "hll_add": 1, "hll_rows": 1,
                          "bitset_get": 1, "bitset_set": 1, "wc_words": 2, "wc_sort_runs": 1,
                          "segment_reduce": 1, "knn_score": 2, "knn_select": 3, "ivf_score": 1,
                          "kmeans": 2}


def test_facade_on_the_card_matches_the_cpu(dev):
    import redisson_tpu_torch
    from redisson_tpu_torch import state

    def stream(client):
        rng = np.random.default_rng(3)
        out = []
        arr = client.get_bloom_filter_array("bank")
        arr.try_init(4, 1000, 0.01)
        t = rng.integers(0, 4, 3000).astype(np.int32)
        ks = rng.integers(-(2**62), 2**62, 3000)
        out.append(arr.add_each(t, ks).tolist())
        out.append(arr.add_flushes([(t[:100], ks[:100]), (t[:100], ks[:100]), (t[100:], ks[100:])]))
        out.append(arr.contains(t, ks + 1).tolist())
        bf = client.get_bloom_filter("bf")
        bf.try_init(1000, 0.01)
        out.append(bf.add_all(["x", "y", 3, 2.5]))
        out.append(bf.contains_each(["x", "q"]).tolist())
        out.append(bf.count())
        h = client.get_hyper_log_log_array("h")
        h.try_init(8)
        h.add(rng.integers(0, 8, 4000).astype(np.int32), rng.integers(0, 2**60, 4000))
        h.merge_rows([0, 0, 3], [1, 2, 0])
        out.append(h.estimate_all().tolist())
        hl = client.get_hyper_log_log("one")
        hl.add_all([f"k{i}" for i in range(300)])
        out.append(hl.count())
        for name in ("bank", "bf", "h", "one"):
            out.append({k: v.tolist() for k, v in state.to_reference(client.engine.store.get(name))[2].items()})
        return out

    assert stream(redisson_tpu_torch.create()) == stream(redisson_tpu_torch.create(device="cpu"))


def _bitset_idx(rng, n, size, dup=0.1, edges=True):
    idx = rng.integers(0, size, n).astype(np.int32)
    d = int(n * dup)
    idx[n - d:] = idx[:d]
    if edges:
        edge = [-1, -size, -size - 1, size, size - 1, 0, 2**31 - 1, -(2**31), 5, 5]
        idx[: min(n, len(edge))] = edge[: min(n, len(edge))]
    return idx


@pytest.mark.parametrize("shape", ["config5", "bitmap_2_28", "edges"])
def test_bitset_kernels_match_plain(dev, shape):
    """bitset_get / bitset_set against their plain versions: config 5's 500
    indexes into a 1 MiB plane, 1M indexes (10% repeated) into a 2**28-lane
    plane, and a small plane with negative, out-of-range and repeated
    indexes, a masked tail and n_valid = 0."""
    rng = np.random.default_rng(31)
    size, n = {"config5": (1 << 20, 500), "bitmap_2_28": (1 << 28, 1 << 20), "edges": (4096, 1000)}[shape]
    plane = (torch.rand(size, device=dev) < 0.3).to(torch.uint8)
    idx = torch.from_numpy(_bitset_idx(rng, n, size if shape != "config5" else 100_000)).to(dev)
    got = K.bitset_get(plane, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, K.bitset_get_plain(plane, idx))
    for n_valid in (0, 1, n - 37, n, n + 5):
        for value in (0, 1):
            a, b = plane.clone(), plane.clone()
            _, old_k = K.bitset_set(a, idx, n_valid, value)
            _, old_p = K.bitset_set_plain(b, idx, n_valid, value)
            torch.cuda.synchronize()
            assert torch.equal(old_k, old_p), (n_valid, value)
            assert torch.equal(a, b), (n_valid, value)


def test_bitset_set_reports_pre_batch_bits(dev):
    plane = torch.zeros(4096, dtype=torch.uint8, device=dev)
    plane[5] = 1
    idx = torch.tensor([5, 5, 9, 9, -1, 9, 4096], dtype=torch.int32, device=dev)
    _, old = K.bitset_set(plane, idx, 7, 1)
    assert old.tolist() == [1, 1, 0, 0, 0, 0, 0]
    assert plane.nonzero().reshape(-1).tolist() == [5, 9, 4095]
    _, old = K.bitset_set(plane, idx, 3, 0)
    assert old.tolist() == [1, 1, 1, 0, 0, 0, 0]
    assert plane.nonzero().reshape(-1).tolist() == [4095]


# bitset_set's two forms: one block up to 2,048 ops, a cooperative grid past
# it (1M ops spread over many grid-stride rounds)
@pytest.mark.parametrize("n", [1, 500, 2048, 2049, 6000, 100_000, 1 << 20])
def test_bitset_set_one_launch_forms_match_plain(dev, n):
    """Each form: repeated indexes far apart (op i and op i + n/2 in other
    blocks) report the pre-batch bit; n_valid 0, 1 and n, both values; two
    calls back to back on one plane."""
    rng = np.random.default_rng(n)
    size = 1 << 16
    idx = _bitset_idx(rng, n, size, dup=0.0, edges=n >= 16)
    half = n // 2
    idx[half:half + min(half, 64)] = idx[:min(half, 64)]
    idx[n - 1] = idx[0]
    idx = torch.from_numpy(idx).to(dev)
    plane = (torch.rand(size, device=dev) < 0.3).to(torch.uint8)
    for n_valid in sorted({0, 1, n}):
        for value in (0, 1):
            a, b = plane.clone(), plane.clone()
            _, old_k = K.bitset_set(a, idx, n_valid, value)
            _, old_p = K.bitset_set_plain(b, idx, n_valid, value)
            _, again_k = K.bitset_set(a, idx.flip(0), n_valid, 1 - value)
            _, again_p = K.bitset_set_plain(b, idx.flip(0), n_valid, 1 - value)
            torch.cuda.synchronize()
            assert torch.equal(old_k, old_p) and torch.equal(again_k, again_p), (n_valid, value)
            assert torch.equal(a, b), (n_valid, value)


def _kernels_a_call(fn, attempts=3):
    """The kernels one call of fn launches, from a torch.profiler trace; a
    trace that comes back empty (CUPTI does so now and then) is taken again,
    up to `attempts` traces."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [x for x in names if not x.startswith(("Memset", "Memcpy"))]
        if kernels:
            return kernels
    return kernels


def test_bitset_set_and_kmeans_assign_launch_one_kernel_a_call(dev):
    """torch.profiler sees one kernel per bitset_set call (both forms) and
    per kmeans_assign call (the widths of both routes)."""
    plane = torch.zeros(1 << 20, dtype=torch.uint8, device=dev)
    for n in (500, 1 << 18):
        idx = torch.randint(0, 1 << 20, (n,), dtype=torch.int32, device=dev)
        assert len(_kernels_a_call(lambda: K.bitset_set(plane, idx, n, 1))) == 1, n
    for w in (128, 300):  # the tensor-core route, the tile route
        p, c = torch.randn((3000, w), device=dev), torch.randn((300, w), device=dev)
        wt = torch.ones(3000, device=dev)
        assert len(_kernels_a_call(lambda: K.kmeans_assign(p, wt, c))) == 1, w


def _bitset_table(dev, case):
    """(planes, host int32 indexes, values) of a level: config 5's fanout
    (128 1 MiB planes, 500 indexes below 100,000 each; all reads or all
    sets), or an edge table: planes of different sizes (one past 1 MiB),
    negative and out-of-plane indexes, repeats, one-op groups, gets and
    both values; "edges" has set groups past 2,048 ops (the cooperative
    form), "edges-blocks" none (one block a group)."""
    rng = np.random.default_rng(len(case))
    if case in ("fanout-get", "fanout-set"):
        sizes, counts = [1 << 20] * 128, [500] * 128
        values = [None] * 128 if case == "fanout-get" else [1] * 128
        hi = [100_000] * 128
    else:
        sizes = [4096, 4099, (1 << 21) + 4096, 100, 4096, 1 << 16, 7, 1 << 20]
        counts = [300, 1, 700, 50, 1, 5000 if case == "edges" else 2000, 20, 2100 if case == "edges" else 900]
        values = [None, 1, 1, 0, None, 0, None, 1]
        hi = [2 * s for s in sizes]
    planes = [(torch.rand(s, device=dev) < 0.4).to(torch.uint8) for s in sizes]
    idx = []
    for n, h in zip(counts, hi):
        a = rng.integers(-h if case.startswith("edges") else 0, h, n).astype(np.int32)
        a[n // 2:] = a[: n - n // 2]
        if n >= 10 and case.startswith("edges"):
            a[:6] = [-1, 2**31 - 1, -(2**31), 0, h, -h]
        idx.append(a)
    return planes, idx, values


@pytest.mark.parametrize("case", ["fanout-get", "fanout-set", "edges", "edges-blocks"])
def test_bitset_groups_match_plain(dev, case):
    """The table form against its plain version on clones of the planes,
    bit for bit: replies (at the firsts reported) and every plane."""
    planes, idx, values = _bitset_table(dev, case)
    ref = [p.clone() for p in planes]
    got, firsts = K.bitset_groups(planes, idx, values)
    want, _ = K.bitset_groups_plain(ref, torch.from_numpy(np.concatenate(idx)).to(dev), [a.size for a in idx], values)
    torch.cuda.synchronize()
    off = 0
    for a, f in zip(idx, firsts):
        assert torch.equal(got[f:f + a.size], want[off:off + a.size])
        off += a.size
    for p, r in zip(planes, ref):
        assert torch.equal(p, r)


def test_bitset_groups_launch_one_kernel_a_verb(dev):
    """torch.profiler: a level of 128 reads is one kernel, of 128 sets one
    kernel, a mixed level two (the upload is a copy, not a kernel)."""
    for case, want in (("fanout-get", 1), ("fanout-set", 1), ("edges-blocks", 2), ("edges", 2)):
        planes, idx, values = _bitset_table(dev, case)
        assert len(_kernels_a_call(lambda: K.bitset_groups(planes, idx, values))) == want, case


@pytest.mark.parametrize("overlap", [True, False])
def test_rbatch_on_the_card_matches_the_cpu(dev, overlap):
    """chip_smoke's RBatch stream (every verb; plain, skip_result and
    atomic batches; an op whose error lands on its future): equal replies
    and final states on the card and the CPU."""
    import redisson_tpu_torch
    from chip_smoke import rbatch_stream, same

    assert same(rbatch_stream(redisson_tpu_torch.create(), np.random.default_rng(8), overlap),
                rbatch_stream(redisson_tpu_torch.create(device="cpu"), np.random.default_rng(8), overlap))


def test_fused_add_on_the_card_leaves_every_record_its_own_storage(dev):
    import redisson_tpu_torch
    from redisson_tpu_torch.core import coalesce

    c = redisson_tpu_torch.create()
    names = [f"own:{i}" for i in range(6)]
    for n in names:
        c.get_bloom_filter(n).try_init(10_000, 0.01)
    planes = [c.engine.store.get(n).arrays["bits"] for n in names]
    newly, _ = coalesce.fused_bloom_add_async(c.engine, names, [np.arange(100, dtype=np.int64) + i for i in range(6)])
    assert bool(newly[:600].all())
    after = [c.engine.store.get(n).arrays["bits"] for n in names]
    assert all(a is b and a.device.type == "cuda" for a, b in zip(planes, after))
    assert len({p.untyped_storage().data_ptr() for p in after}) == len(names)
    for i, n in enumerate(names):
        assert c.get_bloom_filter(n).contains_each(np.arange(100, dtype=np.int64) + i).all()


def test_staging_pool_on_the_card_reuses_pinned_slots(dev):
    import redisson_tpu_torch
    from redisson_tpu_torch.core import ioplane

    c = redisson_tpu_torch.create()
    pool = c.engine.staging_pool()
    assert pool is not None
    arr = np.arange(5000, dtype=np.int32)
    staged = [K.pack_rows(arr + i, arr, size=8192, device=dev, pool=pool) for i in range(6)]
    torch.cuda.synchronize()
    for i, s in enumerate(staged):
        assert s[0, :5000].tolist() == (arr + i).tolist() and not s[:, 5000:].any()
    assert 1 <= pool.slot_count() <= 2 and all(s.pinned.is_pinned() for s in pool._slots)
    f = ioplane.ReadbackFuture((staged[0][0, :4], staged[1][1, :2].to(torch.bool)))
    ioplane.force_all([f])
    a, b = f.result()
    assert a.tolist() == [0, 1, 2, 3] and b.tolist() == [False, True]


def test_staging_pool_on_the_card_fills_a_second_slot_while_a_copy_is_in_flight(dev):
    """With the first slot's copy held in flight behind a spin on the
    stream, the next pack fills a second slot instead of waiting; the third
    finds both copies in flight and waits on one, counted as a staging
    wait; every staged tensor still carries its own bytes."""
    from redisson_tpu_torch.core import ioplane

    pool = ioplane.StagingPool(depth=2, pin=True)
    arr = np.arange(5000, dtype=np.int32)
    torch.cuda.synchronize()
    waits = ioplane.STATS.snapshot()["staging_waits"]
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the stream, ahead of every copy
    first = K.pack_rows(arr, arr, size=8192, device=dev, pool=pool)
    second = K.pack_rows(arr + 1, arr, size=8192, device=dev, pool=pool)
    assert pool.slot_count() == 2 and not pool._slots[0].staged.query()
    assert ioplane.STATS.snapshot()["staging_waits"] == waits
    third = K.pack_rows(arr + 2, arr, size=8192, device=dev, pool=pool)
    assert pool.slot_count() == 2 and pool.oneoffs == 0
    assert ioplane.STATS.snapshot()["staging_waits"] == waits + 1
    torch.cuda.synchronize()
    for i, s in enumerate((first, second, third)):
        assert s[0, :5000].tolist() == (arr + i).tolist() and not s[:, 5000:].any()


# --------------------------------------------------------------------------
# word count and KernelMapReduce kernels
# --------------------------------------------------------------------------

def _text(rng, n_words, long_every=0, pad=True):
    """Normalised text: words of 1-12 letters (one of `long_every` 64-300
    bytes long), separated by 1-3 spaces, padded with spaces to a bucket
    size unless `pad` is False (then the last byte is a letter)."""
    parts = []
    for i in range(n_words):
        ln = int(rng.integers(64, 300)) if long_every and i % long_every == 0 else int(rng.integers(1, 13))
        parts.append(bytes(rng.integers(33, 127, ln).astype(np.uint8)) + b" " * int(rng.integers(1, 4)))
    text = b"".join(parts)
    if not pad:
        text = text.rstrip(b" ")
        return np.frombuffer(text, np.uint8).copy()
    buf = np.full(K.bucket_size(len(text)), 32, np.uint8)
    buf[: len(text)] = np.frombuffer(text, np.uint8)
    return buf


def _ends(buf):
    ws = buf == 32
    return int(np.count_nonzero(~ws & np.concatenate([ws[1:], [True]])))


def _same(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("case", ["short", "long-words", "unpadded", "leading-space", "one-word"])
def test_wc_extract_words_auto_matches_plain(dev, case):
    rng = np.random.default_rng(len(case))
    buf = {"short": lambda: _text(rng, 3000),
           "long-words": lambda: _text(rng, 2000, long_every=7),
           "unpadded": lambda: _text(rng, 5000, pad=False),
           "leading-space": lambda: np.concatenate([np.full(9000, 32, np.uint8), _text(rng, 10)]),
           "one-word": lambda: np.full(10000, 65, np.uint8)}[case]()
    t = torch.from_numpy(buf).to(dev)
    found = _ends(buf)
    for n_words, eb in ((found, K.bucket_size(max(1, found))), (found, max(1, found // 2)),
                        (0, 256), (found + 5, min(buf.size, found + 300)), (3, 1)):
        for base in (0, 2**32 - 3):
            _same(K.wc_extract_words_auto(t, n_words, eb, base),
                  K.wc_extract_words_auto_plain(t, n_words, eb, base))


def test_wc_extract_words_deltas_match_plain(dev):
    rng = np.random.default_rng(2)
    buf = _text(rng, 4000, long_every=11)
    t = torch.from_numpy(buf).to(dev)
    ws = buf == 32
    ends = np.nonzero(~ws & np.concatenate([ws[1:], [True]]))[0]
    true_deltas = np.diff(np.concatenate([[-1], ends]))
    for deltas in (true_deltas, rng.integers(0, 65536, 9000), np.zeros(300, np.int64),
                   rng.integers(0, 3, 5000)):
        d = torch.from_numpy(deltas.astype(np.int32)).to(dev)
        for n_words in (len(deltas), len(deltas) // 3, 0):
            _same(K.wc_extract_words(t, d, n_words, 12345),
                  K.wc_extract_words_plain(t, d, n_words, 12345))


@pytest.mark.parametrize("n", [1, 2, 4095, 4096, 4097, 70001])
def test_wc_sort_runs_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    for distinct in (1, 50, n):
        ids = rng.integers(0, distinct, n)
        words = rng.integers(0, 2**32, (distinct, 2), dtype=np.uint64).astype(np.uint32)
        words[0] = [0xFFFFFFFF, 0xFFFFFFFF]  # the sentinel key sorts last
        if distinct > 2:
            words[1] = [0x80000000, 0]  # the top bit of ha is no sign
            words[2] = [0, 0x80000000]
        ha, hb = (torch.from_numpy(words[ids, j].view(np.int32)).to(dev) for j in (0, 1))
        st = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)
        for d_max in (1, 7, n, n + 10, 1 << 17):
            got = K.wc_sort_runs(ha, hb, st, d_max)
            want = K.wc_sort_runs_plain(ha, hb, st, d_max)
            torch.cuda.synchronize()
            assert got.shape == want.shape == (2, min(n, d_max))
            assert torch.equal(got, want), (distinct, d_max)


def _sort_words(keys):
    """(ha, hb) int32 tensors holding the uint32 halves of uint64 keys."""
    return ((keys >> np.uint64(32)).astype(np.uint32).view(np.int32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("n", [2**20 + 3, 2**22 + 5])
def test_wc_sort_runs_onesweep_edges(dev, n):
    """The one-sweep sort against the plain version bit for bit: keys that
    differ in one byte position only (each of the 8), and all keys equal
    (the starts show the order kept); d_max below n.  2**22 + 5 rows are
    1,025 tiles, more than the card keeps resident, so the look-back waits
    on tiles still running."""
    rng = np.random.default_rng(n)
    base = rng.integers(0, 2**64, dtype=np.uint64)
    st = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)
    cases = [np.full(n, base, np.uint64) ^ (rng.integers(0, 256, n).astype(np.uint64) << np.uint64(8 * b))
             for b in range(8)]
    cases.append(np.full(n, base, np.uint64))
    for keys in cases:
        ha, hb = (torch.from_numpy(x).to(dev) for x in _sort_words(keys))
        for d_max in (n // 3, 1 << 17):
            got = K.wc_sort_runs(ha, hb, st, d_max)
            want = K.wc_sort_runs_plain(ha, hb, st, d_max)
            torch.cuda.synchronize()
            assert torch.equal(got, want), d_max
    same = K.wc_sort_runs(ha, hb, st, n)  # all keys equal: one run, the starts in order
    torch.cuda.synchronize()
    assert int(same[0, 0]) == 0 and bool((same[0, 1:] == K.WC_BIG).all()) and torch.equal(same[1], st)


def test_wc_sort_region_bytes(dev):
    """The sort's zeroed scratch: a 64-bit look-back status word a tile of
    4,096 rows and digit, then each pass's digit counts and tile ticket."""
    from redisson_tpu_torch.core import _build

    lib = _build.library("wordcount")
    for n in (1, 4096, 4097, 2**20 + 3, 2**31 - 1):
        tiles = -(-n // 4096)
        assert lib.rtpu_wc_sort_region_bytes(n) == 8 * tiles * 256 + 4 * 8 * 257


def _float_sum_limit(keys, vals, n_keys):
    """The limit on two float32 sums of one key's zero-mean values added in
    different orders: 8 * 2**-24 * sqrt(count * sum v**2) a key.  One order's
    rounding error grows about as 2**-24 * count * rms(v) / sqrt(6), since
    the partial sums walk as sqrt(i) * rms(v); the limit is about four times
    the largest difference read on an H100 80GB HBM3 at 700 W (1.02 against
    3.9, 8,388,608 values of N(0, 1000) into 1,024 keys), and it bounds any
    order for counts up to 5."""
    k = keys.to(torch.int64)
    k = torch.where(k < 0, k + n_keys, k)
    keep = (k >= 0) & (k < n_keys)
    v = vals[keep].to(torch.float64)
    sq = torch.zeros(n_keys, dtype=torch.float64, device=vals.device).index_add_(0, k[keep], v * v)
    cnt = torch.zeros(n_keys, dtype=torch.float64, device=vals.device).index_add_(0, k[keep], torch.ones_like(v))
    return 8 * 2.0**-24 * torch.sqrt(cnt * sq)


@pytest.mark.parametrize("n_keys", [1, 7, 1024, 20000])
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64, torch.int16])
def test_segment_reduce_matches_plain(dev, n_keys, key_dtype):
    rng = np.random.default_rng(n_keys)
    n = 100_000
    hi = min(3 * n_keys, 30000)
    keys = torch.from_numpy(rng.integers(-hi, hi, n)).to(key_dtype).to(dev)
    ivals = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)).to(dev)
    fvals = torch.from_numpy(rng.normal(0, 1000, n).astype(np.float32)).to(dev)
    # whole floats whose partial sums all stay below 2**24 (100,000 * 100):
    # every order of the sum is exact, so it is held bit for bit
    whole = torch.from_numpy(rng.integers(-100, 101, n).astype(np.float32)).to(dev)
    for reduce in ("sum", "max", "min"):
        got = K.segment_reduce(keys, ivals, n_keys, reduce)
        want = K.segment_reduce_plain(keys, ivals, n_keys, reduce)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want), reduce
        got = K.segment_reduce(keys, whole, n_keys, reduce)
        want = K.segment_reduce_plain(keys, whole, n_keys, reduce)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and torch.equal(got, want), reduce
        got = K.segment_reduce(keys, fvals, n_keys, reduce)
        want = K.segment_reduce_plain(keys, fvals, n_keys, reduce)
        torch.cuda.synchronize()
        if reduce == "sum":
            err = (got.double() - want.double()).abs()
            assert bool((err <= _float_sum_limit(keys, fvals, n_keys)).all())
        else:
            assert torch.equal(got, want), reduce


def test_segment_reduce_empty_and_dropped(dev):
    keys = torch.tensor([5, -6, 6, -7, 2**40], dtype=torch.int64, device=dev)
    vals = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32, device=dev)
    for reduce in ("sum", "max", "min"):
        got = K.segment_reduce(keys, vals, 6, reduce)
        assert torch.equal(got, K.segment_reduce_plain(keys, vals, 6, reduce))
        empty = K.segment_reduce(keys[:0], vals[:0], 3, reduce)
        assert torch.equal(empty, K.segment_reduce_plain(keys[:0], vals[:0], 3, reduce))
    with pytest.raises(ValueError):
        K.segment_reduce(keys, vals.to(torch.int64), 6, "sum")


@pytest.mark.parametrize("case", list(E.wc_edge_buffers()))
def test_wc_words_tile_edges_match_plain(dev, case):
    """Both forms bit for bit against the plain version at wc_words' tile
    and halo edges, for each row case (eb below the end count, n_words past
    it, base near 2**32), on the buffer at its own allocation and as slices
    starting 1 to 15 bytes past a 16-byte boundary."""
    buf = E.wc_edge_buffers()[case]
    big = torch.full((buf.size + 32,), 32, dtype=torch.uint8, device=dev)
    for off in range(16):
        t = torch.from_numpy(buf).to(dev) if off == 0 else big[off: off + buf.size]
        if off:
            t.copy_(torch.from_numpy(buf).to(dev))
            assert t.data_ptr() % 16 == off
        for n_words, eb, base in E.wc_row_cases(buf) if off in (0, 7) else E.wc_row_cases(buf)[:1]:
            _same(K.wc_extract_words_auto(t, n_words, eb, base), K.wc_extract_words_auto_plain(t, n_words, eb, base))
            d = torch.from_numpy(E.true_deltas(buf, eb).astype(np.int32)).to(dev)
            _same(K.wc_extract_words(t, d, n_words, base), K.wc_extract_words_plain(t, d, n_words, base))


def test_wc_words_auto_three_calls_in_a_row_are_equal(dev):
    """The look-back region is shared by every call on a stream and never
    cleared: three calls in a row (and calls on other sizes between them)
    give the plain version's rows."""
    rng = np.random.default_rng(12)
    big = torch.from_numpy(_text(rng, 60000)).to(dev)
    small = torch.from_numpy(_text(rng, 300)).to(dev)
    found = _ends(big.cpu().numpy())
    want = K.wc_extract_words_auto_plain(big, found, found, 3)
    for _ in range(3):
        _same(K.wc_extract_words_auto(big, found, found, 3), want)
        f = _ends(small.cpu().numpy())
        _same(K.wc_extract_words_auto(small, f, f, 0), K.wc_extract_words_auto_plain(small, f, f, 0))


def test_wc_words_rows_at_an_offset_of_a_stream(dev):
    """out= and at= put a chunk's rows at their place in the stream's
    tensors, the other rows untouched."""
    rng = np.random.default_rng(8)
    chunks = [torch.from_numpy(_text(rng, n)).to(dev) for n in (500, 900)]
    ebs = [_ends(c.cpu().numpy()) for c in chunks]
    stream = [torch.full((sum(ebs) + 5,), 7, dtype=torch.int32, device=dev) for _ in range(3)]
    at = 0
    for c, eb in zip(chunks, ebs):
        got = K.wc_extract_words_auto(c, eb, eb, at, out=stream, at=at)
        _same(got, K.wc_extract_words_auto_plain(c, eb, eb, at))
        at += eb
    torch.cuda.synchronize()
    assert all(bool((t[at:] == 7).all()) for t in stream)
    with pytest.raises(ValueError):
        K.wc_extract_words_auto(chunks[0], ebs[0], ebs[0], 0, out=stream, at=sum(ebs))


def test_wc_words_auto_and_segment_reduce_launch_one_kernel_a_call(dev):
    """torch.profiler: one kernel a wc_words call in the auto form and a
    segment_reduce call within the shared limit; two past it."""
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(_text(rng, 20000)).to(dev)
    found = _ends(buf.cpu().numpy())
    assert len(_kernels_a_call(lambda: K.wc_extract_words_auto(buf, found, K.bucket_size(found), 0))) == 1
    keys = torch.randint(-100, 2000, (1 << 20,), dtype=torch.int32, device=dev)
    vals = torch.randint(-1000, 1000, (1 << 20,), dtype=torch.int32, device=dev)
    limit = K.segment_shared_keys(dev)
    for n_keys, want in ((1024, 1), (limit, 1), (limit + 1, 2)):
        assert len(_kernels_a_call(lambda: K.segment_reduce(keys, vals, n_keys, "sum"))) == want, n_keys


def _segment_all_equal(keys, n_keys, rng, nan=False):
    """Every op and value type at these keys against the plain version:
    int32 exact, whole float32 values exact (sum too), N(0, 1000) float32
    max and min exact and its sum within _float_sum_limit; with nan, one
    value in 97 NaN, kept by max and min."""
    n = keys.numel()
    dev = keys.device
    ivals = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)).to(dev)
    whole = torch.from_numpy(rng.integers(-100, 101, n).astype(np.float32)).to(dev)
    fvals = torch.from_numpy(rng.normal(0, 1000, n).astype(np.float32)).to(dev)
    if nan:
        fvals[::97] = float("nan")
    for reduce in K.SEGMENT_OPS:
        for v in (ivals, whole, fvals):
            got = K.segment_reduce(keys, v, n_keys, reduce)
            want = K.segment_reduce_plain(keys, v, n_keys, reduce)
            torch.cuda.synchronize()
            assert got.dtype == v.dtype and got.shape == want.shape
            if v is fvals and reduce == "sum":
                assert torch.equal(got.isnan(), want.isnan())
                keep = ~want.isnan()
                err = (got[keep].double() - want[keep].double()).abs()
                assert bool((err <= _float_sum_limit(keys, fvals.nan_to_num(0.0), n_keys)[keep]).all())
            else:
                assert torch.equal(got.isnan(), want.isnan()), reduce
                assert torch.equal(got[~got.isnan()], want[~want.isnan()]), (reduce, v.dtype)


@pytest.mark.parametrize("case", list(E.segment_edge_cases()))
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_segment_reduce_share_edges_match_plain(dev, case, key_dtype):
    keys, _, n_keys = E.segment_edge_cases()[case]
    rng = np.random.default_rng(len(case))
    _segment_all_equal(torch.from_numpy(keys).to(key_dtype).to(dev), n_keys, rng, nan=keys.size > 100)


def test_segment_reduce_at_and_past_the_shared_limit(dev):
    """n_keys at the shared limit (one launch) and one past it (a fill and
    global atomics), keys up to 3 x n_keys either side."""
    limit = K.segment_shared_keys(dev)
    assert limit >= 12288
    rng = np.random.default_rng(5)
    for n_keys in (limit, limit + 1):
        for key_dtype in (torch.int32, torch.int64):
            keys = torch.from_numpy(rng.integers(-3 * n_keys, 3 * n_keys, 300_000)).to(key_dtype).to(dev)
            _segment_all_equal(keys, n_keys, rng, nan=True)


def test_segment_reduce_unaligned_operands_and_repeats(dev):
    """Keys and values starting 1-3 elements past a 16-byte boundary (the
    head before the aligned groups, or element loads when the two cannot
    align together), NaN in max and min, and three calls in a row equal."""
    rng = np.random.default_rng(9)
    n = 100_003
    keys = torch.from_numpy(rng.integers(-1500, 1500, n + 8)).to(dev)
    vals = torch.from_numpy(rng.normal(0, 10, n + 8).astype(np.float32)).to(dev)
    vals[::1001] = float("nan")
    for key_dtype in (torch.int32, torch.int64):
        k = keys.to(key_dtype)
        for ko, vo in ((1, 1), (2, 2), (3, 3), (1, 2), (0, 3)):
            kk, vv = k[ko: ko + n], vals[vo: vo + n]
            for reduce in ("max", "min"):
                want = K.segment_reduce_plain(kk, vv, 1000, reduce)
                outs = [K.segment_reduce(kk, vv, 1000, reduce) for _ in range(3)]
                torch.cuda.synchronize()
                for got in outs:
                    assert torch.equal(got.isnan(), want.isnan())
                    assert torch.equal(got[~got.isnan()], want[~want.isnan()]), (key_dtype, ko, vo, reduce)
            iv = (vv.nan_to_num(0.0) * 100).to(torch.int32)
            want = K.segment_reduce_plain(kk, iv, 1000, "sum")
            for _ in range(3):
                assert torch.equal(K.segment_reduce(kk, iv, 1000, "sum"), want)


def test_word_count_on_the_card_counts_launches(dev):
    import redisson_tpu_torch
    from redisson_tpu_torch.client.codec import StringCodec
    from redisson_tpu_torch.services import mapreduce as MR

    rng = np.random.default_rng(4)
    vals = [" ".join(f"w{j}" for j in rng.integers(0, 300, 8)) for _ in range(5000)]
    client = redisson_tpu_torch.create()
    m = client.get_map("wc", codec=StringCodec())
    m.put_all({f"d{i}": v for i, v in enumerate(vals)})
    K.reset_launches()
    assert MR.word_count(m) == MR._host_word_count(vals)
    assert K.launches["wc_words"] == 2 and K.launches["wc_sort_runs"] == 1
    assert MR.word_count(m) == MR._host_word_count(vals)  # the staged view
    assert K.launches["wc_words"] == 2 and K.launches["wc_sort_runs"] == 2
    kmr = MR.KernelMapReduce(lambda v: (v % 64, v), "max", 64)
    x = rng.integers(-1000, 1000, 10000).astype(np.int32)
    want = np.full(64, np.iinfo(np.int32).min, np.int32)
    np.maximum.at(want, x % 64, x)
    assert np.array_equal(kmr.execute(x), want) and K.launches["segment_reduce"] == 1
    client.shutdown()


def test_device_word_count_past_d_max_sorts_again_on_the_card(dev):
    from redisson_tpu_torch.services import mapreduce as MR

    vals = [" ".join(f"w{i}" for i in range(j, j + 50)) for j in range(0, 3000, 50)]
    MR.reset_stats()
    K.reset_launches()
    assert MR.device_word_count(vals, d_max_bits=8) == MR._host_word_count(vals)
    assert K.launches["wc_sort_runs"] == 2
    assert MR.STATS == {"device_scans": 1, "view_hits": 0, "host_fallbacks": 0}


# -- vector search: knn_score, knn_select, ivf_score, kmeans ------------------


def _vec_bank(rng, cap, w, dtype, dev):
    rows = rng.standard_normal((cap, w)).astype(np.float32)
    rows[5:8] = rows[1:4]  # exact duplicates: ties
    rows[9] = 0.0
    scale = None
    if dtype == "FLOAT16":
        bank = torch.from_numpy(rows.astype(np.float16))
    elif dtype == "INT8":
        sc = np.abs(rows).max(1) / 127.0
        sc[sc == 0] = 1.0
        bank = torch.from_numpy(np.clip(np.rint(rows / sc[:, None]), -127, 127).astype(np.int8))
        scale = torch.from_numpy(sc.astype(np.float32)).to(dev)
    else:
        bank = torch.from_numpy(rows)
    return bank.to(dev), scale


def _dist_scale(rows, q, metric):
    """The size of the terms a distance is made of: |q|^2 + |b|^2 for L2,
    |q| |b| for IP, 1 for COSINE."""
    if metric == "L2":
        return float((q * q).sum(1).max() + (rows * rows).sum(1).max())
    if metric == "IP":
        return max(1.0, float(q.norm(dim=1).max() * rows.norm(dim=1).max()))
    return 1.0


def _near(got, want, scale):
    """Within 1e-5 of the distance's scale: the kernel and torch add a dot
    product's terms in different orders."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    err = ((got - want).abs() / scale)[fin]
    assert err.numel() == 0 or float(err.max()) <= 1e-5, float(err.max())


def _ids_outside_near_ties(got_i, want_i, want_d, tol=1e-5):
    """Ids equal wherever the plain version's distances leave a gap above
    tol (relative) on both sides of the place; +inf places not compared."""
    d = want_d.double()
    gap = (d[:, 1:] - d[:, :-1]).abs() > tol * d[:, 1:].abs().clamp(min=1.0)
    ok = torch.ones_like(d, dtype=torch.bool)
    ok[:, 1:] &= gap
    ok[:, :-1] &= gap
    ok &= torch.isfinite(d)
    assert torch.equal(got_i[ok], want_i[ok])


@pytest.mark.parametrize("qn", [1, 8, 64, 65])
@pytest.mark.parametrize("dtype", ["FLOAT32", "FLOAT16", "INT8"])
@pytest.mark.parametrize("metric", ["L2", "COSINE", "IP"])
def test_knn_score_matches_plain(dev, metric, dtype, qn):
    rng = np.random.default_rng(qn)
    cap, w = 1000, 70  # W not a multiple of the 32-lane depth step
    bank, scale = _vec_bank(rng, cap, w, dtype, dev)
    bias = torch.zeros(cap, device=dev)
    bias[[3, 500]] = float("inf")
    q = torch.from_numpy(rng.standard_normal((qn, w)).astype(np.float32)).to(dev)
    q[0] = 0.0
    qbias = torch.where(torch.rand((qn, cap), device=dev) < 0.2, float("inf"), 0.0)
    for qb in (None, qbias):
        got = K.knn_score(bank, scale, bias, qb, q, 900, metric)
        stream = K.knn_score(bank, scale, bias, qb, q, 900, metric, route=K.KNN_STREAM_ELEMS)
        want = K.knn_score_plain(bank, scale, bias, qb, q, 900, metric)
        torch.cuda.synchronize()
        s = _dist_scale(K._bank_f32(bank, scale), q, metric)
        _near(got, want, s)
        _near(stream, want, s)  # the streamed route on a narrow bank, whatever the query count
        assert torch.isinf(got[:, 900:]).all() and torch.isinf(got[:, 3]).all()
        assert torch.isinf(stream[:, 900:]).all() and torch.isinf(stream[:, 3]).all()


def _unaligned(bank):
    """The same rows in a storage whose base lies one element past a 16-byte
    boundary (a contiguous view)."""
    flat = torch.empty(bank.numel() + 1, dtype=bank.dtype, device=bank.device)
    view = flat[1:].view(bank.shape)
    view.copy_(bank)
    return view


@pytest.mark.parametrize("w", [1, 3, 64, 70, 128, 129])
@pytest.mark.parametrize("cap", [20001, 70001])
@pytest.mark.parametrize("dtype", ["FLOAT32", "FLOAT16", "INT8"])
def test_knn_score_wide_banks_match_plain(dev, dtype, cap, w):
    """Banks past the narrow bank of 16,384 rows: the chosen route and the
    tile route against the plain version, every metric, 9, 64 and 65
    queries, with and without a per-query bias; a second run gives the same
    bits."""
    rng = np.random.default_rng(cap + w)
    bank, scale = _vec_bank(rng, cap, w, dtype, dev)
    n_rows = cap - 1001
    bias = torch.zeros(cap, device=dev)
    bias[[3, cap // 2]] = float("inf")
    rows = K._bank_f32(bank, scale)
    for qn in (9, 64, 65):
        q = torch.from_numpy(rng.standard_normal((qn, w)).astype(np.float32)).to(dev)
        q[0] = 0.0
        qbias = torch.where(torch.rand((qn, cap), device=dev) < 0.2, float("inf"), 0.0)
        for metric in ("L2", "COSINE", "IP"):
            s = _dist_scale(rows, q, metric)
            for qb in (None, qbias):
                want = K.knn_score_plain(bank, scale, bias, qb, q, n_rows, metric)
                got = K.knn_score(bank, scale, bias, qb, q, n_rows, metric)
                tile = K.knn_score(bank, scale, bias, qb, q, n_rows, metric, route=K.KNN_TILE)
                torch.cuda.synchronize()
                _near(got, want, s)
                _near(tile, want, s)
                assert torch.isinf(got[:, n_rows:]).all() and torch.isinf(got[:, 3]).all()
        again = K.knn_score(bank, scale, bias, None, q, n_rows, "L2")
        first = K.knn_score(bank, scale, bias, None, q, n_rows, "L2")
        torch.cuda.synchronize()
        assert torch.equal(again.view(torch.int32), first.view(torch.int32))


@pytest.mark.parametrize("dtype", ["FLOAT32", "FLOAT16", "INT8"])
def test_knn_score_unaligned_bank_takes_element_loads(dev, dtype):
    """A bank whose rows start off a 16-byte boundary takes the streamed
    route's element loads, with the same bits as the 16-byte copies of the
    same rows; the copies refuse it."""
    rng = np.random.default_rng(11)
    cap, w = 20001, 128
    bank, scale = _vec_bank(rng, cap, w, dtype, dev)
    moved = _unaligned(bank)
    q = torch.from_numpy(rng.standard_normal((64, w)).astype(np.float32)).to(dev)
    assert K.knn_score_route(bank, q) == K.KNN_STREAM_VEC
    assert K.knn_score_route(moved, q) == K.KNN_STREAM_ELEMS
    for metric in ("L2", "COSINE", "IP"):
        got = K.knn_score(moved, scale, None, None, q, cap, metric)
        vec = K.knn_score(bank, scale, None, None, q, cap, metric)
        want = K.knn_score_plain(bank, scale, None, None, q, cap, metric)
        torch.cuda.synchronize()
        _near(got, want, _dist_scale(K._bank_f32(bank, scale), q, metric))
        assert torch.equal(got.view(torch.int32), vec.view(torch.int32))
    with pytest.raises(RuntimeError):
        K.knn_score(moved, scale, None, None, q, cap, "L2", route=K.KNN_STREAM_VEC)


@pytest.mark.parametrize("n", [1, 31, 4096, 4097, 70001])
@pytest.mark.parametrize("k", [1, 10, 32, 33, 256, 257, 700])
def test_knn_select_matches_plain(dev, n, k):
    if k > n:
        k = n
    rng = np.random.default_rng(n * 1000 + k)
    d = torch.from_numpy(rng.standard_normal((5, n)).astype(np.float32)).to(dev)
    d[0] = 1.0                       # one value: every tie to the lower column
    d[1, ::3] = float("inf")
    d[2] = float("inf")
    d[3, ::2] = float(d[3, 0])
    d[4, : n // 2] = -0.0
    ids = torch.from_numpy(rng.integers(0, 2**31 - 1, (5, n)).astype(np.int32)).to(dev)
    for with_ids in (None, ids):
        gv, gi = K.knn_select(d, k, with_ids)
        wv, wi = K.knn_select_plain(d, k, with_ids)
        torch.cuda.synchronize()
        assert torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32))


def _select_rows(rng, r, n):
    """r rows of n: one of each hard kind, then random rows."""
    d = rng.standard_normal((r, n)).astype(np.float32)
    d[0] = 1.0                              # one value: every tie to the lower column
    d[1, ::3] = np.inf
    d[2] = np.inf                           # every key +inf
    d[3, : n // 2] = -0.0                   # -0.0 below +0.0, each tie by column
    d[3, n // 2:] = 0.0
    d[4] = rng.integers(0, 3, n)            # three values: equal keys across every segment boundary
    d[5] = np.arange(n, 0, -1)              # descending: every column is a new best
    d[6, ::2] = d[6, 0]
    d[7] = -np.inf
    return d


def _select_equal(d, k, ids=None):
    gv, gi = K.knn_select(d, k, ids)
    wv, wi = K.knn_select_plain(d, k, ids)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32))


@pytest.mark.parametrize("n", [K.SELECT_SMALL - 1, K.SELECT_SMALL, K.SELECT_SMALL + 1, 4099, 40001, 70001])
@pytest.mark.parametrize("k", [1, 10, 256, 257])
def test_knn_select_one_launch_design_matches_plain(dev, n, k):
    """Rows just under and over the one-warp limit, rows of one and of
    several segments (the last block's merge), lengths that leave unaligned
    ends, equal keys across segment boundaries, all +inf, -0.0 and +0.0, k
    past a round of 256; 19 rows (more than a block's 8 warps), two calls in
    a row (each leaves the rows' tickets and bounds reset for the next)."""
    rng = np.random.default_rng(n + k)
    r = 19
    d = torch.from_numpy(_select_rows(rng, r, n)).to(dev)
    ids = torch.from_numpy(rng.integers(0, 2**31 - 1, (r, n)).astype(np.int32)).to(dev)
    plan = K.knn_select_plan(r, n, k, K._sm_count(d.device))
    assert (plan.segs == 0) == (n <= K.SELECT_SMALL)
    if n >= 40001:
        assert plan.segs > 1
    for with_ids in (None, ids, None):
        _select_equal(d, k, with_ids)
    _select_equal(d[:3], k)  # fewer rows than the state holds
    _select_equal(d, k)


@pytest.mark.parametrize("n", [5, 100, K.SELECT_SMALL + 1, 4097, 9001])
def test_knn_select_k_equal_n_and_unaligned_rows(dev, n):
    """k = n (every key, in rounds of 256), and a matrix whose base lies one
    element past a 16-byte boundary (every row's ends take element loads)."""
    rng = np.random.default_rng(n)
    d = torch.from_numpy(_select_rows(rng, 9, n)).to(dev)
    _select_equal(d, n)
    moved = _unaligned(d)
    for k in sorted({1, min(n, 10), min(n, 300)}):
        _select_equal(moved, k)


def test_knn_select_past_65535_rows(dev):
    rng = np.random.default_rng(2)
    d = torch.from_numpy(rng.standard_normal((70000, 40)).astype(np.float32)).to(dev)
    _select_equal(d, 5)
    d = torch.from_numpy(rng.standard_normal((66000, 4100)).astype(np.float16).astype(np.float32)).to(dev)
    _select_equal(d, 3)


@pytest.mark.parametrize("case", ["random", "ties", "inf", "zeros"])
@pytest.mark.parametrize("n_legs", [1, 8])
def test_knn_sharded_merge_matches_plain(dev, n_legs, case):
    """K19 at its main-path shapes, (64, 10) and (64, 80): the legs' sorted
    top-ks concatenated and merged by one knn_select launch, equal to the
    plain version bit for bit, with ties across legs, +inf dead rows and
    -0.0 against +0.0."""
    rng = np.random.default_rng(n_legs * 7 + len(case))
    dists = []
    for _ in range(n_legs):
        d = rng.standard_normal((64, 10)).astype(np.float32)
        if case == "ties":
            d = (np.round(d * 2) / 2).astype(np.float32)
        elif case == "inf":
            d[rng.random(d.shape) < 0.4] = np.inf
        elif case == "zeros":
            m = rng.random(d.shape)
            d[m < 0.3] = 0.0
            d[(m >= 0.3) & (m < 0.6)] = -0.0
        dists.append(torch.from_numpy(np.sort(d, axis=1, kind="stable")).to(dev))
    idxs = [torch.from_numpy(rng.integers(0, 5000, (64, 10)).astype(np.int32)).to(dev)
            for _ in range(n_legs)]
    sop = torch.arange(n_legs, dtype=torch.int32, device=dev).repeat_interleave(10)
    for k in (1, 10, 10 * n_legs):
        K.reset_launches()
        got = K.knn_sharded_merge(dists, idxs, sop, k)
        assert K.launches["knn_select"] == 1
        want = K.knn_sharded_merge_plain(dists, idxs, sop, k)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.view(torch.int32), w.view(torch.int32))


def _ivf_cells(rng, nlist, ccap, n_rows):
    """Cells of row ids with the sentinel, negative ids and ids past n_rows
    anywhere in a cell, not only at its end."""
    cells = rng.integers(0, n_rows, (nlist, ccap)).astype(np.int32)
    holes = rng.random((nlist, ccap))
    cells[holes < 0.5] = 0x3FFFFFFF
    cells[(holes > 0.5) & (holes < 0.55)] = -3
    cells[(holes > 0.55) & (holes < 0.6)] = n_rows + 1
    cells[1] = 0x3FFFFFFF                   # an empty cell
    return cells


@pytest.mark.parametrize("dtype", ["FLOAT32", "FLOAT16", "INT8"])
@pytest.mark.parametrize("w", [70, 128, 200])
@pytest.mark.parametrize("ccap", [112, 300])
@pytest.mark.parametrize("qn", [9, 70])
def test_ivf_score_compacted_slots_match_plain(dev, dtype, w, ccap, qn):
    """Sentinels in the middle of cells, W 70 (element loads for float32,
    INT8), W 200 (a second chunk of the query), a cell cap past one batch of
    slots, an unaligned bank view (element loads), INT8 with its scale,
    FLOAT16; with and without the mask; 45 (query, probe) pairs and 350
    (blocks of 256 and of 128 threads).  ids bit for bit, distances within
    1e-5 of their scale."""
    rng = np.random.default_rng(w + ccap + qn)
    cap, nlist, n_rows = 3000, 16, 2900
    bank, scale = _vec_bank(rng, cap, w, dtype, dev)
    bias = torch.zeros(cap, device=dev)
    bias[::89] = float("inf")
    cells = torch.from_numpy(_ivf_cells(rng, nlist, ccap, cap)).to(dev)
    q = torch.from_numpy(rng.standard_normal((qn, w)).astype(np.float32)).to(dev)
    probe = torch.from_numpy(rng.integers(0, nlist, (qn, 5)).astype(np.int32)).to(dev)
    probe[0, 0] = 1
    qmask = torch.where(torch.rand(cap, device=dev) < 0.3, float("inf"), 0.0)
    for b in (bank, _unaligned(bank)):
        for metric in ("L2", "COSINE", "IP"):
            s = _dist_scale(K._bank_f32(bank, scale), q, metric)
            for qm in (None, qmask):
                gd, gids = K.ivf_score(b, scale, bias, qm, cells, probe, q, n_rows, metric)
                wd, wids = K.ivf_score_plain(bank, scale, bias, qm, cells, probe, q, n_rows, metric)
                torch.cuda.synchronize()
                assert torch.equal(gids, wids)
                _near(gd, wd, s)


@pytest.mark.parametrize("dtype", ["FLOAT32", "FLOAT16", "INT8"])
@pytest.mark.parametrize("metric", ["L2", "COSINE", "IP"])
def test_ivf_route_score_and_select_match_plain(dev, metric, dtype):
    rng = np.random.default_rng(7)
    cap, w, nlist, ccap, qn, n_rows = 2000, 36, 24, 112, 64, 1900
    bank, scale = _vec_bank(rng, cap, w, dtype, dev)
    bias = torch.zeros(cap, device=dev)
    bias[::97] = float("inf")
    cells = np.full((nlist, ccap), 0x3FFFFFFF, np.int32)
    assign = rng.integers(0, nlist, cap)
    for c in range(nlist):
        m = np.nonzero(assign == c)[0][:ccap]
        cells[c, : m.size] = m
    cells = torch.from_numpy(cells).to(dev)
    cent = torch.from_numpy(rng.standard_normal((nlist, w)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((qn, w)).astype(np.float32)).to(dev)
    qmask = torch.where(torch.rand(cap, device=dev) < 0.3, float("inf"), 0.0)
    route = K.knn_score(cent, None, None, None, q, nlist, metric)
    _, probe = K.knn_select(route, 4)
    for qm in (None, qmask):
        gd, gids = K.ivf_score(bank, scale, bias, qm, cells, probe, q, n_rows, metric)
        wd, wids = K.ivf_score_plain(bank, scale, bias, qm, cells, probe, q, n_rows, metric)
        torch.cuda.synchronize()
        assert torch.equal(gids, wids)
        s = _dist_scale(K._bank_f32(bank, scale), q, metric)
        _near(gd, wd, s)
        for k in (1, 10, 4 * ccap):
            gv, gi = K.knn_ivf_topk_masked_q(bank, scale, bias, qm if qm is not None else torch.zeros_like(bias),
                                             cent, cells, q, n_rows, k, 4, metric) if scale is not None else \
                K.knn_ivf_topk_masked(bank, bias, qm if qm is not None else torch.zeros_like(bias), cent, cells, q,
                                      n_rows, k, 4, metric)
            pv, pi = K.knn_select_plain(wd, k, wids)
            _near(gv, pv, s)
            _ids_outside_near_ties(gi, pi, pv)


def test_knn_topk_edges_on_the_card(dev):
    """k above the live rows, every row dead, exact duplicates, n_rows
    below capacity, k = 1 and k = cap, against the plain version."""
    rng = np.random.default_rng(3)
    bank, _ = _vec_bank(rng, 512, 16, "FLOAT32", dev)
    q = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).to(dev)
    q[1] = bank[5]
    live = torch.zeros(512, device=dev)
    dead = torch.full((512,), float("inf"), device=dev)
    for bias, n_rows, k in ((live, 300, 400), (dead, 512, 5), (live, 512, 1), (live, 512, 512), (live, 17, 10)):
        gv, gi = K.knn_topk(bank, bias, q, n_rows, k, "L2")
        pv, pi = K.knn_select_plain(K.knn_score_plain(bank, None, bias, None, q, n_rows, "L2"), k)
        torch.cuda.synchronize()
        s = _dist_scale(bank, q, "L2")
        _near(gv, pv, s)
        _ids_outside_near_ties(gi, pi, pv)
        assert int(torch.isfinite(gv).sum(1).max()) == min(k, n_rows if bias is live else 0)
    gv, gi = K.knn_topk(bank, live, q, 512, 2, "L2")
    assert gi[1].tolist() == [1, 5]  # the duplicate pair, lower index first


def _groups(c):
    """Each centroid's group of exact copies (int64), and each group's
    lowest index."""
    _, inv = torch.unique(c, dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), c.shape[0], dtype=torch.int64, device=c.device)
    first.scatter_reduce_(0, inv, torch.arange(c.shape[0], device=c.device), "amin")
    return inv, first


def _clear_of(p, c, gap):
    """Points whose nearest centroid (float64 of the float32 terms) stands
    more than `gap` (relative) from every centroid that is not an exact
    copy of it; all of them where every centroid is a copy of one."""
    d = ((p * p).sum(1)[:, None] - 2 * (p @ c.T) + (c * c).sum(1)[None, :]).double()
    inv, _ = _groups(c)
    best = d.argmin(1)
    other = torch.where(inv[None, :] == inv[best][:, None], torch.inf, d).min(1).values
    b = d.gather(1, best[:, None])[:, 0]
    return (other - b) > gap * b.abs().clamp(min=1.0)


# (N, W, L): the old shapes; every width the two routes meet (1, 7, 64, 128,
# 130, 256, 257) at every L (1, 3, 100, 1,536), N off the 128- and 64-point
# tiles
KMEANS_SHAPES = [(5000, 64, 100), (3000, 130, 7), (700, 1024, 3)] + [
    (1037, w, nlist) for w in (1, 7, 64, 128, 130, 256, 257) for nlist in (1, 3, 100, 1536)]


@pytest.mark.parametrize("shape", KMEANS_SHAPES)
def test_kmeans_step_matches_plain_and_repeats_its_bits(dev, shape):
    """The assign (the tensor-core route up to W 256, the tile route past
    it), then the update on its assignment: two runs equal bit for bit,
    assignments equal to the plain version's outside near-ties, dead rows
    -1, the centroids no differing point touches equal to the plain
    version's within 1e-5; exact duplicate centroids (the lower index
    wins)."""
    n, w, nlist = shape
    rng = np.random.default_rng(n)
    centers = rng.standard_normal((nlist, w)).astype(np.float32) * 3
    pts = (centers[rng.integers(nlist, size=n)] + 0.5 * rng.standard_normal((n, w))).astype(np.float32)
    weights = np.ones(n, np.float32)
    weights[rng.choice(n, n // 10, replace=False)] = 0.0
    pts[weights == 0] = 0.0
    live = np.nonzero(weights)[0]
    cent = pts[np.sort(rng.choice(live, nlist, replace=nlist > live.size))].copy()
    dup = nlist >= 6
    if dup:
        cent[nlist - 1] = cent[1]  # an exact copy of centroid 1: it can never win
    p, wt, c = (torch.from_numpy(a).to(dev) for a in (pts, weights, cent))
    wc, wa = K.kmeans_step_plain(p, wt, c)
    # exact copies of a centroid (the explicit one, and those of a point
    # drawn twice when L exceeds the live points) tie: the kernel gives the
    # lowest index of the copies, the plain version may round one copy's
    # distance below another's
    inv, first = _groups(c)
    live = wt > 0
    clear = _clear_of(p, c, 1e-4) & live
    route = K.kmeans_assign_route(p, c)
    ga = K.kmeans_assign(p, wt, c)
    ga2 = K.kmeans_assign(p, wt, c)
    gc = K.kmeans_update(p, wt, c, ga)
    gc2 = K.kmeans_update(p, wt, c, ga2)
    torch.cuda.synchronize()
    assert torch.equal(gc.view(torch.int32), gc2.view(torch.int32)) and torch.equal(ga, ga2), route
    assert torch.equal(ga == -1, wt == 0), route
    assert torch.equal(inv[ga[clear].long()], inv[wa[clear].long()]), route
    assert torch.equal(first[inv[ga[live].long()]], ga[live].long()), route
    if dup:
        assert not bool((ga == nlist - 1).any()), route
    # the cells a differing point leaves or joins may differ; every other
    # centroid is held to the plain version's
    moved = torch.zeros(nlist, dtype=torch.bool, device=dev)
    diff = (ga != wa).nonzero().reshape(-1)
    moved[ga[diff].long().clamp(min=0)] = True
    moved[wa[diff].long().clamp(min=0)] = True
    assert int((~moved).sum()) > 0, route
    err = float((gc[~moved] - wc[~moved]).abs().max()) / max(float(wc.abs().max()), 1e-30)
    assert err <= 1e-5, (route, err)
    gs, gas = K.kmeans_step(p, wt, c)
    torch.cuda.synchronize()
    assert torch.equal(gas, ga) and torch.equal(gs.view(torch.int32), gc.view(torch.int32))


@pytest.mark.parametrize("w", [7, 128, 257])
def test_kmeans_assign_every_point_dead_and_one_centroid(dev, w):
    """Every point dead: -1 everywhere; one centroid: every live point takes
    it (W 7 and 128 by the tensor-core route, 257 by the tile route)."""
    rng = np.random.default_rng(w)
    p = torch.from_numpy(rng.standard_normal((333, w)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal((5, w)).astype(np.float32)).to(dev)
    dead = torch.zeros(333, device=dev)
    half = (torch.arange(333, device=dev) % 2).to(torch.float32)
    assert K.kmeans_assign(p, dead, c).tolist() == [-1] * 333
    one = K.kmeans_assign(p, half, c[:1])
    assert torch.equal(one, torch.where(half > 0, 0, -1).to(torch.int32))
    assert torch.equal(K.kmeans_update(p, dead, c, torch.full((333,), -1, dtype=torch.int32, device=dev)), c)


@pytest.mark.parametrize("n", [1, 255, 257, 20000])
def test_kmeans_update_buckets_in_row_order(dev, n):
    """The update on given assignments (dead rows, empty cells, one cell
    holding most rows, N off the 256-row chunks): the plain version's means,
    the same bits on a second run."""
    rng = np.random.default_rng(n)
    nlist, w = 9, 40
    pts = torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32)).to(dev)
    weights = torch.from_numpy((rng.random(n) < 0.9).astype(np.float32)).to(dev)
    cent = torch.from_numpy(rng.standard_normal((nlist, w)).astype(np.float32)).to(dev)
    cells = np.where(rng.random(n) < 0.7, 4, rng.integers(0, 3, size=n)).astype(np.int32)  # 3, 5-8 stay empty
    assign = torch.from_numpy(cells).to(dev)
    assign[weights == 0] = -1
    got = K.kmeans_update(pts, weights, cent, assign)
    again = K.kmeans_update(pts, weights, cent, assign)
    want = K.kmeans_update_plain(pts, weights, cent, assign)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got[5:], cent[5:]) and torch.equal(got[3], cent[3])
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _update_reference(pts, w, cent, assign):
    """kmeans_update's contract in numpy float32: each cell's sum of point
    * weight and of weights in row order (np.add.at adds in index order,
    one rounding a term), divided by max(weights, 1); an empty cell keeps
    its centroid."""
    live = assign >= 0
    sums, cnt = np.zeros_like(cent), np.zeros(cent.shape[0], np.float32)
    np.add.at(sums, assign[live], pts[live] * w[live, None])
    np.add.at(cnt, assign[live], w[live])
    return np.where(cnt[:, None] > 0, sums / np.maximum(cnt, np.float32(1))[:, None], cent)


# (N, W, L, case): one cell holding most rows, or every row dead; config
# 7's training shape last
UPDATE_SHAPES = [(1, 40, 9, "skew"), (255, 40, 9, "skew"), (257, 40, 9, "skew"), (20000, 40, 9, "skew"),
                 (20000, 130, 300, "skew"), (3000, 1024, 5, "skew"), (257, 64, 9, "dead"),
                 (50000, 128, 1536, "spread"), (50000, 128, 1536, "skew")]


@pytest.mark.parametrize("shape", UPDATE_SHAPES)
def test_kmeans_update_equals_the_float32_row_order_reference(dev, shape):
    """The two-launch update bit for bit against the row-order reference:
    dead rows, empty cells, a cell holding most rows, every row dead."""
    n, w, nlist, case = shape
    rng = np.random.default_rng(n + w)
    pts = rng.standard_normal((n, w)).astype(np.float32)
    wt = (rng.random(n) < 0.9).astype(np.float32) * rng.random(n).astype(np.float32) * 2
    cent = rng.standard_normal((nlist, w)).astype(np.float32)
    assign = rng.integers(0, nlist, n).astype(np.int32)
    if case == "skew":
        assign = np.where(rng.random(n) < 0.7, nlist // 2, assign).astype(np.int32)
    assign[wt == 0] = -1
    if case == "dead":
        assign[:] = -1
    want = _update_reference(pts, wt, cent, assign)
    p, wt_t, c, a = (torch.from_numpy(x).to(dev) for x in (pts, wt, cent, assign))
    got = K.kmeans_update(p, wt_t, c, a)
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32))


# A child's tracing loop: `make(case)` (defined before it) gives the call;
# the child prints, a case each, its kernel count, null for an empty trace.
_CHILD_TRACE = """
import json, sys
from torch.profiler import ProfilerActivity, profile
out = []
for case in json.loads(sys.argv[1]):
    fn = make(case)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out.append(len([x for x in names if not x.startswith(("Memset", "Memcpy"))]) or None)
print(json.dumps(out))
"""


def _kernels_a_call_in_children(make_src: str, cases, attempts=3) -> dict:
    """The kernels one call launches for each case, traced by torch.profiler
    in a short child process (in a long process, such as this whole file
    run at once, its traces come back empty after the first few); a case
    whose trace came back empty is traced again in a fresh child, up to
    `attempts` children.  `make_src` defines make(case) -> the call, with
    torch, torch.device "cuda" as dev and kernels as K in scope."""
    head = ("import torch\nfrom redisson_tpu_torch.core import kernels as K\n"
            "dev = torch.device('cuda')\n")
    counts, left = {}, [list(c) for c in cases]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for _ in range(attempts):
        out = subprocess.run([sys.executable, "-c", head + make_src + _CHILD_TRACE, json.dumps(left)],
                             capture_output=True, text=True, timeout=600, cwd=root)
        assert out.returncode == 0, out.stderr[-4000:]
        counts.update(zip(map(tuple, left), json.loads(out.stdout.strip().splitlines()[-1])))
        left = [list(c) for c, v in counts.items() if v is None]
        if not left:
            break
    return counts


def test_kmeans_update_launches_at_most_two_kernels(dev):
    counts = _kernels_a_call_in_children("""
def make(case):
    n, w, nlist = case
    p, c = torch.randn((n, w), device=dev), torch.randn((nlist, w), device=dev)
    wt = torch.ones(n, device=dev)
    a = torch.randint(0, nlist, (n,), dtype=torch.int32, device=dev)
    return lambda: K.kmeans_update(p, wt, c, a)
""", ((50000, 128, 1536), (3000, 1024, 5), (1, 7, 1)))
    for case, n in counts.items():
        assert n is not None and 1 <= n <= 2, (case, n)


def _replies_agree(a, b, tol=1e-4):
    """Equal replies, but for docs that a near-tie swapped: at a place where
    the doc ids differ, the two (canonical, host-computed) scores must be
    within tol relative of each other."""
    assert len(a) == len(b)
    for call_a, call_b in zip(a, b):  # one knn call: a list per query
        assert len(call_a) == len(call_b)
        for ra, rb in zip(call_a, call_b):
            assert len(ra) == len(rb), (ra, rb)
            for (da, sa), (db, sb) in zip(ra, rb):
                if da == db:
                    assert sa == sb, (da, sa, sb)
                else:
                    assert abs(sa - sb) <= tol * max(1.0, abs(sa)), ((da, sa), (db, sb))


def test_search_on_the_card_matches_the_cpu_and_counts_launches(dev):
    """FLAT and IVF in every dtype, plain and hybrid, on the card and on the
    CPU: equal replies outside near-ties.  The CPU run installs the card's
    trained IVF index (its own k-means may differ in the last bits), and the
    IVF queries are those whose nprobe-th and next centroid differ by more
    than 1e-4 (relative, in float64), so both probe the same cells."""
    import redisson_tpu_torch
    from redisson_tpu_torch.services.search import Range

    def route_clear(cent, q, nprobe):
        c64, q64 = cent.astype(np.float64), q.astype(np.float64)
        cos = (q64 @ c64.T) / (np.linalg.norm(q64, axis=1)[:, None] * np.linalg.norm(c64, axis=1)[None, :])
        d = np.sort(1.0 - cos, axis=1)
        return (d[:, nprobe] - d[:, nprobe - 1]) > 1e-4 * np.maximum(1.0, np.abs(d[:, nprobe]))

    def stream(client, counts, snaps):
        rng = np.random.default_rng(9)
        svc = client.get_search()
        centers = rng.standard_normal((16, 24)).astype(np.float32)
        out = []
        for algo in ("FLAT", "IVF"):
            for dtype in ("FLOAT32", "FLOAT16", "INT8"):
                name = f"{algo}{dtype}"
                spec = {"dim": 24, "metric": "COSINE", "dtype": dtype, "algo": algo}
                if algo == "IVF":
                    spec.update(nlist=16, nprobe=4, train_min=256)
                svc.create_index(name, {"price": "NUMERIC", "emb": "VECTOR"}, vector={"emb": spec})
                vecs = (centers[rng.integers(16, size=1200)] + 0.3 * rng.standard_normal((1200, 24))).astype(np.float32)
                for i in range(1200):
                    svc.add_document(name, f"d{i}", {"price": i, "emb": vecs[i]})
                if counts is not None:
                    K.reset_launches()
                bank = svc._idx(name).vectors.banks["emb"]
                q = vecs[:20] + 0.01
                if algo == "IVF":
                    ivf = bank._ivf
                    if counts is not None:
                        bank.retrain()
                        snaps[name] = (ivf.centroids.copy(), ivf.assign.copy(), ivf.trained_rows)
                    else:
                        cent, assign, ivf.trained_rows = snaps[name]
                        ivf.centroids, ivf.assign = cent.copy(), assign.copy()
                        ivf.dirty_rows.clear()
                        ivf.cells_stale = True
                    q = q[route_clear(ivf.centroids, q, 4)]
                    assert q.shape[0] >= 10
                dev_, fin = svc.knn(name, "emb", q, 10)
                out.append(fin(dev_))
                dev_, fin = svc.knn(name, "emb", q, 10, condition=Range("price", hi=600))
                out.append(fin(dev_))
                if counts is not None:
                    counts[name] = dict(K.launches)
        return out

    counts, snaps = {}, {}
    on_card = stream(redisson_tpu_torch.create(), counts, snaps)
    on_cpu = stream(redisson_tpu_torch.create(device="cpu"), None, snaps)
    _replies_agree(on_card, on_cpu)
    for name, c in counts.items():
        assert c["knn_score"] >= 2 and c["knn_select"] >= 2, (name, c)
        if name.startswith("IVF"):
            assert c["ivf_score"] == 2 and c["kmeans"] == 2 * 6, (name, c)  # assign + update, 6 steps


def test_threads_launching_wc_words_and_segment_reduce_on_one_stream(dev):
    """Four threads, each 50 wc_words and 50 segment_reduce calls on
    distinct inputs on the device's one stream, as the server's workers
    launch them: every result is its plain version's, bit for bit (no two
    calls share a tag of kernels._tagged_state)."""
    import threading

    rng = np.random.default_rng(77)
    texts = [torch.from_numpy(_text(rng, 1500 + 53 * i)).to(dev) for i in range(8)]
    ends = [_ends(t.cpu().numpy()) for t in texts]
    results, errors, lock = [], [], threading.Lock()

    def work(tid):
        try:
            r = np.random.default_rng(1000 + tid)
            mine = []
            for i in range(50):
                j = (tid + i) % len(texts)
                mine.append(("wc", (j, i), K.wc_extract_words_auto(texts[j], ends[j], ends[j], i)))
                keys = torch.from_numpy(r.integers(-5, 70, 20_000)).to(dev)
                vals = torch.from_numpy(r.integers(-(2**31), 2**31 - 1, 20_000).astype(np.int32)).to(dev)
                reduce = ("sum", "max", "min")[i % 3]
                mine.append(("seg", (keys, vals, reduce), K.segment_reduce(keys, vals, 64, reduce)))
            with lock:
                results.extend(mine)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    torch.cuda.synchronize()
    assert len(results) == 400
    for kind, args, got in results:
        if kind == "wc":
            j, base = args
            _same(got, K.wc_extract_words_auto_plain(texts[j], ends[j], ends[j], base))
        else:
            assert torch.equal(got, K.segment_reduce_plain(*args[:2], 64, args[2]))


def test_server_on_the_card_replies_as_on_the_cpu(dev):
    """The mixed stream of every served verb, RESP2 then RESP3, on a server
    whose state lives on the card and on one on the CPU: the same replies,
    the HLL estimates within their contract; the sketch kernels launched."""
    from redisson_tpu_torch.server import ServerThread
    from redisson_tpu_torch.tools import wire_stream as W

    stream = W.mixed_stream(seed=3, scale=4, estimates=True)
    waves = [stream, [("HELLO", "3")] + stream]
    out = []
    for device in ("cpu", "cuda"):
        K.reset_launches()
        with ServerThread(port=0, device=device) as st:
            out.append(W.replies(st.server.host, st.server.port, waves))
    launched = {k for k, v in K.launches.items() if v}
    assert {"bloom_probe", "hll_add", "hll_rows", "bitset_get", "bitset_set"} <= launched, launched
    assert launched & {"bloom_set", "bloom_add"}
    for wave, (_, got), (_, want) in zip(waves, out[1], out[0]):
        assert W.compare(wave, got, want) == []


def test_cluster_on_the_card_coalesces_a_bf_run(dev):
    """A two-master port cluster on the card: a pipelined BF run to each
    master is one fused launch (fewer bloom launches than commands), a
    foreign name gets MOVED, and the replies equal a CPU cluster's."""
    from redisson_tpu_torch.harness import ClusterRunner
    from redisson_tpu_torch.tools import wire_stream as W
    from redisson_tpu_torch.utils.crc16 import calc_slot

    def names(runner, mi, n):
        lo, hi = runner.slot_ranges[mi]
        return [k for k in (f"f{i}" for i in range(10_000)) if lo <= calc_slot(k.encode()) <= hi][:n]

    rng = np.random.default_rng(8)
    blobs = [W._i8(rng.integers(-2**62, 2**62, 500)) for _ in range(8)]
    out, launched = [], {}
    for device in ("cpu", "cuda"):
        runner = ClusterRunner(masters=2, device=device).run()
        try:
            K.reset_launches()
            replies = []
            for mi, m in enumerate(runner.masters):
                own, foreign = names(runner, mi, 8), names(runner, 1 - mi, 1)
                waves = [[("BF.RESERVE", n, "0.01", "5000") for n in own],
                         [("BF.MADD64", n, b) for n, b in zip(own, blobs)],
                         [("BF.MEXISTS64", n, b[::-1]) for n, b in zip(own, blobs)],
                         [("BF.MEXISTS64", foreign[0], blobs[0])]]
                replies += [got for _, got in W.replies(m.server.server.host, m.server.server.port, waves)]
            # a MOVED names the owner's address: by master index, to compare
            addrs = {f"{m.server.server.host}:{m.port}": f"m{i}" for i, m in enumerate(runner.masters)}
            replies = [[r if isinstance(r, bytes) else " ".join(addrs.get(w, w) for w in str(r).split())
                        for r in wave] for wave in replies]
            launched[device] = dict(K.launches)
            out.append(replies)
        finally:
            runner.shutdown()
    assert out[1] == out[0]
    assert all(str(r[0]).startswith("MOVED ") for r in (out[1][3], out[1][7]))
    card = launched["cuda"]
    assert card["bloom_probe"] > 0 and card["bloom_set"] + card["bloom_add"] > 0
    # 32 BF blob commands in runs of 8: far fewer launches than commands
    assert card["bloom_probe"] + card["bloom_set"] + card["bloom_add"] < 32


def test_services_stream_on_the_card_replies_as_on_the_cpu(dev):
    """tools/wire_stream.services_stream (X*, GEO*, JSON.*, FT.* FLAT and
    IVF, the script verbs), RESP2 then RESP3, on a card server and a CPU
    server: the same replies under the stream's clock and KNN contracts
    (the CPU installs the card's trained IVF index); FT.* launched the
    vector kernels on the card, the IVF index trained there."""
    from redisson_tpu_torch.client.redisson import RedissonTpu
    from redisson_tpu_torch.server import ServerThread
    from redisson_tpu_torch.tools import wire_stream as W

    K.reset_launches()
    servers = [ServerThread(port=0, device="cuda").start(), ServerThread(port=0, device="cpu").start()]
    try:
        shas = [W.load_scripts(RedissonTpu(st.server.engine)) for st in servers]
        assert shas[0] == shas[1]
        setup, queries = W.services_stream(seed=5, scale=2, shas=shas[0])
        first = [W.replies(st.server.host, st.server.port, [setup]) for st in servers]
        W.train_ivf(*(RedissonTpu(st.server.engine).get_search() for st in servers), "idx:i")
        waves = [queries, [("HELLO", "3")] + queries]
        got = [W.replies(st.server.host, st.server.port, waves) for st in servers]
    finally:
        for st in servers:
            st.stop()
    launched = {k for k, v in K.launches.items() if v}
    assert {"knn_score", "knn_select", "ivf_score", "kmeans"} <= launched, launched
    assert W.compare(setup, first[0][0][1], first[1][0][1]) == []
    for wave, (_, card), (_, cpu) in zip(waves, got[0], got[1]):
        assert W.compare(wave, card, cpu) == []


@pytest.mark.parametrize("fused_add", [False, True], ids=["set", "fused_add"])
def test_fused_step_on_the_card_matches_its_plain_path(dev, fused_add, monkeypatch):
    """K10 (graft_entry.fused_step) on the card: found, plane and registers
    bit for bit against the same step on the CPU, over two steps with
    in-batch duplicates, tenants outside the plane and a masked tail; with
    the insert by bloom_set and, forced, by the fused add.  Each step
    launches bloom_probe, the insert and hll_add once."""
    from redisson_tpu_torch import graft_entry as G

    if fused_add:
        monkeypatch.setattr(K, "use_fused_add", lambda size, n_valid, k: True)
    rng = np.random.default_rng(3)
    tenants, m, p, b = 6, 1 << 16, 12, 4096
    state = {where: (torch.zeros((tenants, m), dtype=torch.uint8, device=where),
                     torch.zeros((tenants, 1 << p), dtype=torch.uint8, device=where))
             for where in (dev, torch.device("cpu"))}
    for n_valid in (b - 77, b):
        t = rng.integers(0, tenants, b).astype(np.int32)
        t[:4] = (-1, tenants, -tenants, tenants + 3)
        lo = rng.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32)
        hi = rng.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32)
        lo[b // 2:], hi[b // 2:], t[b // 2:] = lo[: b - b // 2], hi[: b - b // 2], t[: b - b // 2]
        out = {}
        for where, (bits, regs) in state.items():
            ops = [torch.from_numpy(a.copy()).to(where) for a in (t, lo, hi)]
            K.reset_launches()
            out[where.type] = G.fused_step(bits, regs, *ops, n_valid, 7)
            torch.cuda.synchronize()
            if where.type == "cuda":
                insert = "bloom_add" if fused_add else "bloom_set"
                assert (K.launches["bloom_probe"], K.launches[insert], K.launches["hll_add"]) == (1, 1, 1)
        for got, want in zip(out["cuda"], out["cpu"]):
            assert torch.equal(got.cpu(), want)


# -- shard windows (parallel/sharded.py) ----------------------------------


@pytest.mark.parametrize("s", [0, 1, 3])
def test_windowed_bloom_kernels_match_plain(dev, s):
    """bloom_probe (found and newly) and bloom_set with a column window on
    shard s of 4 equal their plain versions, out-of-range tenants and a
    masked tail included, and the launch counts as windowed."""
    rng = np.random.default_rng(41 + s)
    T, shards, w, m = 5, 4, 512, 1900  # the stored width 2048 > m
    part = (torch.rand((T, w), device=dev) < 0.5).to(torch.uint8)
    kb = _u64(rng, 700, 1024, dev, tenants=T)
    K.reset_launches()
    for newly in (False, True):
        for out in (K.FLAGS, K.BITS, K.COUNT):
            got = K.bloom_probe(part, w, kb, 650, 7, m, newly, out, col_lo=s * w)
            want = K.bloom_probe_plain(part, w, kb, 650, 7, m, newly, out, col_lo=s * w)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (newly, out)
    for k in (7, 5):
        a, b = part.clone(), part.clone()
        K.bloom_set(a, w, kb, 650, k, m, col_lo=s * w)
        K.bloom_set_plain(b, w, kb, 650, k, m, col_lo=s * w)
        torch.cuda.synchronize()
        assert torch.equal(a, b), k
    assert K.window_launches["bloom_probe"] == 6 and K.window_launches["bloom_set"] == 2


@pytest.mark.parametrize("s", [0, 2])
def test_windowed_hll_and_bitset_kernels_match_plain(dev, s):
    rng = np.random.default_rng(51 + s)
    rows, p = 6, 10
    regs = torch.randint(0, 8, (rows, 1 << p), dtype=torch.uint8, device=dev)
    kb = _u64(rng, 3000, 4096, dev, tenants=4 * rows)
    a, b = regs.clone(), regs.clone()
    K.hll_add(a, 1 << p, kb, 2900, p, row_lo=s * rows)
    K.hll_add_plain(b, 1 << p, kb, 2900, p, row_lo=s * rows)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    size = 1 << 16
    bits = (torch.rand(size, device=dev) < 0.5).to(torch.uint8)
    idx = torch.from_numpy(rng.integers(-5, 4 * size + 5, 7000).astype(np.int32)).to(dev)
    assert torch.equal(K.bitset_get(bits, idx, lo=s * size), K.bitset_get_plain(bits, idx, lo=s * size))
    for n_valid, value in ((7000, 1), (6500, 0), (0, 1)):
        x, y = bits.clone(), bits.clone()
        got = K.bitset_set(x, idx, n_valid, value, lo=s * size)[1]
        want = K.bitset_set_plain(y, idx, n_valid, value, lo=s * size)[1]
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(x, y), (n_valid, value)


def test_sharded_objects_on_the_card_equal_unsharded(dev):
    """The three sharded objects on dp 2 x shard 4 over 8 positions of the
    card equal their unsharded counterparts, through a 4 -> 8 -> 4 reshard."""
    import redisson_tpu_torch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.parallel.manager import MeshManager

    cfg = Config()
    cfg.mesh.dp, cfg.mesh.shard, cfg.mesh.n_devices = 2, 4, 8
    c = redisson_tpu_torch.create(cfg)
    try:
        rng = np.random.default_rng(3)
        mgr = MeshManager.of(c.engine)
        sbf, ubf = c.get_sharded_bloom_filter_array("s"), c.get_bloom_filter_array("u")
        assert sbf.try_init(16, 5000, 0.01) and ubf.try_init(16, 5000, 0.01)
        assert sbf.get_size() == ubf.get_size()
        t = rng.integers(0, 16, 4000).astype(np.int32)
        ks = rng.integers(0, 1 << 62, 4000).astype(np.int64)
        assert np.array_equal(sbf.add_each(t, ks), ubf.add_each(t, ks))
        mgr.reshard(1, 8)
        probe = np.concatenate([ks, rng.integers(0, 1 << 62, 4000).astype(np.int64)])
        tp = np.concatenate([t, t])
        assert np.array_equal(sbf.contains_each(tp, probe), ubf.contains(tp, probe))
        mgr.reshard(2, 4)
        assert torch.equal(c.engine.store.get("s").arrays["bits"].gather(), c.engine.store.get("u").arrays["bits"])
        sh, un = c.get_sharded_hll_array("h"), c.get_hyper_log_log_array("hu")
        sh.try_init(10, p=12)
        un.try_init(10, p=12)
        t = rng.integers(0, 10, 20000).astype(np.int32)
        sh.add_each(t, ks.repeat(5))
        un.add(t, ks.repeat(5))
        assert np.array_equal(sh.estimate_all(), un.estimate_all())
        sb, ub = c.get_sharded_bit_set("b"), c.get_bit_set("bu")
        sb.try_init(1 << 20)
        idx = rng.integers(0, 1 << 20, 9000)
        assert np.array_equal(sb.set_each(idx), ub.set_each(idx).astype(bool))
        assert np.array_equal(sb.get_each(idx[::-1].copy()), ub.get_each(idx[::-1].copy()).astype(bool))
        assert sb.cardinality() == ub.cardinality()
    finally:
        c.shutdown()


def test_checkpoint_and_dump_round_trip_on_the_card(dev, tmp_path):
    """A checkpoint saved from the card loads onto the card and onto the
    CPU bit for bit (the format is the device's own nowhere); DUMP, RESTORE
    and COPY keep the state on the card, and the restored and copied
    objects answer as the source."""
    import redisson_tpu_torch
    from redisson_tpu_torch.core import checkpoint

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 62, 5000, dtype=np.int64)
    tenants = (np.arange(5000) % 8).astype(np.int32)
    src = redisson_tpu_torch.create(device=dev)
    try:
        ba = src.get_bloom_filter_array("cc:bfa")
        ba.try_init(8, 2000, 0.01)
        ba.add_each(tenants, keys)
        h = src.get_hyper_log_log_array("cc:hlla")
        h.try_init(8)
        h.add(tenants, keys)
        path = str(tmp_path / "card.ckpt")
        assert checkpoint.save(src.engine, path) == 2
        for target in (dev, torch.device("cpu")):
            fresh = redisson_tpu_torch.create(device=target)
            try:
                assert checkpoint.load(fresh.engine, path) == 2
                for name, key in (("cc:bfa", "bits"), ("cc:hlla", "regs")):
                    got = fresh.engine.store.get(name).arrays[key]
                    assert got.device.type == target.type
                    assert torch.equal(got.cpu(), src.engine.store.get(name).arrays[key].cpu())
                assert np.array_equal(fresh.get_bloom_filter_array("cc:bfa").contains(tenants, keys),
                                      ba.contains(tenants, keys))
            finally:
                fresh.shutdown()
        before = dict(K.launches)
        checkpoint.restore_record(src.engine, "cc:bfa:r", checkpoint.dump_record(src.engine, "cc:bfa"))
        assert checkpoint.clone_record(src.engine, "cc:hlla", "cc:hlla:c")
        for name, key in (("cc:bfa:r", "bits"), ("cc:hlla:c", "regs")):
            assert src.engine.store.get(name).arrays[key].device.type == "cuda"
        assert src.get_bloom_filter_array("cc:bfa:r").contains(tenants, keys).all()
        assert np.array_equal(src.get_hyper_log_log_array("cc:hlla:c").estimate_all(), h.estimate_all())
        assert K.launches["bloom_probe"] > before["bloom_probe"] and K.launches["hll_rows"] > before["hll_rows"]
    finally:
        src.shutdown()


def test_replication_k23_k24_and_a_replica_on_the_card(dev):
    """K23 (the packed upload) equals per-array copies and K24 (the block
    patch) the numpy patch, on the card; a master and a replica on the card
    hold equal planes after a full sync and after a delta, and a delta
    whose block lies past the plane is refused before it launches anything,
    leaving the context usable."""
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.harness import ClusterRunner
    from redisson_tpu_torch.server import replication as R

    rng = np.random.default_rng(9)
    arrays = {"a": rng.integers(0, 2, 13).astype(bool), "b": rng.integers(0, 256, (3, 7), dtype=np.uint8),
              "c": rng.integers(-2**31, 2**31, 5, dtype=np.int32),
              "d": rng.standard_normal((3, 3)).astype(np.float32),
              "e": rng.integers(-2**62, 2**62, 7, dtype=np.int64)}
    got = ioplane.scatter_host_arrays(arrays, dev, ioplane.StagingPool(pin=True))
    for k, v in arrays.items():
        assert got[k].device.type == "cuda" and torch.equal(got[k].cpu(), torch.from_numpy(v))
    for dt in (np.uint8, np.int32):
        host = rng.integers(0, 100, 256 * 37 + 5).astype(dt)
        be = R._block_elems(np.dtype(dt))
        nb = -(-host.size // be)
        idx = np.asarray([0, 5, 5, nb - 1, 3], np.int32)
        d = {"idx": idx, "data": rng.integers(0, 100, (idx.size, be)).astype(dt), "shape": host.shape,
             "dtype": str(np.dtype(dt)), "nblocks": nb}
        want = np.concatenate([host, np.zeros(nb * be - host.size, dt)]).reshape(nb, be)
        want[idx] = d["data"]
        cur = torch.from_numpy(host).to(dev)
        out = R._apply_array_delta(cur, d)
        assert torch.equal(out.cpu(), torch.from_numpy(want.reshape(-1)[: host.size]))
        assert torch.equal(cur.cpu(), torch.from_numpy(host))
    runner = ClusterRunner(masters=1, replicas_per_master=1, device="cuda").run()
    try:
        master, replica = runner.masters[0].server, runner.replicas[0].server
        with master.client() as c:
            c.execute("BF.RESERVE", "cr:bf", "0.01", "50000")
            c.execute("BF.MADD64", "cr:bf", np.arange(3000, dtype=np.int64).tobytes())
            c.execute("REPLFLUSH")
            c.execute("BF.MADD64", "cr:bf", np.arange(3000, 3050, dtype=np.int64).tobytes())
            c.execute("REPLFLUSH")
        assert master.server.replication_source().stats["records_delta"] >= 1
        m = master.server.engine.store.get_unguarded("cr:bf")
        r = replica.server.engine.store.get_unguarded("cr:bf")
        assert r.arrays["bits"].device.type == "cuda" and torch.equal(r.arrays["bits"], m.arrays["bits"])
        bad = {"name": "cr:bf", "kind": r.kind, "meta": dict(r.meta), "version": r.version + 1,
               "nonce": r.nonce, "expire_at": r.expire_at, "host_pickled": R.safe_pickle.dumps(r.host, protocol=4),
               "delta_base": r.version,
               "arrays_delta": {"bits": {"idx": np.asarray([10**6], np.int32), "data": np.zeros((1, 256), np.uint8),
                                         "shape": tuple(r.arrays["bits"].shape), "dtype": "uint8",
                                         "nblocks": -(-r.arrays["bits"].numel() // 256)}}}
        with replica.client() as c:
            reply = c.execute("REPLPUSH", R._wire_payload([bad], None))
        assert "out of range" in str(reply)
        torch.cuda.synchronize()
        assert replica.server.engine.store.get_unguarded("cr:bf") is r
    finally:
        runner.shutdown()


def test_migration_on_the_card_moves_planes_bit_for_bit(dev, tmp_path):
    """A journaled migration between two masters on the card, its
    coordinator killed after the first drain sweep and resumed: the target
    holds the source's bloom bank and HLL registers equal by torch.equal,
    its BFA.MEXISTS64 launches bloom_probe on the card, and its replies
    equal a CPU pair's after the same migration.  Then 8 positions on the
    card: a device rebalance killed at PLANNED and resumed leaves GETBIT and
    BF.MEXISTS64 replies as they were."""
    from redisson_tpu_torch.harness import ClusterRunner
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server import ServerThread
    from redisson_tpu_torch.server import migration as mig
    from redisson_tpu_torch.tools import wire_stream as W
    from redisson_tpu_torch.utils.crc16 import calc_slot

    rng = np.random.default_rng(23)
    tenants = rng.integers(0, 8, 4000).astype(np.int32)
    keys = rng.integers(-2**62, 2**62, 4000)
    counters = rng.integers(0, 32, 4000).astype(np.int32)
    replies = {}
    for device in ("cpu", "cuda"):
        jd = str(tmp_path / device)
        runner = ClusterRunner(masters=2, device=device, journal_dir=jd).run()
        try:
            lo, hi = runner.slot_ranges[0]
            tag = next(t for t in (f"m{i}" for i in range(10_000)) if lo <= calc_slot(t.encode()) <= hi)
            src, dst = (m.server.server for m in runner.masters)
            c = Connection(src.host, src.port, timeout=120.0)
            try:
                c.execute("BFA.RESERVE", f"{{{tag}}}bank", 8, 1000, "0.01")
                c.execute("BFA.MADD64", f"{{{tag}}}bank", W._i4(tenants), W._i8(keys))
                c.execute("HLLA.RESERVE", f"{{{tag}}}hll", 32)
                c.execute("HLLA.MADD64", f"{{{tag}}}hll", W._i4(counters), W._i8(keys))
            finally:
                c.close()
            before = {n: {k: v.clone() for k, v in src.engine.store.get(n).arrays.items()}
                      for n in (f"{{{tag}}}bank", f"{{{tag}}}hll")}
            with pytest.raises(mig.CoordinatorKilled):
                mig.migrate_slots(src.address(), dst.address(), [calc_slot(tag.encode())],
                                  journal_dir=jd, crash_after="DRAINING:1")
            assert [r["action"] for r in mig.resume_migrations(jd)] == ["completed"]
            for name, arrays in before.items():
                assert src.engine.store.peek(name) is False
                for k, v in arrays.items():
                    got = dst.engine.store.get(name).arrays[k]
                    assert got.device.type == device and torch.equal(got.cpu(), v.cpu())
            K.reset_launches()
            c = Connection(dst.host, dst.port, timeout=120.0)
            try:
                replies[device] = [c.execute("BFA.MEXISTS64", f"{{{tag}}}bank", W._i4(tenants), W._i8(keys[::-1])),
                                   c.execute("HLLA.ESTIMATE", f"{{{tag}}}hll")]
            finally:
                c.close()
            if device == "cuda":
                assert K.launches["bloom_probe"] >= 1 and K.launches["hll_rows"] >= 1
        finally:
            runner.shutdown()
    assert replies["cuda"] == replies["cpu"]
    with ServerThread(port=0, device="cuda", devices=8) as st, st.client() as c:
        names = [f"rb{i}" for i in range(16)]
        for i, n in enumerate(names):
            c.execute("BF.RESERVE", f"bf{n}", "0.01", "1000")
            c.execute("BF.MADD64", f"bf{n}", W._i8(keys[i * 100:(i + 1) * 100]))
            c.execute("SETBITSB", f"bits{n}", W._i8(np.arange(i, 4000, 37)), 1)
        probe = [("BF.MEXISTS64", f"bf{n}", W._i8(keys[:1600])) for n in names]
        probe += [("GETBIT", f"bits{n}", j) for n in names for j in (i * 37 for i in range(0, 100, 7))]
        want = c.execute_many(probe)
        engine = st.server.engine
        p = engine.placement
        slots = sorted({calc_slot(n.encode()) for n in (f"bf{m}" for m in names)})
        targets = {s: (p.device_id_for_slot(s) + 4) % p.n_devices for s in slots[: len(slots) // 2]}
        jd = str(tmp_path / "rebalance")
        with pytest.raises(mig.CoordinatorKilled):
            mig.rebalance_devices(engine, targets, journal_dir=jd, crash_after="PLANNED")
        assert [r["action"] for r in mig.resume_device_rebalances(engine, jd)] == ["completed"]
        assert all(p.device_id_for_slot(s) == d for s, d in targets.items())
        assert c.execute_many(probe) == want


def test_residency_demote_and_promote_a_bloom_bank_on_the_card(dev):
    """A bloom bank on the card demoted WARM and COLD and faulted back in:
    its plane is bit-identical, its probes answer as before, the
    promotion lands on the card, and memory_allocated falls by at least
    the plane's bytes at each demotion."""
    import redisson_tpu_torch
    from redisson_tpu_torch.core import residency as R

    prev = R.set_tier(True)
    client = redisson_tpu_torch.create(device="cuda")
    try:
        eng = client._engine
        mgr = eng.enable_residency(min_idle_s=0.0)
        bank = client.get_bloom_filter_array("res:bank")
        assert bank.try_init(64, 20_000, 0.01)
        rng = np.random.default_rng(17)
        tids = np.repeat(np.arange(64, dtype=np.int32), 300)
        keys = rng.integers(0, 1 << 40, tids.size)
        bank.add(tids, keys)
        probe_t = np.concatenate([tids[::7], tids[::7]])
        probe_k = np.concatenate([keys[::7], keys[::7] + 1])
        want_plane = eng.store.get_unguarded("res:bank").arrays["bits"].clone()
        want = np.asarray(bank.contains(probe_t, probe_k))
        assert want[: tids[::7].size].all()
        nbytes = int(want_plane.nbytes)
        for cold in (False, True):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            assert mgr.demote("res:bank", cold=cold, force=True)
            assert torch.cuda.memory_allocated() <= before - nbytes
            rec = eng.store.get_unguarded("res:bank")
            np.testing.assert_array_equal(np.asarray(bank.contains(probe_t, probe_k)), want)
            assert rec.tier == R.HOT and rec.arrays["bits"].device.type == "cuda"
            assert torch.equal(rec.arrays["bits"], want_plane)
        assert mgr.promotions == 2 and mgr.cold_loads == 1
    finally:
        client.shutdown()
        R.set_tier(prev)


def test_the_armed_watchdog_trips_behind_a_stalled_stream_on_the_card(dev):
    """The card's stream stalled ~1 s by torch.cuda._sleep: with
    lane-watchdog-ms 50 a readback of a tensor made behind the stall fails
    with LaneWatchdogTimeout within 0.5 s (it polls the event and never
    synchronizes), the fault lands on the position's lane, and the grouped
    fetch trips the same way; once the stall drains the same tensors read
    back their values and a probe's readback clears the streak."""
    import time

    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core.engine import Engine

    eng = Engine(device="cuda")
    eng.enable_placement(n_devices=2)
    lane = eng.lanes.lane(eng.placement.devices[1])
    prev = ioplane.set_lane_watchdog_ms(50)
    try:
        # load every kernel the test launches before the stall: a kernel's
        # first launch loads its module (CUDA's lazy loading), which waits
        # for the running spin kernel on the host, so the readback below
        # would start only after the stall had drained
        torch.cuda._sleep(1_000_000)
        warm = [torch.arange(16, device=dev) * 3, torch.ones(4, device=dev)]
        ioplane.gather_device_results([(warm[0],), (warm[1],)], [1, 1])
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(20_000_000)
        e1.record()
        e1.synchronize()
        cycles = int(20_000_000 / e0.elapsed_time(e1) * 1000.0)  # ~1 s
        torch.cuda._sleep(cycles)
        vals = [torch.arange(16, device=dev) * 3, torch.ones(4, device=dev)]
        t0 = time.monotonic()
        fut = ioplane.ReadbackFuture((vals[0],), position=1)
        with pytest.raises(ioplane.LaneWatchdogTimeout):
            fut.result()
        with pytest.raises(ioplane.LaneWatchdogTimeout):
            ioplane.gather_device_results([(vals[0],), (vals[1],)], [1, 1])
        assert time.monotonic() - t0 < 0.5 + 0.1
        assert lane.total_faults == 2 and lane.last_fault_kind == "watchdog_timeout"
        torch.cuda.synchronize()
        assert ioplane.ReadbackFuture((vals[0],), position=1).result().tolist() == list(range(0, 48, 3))
        assert lane.consec_faults == 0
    finally:
        ioplane.set_lane_watchdog_ms(prev)
        eng.shutdown()


# a server of 8 positions of the card whose CUDA context a device-side
# assert has lost: prints what its frames and probes replied as JSON
_STICKY_DRIVER = r"""
import json, os, socket
import torch
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.utils.crc16 import calc_slot

st = ServerThread(port=0, device="cuda", devices=8, workers=2)
st.start()
sock = socket.create_connection((st.server.host, st.server.port), timeout=60)
parser = resp.RespParser(use_native=False)


def wave(*cmd):
    sock.sendall(resp.encode_commands([cmd]))
    raw = b""
    while True:
        data = sock.recv(1 << 16)
        raw += data
        if not data or parser.feed(data):
            return raw.decode()


p, lanes = st.server.engine.placement, st.server.engine.lanes
key = "sticky0"
victim = int(p.owner_snapshot()[calc_slot(key.encode())])
other = (victim + 1) % p.n_devices
out = {"n": ioplane.quarantine_after(), "victim_id": lanes.lane(p.devices[victim]).dev_id,
       "first": wave("PFADD", key, "a")}
try:
    x = torch.zeros(4, device="cuda")
    x[torch.tensor([10], device="cuda")] = 1.0  # out of bounds: a device-side assert
    torch.cuda.synchronize()
    out["assert"] = None
except Exception as e:
    out["assert"] = type(e).__name__ + ": " + str(e)[:120]
out["frames"] = [wave("PFADD", key, f"x{i}") for i in range(out["n"] + 1)]
vl, ol = lanes.lane(p.devices[victim]), lanes.lane(p.devices[other])
out["victim"] = [vl.total_faults, vl.quarantined, vl.last_fault_kind]
out["probe_victim"] = wave("CLUSTER", "DEVPROBE", str(victim))
out["victim_after_probe"] = vl.total_faults
out["probe_other"] = [wave("CLUSTER", "DEVPROBE", str(other)) for _ in range(out["n"])]
out["other"] = [ol.total_faults, ol.quarantined, ol.last_fault_kind]
print(json.dumps(out), flush=True)
os._exit(0)  # the lost context cannot be torn down cleanly
"""


def test_a_sticky_cuda_error_quarantines_every_lane_on_the_card(dev):
    """A device-side assert loses the process's CUDA context: in a child
    process, every later frame replies -TRYAGAIN and counts on its lane
    (kernel_launch) until lane-quarantine-after quarantines it; DEVPROBE
    then answers [0, 1] and counts its own failure once, and another
    position's probes fail until its lane quarantines too.  Recovery is a
    restart of the process."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _STICKY_DRIVER], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    n = out["n"]
    assert out["first"] == ":1\r\n"
    assert out["assert"] is not None and "device-side assert" in out["assert"], out["assert"]
    assert out["frames"][:n] == ["-TRYAGAIN device fault during dispatch; retry\r\n"] * n, out["frames"]
    assert out["frames"][n] == (f"-TRYAGAIN device {out['victim_id']} quarantined; "
                                "retry after evacuation\r\n"), out["frames"]
    assert out["victim"] == [n, True, "kernel_launch"]
    assert out["probe_victim"] == "*2\r\n:0\r\n:1\r\n" and out["victim_after_probe"] == n + 1
    assert out["probe_other"][-1] == "*2\r\n:0\r\n:1\r\n", out["probe_other"]
    assert out["other"][:2] == [n, True], out["other"]


# -- a stream for each position, and positions over several cards ----------------


def _cycles_per_ms() -> float:
    """torch.cuda._sleep's cycles a millisecond, by CUDA events."""
    torch.cuda._sleep(1_000_000)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(20_000_000)
    e1.record()
    e1.synchronize()
    return 20_000_000 / e0.elapsed_time(e1)


@pytest.fixture()
def one_card_lanes(dev):
    """An engine with 8 positions on card 0, each lane on a stream of its own."""
    from redisson_tpu_torch.core.engine import Engine

    eng = Engine(device="cuda:0")
    eng.enable_placement(n_devices=8)
    yield eng
    torch.cuda.synchronize()
    eng.shutdown()


def _lane(eng, position: int):
    return eng.lanes.lane(eng.placement.devices[position])


def test_a_spin_on_one_lane_holds_no_other_lanes_readback(one_card_lanes):
    """Position 0's lane spins ~400 ms; a value made on position 1's lane
    after the spin was launched reads back while the spin still runs."""
    from redisson_tpu_torch.core import ioplane

    eng = one_card_lanes
    lanes = [_lane(eng, p) for p in range(8)]
    assert len({ln.stream.cuda_stream for ln in lanes}) == 8
    with lanes[1].occupy(1):  # load every kernel and copy before the spin
        ioplane.ReadbackFuture((torch.arange(16, device="cuda:0") * 3,)).result()
    cycles = _cycles_per_ms()
    end = torch.cuda.Event()
    with lanes[0].occupy(1):
        torch.cuda._sleep(int(cycles * 400))
        end.record()
    with lanes[1].occupy(1):
        fut = ioplane.ReadbackFuture((torch.arange(16, device="cuda:0") * 3,))
    assert fut.result().tolist() == list(range(0, 48, 3))
    assert not end.query(), "position 1's readback waited for position 0's spin"
    end.synchronize()


def test_only_the_spinning_lanes_watchdog_trips(one_card_lanes):
    """lane-watchdog-ms 50: a readback behind position 0's ~400 ms spin
    fails with LaneWatchdogTimeout and counts on lane 0 alone, while
    readbacks of positions 1-7, one by one and grouped, pass."""
    from redisson_tpu_torch.core import ioplane

    eng = one_card_lanes
    lanes = [_lane(eng, p) for p in range(8)]
    for ln in lanes:  # every kernel loaded before the spin, as the test launches it
        with ln.occupy(1):
            ioplane.ReadbackFuture((torch.ones(4, device="cuda:0") * ln.dev_id,)).result()
    ioplane.force_all([ioplane.ReadbackFuture((torch.ones(4, device="cuda:0"),)) for _ in range(2)])
    cycles = _cycles_per_ms()
    prev = ioplane.set_lane_watchdog_ms(50)
    try:
        with lanes[0].occupy(1):
            torch.cuda._sleep(int(cycles * 400))
            stuck = ioplane.ReadbackFuture((torch.ones(4, device="cuda:0"),))
        others = []
        for ln in lanes[1:]:
            with ln.occupy(1):
                others.append(ioplane.ReadbackFuture((torch.ones(4, device="cuda:0") * ln.dev_id,)))
        assert [f.result().tolist() for f in others[:3]] == [[float(p)] * 4 for p in (1, 2, 3)]
        ioplane.force_all(others[3:])
        assert [f.result().tolist() for f in others[3:]] == [[float(p)] * 4 for p in (4, 5, 6, 7)]
        with pytest.raises(ioplane.LaneWatchdogTimeout, match="device\\(s\\) 0"):
            stuck.result()
        assert [ln.total_faults for ln in lanes] == [1] + [0] * 7
    finally:
        ioplane.set_lane_watchdog_ms(prev)
        torch.cuda.synchronize()


def test_a_record_dropped_under_its_lanes_kernel_is_not_reused(one_card_lanes):
    """A filter made off the lanes (its plane's block in the default
    stream's pool) is probed on position 1's lane behind a spin; the
    record is deleted from outside the lane while the probe waits and a
    buffer of the plane's size filled with ones is allocated on the default
    stream: it gets another block, and the probe's flags equal the plain
    version's."""
    from redisson_tpu_torch.client.objects.bloom import BloomFilter
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core.engine import Engine

    eng = one_card_lanes
    name = next(f"race{i}" for i in range(1000) if eng.placement.device_id_for_name(f"race{i}") == 1)
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 62, 1 << 18).astype(np.int64)
    probe = np.concatenate([keys[: 1 << 17], rng.integers(0, 1 << 62, 1 << 17)]).astype(np.int64)
    plain = Engine(device="cpu")
    pbf = BloomFilter(plain, name)
    pbf.try_init(1 << 18, 0.01)
    pbf.add_all(keys)
    want = pbf.contains_each(probe)
    plain.shutdown()
    bf = BloomFilter(eng, name)
    bf.try_init(1 << 18, 0.01)
    bf.add_all(keys)
    bf.contains_each(probe[:8])  # the probe's kernels loaded before the spin
    torch.cuda.synchronize()
    plane = eng.store.get(name).arrays["bits"]
    ptr, nbytes = plane.data_ptr(), plane.numel()
    del plane
    cycles = _cycles_per_ms()
    end = torch.cuda.Event()
    with _lane(eng, 1).occupy(1):
        torch.cuda._sleep(int(cycles * 200))
        found, n = bf.contains_each_async(probe)
        fut = ioplane.ReadbackFuture((found,), lambda h: K.unpack_found(h[0], n))
        end.record()
    assert eng.store.delete(name)
    junk = torch.full((nbytes,), 255, dtype=torch.uint8, device="cuda:0")
    assert not end.query(), "the probe finished before the DEL: no race was run"
    assert junk.data_ptr() != ptr, "the plane's block was handed out under the pending probe"
    np.testing.assert_array_equal(fut.result(), want)


def test_a_cooperative_bitset_set_runs_beside_a_spinning_lane(one_card_lanes):
    """bitset_set's cooperative grid (a group past one block's ops) on
    position 1's lane finishes while position 0's lane still spins: the
    grid takes half the card's residency, so it fits beside other
    streams' kernels."""
    eng = one_card_lanes
    rng = np.random.default_rng(9)
    bits = torch.zeros(1 << 22, dtype=torch.uint8, device="cuda:0")
    idx = torch.from_numpy(rng.integers(0, 1 << 22, 1 << 20).astype(np.int32)).cuda(0)
    want_bits = K.bitset_set_plain(bits.clone(), idx, idx.numel(), 1)[0]
    with _lane(eng, 1).occupy(1):
        K.bitset_set(bits.clone(), idx, idx.numel(), 1)  # loaded before the spin
        torch.cuda.synchronize()
    cycles = _cycles_per_ms()
    end, done = torch.cuda.Event(), torch.cuda.Event()
    with _lane(eng, 0).occupy(1):
        torch.cuda._sleep(int(cycles * 400))
        end.record()
    with _lane(eng, 1).occupy(1):
        got, old = K.bitset_set(bits, idx, idx.numel(), 1)
        done.record()
    done.synchronize()
    assert not end.query(), "the cooperative grid waited for the spinning lane"
    assert torch.equal(got, want_bits) and int(old.sum()) == 0
    end.synchronize()


def _cards_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two CUDA cards for positions over several cards; saw {n}")
    return n


@pytest.fixture()
def over_cards():
    """An engine whose 2 x (card count) positions lie round robin over every card."""
    from redisson_tpu_torch.core.engine import Engine

    n = _cards_or_skip()
    eng = Engine(device="cuda")
    eng.enable_placement(n_devices=2 * n)
    assert len({str(p.device) for p in eng.placement.devices}) == n
    yield eng
    for d in range(n):
        torch.cuda.synchronize(d)
    eng.shutdown()


def _on_distinct_cards(placement, count: int, prefix: str) -> list:
    names, cards = [], set()
    for i in range(100_000):
        name = f"{prefix}{i}"
        card = str(placement.device_for_name(name).device)
        if card not in cards:
            cards.add(card)
            names.append(name)
            if len(names) == count:
                return names
    raise AssertionError("not enough cards")


def test_records_commit_and_move_between_cards_bit_for_bit(over_cards):
    """Every record's registers sit on its owner's card; a fenced slot
    handoff to a position on another card moves them by a peer copy, bit
    for bit, and the counter reads the same."""
    from redisson_tpu_torch.client.objects.hyperloglog import HyperLogLog
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.utils.crc16 import calc_slot

    eng = over_cards
    p = eng.placement
    names = _on_distinct_cards(p, 2, "cm")
    for name in names:
        HyperLogLog(eng, name).add_all([f"{name}:{j}" for j in range(500)])
        assert eng.store.get(name).arrays["regs"].device == torch.device(p.device_for_name(name).device)
    name = names[0]
    before = eng.store.get(name).arrays["regs"].cpu()
    count = HyperLogLog(eng, name).count()
    slot = calc_slot(name.encode())
    src = p.device_id_for_slot(slot)
    dst = next(i for i, q in enumerate(p.devices) if q.device != p.devices[src].device)
    ioplane.STATS.reset()
    assert eng.move_slot_records(slot, dst, epoch=5) >= 1
    snap = ioplane.STATS.snapshot()
    regs = eng.store.get(name).arrays["regs"]
    assert regs.device == torch.device(p.devices[dst].device)
    assert torch.equal(regs.cpu(), before)
    assert snap["d2d_colocations"] >= 1 and snap["host_colocations"] == 0
    assert snap["d2d_bytes"] == before.numel()
    assert HyperLogLog(eng, name).count() == count
    HyperLogLog(eng, name).add_all(["after the move"])  # kernels on the new card's lane
    assert HyperLogLog(eng, name).count() >= count


def test_k13_across_cards_goes_through_no_host(over_cards):
    """PFCOUNT and PFMERGE over counters on several cards, and BITOP over
    bit sets on two: equal to one card's, peer copies only."""
    from redisson_tpu_torch.client.objects.bitset import BitSet
    from redisson_tpu_torch.client.objects.hyperloglog import HyperLogLog
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core.engine import Engine

    eng = over_cards
    plain = Engine(device="cuda:0")
    try:
        names = _on_distinct_cards(eng.placement, torch.cuda.device_count(), "k13h")
        rng = np.random.default_rng(3)
        for name in names:
            keys = [f"{name}:{int(k)}" for k in rng.integers(0, 1 << 40, 300)]
            HyperLogLog(eng, name).add_all(keys)
            HyperLogLog(plain, name).add_all(keys)
        ioplane.STATS.reset()
        want = HyperLogLog(plain, names[0]).count_with(*names[1:])
        assert HyperLogLog(eng, names[0]).count_with(*names[1:]) == want
        HyperLogLog(eng, names[0]).merge_with(*names[1:])
        HyperLogLog(plain, names[0]).merge_with(*names[1:])
        regs = eng.store.get(names[0]).arrays["regs"]
        assert regs.device == torch.device(eng.placement.device_for_name(names[0]).device)
        assert torch.equal(regs.cpu(), plain.store.get(names[0]).arrays["regs"].cpu())
        a, b = _on_distinct_cards(eng.placement, 2, "k13b")
        BitSet(eng, a).set_each(np.array([1, 5, 9]))
        BitSet(eng, b).set_each(np.array([2, 5, 100]))
        BitSet(eng, a).or_(b)
        got = np.asarray(BitSet(eng, a).get_each(np.arange(128)))
        assert sorted(np.nonzero(got)[0].tolist()) == [1, 2, 5, 9, 100]
        snap = ioplane.STATS.snapshot()
        assert snap["host_colocations"] == 0 and snap["d2d_colocations"] > 0
    finally:
        plain.shutdown()


# the reference's tests/test_device_sharding.py cases that assert device
# identity or device-to-device copies across positions: on the CPU they wait
# (tests/test_torch_suite_device_sharding.py), here they run on positions
# laid over the cards
DEVICE_SHARDING_ON_CARDS = (
    "test_records_commit_to_owner_device",
    "test_put_unguarded_places_like_migration_import",
    "test_device_rebalance_kill_at_every_phase",
    "test_move_slot_records_fenced_and_bit_identical",
    "test_gather_device_results_buckets_per_device",
    "test_hll_union_across_devices_matches_single_device_and_stays_on_device",
    "test_bitset_bitop_across_devices_stays_on_device",
    "test_wordcount_spreads_chunks_and_merges_without_host_gather",
)


def _owner_card(eng, name):
    return torch.device(eng.placement.device_for_name(name).device)


@pytest.mark.parametrize("case", DEVICE_SHARDING_ON_CARDS)
def test_device_sharding_on_cards(case, over_cards, tmp_path):
    """The reference's device-identity and device-to-device cases, each
    with the port's calls, on positions over every card."""
    from redisson_tpu_torch.client.objects.bitset import BitSet
    from redisson_tpu_torch.client.objects.hyperloglog import HyperLogLog
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core.engine import Engine
    from redisson_tpu_torch.core.store import StateRecord
    from redisson_tpu_torch.server.migration import CoordinatorKilled, rebalance_devices, resume_device_rebalances
    from redisson_tpu_torch.server.placement import PlacementStaleEpoch
    from redisson_tpu_torch.utils.crc16 import calc_slot

    eng = over_cards
    p = eng.placement
    if case == "test_records_commit_to_owner_device":
        for name in _on_distinct_cards(p, torch.cuda.device_count(), "own"):
            HyperLogLog(eng, name).add_all([f"{name}:{j}" for j in range(20)])
            assert eng.store.get(name).arrays["regs"].device == _owner_card(eng, name)
    elif case == "test_put_unguarded_places_like_migration_import":
        name = next(f"imp{i}" for i in range(1000) if _owner_card(eng, f"imp{i}").index != 0)
        eng.store.put_unguarded(name, StateRecord(kind="bitset", meta={},
                                                  arrays={"bits": torch.zeros(64, dtype=torch.uint8,
                                                                              device="cuda:0")}))
        assert eng.store.get(name).arrays["bits"].device == _owner_card(eng, name)
    elif case in ("test_move_slot_records_fenced_and_bit_identical", "test_device_rebalance_kill_at_every_phase"):
        names = [f"reb{i}" for i in range(6)]
        for name in names:
            HyperLogLog(eng, name).add_all([f"{name}:{j}" for j in range(50)])
        baseline = {n: eng.store.get(n).arrays["regs"].cpu() for n in names}
        slots = sorted({calc_slot(n.encode()) for n in names})
        phases = ("PLANNED", "DRAINING:1", "STABLE") if "kill" in case else (None,)
        for phase in phases:
            target = {s: (p.device_id_for_slot(s) + 1) % p.n_devices for s in slots}
            if phase is None:
                epoch = 10
                for s, d in target.items():
                    eng.move_slot_records(s, d, epoch=epoch)
            else:
                jd = str(tmp_path / "journal")
                with pytest.raises(CoordinatorKilled):
                    rebalance_devices(eng, target, journal_dir=jd, crash_after=phase)
                resume_device_rebalances(eng, jd)
                epoch = max(p.epoch_of(s) for s in slots)
            for name in names:
                regs = eng.store.get(name).arrays["regs"]
                assert regs.device == torch.device(p.devices[target[calc_slot(name.encode())]].device)
                assert torch.equal(regs.cpu(), baseline[name])
            with pytest.raises(PlacementStaleEpoch, match="STALEEPOCH"):
                eng.move_slot_records(slots[0], 0, epoch=epoch - 1)
    elif case == "test_gather_device_results_buckets_per_device":
        n = torch.cuda.device_count()
        rng = np.random.default_rng(11)
        host_vals = [rng.integers(0, 255, 97).astype(np.uint8) for _ in range(2 * n)]
        groups = [(torch.from_numpy(v).to(f"cuda:{i % n}"),) for i, v in enumerate(host_vals)]
        ioplane.reset_device_stats()
        before = ioplane.STATS.snapshot()["blocking_syncs"]
        out = ioplane.gather_device_results(groups)
        for got, want in zip(out, host_vals):
            np.testing.assert_array_equal(got[0], want)
        assert ioplane.STATS.snapshot()["blocking_syncs"] - before == n
        assert len([d for d, s in ioplane.device_stats_snapshot().items() if s["blocking_syncs"]]) == n
    elif case == "test_hll_union_across_devices_matches_single_device_and_stays_on_device":
        plain = Engine(device="cuda:0")
        try:
            names = _on_distinct_cards(p, torch.cuda.device_count(), "hu")
            rng = np.random.default_rng(3)
            for name in names:
                keys = [f"{name}:{int(k)}" for k in rng.integers(0, 1 << 40, 300)]
                HyperLogLog(eng, name).add_all(keys)
                HyperLogLog(plain, name).add_all(keys)
            ioplane.STATS.reset()
            want = HyperLogLog(plain, names[0]).count_with(*names[1:])
            assert HyperLogLog(eng, names[0]).count_with(*names[1:]) == want
            snap = ioplane.STATS.snapshot()
            assert snap["host_colocations"] == 0 and snap["d2d_colocations"] > 0
            HyperLogLog(eng, names[0]).merge_with(*names[1:])
            assert eng.store.get(names[0]).arrays["regs"].device == _owner_card(eng, names[0])
            assert HyperLogLog(eng, names[0]).count() == want
            assert ioplane.STATS.snapshot()["host_colocations"] == 0
        finally:
            plain.shutdown()
    elif case == "test_bitset_bitop_across_devices_stays_on_device":
        a, b = _on_distinct_cards(p, 2, "bo")
        BitSet(eng, a).set_each(np.array([1, 5, 9]))
        BitSet(eng, b).set_each(np.array([2, 5, 100]))
        ioplane.STATS.reset()
        BitSet(eng, a).or_(b)
        snap = ioplane.STATS.snapshot()
        assert snap["host_colocations"] == 0 and snap["d2d_colocations"] > 0
        got = np.asarray(BitSet(eng, a).get_each(np.arange(128)))
        assert sorted(np.nonzero(got)[0].tolist()) == [1, 2, 5, 9, 100]
    else:
        import collections

        import redisson_tpu_torch
        from redisson_tpu_torch.client.codec import StringCodec
        from redisson_tpu_torch.services import mapreduce

        c = redisson_tpu_torch.create(device="cuda")
        try:
            c.engine.enable_placement(n_devices=2 * torch.cuda.device_count())
            m = c.get_map("ds:wc", codec=StringCodec())
            rng = np.random.default_rng(5)
            vocab = [f"w{i}" for i in range(40)]
            entries = {f"d{i}": " ".join(vocab[j] for j in rng.integers(0, 40, 6)) for i in range(3000)}
            m.put_all(entries)
            ioplane.STATS.reset()
            got = mapreduce.word_count(m)
            snap = ioplane.STATS.snapshot()
            want = collections.Counter(w for v in entries.values() for w in v.split())
            assert got == dict(want)
            assert snap["host_colocations"] == 0 and snap["d2d_colocations"] > 0
        finally:
            c.shutdown()
