"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small adversarial sizes.

Needs a CUDA card and nvcc; without a card every test skips.  This file
imports neither JAX nor the JAX package, so it runs on a machine without
them; from the repository root:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py sets up JAX for the other test files.)
Plain versus JAX is covered on the CPU by tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.utils import hashing as H

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
    assert K.launches == {"bloom_probe": 2, "bloom_set": 1, "bloom_add": 1, "hll_add": 1, "hll_rows": 1}


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
