"""The word-count device path of the port against the JAX package, on the CPU.

The kernels' plain versions (wc_extract_words, wc_extract_words_auto,
wc_sort_runs) against the JAX programs on the same numpy buffers, bit for
bit; device_word_count and word_count against the reference's and
Counter's counts; the staged view's invalidation; and no fallback that
hides a kernel.  The kernels themselves are held to these plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.client.codec import StringCodec as RStringCodec
from redisson_tpu.client.objects.map import MapLoader as RMapLoader
from redisson_tpu.client.objects.map import MapOptions as RMapOptions
from redisson_tpu.core import kernels as RK
from redisson_tpu.services import mapreduce as RMR
from redisson_tpu_torch.client.codec import StringCodec
from redisson_tpu_torch.client.objects.map import MapLoader, MapOptions
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.services import mapreduce as MR
import _wc_edges as E  # tests/ is on the path of a test module

# the corpora of tests/test_wordcount_device.py
CORPORA = [
    ["foo bar foo", "baz foo bar"],
    ["single"],
    ["  leading and  double   spaces ", "trailing spaces  "],
    ["tabs\tand\nnewlines\r\nmixed", "v\x0bv\x0cw"],
    ["", "", "only third has words"],
    ["a b c d e f g h i j" * 3],
    ["répé unicode répé", "naïve café"],
    ["alpha\x1cbeta", "alpha beta", "g\x1dh\x1ei\x1fj"],
    ["x" * 200 + " short " + "x" * 200, "short " + "y" * 80],
]


def _counter(vals):
    c = Counter()
    for v in vals:
        c.update(v.split())
    return dict(c)


def _random_corpus(seed, n_values=300, vocab=400):
    """Seeded values: words of 1-12 printable bytes, one in 50 of 64-150
    bytes (some sharing a 63-byte prefix), ASCII whitespace of every kind."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789-_.,!?", np.uint8)
    words = []
    for i in range(vocab):
        ln = int(rng.integers(64, 150)) if i % 50 == 0 else int(rng.integers(1, 13))
        words.append(bytes(letters[rng.integers(0, letters.size, ln)]).decode())
    words.append("p" * 63 + "q")
    words.append("p" * 63 + "r")
    seps = [" ", "  ", "\t", "\n", "\r\n", "\x0b", "\x0c", "\x1c", "\x1f"]
    vals = []
    for _ in range(n_values):
        k = int(rng.integers(0, 12))
        ids = rng.integers(0, len(words), k)
        vals.append("".join(words[j] + seps[int(rng.integers(0, len(seps)))] for j in ids))
    return vals


def _buffer(vals):
    """A chunk as both packages build it; the port's bytes equal the
    reference's normalisation."""
    big, buf, n_ends = MR._wc_chunk_bytes(vals)
    joined = " ".join(vals) + " "
    assert big == joined.encode().translate(RMR._WS_TRANSLATE)
    ws = buf == 32
    assert n_ends == int(np.count_nonzero(~ws[:-1] & ws[1:]))
    return buf, n_ends


def _same(ref, got):
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), r.view(np.int32))


def _auto_both(buf, n_words, eb, base):
    ref = RK.wc_extract_words_auto(jnp.asarray(buf), jnp.int32(n_words), eb, jnp.uint32(base))
    got = K.wc_extract_words_auto(torch.from_numpy(buf), n_words, eb, base)
    _same(ref, got)
    return ref, got


def _delta_both(buf, deltas, n_words, base):
    ref = RK.wc_extract_words(jnp.asarray(buf), jnp.asarray(deltas.astype(np.uint16)), jnp.int32(n_words),
                              jnp.uint32(base))
    got = K.wc_extract_words(torch.from_numpy(buf), torch.from_numpy(deltas.astype(np.int32)), n_words, base)
    _same(ref, got)


def _sort_both(ha, hb, st, d_max):
    ref = np.asarray(RK.wc_sort_runs(jnp.asarray(ha), jnp.asarray(hb), jnp.asarray(st), d_max))
    got = K.wc_sort_runs(*(torch.from_numpy(np.asarray(x).view(np.int32).copy()) for x in (ha, hb, st)), d_max)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _true_deltas(buf, rows):
    ws = buf == 32
    ends = np.nonzero(~ws & np.concatenate([ws[1:], [True]]))[0]
    d = np.zeros(rows, np.int64)
    k = min(rows, ends.size)
    d[:k] = np.diff(np.concatenate([[-1], ends]))[:k]
    return d


@pytest.mark.parametrize("vals", CORPORA + [_random_corpus(s) for s in range(4)],
                         ids=[f"corpus{i}" for i in range(len(CORPORA))] + [f"random{s}" for s in range(4)])
def test_extract_and_sort_match_jax_bit_for_bit(vals):
    buf, n_ends = _buffer(vals)
    eb = K.bucket_size(max(1, n_ends))
    ref, _ = _auto_both(buf, n_ends, eb, 1000)
    _delta_both(buf, _true_deltas(buf, eb), n_ends, 1000)
    ha, hb, st = (jnp.concatenate([x, x]) for x in ref)
    for d_max in (1 << 17, 64, 3):
        _sort_both(ha, hb, st, d_max)


@pytest.mark.parametrize("case", ["last-byte-not-space", "eb-below-ends", "n-words-0", "n-words-past-ends",
                                  "eb-equals-n", "base-wraps", "all-space", "one-long-word"])
def test_extract_edges_match_jax(case):
    rng = np.random.default_rng(7)
    text = np.frombuffer(b"ab cd  efg hij" * 40, np.uint8).copy()
    buf, n_words, eb, base = {
        "last-byte-not-space": (text, 150, 256, 0),
        "eb-below-ends": (np.concatenate([text, np.full(200, 32, np.uint8)]), 160, 40, 5),
        "n-words-0": (text, 0, 256, 9),
        "n-words-past-ends": (text, 400, 512, 0),
        "eb-equals-n": (text[:300], 300, 300, 0),
        "base-wraps": (text, 160, 256, 2**32 - 7),
        "all-space": (np.full(256, 32, np.uint8), 3, 256, 0),
        "one-long-word": (np.full(700, 120, np.uint8), 1, 256, 0),
    }[case]
    _auto_both(buf, n_words, eb, base)
    for deltas in (_true_deltas(buf, eb), rng.integers(0, 40, eb), rng.integers(0, 65536, eb), np.zeros(eb)):
        _delta_both(buf, deltas, n_words, base)


@pytest.mark.parametrize("case", list(E.wc_edge_buffers()))
def test_extract_tile_edges_match_jax(case):
    """The card tests' wc_words edges (tile and halo edges, long words, n
    not a multiple of 16; eb below the end count, n_words past it, base
    near 2**32), plain against JAX, also on a buffer that starts 7 bytes
    into a larger one."""
    buf = E.wc_edge_buffers()[case]
    for n_words, eb, base in E.wc_row_cases(buf):
        _auto_both(buf, n_words, eb, base)
        _delta_both(buf, E.true_deltas(buf, eb), n_words, base)
    big = np.full(buf.size + 16, 32, np.uint8)
    big[7: 7 + buf.size] = buf
    n_words, eb, base = E.wc_row_cases(buf)[0]
    _auto_both(big[7: 7 + buf.size], n_words, eb, base)


def _jax_segment(keys, vals, n_keys, reduce):
    """KernelMapReduce.pipeline's reduction (redisson_tpu/services/mapreduce.py)."""
    k, v = jnp.asarray(keys.astype(np.int32)), jnp.asarray(vals)
    if reduce == "sum":
        return np.asarray(jnp.zeros((n_keys,), v.dtype).at[k].add(v))
    if reduce == "max":
        lo = jnp.iinfo(v.dtype).min if v.dtype.kind == "i" else -jnp.inf
        return np.asarray(jnp.full((n_keys,), lo, v.dtype).at[k].max(v))
    hi = jnp.iinfo(v.dtype).max if v.dtype.kind == "i" else jnp.inf
    return np.asarray(jnp.full((n_keys,), hi, v.dtype).at[k].min(v))


@pytest.mark.parametrize("case", list(E.segment_edge_cases()) + ["n_keys at the card's shared limit and past it"])
def test_segment_edges_match_jax(case):
    """The card tests' segment_reduce edges, plain against JAX's .at[]:
    int32 exact; float32 max and min exact with NaN kept; the float32 sum
    within the rounding of two orders."""
    rng = np.random.default_rng(3)
    if case in E.segment_edge_cases():
        keys, ivals, n_keys = E.segment_edge_cases()[case]
        sets = [(keys, ivals, n_keys)]
    else:
        sets = []
        for n_keys in (58108, 58109):
            keys = rng.integers(-3 * n_keys, 3 * n_keys, 50_000)
            sets.append((keys, rng.integers(-(2**31), 2**31 - 1, keys.size).astype(np.int32), n_keys))
    for keys, ivals, n_keys in sets:
        fvals = rng.normal(0, 1000, keys.size).astype(np.float32)
        fvals[::97] = np.nan
        for key_dtype in (torch.int32, torch.int64):
            k = torch.from_numpy(keys).to(key_dtype)
            for reduce in ("sum", "max", "min"):
                got = K.segment_reduce(k, torch.from_numpy(ivals), n_keys, reduce).numpy()
                np.testing.assert_array_equal(got, _jax_segment(keys, ivals, n_keys, reduce))
                got = K.segment_reduce(k, torch.from_numpy(fvals), n_keys, reduce).numpy()
                ref = _jax_segment(keys, fvals, n_keys, reduce)
                if reduce == "sum":
                    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
                    ok = ~np.isnan(ref)
                    kk = np.where(keys < 0, keys + n_keys, keys)
                    live = (kk >= 0) & (kk < n_keys)
                    mag = np.bincount(kk[live], np.abs(np.nan_to_num(fvals[live])).astype(np.float64), n_keys)
                    cnt = np.bincount(kk[live], minlength=n_keys)
                    assert np.all(np.abs(got[ok].astype(np.float64) - ref[ok]) <= 2 * cnt[ok] * 2.0**-24 * mag[ok])
                else:
                    np.testing.assert_array_equal(got, ref)


def test_extract_auto_refuses_eb_past_the_buffer():
    with pytest.raises(ValueError):
        K.wc_extract_words_auto(torch.full((256,), 32, dtype=torch.uint8), 1, 257, 0)
    with pytest.raises(ValueError):
        K.wc_extract_words_auto(torch.zeros(0, dtype=torch.uint8), 0, 0, 0)


@pytest.mark.parametrize("n", [1, 2, 300, 4097])
def test_sort_runs_random_keys_match_jax(n):
    rng = np.random.default_rng(n)
    for distinct in (1, 7, n):
        words = rng.integers(0, 2**32, (distinct, 2), dtype=np.uint64).astype(np.uint32)
        words[0] = 0xFFFFFFFF
        if distinct > 2:
            words[1] = [0x80000000, 0]
            words[2] = [0x7FFFFFFF, 0xFFFFFFFF]
        ids = rng.integers(0, distinct, n)
        st = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        for d_max in (1, n, 1 << 17):
            _sort_both(words[ids, 0], words[ids, 1], st, d_max)


def test_sort_runs_refuses_what_the_status_words_cannot_count():
    """Counts travel in the low 32 bits of a status word: the sort takes 1 to
    2**31 - 1 rows (a zero-stride view stands in for 2**31 rows)."""
    big = torch.zeros(1, dtype=torch.int32).expand(2**31)
    with pytest.raises(ValueError):
        K.wc_sort_runs(big, big, big, 10)
    empty = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.wc_sort_runs(empty, empty, empty, 10)


@pytest.mark.parametrize("vals", CORPORA + [_random_corpus(s, n_values=500) for s in (11, 12)],
                         ids=[f"corpus{i}" for i in range(len(CORPORA))] + ["random11", "random12"])
def test_device_word_count_equals_reference_and_counter(vals):
    MR.reset_stats()
    got = MR.device_word_count(vals, device="cpu")
    assert got == RMR.device_word_count(vals) == _counter(vals)
    unicode_ws = any(MR._UNICODE_WS_RE.search(v) for v in vals)
    assert MR.STATS["host_fallbacks"] == int(unicode_ws)
    assert MR.STATS["device_scans"] == int(not unicode_ws)


def test_device_word_count_unicode_whitespace_falls_back_and_counts():
    vals = ["a b c", "x　y", "nbsp here"]
    MR.reset_stats()
    assert MR.device_word_count(vals, device="cpu") == RMR.device_word_count(vals) == _counter(vals)
    assert MR.STATS == {"device_scans": 0, "view_hits": 0, "host_fallbacks": 1}


def _record_sorts(monkeypatch):
    """The d_max of every wc_sort_runs call, the wrapper itself still run."""
    seen = []
    real = K.wc_sort_runs

    def sort(ha, hb, st, d_max):
        seen.append(d_max)
        return real(ha, hb, st, d_max)

    monkeypatch.setattr(K, "wc_sort_runs", sort)
    return seen


def test_device_word_count_d_max_fallback_counts(monkeypatch):
    """More distinct words than d_max sort again on the device with room
    for every row (d_max = N), where the reference counts on the host."""
    vals = [" ".join(f"w{i}" for i in range(j, j + 50)) for j in range(0, 3000, 50)]
    seen = _record_sorts(monkeypatch)
    MR.reset_stats()
    got = MR.device_word_count(vals, d_max_bits=8, device="cpu")
    assert got == RMR.device_word_count(vals, d_max_bits=8) == _counter(vals)
    assert MR.STATS == {"device_scans": 1, "view_hits": 0, "host_fallbacks": 0}
    assert seen == [256, 2 * K.bucket_size(1500)]  # two chunks of 1,500 words, each padded
    seen.clear()
    assert MR.device_word_count(vals, d_max_bits=12, device="cpu") == _counter(vals)
    assert seen == [4096]


def test_device_word_count_empty_and_chunking():
    assert MR.device_word_count([], device="cpu") == {}
    vals = _random_corpus(5, n_values=101)
    for n_chunks in (1, 2, 3, 7):
        assert MR.device_word_count(vals, n_chunks=n_chunks, device="cpu") == _counter(vals)


@pytest.fixture()
def clients():
    j = redisson_tpu.create()
    t = redisson_tpu_torch.create(device="cpu")
    yield j, t
    j.shutdown()
    t.shutdown()


def test_word_count_equals_reference_with_view_invalidation(clients):
    """The cold scan, the staged view, then a put, a remove and a delete +
    recreate (versions restart; the nonce tells the records apart): every
    count equal to the reference's and Counter's."""
    j, t = clients
    maps = [c.get_map("wc:view", codec=codec()) for c, codec in ((j, RStringCodec), (t, StringCodec))]
    vals = _random_corpus(21, n_values=400)
    entries = {f"d{i}": v for i, v in enumerate(vals)}

    def both(expect_view_hit):
        hits = MR.STATS["view_hits"]
        got = MR.word_count(maps[1])
        assert got == RMR.word_count(maps[0]) == _counter(maps[1].read_all_values())
        assert MR.STATS["view_hits"] == hits + int(expect_view_hit)
        return got

    for m in maps:
        m.put_all(entries)
    MR.reset_stats()
    both(False)
    both(True)
    rec = t.engine.store.get("wc:view")
    assert t.engine.service("wc_scan_views", MR._WcViewCache).get("wc:view", (rec.nonce, rec.version))
    for m in maps:
        m.put("extra", "gamma gamma fresh")
    assert both(False)["gamma"] >= 2
    both(True)
    for m in maps:
        m.remove("extra")
    both(False)
    nonce, version = rec.nonce, rec.version
    for m in maps:
        m.delete()
        m.put_all({"x": "delta"})
        m.put_all({"y": "delta"})
    rec2 = t.engine.store.get("wc:view")
    assert rec2.nonce != nonce
    assert both(False) == {"delta": 2}
    assert MR.STATS["host_fallbacks"] == 0


def test_word_count_past_d_max_counts_on_the_device(clients, monkeypatch):
    """A map with more distinct words than d_max: the cold scan and the view
    hit both sort again at d_max = N and count no word on the host."""
    j, t = clients
    monkeypatch.setattr(MR, "_WC_D_MAX_BITS", 6)
    vals = _random_corpus(31, n_values=200, vocab=300)
    maps = [c.get_map("wc:many", codec=codec()) for c, codec in ((j, RStringCodec), (t, StringCodec))]
    for m in maps:
        m.put_all({f"d{i}": v for i, v in enumerate(vals)})
    want = RMR.word_count(maps[0])
    assert len(want) > 64 and want == _counter(vals)
    seen = _record_sorts(monkeypatch)
    MR.reset_stats()
    assert MR.word_count(maps[1]) == want
    assert MR.word_count(maps[1]) == want
    assert MR.STATS == {"device_scans": 1, "view_hits": 1, "host_fallbacks": 0}
    n = seen[1]
    assert seen == [64, n, 64, n] and n > 64


def test_word_count_parts_time_the_scan(clients):
    """word_count(parts=...) fills the cold scan's parts, and a view hit's
    sort, copy and decode, from the same call that counts."""
    _, t = clients
    m = t.get_map("wc:parts", codec=StringCodec())
    m.put_all({"a": "alpha beta", "b": "beta gamma"})
    cold, warm = {}, {}
    assert MR.word_count(m, parts=cold) == MR.word_count(m, parts=warm) == {"alpha": 1, "beta": 2, "gamma": 1}
    assert set(cold) == {"read_values_s", "join_encode_s", "h2d_s", "wc_words_s", "wc_sort_runs_s", "d2h_s",
                         "decode_s"}
    assert set(warm) == {"wc_sort_runs_s", "d2h_s", "decode_s"}
    assert all(v >= 0 for v in (*cold.values(), *warm.values()))


def test_word_count_loader_backed_map_skips_the_view(clients):
    j, t = clients

    class L(MapLoader):
        def load(self, key):
            return "gamma gamma"

    class RL(RMapLoader):
        def load(self, key):
            return "gamma gamma"

    rm = j.get_map("wc:loader", codec=RStringCodec(), options=RMapOptions(loader=RL()))
    m = t.get_map("wc:loader", codec=StringCodec(), options=MapOptions(loader=L()))
    for x in (rm, m):
        x.put("a", "alpha beta")
    assert MR.word_count(m) == RMR.word_count(rm) == {"alpha": 1, "beta": 1}
    for x in (rm, m):
        x.get("newkey")  # read-through load, no version bump
    assert MR.word_count(m) == RMR.word_count(rm) == {"alpha": 1, "beta": 1, "gamma": 2}


def test_word_count_other_codecs_and_absent_map(clients):
    j, t = clients
    rm, m = j.get_map("wc:json"), t.get_map("wc:json")
    for x in (rm, m):
        x.put_all({1: "one two", 2: 3, "k": ["a", "b"]})
    assert MR.word_count(m) == RMR.word_count(rm)
    assert MR.word_count(t.get_map("wc:absent")) == RMR.word_count(j.get_map("wc:absent")) == {}


def test_word_count_unicode_map_falls_back_and_counts(clients):
    _, t = clients
    m = t.get_map("wc:u", codec=StringCodec())
    m.put_all({"a": "x y z", "b": "z"})
    MR.reset_stats()
    assert MR.word_count(m) == {"x": 1, "y": 1, "z": 2}
    assert MR.STATS == {"device_scans": 0, "view_hits": 0, "host_fallbacks": 1}


@pytest.mark.parametrize("kernel", ["wc_extract_words_auto", "wc_sort_runs"])
def test_a_failing_kernel_raises_through_word_count(clients, monkeypatch, kernel):
    """The reference falls back to the host on any exception; the port
    lets a failed build or launch raise, on a cold scan and on a view."""
    _, t = clients
    m = t.get_map("wc:fail", codec=StringCodec())
    m.put_all({"a": "alpha beta", "b": "beta"})
    if kernel == "wc_sort_runs":
        assert MR.word_count(m) == {"alpha": 1, "beta": 2}  # stage the view first

    def boom(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(K, kernel, boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        MR.word_count(m)
    with pytest.raises(RuntimeError, match="launch failed"):
        MR.device_word_count(["alpha beta"], device="cpu")


def test_view_cache_is_lru_and_drops_stale_views():
    cache = MR._WcViewCache(cap=2)
    views = {n: MR._WcScanView((1, 0), None, None, None, [], [], 0) for n in "abc"}
    cache.put("a", views["a"])
    cache.put("b", views["b"])
    assert cache.get("a", (1, 0)) is views["a"]  # a is now the most recent
    cache.put("c", views["c"])
    assert cache.get("b", (1, 0)) is None and cache.get("a", (1, 0)) is views["a"]
    assert cache.get("c", (1, 1)) is None and "c" not in cache._views


def test_prewarm_and_entry_points_default_to_the_card():
    K.reset_launches()
    MR.prewarm_word_count(5000, 900, device="cpu")
    assert K.launches["wc_words"] == K.launches["wc_sort_runs"] == 0  # the plain versions ran
    if not torch.cuda.is_available():
        for call in (lambda: MR.prewarm_word_count(5000, 900), lambda: MR.device_word_count(["a"]),
                     lambda: MR.KernelMapReduce(lambda v: (v, v))):
            with pytest.raises(RuntimeError, match="CUDA card"):
                call()


def test_gc_pause_is_reentrant():
    import gc

    was = gc.isenabled()
    gc.enable()
    try:
        with MR._gc_paused():
            with MR._gc_paused():
                assert not gc.isenabled()
            assert not gc.isenabled()
        assert gc.isenabled()
    finally:
        if not was:
            gc.disable()
