"""MapReduce of the port against the JAX package, on the CPU: the cases of
tests/test_services.py's TestMapReduce on both packages, KernelMapReduce
against the JAX pipeline (sum, max and min of int32 and float32, keys
negative and out of range), the Collector's partitions, and the executor
path that waits for a later slice."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.services import mapreduce as RMR
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.services import mapreduce as MR


@pytest.fixture()
def clients():
    j = redisson_tpu.create()
    t = redisson_tpu_torch.create(device="cpu")
    yield j, t
    j.shutdown()
    t.shutdown()


def _mapper(k, v, collector):
    for w in v.split():
        collector.emit(w, 1)


def _reducer(word, counts):
    return sum(counts)


def test_word_count_generic(clients):
    out = []
    for c in clients:
        m = c.get_map("src")
        m.put_all({i: "alpha beta gamma beta" for i in range(50)})
        out.append(c.get_map_reduce(_mapper, _reducer, workers=4).execute(m))
    assert out[0] == out[1] == {"alpha": 50, "beta": 100, "gamma": 50}


def test_collator_and_result_map(clients):
    out = []
    for c in clients:
        m = c.get_map("src")
        m.put_all({i: "x y" for i in range(10)})
        mr = c.get_map_reduce(
            lambda k, v, col: [col.emit(w, 1) for w in v.split()],
            lambda w, counts: sum(counts),
            collator=lambda result: sum(result.values()),
        )
        out_map = c.get_map("out")
        out.append((mr.execute(m, result_map=out_map), out_map.get("x"), out_map.read_all_map()))
    assert out[0] == out[1] == (20, 10, {"x": 10, "y": 10})


def test_word_count_fast_path(clients):
    out = []
    for c, wc in zip(clients, (RMR.word_count, MR.word_count)):
        m = c.get_map("src")
        m.put_all({i: "tick tock tick" for i in range(100)})
        out.append(wc(m, workers=8))
    assert out[0] == out[1] == {"tick": 200, "tock": 100}


@pytest.mark.parametrize("workers", [1, 3, 16])
def test_generic_on_a_random_corpus_and_a_plain_source(clients, workers):
    rng = np.random.default_rng(workers)
    entries = {f"k{i}": " ".join(f"w{j}" for j in rng.integers(0, 40, 6)) for i in range(200)}
    out = []
    for c in clients:
        m = c.get_map("src")
        m.put_all(entries)
        mr = c.get_map_reduce(_mapper, _reducer, workers=workers).timeout(30)
        out.append(mr.execute(m))
        # an iterable of (key, value) pairs is a source too
        out.append(mr.execute(list(entries.items())))
    assert out[0] == out[1] == out[2] == out[3] == MR._host_word_count(list(entries.values()))


def test_mapper_errors_raise(clients):
    for c in clients:
        m = c.get_map("src")
        m.put_all({1: "a"})

        def bad(k, v, col):
            raise KeyError("mapper failed")

        with pytest.raises(KeyError, match="mapper failed"):
            c.get_map_reduce(bad, _reducer).execute(m)


def test_collector_partitions_equal_the_reference():
    keys = ["alpha", "beta", "", "répé", 17, ("t", 1), b"raw", "x" * 100]
    ours, ref = MR.Collector(7), RMR.Collector(7)
    for i, k in enumerate(keys):
        ours.emit(k, i)
        ref.emit(k, i)
    assert [dict(p) for p in ours._parts] == [dict(p) for p in ref._parts]


def test_executor_path_is_not_ported_yet(clients):
    _, t = clients
    m = t.get_map("src")
    m.put("a", "b")
    with pytest.raises(NotImplementedError, match="M7"):
        t.get_map_reduce(_mapper, _reducer, executor=object())
    with pytest.raises(NotImplementedError, match="M7"):
        MR.MapReduce(t.engine, _mapper, _reducer, executor=object())
    with pytest.raises(NotImplementedError, match="M7"):
        MR.word_count(m, executor=object())


def test_kernel_mapreduce_as_in_test_services():
    kmr = MR.KernelMapReduce(lambda v: (v % 16, v * 2), reduce="sum", n_keys=16, device="cpu")
    values = np.arange(1600, dtype=np.int32)
    ref = RMR.KernelMapReduce(lambda v: (v % 16, v * 2), reduce="sum", n_keys=16).execute(values)
    out = kmr.execute(values)
    expected = np.asarray([sum(2 * v for v in range(k, 1600, 16)) for k in range(16)])
    np.testing.assert_array_equal(out, expected)
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == ref.dtype == np.int32


def _float_sum_tolerance(keys, vals, n_keys):
    """A float32 sum in any order is within (count - 1) * 2**-24 * sum|v| of
    the exact sum (first order), so two orders differ by at most twice
    that: the card adds with atomics, in an order of its own."""
    k = keys.astype(np.int64)
    k = np.where(k < 0, k + n_keys, k)
    keep = (k >= 0) & (k < n_keys)
    cnt = np.bincount(k[keep], minlength=n_keys)
    mag = np.bincount(k[keep], np.abs(vals[keep].astype(np.float64)), minlength=n_keys)
    return 2 * cnt * 2.0**-24 * mag


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n_keys", [1, 50, 1024])
def test_kernel_mapreduce_matches_jax(reduce, dtype, n_keys):
    """Keys from the value itself, some negative (within one wrap, counted
    from the end) and some out of range (dropped), as JAX's .at[] does."""
    rng = np.random.default_rng(n_keys)
    n = 20_000
    if dtype == "int32":
        vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    else:
        vals = rng.normal(0, 1000, n).astype(np.float32)
    keys = rng.integers(-2 * n_keys - 3, 2 * n_keys + 3, n).astype(np.int32)
    # one row per value: its key (exact in either type), then the value
    packed = np.stack([keys.astype(vals.dtype), vals], 1)

    def jax_fn(row):
        return row[0].astype(jnp.int32), row[1]

    def torch_fn(row):
        return row[0].to(torch.int32), row[1]

    ref = RMR.KernelMapReduce(jax_fn, reduce, n_keys).execute(packed)
    got = MR.KernelMapReduce(torch_fn, reduce, n_keys, device="cpu").execute(packed)
    assert got.dtype == ref.dtype and got.shape == (n_keys,)
    if dtype == "float32" and reduce == "sum":
        assert np.all(np.abs(got.astype(np.float64) - ref) <= _float_sum_tolerance(keys, vals, n_keys))
    else:
        np.testing.assert_array_equal(got, ref)


def test_kernel_mapreduce_identities_and_wrap():
    """Empty slots keep the reduction's identity; int32 sums wrap."""
    vals = np.asarray([2**31 - 1, 5, 3, -7], np.int32)
    keys_fn = (lambda v: (torch.zeros_like(v, dtype=torch.int32), v),
               lambda v: (jnp.zeros_like(v, dtype=jnp.int32), v))
    for reduce in ("sum", "max", "min"):
        got = MR.KernelMapReduce(keys_fn[0], reduce, 3, device="cpu").execute(vals)
        ref = RMR.KernelMapReduce(keys_fn[1], reduce, 3).execute(vals)
        np.testing.assert_array_equal(got, ref)
        f = vals.astype(np.float32)
        np.testing.assert_array_equal(MR.KernelMapReduce(keys_fn[0], reduce, 3, device="cpu").execute(f),
                                      RMR.KernelMapReduce(keys_fn[1], reduce, 3).execute(f))
    with pytest.raises(ValueError):
        MR.KernelMapReduce(keys_fn[0], "mean", 3, device="cpu")


def test_segment_reduce_checks_its_operands():
    k = torch.tensor([0, 1], dtype=torch.int32)
    v = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError):
        K.segment_reduce(k, v[:1], 4)
    with pytest.raises(ValueError):
        K.segment_reduce(k, v, 0)
    with pytest.raises(ValueError):
        K.segment_reduce(k, v, 4, "prod")
    with pytest.raises(ValueError):  # JAX refuses float indexes too
        K.segment_reduce(k.to(torch.float32), v, 4)
