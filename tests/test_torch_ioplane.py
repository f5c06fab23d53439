"""The port's I/O plane (core/ioplane.py) and the coalescer's host planners
(core/coalesce.py) on the CPU: the staging pool's double buffer and its
one-off degrade with stand-in events, readback futures on demand and in one
grouped drain with their STATS counts, and plan_subwindows /
runs_within_admission against the JAX package's."""
import numpy as np
import pytest
import torch

import redisson_tpu_torch
from redisson_tpu.core import coalesce as JCO
from redisson_tpu_torch.core import coalesce as TCO
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import kernels as K


class _FakeEvent:
    """Stand-in for the CUDA event behind a slot's copy (query/synchronize)."""

    def __init__(self, done: bool):
        self.done = done
        self.waited = False

    def query(self) -> bool:
        return self.done

    def synchronize(self):
        self.waited = True
        self.done = True


def test_staging_pool_double_buffers_and_degrades_to_oneoff():
    pool = ioplane.StagingPool(depth=2)
    buf1, s1 = pool.acquire((3, 8))
    assert s1 is not None and buf1.shape == (3, 8) and not buf1.any()
    buf1[:] = 7  # dirty the slot: the next acquire must hand it back zeroed
    pool.commit(s1, _FakeEvent(done=True))
    buf2, s2 = pool.acquire((3, 8))
    assert s2 is s1 and not buf2.any(), "a reused slot must be zeroed"
    buf3, s3 = pool.acquire((3, 16))  # second slot; capacity grows on demand
    assert s3 is not None and s3 is not s1 and buf3.shape == (3, 16)
    buf4, s4 = pool.acquire((3, 8))  # pool exhausted: one-off buffer
    assert s4 is None and buf4.shape == (3, 8) and pool.oneoffs == 1
    pool.release(s2)
    pool.release(s3)
    assert pool.slot_count() == 2
    _, s5 = pool.acquire((3, 64))  # a released slot is handed out again, grown
    assert s5 in (s1, s3) and s5.buf.nbytes >= 3 * 64 * 4


def test_staging_pool_waits_only_for_copies_in_flight():
    pool = ioplane.StagingPool(depth=1)
    _, slot = pool.acquire((2, 4))
    done = _FakeEvent(done=True)
    pool.commit(slot, done)
    before = ioplane.STATS.snapshot()
    _, slot = pool.acquire((2, 4))  # previous copy done: no wait
    assert ioplane.STATS.snapshot()["staging_waits"] == before["staging_waits"]
    assert not done.waited
    inflight = _FakeEvent(done=False)
    pool.commit(slot, inflight)
    _, slot = pool.acquire((2, 4))  # previous copy in flight: a counted wait
    after = ioplane.STATS.snapshot()
    assert after["staging_waits"] == before["staging_waits"] + 1
    assert after["blocking_syncs"] == before["blocking_syncs"] + 1
    assert inflight.waited
    pool.release(slot)


def test_staging_pool_refills_the_other_slot_while_a_copy_is_in_flight():
    pool = ioplane.StagingPool(depth=2)
    _, a = pool.acquire((2, 4))
    first = _FakeEvent(done=False)
    pool.commit(a, first)
    before = ioplane.STATS.snapshot()["staging_waits"]
    _, b = pool.acquire((2, 4))  # a's copy in flight: the second slot, no wait
    assert b is not a and not first.waited
    second = _FakeEvent(done=False)
    pool.commit(b, second)
    assert ioplane.STATS.snapshot()["staging_waits"] == before
    _, c = pool.acquire((2, 4))  # both in flight, the pool full: wait on one
    assert c is a and first.waited and not second.waited
    assert ioplane.STATS.snapshot()["staging_waits"] == before + 1
    pool.commit(c, _FakeEvent(done=True))
    second.done = True
    _, d = pool.acquire((2, 4))  # both passed: the first free slot
    assert d is a and pool.slot_count() == 2


def test_pack_rows_through_a_pool_commits_its_slot():
    pool = ioplane.StagingPool(depth=1)
    a = np.arange(5, dtype=np.int32)
    b = np.arange(3, dtype=np.uint32) + 2**31
    got = K.pack_rows(a, b, size=8, device="cpu", pool=pool)
    want = K.pack_rows(a, b, size=8, device="cpu")
    assert torch.equal(got, want) and got.dtype == torch.int32
    slot = pool._slots[0]
    assert not slot.busy and slot.staged is None  # the CPU records no event
    with pytest.raises(AttributeError):
        K.pack_rows(a, object(), size=8, device="cpu", pool=pool)
    assert not slot.busy, "an error must release the slot"


def test_cpu_engine_has_no_staging_pool():
    """On the CPU the staged tensor aliases the slot, so reuse is unsafe."""
    c = redisson_tpu_torch.create(device="cpu")
    try:
        assert not ioplane.staging_reuse_safe("cpu") and ioplane.staging_reuse_safe("cuda")
        assert c.engine.staging_pool() is None
        assert c.engine.device_for_name("x") is None
    finally:
        c.shutdown()


def test_readback_future_on_demand_and_grouped_force():
    a = torch.arange(6, dtype=torch.int32) * 2
    b = torch.arange(4, dtype=torch.uint8)
    flags = torch.tensor([True, False, True])
    count = torch.tensor(7, dtype=torch.int32)
    bitmap = torch.tensor([-1, 5], dtype=torch.int32)  # uint32 bits in int32
    f1 = ioplane.ReadbackFuture((a,), lambda host: host[0][:3])
    f2 = ioplane.ReadbackFuture((a, b))
    f3 = ioplane.ReadbackFuture((flags, count, bitmap, np.arange(2, dtype=np.int64)))
    assert not f1.done() and f1.ready()
    before = ioplane.STATS.snapshot()
    ioplane.force_all([f1, f2, f3])  # ONE grouped transfer primes all three
    after = ioplane.STATS.snapshot()
    assert after["blocking_syncs"] == before["blocking_syncs"] + 1
    assert after["readbacks"] == before["readbacks"]
    assert f1.done() and f2.done() and f3.done()
    np.testing.assert_array_equal(f1.result(), [0, 2, 4])
    host_a, host_b = f2.result()
    np.testing.assert_array_equal(host_a, np.arange(6) * 2)
    assert host_a.dtype == np.int32 and host_b.dtype == np.uint8
    hf, hc, hb, hn = f3.result()
    assert hf.dtype == np.bool_ and hf.tolist() == [True, False, True]
    assert hc.shape == () and int(hc) == 7
    assert hb.tolist() == [-1, 5] and hn.tolist() == [0, 1]
    assert K.unpack_found(hb, 3).tolist() == [True, True, True]
    # the single-demand path counts a readback
    f4 = ioplane.ReadbackFuture((b,))
    np.testing.assert_array_equal(f4.result(), np.arange(4))
    assert ioplane.STATS.snapshot()["readbacks"] == after["readbacks"] + 1
    ioplane.force_all([f4])  # nothing left to fetch: no sync
    assert ioplane.STATS.snapshot()["blocking_syncs"] == after["blocking_syncs"] + 1


def test_readback_future_failure_lands_on_result():
    f = ioplane.ReadbackFuture((torch.zeros(3),), lambda host: 1 / 0)
    ioplane.force_all([f])
    with pytest.raises(ZeroDivisionError):
        f.result()


def test_gather_device_results_keeps_dtypes_and_shapes():
    vals = [torch.zeros((2, 3), dtype=torch.bool), torch.arange(12, dtype=torch.int64).reshape(3, 4),
            torch.tensor([1.5, -2.0]), torch.zeros(0, dtype=torch.int32), torch.arange(10, dtype=torch.uint8)[::3]]
    vals[0][1, 2] = True
    (got,) = ioplane.gather_device_results([vals])
    for g, v in zip(got, vals):
        assert g.dtype == v.numpy().dtype and g.shape == tuple(v.shape)
        np.testing.assert_array_equal(g, v.numpy())
    assert ioplane.gather_device_results([]) == []
    assert ioplane.device_of(vals[0]) == torch.device("cpu") and ioplane.device_of(np.zeros(1)) is None


def test_overlap_switch_round_trips():
    prev = ioplane.set_overlap(False)
    try:
        assert not ioplane.overlap_enabled()
        assert ioplane.set_overlap(True) is False
        assert ioplane.overlap_enabled()
    finally:
        ioplane.set_overlap(prev)


@pytest.mark.parametrize("seed", range(6))
def test_plan_subwindows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    items = [int(x) for x in rng.integers(1, 5000, int(rng.integers(0, 40)))]
    for target in (-1, 0, 1, 2500, 4999, 10_000, 10**9):
        assert TCO.plan_subwindows(items, target) == JCO.plan_subwindows(items, target)


@pytest.mark.parametrize("seed", range(6))
def test_runs_within_admission_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    n = 60
    bounds = sorted(set(int(x) for x in rng.integers(0, n, 12)))
    runs = [(a, b) for a, b in zip(bounds[::2], bounds[1::2])]
    mask = rng.random(n) < 0.3
    assert TCO.runs_within_admission(runs, mask) == JCO.runs_within_admission(runs, mask)
    assert TCO.runs_within_admission(runs, None) == JCO.runs_within_admission(runs, None) == runs
