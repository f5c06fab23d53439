"""The port's warm pool (redisson_tpu_torch/core/warmpool.py) against the
reference's (redisson_tpu/core/warmpool.py) on the CPU: the same records in
both packages warm the same keys, a second pass warms none, the records are
left as they were, and the server's ``--prewarm`` warms its restored
records at boot."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.core import warmpool as ref_wp
from redisson_tpu_torch.core import checkpoint as port_ckpt
from redisson_tpu_torch.core import warmpool as port_wp
from redisson_tpu_torch.services import mapreduce as MR

ROOT = Path(__file__).resolve().parent.parent


def _populate(c, salt: int):
    """One bloom filter, bloom bank, HLL and HLL bank."""
    rng = np.random.default_rng(salt)
    keys = rng.integers(0, 1 << 62, 300, dtype=np.int64)
    n = 10_000 + 97 * salt
    c.get_bloom_filter("wp:bf").try_init(n, 0.01)
    c.get_bloom_filter("wp:bf").add_all(keys)
    bfa = c.get_bloom_filter_array("wp:bfa")
    bfa.try_init(4, n, 0.01)
    bfa.add_each((np.arange(300) % 4).astype(np.int32), keys)
    c.get_hyper_log_log("wp:hll").add_all([f"h{i}" for i in range(50)])
    c.get_hyper_log_log_array("wp:hlla").try_init(3 + salt % 5)
    c.get_hyper_log_log_array("wp:hlla").add(
        (np.arange(300) % 3).astype(np.int32), keys)
    return ["wp:bf", "wp:bfa", "wp:hll", "wp:hlla"]


def _arrays(engine, names):
    return {(n, k): np.asarray(v).copy() for n in names
            for k, v in engine.store.get(n).arrays.items()}


def _norm_key(key):
    # the reference names dtypes as numpy does; the port's pool does too
    return tuple(str(x) if isinstance(x, np.dtype) else x for x in key)


@pytest.mark.parametrize("buckets", [(0,), (0, 5000)])
def test_prewarm_warms_the_references_keys_once_and_leaves_records(buckets, monkeypatch):
    # fresh pools: the process-global ones hold what earlier tests warmed
    monkeypatch.setattr(ref_wp, "POOL", ref_wp.KernelWarmPool())
    monkeypatch.setattr(port_wp, "POOL", port_wp.KernelWarmPool())
    salt = 3 + len(buckets)
    ref = redisson_tpu.create()
    port = redisson_tpu_torch.create(None, "cpu")
    try:
        names = _populate(ref, salt)
        assert _populate(port, salt) == names
        before = _arrays(port._engine, names)
        want = ref._engine.prewarm(names=names, buckets=buckets)
        got = port._engine.prewarm(names=names, buckets=buckets)
        assert got == want == 4 * len(buckets)
        new_ref = {_norm_key(k) for k in ref_wp.POOL._entries}
        new_port = {_norm_key(k) for k in port_wp.POOL._entries}
        assert new_port == new_ref
        # a single-device engine keys on device -1
        assert all(k[-1] == -1 for k in new_port)
        # everything is warm: a second pass warms nothing
        hits = port._engine.warm_pool.stats()["hits"]
        assert port._engine.prewarm(names=names, buckets=buckets) == 0
        assert ref._engine.prewarm(names=names, buckets=buckets) == 0
        assert port._engine.warm_pool.stats() == {"entries": got, "hits": hits + got, "warms": got}
        # the throwaway planes never touched a record
        after = _arrays(port._engine, names)
        assert before.keys() == after.keys()
        assert all(np.array_equal(before[k], after[k]) for k in before)
        ref_arrays = _arrays(ref._engine, names)
        assert all(np.array_equal(ref_arrays[k], after[k]) for k in after)
        assert port.get_bloom_filter("wp:bf").count() == ref.get_bloom_filter("wp:bf").count()
    finally:
        ref.shutdown()
        port.shutdown()


def test_pool_is_a_bounded_lru():
    pool = port_wp.KernelWarmPool(max_entries=3)
    ran = []
    for i in range(5):
        assert pool.warm(("k", i), lambda i=i: ran.append(i))
    assert not pool.warm(("k", 4), lambda: ran.append("again"))
    assert ran == [0, 1, 2, 3, 4] and len(pool) == 3
    assert not pool.warmed(("k", 0)) and pool.warmed(("k", 2))
    assert pool.stats() == {"entries": 3, "hits": 1, "warms": 5}


def test_word_count_warm_goes_through_the_pool():
    assert MR.prewarm_word_count_pooled(7_777, 1_333, device="cpu") is True
    assert MR.prewarm_word_count_pooled(7_777, 1_333, device="cpu") is False


def test_server_prewarm_flag_warms_the_restored_records(tmp_path):
    port = redisson_tpu_torch.create(None, "cpu")
    try:
        _populate(port, 11)
        path = str(tmp_path / "head.ckpt")
        assert port_ckpt.save(port._engine, path) == 4
    finally:
        port.shutdown()
    r, w = os.pipe()
    proc = subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch.server", "--device", "cpu", "--port", "0",
         "--checkpoint", path, "--restore", "--prewarm", "--ready-fd", str(w)],
        cwd=ROOT, pass_fds=(w,), stdout=subprocess.PIPE, text=True)
    os.close(w)
    try:
        with os.fdopen(r) as f:
            assert f.readline().split()[0] == "READY"
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0
    assert "restored 4 records" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("prewarmed "))
    assert line.split()[1] == "4"
    assert "serving on cpu" in out
