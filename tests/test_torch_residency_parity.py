"""Three residency behaviours of the reference that the port now has, each
held against the reference on the CPU:

  * a forced demotion takes any record with arrays: a record holding a
    ShardedPlane (a sharded bloom bank on 8 positions) and one holding a
    numpy plane both demote, reply as the reference's DEMOTE does, and
    fault back in with the same bytes, now as tensors on the owner's
    device, as the reference's come back as device arrays;
  * a fault-in whose packed upload refuses a dtype (``bfloat16``, which
    torch.from_numpy does not read) uploads each array on its own
    (``core/residency.upload_array``), the same bytes as the reference's;
  * ``ResidencyManager(cold_after_s=..., gate_timeout_s=...)``: a sweep
    spills WARM records idle for ``cold_after_s`` COLD, as the
    reference's does, and a fault-in outside a lane waits at most
    ``gate_timeout_s`` for the owner lane's busy gate.

Every input is built from a numpy seed."""
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.config import Config as RefConfig
from redisson_tpu.core import residency as ref_res
from redisson_tpu.core.store import StateRecord as RefRecord
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.core import residency as port_res
from redisson_tpu_torch.core.store import StateRecord
from redisson_tpu_torch.parallel import mesh as TM

TM.set_cpu_positions(8)


@pytest.fixture(autouse=True)
def _armed():
    saved = [(m, m.tier_enabled()) for m in (ref_res, port_res)]
    for m, _ in saved:
        m.set_tier(True)
    yield
    for m, tier in saved:
        m.set_tier(tier)


def _pair(sharded: bool = False):
    """A reference and a port client on the CPU, residency armed with no
    idle floor (and with the 2 x 4 mesh of 8 positions when `sharded`)."""
    out = []
    for pkg, cfg_cls, kw in ((redisson_tpu, RefConfig, {}), (redisson_tpu_torch, Config, {"device": "cpu"})):
        cfg = cfg_cls()
        if sharded:
            cfg.mesh.dp, cfg.mesh.shard, cfg.mesh.n_devices = 2, 4, 8
        c = pkg.create(cfg, **kw)
        c._engine.enable_residency(min_idle_s=0.0)
        out.append(c)
    return out


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def test_a_forced_demote_takes_a_sharded_plane_and_faults_it_back():
    ref, port = _pair(sharded=True)
    try:
        rng = np.random.default_rng(7)
        t = rng.integers(0, 16, 3000).astype(np.int32)
        k = rng.integers(0, 1 << 60, 3000).astype(np.int64)
        probe_t = np.concatenate([t, rng.integers(0, 16, 3000).astype(np.int32)])
        probe_k = np.concatenate([k, rng.integers(0, 1 << 60, 3000).astype(np.int64)])
        flags = []
        for c in (ref, port):
            bank = c.get_sharded_bloom_filter_array("rp:sh")
            assert bank.try_init(16, 5000, 0.01)
            bank.add_each(t, k)
            before = np.asarray(bank.contains_each(probe_t, probe_k))
            rec = c._engine.store.get("rp:sh")
            whole = _host(rec.arrays["bits"]) if not hasattr(rec.arrays["bits"], "gather") \
                else rec.arrays["bits"].numpy()
            mgr = c._engine.residency
            assert mgr.demote("rp:sh", force=True) is True
            assert rec.tier == "warm" and rec.stash is not None
            np.testing.assert_array_equal(rec.stash["bits"], whole)
            after = np.asarray(bank.contains_each(probe_t, probe_k))  # faults in, re-lays onto the mesh
            np.testing.assert_array_equal(after, before)
            assert rec.tier == "hot"
            flags.append(after)
        np.testing.assert_array_equal(flags[0], flags[1])
    finally:
        ref.shutdown()
        port.shutdown()


def test_a_forced_demote_takes_a_numpy_plane_with_the_references_reply():
    from redisson_tpu.server.server import ServerThread as RefServerThread
    from redisson_tpu_torch.server import ServerThread

    plane = np.random.default_rng(3).integers(0, 2, 4096).astype(np.uint8)
    replies, back = [], []
    for st_cls, rec_cls, kw in ((RefServerThread, RefRecord, {}), (ServerThread, StateRecord, {"device": "cpu"})):
        with st_cls(port=0, **kw) as st, st.client() as c:
            assert c.execute("CONFIG", "SET", "residency-enabled", "yes") in (b"OK", "OK")
            eng = st.server.engine
            eng.residency.min_idle_s = 0.0
            eng.store.put("rp:np", rec_cls(kind="bitset", meta={"nbits": plane.size},
                                           arrays={"bits": plane.copy()}))
            replies.append([c.execute("CLUSTER", "RESIDENCY", "DEMOTE", "rp:np"),
                            c.execute("CLUSTER", "RESIDENCY", "TIER", "rp:np")])
            rec = eng.store.get("rp:np")  # the getter faults it back in
            assert rec.tier == "hot"
            back.append(_host(rec.arrays["bits"]))
    assert replies[0] == replies[1] and replies[1][0] == 1
    np.testing.assert_array_equal(back[0], plane)
    np.testing.assert_array_equal(back[1], plane)


def test_a_refused_packed_fault_in_uploads_each_array_the_same_bytes(monkeypatch):
    ref, port = _pair()
    stash = {"bf16": np.random.default_rng(5).standard_normal(300).astype(ml_dtypes.bfloat16),
             "ints": np.arange(17, dtype=np.int32)}
    calls = []
    real = port_res.upload_array
    monkeypatch.setattr(port_res, "upload_array", lambda v, d: calls.append(v.dtype) or real(v, d))
    try:
        got = []
        for c, rec_cls, tensor in ((ref, RefRecord, None), (port, StateRecord, torch.zeros(4))):
            eng = c._engine
            first = np.zeros(4, np.float32) if tensor is None else tensor
            eng.store.put("rp:x", rec_cls(kind="blob", meta={}, arrays={"v": first}))
            assert eng.residency.demote("rp:x", force=True)
            rec = eng.store._states["rp:x"]
            rec.stash = dict(stash)
            rec = eng.store.get("rp:x")  # fault-in
            assert rec.tier == "hot"
            got.append(rec.arrays)
        ref_bf16 = np.asarray(got[0]["bf16"]).view(np.uint16)
        port_bf16 = got[1]["bf16"]
        assert port_bf16.dtype == torch.bfloat16
        np.testing.assert_array_equal(port_bf16.view(torch.uint16).numpy(), stash["bf16"].view(np.uint16))
        np.testing.assert_array_equal(port_bf16.view(torch.uint16).numpy(), ref_bf16)
        np.testing.assert_array_equal(got[1]["ints"].numpy(), np.asarray(got[0]["ints"]))
        assert sorted(str(d) for d in calls) == ["bfloat16", "int32"]
    finally:
        ref.shutdown()
        port.shutdown()


def test_cold_after_s_spills_idle_warm_records_as_the_reference_does():
    sweeps = []
    for pkg, kw in ((redisson_tpu, {}), (redisson_tpu_torch, {"device": "cpu"})):
        c = pkg.create(**kw)
        try:
            eng = c._engine
            mgr = eng.enable_residency(min_idle_s=0.0, cold_after_s=0.5)
            assert mgr.cold_after_s == 0.5
            for name in ("rp:c0", "rp:c1"):
                bf = c.get_bloom_filter(name)
                bf.try_init(1000, 0.01)
                bf.add_all([b"a", b"b"])
                assert bf.contains(b"a")  # every kernel built before the clock matters
                assert mgr.demote(name)
            time.sleep(0.6)
            c.get_bloom_filter("rp:c1").contains(b"a")  # touched: HOT again, not idle
            assert mgr.demote("rp:c1")  # WARM, but touched just now
            first = mgr.sweep()
            tiers = [mgr.tier_of(n) for n in ("rp:c0", "rp:c1")]
            time.sleep(0.6)
            second = mgr.sweep()
            sweeps.append((first, tiers, second, [mgr.tier_of(n) for n in ("rp:c0", "rp:c1")],
                           c.get_bloom_filter("rp:c0").contains(b"a")))
        finally:
            c.shutdown()
    assert sweeps[0] == sweeps[1]
    assert sweeps[1][0]["colded"] == 1 and sweeps[1][1] == ["cold", "warm"]
    assert sweeps[1][2]["colded"] == 1 and sweeps[1][3] == ["cold", "cold"] and sweeps[1][4] is True


def test_gate_timeout_s_bounds_a_fault_ins_wait_for_a_busy_lane():
    """A fault-in outside a lane occupancy tries the owner lane's bulk gate
    for gate_timeout_s, then uploads without it: a lane held busy delays it
    by about the bound, in both packages."""
    waits = []
    for pkg, kw in ((redisson_tpu, {}), (redisson_tpu_torch, {"device": "cpu"})):
        c = pkg.create(**kw)
        try:
            eng = c._engine
            eng.enable_placement()
            mgr = eng.enable_residency(min_idle_s=0.0, gate_timeout_s=0.05)
            assert mgr.gate_timeout_s == 0.05
            bf = c.get_bloom_filter("rp:g")
            bf.try_init(1000, 0.01)
            bf.add_all([b"a"])
            assert mgr.demote("rp:g") and bf.contains(b"a")  # one cycle builds every program
            assert mgr.demote("rp:g")
            lane = eng.lanes.lane(eng.placement.device_for_name("rp:g"))
            held, release = threading.Event(), threading.Event()

            def hold():
                with lane._gate:
                    held.set()
                    release.wait(5.0)

            th = threading.Thread(target=hold)
            th.start()
            held.wait(5.0)
            s = time.monotonic()
            assert bf.contains(b"a")
            waits.append(time.monotonic() - s)
            release.set()
            th.join()
        finally:
            c.shutdown()
    for w in waits:
        assert 0.05 <= w < 0.2, waits
