"""The residency plane (core/residency.py, CLUSTER RESIDENCY, DEVEVACUATE,
the pressure rebalancer) against the reference on the CPU.

  * One command stream goes to a reference server and a port server, both
    on 8 positions and armed with the same budget: CONFIG SET and GET of
    both knobs, CLUSTER RESIDENCY and its TIER, DEMOTE [COLD], SWEEP and
    SHED, DEVEVACUATE, and sketch verbs between forced tier cycles.  The
    replies are the same bytes in RESP2 and RESP3, apart from the CTR row's
    two millisecond fields.
  * A spill file written by either package is the other's byte for byte
    and loads in both; a torn or forged one raises CheckpointCorruptError
    in both.
  * The same budget and touch order demote the same records on the CPU's 8
    positions, with equal ``residency_bytes_dev<N>_*`` rows.
  * A failed promotion (``scatter_host_arrays`` raising
    ``torch.cuda.OutOfMemoryError``) leaves the record WARM with its stash,
    and a retry serves the right reply.
  * A WARM->HOT promotion calls ``scatter_host_arrays`` once and makes one
    host-to-device copy; the disarmed getter allocates nothing; the
    ``RTPU_NO_TIER=1`` killswitch beats ``set_tier(True)`` and CONFIG SET;
    replies armed with tier cycles equal those of a disarmed server, on
    both wire codecs (the last two in subprocesses importing only the port).
  * The serializers (checkpoint, DUMP, COPY, the replication snapshot and
    the migration drain's cut) read a WARM or COLD record without
    promoting it.
Every input is built from a numpy seed."""
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.core import checkpoint as ref_ckpt
from redisson_tpu.core import residency as ref_res
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu_torch.core import checkpoint as port_ckpt
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import residency as port_res
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.parallel import mesh as TM
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.tools import wire_stream as W
from redisson_tpu_torch.utils.crc16 import calc_slot

TM.set_cpu_positions(8)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_planes():
    saved = [(m, m.tier_enabled(), m.DEVICE_BUDGET_BYTES) for m in (ref_res, port_res)]
    yield
    for mod, tier, budget in saved:
        mod.set_tier(tier)
        mod.set_device_budget_bytes(budget)


# -- the command stream against the reference ----------------------------------

BUDGET = 60_000
_CTR_MS = re.compile(rb"(\$3\r\nCTR\r\n(?::\d+\r\n){4})\$\d+\r\n[^\r]*\r\n\$\d+\r\n[^\r]*\r\n")


def _names():
    """Filters, counters and bit sets spread over the positions: two of
    each on the position that owns slot 0's range, so a budget there
    pressures it."""
    rng = np.random.default_rng(24)
    return ([f"rs:f{i}" for i in range(6)], [f"rs:h{i}" for i in range(4)],
            [f"rs:b{i}" for i in range(3)], rng)


def _i8(a) -> bytes:
    return np.ascontiguousarray(a, dtype="<i8").tobytes()


def _sketch_wave(filters, hlls, bits, keys):
    wave = [("BF.MEXISTS64", f, _i8(keys[f])) for f in filters]
    wave += [("BF.EXISTS", f, "absent-key") for f in filters]
    wave += [("PFCOUNT", h) for h in hlls]
    wave += [("GETBIT", b, int(i)) for b in bits for i in (3, 77, 4095)]
    wave += [("BITCOUNT", b) for b in bits]
    return wave


def _tiers(names):
    return [("CLUSTER", "RESIDENCY", "TIER", n) for n in names]


def _stream(proto: int):
    """[(kind, commands)]: kind "wave" sends the commands as one pipelined
    wave; "halt" does too, then stops each server's sweeper thread (only
    the stream's SWEEPs demote); "ordered" sends them one at a time, 10 ms
    apart, then waits past min_idle_s (0.25 s), so the touch clock's order,
    which picks a SWEEP's victims, is the stream's and not the dispatch
    pool's."""
    filters, hlls, bits, rng = _names()
    everything = filters + hlls + bits
    keys = {f: rng.integers(0, 1 << 40, 200) for f in filters}
    setup = [("BF.RESERVE", f, "0.01", str(2000 + 1000 * i)) for i, f in enumerate(filters)]
    setup += [("BF.MADD64", f, _i8(keys[f])) for f in filters]
    setup += [("PFADD", h, *[f"e{j}" for j in rng.integers(0, 10_000, 300)]) for h in hlls]
    setup += [("SETBIT", b, int(i), 1) for b in bits for i in (3, 4095, 9000)]
    sketch = _sketch_wave(filters, hlls, bits, keys)
    table = [("CLUSTER", "RESIDENCY")]

    def touch(names):
        # one read a record, in a seeded order
        order = [names[i] for i in rng.permutation(len(names))]
        return ("ordered", [("BF.EXISTS", n, "t") if n in filters else ("PFCOUNT", n) if n in hlls
                            else ("GETBIT", n, 3) for n in order])

    out = [("wave", [("HELLO", "3")])] if proto == 3 else []
    out += [
        ("halt", [("CONFIG", "GET", "device-budget-bytes"), ("CONFIG", "GET", "residency-enabled"),
                  ("CLUSTER", "RESIDENCY"), ("CLUSTER", "RESIDENCY", "TIER", "nope"),
                  ("CLUSTER", "RESIDENCY", "SWEEP"), ("CLUSTER", "RESIDENCY", "DEMOTE", "nope"),
                  ("CONFIG", "SET", "device-budget-bytes", "-1"),
                  ("CONFIG", "SET", "device-budget-bytes", str(BUDGET)),
                  ("CONFIG", "SET", "residency-enabled", "yes"),
                  ("CONFIG", "GET", "device-budget-bytes"), ("CONFIG", "GET", "residency-enabled")]),
        ("wave", setup),
        ("wave", table + _tiers(everything) + sketch),
        ("wave", [("CLUSTER", "RESIDENCY", "DEMOTE", filters[0]),
                  ("CLUSTER", "RESIDENCY", "DEMOTE", filters[1], "COLD"),
                  ("CLUSTER", "RESIDENCY", "DEMOTE", hlls[0], "COLD"),
                  ("CLUSTER", "RESIDENCY", "DEMOTE", bits[0]),
                  ("CLUSTER", "RESIDENCY", "DEMOTE", filters[0], "COLD"),
                  ("CLUSTER", "RESIDENCY", "DEMOTE", "nope")] + _tiers(everything) + table),
        ("wave", sketch + _tiers(everything) + table),
        ("wave", [("CLUSTER", "RESIDENCY", "DEMOTE", f) for f in filters[2:]] + sketch + table),
        touch(everything),
        ("wave", [("CLUSTER", "RESIDENCY", "SWEEP")] + _tiers(everything) + table),
        ("wave", sketch + _tiers(everything) + table),
        touch(everything),
        ("wave", [("CLUSTER", "RESIDENCY", "SWEEP"), ("CLUSTER", "RESIDENCY", "SHED", "0", "COUNT", "4"),
                  ("CLUSTER", "RESIDENCY", "SHED", "1", "COUNT"), ("CLUSTER", "RESIDENCY", "SHED")]
         + _tiers(everything) + table + sketch + table),
        ("wave", [("CLUSTER", "DEVEVACUATE", "0"), ("CLUSTER", "DEVEVACUATE", "1"),
                  ("CLUSTER", "DEVEVACUATE", "99")] + sketch + _tiers(everything) + table),
        ("wave", [("CLUSTER", "RESIDENCY", "BOGUS"), ("CLUSTER", "RESIDENCY", "TIER"),
                  ("CLUSTER", "RESIDENCY", "DEMOTE"), ("BF.ADD", filters[3], "late"),
                  ("BF.EXISTS", filters[3], "late"), ("DEL", filters[4])]),
        touch([n for n in everything if n != filters[4]]),
        ("wave", [("CLUSTER", "RESIDENCY", "SWEEP")] + _tiers(everything) + table),
        ("wave", [("CONFIG", "SET", "residency-enabled", "no"), ("CONFIG", "GET", "residency-enabled"),
                  ("CLUSTER", "RESIDENCY"), ("CLUSTER", "RESIDENCY", "TIER", filters[0])] + sketch
         + [("CONFIG", "SET", "device-budget-bytes", "0")]),
    ]
    return out


def _halt_sweeper(server) -> None:
    mgr = server.engine.residency
    mgr._stop.set()
    if mgr._sweeper is not None:
        mgr._sweeper.join(timeout=10)
        mgr._sweeper = None


class _Stepper:
    """One connection a server: send a wave, read its replies."""

    def __init__(self, st):
        import socket

        self.sock = socket.create_connection((st.server.host, st.server.port), timeout=60)
        self.parser = resp.RespParser(use_native=False)

    def wave(self, cmds) -> bytes:
        self.sock.sendall(resp.encode_commands(list(cmds)))
        raw, got = [], 0
        while got < len(cmds):
            data = self.sock.recv(1 << 20)
            assert data, "server closed the connection early"
            raw.append(data)
            got += len(self.parser.feed(data))
        return b"".join(raw)

    def close(self):
        self.sock.close()


@pytest.mark.parametrize("proto", [2, 3])
def test_residency_stream_reply_bytes_equal_the_reference(proto):
    servers = {"ref": RefServerThread(port=0, devices=8, workers=2),
               "port": ServerThread(port=0, device="cpu", devices=8, workers=2)}
    for st in servers.values():
        st.start()
    steppers = {k: _Stepper(st) for k, st in servers.items()}
    try:
        got = {k: [] for k in servers}
        sent = []
        for kind, cmds in _stream(proto):
            for wave in ([[c] for c in cmds] if kind == "ordered" else [cmds]):
                for k, st in servers.items():
                    got[k].append(_CTR_MS.sub(rb"\1$2\r\nMS\r\n$2\r\nMS\r\n", steppers[k].wave(wave)))
                    if kind == "halt":
                        _halt_sweeper(st.server)
                sent.append(wave)
                if kind == "ordered":
                    time.sleep(0.01)
            if kind == "ordered":
                time.sleep(0.3)
        for w, cmds in enumerate(sent):
            spans = {k: W.reply_spans(v[w]) for k, v in got.items()}
            assert len(spans["ref"]) == len(cmds)
            for i, (a, b) in enumerate(zip(spans["ref"], spans["port"])):
                assert a == b, (w, i, cmds[i][:3], a[:300], b[:300])
        # the stream did what it says: tiers cycled, SWEEP and SHED moved
        # something, every member probe was found
        text = b"".join(got["port"])
        assert b"warm" in text and b"cold" in text
        port = servers["port"].server
        assert port.engine.residency is None
        counts = port.engine.placement.slot_counts()
        assert counts[1] == 0 and counts[0] < 2048 and sum(counts) == 16384
    finally:
        for s in steppers.values():
            s.close()
        for st in servers.values():
            st.stop()


# -- spill files across the packages -------------------------------------------


def _spill_arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"bits": (rng.random(9_631) < 0.3).astype(np.uint8),
            "regs": rng.integers(0, 50, (7, 1024), dtype=np.uint8),
            "rows": rng.standard_normal((33, 70)).astype(np.float32),
            "flags": rng.random(13) < 0.5,
            "ids": rng.integers(-2**40, 2**40, 17, dtype=np.int64)}


def test_spill_files_load_across_the_packages_and_refuse_corruption(tmp_path):
    arrays = _spill_arrays(5)
    paths = {}
    for name, mod in (("ref", ref_res), ("port", port_res)):
        paths[name] = str(tmp_path / f"{name}.spill")
        assert mod.write_spill(paths[name], arrays) == os.path.getsize(paths[name])
    # the same bytes: either package's reader sees one file format
    assert open(paths["ref"], "rb").read() == open(paths["port"], "rb").read()
    for writer in ("ref", "port"):
        for mod in (ref_res, port_res):
            back = mod.load_spill(paths[writer])
            assert set(back) == set(arrays)
            for k, v in arrays.items():
                assert back[k].dtype == v.dtype and back[k].shape == v.shape
                np.testing.assert_array_equal(back[k], v)
    # a flipped byte (forged), a cut file (torn): each package refuses with
    # its own CheckpointCorruptError
    blob = bytearray(open(paths["port"], "rb").read())
    forged, torn = bytearray(blob), bytes(blob[: len(blob) // 3])
    forged[len(forged) // 2] ^= 0xFF
    for label, data in (("forged", bytes(forged)), ("torn", torn)):
        bad = str(tmp_path / f"{label}.spill")
        open(bad, "wb").write(data)
        with pytest.raises(ref_ckpt.CheckpointCorruptError):
            ref_res.load_spill(bad)
        with pytest.raises(port_ckpt.CheckpointCorruptError):
            port_res.load_spill(bad)
    # a checkpoint is a verified container but no spill: the port refuses it
    # (the reference's reader raises KeyError there)
    eng = redisson_tpu_torch.create(device="cpu")
    try:
        not_spill = str(tmp_path / "head.ckpt")
        port_ckpt.save(eng._engine, not_spill)
        with pytest.raises(port_ckpt.CheckpointCorruptError):
            port_res.load_spill(not_spill)
    finally:
        eng.shutdown()


# -- the same budget demotes the same records ----------------------------------


def _budget_run(pkg: str):
    """Filters of several sizes over 8 positions, touched in one order from
    a seed, a budget from the measured footprint, one sweep: (tiers,
    census rows without the fault-in times)."""
    rng = np.random.default_rng(31)
    if pkg == "ref":
        client, res = redisson_tpu.create(), ref_res
    else:
        client, res = redisson_tpu_torch.create(device="cpu"), port_res
    eng = client._engine
    eng.enable_placement(n_devices=8)
    mgr = eng.enable_residency(min_idle_s=0.0)
    res.set_tier(True)
    try:
        names = [f"bd:{i}" for i in range(24)]
        for i, name in enumerate(names):
            bf = client.get_bloom_filter(name)
            assert bf.try_init(int(rng.integers(500, 6000)), 0.01)
            bf.add_all([f"{name}:{j}" for j in range(20)])
        for i in rng.permutation(len(names)):
            assert client.get_bloom_filter(names[i]).contains(f"{names[i]}:3")
            time.sleep(0.002)  # distinct touch ages, in this order
        hot = mgr.hot_bytes_by_device()
        res.set_device_budget_bytes(int(np.median(list(hot.values()))))
        swept = mgr.sweep()
        tiers = {n: mgr.tier_of(n) for n in names}
        rows = {k: v for k, v in mgr.census().items() if "fault_in_ms" not in k}
        for name in names:  # every member still found after the cycle
            assert client.get_bloom_filter(name).contains(f"{name}:7")
        return hot, swept, tiers, rows
    finally:
        client.shutdown()


def test_same_budget_and_touch_order_demote_the_same_records():
    ref = _budget_run("ref")
    port = _budget_run("port")
    assert port[0] == ref[0] and len(port[0]) > 1  # footprint by position
    assert port[1] == ref[1] and port[1]["demoted"] > 0
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert any(k.endswith("_warm") for k in port[3])


# -- a failed promotion loses nothing ------------------------------------------


def test_failed_promotion_keeps_the_stash_and_a_retry_serves(monkeypatch):
    client = redisson_tpu_torch.create(device="cpu")
    eng = client._engine
    mgr = eng.enable_residency(min_idle_s=0.0)
    port_res.set_tier(True)
    try:
        bf = client.get_bloom_filter("fp:f")
        assert bf.try_init(20_000, 0.01)
        keys = [f"k{i}" for i in range(200)]
        bf.add_all(keys)
        want = np.asarray(bf.contains_each(keys + ["absent"]))
        for cold in (False, True):
            assert mgr.demote("fp:f", cold=cold, force=True)
            rec = eng.store.get_unguarded("fp:f")
            held = {k: v.copy() for k, v in port_res.record_host_arrays(rec).items()}

            def oom(*_a, **_k):
                raise torch.cuda.OutOfMemoryError("injected: no room for the promotion")

            monkeypatch.setattr(ioplane, "scatter_host_arrays", oom)
            with pytest.raises(torch.cuda.OutOfMemoryError):
                bf.contains_each(keys)
            assert rec.tier == (port_res.COLD if cold else port_res.WARM)
            assert not rec.arrays
            assert (rec.cold_path is not None and os.path.exists(rec.cold_path)) if cold \
                else rec.stash is not None
            for k, v in port_res.record_host_arrays(rec).items():
                np.testing.assert_array_equal(v, held[k])
            monkeypatch.undo()
            np.testing.assert_array_equal(np.asarray(bf.contains_each(keys + ["absent"])), want)
            assert rec.tier == port_res.HOT and rec.stash is None and rec.cold_path is None
            assert all(t.device.type == "cpu" for t in rec.arrays.values())
        assert mgr.promotions == 2
    finally:
        client.shutdown()


# -- one packed upload ---------------------------------------------------------


def test_promotion_is_one_scatter_and_one_host_to_device_copy(monkeypatch):
    client = redisson_tpu_torch.create(device="cpu")
    eng = client._engine
    mgr = eng.enable_residency(min_idle_s=0.0)
    port_res.set_tier(True)
    try:
        bf = client.get_bloom_filter("h2d:f")
        assert bf.try_init(50_000, 0.01)
        bf.add_all([f"m{i}" for i in range(200)])
        scatters, copies = [], []
        orig_scatter = ioplane.scatter_host_arrays
        monkeypatch.setattr(ioplane, "scatter_host_arrays", lambda a, d, pool=None: (
            scatters.append(sorted(a)), orig_scatter(a, d, pool=pool))[1])
        orig_to = torch.Tensor.to

        def counted_to(self, *a, **k):
            out = orig_to(self, *a, **k)
            if self.device.type == "cpu" and self.numel() and not self.is_floating_point():
                copies.append(self.numel())
            return out

        monkeypatch.setattr(torch.Tensor, "to", counted_to)
        assert bf.contains("m5") and bf.contains("m6")
        copies.clear()
        assert bf.contains("m7")
        base = len(copies)
        copies.clear()
        assert mgr.demote("h2d:f", force=True)
        assert not scatters and not copies  # a demotion copies to the host only
        assert bf.contains("m8")  # the first touch: the fault-in
        assert scatters == [["bits"]]
        assert len(copies) == base + 1, (base, copies)
        rec = eng.store.get_unguarded("h2d:f")
        assert max(copies) >= rec.arrays["bits"].numel()  # the merged stream, once
        copies.clear()
        assert bf.contains("m9")
        assert len(scatters) == 1 and len(copies) == base
    finally:
        monkeypatch.undo()
        client.shutdown()


# -- the disarmed guard --------------------------------------------------------


def _guard_lines(mod):
    lines = []
    with open(mod.__file__) as fh:
        for no, line in enumerate(fh, 1):
            if "plane is not None" in line or "plane.on_" in line:
                lines.append(no)
    return mod.__file__, sorted(set(lines))


def test_disarmed_store_getter_allocates_nothing():
    import tracemalloc

    from redisson_tpu_torch.core import store as store_mod
    from redisson_tpu_torch.services import vector as vec_mod

    for mod in (store_mod, vec_mod):
        assert _guard_lines(mod)[1], f"no tier-plane guard lines in {mod.__name__}"
    prev = port_res.set_tier(False)
    client = redisson_tpu_torch.create(device="cpu")
    try:
        eng = client._engine
        bf = client.get_bloom_filter("perf:res")
        assert bf.try_init(10_000, 0.01)
        bf.add("warm")
        eng.store.get("perf:res")
        path, guards = _guard_lines(store_mod)
        tracemalloc.start(1)
        try:
            for _ in range(200):
                eng.store.get("perf:res")
                eng.store.get_or_create("perf:res", "bloom", lambda: None)
            snap = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        offenders = [(tb.lineno, stat.size) for stat in snap.statistics("lineno")
                     for tb in [stat.traceback[0]]
                     if tb.filename == path and tb.lineno in guards and stat.size > 0]
        assert not offenders, offenders
    finally:
        client.shutdown()
        port_res.set_tier(prev)


# -- subprocesses that import only the port ------------------------------------

_KILLSWITCH = r"""
import os, sys
from redisson_tpu_torch.core import residency as _res
from redisson_tpu_torch.server import ServerThread
assert _res.tier_enabled() is False, "must start disarmed"
if os.environ.get("KS_PIN") == "1":
    _res.pin_disarmed()  # what the server's --no-tier does
assert _res.set_tier(True) is False
want = os.environ.get("RTPU_NO_TIER") != "1" and os.environ.get("KS_PIN") != "1"
assert _res.tier_enabled() is want
_res.set_tier(False)
with ServerThread(port=0, device="cpu", workers=2) as st, st.client() as c:
    assert c.execute("CONFIG", "SET", "residency-enabled", "yes") == b"OK"
    assert (st.server.engine.residency is not None) is want
    assert _res.tier_enabled() is want
    assert c.execute("CONFIG", "GET", "residency-enabled") == [b"residency-enabled", b"1" if want else b"0"]
    assert c.execute("CLUSTER", "RESIDENCY")[0] == (1 if want else 0)
    c.execute("CONFIG", "SET", "residency-enabled", "no")
assert not any(m == "jax" or m.startswith(("jax.", "redisson_tpu.")) for m in sys.modules)
print("ok")
"""

_AB_SCRIPT = r"""
import hashlib, os, socket
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.server import ServerThread

ARMED = os.environ.get("AB_ARMED") == "1"
with ServerThread(port=0, device="cpu", workers=2) as st:
    srv = st.server
    if ARMED:
        srv.enable_residency(min_idle_s=0.0)
    s = socket.create_connection((srv.host, srv.port), timeout=30)
    parser = resp.RespParser(use_native=False)
    h = hashlib.sha256()

    def run(cmds):
        s.sendall(b"".join(resp.encode_command_python(*c) for c in cmds))
        got = 0
        while got < len(cmds):
            data = s.recv(1 << 16)
            assert data, "server closed early"
            h.update(data)
            got += len(parser.feed(data))

    def cycle():
        if ARMED:
            mgr = srv.engine.residency
            assert mgr.demote("ab:f", force=True)
            assert mgr.demote("ab:f", cold=True, force=True)
            assert mgr.demote("ab:h", force=True)

    run([("BF.RESERVE", "ab:f", "0.01", "20000")]
        + [("BF.MADD", "ab:f", *[f"k{i}" for i in range(j, j + 50)]) for j in range(0, 500, 50)]
        + [("SET", "ab:b", "v1"), ("GET", "ab:b"), ("PFADD", "ab:h", *[f"p{i}" for i in range(300)])])
    cycle()
    run([("BF.MEXISTS", "ab:f", *[f"k{i}" for i in range(0, 500, 7)]), ("PFCOUNT", "ab:h")])
    cycle()
    run([("BF.EXISTS", "ab:f", "k3"), ("BF.EXISTS", "ab:f", "nope"), ("BF.INFO", "ab:f"),
         ("GET", "ab:b"), ("PFCOUNT", "ab:h"),
         ("BF.MEXISTS", "ab:f", *[f"k{i}" for i in range(100, 200, 3)])])
    s.close()
print(h.hexdigest())
"""


def _port_only_env(**extra):
    env = dict(os.environ)
    env.pop("RTPU_NO_TIER", None)
    env.update(extra)
    return env


def test_killswitch_beats_set_tier_and_config_set():
    for extra in ({}, {"RTPU_NO_TIER": "1"}, {"KS_PIN": "1"}):
        out = subprocess.run([sys.executable, "-c", _KILLSWITCH], capture_output=True, text=True,
                             timeout=120, cwd=REPO, env=_port_only_env(**extra))
        assert out.returncode == 0, (extra, out.stdout, out.stderr)
        assert out.stdout.strip().endswith("ok")


def test_replies_armed_with_tier_cycles_equal_disarmed_on_both_wire_codecs():
    digests = {}
    for wire, wire_env in (("native", {}), ("python", {"RTPU_NO_NATIVE": "1"})):
        for mode, mode_env in (("armed", {"AB_ARMED": "1"}),
                               ("disarmed", {"AB_ARMED": "0", "RTPU_NO_TIER": "1"})):
            out = subprocess.run([sys.executable, "-c", _AB_SCRIPT], capture_output=True, text=True,
                                 timeout=120, cwd=REPO, env=_port_only_env(**wire_env, **mode_env))
            assert out.returncode == 0, (wire, mode, out.stdout, out.stderr)
            digests[(wire, mode)] = out.stdout.strip().splitlines()[-1]
    assert len(set(digests.values())) == 1, digests
    assert len(next(iter(digests.values()))) == 64


# -- the serializers read demoted records without promoting them ----------------


def test_serializers_read_warm_and_cold_records_without_promotion(tmp_path):
    from redisson_tpu_torch.server import replication

    client = redisson_tpu_torch.create(device="cpu")
    eng = client._engine
    mgr = eng.enable_residency(min_idle_s=0.0)
    port_res.set_tier(True)
    try:
        rng = np.random.default_rng(44)
        bf = client.get_bloom_filter("sz:f")
        assert bf.try_init(5_000, 0.01)
        bf.add_all([int(x) for x in rng.integers(0, 1 << 40, 100)])
        hll = client.get_hyper_log_log("sz:h")
        hll.add_all([f"x{i}" for i in range(500)])
        names = ["sz:f", "sz:h"]
        hot = {n: port_res.record_host_arrays(eng.store.get_unguarded(n)) for n in names}
        hot_dump = {n: port_ckpt.dump_record(eng, n) for n in names}
        assert mgr.demote("sz:f", force=True)
        assert mgr.demote("sz:h", cold=True, force=True)
        tiers = {n: mgr.tier_of(n) for n in names}
        assert tiers == {"sz:f": port_res.WARM, "sz:h": port_res.COLD}
        # checkpoint save, DUMP, the replication snapshot and the drain's cut
        assert port_ckpt.save(eng, str(tmp_path / "c.ckpt")) == 2
        for n in names:
            assert port_ckpt.dump_record(eng, n) == hot_dump[n]
        snap = replication.snapshot_records(eng, names)
        _blob, shipped = replication.serialize_records(eng, names, include_live=False)
        assert [s[0] for s in shipped] == names
        assert {n: mgr.tier_of(n) for n in names} == tiers and mgr.promotions == 0
        for n in names:
            for k, v in hot[n].items():
                np.testing.assert_array_equal(snap[n]["arrays"][k], v)
        payload = port_ckpt.read_verified(str(tmp_path / "c.ckpt"))
        for item in payload["records"]:
            for k, v in hot[item["name"]].items():
                np.testing.assert_array_equal(item["arrays"][k], v)
        # COPY lands the clone HOT and leaves the source demoted
        assert port_ckpt.clone_record(eng, "sz:f", "sz:f2")
        assert mgr.tier_of("sz:f") == port_res.WARM and mgr.tier_of("sz:f2") == port_res.HOT
        clone = eng.store.get_unguarded("sz:f2")
        np.testing.assert_array_equal(clone.arrays["bits"].numpy(), hot["sz:f"]["bits"])
        client.get_bloom_filter("sz:f2").add("only-in-the-clone")
        np.testing.assert_array_equal(eng.store.get_unguarded("sz:f").stash["bits"], hot["sz:f"]["bits"])
        # a restore of the save in the reference reads the same records
        ref_client = redisson_tpu.create()
        try:
            assert ref_ckpt.load(ref_client._engine, str(tmp_path / "c.ckpt")) == 2
            for n in names:
                rec = ref_client._engine.store.get_unguarded(n)
                for k, v in hot[n].items():
                    np.testing.assert_array_equal(np.asarray(rec.arrays[k]), v)
        finally:
            ref_client.shutdown()
    finally:
        client.shutdown()


# -- vector banks: growth admission and the promoted planes ----------------------


def _knn(svc, idx, q):
    dev, finish = svc.knn(idx, "emb", q, 5)
    return (finish(None) if dev is None else finish(tuple(np.asarray(v) for v in dev)))[0]


def test_bank_growth_after_a_promotion_replaces_every_merged_plane():
    """A promoted bank's planes are views of one merged stream; growth
    replaces all of them, so no tensor of the record keeps the old stream
    alive (the ledger counts what the device holds)."""
    from redisson_tpu_torch.core.engine import Engine
    from redisson_tpu_torch.services.search import SearchService
    from redisson_tpu_torch.services.vector import DEFAULT_BLOCK, bank_record_name

    eng = Engine(device="cpu")
    mgr = eng.enable_residency(min_idle_s=0.0)
    port_res.set_tier(True)
    try:
        svc = SearchService(eng)
        rng = np.random.default_rng(9)
        for dtype in ("FLOAT32", "INT8"):
            idx = f"vg{dtype}"
            svc.create_index(idx, {"emb": "VECTOR"}, vector={"emb": {"dim": 16, "dtype": dtype}})
            for i in range(DEFAULT_BLOCK // 2):
                svc.add_document(idx, f"{idx}:d{i}", {"emb": rng.standard_normal(16).astype(np.float32)})
            q = rng.standard_normal(16).astype(np.float32)
            before = _knn(svc, idx, q)
            bank = bank_record_name(idx, "emb")
            assert mgr.demote(bank, force=True)
            assert _knn(svc, idx, q) == before
            rec = eng.store.get_unguarded(bank)
            merged = {t.untyped_storage().data_ptr() for t in rec.arrays.values()}
            assert len(merged) == 1  # the promotion's one stream
            for i in range(DEFAULT_BLOCK):
                svc.add_document(idx, f"{idx}:g{i}", {"emb": rng.standard_normal(16).astype(np.float32)})
            _knn(svc, idx, q)
            ptrs = [t.untyped_storage().data_ptr() for t in rec.arrays.values()]
            assert not merged & set(ptrs), "a plane still shares the promoted stream"
            assert sum(int(t.nbytes) for t in rec.arrays.values()) == \
                sum(t.untyped_storage().nbytes() for t in rec.arrays.values())
    finally:
        eng.shutdown()


def test_bank_growth_after_a_promotion_frees_the_index_views():
    """An IVF bank's record holds its bank planes and its index's centroids
    and cells, all cut from one stream by a promotion.  Growth replaces the
    bank planes only: the kept index views get storages of their own, so no
    tensor of the record holds the old stream (the ledger counts what the
    device holds)."""
    from redisson_tpu_torch.core.engine import Engine
    from redisson_tpu_torch.services.search import SearchService
    from redisson_tpu_torch.services.vector import DEFAULT_BLOCK, bank_record_name

    eng = Engine(device="cpu")
    mgr = eng.enable_residency(min_idle_s=0.0)
    port_res.set_tier(True)
    try:
        svc = SearchService(eng)
        rng = np.random.default_rng(31)
        svc.create_index("vi", {"emb": "VECTOR"}, vector={"emb": {
            "dim": 16, "algo": "IVF", "nlist": 4, "nprobe": 2, "train_min": 64}})
        for i in range(DEFAULT_BLOCK - 6):
            svc.add_document("vi", f"d{i}", {"emb": rng.standard_normal(16).astype(np.float32)})
        q = rng.standard_normal(16).astype(np.float32)
        before = _knn(svc, "vi", q)
        bank = bank_record_name("vi", "emb")
        rec = eng.store.get_unguarded(bank)
        assert {"centroids", "cells"} <= set(rec.arrays)
        assert mgr.demote(bank, force=True)
        assert _knn(svc, "vi", q) == before
        merged = {t.untyped_storage().data_ptr() for t in rec.arrays.values()}
        assert len(merged) == 1  # the promotion's one stream
        index = {k: rec.arrays[k].clone() for k in ("centroids", "cells")}
        bank_obj = svc._idx("vi").vectors.banks["emb"]
        for i in range(12):  # past the capacity, short of a retrain
            svc.add_document("vi", f"g{i}", {"emb": rng.standard_normal(16).astype(np.float32)})
        bank_obj.flush_pending()
        assert rec.arrays["bank"].shape[0] > DEFAULT_BLOCK  # it grew
        ptrs = [t.untyped_storage().data_ptr() for t in rec.arrays.values()]
        assert not merged & set(ptrs), "a plane still holds the promoted stream"
        for k, v in index.items():
            torch.testing.assert_close(rec.arrays[k], v, rtol=0, atol=0)
        assert sum(int(t.nbytes) for t in rec.arrays.values()) == \
            sum(t.untyped_storage().nbytes() for t in rec.arrays.values())
    finally:
        eng.shutdown()


def test_replace_planes_copies_only_views_of_a_dropped_stream():
    from redisson_tpu_torch.core.store import StateRecord

    stream = torch.arange(48, dtype=torch.uint8)
    rec = StateRecord(kind="x", meta={}, arrays={
        "a": stream[0:16], "b": stream[16:32], "c": stream[32:48]})
    kept = rec.arrays["b"]
    # an in-place write hands back the same tensors: nothing is copied
    port_res.replace_planes(rec, {"a": rec.arrays["a"], "c": rec.arrays["c"]})
    assert rec.arrays["b"] is kept
    # the stream is still referenced by a new plane: nothing is copied
    port_res.replace_planes(rec, {"a": stream[0:8]})
    assert rec.arrays["b"] is kept
    port_res.replace_planes(rec, {"a": torch.zeros(16, dtype=torch.uint8),
                                  "c": torch.ones(16, dtype=torch.uint8)})
    assert rec.arrays["b"] is not kept
    assert rec.arrays["b"].untyped_storage().data_ptr() != stream.untyped_storage().data_ptr()
    torch.testing.assert_close(rec.arrays["b"], torch.arange(16, 32, dtype=torch.uint8), rtol=0, atol=0)


# -- switching the plane off ------------------------------------------------------


def _disable_fixture(c, srv, n_filters):
    names = [f"ds:f{i}" for i in range(n_filters)]
    for n in names:
        assert c.execute("BF.RESERVE", n, "0.01", "20000") == b"OK"
        c.execute("BF.MADD", n, *[f"{n}:{j}" for j in range(40)])
    probe = [("BF.MEXISTS", n, f"{n}:0", f"{n}:39", "absent") for n in names]
    want = c.execute_many(probe)
    return names, probe, want


def test_switching_residency_off_under_a_live_sweeper_leaves_every_record_hot():
    """CONFIG SET residency-enabled no with a budget and the sweeper
    running every few milliseconds: the sweeper stops before the first
    promotion, so none demotes a record behind the detach, and every
    record reads back HOT with its replies."""
    with ServerThread(port=0, device="cpu", workers=2) as st, st.client() as c:
        srv = st.server
        names, probe, want = _disable_fixture(c, srv, 12)
        for _round in range(3):
            srv.enable_residency(min_idle_s=0.0, sweep_interval=0.002)
            c.execute("CONFIG", "SET", "device-budget-bytes", "1")
            mgr = srv.engine.residency
            deadline = time.monotonic() + 10
            while mgr.demotions_warm < len(names) and time.monotonic() < deadline:
                time.sleep(0.005)
            assert mgr.demotions_warm >= len(names)
            assert c.execute("CONFIG", "SET", "residency-enabled", "no") == b"OK"
            assert srv.engine.residency is None and not port_res.tier_enabled()
            assert mgr._sweeper is None
            tiers = {n: srv.engine.store.get_unguarded(n).tier for n in names}
            assert set(tiers.values()) == {port_res.HOT}, tiers
            assert c.execute_many(probe) == want
            c.execute("CONFIG", "SET", "device-budget-bytes", "0")


def test_switching_residency_off_with_a_failing_promotion_keeps_the_plane(monkeypatch):
    """A promotion that raises while the plane is switched off leaves it
    attached, armed and sweeping: the error is the reply, nothing is
    stranded, and a second switch-off once memory is back succeeds."""
    with ServerThread(port=0, device="cpu", workers=2) as st, st.client() as c:
        srv = st.server
        names, probe, want = _disable_fixture(c, srv, 4)
        srv.enable_residency(min_idle_s=0.0, sweep_interval=0.05)
        mgr = srv.engine.residency
        for n in names:
            assert mgr.demote(n, force=True)

        def oom(*_a, **_k):
            raise torch.cuda.OutOfMemoryError("injected: no room for the promotion")

        monkeypatch.setattr(ioplane, "scatter_host_arrays", oom)
        reply = c.execute("CONFIG", "SET", "residency-enabled", "no")
        assert "no room for the promotion" in str(reply)
        assert srv.engine.residency is mgr and port_res.tier_enabled()
        assert mgr._sweeper is not None and not mgr._closing
        monkeypatch.undo()
        assert c.execute_many(probe) == want  # served by fault-in
        assert mgr.demote(names[0], force=True)
        assert c.execute("CONFIG", "SET", "residency-enabled", "no") == b"OK"
        assert srv.engine.residency is None
        assert all(srv.engine.store.get_unguarded(n).tier == port_res.HOT for n in names)
        assert c.execute_many(probe) == want


def test_rebalancer_step_on_a_port_server_sweeps_then_sheds(tmp_path):
    """The port's ResidencyRebalancer against a port server on 8
    positions: a pressured position gets SWEEP, then SHED, and the sketch
    replies stay those from before."""
    from contextlib import closing

    from redisson_tpu_torch.cluster import ResidencyRebalancer
    from redisson_tpu_torch.net.client import Connection

    with ServerThread(port=0, device="cpu", devices=8, workers=2) as st, st.client() as c:
        srv = st.server
        # every record stays touched too recently to demote: only a shed
        # relieves the pressure
        srv.enable_residency(min_idle_s=600.0)
        p = srv.engine.placement
        names = [f"rb:{i}" for i in range(64) if p.device_id_for_name(f"rb:{i}") == 0][:6]
        for n in names:
            assert c.execute("BF.RESERVE", n, "0.01", "5000") == b"OK"
            c.execute("BF.MADD", n, "a", "b", "c")
        probe = [("BF.MEXISTS", n, "a", "b", "zz") for n in names]
        want = c.execute_many(probe)
        c.execute("CONFIG", "SET", "device-budget-bytes", "1")
        # an unarmed node is left alone; a dead one contributes nothing
        rb = ResidencyRebalancer({
            "n": lambda: closing(Connection(srv.host, srv.port, timeout=10.0)),
            "dead": lambda: closing(Connection("127.0.0.1", 1, timeout=1.0)),
        }, shed_after=2, shed_count=4, journal_dir=str(tmp_path))
        actions = [rb.step(), rb.step()]
        assert actions[0] == [("n", "sweep", 0)]
        assert actions[1] == [("n", "shed", 0)]
        assert p.slot_counts()[0] == 2048 - 4
        assert c.execute_many(probe) == want
        c.execute("CONFIG", "SET", "device-budget-bytes", "0")
        c.execute("CONFIG", "SET", "residency-enabled", "no")


def test_fault_in_under_a_lane_occupancy_takes_no_gate(monkeypatch):
    """A promotion fired from inside either lane occupancy (bulk or
    interactive) takes no gate; from outside, it tries the bulk gate and
    proceeds without it when the gate is held."""
    from redisson_tpu_torch.core.engine import Engine

    monkeypatch.setattr(port_res, "GATE_TIMEOUT_S", 0.05)
    eng = Engine(device="cpu")
    eng.enable_placement(n_devices=2)
    mgr = eng.enable_residency(min_idle_s=0.0)
    port_res.set_tier(True)
    prev_preempt = ioplane.set_preempt(True)
    try:
        from redisson_tpu_torch.client.objects.bloom import BloomFilter

        bf = BloomFilter(eng, "gate:f")
        assert bf.try_init(1000, 0.01)
        bf.add("x")
        lane = eng.lanes.lane(eng.device_for_name("gate:f"))
        for qos_class in ("bulk", "interactive"):
            assert mgr.demote("gate:f", force=True)
            with lane.occupy(1, qos_class=qos_class):
                done = []
                t = threading.Thread(target=lambda: done.append(bf.contains("x")))
                t.start()
                t.join(timeout=0.01)
                # another thread blocked on the held gate: it proceeds
                # gateless after GATE_TIMEOUT_S
                t.join(timeout=5)
                assert done == [True]
                assert mgr.demote("gate:f", force=True)
                assert bf.contains("x")  # this thread holds a gate: no wait
        assert mgr.promotions == 4
    finally:
        ioplane.set_preempt(prev_preempt)
        eng.shutdown()


def test_cluster_residency_shed_and_devevacuate_need_placement():
    with ServerThread(port=0, device="cpu", workers=2) as st, st.client() as c:
        for cmd in (("CLUSTER", "RESIDENCY", "SHED", "0"), ("CLUSTER", "DEVEVACUATE", "0")):
            err = c.execute(*cmd)
            assert "placement is not enabled" in str(err)
        err = c.execute("CLUSTER", "DEVPROBE", "0")
        assert "M11 part 6" in str(err)
