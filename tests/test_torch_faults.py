"""The port's fault plane and device-fault domain against the reference.

  * ``chaos/faults.py``: the same ``FaultSchedule(seed)``, with rules of
    every kind, injects at the same event indices in both packages;
  * the CUDA fault taxonomy (``ioplane.is_retryable_device_fault``);
  * the armed lane watchdog: a readback whose event never passes trips
    within the bound plus 0.5 s and the fault lands on the lane, on a lone
    future, the grouped fetch and ``force_all``; an injected hung transfer
    trips it too;
  * the disarmed guard lines of ``net/client.py`` and ``core/ioplane.py``
    allocate nothing (tracemalloc);
  * a command stream on a reference ``ServerThread(devices="all")`` (JAX on
    the CPU, 8 host devices) and on the port's (8 CPU positions), with the
    same schedules installed, gives byte-identical replies: the
    ``-TRYAGAIN`` of a failed launch, the quarantine reply, the FAULTS rows
    of CLUSTER DEVICES, DEVPROBE, DEVEVACUATE, the ``-OOM`` of a bank's
    growth and its retry, and the lane knobs under CONFIG GET and SET;
  * a real ``torch.OutOfMemoryError`` at a bank's growth replies the same
    ``-OOM`` as the reference's injected one, and the port's fault stream
    digests the same with the native wire codec and without it;
  * the census reads the same metrics in both packages.
"""
import os
import socket
import subprocess
import sys
import threading
import time
import tracemalloc
from collections import deque

import numpy as np
import pytest
import torch

from redisson_tpu.chaos import census as ref_census
from redisson_tpu.chaos import faults as ref_faults
from redisson_tpu.core import ioplane as ref_ioplane
from redisson_tpu.net import client as ref_net
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu_torch.chaos import census as port_census
from redisson_tpu_torch.chaos import faults as port_faults
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core.engine import Engine
from redisson_tpu_torch.net import client as port_net
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.parallel import mesh as TM
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.server import server as port_server
from redisson_tpu_torch.services import vector as port_vector
from redisson_tpu_torch.tools import wire_stream as W
from redisson_tpu_torch.utils.crc16 import calc_slot

TM.set_cpu_positions(8)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clear_lanes(*modules):
    """Un-quarantine every lane of every live lane set: the fault ledger is
    process-global, so a test must never leak a quarantined position."""
    for mod in modules:
        for ls in list(mod._LANE_SETS):
            for lane in ls._lanes.values():
                lane.unquarantine()


@pytest.fixture(autouse=True)
def _no_leaked_plane():
    assert port_net._fault_plane is None and ref_net._fault_plane is None
    knobs = (ioplane.lane_watchdog_ms(), ioplane.quarantine_after(),
             ref_ioplane.lane_watchdog_ms(), ref_ioplane.quarantine_after())
    yield
    port_net.install_fault_plane(None)
    ref_net.install_fault_plane(None)
    ioplane.set_lane_watchdog_ms(knobs[0])
    ioplane.set_quarantine_after(knobs[1])
    ref_ioplane.set_lane_watchdog_ms(knobs[2])
    ref_ioplane.set_quarantine_after(knobs[3])
    _clear_lanes(ioplane, ref_ioplane)


# -- the schedule: same seed, same faulted events ------------------------------


class _Conn:
    """What the transport hooks read of a Connection."""

    def __init__(self, port: int):
        self.host, self.port, self.closed = "h", port, False

    def close(self):
        self.closed = True


PORTS = (7001, 7002, 7003)


def _schedule(mod, seed: int):
    s = mod.FaultSchedule(seed)
    for i, kind in enumerate(mod.KINDS):
        stream = mod._STREAM[kind]
        if stream.startswith("storage"):
            port = None
        elif stream.startswith("device"):
            port = (None, 1, 5)[i % 3]
        else:
            port = (None,) + PORTS
            port = port[i % 4]
        s.add_random(kind, port=port, n=3, window=8, delay_s=0.0005)
    s.add("torn_write", after=35, count=2, torn_at=5)
    s.add("torn_write", after=40, torn_frac=0.25)
    s.add("device_kernel", port=3, after=4, count=3)
    s.add_dcn_partition((7002, 7003), direction="out", after=6, count=2)
    s.add_dcn_partition((7001, 7003), direction="in", after=3, count=3)
    return s


def _events(seed: int, n: int = 600):
    rng = np.random.default_rng(seed)
    kinds = ("connect", "send", "recv", "write", "fsync", "dispatch", "alloc", "readback")
    return [(kinds[int(k)], int(p)) for k, p in zip(rng.integers(0, len(kinds), n),
                                                   rng.integers(0, 8, n))]


def _drive(plane, events) -> list:
    out = []
    for kind, p in events:
        conn = _Conn(PORTS[p % 3])
        try:
            if kind == "connect":
                plane.on_connect("h", conn.port)
                got = "ok"
            elif kind == "send":
                got = plane.on_send(conn)
            elif kind == "recv":
                got = plane.on_recv(conn, b"abcdefgh")
            elif kind == "write":
                got = plane.on_storage_write("f", b"0123456789")
            elif kind == "fsync":
                plane.on_storage_fsync("f")
                got = "ok"
            elif kind == "dispatch":
                plane.on_device_dispatch(p)
                got = "ok"
            elif kind == "alloc":
                plane.on_device_alloc(p, 4096)
                got = "ok"
            else:
                got = plane.on_device_readback(p)
        except Exception as e:  # noqa: BLE001 — the fault is the outcome
            got = ("raised", "errno" if isinstance(e, OSError) else "runtime")
        out.append((kind, p, got, conn.closed))
    return out


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_one_seed_faults_the_same_events_in_both_packages(seed):
    ref_s, port_s = _schedule(ref_faults, seed), _schedule(port_faults, seed)
    assert [(f.kind, f.port, f.ports, f.after, f.count) for f in ref_s.faults] == \
        [(f.kind, f.port, f.ports, f.after, f.count) for f in port_s.faults]
    assert port_faults.KINDS == ref_faults.KINDS
    ref_p, port_p = ref_s.plane(), port_s.plane()
    events = _events(seed)
    got = {"ref": _drive(ref_p, events), "port": _drive(port_p, events)}
    assert got["port"] == got["ref"]
    assert port_p.injected == ref_p.injected and sum(port_p.injected.values()) > 10
    assert set(port_p.injected) == set(ref_faults.KINDS)
    assert [f.hits for f in port_s.faults] == [f.hits for f in ref_s.faults]
    for stream in ("connect", "send", "recv", "storage_write", "device_dispatch"):
        assert port_p.events(stream) == ref_p.events(stream)


def test_device_faults_raise_cudas_shapes():
    s = port_faults.FaultSchedule(0)
    s.add("device_kernel", port=2)
    s.add("device_oom", port=2)
    s.add("device_hang", port=2, delay_s=1.5)
    p = s.plane()
    with pytest.raises(RuntimeError) as launch:
        p.on_device_dispatch(2)
    assert launch.type is getattr(torch, "AcceleratorError", RuntimeError)
    assert str(launch.value).startswith("CUDA error: unspecified launch failure")
    with pytest.raises(torch.OutOfMemoryError, match="CUDA out of memory. Tried to allocate 64 bytes"):
        p.on_device_alloc(2, 64)
    assert p.on_device_readback(2) == 1.5 and p.on_device_readback(2) == 0.0
    assert ioplane.is_retryable_device_fault(launch.value)
    assert p.injected == {"device_kernel": 1, "device_oom": 1, "device_hang": 1}


# -- the CUDA fault taxonomy ----------------------------------------------------


@pytest.mark.parametrize("exc,retryable", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    (RuntimeError("CUDA out of memory. Tried to allocate 8 bytes"), False),
    (RuntimeError("CUDA error: out of memory"), False),
    (getattr(torch, "AcceleratorError", RuntimeError)("CUDA error: an illegal memory access was encountered"), True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (ioplane.LaneWatchdogTimeout("readback exceeded lane-watchdog bound"), True),
    (RuntimeError("INTERNAL: Failed to launch kernel"), True),
    (RuntimeError("UNAVAILABLE: device preempted"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), False),
    (RuntimeError("shape mismatch"), False),
    (ValueError("CUDA error: not a runtime error"), False),
])
def test_the_cuda_fault_taxonomy(exc, retryable):
    assert ioplane.is_retryable_device_fault(exc) is retryable
    reply = port_server._error_reply(exc)
    if retryable:
        assert reply == b"-TRYAGAIN device fault during dispatch; retry\r\n"
    else:
        assert reply.startswith(b"-ERR internal: ")


# -- the armed lane watchdog ----------------------------------------------------


class _NeverEvent:
    """A CUDA event stand-in whose work never finishes."""

    def query(self) -> bool:
        return False

    def synchronize(self) -> None:  # the watchdog must never call this
        raise AssertionError("the armed watchdog synchronized")


@pytest.fixture()
def placed():
    eng = Engine(device="cpu")
    eng.enable_placement()
    yield eng
    eng.shutdown()


def test_armed_watchdog_trips_a_future_whose_event_never_passes(placed):
    lane = placed.lanes.lane(placed.placement.devices[3])
    ioplane.set_lane_watchdog_ms(50)
    fut = ioplane.ReadbackFuture((torch.arange(4),), position=3)
    fut._event = _NeverEvent()
    t0 = time.monotonic()
    with pytest.raises(ioplane.LaneWatchdogTimeout, match="lane-watchdog bound \\(50ms\\) on device\\(s\\) 3"):
        fut.result()
    assert time.monotonic() - t0 < 0.05 + 0.5
    assert lane.total_faults == 1 and lane.last_fault_kind == "watchdog_timeout"
    # the error stays on the future; no copy was made
    with pytest.raises(ioplane.LaneWatchdogTimeout):
        fut.result()
    # disarmed, the same stand-in waits as before (the CPU copy needs none)
    ioplane.set_lane_watchdog_ms(0)
    ok = ioplane.ReadbackFuture((torch.arange(4),), position=3)
    ok._event = _NeverEvent()
    assert ok.result().tolist() == [0, 1, 2, 3]
    assert lane.consec_faults == 0 and lane.total_faults == 1  # a clean readback ends the streak


def test_a_future_made_under_a_lane_belongs_to_its_position(placed):
    lane = placed.lanes.lane(placed.placement.devices[5])
    with lane.occupy(1):
        assert ioplane.current_position() == 5
        fut = ioplane.ReadbackFuture((torch.ones(2),))
    assert ioplane.current_position() is None
    assert fut._positions == (5,)
    assert ioplane.ReadbackFuture((torch.ones(2),))._positions == (0,)


def test_armed_watchdog_bounds_the_grouped_fetch_and_force_all(placed, monkeypatch):
    lanes = [placed.lanes.lane(placed.placement.devices[i]) for i in (1, 6)]
    ioplane.set_lane_watchdog_ms(50)
    monkeypatch.setattr(ioplane, "record_event", lambda device: _NeverEvent())
    groups = [(torch.arange(3),), (torch.ones(2, dtype=torch.int32),)]
    t0 = time.monotonic()
    with pytest.raises(ioplane.LaneWatchdogTimeout, match="device\\(s\\) 1, 6"):
        ioplane.gather_device_results(groups, [1, 6])
    assert time.monotonic() - t0 < 0.05 + 0.5
    # one stream: every position waiting behind it timed out
    assert [(ln.total_faults, ln.last_fault_kind) for ln in lanes] == [(1, "watchdog_timeout")] * 2
    futs = [ioplane.ReadbackFuture((torch.arange(2),), position=1) for _ in range(2)]
    t0 = time.monotonic()
    ioplane.force_all(futs)
    assert time.monotonic() - t0 < 2 * 0.05 + 0.5
    for f in futs:
        with pytest.raises(ioplane.LaneWatchdogTimeout):
            f.result()
    assert lanes[0].total_faults == 3 and lanes[0].quarantined
    assert ioplane.is_retryable_device_fault(ioplane.LaneWatchdogTimeout("x"))


def _sticky(*_a, **_k):
    raise torch.AcceleratorError("CUDA error: an illegal memory access was encountered")


def test_a_failed_grouped_copy_counts_once_on_its_positions(placed, monkeypatch):
    """A CUDA error raised by the grouped fetch's copy (disarmed) lands on
    the bucket's positions as a readback_error, once; force_all leaves the
    count to each future's own retry."""
    lanes = [placed.lanes.lane(placed.placement.devices[i]) for i in (2, 7)]
    monkeypatch.setattr(ioplane, "_fetch", _sticky)
    with pytest.raises(torch.AcceleratorError) as raised:
        ioplane.gather_device_results([(torch.arange(3),), (torch.ones(2),)], [2, 7])
    assert [(ln.total_faults, ln.last_fault_kind) for ln in lanes] == [(1, "readback_error")] * 2
    # the dispatch layer that replies it does not count it again
    ioplane.note_raised_fault(raised.value, 2)
    assert lanes[0].total_faults == 1
    futs = [ioplane.ReadbackFuture((torch.arange(2),), position=2) for _ in range(2)]
    ioplane.force_all(futs)  # the grouped copy fails, each future copies alone
    assert [f.result().tolist() for f in futs] == [[0, 1]] * 2
    assert lanes[0].total_faults == 1 and lanes[0].consec_faults == 0


def test_a_real_cuda_error_counts_on_its_lane_and_quarantines(monkeypatch):
    """A torch.AcceleratorError raised by a handler's kernel wrapper (the
    first call after a sticky error) replies -TRYAGAIN and counts on the
    lane it ran under: lane-quarantine-after of them quarantine the
    position, and DEVPROBE, whose first op fails the same way, answers
    [0, 1] and counts its own failure once."""
    from redisson_tpu_torch.core import kernels as K

    with ServerThread(port=0, device="cpu", devices="all", workers=2) as st:
        step = _Stepper(st)
        try:
            key, victim = _victim(st)
            lane = st.server.engine.lanes.lane(st.server.engine.placement.devices[victim])
            assert step.wave([("PFADD", key, "a")]) == b":1\r\n"
            monkeypatch.setattr(K, "hll_add_bytes", _sticky)
            monkeypatch.setattr(K, "hll_add_packed", _sticky)
            n = ioplane.quarantine_after()
            for i in range(n):
                assert step.wave([("PFADD", key, f"x{i}")]) == \
                    b"-TRYAGAIN device fault during dispatch; retry\r\n"
                assert lane.consec_faults == i + 1
            assert lane.quarantined and lane.total_faults == n
            assert lane.last_fault_kind == "kernel_launch"
            assert step.wave([("PFADD", key, "y")]) == (
                f"-TRYAGAIN device {lane.dev_id} quarantined; retry after evacuation\r\n".encode())
            monkeypatch.setattr(torch, "arange", _sticky)
            assert step.wave([("CLUSTER", "DEVPROBE", str(victim))]) == b"*2\r\n:0\r\n:1\r\n"
            assert lane.total_faults == n + 1
            monkeypatch.undo()  # the restarted process: a fresh context
            assert step.wave([("CLUSTER", "DEVPROBE", str(victim))]) == b"*2\r\n:1\r\n:0\r\n"
            assert step.wave([("PFADD", key, "z")]) == b":1\r\n"
        finally:
            step.close()


def test_an_injected_hung_readback_trips_the_armed_watchdog(placed):
    """The counterpart of the reference's test_lane_watchdog_bounds_hung_readback
    (which stages its value with jax.device_put)."""
    lane = placed.lanes.lane(placed.placement.devices[3])
    ioplane.set_lane_watchdog_ms(50)
    sched = port_faults.FaultSchedule(0)
    sched.add("device_hang", port=3, after=0, count=1, delay_s=30.0)
    with sched.plane().active():
        t0 = time.monotonic()
        with pytest.raises(ioplane.LaneWatchdogTimeout, match="lane-watchdog"):
            ioplane.ReadbackFuture((torch.arange(4),), position=3).result()
        assert time.monotonic() - t0 < 5.0
        # the rule's one event is spent: the next readback is clean
        assert ioplane.ReadbackFuture((torch.arange(4),), position=3).result().sum() == 6
    assert lane.total_faults >= 1 and lane.last_fault_kind == "watchdog_timeout"
    assert not ioplane.is_retryable_device_fault(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))


def test_an_injected_launch_failure_lands_on_the_lane_before_the_gate(placed):
    lane = placed.lanes.lane(placed.placement.devices[2])
    sched = port_faults.FaultSchedule(0)
    sched.add("device_kernel", port=2, count=3)
    with sched.plane().active():
        for i in range(3):
            with pytest.raises(RuntimeError, match="CUDA error"):
                with lane.occupy(4, qos_class="bulk"):
                    pass
            assert lane.consec_faults == i + 1
    assert lane.quarantined and lane.last_fault_kind == "kernel_launch"
    # nothing was entered: the ledgers and the gate are as before
    assert lane.qos.census(prefix="q")["q_bulk_inflight_ops"] == 0
    assert lane.dispatches == 0 and not lane._gate.locked()


# -- the disarmed guard lines allocate nothing ----------------------------------


def _guard_lines(mod):
    """Line numbers of every chaos-plane and watchdog guard in `mod`."""
    lines = []
    with open(mod.__file__) as fh:
        for no, line in enumerate(fh, 1):
            text = line.split("#")[0]
            if ("_fault_plane" in text or "_lane_watchdog_s" in text) and \
                    "def " not in text and "install" not in text and "global" not in text:
                lines.append(no)
            if "plane is not None" in text or "plane.on_" in text:
                lines.append(no)
    return mod.__file__, sorted(set(lines))


def _offenders(snap, path, guards):
    return [(tb.lineno, stat.size) for stat in snap.statistics("lineno")
            for tb in [stat.traceback[0]]
            if tb.filename == path and tb.lineno in guards and stat.size > 0]


def test_disarmed_transport_guards_allocate_nothing():
    """The reference's tests/test_perf_smoke.py zero-allocation case, on the
    port's net/client.py."""
    assert port_net._fault_plane is None
    a, b = socket.socketpair()
    stop = threading.Event()

    def echo():
        while not stop.is_set():
            try:
                data = b.recv(1 << 16)
            except OSError:
                return
            if not data:
                return
            b.sendall(b"+PONG\r\n" * max(1, data.count(b"PING")))

    t = threading.Thread(target=echo, daemon=True)
    t.start()
    conn = port_net.Connection.__new__(port_net.Connection)  # no connect handshake
    conn.host, conn.port = "local", 0
    conn.timeout = 5.0
    conn._parser = resp.RespParser()
    conn._pending = deque()
    conn.push_handler = None
    conn.dropped_pushes = 0
    conn._sock = a
    conn.closed = False
    try:
        conn.execute("PING")
        conn.execute_many([("PING",)] * 4)
        path, guards = _guard_lines(port_net)
        assert len(guards) >= 5
        tracemalloc.start(1)
        try:
            for _ in range(200):
                conn.execute("PING")
                conn.execute_many([("PING",)] * 2)
            snap = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        assert not _offenders(snap, path, guards)
    finally:
        stop.set()
        conn.close()
        b.close()
        t.join(timeout=5)


def test_disarmed_device_guards_allocate_nothing(placed):
    assert port_net._fault_plane is None and ioplane.lane_watchdog_ms() == 0
    lane = placed.lanes.lane(placed.placement.devices[4])
    vals = [torch.arange(8) for _ in range(4)]

    def once():
        with lane.occupy(1):
            fut = ioplane.ReadbackFuture((vals[0],))
        fut.result()
        ioplane.force_all([ioplane.ReadbackFuture((v,)) for v in vals])
        ioplane.gather_device_results([(v,) for v in vals], [4, 4, 4, 4])

    once()
    path, guards = _guard_lines(ioplane)
    assert len(guards) >= 8
    tracemalloc.start(1)
    try:
        for _ in range(200):
            once()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert not _offenders(snap, path, guards)


# -- the command stream against the reference -----------------------------------

DIM = 8
VEC = np.ones(DIM, np.float32).tobytes()
IDX = ("FT.CREATE", "oix", "ON", "HASH", "PREFIX", "1", "oi:", "SCHEMA", "emb", "VECTOR",
       "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(DIM), "DISTANCE_METRIC", "L2")
KNN = ("FT.SEARCH", "oix", "(*)=>[KNN 2 @emb $v]", "PARAMS", "2", "v", VEC, "NOCONTENT")


class _Stepper:
    """One connection a server: send a wave, read its raw reply bytes."""

    def __init__(self, st):
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


def _devices_rows(raw: bytes):
    """CLUSTER DEVICES without the labels (the port's name positions, the
    reference's JAX devices)."""
    parser = resp.RespParser(use_native=False)
    (rows,) = parser.feed(raw)
    return [rows[0]] + [[r[0], r[1]] + r[3:] for r in rows[1:]]


def _victim(st):
    p = st.server.engine.placement
    key = "dfk0"
    return key, int(p.owner_snapshot()[calc_slot(key.encode())])


def _run_stream(servers, steppers, proto: int, tmp_path):
    """The fault stream on every server: [(wave, {name: reply bytes})]."""
    out = []

    def wave(cmds, devices=False):
        got = {}
        for name, s in steppers.items():
            raw = s.wave(cmds)
            got[name] = _devices_rows(raw) if devices else raw
        out.append((cmds, got))
        return got

    if proto == 3:
        wave([("HELLO", "3")])
    key, victim = _victim(servers["ref"])
    assert _victim(servers["port"]) == (key, victim)
    other = next(f"dfo{i}" for i in range(200)
                 if int(servers["port"].server.engine.placement.owner_snapshot()[calc_slot(f"dfo{i}".encode())])
                 != victim)
    wave([("CONFIG", "GET", "lane-*")])
    wave([("CONFIG", "SET", "lane-quarantine-after", "3"), ("CONFIG", "SET", "lane-watchdog-ms", "-1"),
          ("CONFIG", "SET", "lane-quarantine-after", "0"), ("CONFIG", "GET", "lane-watchdog-ms"),
          ("CONFIG", "GET", "lane-quarantine-after")])
    wave([("PFADD", key, "a", "b"), ("SET", other, "v")])
    wave([("CLUSTER", "DEVICES")], devices=True)
    planes = {}
    for name, mod in (("ref", ref_faults), ("port", port_faults)):
        sched = mod.FaultSchedule(11)
        sched.add("device_kernel", port=victim, after=0, count=1000)
        planes[name] = sched.plane()
    ref_net.install_fault_plane(planes["ref"])
    port_net.install_fault_plane(planes["port"])
    # a streak of lane-quarantine-after launch failures on one position,
    # each a frame of its own: -TRYAGAIN, the third flips the quarantine
    for c in (("PFADD", key, "c"), ("GET", key), ("PFCOUNT", key)):
        wave([c])
    # the quarantined position's keys reply the quarantine -TRYAGAIN;
    # another position's keys still serve
    wave([("PFADD", key, "d")])
    wave([("GET", other)])
    wave([("PFCOUNT", key), ("GET", other), ("SET", key, "x")])
    wave([("CLUSTER", "DEVICES")], devices=True)
    wave([("CLUSTER", "DEVPROBE", str(victim))])
    wave([("CLUSTER", "DEVICES")], devices=True)
    jd = {name: str(tmp_path / f"journal-{name}") for name in servers}
    got = {}
    for name, s in steppers.items():
        got[name] = s.wave([("CLUSTER", "DEVEVACUATE", str(victim), "DIR", jd[name])])
    out.append((["DEVEVACUATE"], got))
    wave([("CLUSTER", "DEVICES")], devices=True)
    wave([("PFCOUNT", key)])
    ref_net.install_fault_plane(None)
    port_net.install_fault_plane(None)
    wave([("CLUSTER", "DEVPROBE", str(victim))])
    wave([("CLUSTER", "DEVICES")], devices=True)
    wave([("PFADD", key, "e"), ("PFCOUNT", key), ("CLUSTER", "DEVPROBE", "99")])
    # the first growth of a vector bank runs out of the card's memory:
    # -OOM with the row kept pending, and the retry lands
    for name, mod in (("ref", ref_faults), ("port", port_faults)):
        sched = mod.FaultSchedule(12)
        sched.add("device_oom", after=0, count=1)
        planes[name] = sched.plane()
    ref_net.install_fault_plane(planes["ref"])
    port_net.install_fault_plane(planes["port"])
    wave([IDX, ("HSET", "oi:k", "emb", VEC)])
    wave([KNN])
    wave([KNN])
    ref_net.install_fault_plane(None)
    port_net.install_fault_plane(None)
    wave([("CLUSTER", "DEVICES")], devices=True)
    wave([("CONFIG", "SET", "lane-watchdog-ms", "250"), ("CONFIG", "SET", "lane-quarantine-after", "4"),
          ("CONFIG", "GET", "lane-*"), ("CONFIG", "SET", "lane-watchdog-ms", "0"),
          ("CONFIG", "SET", "lane-quarantine-after", "3")])
    return out, planes


@pytest.mark.parametrize("proto", [2, 3])
def test_fault_stream_replies_equal_the_reference(proto, tmp_path):
    servers = {"ref": RefServerThread(port=0, devices="all", workers=4),
               "port": ServerThread(port=0, device="cpu", devices="all", workers=4)}
    for st in servers.values():
        st.start()
    steppers = {k: _Stepper(st) for k, st in servers.items()}
    try:
        assert servers["port"].server.engine.placement.n_devices == 8
        out, planes = _run_stream(servers, steppers, proto, tmp_path)
        for w, (cmds, got) in enumerate(out):
            if isinstance(got["ref"], bytes):
                a, b = W.reply_spans(got["ref"]), W.reply_spans(got["port"])
                assert len(a) == len(cmds)
            else:
                a, b = got["ref"], got["port"]
            assert a == b, (w, cmds, a, b)
        probes = [g["port"] for c, g in out
                  if len(c) == 1 and isinstance(c[0], tuple) and c[0][:2] == ("CLUSTER", "DEVPROBE")]
        assert probes == [b"*2\r\n:0\r\n:1\r\n", b"*2\r\n:1\r\n:0\r\n"]
        text = b"".join(g["port"] for _c, g in out if isinstance(g["port"], bytes))
        assert text.count(b"-TRYAGAIN device fault during dispatch; retry") == 3
        assert b"quarantined; retry after evacuation" in text
        assert b"-OOM device out of memory growing vector bank" in text
        assert planes["port"].injected == planes["ref"].injected == {"device_oom": 1}
    finally:
        for s in steppers.values():
            s.close()
        for st in servers.values():
            st.stop()


def test_a_real_oom_at_growth_replies_the_references_injected_oom(monkeypatch):
    """A torch.OutOfMemoryError from the grown planes' torch.zeros takes the
    injected fault's path: the same -OOM bytes as the reference's injected
    RESOURCE_EXHAUSTED, the fault on the owner lane as alloc_oom, the row
    kept pending, and no retry or host fallback until the client's retry."""
    real = torch.zeros
    calls = {"n": 0}

    def zeros(*a, **kw):
        calls["n"] += 1
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    with RefServerThread(port=0, devices="all", workers=2) as ref, \
            ServerThread(port=0, device="cpu", devices="all", workers=2) as st:
        steps = {"ref": _Stepper(ref), "port": _Stepper(st)}
        try:
            setup = [IDX, ("HSET", "oi:k", "emb", VEC)]
            for s in steps.values():
                s.wave(setup)
            sched = ref_faults.FaultSchedule(0)
            sched.add("device_oom", after=0, count=1)
            ref_net.install_fault_plane(sched.plane())
            want = steps["ref"].wave([KNN])
            ref_net.install_fault_plane(None)
            monkeypatch.setattr(port_vector.torch, "zeros", zeros)
            got = steps["port"].wave([KNN])
            assert calls["n"] == 1  # no silent retry
            monkeypatch.setattr(port_vector.torch, "zeros", real)
            assert got == want and got.startswith(b"-OOM device out of memory growing vector bank")
            lanes = st.server.engine.lanes.lanes()
            assert sorted(ln.last_fault_kind for ln in lanes if ln.total_faults) == ["alloc_oom"]
            assert steps["port"].wave([KNN]) == steps["ref"].wave([KNN])
            assert steps["port"].wave([("PING",)]) == b"+PONG\r\n"
        finally:
            for s in steps.values():
                s.close()


_PORT_DIGEST_SCRIPT = r"""
import hashlib, socket
import numpy as np
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.chaos.faults import FaultSchedule
from redisson_tpu_torch.net.client import install_fault_plane
from redisson_tpu_torch.parallel import mesh
from redisson_tpu_torch.server.server import ServerThread

mesh.set_cpu_positions(8)
IDX = ("FT.CREATE", "oix", "ON", "HASH", "PREFIX", "1", "oi:",
       "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
       "DIM", "8", "DISTANCE_METRIC", "L2")
VEC = np.ones(8, np.float32).tobytes()
KNN = ("FT.SEARCH", "oix", "(*)=>[KNN 1 @emb $v]",
       "PARAMS", "2", "v", VEC, "NOCONTENT")

with ServerThread(port=0, device="cpu", devices="all", workers=8) as st:
    s = socket.create_connection((st.server.host, st.server.port), timeout=30)
    parser = resp.RespParser(use_native=False)
    h = hashlib.sha256()

    def drive(cmds):
        s.sendall(b"".join(resp.encode_command(*c) for c in cmds))
        replies = []
        while len(replies) < len(cmds):
            data = s.recv(1 << 16)
            assert data, "server closed early"
            h.update(data)
            replies.extend(parser.feed(data))
        return replies

    drive([("SET", "dk1", "v1"), ("GET", "dk1")])
    sched = FaultSchedule(0)
    sched.add("device_kernel", after=0, count=1)
    sched.add("device_oom", after=0, count=1)
    prev = install_fault_plane(sched.plane())
    try:
        (r_try,) = drive([("SET", "dk2", "v2")])
        drive([IDX, ("HSET", "oi:k", "emb", VEC)])
        (r_oom,) = drive([KNN])
        (r_ok,) = drive([KNN])
    finally:
        install_fault_plane(prev)
    drive([("SET", "dk3", "v3"), ("GET", "dk3")])
    s.close()

assert isinstance(r_try, resp.RespError) and str(r_try).startswith("TRYAGAIN"), r_try
assert isinstance(r_oom, resp.RespError) and str(r_oom).startswith("OOM"), r_oom
assert not isinstance(r_ok, resp.RespError) and r_ok[0] == 1, r_ok
print(h.hexdigest())
"""


def test_fault_reply_digest_equal_with_and_without_the_native_codec():
    """The counterpart of the reference's
    test_fault_reply_digest_identical_without_native (which runs the
    reference in a subprocess): the port's degraded replies digest the
    same with the native wire codec and with RTPU_NO_NATIVE=1."""
    digests = {}
    for label, extra in (("native", {}), ("fallback", {"RTPU_NO_NATIVE": "1"})):
        env = dict(os.environ, PYTHONPATH=REPO, **extra)
        out = subprocess.run([sys.executable, "-c", _PORT_DIGEST_SCRIPT], capture_output=True,
                             text=True, timeout=240, cwd=REPO, env=env)
        assert out.returncode == 0, (label, out.stdout, out.stderr)
        digests[label] = out.stdout.strip().splitlines()[-1]
    assert digests["native"] == digests["fallback"] and len(digests["native"]) == 64


# -- the census -----------------------------------------------------------------


def test_census_reads_the_references_metrics():
    """The same sources tracked in both packages give the same metric
    names, and a quiet server's census stays flat."""
    with RefServerThread(port=0) as ref, ServerThread(port=0, device="cpu") as st:
        keys = {}
        for name, mod, server in (("ref", ref_census, ref.server), ("port", port_census, st.server)):
            c = mod.ResourceCensus()
            c.track_engine("engine", server.engine)
            c.track_server("server", server)
            c.track_checkpoints()
            before = c.snapshot()
            after = c.snapshot()
            c.assert_flat(before, after)
            keys[name] = sorted(before)
        assert keys["port"] == keys["ref"]
        assert "engine.kernel_cache_entries" in keys["port"]
