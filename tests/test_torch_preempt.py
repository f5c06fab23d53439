"""The port's preemption plane, CONFIG and CLUSTER QOS against the reference
server's, on the CPU.

Each package runs a ``devices=1`` laned server and gets the same command
stream: CONFIG GET and SET of every knob the port serves, CLUSTER QOS and
``REBALANCE ... WEIGHT``, and a 6-command ``BF.MADD64`` run split into
sub-windows at ``qos-bulk-subwindow-items`` 128 and 256.  The reply bytes
must be equal, in RESP2 and RESP3, and again with preemption disarmed
(``set_preempt(False)``).  Tolerance: none, the bytes are compared whole.
"""
import threading
import time

import numpy as np
import pytest

from redisson_tpu.core import ioplane as ref_ioplane
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu.services import vector as ref_vector
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.net.client import Connection
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.services import vector as port_vector
from redisson_tpu_torch.tools import wire_stream as W

# every CONFIG knob the port serves, with a value to set it to and back
_KNOBS = [
    ("qos-enabled", "1", "1"),
    ("qos-tenant-rate", "0", "0"),
    ("qos-tenant-burst", "5000", ""),
    ("qos-interactive-max-items", "64", "256"),
    ("qos-interactive-deadline-ms", "40", "0"),
    ("qos-bulk-slots", "2", "0"),
    ("qos-bulk-subwindow-items", "4096", "0"),
    ("qos-shed-penalty-ms", "0", "0"),
    ("dispatch-ahead", "5", "2"),
    ("tracking-table-max-keys", "1000", "1000000"),
    ("eviction-min-delay", "2.5", "5"),
    ("eviction-max-delay", "900", "1800"),
    ("trace-ring-capacity", "64", "512"),
    ("slowlog-log-slower-than", "500", "10000"),
    ("slowlog-max-len", "16", "128"),
    ("ivf-cell-imbalance", "5.0", "3"),
    ("ivf-cell-cap-max", "64", "0"),
    ("ftvec-device-budget", "1048576", "0"),
]
_READ_ONLY = ["mode", "role", "tls", "placement-devices", "trace-enabled",
              "checkpoint-path", "residency-enabled", "device-budget-bytes",
              "lane-watchdog-ms", "lane-quarantine-after"]


def _config_waves():
    get = [("CONFIG", "GET", k) for k, _s, _r in _KNOBS]
    get += [("CONFIG", "GET", k) for k in _READ_ONLY]
    sets = [("CONFIG", "SET", k, v) for k, v, _r in _KNOBS]
    bad = [("CONFIG", "SET", "dispatch-ahead", "0"), ("CONFIG", "SET", "port", "1234"),
           ("CONFIG", "SET", "ivf-cell-imbalance", "0.5"),
           ("CONFIG", "SET", "ftvec-device-budget", "-3"),
           ("CONFIG", "SET", "no-such-knob", "1"), ("CONFIG", "RESETSTAT")]
    # the defaults first: the tracer's and the vector knobs are the
    # process's, and an earlier test in this process may have moved them
    back = [("CONFIG", "SET", k, r) for k, _s, r in _KNOBS] + [("CONFIG", "SET", "trace-enabled", "0")]
    return [back + get + [("CONFIG", "GET", "qos-*"), ("CONFIG", "GET", "ivf-*")],
            sets + get + bad, back + get]


def _bulk_waves(target: int, tag: str):
    names = [f"pw{{{tag}}}:{i}" for i in range(6)]
    blobs = [W._i8(np.arange(100) + 1_000_000 * i + 7 * target) for i in range(6)]
    return [
        [("BF.RESERVE", n, "0.01", "10000") for n in names],
        [("CLIENT", "QOS", "CLASS", "bulk"), ("CONFIG", "SET", "qos-bulk-subwindow-items", str(target))],
        [("BF.MADD64", n, b) for n, b in zip(names, blobs)],
        [("BF.MADD64", n, b) for n, b in zip(names, blobs)],
        [("CLIENT", "QOS", "CLASS", "auto"), ("CONFIG", "SET", "qos-bulk-subwindow-items", "0")],
        [("BF.MEXISTS64", n, b) for n, b in zip(names, blobs)],
    ]


def _qos_waves():
    return [
        [("CLUSTER", "QOS", "REBALANCE", "acme", "12500", "20000"),
         ("CLUSTER", "QOS", "REBALANCE", "gold", "8000", "12000", "WEIGHT", "2"),
         ("CLUSTER", "QOS", "REBALANCE", "acme"),
         ("CLUSTER", "QOS", "REBALANCE", "acme", "wat"),
         ("CLUSTER", "QOS", "REBALANCE", "gold", "8000", "WEIGHT", "wat")],
        [("CLUSTER", "QOS")],
    ]


def _stream(proto: int):
    waves = [[("HELLO", str(proto))]] if proto == 3 else []
    waves += _config_waves()
    waves += _bulk_waves(128, "a") + _bulk_waves(256, "b")
    waves += _qos_waves()
    return waves


def _lane_dispatches(st) -> int:
    return sum(lane.dispatches for lane in st.server.engine.lanes.lanes())


def _run(make, proto: int):
    """(raw reply bytes a wave, lane dispatches of each split run)."""
    with make() as st:
        host, port = st.server.host, st.server.port
        waves = _stream(proto)
        out, split = [], []
        for wave in waves:
            before = _lane_dispatches(st)
            out += W.replies(host, port, [wave])
            if wave[0][0] == "BF.MADD64":
                split.append(_lane_dispatches(st) - before)
        return [raw for raw, _ in out], split


def _servers():
    return (lambda: RefServerThread(port=0, devices=1, workers=4),
            lambda: ServerThread(port=0, device="cpu", devices=1, workers=4))


@pytest.fixture(autouse=True)
def _restore_globals():
    saved = (ioplane.preempt_enabled(), ref_ioplane.preempt_enabled(),
             port_vector.IVF_CELL_IMBALANCE, ref_vector.IVF_CELL_IMBALANCE)
    yield
    ioplane.set_preempt(saved[0])
    ref_ioplane.set_preempt(saved[1])
    for mod in (ioplane, ref_ioplane):
        mod.set_bulk_subwindow_items(0)
        mod.set_window_deadline(None)
        mod.set_replica_occupancy(None)
    for mod, imb in ((port_vector, saved[2]), (ref_vector, saved[3])):
        mod.set_ivf_cell_imbalance(imb)
        mod.set_ivf_cell_cap_max(0)
        mod.set_device_bytes_budget(0)


@pytest.mark.parametrize("armed", [True, False], ids=["armed", "disarmed"])
@pytest.mark.parametrize("proto", [2, 3])
def test_stream_replies_equal_the_reference(proto, armed):
    ioplane.set_preempt(armed)
    ref_ioplane.set_preempt(armed)
    (want, want_split), (got, got_split) = (_run(make, proto) for make in _servers())
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"wave {i}: {g[:300]!r} != {w[:300]!r}"
    # 6 commands of 100 items: 6 chunks at 128, 3 at 256; one unsplit
    # dispatch disarmed (the second run of each pair as the first)
    assert got_split == want_split
    assert got_split == ([6, 6, 3, 3] if armed else [1, 1, 1, 1])


def test_armed_and_disarmed_replies_are_the_same_bytes():
    """Every reply but the last wave's CLUSTER QOS view, whose STREAM rows
    book interactive dispatches on the interactive stream only when armed."""
    runs = []
    for armed in (True, False):
        ioplane.set_preempt(armed)
        runs.append(_run(_servers()[1], 2)[0])
    assert runs[0][:-1] == runs[1][:-1]
    assert runs[0][-1] != runs[1][-1]


def test_operations_knobs_read_defaults_and_refuse_sets():
    from redisson_tpu.core import residency as ref_res
    from redisson_tpu_torch.core import residency as port_res

    saved = [(m, m.tier_enabled(), m.DEVICE_BUDGET_BYTES) for m in (ref_res, port_res)]
    with ServerThread(port=0, device="cpu") as st, RefServerThread(port=0) as ref, \
            st.client() as c, ref.client() as rc:
        try:
            for key in ("residency-enabled", "device-budget-bytes",
                        "lane-watchdog-ms", "lane-quarantine-after"):
                assert c.execute("CONFIG", "GET", key) == rc.execute("CONFIG", "GET", key)
            # the residency knobs came with the residency plane: they set and
            # read back as the reference's
            for key, value in (("device-budget-bytes", "1048576"), ("residency-enabled", "yes"),
                               ("residency-enabled", "no"), ("device-budget-bytes", "0")):
                assert c.execute("CONFIG", "SET", key, value) == rc.execute("CONFIG", "SET", key, value) == b"OK"
                assert c.execute("CONFIG", "GET", key) == rc.execute("CONFIG", "GET", key)
                assert c.execute("CONFIG", "GET", "residency-enabled") == rc.execute("CONFIG", "GET", "residency-enabled")
            # the lane fault plane's knobs came with the device-fault domain:
            # they set, refuse out-of-range values and read back as the
            # reference's
            for key, value in (("lane-watchdog-ms", "250"), ("lane-quarantine-after", "4"),
                               ("lane-watchdog-ms", "-1"), ("lane-quarantine-after", "0"),
                               ("lane-watchdog-ms", "0"), ("lane-quarantine-after", "3")):
                got, want = c.execute("CONFIG", "SET", key, value), rc.execute("CONFIG", "SET", key, value)
                assert (type(got).__name__, str(got)) == (type(want).__name__, str(want))
                assert c.execute("CONFIG", "GET", key) == rc.execute("CONFIG", "GET", key)
        finally:
            for mod, tier, budget in saved:
                mod.set_tier(tier)
                mod.set_device_budget_bytes(budget)
        # checkpoint-path came with the checkpoints: read and set as the
        # reference's
        for conn in (c, rc):
            assert conn.execute("CONFIG", "GET", "checkpoint-path") == [b"checkpoint-path", b""]
            assert conn.execute("CONFIG", "SET", "checkpoint-path", "/tmp/cp.ckpt") == b"OK"
        assert c.execute("CONFIG", "GET", "checkpoint-path") == rc.execute("CONFIG", "GET", "checkpoint-path")


def test_preempt_point_yields_to_a_waiting_interactive_dispatch():
    """A bulk frame of 8 sub-windows under the modelled occupancy (10 ms a
    chunk; BF.MADD64 and BF.MEXISTS64 alternate, so no coalesced run spans
    two chunks) while another connection sends interactive BF.MEXISTS64
    frames (4 ms a frame on the interactive gate): the lane's preemption
    points yield to them, and CLUSTER QOS books them on the interactive
    stream."""
    with ServerThread(port=0, device="cpu", devices=1, workers=4) as st:
        host, port = st.server.host, st.server.port
        lane = st.server.engine.lanes.lanes()[0]
        names = [f"pp{{z}}:{i}" for i in range(8)]
        blobs = [W._i8(np.arange(512) + 10_000_000 * i) for i in range(8)]
        W.replies(host, port, [[("BF.RESERVE", n, "0.01", "50000") for n in names]
                               + [("CONFIG", "SET", "qos-bulk-subwindow-items", "512")]])
        ioplane.set_replica_occupancy(20_000.0)
        done = threading.Event()
        probes = []

        def interactive():
            conn = Connection(host, port, timeout=30.0)
            try:
                probe = W._i8(np.arange(200))
                while not done.is_set():
                    probes.append(conn.execute("BF.MEXISTS64", names[0], probe))
            finally:
                conn.close()

        t = threading.Thread(target=interactive)
        t.start()
        try:
            time.sleep(0.05)
            frame = []
            for n, b in zip(names[::2], blobs[::2]):
                frame += [("BF.MADD64", n, b), ("BF.MEXISTS64", n, b)]
            out = W.replies(host, port, [[("CLIENT", "QOS", "CLASS", "bulk")], frame])
        finally:
            done.set()
            t.join(30)
            ioplane.set_replica_occupancy(None)
        assert all(r == b"\x01" * 512 for r in out[1][1])
        assert probes and lane.preemptions >= 1
        assert lane.interactive_waiting() == 0
        with st.client() as c:
            rows = {bytes(r[1]): r for r in c.execute("CLUSTER", "QOS")[3:]
                    if isinstance(r, list) and r[0] == b"STREAM"}
        assert rows[b"interactive"][2] == 0 and rows[b"interactive"][3] >= 200
        assert rows[b"bulk"][2] == 0
