"""The port's QoS plane (redisson_tpu_torch.server.scheduler) against the
reference server's on the CPU: tenant budgets shed the same commands with
the same -BUSY bytes and counts, a shed never splits a coalesced add run,
CLIENT QOS replies alike, a bulk flood passes the bounded admission gate
while interactive frames dispatch on their own pool, and the disarmed
plane (qos off, and the RTPU_NO_QOS switch) keeps the armed plane's reply
bytes."""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.server import server as SRV
from redisson_tpu_torch.tools import wire_stream as W

ROOT = Path(__file__).resolve().parent.parent


def _servers(**kw):
    return (lambda: RefServerThread(port=0, **kw), lambda: ServerThread(port=0, device="cpu", **kw))


def _shed_run(st):
    """The reply bytes of a shed stream and the shed counters after it.
    Budgets refill at 0.001 items/s, so no frame's outcome hangs on time."""
    host, port = st.server.host, st.server.port
    # the frame's first key names its tenant: vip, so hog's and t1's
    # budgets start full when they are set
    names = ["sh{vip}", "sh{hog}", "ru{t1}", "rv{t1}", "rw{t1}"]
    out = W.replies(host, port, [[("BF.RESERVE", n, "0.01", "10000") for n in names]])
    sched = st.server.scheduler
    sched.set_tenant_rate("hog", 0.001, 300)
    sched.set_tenant_rate("t1", 0.001, 150)
    hog, vip = W._i8(np.arange(200)), W._i8(np.arange(32))
    t1 = {n: W._i8(np.arange(100 * i, 100 * i + 100)) for i, n in enumerate(names[2:])}
    out += W.replies(host, port, [
        [("BF.MADD64", "sh{hog}", hog)] * 4,       # 200 of 300 tokens, then shed
        [("BF.MADD64", "sh{vip}", vip)] * 2,       # another tenant: untouched
        [("BF.MADD64", n, b) for n, b in t1.items()],  # a run across the boundary
        [("BF.MADD64", "sh{hog}", hog)],           # fully shed
    ])
    sched.set_tenant_rate("t1", 0)                 # lift the budget, then audit
    out += W.replies(host, port, [[("BF.MEXISTS64", n, b) for n, b in t1.items()]])
    # (tenant, admitted, shed ops, shed frames): levels hang on time
    table = [row[:1] + row[2:5] for row in sched.tenant_table()]
    return out, (st.server.stats["sheds"], sched.shed_ops, sched.shed_frames, table)


def test_sheds_match_the_reference():
    runs = []
    for make in _servers():
        with make() as st:
            runs.append(_shed_run(st))
    (want, want_counts), (got, got_counts) = runs
    assert [raw for raw, _ in got] == [raw for raw, _ in want]
    assert got_counts == want_counts
    busy = resp.RespError
    hog4, vip2, run3, hog1, audit = (g for _, g in got[1:])
    assert [isinstance(r, busy) for r in hog4] == [False, True, True, True]
    assert str(hog4[1]).startswith("BUSY") and "'hog'" in str(hog4[1])
    assert not any(isinstance(r, busy) for r in vip2)
    # the admitted prefix applied once; the shed suffix never dispatched
    assert run3[0] == b"\x01" * 100 and all(isinstance(r, busy) for r in run3[1:])
    assert isinstance(hog1[0], busy)
    assert audit == [b"\x01" * 100, b"\x00" * 100, b"\x00" * 100]
    assert got_counts[:3] == (6, 1000, 3)


def test_client_qos_verb_matches_the_reference():
    stream = [("CLIENT", "QOS", "GET"), ("CLIENT", "QOS", "CLASS", "bulk", "TENANT", "acme"),
              ("CLIENT", "QOS", "GET"), ("PING",), ("CLIENT", "QOS", "CLASS", "auto"),
              ("CLIENT", "QOS", "TENANT", "acme"), ("CLIENT", "QOS", "GET"),
              ("CLIENT", "QOS", "CLASS", "warp"), ("CLIENT", "QOS", "TENANT"),
              ("CLIENT", "QOS", "CLASS", "bulk", "TENANTS", "x"), ("CLIENT", "QOS", "NOPE"),
              ("CLIENT", "QOS")]
    waves = [stream, [("HELLO", "3")] + stream]
    out = []
    for make in _servers():
        with make() as st:
            out.append(W.replies(st.server.host, st.server.port, waves))
    assert [raw for raw, _ in out[1]] == [raw for raw, _ in out[0]]
    replies = out[1][1][1]
    assert replies[3][b"class"] == b"bulk" and replies[3][b"tenant"] == b"acme"
    assert replies[3][b"armed"] == 1
    assert all(isinstance(r, resp.RespError) for r in replies[8:])


def _flood(st, frames=6):
    """Four connections each send `frames` bulk frames (two BF.MADD64 of
    200 keys: 400 items) while a fifth sends small interactive frames; the
    reply bytes of each connection."""
    host, port = st.server.host, st.server.port
    W.replies(host, port, [[("BF.RESERVE", f"fl{c}:{i}", "0.01", "5000")
                            for c in range(4) for i in range(2)]])
    waves = {c: [[("BF.MADD64", f"fl{c}:{i}", W._i8(np.arange(200) + 1000 * f + 7 * c)) for i in range(2)]
                 for f in range(frames)] for c in range(4)}
    waves[4] = [[("SET", f"k{f}", str(f)), ("GET", f"k{f}"), ("PING",)] for f in range(2 * frames)]
    out = {}

    def send(c):
        out[c] = [raw for raw, _ in W.replies(host, port, waves[c])]

    threads = [threading.Thread(target=send, args=(c,)) for c in waves]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert len(out) == 5
    return out


def test_a_bulk_flood_passes_the_gate_and_interactive_frames_keep_their_pool(monkeypatch):
    with RefServerThread(port=0) as st:
        want = _flood(st)
    seen, lock = [], threading.Lock()
    real_dispatch = SRV.TpuServer._dispatch_traced

    def dispatch(self, fn, ctx, arg, trace=None):
        verb = bytes((arg[0] if fn.__name__ == "_dispatch_bloom_run" else arg)[0]).upper()
        with lock:
            seen.append((verb, threading.current_thread().name.split("_")[0]))
        return real_dispatch(self, fn, ctx, arg, trace)

    peak, gate = [], []
    real_enter, real_wait = ioplane.QosLedger.enter, ioplane.QosLedger.wait_enter

    def enter(self, *a):
        real_enter(self, *a)
        peak.append(self.frames["bulk"])

    def wait_enter(self):
        gate.append(1)
        real_wait(self)

    monkeypatch.setattr(SRV.TpuServer, "_dispatch_traced", dispatch)
    monkeypatch.setattr(ioplane.QosLedger, "enter", enter)
    monkeypatch.setattr(ioplane.QosLedger, "wait_enter", wait_enter)
    for qos in (True, False):
        seen.clear(), peak.clear(), gate.clear()
        with ServerThread(port=0, device="cpu", qos=qos) as st:
            sched = st.server.scheduler
            sched.bulk_slots = 1
            got = _flood(st)
            ledger = sched.ledger
            drained = (ledger.frames, ledger.ops, ledger.nbytes, ledger.waiting)
        assert got == want, qos
        pools = {v: {p for sv, p in seen if sv == v} for v, _ in seen}
        if qos:
            assert pools[b"BF.MADD64"] == {"rtpu-srv"}
            assert pools[b"SET"] == pools[b"GET"] == pools[b"PING"] == {"rtpu-qos"}
            assert len(gate) == 24 and max(peak) == 1  # one bulk frame at a time
            assert drained == ({"interactive": 0, "bulk": 0},) * 3 + (0,)
        else:
            assert set().union(*pools.values()) == {"rtpu-srv"}
            assert gate == [] and peak == []


def test_rtpu_no_qos_env_disarms_subprocess():
    code = (
        "import json\n"
        "from redisson_tpu_torch.server import scheduler\n"
        "from redisson_tpu_torch.server.server import TpuServer\n"
        "srv = TpuServer(device='cpu')\n"
        "print(json.dumps({'module': scheduler.qos_enabled(), 'armed': srv.scheduler.armed}))\n"
        "srv.stop()\n"
    )
    env = dict(os.environ, RTPU_NO_QOS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"module": False, "armed": False}
