"""The port's synchronizers against the reference's, on the CPU: the same
threaded scenarios run on redisson_tpu.create() and on
redisson_tpu_torch.create(device="cpu") in a fixed interleaving (each step
waits for the one before it), and their observations must be equal and
right: reentrancy, lease expiry and watchdog renewal, a non-owner's unlock,
fair-lock order, read-write exclusion, fenced tokens, MultiLock and
RedLock, semaphore permits, permit leases and their expiry, latch
count-down and rate-limiter refusals.

Also the engine's timers: every timeout rides one wheel timer, so holding
1,000 locks with watchdogs adds at most one timer thread and the pools'
threads, and Engine.shutdown() leaves no timer thread alive."""
import threading
import time

import pytest

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.client.objects import lock as rlock
from redisson_tpu_torch.client.objects import lock as tlock
from redisson_tpu_torch.core.engine import Engine

PACKAGES = {"reference": (redisson_tpu, rlock), "port": (redisson_tpu_torch, tlock)}


def _create(pkg):
    return pkg.create() if pkg is redisson_tpu else pkg.create(device="cpu")


def in_thread(fn, timeout=10.0):
    """fn() on a thread of its own (another lock holder); its reply."""
    out = []
    th = threading.Thread(target=lambda: out.append(fn()), daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), "the other holder did not finish"
    return out[0]


def run_both(scenario, monkeypatch=None, lease=None):
    """scenario(client) on each package; returns {package: observations}."""
    out = {}
    for key, (pkg, lockmod) in PACKAGES.items():
        if lease is not None:
            monkeypatch.setattr(lockmod, "DEFAULT_LEASE", lease)
        c = _create(pkg)
        try:
            out[key] = scenario(c)
        finally:
            c.shutdown()
    return out


def test_reentrancy_and_a_non_owners_unlock():
    def scenario(c):
        lk = c.get_lock("l")
        obs = [lk.is_locked(), lk.try_lock(), lk.try_lock(), lk.get_hold_count(),
               lk.is_held_by_current_thread()]
        obs.append(in_thread(lambda: (lk.try_lock(), lk.is_held_by_current_thread(), lk.get_hold_count())))
        obs.append(in_thread(lambda: _raises(lk.unlock)))
        lk.unlock()
        obs += [lk.is_locked(), lk.get_hold_count()]
        lk.unlock()
        obs += [lk.is_locked(), _raises(lk.unlock), in_thread(lambda: lk.try_lock())]
        obs += [lk.is_locked(), lk.force_unlock(), lk.is_locked(), lk.force_unlock()]
        return obs

    got = run_both(scenario)
    assert got["port"] == got["reference"]
    assert got["port"] == [False, True, True, 2, True, (False, False, 0), "RuntimeError", True, 1,
                           False, "RuntimeError", True, True, True, False, False]


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the exception type is the observation
        return type(e).__name__
    return None


def test_lease_expiry_and_watchdog_renewal(monkeypatch):
    def scenario(c):
        lk = c.get_lock("lease")
        obs = [lk.try_lock(lease_time=0.2), in_thread(lambda: lk.try_lock())]
        time.sleep(0.35)  # the lease lapsed: another holder gets in
        obs += [lk.is_locked(), in_thread(lambda: lk.try_lock(wait_time=1.0, lease_time=5.0))]
        wd = c.get_lock("watchdog")
        wd.lock()  # no lease: the watchdog renews every DEFAULT_LEASE / 3
        time.sleep(2.6)  # past two leases of 1.2 s
        obs += [wd.is_locked(), in_thread(lambda: wd.try_lock()), 0 < wd.remain_time_to_live_lock() <= 1.2]
        wd.unlock()
        obs += [wd.is_locked(), len(c.engine._renewals), in_thread(lambda: wd.try_lock(lease_time=5.0))]
        return obs

    got = run_both(scenario, monkeypatch, lease=1.2)
    assert got["port"] == got["reference"] == [True, False, False, True, True, False, True, False, 0, True]


def test_fair_lock_grants_in_arrival_order():
    def scenario(c):
        fl = c.get_fair_lock("fair")
        fl.lock()
        order, threads = [], []
        for i in range(4):
            th = threading.Thread(target=lambda i=i: (fl.lock(), order.append(i), fl.unlock()), daemon=True)
            th.start()
            threads.append(th)
            deadline = time.time() + 5
            while len(c.engine.store.get("fair").host["queue"]) < i + 1 and time.time() < deadline:
                time.sleep(0.002)  # the waiter has queued
        fl.unlock()
        for th in threads:
            th.join(10)
        return [order, fl.is_locked(), [th.is_alive() for th in threads]]

    got = run_both(scenario)
    assert got["port"] == got["reference"] == [[0, 1, 2, 3], False, [False] * 4]


def test_read_write_exclusion():
    def scenario(c):
        rw = c.get_read_write_lock("rw")
        r, w = rw.read_lock(), rw.write_lock()
        # another thread's read lock stays held: readers share, writers wait
        obs = [r.try_lock(), in_thread(lambda: rw.read_lock().try_lock()),
               in_thread(lambda: rw.write_lock().try_lock()), w.try_lock()]
        r.unlock()
        obs += [r.is_locked(), _raises(w.unlock), _raises(r.unlock)]
        rw2 = c.get_read_write_lock("rw2")
        r2, w2 = rw2.read_lock(), rw2.write_lock()
        obs += [w2.try_lock(), w2.try_lock(), in_thread(lambda: rw2.read_lock().try_lock()), r2.try_lock()]
        w2.unlock()
        w2.unlock()  # downgraded: still a reader
        obs += [w2.is_locked(), in_thread(lambda: rw2.write_lock().try_lock(wait_time=0.05))]
        r2.unlock()
        obs += [in_thread(lambda: rw2.write_lock().try_lock()), r2.is_locked()]
        return obs

    got = run_both(scenario)
    assert got["port"] == got["reference"] == [True, True, False, False, True, "RuntimeError", "RuntimeError",
                                                True, True, False, True, False, False, True, False]


def test_fenced_tokens_increase():
    def scenario(c):
        f = c.get_fenced_lock("fence")
        obs = [f.get_token(), f.lock_and_get_token()]
        f.unlock()
        obs += [in_thread(lambda: (f.try_lock_and_get_token(), f.unlock())[0])]
        obs += [f.try_lock_and_get_token(), f.try_lock_and_get_token(), f.get_token()]
        obs += [in_thread(lambda: f.try_lock_and_get_token(wait_time=0.05))]
        return obs

    got = run_both(scenario)
    assert got["port"] == got["reference"] == [0, 1, 2, 3, 3, 3, None]


def test_multi_lock_and_red_lock_are_all_or_nothing():
    def scenario(c):
        a, b, d = c.get_lock("a"), c.get_lock("b"), c.get_lock("d")
        ml = c.get_multi_lock(a, b)
        obs = [ml.try_lock(), a.is_locked(), b.is_locked()]
        obs += [in_thread(lambda: c.get_multi_lock(d, b).try_lock(wait_time=0.05)), d.is_locked()]
        ml.unlock()
        rl = c.get_red_lock(a, b, d)
        obs += [a.is_locked(), rl.try_lock(), in_thread(lambda: d.try_lock())]
        rl.unlock()
        obs += [d.is_locked(), _raises(lambda: c.get_multi_lock()), _raises(ml.unlock)]
        return obs

    got = run_both(scenario)
    assert got["port"] == got["reference"] == [True, True, True, False, False, False, True, False, False,
                                                "ValueError", "RuntimeError"]


def test_permits_leases_latches_and_rate_limits():
    def scenario(c):
        s = c.get_semaphore("sem")
        obs = [s.try_set_permits(2), s.try_set_permits(5), s.available_permits(), s.try_acquire(),
               in_thread(lambda: s.try_acquire(2)), s.try_acquire(), s.try_acquire(wait_time=0.05)]
        s.release(2)
        s.add_permits(3)
        obs += [s.available_permits(), s.drain_permits(), s.available_permits()]
        pes = c.get_permit_expirable_semaphore("pes")
        obs += [pes.try_set_permits(2)]
        p1 = pes.try_acquire(lease_time=0.2)
        p2 = pes.try_acquire()
        obs += [p1 is not None, p2 is not None, pes.try_acquire(), pes.available_permits()]
        time.sleep(0.3)  # p1's lease lapsed: its permit returns
        obs += [pes.available_permits(), _raises(lambda: pes.release(p1)), pes.release(p2),
                pes.available_permits(), _raises(lambda: pes.release("nobody"))]
        latch = c.get_count_down_latch("latch")
        obs += [latch.try_set_count(2), latch.try_set_count(3), latch.get_count(), latch.await_(0.05)]
        waiter = threading.Thread(target=lambda: obs_wait.append(latch.await_(5.0)), daemon=True)
        obs_wait = []
        waiter.start()
        in_thread(latch.count_down)
        obs += [latch.get_count()]
        latch.count_down()
        waiter.join(5)
        obs += [obs_wait, latch.get_count(), latch.await_(0.0)]
        rl = c.get_rate_limiter("rate")
        obs += [rl.try_set_rate("OVERALL", 3, 0.5), rl.try_set_rate("OVERALL", 9, 1.0),
                [rl.try_acquire() for _ in range(4)], rl.available_permits(), rl.try_acquire(2),
                in_thread(lambda: rl.try_acquire())]
        time.sleep(0.55)
        obs += [rl.try_acquire(3), rl.try_acquire(), _raises(lambda: rl.set_rate("SIDEWAYS", 1, 1.0))]
        return obs

    got = run_both(scenario)
    assert got["port"] == got["reference"]
    assert got["port"][:7] == [True, False, 2, True, False, True, False]


# -- the wheel timer ----------------------------------------------------------


# The scenario runs in a fresh interpreter: the thread counts below are the
# process's, and in a pytest worker that ran other files first, their
# leftover pools (an engine never shut down, the reference's process-wide
# pools) may start threads during the sleep.  The lease is 3 s (renewed every
# 1 s): with 0.6 s, a renewal had 0.24-0.31 s of headroom before its lease
# ran out, less than a loaded machine can stall a process.  The check comes
# 4 s after the first lock, past its lease, so a lock is still held only if
# the watchdog renewed it.
_WATCHDOGS = """
import json, sys, threading, time
from redisson_tpu_torch.client.objects import lock as tlock
from redisson_tpu_torch.client.redisson import RedissonTpu
from redisson_tpu_torch.core.engine import Engine

tlock.DEFAULT_LEASE = 3.0
wheel = lambda: [t for t in threading.enumerate() if t.name == "rtpu-wheel-timer"]
before = set(threading.enumerate())
engine = Engine(device="cpu")
client = RedissonTpu(engine)
try:
    locks = [client.get_lock(f"wd:{i}") for i in range(1000)]
    t0 = time.monotonic()
    for lk in locks:
        lk.lock()
    time.sleep(max(0.0, t0 + 4.0 - time.monotonic()))  # 1.33 leases after the first lock
    added = [t for t in threading.enumerate() if t not in before]
    out = {"timers": len(wheel()) - sum(t in before for t in wheel()),
           "added": sorted(t.name for t in added),
           "locked": sum(lk.is_locked() for lk in locks), "renewals": len(engine._renewals)}
    for lk in locks:
        lk.unlock()
    out["renewals_after_unlock"] = len(engine._renewals)
finally:
    engine.shutdown()
print(json.dumps(out))
"""


def test_a_thousand_watchdogs_ride_one_timer_thread():
    import json
    import subprocess
    import sys
    from pathlib import Path

    run = subprocess.run([sys.executable, "-c", _WATCHDOGS], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parent.parent)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    names = sorted({n.rsplit("_", 1)[0] for n in got["added"]})
    assert got["timers"] <= 1
    # the wheel, its task pools (4 workers each at most) and the sweep
    assert len(got["added"]) <= 1 + 4 + 4 + 1, names
    assert got["locked"] == 1000
    assert got["renewals"] == 1000
    assert got["renewals_after_unlock"] == 0


def test_engine_shutdown_leaves_no_timer_thread():
    engines = [Engine(device="cpu") for _ in range(3)]
    for i, e in enumerate(engines):
        e.schedule_timeout(lambda: None, 30.0)
        e.start_renewal(f"l{i}", "me", lambda: True, 30.0)
        assert e._timer._thread.is_alive()
    wheels = [e._timer._thread for e in engines]
    for e in engines:
        e.shutdown()
    assert not any(t.is_alive() for t in wheels)
    with pytest.raises(RuntimeError):
        engines[0].schedule_timeout(lambda: None, 1.0)


def test_timeouts_and_write_behind_flushes_ride_the_wheel():
    from redisson_tpu_torch.client.objects.map import MapOptions
    from redisson_tpu_torch.utils.timer import Timeout

    c = redisson_tpu_torch.create(device="cpu")
    try:
        fired = threading.Event()
        t = c.engine.schedule_timeout(fired.set, 0.05)
        assert fired.wait(5.0) and t.is_expired()
        cancelled = c.engine.schedule_timeout(fired.clear, 0.3)
        assert cancelled.cancel()
        time.sleep(0.5)
        assert fired.is_set()  # a cancelled timeout never runs

        class Writer:
            def __init__(self):
                self.flushed = threading.Event()

            def write(self, entries):
                self.flushed.set()

            def delete(self, keys):
                pass

        w = Writer()
        m = c.get_map("wb", options=MapOptions(writer=w, write_mode=MapOptions.WRITE_BEHIND,
                                               write_behind_delay=0.05))
        m.put("a", 1)
        assert isinstance(m._wb_timer, Timeout)
        assert w.flushed.wait(5.0)
        assert [th.name for th in threading.enumerate()].count("rtpu-wheel-timer") >= 1
        assert c.engine._timer._thread.is_alive()
    finally:
        c.shutdown()
