"""Local cached maps and object references over the wire, in all four
pairings of the two packages' clients and servers (the port's
RemoteRedisson to a port ServerThread(device="cpu"), the reference's to a
reference ServerThread, and each package's client to the other's server).

``get_local_cached_map`` is driven in INVALIDATE and TRACKING modes by two
clients (writes by one seen by the other's near cache, a transaction's
local cached view and its commit handshake); every result and the server's
stored records must equal the reference pair's.  An OBJCALL that returns a
handle (a map value holding a list, a map's lock) gets the reference
server's reply bytes, the pickled ``ObjectRef``, and both clients resolve it
to a live handle.
"""
import contextlib
import pickle
import time

import numpy as np
import pytest

import redisson_tpu.client.objects.localcache as ref_lc
import redisson_tpu.client.remote as ref_remote
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu_torch import state
from redisson_tpu_torch.client import remote as port_remote
from redisson_tpu_torch.client.objects import localcache as port_lc
from redisson_tpu_torch.net.client import Connection
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.server.server import TpuServer

TIMEOUT = 60.0
CLIENTS = {"port": (port_remote.RemoteRedisson, port_lc), "ref": (ref_remote.RemoteRedisson, ref_lc)}
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]
PAIR_IDS = ["port_client_port_server", "port_client_ref_server", "ref_client_port_server"]
NAMES = ["lc:m", "lc:refs", "lc:inner"]


@contextlib.contextmanager
def _server(pkg):
    """A started server of `pkg`; its engine shuts down with it, so no timer
    or pool thread outlives the test."""
    st = ServerThread(port=0, device="cpu") if pkg == "port" else RefServerThread(port=0)
    try:
        with st:
            yield st
    finally:
        st.server.engine.shutdown()


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _stored(server):
    port = isinstance(server, TpuServer)
    out = {}
    for name in NAMES:
        rec = server.engine.store.get(name)
        if rec is None:
            out[name] = None
        elif port:
            kind, meta, arrays, host = state.to_reference(rec)
            out[name] = (kind, meta, {k: np.asarray(v).tolist() for k, v in arrays.items()}, host)
        else:
            out[name] = (rec.kind, dict(rec.meta), {k: np.asarray(v).tolist() for k, v in rec.arrays.items()},
                         rec.host)
    return out


def drive_local_cache(pkg, address, strategy):
    """Two clients of `pkg` on one local cached map; returns the results."""
    cls, lc = CLIENTS[pkg]
    c1, c2 = cls(address, timeout=TIMEOUT), cls(address, timeout=TIMEOUT)
    out = []
    try:
        if strategy == "TRACKING":
            c1.enable_tracking()
            c2.enable_tracking()
        opts = lc.LocalCachedMapOptions(sync_strategy=getattr(lc.SyncStrategy, strategy))
        a = c1.get_local_cached_map("lc:m", options=opts)
        b = c2.get_local_cached_map("lc:m", options=opts)
        out += [a.put("k1", 1), a.put("k2", {"x": [1, 2]}), a.fast_put("k3", "three"),
                a.put_all({"k4": 4, "k5": 5}), a.put("k1", 10)]
        out += [b.get("k1"), b.get("k1"), b.get_all(["k1", "k2", "k9"])]
        out += [a.put("k1", 11), _wait(lambda: b.get("k1") == 11), b.get("k1")]
        out += [a.remove("k2"), _wait(lambda: b.get("k2") is None),
                a.fast_remove("k3", "k9"), _wait(lambda: b.get("k3") is None)]
        out += [b.put("k5", 55), _wait(lambda: a.get("k5") == 55), a.get("k5")]
        out += [b.size(), sorted(b.read_all_map().items()), b.contains_key("k4")]
        # a transaction's local cached view: the commit disables and enables
        # every near cache of the map around the commit frame
        tx = c1.create_transaction()
        view = tx.get_local_cached_map(a)
        view.put("t", "tx")
        view.fast_put("k4", 44)
        tx.commit()
        out += [_wait(lambda: b.get("t") == "tx"), _wait(lambda: b.get("k4") == 44), b.get_all(["t", "k4"])]
        # the enable that follows the commit is published: it may land after
        # the values read back
        out += [_wait(lambda: not b._disabled and not a._disabled)]
        a.destroy()
        b.destroy()
    finally:
        c1.shutdown()
        c2.shutdown()
    return out


def _seed_refs(server):
    """A map value holding a list handle, stored by the server's own client."""
    srv = server.local_client()
    inner = srv.get_list("lc:inner")
    inner.add("x")
    srv.get_map("lc:refs").put("l", inner)


def drive_refs(pkg, address):
    """An OBJCALL that returns a handle, resolved by `pkg`'s client."""
    cls, _lc = CLIENTS[pkg]
    c = cls(address, timeout=TIMEOUT)
    try:
        m = c.get_map("lc:refs")
        got = m.get("l")
        lock = m.get_lock("key")
        out = [type(got).__name__, got.name, got.read_all(), type(lock).__name__, lock.name]
        got.add("y")
        out += [c.get_list("lc:inner").read_all(), m.read_all_map().keys() == {"l"}]
    finally:
        c.shutdown()
    return out


def _run(client_pkg, server_pkg):
    with _server(server_pkg) as st:
        res = {s: drive_local_cache(client_pkg, st.address, s) for s in ("INVALIDATE", "TRACKING")}
        _seed_refs(st.server)
        res["refs"] = drive_refs(client_pkg, st.address)
        return res, _stored(st.server)


@pytest.fixture(scope="module")
def reference_run():
    return _run("ref", "ref")


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=PAIR_IDS)
def test_local_cached_maps_and_handles_match_the_reference_pair(reference_run, client_pkg, server_pkg):
    want, want_state = reference_run
    got, got_state = _run(client_pkg, server_pkg)
    for key in want:
        assert got[key] == want[key], key
    assert got_state == want_state
    assert all(x is True for x in got["INVALIDATE"] if isinstance(x, bool))
    assert got["refs"][0] in ("RemoteObjectProxy", "RList") and got["refs"][2] == ["x"]


def test_objcall_returning_a_handle_replies_the_reference_bytes():
    """The raw R-frames of OBJCALLs that return handles: a map value that is
    a reference, and a map's lock."""
    calls = [("get_map", "lc:refs", "get", (("l",), {})),
             ("get_map", "lc:refs", "get_lock", (("key",), {})),
             ("get_map", "lc:refs", "read_all_map", ((), {}))]
    out = []
    for pkg in ("ref", "port"):
        with _server(pkg) as st:
            _seed_refs(st.server)
            conn = Connection(st.server.host, st.server.port)
            try:
                out.append([conn.execute("OBJCALL", f, n, meth, pickle.dumps(args, protocol=4), timeout=TIMEOUT)
                            for f, n, meth, args in calls])
            finally:
                conn.close()
    want, got = out
    assert got == want
    assert all(isinstance(r, bytes) and r[:1] == b"R" for r in got)
    assert b"redisson_tpu.client.codec" in got[0] and b"redisson_tpu.client.objects.list" in got[0]
    assert b"redisson_tpu_torch" not in b"".join(got)
