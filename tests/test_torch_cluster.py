"""The port's cluster serving path against the reference's, on the CPU.

A reference ``ClusterRunner`` and a port one (three masters each) get the
same command streams over raw connections: their reply bytes must be equal,
RESP2 and RESP3, once each node's address, port and ID are replaced by its
master index.  Each package's ``ClusterRedisson`` then drives the other's
cluster with the same replies; the process ``ClusterSupervisor`` spawns
port servers whose logs name their device and kernel launches.
"""
import os
import signal
import time
from contextlib import contextmanager

import numpy as np
import pytest

from redisson_tpu.client.cluster import ClusterRedisson as RefClusterRedisson
from redisson_tpu.harness import ClusterRunner as RefClusterRunner
from redisson_tpu_torch import config as port_config
from redisson_tpu_torch.client.cluster import ClusterRedisson
from redisson_tpu_torch.client.replicated import ReplicatedRedisson
from redisson_tpu_torch.cluster import ClusterSupervisor, NodeStartupError, topology
from redisson_tpu_torch.harness import ClusterRunner
from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.verbs import sketch as SK
from redisson_tpu_torch.tools import wire_stream as W
from redisson_tpu_torch.utils.crc16 import calc_slot
from tests._torch_port_suite import time_limit

# the most seconds a test that starts server processes may take
PROC_TEST_S = 120


@contextmanager
def _runners(masters: int = 3):
    """A reference ClusterRunner and a port one on the CPU."""
    ref = RefClusterRunner(masters=masters).run()
    try:
        port = ClusterRunner(masters=masters, device="cpu").run()
        try:
            yield ref, port
        finally:
            port.shutdown()
    finally:
        ref.shutdown()


def _name_in(runner, mi: int, prefix: str) -> str:
    """The first f"{prefix}-{i}" whose slot master mi owns."""
    lo, hi = runner.slot_ranges[mi]
    return next(n for n in (f"{prefix}-{i}" for i in range(100_000))
                if lo <= calc_slot(n.encode()) <= hi)


def _normalize(raw: bytes, runner) -> bytes:
    """Reply bytes with each master's host:port, port and node ID replaced
    by its index (the only bytes that differ between two clusters)."""
    for i, m in enumerate(runner.masters):
        srv = m.server.server
        raw = raw.replace(f"{srv.host}:{srv.port}".encode(), b"<m%d>" % i)
        raw = raw.replace(srv.node_id.encode(), b"<id%d>" % i)
        raw = raw.replace(b":%d\r\n" % srv.port, b":<p%d>\r\n" % i)
    return raw


def _blob(n: int, seed: int) -> bytes:
    return W._i8(np.random.default_rng(seed).integers(-2**62, 2**62, n))


def _bf_run(runner, verb: str, names) -> list:
    return [(verb, n, _blob(32, calc_slot(n.encode()))) for n in names]


# -- the coalesced run checks routing ----------------------------------------

@pytest.mark.parametrize("verb", ["BF.MEXISTS64", "BF.MADD64"])
def test_a_coalesced_run_with_a_foreign_name_gets_moved_for_it_alone(verb, monkeypatch):
    """A pipelined BF run on master 0 with one name master 1 owns: the
    foreign command replies MOVED, the rest the reference's replies.  The
    foreign filter also lies on master 0 (made there while it held no view,
    as a stale copy would), so a run served without the routing check would
    answer from it, or add to it."""
    fused = []
    real = SK.coalesce_bloom_run
    monkeypatch.setattr(SK, "coalesce_bloom_run",
                        lambda server, ctx, cmds: fused.append(real(server, ctx, cmds)) or fused[-1])
    with _runners() as (ref, port):
        out = []
        for runner in (ref, port):
            own = [_name_in(runner, 0, f"own{i}") for i in range(3)]
            foreign = _name_in(runner, 1, "foreign")
            names = own[:2] + [foreign] + own[2:]
            view = topology.flatten_view(runner.view_tuples())
            setup = ([("CLUSTER", "RESET")] + [("BF.RESERVE", n, "0.01", "1000") for n in own + [foreign]]
                     + [("CLUSTER", "SETVIEW", *view)])
            m0 = runner.masters[0].server.server
            (_, s), = W.replies(m0.host, m0.port, [setup])
            assert s == [b"OK"] * 6
            stale = m0.engine.store.get(foreign).version
            (raw, got), = W.replies(m0.host, m0.port, [_bf_run(runner, verb, names)])
            assert m0.engine.store.get(foreign).version == stale
            out.append((_normalize(raw, runner), got, foreign))
        (want_raw, want, _), (got_raw, got, foreign) = out
        assert got_raw == want_raw
        assert isinstance(got[2], RespError) and str(got[2]).startswith(f"MOVED {calc_slot(foreign.encode())} ")
        assert not any(isinstance(r, RespError) for r in got[:2] + got[3:])
        # the run was ineligible (the redirect), so it went command by command
        assert fused == [None]


# -- reply bytes: the reference's cluster and the port's ------------------------

def _cluster_stream(runner, node: int) -> list:
    """One node's stream: keys over every master's range (MOVED for the
    foreign ones), the CLUSTER views, a stale SETVIEW TOKEN, a view reset
    and reinstall, ASKING outside a window, MULTI with a foreign key, and
    coalescible BF runs spanning foreign slots."""
    keys = [_name_in(runner, mi, f"k{j}") for j in range(3) for mi in range(len(runner.masters))]
    bfs = [_name_in(runner, mi, f"bf{j}") for j in range(2) for mi in range(len(runner.masters))]
    own = _name_in(runner, node, "own")
    foreign = _name_in(runner, (node + 1) % len(runner.masters), "away")
    view = topology.flatten_view(runner.view_tuples())
    cmds = [("SET", k, f"v-{k}") for k in keys] + [("GET", k) for k in keys]
    cmds += [("CLUSTER", "SLOTS"), ("CLUSTER", "INFO"), ("CLUSTER", "MYID"),
             ("CLUSTER", "COUNTKEYSINSLOT", calc_slot(keys[node].encode())),
             ("CLUSTER", "GETKEYSINSLOT", calc_slot(keys[node].encode()), 10),
             ("CLUSTER", "COUNTKEYSINSLOT", calc_slot(keys[node + 1].encode()))]
    cmds += [("BF.RESERVE", n, "0.01", "1000") for n in bfs]
    cmds += _bf_run(runner, "BF.MADD64", bfs) + _bf_run(runner, "BF.MEXISTS64", bfs)
    cmds += [("CLUSTER", "SETVIEW", "TOKEN", 7 + node, *view),
             ("CLUSTER", "SETVIEW", "TOKEN", 3, *view),
             ("CLUSTER", "RESET"), ("CLUSTER", "INFO"), ("CLUSTER", "SLOTS"),
             ("CLUSTER", "SETVIEW", "TOKEN", 9 + node, *view), ("CLUSTER", "INFO"),
             ("CLUSTER", "SETVIEW", "1", "2", "3"),
             ("ASKING",), ("GET", foreign),
             ("MULTI",), ("SET", own, "in-tx"), ("SET", foreign, "no"), ("EXEC",),
             ("GET", own), ("DBSIZE",), ("CLUSTER", "NOSUCH")]
    return cmds


def test_cluster_reply_bytes_match_the_reference():
    with _runners() as (ref, port):
        out = []
        for runner in (ref, port):
            per_node = []
            for i, m in enumerate(runner.masters):
                stream = _cluster_stream(runner, i)
                srv = m.server.server
                for raw, got in W.replies(srv.host, srv.port, [stream, [("HELLO", "3")] + stream]):
                    per_node.append((_normalize(raw, runner), got))
            out.append(per_node)
        want, got = out
        assert len(got) == 6
        for (graw, g), (wraw, w) in zip(got, want):
            assert graw == wraw
        # the stream reached what it means to: MOVED, STALEVIEW, the views
        replies = got[0][1]
        errors = [str(r) for r in replies if isinstance(r, RespError)]
        assert any(e.startswith("MOVED ") for e in errors)
        assert any(e.startswith("STALEVIEW ") for e in errors)
        assert b"cluster_enabled:0" in b"".join(r for r in replies if isinstance(r, bytes))


# -- each package's client drives the other's cluster ------------------------------

def _client_ops(client) -> list:
    """One client's op stream; error replies are kept as their text (either
    package's RespError)."""
    out = []

    def run(fn):
        try:
            out.append(fn())
        except Exception as e:  # noqa: BLE001 — the two packages' RespError
            if type(e).__name__ != "RespError":
                raise
            out.append(f"raised RespError: {e}")

    names = [f"cd-{i}" for i in range(24)]
    for n in names:
        run(lambda n=n: client.execute("SET", n, n.upper()))
    run(lambda: [client.execute("GET", n) for n in names])
    run(lambda: client.execute_many([("INCRBY", f"ctr-{i}", i) for i in range(12)]
                                    + [("GET", n) for n in names[:6]]))
    run(lambda: sorted(client.execute("KEYS", "cd-*")))
    run(lambda: client.execute("DBSIZE"))
    for i in range(6):
        b = client.get_bucket(f"bkt-{i}")
        run(lambda b=b, i=i: b.set({"i": i, "l": [i] * i}))
        run(lambda b=b: b.get())
    m = client.get_map("cd-map")
    run(lambda: [m.put(f"k{i}", i * i) for i in range(5)])
    run(lambda: sorted(m.read_all_map().items()))
    run(lambda: client.objcall_many([("get_map", f"om-{i}", "put", (f"k{i}", i), {}) for i in range(9)]))
    run(lambda: client.objcall_many([("get_map", f"om-{i}", "get", (f"k{i}",), {}) for i in range(9)]))
    bf = client.get_bloom_filter("cd-bf")
    keys = np.arange(2000, dtype=np.int64) * 7919
    run(lambda: bf.try_init(10_000, 0.01))
    run(lambda: bf.add_each(keys).tolist())
    run(lambda: bf.contains_each(np.concatenate([keys, keys + 1])).tolist())
    run(lambda: client.execute("DEL", *names))
    # multi-key commands across slots: refused client-side, as the
    # reference refuses them
    run(lambda: client.execute("PFMERGE", "hll-a", "hll-b"))
    run(lambda: client.execute("RENAME", "cd-0", "cd-1"))
    run(lambda: client.execute("MGET", "{x}a", "{x}b"))
    run(lambda: client.execute("DBSIZE"))
    return out


@pytest.mark.parametrize("pairing", ["reference client, port cluster",
                                     "port client, reference cluster",
                                     "port client, port cluster"])
def test_each_client_drives_each_cluster_with_the_reference_replies(pairing):
    client_pkg, cluster_pkg = (p.split()[0] for p in pairing.split(", "))
    with _runners() as (ref, port):
        runs = {}
        for name, make, runner in (("baseline", RefClusterRedisson, ref),
                                   (pairing, ClusterRedisson if client_pkg == "port" else RefClusterRedisson,
                                    port if cluster_pkg == "port" else ref)):
            client = make(runner.seeds(), scan_interval=0, timeout=60.0)
            try:
                if name == pairing:
                    # the baseline's state is gone from its cluster first
                    client.execute("FLUSHALL")
                runs[name] = _client_ops(client)
            finally:
                client.shutdown()
    want, got = runs["baseline"], runs[pairing]
    assert got == want
    assert any(isinstance(r, str) and "CROSSSLOT" in r for r in got)


def test_the_client_follows_moved_after_the_view_changes():
    """A client with a stale view: the masters' ranges rotate under it, and
    every keyed command follows MOVED to the new owner."""
    with _runners() as (_, port):
        client = port.client(scan_interval=0, timeout=30.0)
        try:
            names = [f"mv-{i}" for i in range(30)]
            client.execute_many([("SET", n, "before") for n in names])
            rotated = [(lo, hi, h, p, nid) for (lo, hi, _, _, _), (_, _, h, p, nid)
                       in zip(port.view_tuples(), port.view_tuples()[1:] + port.view_tuples()[:1])]
            topology.install_view([m.server.client for m in port.masters], rotated)
            # the data stayed where it was, so every GET misses on its new owner
            assert client.execute_many([("GET", n) for n in names]) == [None] * 30
            client.execute_many([("SET", n, "after") for n in names])
            assert [client.execute("GET", n) for n in names] == [b"after"] * 30
            owner = {calc_slot(n.encode()): n for n in names}
            for lo, hi, h, p, _ in rotated:
                srv = next(m.server.server for m in port.masters if m.server.server.port == p)
                assert all(srv.engine.store.exists(n) for s, n in owner.items() if lo <= s <= hi)
        finally:
            client.shutdown()


# -- the process cluster ---------------------------------------------------------

def test_supervised_nodes_log_their_device_and_launches():
    with time_limit(PROC_TEST_S):
        sup = ClusterSupervisor(masters=2, platform="cpu", ready_timeout=60.0).start()
        try:
            client = sup.client(scan_interval=0)
            try:
                assert client.wait_routable(timeout=30.0)
                names = [_name_in(sup, mi, "sv") for mi in range(2)]
                client.execute_many([("BF.RESERVE", n, "0.01", "1000") for n in names])
                got = client.execute_many([("BF.MADD64", n, _blob(16, 1)) for n in names])
                assert got == [b"\x01" * 16] * 2
            finally:
                client.shutdown()
            codes = [sup.stop(node) for node in sup.masters]
            assert codes == [0, 0], [sup.log_tail(n) for n in sup.masters]
            for node in sup.masters:
                log = sup.log_tail(node)
                assert "serving on cpu" in log and "kernel launches {" in log, log
        finally:
            sup.shutdown()


def test_a_sigterm_with_a_client_open_exits_zero_and_flushes():
    """SIGTERM is the graceful path also while a cluster client holds its
    connections open: each node closes them before it waits for them,
    exits 0 well inside its grace, runs its flush-on-stop (the checkpoint
    holds the write, though the interval never ticked) and ends its log
    with its kernel launches."""
    from redisson_tpu_torch.core import checkpoint
    from redisson_tpu_torch.core.engine import Engine

    with time_limit(PROC_TEST_S):
        sup = ClusterSupervisor(masters=2, platform="cpu", checkpoint_interval=3600.0,
                                ready_timeout=60.0).start()
        try:
            client = sup.client(scan_interval=0)
            try:
                assert client.wait_routable(timeout=30.0)
                names = [_name_in(sup, mi, "st") for mi in range(2)]
                assert client.execute_many([("SET", n, "kept") for n in names]) == [b"OK"] * 2
                start = time.monotonic()
                codes = [sup.stop(node, timeout=10.0) for node in sup.masters]
                took = time.monotonic() - start
            finally:
                client.shutdown()
            assert codes == [0, 0] and took < 10.0, (codes, took, [sup.log_tail(n) for n in sup.masters])
            for name, node in zip(names, sup.masters):
                log = sup.log_tail(node)
                assert log.strip().splitlines()[-1].startswith("kernel launches {"), log
                engine = Engine(device="cpu")
                assert checkpoint.load(engine, node.checkpoint_path) == 1
                assert engine.store.get(name) is not None
        finally:
            sup.shutdown()


def test_a_node_asked_for_a_missing_card_fails_its_start(monkeypatch):
    """No fallback: a child asked for the card on a machine without one
    exits non-zero and the supervisor raises with its log."""
    with time_limit(PROC_TEST_S):
        sup = ClusterSupervisor(masters=1, env={"CUDA_VISIBLE_DEVICES": ""}, ready_timeout=60.0)
        with pytest.raises(NodeStartupError, match="died before ready|ready pipe closed") as err:
            sup.start()
        assert "device='cpu'" in str(err.value)
        assert all(not n.alive() for n in sup.masters)


def test_an_ssh_loopback_fleet_serves_over_tls():
    """The ssh host driver's whole pipeline (remote script, READY over the
    channel, signals by remote kill) through /bin/sh: two masters on two
    host labels, TLS armed by them, plaintext refused, a host killed."""
    from redisson_tpu_torch.cluster import LoopbackTransport, SshHostDriver
    from redisson_tpu_torch.net.client import Connection, ConnectionError_

    driver = SshHostDriver(transport=LoopbackTransport())
    assert driver._remote_script(["--port", "1"], "/tmp/n.log", {}, ()).endswith(
        "-m redisson_tpu_torch.server --port 1 --ready-fd 3")
    with time_limit(PROC_TEST_S):
        sup = ClusterSupervisor(masters=2, hosts=["hostA", "hostB"], driver=driver,
                                platform="cpu", ready_timeout=60.0)
        sup.start()
        try:
            assert sup.tls_armed and [n.host_label for n in sup.masters] == ["hostA", "hostB"]
            client = sup.client(scan_interval=0)
            try:
                assert client.wait_routable(timeout=30.0)
                names = [_name_in(sup, mi, "ssh") for mi in range(2)]
                client.execute_many([("SET", n, n) for n in names])
                assert client.execute_many([("GET", n) for n in names]) == [n.encode() for n in names]
            finally:
                client.shutdown()
            with pytest.raises((ConnectionError_, OSError)):
                c = Connection(sup.masters[0].host, sup.masters[0].port, timeout=5.0)
                try:
                    c.execute("PING")
                finally:
                    c.close()
            assert sup.kill_host("hostB") == {"m1": -signal.SIGKILL}
            assert sup.masters[0].alive() and not sup.masters[1].alive()
        finally:
            sup.shutdown()


# -- what waits for later slices ---------------------------------------------------

def test_replicas_and_replicated_clients_wait_for_m11():
    # replicas and the replicated client came with M11 part 3: the runner
    # and the supervisor plan a replica a master, and the replicated
    # client refuses a config without node addresses as the reference's does
    runner = ClusterRunner(masters=2, replicas_per_master=1, device="cpu")
    assert runner.replicas_per_master == 1 and runner.replicas == []
    plan = ClusterSupervisor(masters=2, replicas_per_master=1)
    assert plan._replica_hosts == {(0, 0): "local", (1, 0): "local"}
    with pytest.raises(ValueError, match="node_addresses"):
        ReplicatedRedisson.create(port_config.Config())
    # checkpoints came with M11 part 1: each node's checkpoint path and
    # interval go on its command line; scrape merges the live nodes (none)
    sup = ClusterSupervisor(masters=1, checkpoint_interval=5.0)
    node = sup._make_node("m0", "master", 0)
    cli = sup._server_cli(node, restore=True)  # no checkpoint yet: no --restore
    assert cli[cli.index("--checkpoint") + 1] == node.checkpoint_path
    assert cli[cli.index("--checkpoint-interval") + 1] == "5.0" and "--restore" not in cli
    assert sup.scrape() == "\n"
    # migration journals came with M11 part 4: every node journals its
    # imports into the supervisor's journal directory; a roll of no nodes
    # restarts nothing
    assert cli[cli.index("--journal-dir") + 1] == sup.journal_dir
    assert os.path.isdir(sup.journal_dir) and sup.rolling_restart(nodes=[]) == []
    # the fleet QoS loop is served: idempotent, stopped by shutdown
    rb = sup.start_qos_rebalance(1000.0, interval=3600.0)
    assert sup.start_qos_rebalance(1000.0) is rb and rb._thread is not None
    sup.shutdown()
    assert sup._qos_rebalancer is None and rb._thread is None


def test_config_loads_cluster_sections_from_files(tmp_path):
    (tmp_path / "c.yaml").write_text(
        "clusterServersConfig:\n  nodeAddresses: ['tpu://a:1', 'tpu://b:2']\n  scanInterval: 0.5\n")
    (tmp_path / "c.json").write_text('{"threads": 3, "replicatedServersConfig": {"nodeAddresses": ["tpu://r:1"]}}')
    cfg = port_config.Config.from_file(tmp_path / "c.yaml")
    assert cfg.cluster_servers_config.node_addresses == ["tpu://a:1", "tpu://b:2"]
    assert cfg.cluster_servers_config.scan_interval == 0.5
    cfg = port_config.Config.from_file(str(tmp_path / "c.json"))
    assert cfg.threads == 3 and cfg.replicated_servers_config.read_mode == "SLAVE"
    assert port_config.Config.from_yaml(cfg.to_yaml()).replicated_servers_config.node_addresses == ["tpu://r:1"]
