"""The port's fleet QoS plane (``cluster/qos_control.py``, the supervisor's
``start_qos_rebalance``, CLUSTER QOS) against the reference's, on the CPU.

``split_rate``, ``parse_tenant_table`` and ``parse_tenant_weights`` give the
reference's results on the same inputs; both packages' ``QosRebalancer``s,
scripted against the same scrape replies, push the same commands; a port
fleet under the rebalancer pushes splits that sum to the global rate (times
the tenant's weight); and the port's ``OccupancyLoadBalancer`` scores a port
fleet by its CLUSTER QOS view, as it scores a reference fleet.  Tolerance:
the splits are floats compared exactly between the packages (the same
arithmetic), and to 1e-9 relative against the global rate.
"""
import time
from contextlib import closing

import numpy as np
import pytest

from redisson_tpu.cluster import qos_control as RQ
from redisson_tpu_torch.cluster import qos_control as Q
from redisson_tpu_torch.cluster.supervisor import ClusterSupervisor
from redisson_tpu_torch.harness import ClusterRunner
from redisson_tpu_torch.net.balancer import OccupancyLoadBalancer
from redisson_tpu_torch.net.client import Connection, NodeClient
from redisson_tpu_torch.server.scheduler import Admission
from tests import _torch_port_suite

_REPLIES = [
    [1, 0, 0,
     [b"interactive", 0, 0, 0], [b"bulk", 1, 9, 100],
     [b"STREAM", b"interactive", 0, 5], [b"STREAM", b"bulk", 9, 900],
     [b"TENANT", b"hog", 42, 1000, 250, 3],
     [b"TENANT", b"vip", 7, 50, 0, 0]],
    [1, 0, 0,
     [b"interactive", 0, 0, 0],
     [b"TENANT", b"legacy", 0, 10, 0, 0],
     [b"TENANT", b"gold", 0, 10, 0, 0, b"2"],
     [b"TENANT", b"bad", 0, 10, 0, 0, b"not-a-float"]],
    [1, 0, 0],
    ["TENANT", "x"],
    RuntimeError("not a reply"),
    [1, 2, 3, ["TENANT", "s", 1, 2, 3, 4, "0.5"], [b"TENANT", b"short", 1]],
]


@pytest.mark.parametrize("reply", _REPLIES, ids=range(len(_REPLIES)))
def test_parsers_match_the_reference(reply):
    assert Q.parse_tenant_table(reply) == RQ.parse_tenant_table(reply)
    assert Q.parse_tenant_weights(reply) == RQ.parse_tenant_weights(reply)


def test_split_rate_matches_the_reference():
    rng = np.random.default_rng(20)
    cases = [({}, 1.0), ({"a": 0.0, "b": 0.0}, 1.0), ({"a": 90.0, "b": 10.0}, 1.0),
             ({"a": 100.0, "b": 0.0}, 1.0), ({"a": 1e9, "b": 1.0}, 2.0),
             ({"a": 3.0}, 0.0), ({"a": 5.0, "b": -1.0, "c": 0.0}, -3.0)]
    for _ in range(40):
        n = int(rng.integers(1, 9))
        demand = {f"n{i}": float(rng.integers(0, 1000)) for i in range(n)}
        cases.append((demand, float(rng.choice([0.5, 1.0, 2.0, 3.5]))))
    for demand, weight in cases:
        for rate, share in ((100.0, 0.05), (77.5, 0.2), (40_000.0, 0.0)):
            got = Q.split_rate(rate, demand, share, weight=weight)
            assert got == RQ.split_rate(rate, demand, share, weight=weight)
            if demand:
                assert sum(got.values()) == pytest.approx(rate * max(0.0, weight), rel=1e-9)


class _ScriptedNode:
    """A CLUSTER QOS endpoint serving a scripted tenant table (the weights
    it carries on their rows, a pre-weight row for the rest) and recording
    every REBALANCE push."""

    def __init__(self, weights=None):
        self.tenants = {}
        self.weights = dict(weights or {})
        self.pushes = []
        self.dead = False

    def __call__(self):
        if self.dead:
            raise ConnectionError("node down")
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def execute(self, *args):
        if args == ("CLUSTER", "QOS"):
            return [1, 0, 0] + [
                [b"TENANT", t.encode(), 0, adm, shed, 0]
                + ([f"{self.weights[t]:g}".encode()] if t in self.weights else [])
                for t, (adm, shed) in sorted(self.tenants.items())
            ]
        assert args[:3] == ("CLUSTER", "QOS", "REBALANCE"), args
        self.pushes.append(args[3:])
        return b"OK"


def _scripted_run(mod):
    """Four sweeps of one package's rebalancer over the same script."""
    a, b, c = _ScriptedNode(), _ScriptedNode({"carried": 3.0}), _ScriptedNode()
    rb = mod.QosRebalancer({"a": a, "b": b, "c": c}, 10_000.0, global_burst=15_000.0,
                           min_share=0.1, tenant_weights={"gold": 2.0})
    sweeps = []
    for step, table in enumerate([
        {"gold": (100, 0), "carried": (100, 0), "plain": (100, 0)},
        {"gold": (900, 0), "carried": (140, 60), "plain": (100, 0)},
        {"gold": (950, 400), "carried": (1000, 60), "plain": (5000, 0)},
        {"gold": (950, 400), "carried": (1000, 60), "plain": (5000, 0)},
    ]):
        for i, node in enumerate((a, b, c)):
            node.tenants = {t: (adm * (i + 1), shed) for t, (adm, shed) in table.items()}
        c.dead = step == 2
        sweeps.append(rb.step())
    return sweeps, [n.pushes for n in (a, b, c)], rb.sweeps, rb.push_errors


def test_rebalancer_pushes_what_the_reference_pushes():
    got, want = _scripted_run(Q), _scripted_run(RQ)
    assert got == want
    sweeps, pushes, n, errors = got
    assert n == 4 and errors == 0 and sweeps[0] == {}
    assert sum(sweeps[1]["gold"].values()) == pytest.approx(20_000.0)
    assert sum(sweeps[1]["carried"].values()) == pytest.approx(30_000.0)
    assert set(sweeps[2]["plain"]) == {"a", "b"}  # c was down
    assert all(p[-2:] == ("WEIGHT", "2") for p in pushes[0] if p[0] == "gold")


def _conn_factory(node):
    def open_conn():
        return closing(Connection(node.server.server.host, node.server.server.port, timeout=30.0))
    return open_conn


def test_rebalancer_over_a_port_runner_fleet():
    """Three in-process port masters: demand on one tenant's hashtag lands
    on its slot's master, which gets nearly the whole budget, and the
    splits sum to the global rate times the weight."""
    runner = ClusterRunner(masters=3, device="cpu").run()
    try:
        rb = Q.QosRebalancer({m.address: _conn_factory(m) for m in runner.masters},
                             30_000.0, tenant_weights={"hog": 1.5})
        assert rb.step() == {}
        client = runner.client(scan_interval=0)
        try:
            client.execute("BF.RESERVE", "ft{hog}", 0.01, 10_000)
            rb.step()  # the tenant's baseline on every node
            for i in range(4):
                client.execute("BF.MADD64", "ft{hog}", (np.arange(200, dtype=np.int64) + i * 1000).tobytes())
        finally:
            client.shutdown()
        split = rb.step()["hog"]
        assert sum(split.values()) == pytest.approx(45_000.0, rel=1e-9)
        owner = max(split, key=split.get)
        assert split[owner] > 0.9 * 45_000.0
        node = next(m for m in runner.masters if m.address == owner)
        ts = node.server.server.scheduler._tenants["hog"]
        assert ts.bucket.rate == pytest.approx(split[owner]) and ts.weight == 1.5
    finally:
        runner.shutdown()


def test_supervisor_rebalance_over_port_processes():
    """start_qos_rebalance on a 3-master process fleet on the CPU: the loop
    thread baselines, the driven sweeps push splits that sum to the global
    rate, and shutdown stops the loop."""
    with _torch_port_suite.time_limit(120):
        sup = ClusterSupervisor(masters=3, platform="cpu").start()
        try:
            rb = sup.start_qos_rebalance(12_000.0, interval=3600.0)
            deadline = time.time() + 10.0
            while rb.sweeps < 1 and time.time() < deadline:
                time.sleep(0.02)
            assert rb.sweeps >= 1
            client = sup.client()
            try:
                assert client.wait_routable(timeout=30.0)
                client.execute("BF.RESERVE", "q{acme}", 0.01, 10_000)
                rb.step()
                for i in range(3):
                    client.execute("BF.MADD64", "q{acme}", (np.arange(300, dtype=np.int64) + i).tobytes())
            finally:
                client.shutdown()
            split = rb.step()["acme"]
            # the nodes that saw the tenant: its slot's master at least
            assert split and set(split) <= {m.address for m in sup.masters}
            assert sum(split.values()) == pytest.approx(12_000.0, rel=1e-9)
        finally:
            sup.shutdown()
        assert sup._qos_rebalancer is None and rb._thread is None


def test_occupancy_balancer_scores_a_port_fleet_by_cluster_qos():
    """The port serves CLUSTER QOS, so the occupancy balancer reads a
    loaded node's in-flight ops and picks an idle one; without the view
    every node scored stale and the pick fell to round robin (the loaded
    node first)."""
    runner = ClusterRunner(masters=3, device="cpu").run()
    clients = [NodeClient(m.address, timeout=10.0) for m in runner.masters]
    loaded = runner.masters[0].server.server.scheduler
    adm = Admission("bulk", "hog", 5000, 40_000)
    loaded.begin(adm)
    try:
        bal = OccupancyLoadBalancer(scrape_interval=0.0)
        for c in clients:
            bal._scrape(c)
        # each view counts the probe itself in flight (one op)
        scores = [bal.score(c) for c in clients]
        assert scores == [5001.0, 1.0, 1.0]
        picked = {bal.pick(clients).address for _ in range(6)}
        assert picked and clients[0].address not in picked
    finally:
        loaded.end(adm)
        for c in clients:
            c.close()
        runner.shutdown()
