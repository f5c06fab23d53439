"""Fleet-wide tenant budget control loop.

A copy of ``redisson_tpu/cluster/qos_control.py`` for the port's fleets;
it speaks only RESP, so it budgets a fleet of either package's servers.

Per-node ``WindowScheduler`` token buckets make a tenant's budget a PER-NODE
number: a tenant spraying all N masters of a fleet harvests N times the rate
an operator configured.  This module closes that hole with a CONTROL LOOP,
not consensus: a ``QosRebalancer`` periodically scrapes every node's
``CLUSTER QOS`` tenant table, measures each tenant's per-node demand (the
delta of the table's cumulative ``admitted + shed`` op counters between
sweeps — what the tenant ASKED for, not what it was granted, so a starved
node still attracts budget), and re-splits the tenant's GLOBAL rate across
nodes proportional to that demand.  The actuator is the new ``CLUSTER QOS
REBALANCE <tenant> <rate> [<burst>]`` admin verb, which lands on
``WindowScheduler.set_tenant_rate`` — the same per-tenant override hook the
tests use.

Control-loop discipline:

  * every node always keeps a minimum share (``min_share``) of the global
    rate, so a tenant going quiet on one node can always ramp back up there
    and be SEEN by the next demand measurement (a zero split would be a
    ratchet: no admitted ops -> no demand -> no budget, forever);
  * an unreachable node contributes no demand and receives no push that
    sweep — its last-pushed split keeps working locally (budgets degrade to
    the per-node behavior, never to zero);
  * the first sweep only baselines the counters; pushes start on the
    second, once a demand delta exists.

The loop runs the same way over a ``ClusterSupervisor`` fleet
(``supervisor.start_qos_rebalance``) or any driver-spawned fleet addressed
by host:port (``redisson_tpu_torch/tools/qos_rebalance.py``).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["QosRebalancer", "parse_tenant_table", "parse_tenant_weights",
           "split_rate"]


def parse_tenant_table(reply) -> Dict[str, Tuple[int, int]]:
    """``CLUSTER QOS`` reply -> {tenant: (admitted_ops, shed_ops)}.

    Tolerates the reply growing rows (class rows, STREAM rows) — only
    ``[b"TENANT", name, level, admitted, shed_ops, shed_frames]`` rows are
    read."""
    out: Dict[str, Tuple[int, int]] = {}
    for row in reply[3:] if isinstance(reply, (list, tuple)) else ():
        if not isinstance(row, (list, tuple)) or len(row) < 6:
            continue
        tag = row[0]
        if tag not in (b"TENANT", "TENANT"):
            continue
        name = row[1]
        if isinstance(name, (bytes, bytearray)):
            name = bytes(name).decode(errors="replace")
        out[str(name)] = (int(row[3]), int(row[4]))
    return out


def parse_tenant_weights(reply) -> Dict[str, float]:
    """``CLUSTER QOS`` reply -> {tenant: weight} for TENANT rows that carry
    the trailing weight element.  Pre-weight nodes
    (6-element rows) simply contribute nothing — callers default to 1.0."""
    out: Dict[str, float] = {}
    for row in reply[3:] if isinstance(reply, (list, tuple)) else ():
        if not isinstance(row, (list, tuple)) or len(row) < 7:
            continue
        if row[0] not in (b"TENANT", "TENANT"):
            continue
        name = row[1]
        if isinstance(name, (bytes, bytearray)):
            name = bytes(name).decode(errors="replace")
        try:
            out[str(name)] = float(row[6])
        except (TypeError, ValueError):
            continue
    return out


def split_rate(global_rate: float, demand: Dict[str, float],
               min_share: float = 0.05,
               weight: float = 1.0) -> Dict[str, float]:
    """Split one tenant's global rate across nodes proportional to demand,
    with every node floored at ``min_share`` of an even split (see module
    docstring for why the floor exists).  ``weight`` is the tenant's
    service-class multiplier (gold=2.0/silver=1.0):
    the tenant's effective global budget is ``global_rate * weight``, so a
    weight of 1.0 reproduces unweighted behavior exactly.  Shares are
    normalized so the splits always sum to that effective budget — the
    fleet-wide (weighted) budget is the invariant the loop defends."""
    if not demand:
        return {}
    budget = global_rate * max(0.0, weight)
    n = len(demand)
    floor = min_share / n
    total = sum(max(0.0, d) for d in demand.values())
    if total <= 0.0:
        return {node: budget / n for node in demand}
    shares = {
        node: max(floor, max(0.0, d) / total) for node, d in demand.items()
    }
    norm = sum(shares.values())
    return {node: budget * s / norm for node, s in shares.items()}


class QosRebalancer:
    """The control loop: scrape -> measure demand -> split -> push.

    ``conn_factories`` maps a node label (host:port) to a zero-arg callable
    returning a context-managed connection whose ``execute(*args)`` speaks
    RESP — ``ClusterSupervisor.conn`` wrapped per node, or a raw
    ``net.client.Connection`` for standalone fleets."""

    def __init__(self, conn_factories: Dict[str, Callable],
                 global_rate: float, *, global_burst: Optional[float] = None,
                 interval: float = 1.0, min_share: float = 0.05,
                 tenant_weights: Optional[Dict[str, float]] = None):
        if global_rate <= 0:
            raise ValueError("global_rate must be positive")
        self.conn_factories = dict(conn_factories)
        self.global_rate = float(global_rate)
        self.global_burst = global_burst
        self.interval = float(interval)
        self.min_share = float(min_share)
        # service-class weights: configured weights are
        # authoritative and are PUSHED to the fleet with each rebalance
        # (CLUSTER QOS REBALANCE ... WEIGHT); weights a node already
        # carries (scraped off its TENANT rows) fill in for tenants the
        # operator didn't name.  Unknown tenants weigh 1.0.
        self.tenant_weights = dict(tenant_weights or {})
        self._scraped_weights: Dict[str, float] = {}
        # node -> tenant -> cumulative demand counter at last sweep
        self._last: Dict[str, Dict[str, int]] = {}
        # tenant -> node -> rate pushed last sweep (observability + tests)
        self.last_split: Dict[str, Dict[str, float]] = {}
        self.sweeps = 0
        self.push_errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one control-loop tick (synchronous, unit-testable) -------------------

    def _scrape_node(self, node: str) -> Optional[Dict[str, Tuple[int, int]]]:
        try:
            with self.conn_factories[node]() as c:
                reply = c.execute("CLUSTER", "QOS")
        except Exception:  # noqa: BLE001 — a dead node skips this sweep
            return None
        self._scraped_weights.update(parse_tenant_weights(reply))
        return parse_tenant_table(reply)

    def weight_of(self, tenant: str) -> float:
        """Configured weight wins; a weight the fleet already carries fills
        in; everyone else is 1.0."""
        w = self.tenant_weights.get(tenant)
        if w is None:
            w = self._scraped_weights.get(tenant, 1.0)
        return max(0.0, float(w))

    def _push(self, node: str, tenant: str, rate: float,
              weight: float) -> None:
        args: List[object] = ["CLUSTER", "QOS", "REBALANCE", tenant,
                             f"{rate:.6f}"]
        if self.global_burst is not None:
            # each node's burst headroom scales with its share of the
            # tenant's WEIGHTED global budget, so the fleet-wide burst stays
            # the configured global number (times the tenant's weight)
            budget = self.global_rate * max(weight, 1e-9)
            args.append(f"{self.global_burst * rate / budget:.6f}")
        if tenant in self.tenant_weights:
            # operator-configured weights are authoritative: teach the node
            args += ["WEIGHT", f"{weight:g}"]
        try:
            with self.conn_factories[node]() as c:
                c.execute(*args)
        except Exception:  # noqa: BLE001 — degrade to the last pushed split
            self.push_errors += 1

    def step(self) -> Dict[str, Dict[str, float]]:
        """One sweep: returns {tenant: {node: pushed_rate}} (empty on the
        baseline sweep and when no tenant has traffic)."""
        tables: Dict[str, Dict[str, Tuple[int, int]]] = {}
        for node in self.conn_factories:
            t = self._scrape_node(node)
            if t is not None:
                tables[node] = t
        # demand = delta of cumulative (admitted + shed) ops since the last
        # sweep: what the tenant attempted on that node, granted or not
        demand: Dict[str, Dict[str, float]] = {}
        for node, table in tables.items():
            prev = self._last.setdefault(node, {})
            for tenant, (admitted, shed) in table.items():
                cum = admitted + shed
                if tenant in prev:
                    demand.setdefault(tenant, {})[node] = float(
                        max(0, cum - prev[tenant])
                    )
                prev[tenant] = cum
        pushed: Dict[str, Dict[str, float]] = {}
        for tenant, node_demand in demand.items():
            weight = self.weight_of(tenant)
            split = split_rate(self.global_rate, node_demand, self.min_share,
                               weight=weight)
            for node, rate in split.items():
                self._push(node, tenant, rate, weight)
            pushed[tenant] = split
        if pushed:
            self.last_split = pushed
        self.sweeps += 1
        return pushed

    # -- background thread -----------------------------------------------------

    def start(self) -> "QosRebalancer":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="qos-rebalance", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the loop must outlive a sweep
                pass
            self._stop.wait(self.interval)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
