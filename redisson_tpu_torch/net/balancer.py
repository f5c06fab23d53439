"""Load balancers for replica read routing.

Parity targets (SURVEY.md §2.2): ``connection/balancer/LoadBalancerManager``
with RoundRobinLoadBalancer (default), RandomLoadBalancer,
WeightedRoundRobinBalancer (`WeightedRoundRobinBalancer.java:153`), and
CommandsLoadBalancer (least in-flight).  Balancers pick among the healthy
NodeClients of one shard entry; the entry (client/cluster.py ShardEntry)
owns freeze/unfreeze, mirroring ``connection/MasterSlaveEntry``.

A copy of ``redisson_tpu/net/balancer.py``.  The occupancy balancer scrapes
``CLUSTER QOS``, which the port's server answers only from ROADMAP M8 part
2: until then its scrapes fail and it scores nodes by this client's own
in-flight count.
"""
from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


class LoadBalancer:
    def pick(self, nodes: Sequence) -> Optional[object]:
        raise NotImplementedError


class RoundRobinLoadBalancer(LoadBalancer):
    def __init__(self):
        self._counter = itertools.count()
        self._lock = threading.Lock()

    def pick(self, nodes: Sequence):
        if not nodes:
            return None
        with self._lock:
            i = next(self._counter)
        return nodes[i % len(nodes)]


class RandomLoadBalancer(LoadBalancer):
    def pick(self, nodes: Sequence):
        return random.choice(nodes) if nodes else None


class WeightedRoundRobinBalancer(LoadBalancer):
    """Weights map address -> positive int; unlisted nodes get default_weight.
    Node n is picked weight(n) times per cycle (the reference's weight-decay
    scheme collapsed to a static expanded cycle)."""

    def __init__(self, weights: Dict[str, int], default_weight: int = 1):
        if any(w <= 0 for w in weights.values()) or default_weight <= 0:
            raise ValueError("weights must be positive")
        self.weights = dict(weights)
        self.default_weight = default_weight
        self._rr = RoundRobinLoadBalancer()

    def pick(self, nodes: Sequence):
        if not nodes:
            return None
        expanded: List = []
        for n in nodes:
            w = self.weights.get(getattr(n, "address", None), self.default_weight)
            expanded.extend([n] * w)
        return self._rr.pick(expanded)


class CommandsLoadBalancer(LoadBalancer):
    """Least in-flight commands (CommandsLoadBalancer.java) — NodeClients
    expose in_flight() fed by their connection pools."""

    def pick(self, nodes: Sequence):
        if not nodes:
            return None
        return min(nodes, key=lambda n: getattr(n, "in_flight", lambda: 0)())


class OccupancyLoadBalancer(LoadBalancer):
    """Server-lane-occupancy balancer for replica reads: scores
    each candidate by the in-flight op count its server reports through
    ``CLUSTER QOS`` (the window scheduler's per-class ledger — what the
    device lanes are actually chewing on, including load from OTHER
    clients), scraped at most once per ``scrape_interval`` per node, PLUS
    this client's own in_flight() count, which is always current.  A node
    whose scrape keeps failing ages out after ``stale_after`` and competes
    on local in-flight alone; exact ties break round-robin so equally idle
    replicas share the read load instead of pinning the first.

    The scraped count already CONTAINS this client's own in-flight ops on
    that node (they sit in the server's ledger like anyone else's), so the
    score books them apart: ``others = scraped - own_at_scrape_time`` stays
    fixed until the next scrape while ``own`` is re-read live on every
    pick.  Without the split a stale snapshot both double-counts own load
    and herds the fleet onto whichever replica happened to look idle at
    scrape time for a full scrape interval."""

    def __init__(self, scrape_interval: float = 0.5,
                 stale_after: float = 5.0, probe_timeout: float = 1.0):
        self.scrape_interval = scrape_interval
        self.stale_after = stale_after
        self.probe_timeout = probe_timeout
        # addr -> (total_ops_scraped, data_ts, own_in_flight_at_scrape)
        self._scores: Dict[str, Tuple[float, float, float]] = {}
        # addr -> last probe ATTEMPT (throttle clock, kept apart from the
        # data clock above: a failing probe must not re-freshen the stale
        # snapshot it failed to replace, or a dead node never ages out)
        self._probed: Dict[str, float] = {}
        self._rr = RoundRobinLoadBalancer()
        self._lock = threading.Lock()

    @staticmethod
    def _qos_infl_ops(reply) -> float:
        """Sum of in-flight ops across deadline classes from a CLUSTER QOS
        reply ([armed, shed_ops, shed_frames, [class, infl_frames,
        infl_ops, infl_bytes]..., [TENANT,...]...])."""
        total = 0.0
        for row in reply[3:]:
            if isinstance(row, (list, tuple)) and len(row) >= 3 \
                    and row[0] in (b"interactive", b"bulk",
                                   "interactive", "bulk"):
                total += float(row[2])
        return total

    def _scrape(self, node) -> None:
        addr = getattr(node, "address", None)
        if addr is None:
            return
        with self._lock:
            # reserve the probe slot first: concurrent picks must not
            # stampede the same node with probe round-trips
            if time.monotonic() - self._probed.get(addr, 0.0) < self.scrape_interval:
                return
            self._probed[addr] = time.monotonic()
        try:
            reply = node.execute("CLUSTER", "QOS", timeout=self.probe_timeout,
                                 retry_attempts=0)
            score = self._qos_infl_ops(reply)
        except Exception:  # noqa: BLE001 — unreachable node scores stale
            return
        own = float(getattr(node, "in_flight", lambda: 0)())
        with self._lock:
            self._scores[addr] = (score, time.monotonic(), own)

    def score(self, node) -> float:
        now = time.monotonic()
        with self._lock:
            ent = self._scores.get(getattr(node, "address", ""))
        others = 0.0
        if ent is not None and now - ent[1] < self.stale_after:
            others = max(0.0, ent[0] - ent[2])
        return others + float(getattr(node, "in_flight", lambda: 0)())

    def pick(self, nodes: Sequence):
        if not nodes:
            return None
        if len(nodes) == 1:
            return nodes[0]
        for n in nodes:
            self._scrape(n)
        # power-of-two-choices: score only a random pair and take the lower.
        # Full-argmin herds — N concurrent picks all see the same minimum
        # before any of their checkouts registers in in_flight, so a wave
        # of requests queues on one replica while the others idle.  A
        # random pair keeps concurrent picks spread while still steering
        # away from genuinely loaded nodes (the classic stale-signal
        # balancing result).
        if len(nodes) > 2:
            candidates = random.sample(list(nodes), 2)
        else:
            candidates = list(nodes)
        best: List = []
        best_score: Optional[float] = None
        for n in candidates:
            s = self.score(n)
            if best_score is None or s < best_score - 1e-9:
                best, best_score = [n], s
            elif abs(s - best_score) <= 1e-9:
                best.append(n)
        return self._rr.pick(best)
