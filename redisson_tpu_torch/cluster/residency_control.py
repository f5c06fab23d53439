"""Fleet-wide device-memory pressure control loop.

A copy of ``redisson_tpu/cluster/residency_control.py`` for the port's
fleets; it speaks only RESP, so it drives a fleet of either package's
servers.

The per-node residency sweeper keeps each device (each position, with
placement on) under its byte budget by DEMOTING cold records, but demotion
only helps while a device still has demotable (clean, idle) bytes.  A
device whose HOT working set itself outgrows the budget needs records to
live somewhere else, and the only safe way to move them is the journaled
fenced device rebalance.  This module closes that loop with the shape of
:class:`~redisson_tpu_torch.cluster.qos_control.QosRebalancer`, a CONTROL
LOOP, not consensus:

  * every sweep scrapes each node's ``CLUSTER RESIDENCY`` ledger (per-device
    hot/warm/cold bytes and the node's budget);
  * a device whose HOT bytes exceed ``high_water * budget`` is PRESSURED:
    the first response is ``CLUSTER RESIDENCY SWEEP`` (demote first: the
    relief is free, nothing moves across devices);
  * a device still pressured after ``shed_after`` consecutive sweeps has a
    working set demotion cannot fix: the loop issues ``CLUSTER RESIDENCY
    SHED <dev> COUNT <n>``, moving a bounded bite of the device's slots onto
    the survivors through the journaled fenced rebalance (keyed traffic on
    the moving slots rides the TRYAGAIN fence; acked writes are not lost);
  * an unreachable node contributes nothing and receives nothing that sweep
    (its local sweeper keeps the device bounded).

Runs over any fleet addressed by connection factories, the
``QosRebalancer`` contract (``ClusterSupervisor.conn`` wrapped a node, or a
raw ``net.client.Connection`` in ``contextlib.closing``).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["ResidencyRebalancer", "parse_residency_table"]


def parse_residency_table(reply) -> Tuple[bool, int, Dict[int, Tuple[int, int, int]]]:
    """``CLUSTER RESIDENCY`` reply -> (armed, budget_bytes,
    {dev: (hot, warm, cold)}).

    Tolerates the reply growing rows — only ``[b"DEV", dev, hot, warm,
    cold]`` rows are read; the trailing CTR row is skipped."""
    armed = False
    budget = 0
    devs: Dict[int, Tuple[int, int, int]] = {}
    if not isinstance(reply, (list, tuple)) or len(reply) < 2:
        return armed, budget, devs
    armed = bool(int(reply[0]))
    budget = int(reply[1])
    for row in reply[2:]:
        if not isinstance(row, (list, tuple)) or len(row) < 5:
            continue
        if row[0] not in (b"DEV", "DEV"):
            continue
        devs[int(row[1])] = (int(row[2]), int(row[3]), int(row[4]))
    return armed, budget, devs


class ResidencyRebalancer:
    """The control loop: scrape ledgers -> detect pressure -> demote-first
    -> shed persistent pressure through the journaled device rebalance."""

    def __init__(self, conn_factories: Dict[str, Callable], *,
                 interval: float = 1.0, high_water: float = 0.9,
                 shed_after: int = 2, shed_count: int = 8,
                 journal_dir: Optional[str] = None,
                 budget_bytes: Optional[int] = None):
        if not 0.0 < high_water <= 1.0:
            raise ValueError("high_water must be in (0, 1]")
        self.conn_factories = dict(conn_factories)
        self.interval = float(interval)
        self.high_water = float(high_water)
        self.shed_after = max(1, int(shed_after))
        self.shed_count = max(1, int(shed_count))
        self.journal_dir = journal_dir
        # None = trust each node's scraped budget; an explicit number
        # overrides (the operator's fleet-wide per-device ceiling)
        self.budget_bytes = budget_bytes
        # (node, dev) -> consecutive pressured sweeps
        self._pressure: Dict[Tuple[str, int], int] = {}
        # observability + tests: what the last step actually did
        self.last_actions: List[Tuple[str, str, int]] = []
        self.sweeps = 0
        self.sweeps_issued = 0
        self.sheds_issued = 0
        self.push_errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one control-loop tick (synchronous, unit-testable) -------------------

    def _scrape_node(self, node: str):
        try:
            with self.conn_factories[node]() as c:
                reply = c.execute("CLUSTER", "RESIDENCY")
        except Exception:  # noqa: BLE001 — a dead node skips this sweep
            return None
        return parse_residency_table(reply)

    def _issue(self, node: str, *args) -> bool:
        try:
            with self.conn_factories[node]() as c:
                c.execute(*args)
            return True
        except Exception:  # noqa: BLE001 — degrade to the node's own sweeper
            self.push_errors += 1
            return False

    def step(self) -> List[Tuple[str, str, int]]:
        """One sweep: returns the actions taken as (node, action, dev)
        tuples, action in {"sweep", "shed"}."""
        actions: List[Tuple[str, str, int]] = []
        for node in self.conn_factories:
            scraped = self._scrape_node(node)
            if scraped is None:
                continue
            armed, node_budget, devs = scraped
            budget = (self.budget_bytes if self.budget_bytes is not None
                      else node_budget)
            if not armed or budget <= 0:
                # nothing to defend: clear any stale pressure bookkeeping
                for key in [k for k in self._pressure if k[0] == node]:
                    del self._pressure[key]
                continue
            ceiling = self.high_water * budget
            for dev, (hot, _warm, _cold) in sorted(devs.items()):
                key = (node, dev)
                if hot <= ceiling:
                    self._pressure.pop(key, None)
                    continue
                streak = self._pressure.get(key, 0) + 1
                self._pressure[key] = streak
                if streak < self.shed_after:
                    # demote-first: ask the node to sweep before anything
                    # crosses a device boundary
                    if self._issue(node, "CLUSTER", "RESIDENCY", "SWEEP"):
                        self.sweeps_issued += 1
                        actions.append((node, "sweep", dev))
                else:
                    shed: List[object] = ["CLUSTER", "RESIDENCY", "SHED",
                                          str(dev), "COUNT",
                                          str(self.shed_count)]
                    if self.journal_dir:
                        shed += ["DIR", self.journal_dir]
                    if self._issue(node, *shed):
                        self.sheds_issued += 1
                        actions.append((node, "shed", dev))
                        self._pressure[key] = 0
        self.last_actions = actions
        self.sweeps += 1
        return actions

    # -- background thread -----------------------------------------------------

    def start(self) -> "ResidencyRebalancer":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="residency-rebalance", daemon=True
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
