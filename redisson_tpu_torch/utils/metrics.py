"""Metrics registry + command-hook SPI (observability, SURVEY.md §5.1/§5.5).

Reference parity: OSS Redisson exposes no metrics registry (PRO feature);
what exists is the `NettyHook` SPI (``client/NettyHook.java``, wired at
``RedisClient.java:141``) as the sanctioned instrumentation point, plus
micrometer binders for Spring caches.  Here observability is first-class:

  * `MetricsRegistry` — counters, gauges, timers with streaming quantile
    snapshots; renders Prometheus text exposition (`prometheus_text`).
  * `CommandHook` — the NettyHook analog one layer up (exactly where the
    BASELINE north star's "CommandExecutor plugin" sits): on_start/on_end
    around every dispatched command, server- or client-side.

Zero deps: quantiles come from a bounded reservoir (ring buffer), good
enough for p50/p99 dashboards without a HDR histogram dependency.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], float]):
        self.fn = fn


class Timer:
    """Latency reservoir: bounded ring of recent samples + total counters."""

    __slots__ = ("count", "total_s", "_ring", "_idx", "_lock", "_size")

    def __init__(self, reservoir: int = 2048):
        self.count = 0
        self.total_s = 0.0
        self._ring = np.zeros(reservoir, np.float64)
        self._idx = 0
        self._size = reservoir
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self._ring[self._idx % self._size] = seconds
            self._idx += 1

    def quantiles(self, qs=(50, 99)) -> Dict[int, float]:
        with self._lock:
            n = min(self._idx, self._size)
            if n == 0:
                return {q: 0.0 for q in qs}
            samples = self._ring[:n].copy()
        return {q: float(np.percentile(samples, q)) for q in qs}


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._multi_gauges: Dict[str, Callable[[], Dict[str, float]]] = {}
        self._timers: Dict[str, Timer] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = Gauge(fn)

    def multi_gauge(self, key: str, fn: Callable[[], Dict[str, float]]) -> None:
        """Register a LABELED gauge family: `fn` returns {row_name: value}
        and every row lands in the snapshot verbatim.  This is how dynamic
        label sets (per-device memory-ledger rows) ride the scrape —
        rows appear/disappear with the resource, so a torn-down shard's
        row vanishes instead of sticking at its last value."""
        with self._lock:
            self._multi_gauges[key] = fn

    def timer(self, name: str) -> Timer:
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                t = self._timers[name] = Timer()
            return t

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            multi = dict(self._multi_gauges)
            timers = dict(self._timers)
        for name, c in counters.items():
            out[name] = c.value
        for name, g in gauges.items():
            try:
                out[name] = float(g.fn())
            except Exception:  # noqa: BLE001 — a broken gauge must not kill scrape
                continue
        for _key, fn in multi.items():
            try:
                for name, v in fn().items():
                    out[name] = float(v)
            except Exception:  # noqa: BLE001 — same scrape-safety contract
                continue
        for name, t in timers.items():
            out[f"{name}_count"] = t.count
            out[f"{name}_total_seconds"] = t.total_s
            for q, v in t.quantiles().items():
                out[f"{name}_p{q}_seconds"] = v
        return out

    def prometheus_text(self, prefix: str = "rtpu") -> str:
        lines: List[str] = []
        for name, value in sorted(self.snapshot().items()):
            metric = f"{prefix}_{name}".replace(".", "_").replace("-", "_")
            lines.append(f"{metric} {value}")
        return "\n".join(lines) + "\n"


def merge_prometheus_texts(texts: Dict[str, str]) -> str:
    """Fleet-wide scrape merge: stamp each node's Prometheus
    exposition with a ``node="host:port"`` label and concatenate — one pane
    of glass for a multi-process cluster (``ClusterSupervisor.scrape()``
    and the ``METRICS CLUSTER`` verb both ride this, so the two scrape
    paths cannot diverge).  Lines that already carry a label set keep it
    (the node label is appended); malformed lines are dropped."""
    out: List[str] = []
    for node in sorted(texts):
        for line in texts[node].splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, _, value = line.rpartition(" ")
            if not name or not value:
                continue
            if name.endswith("}"):
                name = f'{name[:-1]},node="{node}"}}'
            else:
                name = f'{name}{{node="{node}"}}'
            out.append(f"{name} {value}")
    return "\n".join(out) + "\n"


class CommandHook:
    """SPI: subclass and override; attach via the server's or a client's
    hook lists (the NettyHook analog)."""

    def on_start(self, command: str, args) -> Optional[object]:
        """Called before dispatch; the return value is passed to on_end."""
        return None

    def on_end(self, command: str, token, error: Optional[BaseException]) -> None:
        """Called after the reply (error is the raised exception, if any)."""


class MetricsHook(CommandHook):
    """Default hook: per-command counters + latency timers into a registry."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry

    def on_start(self, command: str, args):
        return (command, time.perf_counter())

    def on_end(self, command: str, token, error):
        cmd, t0 = token
        self.registry.timer(f"command.{cmd.lower()}").record(time.perf_counter() - t0)
        self.registry.counter("commands.total").inc()
        if error is not None:
            self.registry.counter("commands.errors").inc()


def run_hooks_start(hooks, command: str, args) -> List[Tuple[CommandHook, object]]:
    tokens = []
    for h in hooks:
        try:
            tokens.append((h, h.on_start(command, args)))
        except Exception:  # noqa: BLE001 — instrumentation must not break dispatch
            continue
    return tokens

def run_hooks_end(tokens, command: str, error: Optional[BaseException]) -> None:
    for h, token in tokens:
        try:
            h.on_end(command, token, error)
        except Exception:  # noqa: BLE001
            continue
