"""DNSMonitor: periodic A-record re-resolution for topology endpoints.

Parity target: ``org/redisson/connection/DNSMonitor.java`` (208 LoC) — the
reference re-resolves master/slave hostnames on an interval and triggers
`changeMaster` / slave up-down when an address flips (cloud endpoints move
behind stable names).  Here the monitor watches any set of `host:port`
endpoints and invokes a callback with (endpoint, old_ips, new_ips); the
cluster client wires it to `refresh_topology` so moved nodes reconnect.
Numeric-IP endpoints are skipped (nothing to re-resolve).

A copy of ``redisson_tpu/net/dns.py``.
"""
from __future__ import annotations

import socket
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def _resolve(host: str) -> List[str]:
    try:
        infos = socket.getaddrinfo(host, None, family=socket.AF_UNSPEC, type=socket.SOCK_STREAM)
    except OSError:
        return []
    return sorted({info[4][0] for info in infos})


def _is_numeric(host: str) -> bool:
    try:
        socket.inet_pton(socket.AF_INET, host)
        return True
    except OSError:
        pass
    try:
        socket.inet_pton(socket.AF_INET6, host.strip("[]"))
        return True
    except OSError:
        return False


def _host_of(endpoint: str) -> str:
    """Endpoint -> bare hostname: scheme stripped FIRST (else the scheme's
    colon wins the port rsplit for port-less endpoints), then the port, with
    bracketed IPv6 respected."""
    host = endpoint
    for prefix in ("tpu://", "redis://", "rediss://"):
        if host.startswith(prefix):
            host = host[len(prefix):]
            break
    if host.startswith("["):  # [v6addr]:port
        return host[1:].split("]", 1)[0]
    if host.count(":") == 1:  # host:port (bare v6 has >= 2 colons)
        host = host.rsplit(":", 1)[0]
    return host


class DNSMonitor:
    def __init__(
        self,
        endpoints: Sequence[str],
        on_change: Callable[[str, List[str], List[str]], None],
        interval: float = 5.0,
    ):
        self.interval = interval
        self.on_change = on_change
        self._host_by_ep: Dict[str, str] = {}  # parsed once, reused per sweep
        self._hosts: Dict[str, List[str]] = {}
        for ep in endpoints:
            host = _host_of(ep)
            if not _is_numeric(host):
                self._host_by_ep[ep] = host
                self._hosts[ep] = _resolve(host)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watched(self) -> List[str]:
        return list(self._hosts)

    def start(self) -> "DNSMonitor":
        if self._hosts and self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True, name="rtpu-dns")
            self._thread.start()
        return self

    def check_once(self) -> List[Tuple[str, List[str], List[str]]]:
        """One sweep; returns [(endpoint, old, new)] for every change."""
        changes = []
        for ep in list(self._hosts):
            new = _resolve(self._host_by_ep[ep])
            old = self._hosts[ep]
            if new and new != old:
                self._hosts[ep] = new
                changes.append((ep, old, new))
                try:
                    self.on_change(ep, old, new)
                except Exception:  # noqa: BLE001 — callback must not kill the loop
                    pass
        return changes

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.check_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
