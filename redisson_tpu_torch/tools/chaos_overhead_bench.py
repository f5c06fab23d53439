"""Chaos-hook overhead microbenchmark, on the port (a copy of the
repository's ``tools/chaos_overhead_bench.py``).

Measures the zero-cost contract of the ``net/client.py`` fault-plane event
sites: with no plane installed, the per-event cost must be
indistinguishable from a build with the hooks deleted.  Three variants run
the same pipelined PING workload against one in-process port server over
real sockets:

  shipped/none      — the shipped Connection, no fault plane installed
                      (the production state: one global load + `is None`
                      per event);
  shipped/empty     — the shipped Connection with an EMPTY FaultPlane
                      installed (every event consults the plane, no fault
                      fires: the chaos-idle state, allowed to cost more);
  stripped          — a Connection subclass whose send/read_reply are the
                      shipped code with the fault-plane lines deleted (the
                      hooks-never-existed baseline).

Run:  python -m redisson_tpu_torch.tools.chaos_overhead_bench
          [--batches 50] [--pipeline 500] [--rounds 3] [--device cpu]

The server's engine lives on the card unless ``--device`` says otherwise
(PING touches no device).  Output: ops/s per variant and the
shipped/none : stripped ratio.  Parity is a ratio >= 0.97 over the socket
path (the rest of the spread is syscall noise; the allocation-level check
is ``tests/test_torch_faults.py``).  Exit code 1 when parity is missed.
"""
from __future__ import annotations

import argparse
import socket
import time

from redisson_tpu_torch.net import client as net
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.net.client import CommandTimeoutError, Connection, ConnectionError_


class StrippedConnection(Connection):
    """The shipped Connection minus every fault-plane line: the
    hooks-deleted baseline the parity claim is measured against."""

    def send(self, *args) -> None:
        try:
            self._sock.sendall(resp.encode_command(*args))
        except (OSError, ValueError) as e:
            self.close()
            raise ConnectionError_(f"send to {self.host}:{self.port} failed: {e}") from e

    def read_reply(self, timeout=None):
        deadline = time.monotonic() + (timeout if timeout is not None else self.timeout)
        while True:
            while self._pending:
                value = self._pending.popleft()
                if isinstance(value, resp.Push) and self.push_handler is not None:
                    self.push_handler(value)
                    continue
                return value
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise CommandTimeoutError("no response within budget")
            self._sock.settimeout(remaining)
            try:
                data = self._sock.recv(1 << 16)
            except socket.timeout:
                raise CommandTimeoutError("no response within budget") from None
            except OSError as e:
                self.close()
                raise ConnectionError_(f"read failed: {e}") from e
            if not data:
                self.close()
                raise ConnectionError_("connection closed by peer")
            self._pending.extend(self._parser.feed(data))

    def execute_many(self, commands, timeout=None):
        if not commands:
            return []
        payload = b"".join(resp.encode_command(*c) for c in commands)
        try:
            self._sock.sendall(payload)
        except OSError as e:
            self.close()
            raise ConnectionError_(f"send failed: {e}") from e
        return [self.read_reply(timeout) for _ in commands]


def _drive(conn, batches: int, pipeline: int) -> float:
    cmds = [("PING",)] * pipeline
    conn.execute_many(cmds)  # warm
    t0 = time.perf_counter()
    for _ in range(batches):
        conn.execute_many(cmds)
    wall = time.perf_counter() - t0
    return batches * pipeline / wall


def measure(batches: int = 50, pipeline: int = 500, rounds: int = 3,
            device: str = "cuda") -> dict:
    """{variant: best ops/s} over `rounds` interleaved rounds, and
    ``ratio`` = shipped/none over stripped."""
    from redisson_tpu_torch.chaos.faults import FaultSchedule
    from redisson_tpu_torch.server.server import ServerThread

    results: dict = {}
    with ServerThread(port=0, device=device) as st:
        host, port = st.server.host, st.server.port

        def fresh(cls):
            return cls(host, port, timeout=30.0)

        assert net._fault_plane is None, "a fault plane is already installed"
        # interleaved best-of-N rounds: a single pass per variant is
        # dominated by run order (the server's pool warm-up, allocator
        # state); alternating rounds and keeping each variant's best gives
        # every variant the same best-case transport
        for _round in range(rounds):
            conn = fresh(Connection)
            r = _drive(conn, batches, pipeline)
            results["shipped/none"] = max(results.get("shipped/none", 0.0), r)
            conn.close()

            with FaultSchedule(seed=0).plane().active():
                conn = fresh(Connection)
                r = _drive(conn, batches, pipeline)
                results["shipped/empty-plane"] = max(
                    results.get("shipped/empty-plane", 0.0), r
                )
                conn.close()

            conn = fresh(StrippedConnection)
            r = _drive(conn, batches, pipeline)
            results["stripped"] = max(results.get("stripped", 0.0), r)
            conn.close()
    results["ratio"] = results["shipped/none"] / results["stripped"]
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=50)
    ap.add_argument("--pipeline", type=int, default=500)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="the server engine's device (default: the card)")
    args = ap.parse_args(argv)
    results = measure(args.batches, args.pipeline, args.rounds, args.device)
    ratio = results.pop("ratio")
    for name, rate in results.items():
        print(f"{name:>20}: {rate/1e3:8.1f}k ops/s")
    print(f"{'none/stripped':>20}: {ratio:8.3f}x  "
          f"({'PARITY MET' if ratio >= 0.97 else 'PARITY MISSED'})")
    return 0 if ratio >= 0.97 else 1


if __name__ == "__main__":
    raise SystemExit(main())
