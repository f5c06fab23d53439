"""Standalone fleet-wide device-memory pressure rebalancer, on the port's
``Connection`` (a copy of the repository's ``tools/residency_rebalance.py``).

Runs the cluster/residency_control.py control loop against ANY fleet
addressed by host:port — sidecar-style, like tools/qos_rebalance.py: scrape
every node's ``CLUSTER RESIDENCY`` per-device tier ledgers, ask pressured
devices to demote first (``CLUSTER RESIDENCY SWEEP``), and shed devices
whose HOT working set outgrows the budget through the journaled fenced
device rebalance (``CLUSTER RESIDENCY SHED``).

    python -m redisson_tpu_torch.tools.residency_rebalance 127.0.0.1:7000 127.0.0.1:7001 \
        --interval 1.0 --high-water 0.9 --shed-count 64

Runs until interrupted; ``--sweeps N`` exits after N sweeps (smoke/CI use).
"""
from __future__ import annotations

import argparse
import sys
import time
from contextlib import closing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fleet-wide device-memory pressure rebalancer"
    )
    ap.add_argument("nodes", nargs="+", metavar="HOST:PORT",
                    help="nodes whose device ledgers to defend")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between control-loop sweeps")
    ap.add_argument("--high-water", type=float, default=0.9,
                    help="pressure threshold as a fraction of the budget")
    ap.add_argument("--shed-after", type=int, default=2,
                    help="consecutive pressured sweeps before a shed")
    ap.add_argument("--shed-count", type=int, default=8,
                    help="slots moved per shed step")
    ap.add_argument("--journal-dir", default=None,
                    help="journal directory passed to SHED (resumable)")
    ap.add_argument("--budget", type=int, default=None,
                    help="override per-device byte budget (default: trust "
                         "each node's device-budget-bytes)")
    ap.add_argument("--password", default=None)
    ap.add_argument("--ca-cert", default=None, metavar="PEM",
                    help="fleet CA certificate: speak TLS to the nodes")
    ap.add_argument("--sweeps", type=int, default=0,
                    help="exit after this many sweeps (0 = run forever)")
    args = ap.parse_args(argv)

    from redisson_tpu_torch.cluster.residency_control import ResidencyRebalancer
    from redisson_tpu_torch.net.client import Connection

    ssl_context = None
    if args.ca_cert:
        from redisson_tpu_torch.net.client import client_ssl_context

        ssl_context = client_ssl_context(
            ca_file=args.ca_cert, verify_hostname=False,
        )

    def factory(addr: str):
        host, _, port = addr.rpartition(":")

        def open_conn():
            return closing(Connection(host, int(port), timeout=10.0,
                                      password=args.password,
                                      ssl_context=ssl_context))

        return open_conn

    rb = ResidencyRebalancer(
        {a: factory(a) for a in args.nodes},
        interval=args.interval, high_water=args.high_water,
        shed_after=args.shed_after, shed_count=args.shed_count,
        journal_dir=args.journal_dir, budget_bytes=args.budget,
    )
    n = 0
    try:
        while True:
            actions = rb.step()
            n += 1
            for node, action, dev in actions:
                print(f"[sweep {n}] {node} dev{dev}: {action}", flush=True)
            if args.sweeps and n >= args.sweeps:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
