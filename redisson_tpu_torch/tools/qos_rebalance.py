"""Standalone fleet-wide tenant QoS rebalancer, on the port's ``Connection``
(a copy of the repository's ``tools/qos_rebalance.py``).

Runs the cluster/qos_control.py control loop against ANY fleet addressed by
host:port — driver-spawned clusters whose supervisor lives in another
process (or no process at all), exactly like a sidecar: scrape every node's
``CLUSTER QOS`` tenant table, re-split each tenant's global rate across
nodes proportional to observed demand, push the split via ``CLUSTER QOS
REBALANCE``.

    python -m redisson_tpu_torch.tools.qos_rebalance 127.0.0.1:7000 127.0.0.1:7001 \
        --rate 100000 --burst 150000 --interval 1.0

Runs until interrupted; ``--sweeps N`` exits after N sweeps (smoke/CI use).
"""
from __future__ import annotations

import argparse
import sys
import time
from contextlib import closing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="fleet-wide tenant QoS rebalancer")
    ap.add_argument("nodes", nargs="+", metavar="HOST:PORT",
                    help="master nodes to budget across")
    ap.add_argument("--rate", type=float, required=True,
                    help="each tenant's GLOBAL ops/s budget across the fleet")
    ap.add_argument("--burst", type=float, default=None,
                    help="global burst headroom (split with the rate)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between control-loop sweeps")
    ap.add_argument("--min-share", type=float, default=0.05,
                    help="minimum fraction of an even split every node keeps")
    ap.add_argument("--password", default=None)
    ap.add_argument("--ca-cert", default=None, metavar="PEM",
                    help="fleet CA certificate: speak TLS to the nodes "
                         "(cross-host driver fleets arm TLS by default; "
                         "point this at the supervisor's tls/fleet.crt)")
    ap.add_argument("--weight", action="append", default=[],
                    metavar="TENANT=W",
                    help="per-tenant service-class weight (repeatable, e.g. "
                         "--weight gold=2.0 --weight silver=1.0); scales "
                         "that tenant's global budget and is pushed "
                         "fleet-wide via REBALANCE ... WEIGHT")
    ap.add_argument("--sweeps", type=int, default=0,
                    help="exit after this many sweeps (0 = run forever)")
    args = ap.parse_args(argv)

    from redisson_tpu_torch.cluster.qos_control import QosRebalancer
    from redisson_tpu_torch.net.client import Connection

    weights = {}
    for spec in args.weight:
        tenant, sep, w = spec.partition("=")
        if not sep or not tenant:
            ap.error(f"--weight expects TENANT=W, got {spec!r}")
        try:
            weights[tenant] = float(w)
        except ValueError:
            ap.error(f"--weight {spec!r}: weight is not a float")

    ssl_context = None
    if args.ca_cert:
        from redisson_tpu_torch.net.client import client_ssl_context

        # fleet peers are addressed by IP/label: the chain pin (not the
        # hostname) is what keeps foreign certs out, same as the supervisor
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

    rb = QosRebalancer(
        {a: factory(a) for a in args.nodes}, args.rate,
        global_burst=args.burst, interval=args.interval,
        min_share=args.min_share, tenant_weights=weights,
    )
    n = 0
    try:
        while True:
            pushed = rb.step()
            n += 1
            for tenant, split in sorted(pushed.items()):
                parts = ", ".join(
                    f"{node}={rate:.0f}" for node, rate in sorted(split.items())
                )
                print(f"[sweep {n}] {tenant}: {parts}", flush=True)
            if args.sweeps and n >= args.sweeps:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
