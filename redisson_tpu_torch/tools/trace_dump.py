"""Per-stage waterfall dump of the server's trace ring, on the port's
``Connection`` (a copy of the repository's ``tools/trace_dump.py``).

Pulls ``TRACE GET`` over the wire and renders each frame trace as an ASCII
waterfall — one bar per stage span, offset/scaled against the frame's total
(client-observable) latency — so "WHERE did this frame's p99 go?" is
answerable from a terminal:

    $ python -m redisson_tpu_torch.tools.trace_dump --port 6390 --n 5 --by total
    trace 184  BF.MEXISTS64 x1  total 63.1ms  class=interactive tenant=ta
      parse      0.0ms |#                                                 |
      qos        0.1ms |#                                                 |
      dispatch  12.4ms |....#########                                     |
      readback  48.9ms |.............###################################  |
      reply      1.2ms |..............................................### |

Arm tracing first (``CONFIG SET trace-enabled yes`` / ``RTPU_TRACE=1``);
``--by <stage>`` orders by one stage's summed duration (e.g. ``--by qos``
surfaces the frames that sat longest behind admission).  ``--json`` emits
the raw entries for dashboards.
"""
from __future__ import annotations

import argparse
import json
import sys

WIDTH = 50


def _b(x) -> str:
    return x.decode(errors="replace") if isinstance(x, (bytes, bytearray)) else str(x)


def render_trace(entry, width: int = WIDTH) -> str:
    """One wire trace entry -> waterfall text (entry shape: [id, unix_ms,
    total_us, verb, n_cmds, class, tenant, [[name, off, dur, attrs]...]])."""
    tid, _ts_ms, total_us, verb, n_cmds, cls, tenant, spans = entry
    total_us = max(int(total_us), 1)
    head = (
        f"trace {tid}  {_b(verb)} x{int(n_cmds)}  "
        f"total {total_us / 1000:.1f}ms"
    )
    if _b(cls):
        head += f"  class={_b(cls)}"
    if _b(tenant):
        head += f"  tenant={_b(tenant)}"
    lines = [head]
    for name, off_us, dur_us, attrs in spans:
        name = _b(name)
        if name.endswith(".member"):
            continue  # members duplicate their kernel span's interval
        lo = min(width, int(int(off_us) * width / total_us))
        ln = max(1, int(int(dur_us) * width / total_us))
        bar = "." * lo + "#" * min(ln, width - lo)
        bar += " " * (width - len(bar))
        extra = ""
        if attrs:
            kv = [
                f"{_b(attrs[i])}={_b(attrs[i + 1])}"
                for i in range(0, len(attrs), 2)
            ]
            extra = "  " + ",".join(kv)
        lines.append(
            f"  {name:<9}{int(dur_us) / 1000:>8.1f}ms |{bar}|{extra}"
        )
    return "\n".join(lines)


def fetch(host: str, port: int, n: int, by: str, password=None):
    from redisson_tpu_torch.net.client import Connection

    conn = Connection(host, port, timeout=30.0, password=password)
    try:
        return conn.execute("TRACE", "GET", str(n), "BY", by, timeout=30.0)
    finally:
        conn.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6390)
    ap.add_argument("--password", default=None)
    ap.add_argument("--n", type=int, default=10, help="slowest-N traces")
    ap.add_argument(
        "--by", default="total",
        help="order by 'total' or one stage's summed duration "
             "(qos/stage/dispatch/kernel/readback/reply)",
    )
    ap.add_argument("--json", action="store_true", help="raw entries as JSON")
    args = ap.parse_args(argv)

    entries = fetch(args.host, args.port, args.n, args.by, args.password)
    if not entries:
        print(
            "trace ring is empty — arm tracing first: "
            "CONFIG SET trace-enabled yes (or RTPU_TRACE=1)",
            file=sys.stderr,
        )
        return 1
    if args.json:
        def clean(x):
            if isinstance(x, (bytes, bytearray)):
                return x.decode(errors="replace")
            if isinstance(x, list):
                return [clean(v) for v in x]
            return x

        print(json.dumps([clean(e) for e in entries], indent=1))
        return 0
    for e in entries:
        print(render_trace(e))
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
