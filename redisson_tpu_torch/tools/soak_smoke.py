"""A short soak for a sanity check, on the port (a copy of the
repository's ``tools/soak_smoke.py``): one run of one of the twelve
harnesses of ``redisson_tpu_torch/chaos/soak.py``.

Profiles:

  * ``standard`` (default): one full chaos cycle (workload under injected
    transport faults, master kill, automatic failover, recovery, and the
    embedded sharded bloom array's reshard 4 -> 8 -> 4 when there are 8
    mesh positions) with the zero-acked-write-loss and flat-census
    assertions of the slow endurance tier;
  * ``migration``: the journaled migration coordinator killed at every
    phase boundary (PLANNED, WINDOW_OPEN, mid-DRAINING, VIEW_COMMITTED) and
    resumed under a mixed write stream, plus torn-write/ENOSPC checkpoint
    chaos: zero acked-write loss, no slot left non-STABLE, bit-identical
    record contents, checkpoint generation fallback, flat census;
  * ``cluster-proc``: server OS processes under a ClusterSupervisor; the
    coordinator dies mid-drain and the source master takes a real SIGKILL
    (``--replicas n`` adds replica processes and a read_mode=replica
    reader);
  * ``fleet``: replica-covered process masters under client-side faults
    take a rolling restart, a coordinator+target double kill, a replica
    promotion carrying an import window, and a live-coordinator target
    SIGKILL;
  * ``fleet-host``: the fleet over two host labels through the ssh driver's
    pipeline (loopback transport), TLS armed; the import target's whole
    host is SIGKILLed and partitioned mid-drain;
  * ``tracking``: zipf readers with server-assisted near caches while
    key-bearing slots migrate m0 -> m1 -> m0 and the write-owning master
    fails over: zero stale tracked reads;
  * ``read-scale``: the same readers served from replicas, with a replica
    kill (reads drain to the master) and a master failover;
  * ``device-shard``: one server on the mesh positions, its slot table
    rebalanced 8 -> 4 -> 8 under bucket/bloom traffic and tracked readers:
    zero acked-write loss, zero stale reads, lane census flat,
    host_colocations 0;
  * ``device-fault``: that server's lanes killed, hung and OOMed, the
    quarantined lane evacuated, probed and respread;
  * ``qos``: an abusive bulk tenant against interactive tenants: bounded
    interactive p99, sheds on the hog only;
  * ``vector``: KNN readers with tracked results and concurrent ingest
    while the index's bank rebalances (``--shards n`` for the sharded bank);
  * ``residency``: zipf tenant bloom banks overcommitting the device
    budget 4x while slots rebalance and the ResidencyRebalancer sheds.

Usage:
    python -m redisson_tpu_torch.tools.soak_smoke [--profile NAME]
        [--cycles N] [--seed S] [--phase SECONDS] [--no-kill]
        [--shards N] [--replicas N] [--device cuda|cpu] [--positions N]

``--device`` is where every server and client lives: the card unless
``cpu``; without a card the default raises.  On the CPU the mesh has 8
positions, as the reference's tool forces 8 host devices.  ``--positions``
sets the mesh positions of the standard, device-shard, device-fault,
vector and residency profiles (default: every local position; one a card,
so ``--positions 8`` for 8 shards on one card).

Exit code 0 = every assertion held (prints the summary and ``SOAK OK``);
1 = an assertion failed (prints ``SOAK FAILED: ...`` and the summary).
"""
from __future__ import annotations

import argparse
import sys

PROFILES = ("standard", "migration", "cluster-proc", "fleet", "fleet-host", "tracking",
            "read-scale", "device-shard", "device-fault", "qos", "vector", "residency")


def build(args):
    """The harness of ``args.profile``, configured from the flags."""
    from redisson_tpu_torch.chaos import soak

    common = {"cycles": args.cycles, "seed": args.seed, "device": args.device}
    placed = {**common, "positions": args.positions}
    if args.profile == "vector":
        return soak.VectorSoakHarness(soak.VectorSoakConfig(shards=args.shards, **placed))
    if args.profile == "qos":
        return soak.QosSoakHarness(soak.QosSoakConfig(**common))
    if args.profile == "device-shard":
        return soak.DeviceShardSoakHarness(soak.DeviceShardSoakConfig(**placed))
    if args.profile == "device-fault":
        return soak.DeviceFaultSoakHarness(soak.DeviceFaultSoakConfig(**placed))
    if args.profile == "residency":
        return soak.ResidencySoakHarness(soak.ResidencySoakConfig(**placed))
    if args.profile == "read-scale":
        return soak.ReadScaleSoakHarness(soak.ReadScaleSoakConfig(kill=not args.no_kill, **common))
    if args.profile == "tracking":
        return soak.TrackingSoakHarness(soak.TrackingSoakConfig(kill=not args.no_kill, **common))
    # the process profiles' smoke is the sharpest single phase (a kill
    # mid-drain); the full phase matrices run in the slow tier
    if args.profile == "fleet-host":
        return soak.HostFleetSoakHarness(soak.HostFleetSoakConfig(
            crash_phases=("DRAINING:1",), **common))
    if args.profile == "fleet":
        return soak.FleetSoakHarness(soak.FleetSoakConfig(
            crash_phases=("DRAINING:1",), **common))
    if args.profile == "cluster-proc":
        return soak.ClusterProcSoakHarness(soak.ClusterProcSoakConfig(
            crash_phases=("DRAINING:1",), replicas=args.replicas, **common))
    if args.profile == "migration":
        return soak.MigrationSoakHarness(soak.MigrationSoakConfig(**common))
    return soak.SoakHarness(soak.SoakConfig(
        seconds_per_phase=args.phase, kill=not args.no_kill, **placed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a short soak of one chaos profile on the port")
    ap.add_argument("--profile", choices=PROFILES, default="standard")
    ap.add_argument("--cycles", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", type=float, default=1.0,
                    help="seconds of workload per phase (standard profile)")
    ap.add_argument("--no-kill", action="store_true",
                    help="standard, tracking and read-scale profiles: no master kill")
    ap.add_argument("--shards", type=int, default=1,
                    help="vector profile: SHARDS of the soaked index (> 1: the sharded bank)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="cluster-proc profile: replica processes per master, and a "
                         "read_mode=replica reader")
    ap.add_argument("--device", default="cuda",
                    help="where every server and client lives: cuda (default) or cpu")
    ap.add_argument("--positions", type=int, default=None,
                    help="mesh positions of the standard, device-shard, device-fault, vector "
                         "and residency profiles (default: every local position)")
    args = ap.parse_args(argv)

    if args.device == "cpu":
        from redisson_tpu_torch.parallel import mesh

        mesh.set_cpu_positions(8)
    harness = build(args)
    try:
        report = harness.run()
    except AssertionError as e:
        print(f"SOAK FAILED: {e}")
        print(harness.report.summary())
        return 1
    print(report.summary())
    print("SOAK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
