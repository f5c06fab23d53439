"""Node info, CONFIG, cluster view, QoS and device-placement verbs, and the
script and function verbs (the RScript and RFunction wire surface).

A copy of these parts of ``redisson_tpu/server/verbs/admin.py``:

  * TIME, INFO and MEMORY (the node-info verbs the nodes group reads), and
    CONFIG GET/SET over the server's knob table (reference ``:1375-1392``;
    ``TpuServer.config_view``/``config_set`` say which knobs).
  * CLUSTER SLOTS, MYID, INFO, SETVIEW (with ``TOKEN`` fencing), RESET,
    COUNTKEYSINSLOT and GETKEYSINSLOT, and ASKING, with the reference's
    replies; CLUSTER DEVICES (each position's slot count and label, its
    lane's QOS row and its FAULTS row, which stays 0 until the operations
    slice's fault plane) and DEVMOVE (a fenced slot -> position handoff,
    STALEEPOCH for a stale coordinator); CLUSTER QOS, the window
    scheduler's view (its class rows, the lanes' STREAM rows and a TENANT
    row a tenant, weight last) and ``REBALANCE <tenant> <rate> [<burst>]
    [WEIGHT <w>]``, the fleet rebalancer's actuator (reference
    ``:224-300``; ``cluster/qos_control.py``).  CLUSTER DEVEVACUATE (a
    position's every slot onto the survivors, a journaled device
    rebalance) and CLUSTER RESIDENCY (the residency plane's table, TIER,
    DEMOTE [COLD], SWEEP and SHED, reference ``:332-470``;
    ``cluster/residency_control.py`` drives SWEEP and SHED).  DEVPROBE
    replies an error naming the slice that brings it (the device fault
    plane, ROADMAP M11 part 6).
  * EVALSHA, EVAL, SCRIPT, FCALL, FCALL_RO and FUNCTION, on the engine's
    ``services/script.py`` services.  Scripts are Python callables
    registered server-side, so callers address them by digest (EVALSHA) or
    by function name (FCALL); EVAL, SCRIPT LOAD and FUNCTION LOAD/DUMP
    reply the reference's errors.

  * ROLE (a master's and a replica's form), METRICS (and METRICS CLUSTER over ``TpuServer.link_client``), and the
    tracing plane's TRACE, SLOWLOG and LATENCY over ``observe/trace.py``
    (reference ``:959-1152``).
  * The durability verbs over ``core/checkpoint.py``: SAVE, BGSAVE,
    BGREWRITEAOF (a background checkpoint: there is no AOF), LASTSAVE,
    SHUTDOWN (a failed final save aborts it), RESTORESTATE, DUMP and
    RESTORE (reference ``:1154-1232``, ``:1440-1476``).

  * Replication over ``server/replication.py`` (reference ``:526-990``,
    ``:1343-1373``): REPLICAOF (a resumable full sync, then REPLREGISTER;
    NO ONE promotes, leaving the promoted-from breadcrumb), REPLSNAPSHOT
    (BEGIN, FETCH, END), REPLREGISTER, REPLPUSH, REPLPUSHSEG, REPLPING,
    REPLSTATE [MAXSTALE], REPLFLUSH, WAIT and REPLICAS.  The push-stream
    verbs apply only on a replica (a promoted master refuses a late push).

  * Live slot migration (reference ``:108-192``, ``:355-368``, ``:600``):
    CLUSTER SETSLOT (MIGRATING, IMPORTING, STABLE, NODE; ``EPOCH n`` fences
    the slot, a lower epoch replies STALEEPOCH), WINDOWS (the windows and
    the open import journals), MIGRATESLOT and MIGRATESLOTS (the drain,
    ``TpuServer.migrate_slot_batch``), and IMPORTRECORDS, the transfer
    frame a drain sends, journaled before its ack.
"""

import sys
import threading
import time

from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import register, _s, _int
from redisson_tpu_torch.server.verbs.common import _exec_tls, _glob_match

# -- admin / node info (redisnode/* surface) ---------------------------------


@register("TIME")
def cmd_time(server, ctx, args):
    t = time.time()
    return [str(int(t)).encode(), str(int((t % 1) * 1e6)).encode()]


@register("INFO")
def cmd_info(server, ctx, args):
    """INFO [section]: the default sections, or one named section
    (``commandstats``: per-verb calls, usec and usec_per_call)."""
    if args:
        section = _s(args[0]).lower()
        if section == "commandstats":
            return server.commandstats_text().encode()
        if section in ("all", "everything"):
            return (server.info_text() + server.commandstats_text()).encode()
    return server.info_text().encode()


@register("MEMORY")
def cmd_memory(server, ctx, args):
    sub = bytes(args[0]).upper() if args else b""
    if sub == b"USAGE":
        rec = server.engine.store.get(_s(args[1]))
        if rec is None:
            return None
        total = 0
        for arr in rec.arrays.values():
            total += int(getattr(arr, "nbytes", 0) or 0)
        if rec.host is not None:
            total += sys.getsizeof(rec.host)
        return total
    if sub == b"STATS":
        return [b"keys.count", len(server.engine.store)]
    return "+OK"


@register("CONFIG")
def cmd_config(server, ctx, args):
    """CONFIG GET pattern | CONFIG SET key value over the server's live
    knob table."""
    sub = bytes(args[0]).upper()
    if sub == b"GET":
        pattern = _s(args[1]) if len(args) > 1 else "*"
        out = []
        for k, v in sorted(server.config_view().items()):
            if _glob_match(pattern, k):
                out += [k.encode(), str(v).encode()]
        return out
    if sub == b"SET":
        if not server.config_set(_s(args[1]), _s(args[2])):
            raise RespError(f"ERR Unknown or read-only CONFIG parameter '{_s(args[1])}'")
        return "+OK"
    raise RespError(f"ERR Unknown CONFIG subcommand '{_s(args[0])}'")


# -- cluster view (the slot map the topology programs install) ---------------

# CLUSTER subcommands the port does not serve yet -> the slice that brings them
_CLUSTER_LATER = {
    b"DEVPROBE": "M11 part 6: the device fault plane",
}


def _cluster_devices(server):
    """[n_devices, [position id, slots owned, label, [QOS, ...], [FAULTS,
    quarantined, consec_faults, total_faults, last_fault_kind]]...]; [0]
    without placement."""
    p = server.engine.placement
    if p is None:
        return [0]
    counts = p.slot_counts()
    lanes = server.engine.lanes
    out = [p.n_devices]
    for i, d in enumerate(p.devices):
        row = [getattr(d, "id", i), counts[i], str(d).encode()]
        if lanes is not None:
            lane = lanes.lane(d)
            row.append([b"QOS"] + lane.qos.wire_row())
            row.append([
                b"FAULTS", int(lane.quarantined), lane.consec_faults,
                lane.total_faults, lane.last_fault_kind.encode(),
            ])
        out.append(row)
    return out


def _cluster_qos_rebalance(server, args):
    """REBALANCE <tenant> <rate> [<burst>] [WEIGHT <w>]: one node's share of
    a tenant's fleet budget, pushed by the fleet rebalancer
    (``cluster/qos_control.py``).  The weight is stored on the tenant's
    state for the rebalancer's split; the rate retarget keeps the bucket's
    tokens."""
    if len(args) < 4:
        raise RespError("ERR CLUSTER QOS REBALANCE <tenant> <rate> [<burst>] [WEIGHT <w>]")
    rest = list(args[2:])
    weight = None
    if len(rest) >= 2 and bytes(rest[-2]).upper() == b"WEIGHT":
        try:
            weight = float(rest[-1])
        except ValueError:
            raise RespError("ERR value is not a valid float") from None
        rest = rest[:-2]
    tenant = _s(rest[0]) if rest else ""
    try:
        rate = float(rest[1])
        burst = float(rest[2]) if len(rest) > 2 else None
    except (IndexError, ValueError):
        raise RespError("ERR value is not a valid float") from None
    if weight is not None:
        server.scheduler.set_tenant_weight(tenant, weight)
    server.scheduler.set_tenant_rate(tenant, rate, burst)
    return b"OK"


def _cluster_qos(server):
    """[armed, shed_ops, shed_frames, [class, in-flight frames, ops,
    bytes]..., [STREAM, name, in-flight ops, dispatched ops]... (summed over
    the lanes), [TENANT, name, bucket level, admitted, shed ops, shed
    frames, weight]...]: the class rows stay where the occupancy balancer
    reads them, and the tagged rows after them."""
    sched = server.scheduler
    led = sched.ledger
    out = [1 if sched.armed else 0, sched.shed_ops, sched.shed_frames]
    for cls in ("interactive", "bulk"):
        out.append([cls.encode(), led.frames[cls], led.ops[cls], led.nbytes[cls]])
    lanes = server.engine.lanes
    if lanes is not None:
        agg = {}
        for lane in lanes.lanes():
            for _tag, name, infl, disp in lane.qos.stream_rows():
                cur = agg.setdefault(name, [0, 0])
                cur[0] += infl
                cur[1] += disp
        for name in (b"interactive", b"bulk"):
            if name in agg:
                out.append([b"STREAM", name] + agg[name])
    for name, level, admitted, shed_ops, shed_frames, weight in sched.tenant_table():
        out.append([
            b"TENANT", name.encode(), int(level), admitted,
            shed_ops, shed_frames, f"{weight:g}".encode(),
        ])
    return out


def _cluster_devmove(server, args):
    """DEVMOVE <position> [EPOCH <n>] <slot>...: a fenced slot -> position
    handoff in this process; the number of records that moved."""
    from redisson_tpu_torch.server.placement import PlacementStaleEpoch

    if server.engine.placement is None:
        raise RespError("ERR placement is not enabled on this server")
    rest = list(args[1:])
    dev_index = _int(rest[0])
    rest = rest[1:]
    epoch = None
    if rest and bytes(rest[0]).upper() == b"EPOCH":
        epoch = _int(rest[1])
        rest = rest[2:]
    moved = 0
    try:
        for s in (_int(a) for a in rest):
            moved += server.engine.move_slot_records(s, dev_index, epoch)
    except PlacementStaleEpoch as e:
        raise RespError(str(e))
    except ValueError as e:
        raise RespError(f"ERR {e}")
    return moved


def _cluster_devevacuate(server, args):
    """DEVEVACUATE <position> [DIR <journal_dir>]: every slot the position
    owns onto the surviving positions through the journaled device
    rebalance.  Reply: [moved_records, evacuated_slots, epoch] (epoch -1
    when unjournaled)."""
    from redisson_tpu_torch.server import migration as mig

    if server.engine.placement is None:
        raise RespError("ERR placement is not enabled on this server")
    rest = list(args[1:])
    dev_index = _int(rest[0])
    journal_dir = None
    if len(rest) >= 3 and bytes(rest[1]).upper() == b"DIR":
        journal_dir = _s(rest[2])
    try:
        moved, targets, epoch = mig.evacuate_device(
            server.engine, dev_index, journal_dir=journal_dir
        )
    except ValueError as e:
        raise RespError(f"ERR {e}")
    return [moved, len(targets), -1 if epoch is None else epoch]


def _cluster_residency_shed(server, rest):
    """SHED <position> [COUNT n] [DIR d]: up to n of the position's slots
    onto the survivors through the journaled device rebalance (the
    pressure rebalancer's actuator).  Legal with the manager off: an
    operator may pre-drain a position before arming tiers.  Reply:
    [records_moved, slots_moved]."""
    from redisson_tpu_torch.server import migration as mig

    if server.engine.placement is None:
        raise RespError("ERR placement is not enabled on this server")
    usage = "ERR CLUSTER RESIDENCY SHED <dev> [COUNT n] [DIR d]"
    if not rest:
        raise RespError(usage)
    dev_index = _int(rest[0])
    rest = rest[1:]
    count = 8
    journal_dir = None
    while rest:
        word = bytes(rest[0]).upper()
        if word == b"COUNT" and len(rest) >= 2:
            count = _int(rest[1])
            rest = rest[2:]
        elif word == b"DIR" and len(rest) >= 2:
            journal_dir = _s(rest[1])
            rest = rest[2:]
        else:
            raise RespError(usage)
    try:
        targets = mig.shed_plan(server.engine.placement, dev_index, count)
        moved = mig.rebalance_devices(
            server.engine, targets, journal_dir=journal_dir
        ) if targets else 0
    except ValueError as e:
        raise RespError(f"ERR {e}")
    return [moved, len(targets)]


def _cluster_residency(server, args):
    """CLUSTER RESIDENCY: [armed, budget_bytes, [DEV, dev, hot, warm,
    cold]..., [CTR, promotions, demotions_warm, demotions_cold, cold_loads,
    fault_in_ms_total, fault_in_ms_max]] (no DEV or CTR rows while no
    manager is armed); TIER <key> (hot/warm/cold; hot with the plane off);
    DEMOTE <key> [COLD] (1 when the tier changed); SWEEP ([demoted,
    colded, freed_bytes]); SHED (``_cluster_residency_shed``)."""
    from redisson_tpu_torch.core import residency as _res

    mgr = server.engine.residency
    if len(args) > 1:
        op = bytes(args[1]).upper()
        if op == b"TIER":
            if len(args) < 3:
                raise RespError("ERR CLUSTER RESIDENCY TIER <key>")
            if mgr is None:
                return _res.HOT.encode()  # disarmed: HOT by construction
            t = mgr.tier_of(_s(args[2]))
            if t is None:
                raise RespError("ERR no such key")
            return t.encode()
        if op == b"SHED":
            return _cluster_residency_shed(server, list(args[2:]))
        if mgr is None:
            raise RespError(
                "ERR residency plane is not enabled "
                "(CONFIG SET residency-enabled yes)"
            )
        if op == b"DEMOTE":
            if len(args) < 3:
                raise RespError("ERR CLUSTER RESIDENCY DEMOTE <key> [COLD]")
            cold = len(args) > 3 and bytes(args[3]).upper() == b"COLD"
            return 1 if mgr.demote(_s(args[2]), cold=cold, force=True) else 0
        if op == b"SWEEP":
            swept = mgr.sweep()
            return [swept["demoted"], swept["colded"], int(swept["freed_bytes"])]
        raise RespError("ERR unknown CLUSTER RESIDENCY subcommand")
    armed = 1 if (mgr is not None and _res.tier_enabled()) else 0
    out = [armed, int(_res.DEVICE_BUDGET_BYTES)]
    if mgr is None:
        return out
    devs: dict = {}
    for k, v in mgr.census().items():
        if k.startswith("residency_bytes_dev"):
            num, _, tier = k[len("residency_bytes_dev"):].partition("_")
            devs.setdefault(int(num), {})[tier] = int(v)
    for d in sorted(devs):
        row = devs[d]
        out.append([b"DEV", d, row.get("hot", 0), row.get("warm", 0),
                    row.get("cold", 0)])
    out.append([
        b"CTR", mgr.promotions, mgr.demotions_warm, mgr.demotions_cold,
        mgr.cold_loads, f"{mgr.fault_in_ms_total:g}".encode(),
        f"{mgr.fault_in_ms_max:g}".encode(),
    ])
    return out


@register("CLUSTER")
def cmd_cluster(server, ctx, args):
    sub = bytes(args[0]).upper() if args else b""
    if sub == b"SLOTS":
        return server.cluster_slots()
    if sub == b"MYID":
        return server.node_id.encode()
    if sub == b"INFO":
        return f"cluster_enabled:{1 if server.cluster_view else 0}\r\ncluster_state:ok\r\n".encode()
    if sub == b"SETVIEW":
        # SETVIEW [TOKEN <n>] <from> <to> <host> <port> <node_id> ...
        # (5-tuples) — the topology programs (harness.ClusterRunner,
        # cluster.ClusterSupervisor) install the slot map on every node.
        # TOKEN carries the writing coordinator's fencing token: a view
        # stamped with a LOWER token than the last accepted one is a stale
        # coordinator's late write and is rejected.
        rest = args[1:]
        token = None
        if rest and bytes(rest[0]).upper() == b"TOKEN":
            token = _int(rest[1])
            rest = rest[2:]
        if len(rest) % 5 != 0:
            raise RespError("ERR SETVIEW expects 5-tuples")
        if token is not None:
            if token < server.view_epoch:
                raise RespError(
                    f"STALEVIEW token {token} < accepted epoch {server.view_epoch}"
                )
            server.view_epoch = token
        view = []
        for i in range(0, len(rest), 5):
            view.append(
                (
                    _int(rest[i]),
                    _int(rest[i + 1]),
                    _s(rest[i + 2]),
                    _int(rest[i + 3]),
                    _s(rest[i + 4]),
                )
            )
        server.cluster_view = view
        return "+OK"
    if sub == b"RESET":
        server.cluster_view = []
        return "+OK"
    # -- live slot migration (MIGRATING/IMPORTING window + drain) ------------
    if sub == b"SETSLOT":
        # SETSLOT <slot> MIGRATING <host:port> | IMPORTING <host:port> |
        #         STABLE | NODE <host:port> <node_id>   [EPOCH <n>]
        # EPOCH is the journaled coordinator's per-migration fencing token
        # (server.fence_slot_epoch): re-send with the SAME epoch is the
        # idempotent resume path; a LOWER epoch is a stale coordinator and
        # replies STALEEPOCH before any state changes.
        slot = _int(args[1])
        mode = bytes(args[2]).upper()
        rest = list(args[3:])
        epoch = None
        if len(rest) >= 2 and bytes(rest[-2]).upper() == b"EPOCH":
            epoch = _int(rest[-1])
            rest = rest[:-2]
        server.fence_slot_epoch(slot, epoch)
        if mode == b"MIGRATING":
            server.set_slot_migrating(slot, _s(rest[0]), epoch)
            return "+OK"
        if mode == b"IMPORTING":
            server.set_slot_importing(slot, _s(rest[0]))
            return "+OK"
        if mode == b"STABLE":
            server.set_slot_stable(slot, epoch)
            return "+OK"
        if mode == b"NODE":
            # finalize locally: point the slot at its new owner in this
            # node's view and clear the window state (the orchestrator also
            # pushes a full SETVIEW; NODE keeps single-node finalization
            # correct even before that lands)
            addr, nid = _s(rest[0]), _s(rest[1])
            host, port = addr.rsplit(":", 1)
            new_view = []
            for lo, hi, h, p, vnid in server.cluster_view:
                if lo <= slot <= hi:
                    # split the range around the reassigned slot
                    if lo <= slot - 1:
                        new_view.append((lo, slot - 1, h, p, vnid))
                    new_view.append((slot, slot, host, int(port), nid))
                    if slot + 1 <= hi:
                        new_view.append((slot + 1, hi, h, p, vnid))
                else:
                    new_view.append((lo, hi, h, p, vnid))
            server.cluster_view = new_view
            server.set_slot_stable(slot, epoch)
            return "+OK"
        raise RespError("ERR SETSLOT expects MIGRATING|IMPORTING|STABLE|NODE")
    if sub == b"WINDOWS":
        # live migration-window state, over the wire: a coordinator or an
        # operator checks "all slots STABLE" on server processes, whose
        # server.migrating_slots it cannot reach.
        # Reply: [["MIGRATING", slot, target], ..., ["IMPORTING", slot, src]]
        out = [
            [b"MIGRATING", s, t.encode()]
            for s, t in sorted(server.migrating_slots.items())
        ]
        out += [
            [b"IMPORTING", s, src.encode()]
            for s, src in sorted(server.importing_slots.items())
        ]
        out += [
            [b"RECOVERING", s, t.encode()]
            for s, t in sorted(server.recovering_slots.items())
        ]
        # target-side import-journal state: an operator can see
        # an in-flight import from the RECEIVING end — epoch, phase,
        # batches made durable pre-ack, and the draining source.  Rows
        # disappear when the migration's last slot goes STABLE (the
        # journal terminalizes), so "no windows" keeps meaning "settled".
        out += [
            [b"IMPORTJOURNAL", epoch, phase.encode(), batches, src.encode()]
            for epoch, phase, batches, src in server.import_journal_rows()
        ]
        return out
    if sub == b"COUNTKEYSINSLOT":
        return len(server.slot_names(_int(args[1])))
    if sub == b"GETKEYSINSLOT":
        names = server.slot_names(_int(args[1]))
        limit = _int(args[2]) if len(args) > 2 else len(names)
        return [n.encode() for n in names[:limit]]
    if sub == b"MIGRATESLOT":
        # drain one MIGRATING slot (optional batch limit; <=0 = fully)
        limit = _int(args[2]) if len(args) > 2 else 0
        return server.migrate_slot_batch(_int(args[1]), limit)
    if sub == b"MIGRATESLOTS":
        # MIGRATESLOTS [EPOCH <n>] <slot>... — drain MANY migrating slots
        # in one store scan (the orchestrator's bulk form: a reshard of
        # hundreds of slots must not pay a full keyspace scan per slot).
        # EPOCH fences every named slot like SETSLOT EPOCH does.
        rest = list(args[1:])
        epoch = None
        if rest and bytes(rest[0]).upper() == b"EPOCH":
            epoch = _int(rest[1])
            rest = rest[2:]
        slots = [_int(a) for a in rest]
        for s in slots:
            server.fence_slot_epoch(s, epoch)
        return server.migrate_slot_batch(slots)
    if sub == b"DEVICES":
        return _cluster_devices(server)
    if sub == b"DEVMOVE":
        return _cluster_devmove(server, args)
    if sub == b"DEVEVACUATE":
        return _cluster_devevacuate(server, args)
    if sub == b"RESIDENCY":
        return _cluster_residency(server, args)
    if sub == b"QOS":
        if len(args) > 1 and bytes(args[1]).upper() == b"REBALANCE":
            return _cluster_qos_rebalance(server, args)
        return _cluster_qos(server)
    later = _CLUSTER_LATER.get(sub)
    if later is not None:
        raise RespError(
            f"ERR CLUSTER {sub.decode()} is not served by this port yet "
            f"(ROADMAP {later})"
        )
    raise RespError("ERR unknown CLUSTER subcommand")


@register("ASKING")
def cmd_asking(server, ctx, args):
    """One-shot admission for the NEXT command on this connection into an
    IMPORTING slot (the redirect half of the ASK protocol)."""
    ctx.asking = True
    return "+OK"


# -- replication (server/replication.py) -------------------------------------


def _tracking_invalidator(server):
    """apply_records' on_applied hook: transfer frames (replication
    pushes, migration imports) change the keyspace exactly like writes, so
    tracked readers on this node must invalidate."""
    tracking = getattr(server, "tracking", None)
    if tracking is None or not tracking.active:
        return None
    return lambda names: tracking.note_write(list(names), None)


def _bank_resync(server, names) -> None:
    """A full ship replaces a vector_bank record's arrays behind any
    service-level bank object bound to it: resync the bank's host mirror
    and row count, so a later (e.g. post-promotion) query never scores a
    stale mirror."""
    services = getattr(server.engine, "_services", None)
    if not services or services.get("search") is None or not names:
        return
    try:
        from redisson_tpu_torch.services.vector import sync_banks_from_records

        sync_banks_from_records(server.engine, names)
    except Exception:  # noqa: BLE001 — observability seam: never fail the apply
        pass


def _replica_on_applied(server):
    """The replica's on_applied: tracked readers invalidate and service
    banks re-adopt the records installed by the push stream."""
    tracking_cb = _tracking_invalidator(server)

    def on_applied(names):
        if tracking_cb is not None:
            tracking_cb(names)
        _bank_resync(server, names)

    return on_applied


def _stamp_recorder(server):
    """apply_records' on_payload hook: adopt the push's replication stamp
    (the master's sweep-cut offset and wall time) AFTER the records
    applied, so REPLSTATE never runs ahead of what a replica read sees.
    The receipt time is monotonic: staleness needs no clock agreement
    between hosts."""

    def on_payload(payload):
        off = payload.get("repl_offset")
        if off is None:
            return  # a scoped cover ship: records, not a sweep cut
        server.repl_applied_offset = int(off)
        server.repl_applied_ts = float(payload.get("repl_ts") or 0.0)
        server.repl_applied_at = time.monotonic()

    return on_payload


def _require_replica(server, verb: str) -> None:
    """The replication-stream verbs apply only on a replica: a promoted
    master must NEVER apply a late push from its old master, which would
    turn its state back to before the failover.  The refused pusher marks
    the link unhealthy."""
    if server.role != "replica":
        raise RespError(
            f"ERR {verb} rejected: node is a master (stale replication push)"
        )


@register("IMPORTRECORDS")
def cmd_importrecords(server, ctx, args):
    """IMPORTRECORDS [EPOCH <n> [SOURCE <addr>]] <blob> — install migrated
    records (slot-migration transfer frame; the blob carries records only —
    no live-list pruning, unlike REPLPUSH).

    With EPOCH (a journaled migration's fenced drain) and a configured
    journal dir, the batch is fsync'd into this node's
    :class:`~redisson_tpu_torch.server.migration_journal.ImportJournal`
    BEFORE it is applied or acked — the source deletes only records this
    node has made durable, which closes the target-kill gap.  When
    replicas are attached, the applied records are additionally
    REPLPUSH-covered before the ack, so a dead target's promoted replica
    carries the in-flight import forward.

    A node started WITHOUT a journal dir accepts EPOCH frames but journals
    nothing — the degraded mode, kept for the manual migration path.  The target-kill guarantee therefore requires the
    fleet to share a journal dir; the ClusterSupervisor enforces this by
    construction (``--journal-dir`` is passed to every node it spawns)."""
    from redisson_tpu_torch.server import replication

    rest = list(args)
    epoch = source = None
    while len(rest) > 2:
        head = bytes(rest[0]).upper()
        if head == b"EPOCH":
            epoch = _int(rest[1])
        elif head == b"SOURCE":
            source = _s(rest[1])
        else:
            break
        rest = rest[2:]
    if len(rest) != 1:
        raise RespError("ERR IMPORTRECORDS [EPOCH n [SOURCE addr]] <blob>")
    blob = bytes(rest[0])
    if epoch is not None:
        # durability point FIRST: a SIGKILL after this line loses nothing
        # the source will delete (the reply below is what authorizes it)
        server.journal_import_batch(epoch, source, blob)
    applied_names: list = []
    tracking_cb = _tracking_invalidator(server)

    def on_applied(names):
        applied_names.extend(names)
        if tracking_cb is not None:
            tracking_cb(names)

    applied = replication.apply_records(
        server.engine, blob, on_applied=on_applied
    )
    repl = server._replication
    if epoch is not None and applied_names \
            and repl is not None and repl.replicas():
        # replica-covered target (journaled imports only — the legacy
        # epoch-less path never promised it): best-effort push of JUST the
        # applied records before the ack, so failover-by-promotion starts
        # from a caught-up replica (the journal remains the proof)
        repl.cover(applied_names)
    return applied


def _promote_flush(server) -> None:
    """The promotion barrier: the replica's state becomes MASTER state the
    instant the role flips, so half-assembled segmented pushes are
    dropped, tracked readers invalidate across the keyspace, the staleness
    clock resets (a master is never stale) and service banks re-adopt
    their records."""
    with server._repl_xfers_lock:
        server._repl_xfers.clear()
    server.repl_applied_at = None
    names = list(server.engine.store.keys())
    cb = _tracking_invalidator(server)
    if cb is not None and names:
        try:
            cb(names)
        except Exception:  # noqa: BLE001
            pass
    _bank_resync(server, names)
    server.stats["promotions"] = server.stats.get("promotions", 0) + 1


@register("REPLICAOF")
def cmd_replicaof(server, ctx, args):
    """REPLICAOF NO ONE -> become master; REPLICAOF <host> <port> -> full
    sync from the master (a resumable chunked pull), then register for its
    push stream."""
    if len(args) == 2 and bytes(args[0]).upper() == b"NO" and bytes(args[1]).upper() == b"ONE":
        promoted = server.role == "replica"
        if promoted and server.master_address:
            # the breadcrumb for successor coordinators: a master that can
            # name the master it was promoted FROM is a half-finished
            # failover; a restarted stale master cannot
            server.promoted_from = server.master_address
        # the role flips FIRST: from here every late push of the old master
        # is refused by _require_replica, THEN the barrier scrubs what the
        # replica stream staged
        server.role = "master"
        server.master_address = None
        if promoted:
            _promote_flush(server)
        return "+OK"
    if len(args) != 2:
        raise RespError("ERR REPLICAOF <host> <port> | NO ONE")
    host, port = _s(args[0]), _int(args[1])
    from redisson_tpu_torch.net.retry import replica_link_kwargs
    from redisson_tpu_torch.server import replication

    # nodes of one grid share credentials and transport security
    master = server.link_client(f"{host}:{port}", **replica_link_kwargs())
    try:
        blob = replication.pull_snapshot(master, timeout=60.0)
        replication.apply_records(
            server.engine, blob,
            on_applied=_tracking_invalidator(server),
        )
        # register by the address this node is KNOWN BY: the master's push
        # link must reach a routable address, not a 0.0.0.0 bind
        reply = master.execute("REPLREGISTER", server.public_host, server.port)
        if isinstance(reply, RespError):
            raise reply
    finally:
        master.close()
    server.role = "replica"
    server.master_address = f"{host}:{port}"
    # a PREVIOUS master's stamps must not answer fresh: the staleness clock
    # restarts at the new master's first push or heartbeat
    server.repl_applied_at = None
    return "+OK"


def _reap_stale_snaps(server, now: float, keep: str = "") -> None:
    """Drop staged snapshot cuts untouched past the stale window (the
    caller holds server._snap_lock): a replica that died mid-pull must not
    pin its cut for good."""
    from redisson_tpu_torch.server.replication import SNAP_STAGE_STALE_S

    stages = server._snap_stages
    for k in [k for k, (_b, _c, ts) in stages.items()
              if k != keep and now - ts > SNAP_STAGE_STALE_S]:
        del stages[k]


@register("REPLSNAPSHOT")
def cmd_replsnapshot(server, ctx, args):
    """Bare REPLSNAPSHOT -> the full serialized cut (the one-ship form).

    Subcommands (the resumable full sync; replication.pull_snapshot is the
    client half):

      * ``BEGIN [CHUNK n]`` — serialize ONE immutable cut, stage it, reply
        ``[xfer_id, total_bytes, crc32, chunk_bytes]``;
      * ``FETCH <id> <offset>`` — the staged bytes at ``offset`` (up to the
        stage's chunk size); an unknown or reaped id replies
        ``SNAPEXPIRED``, so the puller restarts from a fresh BEGIN;
      * ``END <id>`` — release the stage (idempotent)."""
    import zlib

    from redisson_tpu_torch.server import replication

    if not args:
        blob, _shipped = replication.serialize_records(server.engine)
        return blob
    sub = bytes(args[0]).upper()
    now = time.monotonic()
    if sub == b"BEGIN":
        chunk = replication.SNAPSHOT_CHUNK_BYTES
        if len(args) >= 3 and bytes(args[1]).upper() == b"CHUNK":
            chunk = max(1, _int(args[2]))
        blob, _shipped = replication.serialize_records(server.engine)
        with server._snap_lock:
            _reap_stale_snaps(server, now)
            while len(server._snap_stages) >= replication.SNAP_STAGE_MAX:
                # backstop only: drop the least recently touched stage
                stages = server._snap_stages
                del stages[min(stages, key=lambda k: stages[k][2])]
            server._snap_seq += 1
            xfer_id = f"snap-{server.node_id[:8]}-{server._snap_seq}"
            server._snap_stages[xfer_id] = [blob, chunk, now]
        return [xfer_id, len(blob), zlib.crc32(blob), chunk]
    if sub == b"FETCH":
        xfer_id, offset = _s(args[1]), _int(args[2])
        with server._snap_lock:
            _reap_stale_snaps(server, now, keep=xfer_id)
            entry = server._snap_stages.get(xfer_id)
            if entry is None:
                raise RespError(
                    f"SNAPEXPIRED unknown snapshot transfer {xfer_id}"
                )
            blob, chunk, _ts = entry
            entry[2] = now
        if not (0 <= offset <= len(blob)):
            raise RespError(
                f"ERR snapshot offset {offset} outside 0..{len(blob)}"
            )
        return blob[offset:offset + chunk]
    if sub == b"END":
        with server._snap_lock:
            server._snap_stages.pop(_s(args[1]), None)
        return "+OK"
    raise RespError(
        "ERR REPLSNAPSHOT [BEGIN [CHUNK n] | FETCH <id> <offset> | END <id>]"
    )


@register("REPLREGISTER")
def cmd_replregister(server, ctx, args):
    host, port = _s(args[0]), _int(args[1])
    server.replication_source().register(f"{host}:{port}")
    return "+OK"


@register("REPLPUSH")
def cmd_replpush(server, ctx, args):
    from redisson_tpu_torch.server import replication

    _require_replica(server, "REPLPUSH")
    # any live push proves the link is back: reap the transfers a dead
    # predecessor abandoned mid-segment
    with server._repl_xfers_lock:
        _reap_stale_xfers(server, time.monotonic())
    return replication.apply_records(
        server.engine, bytes(args[0]),
        on_applied=_replica_on_applied(server),
        on_payload=_stamp_recorder(server),
    )


# REPLPUSHSEG staging: a transfer untouched for REPL_XFER_STALE_S is
# abandoned (its pusher's per-segment timeout is 60 s); REPL_XFER_MAX is the
# hard leak backstop, far above any sane count of concurrent transfers
REPL_XFER_STALE_S = 120.0
REPL_XFER_MAX = 64


def _reap_stale_xfers(server, now: float, keep: str = "") -> None:
    """Drop staged transfers untouched past the stale window (the caller
    holds server._repl_xfers_lock).  Runs on EVERY replication push, so an
    abandoned transfer cannot linger when no later segmented ship starts."""
    xfers = server._repl_xfers
    for k in [k for k, (_slots, ts) in xfers.items()
              if k != keep and now - ts > REPL_XFER_STALE_S]:
        del xfers[k]


@register("REPLPUSHSEG")
def cmd_replpushseg(server, ctx, args):
    """REPLPUSHSEG <xfer_id> <seq> <nsegs> <chunk> — one bounded slice of an
    oversized REPLPUSH blob (replication.SEGMENT_BYTES).  The last slice
    reassembles and applies the blob; the others stage on the host and
    reply +OK.  Staging evicts by staleness, never by insertion order."""
    from redisson_tpu_torch.server import replication

    _require_replica(server, "REPLPUSHSEG")
    xfer_id, seq, nsegs = _s(args[0]), _int(args[1]), _int(args[2])
    chunk = bytes(args[3])
    now = time.monotonic()
    xfers = server._repl_xfers
    with server._repl_xfers_lock:
        _reap_stale_xfers(server, now, keep=xfer_id)
        if seq == 0:
            while len(xfers) >= REPL_XFER_MAX:
                # backstop only: drop the least recently touched transfer
                del xfers[min(xfers, key=lambda k: xfers[k][1])]
            xfers[xfer_id] = [[None] * nsegs, now]
        entry = xfers.get(xfer_id)
        if entry is None or len(entry[0]) != nsegs or not (0 <= seq < nsegs):
            raise RespError(f"ERR unknown replication transfer {xfer_id}/{seq}")
        entry[0][seq] = chunk
        entry[1] = now
        if any(s is None for s in entry[0]):
            return "+OK"
        del xfers[xfer_id]
        blob = b"".join(entry[0])
    return replication.apply_records(
        server.engine, blob,
        on_applied=_replica_on_applied(server),
        on_payload=_stamp_recorder(server),
    )


@register("REPLPING")
def cmd_replping(server, ctx, args):
    """REPLPING <offset> <ts> — the master's heartbeat on a clean sweep: the
    replica's applied offset advances with no payload, so bounded-staleness
    replica reads stay eligible while the keyspace is idle."""
    _require_replica(server, "REPLPING")
    server.repl_applied_offset = _int(args[0])
    try:
        server.repl_applied_ts = float(_s(args[1]))
    except (ValueError, IndexError):
        server.repl_applied_ts = 0.0
    server.repl_applied_at = time.monotonic()
    return "+OK"


@register("REPLSTATE")
def cmd_replstate(server, ctx, args):
    """REPLSTATE [MAXSTALE <ms>] -> [role, applied_offset, staleness_ms,
    view_epoch] — the server half of the bounded-staleness contract.

    staleness_ms counts from the monotonic RECEIPT of the last applied push
    or heartbeat; -1 means the replica never synced (always too stale); a
    master replies 0.  The MAXSTALE form replies the same and also counts
    replica_redirects_stale when the answer exceeds the client's bound."""
    max_stale = None
    if args:
        if len(args) == 2 and bytes(args[0]).upper() == b"MAXSTALE":
            max_stale = _int(args[1])
        else:
            raise RespError("ERR REPLSTATE [MAXSTALE <ms>]")
    if server.role != "replica":
        stale_ms = 0
    elif server.repl_applied_at is None:
        stale_ms = -1
    else:
        stale_ms = int((time.monotonic() - server.repl_applied_at) * 1000.0)
    if max_stale is not None and server.role == "replica" \
            and (stale_ms < 0 or stale_ms > max_stale):
        server.stats["replica_redirects_stale"] += 1
    return [
        server.role.encode(),
        int(server.repl_applied_offset),
        stale_ms,
        int(server.view_epoch),
    ]


@register("REPLFLUSH")
def cmd_replflush(server, ctx, args):
    """Ship dirty records to every replica NOW (the WAIT / syncSlaves
    analog)."""
    if server._replication is None:
        return 0
    return server._replication.flush()


@register("WAIT")
def cmd_wait(server, ctx, args):
    """WAIT numreplicas timeout(ms): flush dirty records to the replicas
    now and reply how many replicas are attached (a count >= numreplicas
    means the flush was SHIPPED to that many: the REPLFLUSH semantics)."""
    if len(args) < 2:
        raise RespError("ERR wrong number of arguments for 'wait' command")
    want = _int(args[0])
    timeout_ms = _int(args[1])
    if timeout_ms < 0:
        raise RespError("ERR timeout is negative")
    # Redis's WAIT timeout 0 blocks until the replica count is reached
    deadline = None if timeout_ms == 0 else time.time() + timeout_ms / 1000.0
    while True:
        n = 0
        if server._replication is not None:
            server._replication.flush()
            n = len(server._replication.replicas())
        if (
            n >= want
            or (deadline is not None and time.time() >= deadline)
            or getattr(server, "_closing", False)
            or getattr(_exec_tls, "in_exec", False)  # no parking inside EXEC
        ):
            return n
        time.sleep(0.02)  # parked, not spinning: this holds a pool worker


@register("REPLICAS")
def cmd_replicas(server, ctx, args):
    if server._replication is None:
        return []
    return [a.encode() for a in server._replication.replicas()]


@register("ROLE")
def cmd_role(server, ctx, args):
    """Redis ROLE parity: a master -> ["master", 0, [replica addrs],
    promoted-from]; a replica -> ["slave", host, port, "connected", 0].
    Failover coordinators probe it to find a dead master's replicas.  The
    4th element of the master form goes past Redis: the address this
    master was promoted FROM (empty when it never was a replica)."""
    if server.role == "replica" and server.master_address:
        host, _, port = server.master_address.rpartition(":")
        return [b"slave", host.encode(), int(port), b"connected", 0]
    reps = []
    if server._replication is not None:
        reps = [a.encode() for a in server._replication.replicas()]
    return [b"master", 0, reps, (server.promoted_from or "").encode()]


@register("METRICS")
def cmd_metrics(server, ctx, args):
    """Prometheus text exposition of the node's metrics registry.

    ``METRICS CLUSTER``: fan the scrape out to every master in this node's
    cluster view and merge the expositions with per-node
    ``node="host:port"`` labels (``utils.metrics.merge_prometheus_texts``,
    which ``ClusterSupervisor.scrape`` rides too).  A dead peer contributes
    nothing rather than failing the whole scrape."""
    if args and bytes(args[0]).upper() == b"CLUSTER":
        from redisson_tpu_torch.utils.metrics import merge_prometheus_texts

        texts = {server.address(): server.metrics.prometheus_text()}
        seen = {(server.host, server.port)}
        for _lo, _hi, host, port, _nid in server.cluster_view:
            if (host, port) in seen:
                continue
            seen.add((host, port))
            try:
                link = server.link_client(
                    f"{host}:{port}", ping_interval=0, retry_attempts=1
                )
                try:
                    texts[f"{host}:{port}"] = bytes(
                        link.execute("METRICS", timeout=10.0)
                    ).decode()
                finally:
                    link.close()
            except Exception:  # noqa: BLE001 — dead peer: scrape the rest
                continue
        return merge_prometheus_texts(texts).encode()
    return server.metrics.prometheus_text().encode()


# -- tracing plane verbs (TRACE / SLOWLOG / LATENCY) -------------------------


def _span_wire(span) -> list:
    """One stage span on the wire: [name, off_us, dur_us, [k, v, ...]]."""
    attrs = []
    if span.attrs:
        for k, v in span.attrs.items():
            attrs.append(k.encode())
            attrs.append(v if isinstance(v, int) else str(v).encode())
    return [span.name.encode(), span.off_us, span.dur_us, attrs]


def _trace_wire(tr) -> list:
    """One frame trace on the wire: [id, unix_ms, total_us, verb, n_cmds,
    class, tenant, [span, ...]] — tools/trace_dump.py renders this as a
    per-stage waterfall."""
    return [
        tr.trace_id, int(tr.ts * 1000), tr.total_us, tr.verbs.encode(),
        tr.n_cmds, (tr.qos_class or "").encode(), (tr.tenant or "").encode(),
        [_span_wire(s) for s in tr.spans],
    ]


@register("TRACE")
def cmd_trace(server, ctx, args):
    """TRACE GET [n] [BY total|<stage>] | RESET | CONFIG GET|SET k v —
    the per-frame span ring over the wire.  GET returns the slowest-n
    finished traces ordered by total duration (or by one stage's summed
    duration), each a full span tree.  Empty while tracing is disarmed
    (CONFIG SET trace-enabled yes arms)."""
    sub = bytes(args[0]).upper() if args else b"GET"
    tracer = server.tracer
    if sub == b"GET":
        rest = list(args[1:])
        n = 10
        by = "total"
        if rest and bytes(rest[0]).upper() != b"BY":
            n = _int(rest[0])
            rest = rest[1:]
        if rest and bytes(rest[0]).upper() == b"BY":
            if len(rest) < 2:
                raise RespError("ERR TRACE GET ... BY needs a stage name")
            by = _s(rest[1])
        return [_trace_wire(t) for t in tracer.slowest(n, by=by)]
    if sub == b"RESET":
        tracer.reset()
        return "+OK"
    if sub == b"CONFIG":
        mode = bytes(args[1]).upper() if len(args) > 1 else b"GET"
        if mode == b"GET":
            out = []
            view = server.config_view()
            for k in ("trace-enabled", "trace-ring-capacity",
                      "slowlog-log-slower-than", "slowlog-max-len"):
                out += [k.encode(), str(view[k]).encode()]
            return out
        if mode == b"SET":
            if len(args) < 4:
                raise RespError("ERR TRACE CONFIG SET <key> <value>")
            if not server.config_set(_s(args[2]), _s(args[3])):
                raise RespError(
                    f"ERR unknown TRACE CONFIG parameter '{_s(args[2])}'"
                )
            return "+OK"
        raise RespError("ERR TRACE CONFIG expects GET|SET")
    raise RespError("ERR TRACE expects GET|RESET|CONFIG")


@register("SLOWLOG")
def cmd_slowlog(server, ctx, args):
    """SLOWLOG GET [n] | RESET | LEN over the trace ring (threshold: CONFIG
    SET slowlog-log-slower-than <us>, negative disables, 0 logs every
    frame).  Each entry carries the per-stage breakdown:
    [id, unix_ts, total_us, [verb, ncmds], [[stage, dur_us], ...]]."""
    sub = bytes(args[0]).upper() if args else b"GET"
    tracer = server.tracer
    if sub == b"GET":
        n = _int(args[1]) if len(args) > 1 else 10
        out = []
        for sid, ts, dur_us, tr, stages in tracer.slowlog_get(n):
            out.append([
                sid, ts, dur_us,
                [tr.verbs.encode(), str(tr.n_cmds).encode()],
                [[st.encode(), us] for st, us in sorted(stages.items())],
            ])
        return out
    if sub == b"LEN":
        return tracer.slowlog_len()
    if sub == b"RESET":
        tracer.slowlog_reset()
        return "+OK"
    raise RespError("ERR SLOWLOG expects GET|RESET|LEN")


@register("LATENCY")
def cmd_latency(server, ctx, args):
    """LATENCY HISTORY <event> | RESET [event ...] | LATEST over the
    per-stage samples the tracer collects (events are stage names: total,
    qos, dispatch, stage, kernel, readback, reply)."""
    sub = bytes(args[0]).upper() if args else b""
    tracer = server.tracer
    if sub == b"HISTORY":
        if len(args) < 2:
            raise RespError("ERR LATENCY HISTORY <event>")
        # (unix ts, MILLISECONDS) pairs; a sub-ms sample rounds up to 1 so
        # it never reads as "no latency"
        return [
            [ts, max(1, int(round(ms)))]
            for ts, ms in tracer.latency_history(_s(args[1]))
        ]
    if sub == b"RESET":
        return tracer.latency_reset([_s(a) for a in args[1:]])
    if sub == b"LATEST":
        out = []
        for ev in tracer.latency_events():
            hist = tracer.latency_history(ev)
            if not hist:
                continue
            ts, ms = hist[-1]
            worst = max(m for _t, m in hist)
            out.append([
                ev.encode(), ts,
                max(1, int(round(ms))), max(1, int(round(worst))),
            ])
        return out
    raise RespError("ERR LATENCY expects HISTORY|RESET|LATEST")


# -- durability verbs (core/checkpoint.py) -----------------------------------


def _checkpoint_path(server, args) -> str:
    path = _s(args[0]) if args else server.checkpoint_path
    if path is None:
        raise RespError("ERR no checkpoint path configured")
    return path


@register("SAVE")
def cmd_save(server, ctx, args):
    from redisson_tpu_torch.core import checkpoint

    checkpoint.save(server.engine, _checkpoint_path(server, args))
    return "+OK"


@register("BGSAVE")
def cmd_bgsave(server, ctx, args):
    """Checkpoint in the background (the RDB BGSAVE role); LASTSAVE reports
    the completion time of the most recent one."""
    path = _checkpoint_path(server, args)
    from redisson_tpu_torch.core import checkpoint

    def run():
        try:
            checkpoint.save(server.engine, path)
            server.__dict__["_lastsave"] = int(time.time())
        except Exception:  # noqa: BLE001 — background save: best-effort
            pass

    threading.Thread(target=run, daemon=True, name="rtpu-bgsave").start()
    return "+Background saving started"


@register("BGREWRITEAOF")
def cmd_bgrewriteaof(server, ctx, args):
    """No AOF exists: durability is checkpoints (and, with the operations
    slice, replication), so the rewrite degrades to a background
    checkpoint."""
    cmd_bgsave(server, ctx, args)
    return "+Background append only file rewriting started"


@register("LASTSAVE")
def cmd_lastsave(server, ctx, args):
    return int(server.__dict__.get("_lastsave", 0))


@register("SHUTDOWN")
def cmd_shutdown(server, ctx, args):
    """SHUTDOWN [NOSAVE|SAVE]: optionally checkpoint, then stop the server.
    The stop runs on a side thread so this handler's worker can finish its
    frame; a failed final save ABORTS the shutdown, as in Redis."""
    mode = bytes(args[0]).upper() if args else b""
    if mode == b"SAVE" and not server.checkpoint_path:
        raise RespError("ERR no checkpoint path configured")
    if mode == b"SAVE" or (mode != b"NOSAVE" and server.checkpoint_path):
        from redisson_tpu_torch.core import checkpoint

        try:
            checkpoint.save(server.engine, server.checkpoint_path)
            server.__dict__["_lastsave"] = int(time.time())
        except Exception as e:  # noqa: BLE001 — data would be lost silently
            raise RespError(f"ERR shutdown save failed, aborting: {e}")
    threading.Thread(target=server.stop, daemon=True, name="rtpu-shutdown").start()
    return "+OK"


@register("RESTORESTATE")
def cmd_restorestate(server, ctx, args):
    from redisson_tpu_torch.core import checkpoint

    return checkpoint.load(server.engine, _checkpoint_path(server, args))


@register("DUMP")
def cmd_dump(server, ctx, args):
    """DUMP key — the portable record blob (core/checkpoint.dump_record);
    a missing key dumps nil."""
    from redisson_tpu_torch.core import checkpoint

    try:
        return checkpoint.dump_record(server.engine, _s(args[0]))
    except KeyError:
        return None


@register("RESTORE")
def cmd_restore(server, ctx, args):
    """RESTORE key ttl(ms) blob [REPLACE] [PERSIST] — BUSYKEY unless
    REPLACE; ttl 0 is no expiry (RObject.migrate ships the remaining TTL
    as this operand)."""
    from redisson_tpu_torch.core import checkpoint

    name = _s(args[0])
    ttl_ms = _int(args[1])
    if ttl_ms < 0:
        raise RespError("ERR Invalid TTL value, must be >= 0")
    opts = {bytes(a).upper() for a in args[3:]}
    if opts - {b"REPLACE", b"PERSIST"}:
        raise RespError("ERR syntax error")
    try:
        checkpoint.restore_record(
            server.engine, name, bytes(args[2]),
            ttl_ms / 1000.0 if ttl_ms > 0 else None,
            b"REPLACE" in opts, persist=b"PERSIST" in opts or ttl_ms == 0,
        )
    except ValueError as e:
        msg = str(e)
        raise RespError(msg if msg.startswith("BUSYKEY") else f"ERR {msg}")
    return "+OK"

# -- script / function / admin verbs (RScript + RFunction wire surface) ------

def _script_svc(server):
    from redisson_tpu_torch.services.script import ScriptService

    return server.engine.service("script", lambda: ScriptService(server.engine))


def _function_svc(server):
    from redisson_tpu_torch.services.script import FunctionService

    return server.engine.service("function", lambda: FunctionService(server.engine))


def _proc_keys_args(args, at):
    """numkeys keys... args... tail shared by EVALSHA/FCALL."""
    n = _int(args[at])
    if n < 0:
        raise RespError("ERR Number of keys can't be negative")
    if len(args) < at + 1 + n:
        raise RespError("ERR Number of keys is greater than number of args")
    keys = [_s(k) for k in args[at + 1 : at + 1 + n]]
    rest = [bytes(a) for a in args[at + 1 + n :]]
    return keys, rest


@register("EVALSHA")
def cmd_evalsha(server, ctx, args):
    """EVALSHA sha numkeys key... arg... — invokes a script REGISTERED
    SERVER-SIDE (embedded script_load).  Scripts here are Python callables,
    so source never ships over the wire: remote callers address by digest
    only, and a miss replies NOSCRIPT exactly like the reference's
    EVAL-fallback discipline expects."""
    from redisson_tpu_torch.services.script import NoScriptError

    keys, rest = _proc_keys_args(args, 1)
    try:
        return _script_svc(server).eval_sha(_s(args[0]), keys, rest)
    except NoScriptError:
        raise RespError("NOSCRIPT No matching script. Please use EVAL.")


@register("EVAL")
def cmd_eval(server, ctx, args):
    raise RespError(
        "ERR EVAL with shipped source is not supported on this server: "
        "scripts are Python callables registered server-side (script_load); "
        "invoke by digest with EVALSHA, or FCALL a loaded function library"
    )


@register("SCRIPT")
def cmd_script(server, ctx, args):
    sub = bytes(args[0]).upper()
    svc = _script_svc(server)
    if sub == b"EXISTS":
        return [1 if ok else 0 for ok in svc.script_exists(*[_s(s) for s in args[1:]])]
    if sub == b"FLUSH":
        svc.script_flush()
        return "+OK"
    if sub == b"LOAD":
        raise RespError(
            "ERR SCRIPT LOAD over the wire is not supported (scripts are "
            "Python callables; register them server-side)"
        )
    raise RespError(f"ERR Unknown SCRIPT subcommand '{_s(args[0])}'")


def _fcall(server, args, read_only: bool):
    keys, rest = _proc_keys_args(args, 1)
    svc = _function_svc(server)
    # resolve OUTSIDE the invocation: a KeyError raised by the function's
    # own body must surface as the function's error, not "not found"
    try:
        fn = svc._resolve(_s(args[0]))
    except KeyError:
        raise RespError(f"ERR Function not found: {_s(args[0])}")
    from redisson_tpu_torch.services.script import ScriptMode

    mode = ScriptMode.READ_ONLY if read_only else ScriptMode.READ_WRITE
    return svc._script.eval(fn, keys, rest, mode)


@register("FCALL")
def cmd_fcall(server, ctx, args):
    return _fcall(server, args, read_only=False)


@register("FCALL_RO")
def cmd_fcall_ro(server, ctx, args):
    return _fcall(server, args, read_only=True)


@register("FUNCTION")
def cmd_function(server, ctx, args):
    sub = bytes(args[0]).upper()
    if sub == b"LIST":
        out = []
        for lib, fns in sorted(_function_svc(server).list().items()):
            out.append([
                b"library_name", lib.encode(),
                b"functions", [f.encode() for f in fns],
            ])
        return out
    if sub == b"DUMP" or sub == b"LOAD":
        raise RespError(
            "ERR FUNCTION libraries are Python callables registered "
            "server-side; wire DUMP/LOAD is not supported"
        )
    raise RespError(f"ERR Unknown FUNCTION subcommand '{_s(args[0])}'")
