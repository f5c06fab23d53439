"""Node info, CONFIG, cluster view, QoS and device-placement verbs, and the
script and function verbs (the RScript and RFunction wire surface).

A copy of four parts of ``redisson_tpu/server/verbs/admin.py``:

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
    ``:224-300``; ``cluster/qos_control.py``).  The other CLUSTER
    subcommands reply an error naming the slice that brings them: DEVPROBE
    and DEVEVACUATE (they need the fault plane and
    ``server/migration.py``), the migration and residency ones (SETSLOT,
    WINDOWS, MIGRATESLOT, MIGRATESLOTS, RESIDENCY) ROADMAP M11, as does
    REPLICAOF.  REPLICAS replies the empty list a master with no replica
    replies: no replica can attach before M11.
  * EVALSHA, EVAL, SCRIPT, FCALL, FCALL_RO and FUNCTION, on the engine's
    ``services/script.py`` services.  Scripts are Python callables
    registered server-side, so callers address them by digest (EVALSHA) or
    by function name (FCALL); EVAL, SCRIPT LOAD and FUNCTION LOAD/DUMP
    reply the reference's errors.

The rest of the file (SAVE, the replication verbs, DUMP, RESTORE, COPY,
WAIT) comes with the operations slice (ROADMAP M11).
"""

import sys
import time

from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import register, _s, _int
from redisson_tpu_torch.server.verbs.common import _glob_match

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
    b"DEVPROBE": "M11: the device fault plane", b"DEVEVACUATE": "M11: the device fault plane",
    b"SETSLOT": "M11", b"WINDOWS": "M11", b"MIGRATESLOT": "M11",
    b"MIGRATESLOTS": "M11", b"RESIDENCY": "M11",
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
    if sub == b"COUNTKEYSINSLOT":
        return len(server.slot_names(_int(args[1])))
    if sub == b"GETKEYSINSLOT":
        names = server.slot_names(_int(args[1]))
        limit = _int(args[2]) if len(args) > 2 else len(names)
        return [n.encode() for n in names[:limit]]
    if sub == b"DEVICES":
        return _cluster_devices(server)
    if sub == b"DEVMOVE":
        return _cluster_devmove(server, args)
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


@register("REPLICAOF")
def cmd_replicaof(server, ctx, args):
    raise RespError(
        "ERR REPLICAOF is not served by this port yet (ROADMAP M11: replication)"
    )


@register("REPLICAS")
def cmd_replicas(server, ctx, args):
    # a master's replica list: empty, as no replica attaches before M11
    return []

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
