"""Server command registry: RESP command name -> handler over the Engine.

Parity target: ``client/protocol/RedisCommands.java`` (the ~447-command
registry) reimagined server-side: a compact set of compatible commands for
keyspace admin, strings, bits, sketches and pubsub, with **batched multi-key
forms as the primary citizens** (BF.MADD64/BF.MEXISTS64 carry whole key
batches — an RBatch flush arrives as ONE command, one kernel launch).

Handlers run on the server's worker pool; per-connection order is preserved
by the connection loop (CommandsQueue FIFO discipline).

A copy of ``redisson_tpu/server/registry.py`` for the verb families the port
serves (``server/verbs``).  Device values of a ``LazyReply`` are torch
tensors: a frame's values come to the host in one grouped copy
(``core/ioplane.gather_device_results``).  A node in a cluster checks each
command's slots before it dispatches (``TpuServer.check_routing``: MOVED,
ASK).  With the chaos plane installed a keyed command consults its
position's device-dispatch stream before the handler runs
(``_consult_device_dispatch``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.net import client as _net
from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.observe import trace as _obs
from redisson_tpu_torch.utils.metrics import run_hooks_end, run_hooks_start


class LazyReply:
    """Deferred reply: the handler launched device work but did not wait
    for it.  The connection loop materializes every lazy reply of a
    pipelined frame together — for the (device, finish) form, every device
    value is viewed as bytes, concatenated on the card and copied to the
    host in ONE transfer, so a 32-command frame pays one readback instead
    of 32 (the reference's analog is CommandBatchService's single-flush
    discipline).

    Two forms:
      LazyReply(force=fn)              — fn() -> reply, forced individually;
      LazyReply(device=(tensors...), finish=fn) — fn(host_arrays) -> reply,
        host_arrays delivered by the frame-level grouped transfer.

    A device-form reply belongs to the position whose lane occupancy was
    current when it was made (``ioplane.current_position``), for the lane
    watchdog and the injected stalls of the grouped fetch.
    """

    __slots__ = ("device", "finish", "_force", "position")

    def __init__(self, force: Optional[Callable[[], Any]] = None,
                 device: Optional[tuple] = None,
                 finish: Optional[Callable[[tuple], Any]] = None):
        self._force = force
        self.device = device
        self.finish = finish
        self.position = ioplane.current_position() if device is not None else None

    def force(self) -> Any:
        if self._force is not None:
            return self._force()
        return self.finish(tuple(ioplane._to_host(v) for v in self.device))


def _settled(lazies: List["LazyReply"]) -> bool:
    """True when no device value of `lazies` still waits on device work:
    an event recorded now on each value's device has already passed."""
    devs = {ioplane.device_of(v) for lz in lazies for v in lz.device}
    return all(ioplane._passed(ioplane.record_event(d)) for d in devs if d is not None)


def gather_lazy_device_results(lazies: List["LazyReply"]) -> List[tuple]:
    """Fetch every device value of `lazies` with ONE device->host transfer
    (core/ioplane.gather_device_results, the primitive the embedded Batch
    drain shares).  With tracing armed the gather is the frame's
    ``readback`` span, annotated whether it had to wait on device work."""
    if _obs._tracer is not None:
        cur = _obs.current_trace()
        if cur is not None:
            was_ready = _settled(lazies)
            t0 = time.monotonic()
            out = _gather(lazies)
            cur.add_span(
                "readback", t0, time.monotonic(),
                grouped=len(lazies), blocking=int(not was_ready),
            )
            return out
    return _gather(lazies)


def _gather(lazies: List["LazyReply"]) -> List[tuple]:
    return ioplane.gather_device_results(
        [lz.device for lz in lazies], [lz.position for lz in lazies])
class CommandContext:
    """Per-connection state (db selection, auth, subscriptions)."""

    def __init__(self, server):
        self.server = server
        # auth required when a default password OR any ACL user is set
        self.authenticated = server.password is None and not getattr(server, "users", None)
        self.username: Optional[str] = None
        # negotiated protocol: this wire is RESP3-native (typed maps/sets/
        # push/null/bool/double frames); HELLO 2 downgrades the connection
        # to the strict RESP2 projection for compatibility clients
        self.proto: int = 3
        self.name: Optional[str] = None
        # stable connection identity: CLIENT ID / TRACKING REDIRECT address
        # this context for its whole life (the old per-call next_client_id
        # minted a fresh id every CLIENT ID — useless as a redirect target)
        self.client_id: int = server.next_client_id()
        # per-connection tracking state (tracking/table.py ConnTracking);
        # None until CLIENT TRACKING ON
        self.tracking = None
        # QoS plane: the connection-declared
        # deadline class ("interactive"/"bulk"; None = heuristic by frame
        # size) and tenant (None = derive from the frame's key {hashtag})
        # — set by CLIENT QOS CLASS <c> [TENANT <t>]
        self.qos_class: Optional[str] = None
        self.tenant: Optional[str] = None
        self.subscriptions: Dict[str, int] = {}
        self.psubscriptions: Dict[str, int] = {}
        self.push: Optional[Callable[[Any], None]] = None  # wired by the server
        self.asking = False  # one-shot ASK admission (cleared per command)
        # READONLY connection state (Redis cluster parity): armed
        # by the READONLY verb, cleared by READWRITE.  A cluster replica
        # serves keyed reads only to readonly connections — everyone else
        # gets -MOVED to the master (server.check_routing).
        self.readonly = False
        # MULTI/EXEC/WATCH state (per-connection, like Redis): a non-None
        # multi_queue means queueing mode; watch_versions holds the record
        # versions observed at WATCH time (the optimistic precondition)
        self.multi_queue: Optional[List[List[bytes]]] = None
        self.multi_error = False
        self.watch_versions: Dict[str, int] = {}

    def subscription_count(self) -> int:
        return len(self.subscriptions) + len(self.psubscriptions)


class Registry:
    def __init__(self):
        self._handlers: Dict[bytes, Callable] = {}

    def register(self, name: str):
        def deco(fn):
            self._handlers[name.upper().encode()] = fn
            return fn

        return deco

    # commands served immediately even while a MULTI queue is open
    _TX_IMMEDIATE = frozenset(
        (b"MULTI", b"EXEC", b"DISCARD", b"WATCH", b"UNWATCH", b"RESET",
         b"QUIT", b"AUTH", b"HELLO")
    )

    def dispatch(self, server, ctx: CommandContext, args: List[bytes]):
        if not args:
            raise RespError("ERR empty command")
        cmd = bytes(args[0]).upper()
        handler = self._handlers.get(cmd)
        if handler is None:
            if ctx.multi_queue is not None:
                # Redis poisons the open transaction: EXEC replies EXECABORT
                ctx.multi_error = True
            raise RespError(f"ERR unknown command '{cmd.decode()}'")
        if not ctx.authenticated and cmd not in (b"AUTH", b"HELLO", b"QUIT", b"PING"):
            raise RespError("NOAUTH Authentication required.")
        # one-shot ASK admission: consumed by every command (the ASKING
        # handler re-arms it for the next one)
        asking, ctx.asking = ctx.asking, False
        if server.cluster_view or server.role == "replica":
            # queue-time MOVED/ASK replies match Redis cluster; EXEC rechecks
            # the whole group before applying anything
            server.check_routing(cmd.decode(), args[1:], asking=asking,
                                 readonly=ctx.readonly)
        if ctx.multi_queue is not None and cmd not in self._TX_IMMEDIATE:
            ctx.multi_queue.append([bytes(a) for a in args])
            return "+QUEUED"
        # device-dispatch chokepoint: with the chaos plane armed a command
        # routed to a faulted position fails here, with the exception a
        # failed launch raises, before the handler applies anything.
        # Disarmed cost: one global load and an `is None` branch.
        plane = _net._fault_plane
        if plane is not None:
            _consult_device_dispatch(plane, server, args)
        # client-tracking hooks (tracking/table.py): `active` is an int load
        # + compare, so a server with no tracking clients pays ~nothing.
        # Reads register PRE-dispatch (a concurrent writer must see the
        # registration or apply before our read); writes invalidate
        # POST-dispatch (after the handler applied).
        track = getattr(server, "tracking", None)
        if track is not None and not track.active:
            track = None
        if track is not None:
            track.pre_dispatch(ctx, cmd, args[1:])
        hooks = getattr(server, "hooks", None)
        name = cmd.decode()
        tokens = run_hooks_start(hooks, name, args[1:]) if hooks else None
        try:
            result = handler(server, ctx, args[1:])
        except BaseException as e:
            if tokens is not None:
                run_hooks_end(tokens, name, e)
            # a raising write verb may have PARTIALLY applied (a multi-source
            # merge that created its dest before a later WRONGTYPE): other
            # clients' tracked entries must still invalidate.  A spurious
            # push for a not-applied write costs one refetch; a skipped one
            # is stale forever.
            if track is not None:
                try:
                    track.post_dispatch(ctx, cmd, args[1:])
                except Exception:  # noqa: BLE001 — never mask the primary error
                    pass
            raise
        if tokens is not None:
            run_hooks_end(tokens, name, None)
        if track is not None:
            track.post_dispatch(ctx, cmd, args[1:])
        return result


def _consult_device_dispatch(plane, server, args) -> None:
    """Armed-only slow path: resolve the command's owning position (the
    single-position verbs of SlotPlacement) and consult the chaos plane's
    per-position dispatch stream.  A raised fault is attributed to the
    lane's quarantine ledger before it surfaces."""
    eng = getattr(server, "engine", None)
    placement = getattr(eng, "placement", None)
    if placement is None:
        return
    try:
        dev_index = placement.device_index_for_command(
            [bytes(a) for a in args]
        )
    except Exception:  # noqa: BLE001 — unroutable: not a device command
        return
    if dev_index is None:
        return
    dev_id = getattr(placement.devices[dev_index], "id", dev_index)
    try:
        plane.on_device_dispatch(dev_id)
    except BaseException as e:
        ioplane.note_device_fault(dev_id, "kernel_launch")
        ioplane.mark_fault_noted(e)
        raise


REGISTRY = Registry()
register = REGISTRY.register


def _s(b: bytes) -> str:
    return b.decode() if isinstance(b, (bytes, bytearray)) else str(b)


def _int(b) -> int:
    try:
        return int(b)
    except (TypeError, ValueError):
        raise RespError("ERR value is not an integer or out of range")


# verb families live in server/verbs/*; importing the package registers
# every handler into REGISTRY
from redisson_tpu_torch.server import verbs  # noqa: E402,F401  (registration side effect)
