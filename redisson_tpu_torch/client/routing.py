"""Shared cluster-routing core: pure slot/redirect logic consumed by BOTH
the sync (`client/cluster.py`) and async (`client/aio.py`) cluster clients,
and the frame run shapes the server's coalescing plane reads.

A copy of ``redisson_tpu/client/routing.py``.  Parity target: the routing
half of ``command/RedisExecutor.java:113-560`` (slot calculation,
MOVED/ASK/TRYAGAIN classification) and the view parsing of
``cluster/ClusterConnectionManager.java:84-180``, extracted so the two
client flavors cannot drift.

Everything here is pure (no I/O, no locks): inputs are command tuples and
CLUSTER SLOTS reply rows; outputs are slots, write flags, and redirect
decisions.  The clients own connections, retries, and timing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from redisson_tpu_torch.net import commands as C
from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.utils.crc16 import MAX_SLOT, calc_slot

# keyless commands whose answer is the union over every master — the RKeys
# scatter-gather surface (CommandAsyncService readAllAsync/writeAllAsync)
ALL_SHARD = {"KEYS": "concat", "DBSIZE": "sum", "FLUSHALL": "ok"}

# multi-key commands that are one atomic compound op server-side:
# all keys must colocate on one shard (Redis CROSSSLOT rule)
SAME_SLOT = {
    "PFMERGE", "BITOP", "RENAME", "MGET", "MSET", "MSETNX",
    "SMOVE", "LMOVE", "RPOPLPUSH",
    "SINTER", "SUNION", "SDIFF",
    "SINTERSTORE", "SUNIONSTORE", "SDIFFSTORE", "SINTERCARD",
    "ZUNIONSTORE", "ZINTERSTORE",
    "COPY", "RENAMENX", "SORT", "GEOSEARCHSTORE",
    "ZDIFF", "ZINTER", "ZUNION", "ZDIFFSTORE", "ZRANGESTORE",
    "LMPOP", "ZMPOP", "BLMPOP", "BZMPOP", "BLPOP", "BRPOP", "BLMOVE", "BRPOPLPUSH",
    "BZPOPMIN", "BZPOPMAX", "XREAD", "XREADGROUP",
}
# (MGET/MSET follow real Redis cluster semantics: multi-key commands
#  spanning slots raise CROSSSLOT; use {hashtags} or the RBuckets
#  handles, which split per shard client-side)

# sentinel slot meaning "cross-slot but splittable" (DEL/UNLINK grouping)
SPLIT = -1


def route(cmd: str, args: tuple) -> Tuple[Optional[int], bool]:
    """(slot | None | SPLIT, is_write) for one command.

    None = keyless (any node); SPLIT = multi-key spanning slots where the
    caller groups per shard.  PUBLISH routes by channel slot as a write —
    subscriptions live on the channel's slot-owner master, so a publish
    must land there or fan-out silently drops."""
    cu = cmd.upper()
    if cu in ("PUBLISH", "SPUBLISH") and args:
        ch = args[0]
        return calc_slot(ch if isinstance(ch, bytes) else str(ch).encode()), True
    keys = C.command_keys(cmd, list(args))
    write = C.is_write(cmd, list(args))
    if not keys:
        return None, write
    slots = {calc_slot(k if isinstance(k, bytes) else str(k).encode()) for k in keys}
    if len(slots) > 1:
        if cu in SAME_SLOT:
            raise RespError(
                f"CROSSSLOT keys of {cmd} map to different slots; use a "
                "{hashtag} to colocate them"
            )
        return SPLIT, write
    return slots.pop(), write


# Keyless READ verbs a replica serves: the FT search surface is
# read-classified and keyless (indexes are named, not keyed — net/commands
# SPECS), and the server's check_routing admits keyless reads on replicas,
# so the read-only legs of FT.MSEARCH / execute_many fan-outs may ride the
# replica plane.  The admin/introspection remainder of the keyless surface
# stays master-routed.
FT_REPLICA_READS = frozenset((
    "FT.SEARCH", "FT.MSEARCH", "FT.AGGREGATE", "FT.INFO",
))


def replica_readable(cmd: str, args: tuple) -> bool:
    """True when a READONLY replica may serve this command: the
    client-side mirror of the server's check_routing admission — keyed
    (slot-routed, single slot) and read-classified, plus the keyless FT
    read verbs (FT_REPLICA_READS).  Other keyless commands route to
    masters (admin surface), writes always do, and split multi-key reads
    re-enter per group where each group is re-checked."""
    try:
        slot, write = route(cmd, args)
    except RespError:
        return False  # CROSSSLOT surfaces on the normal path
    if write:
        return False
    if slot is None:
        return cmd.upper() in FT_REPLICA_READS
    return slot != SPLIT


def parse_view(view_rows: List[Any]) -> Tuple[List[Optional[str]], Dict[str, None]]:
    """CLUSTER SLOTS reply -> (slot->addr table, ordered master addr set)."""
    new_slots: List[Optional[str]] = [None] * MAX_SLOT
    masters: Dict[str, None] = {}
    for row in view_rows:
        lo, hi, (host, port, _nid) = int(row[0]), int(row[1]), row[2]
        host = host.decode() if isinstance(host, bytes) else host
        addr = f"{host}:{int(port)}"
        masters[addr] = None
        for s in range(lo, hi + 1):
            new_slots[s] = addr
    return new_slots, masters


def classify_redirect(err: RespError) -> Tuple[Optional[str], Optional[str]]:
    """(kind, target_addr) where kind is "moved" | "ask" | "tryagain" | None.

    MOVED refreshes topology and re-routes; ASK is a one-shot hop into a
    migration window WITHOUT a view update; TRYAGAIN backs off (multi-key
    op spanning a half-drained window)."""
    msg = str(err)
    if msg.startswith("MOVED "):
        parts = msg.split()
        return "moved", parts[2] if len(parts) > 2 else None
    if msg.startswith("ASK "):
        parts = msg.split()
        return "ask", parts[2] if len(parts) > 2 else None
    if msg.startswith("TRYAGAIN"):
        return "tryagain", None
    return None, None


def is_redirect(err: RespError) -> bool:
    return classify_redirect(err)[0] is not None


def group_by_slot_owner(
    slot_table: List[Optional[str]], names: List[Any]
) -> Dict[Optional[str], List[int]]:
    """Index positions grouped by owning master address (OBJCALLM / batch
    per-shard grouping — the executeBatchedAsync discipline)."""
    groups: Dict[Optional[str], List[int]] = {}
    for i, name in enumerate(names):
        if name:
            kb = name if isinstance(name, bytes) else str(name).encode()
            addr = slot_table[calc_slot(kb)]
        else:
            addr = None
        groups.setdefault(addr, []).append(i)
    return groups


# blob sketch verbs whose same-verb frame runs the server may fuse into one
# stacked-bank kernel dispatch (server/verbs/sketch.py coalesce_bloom_run —
# the adaptive coalescing plane).  Listed HERE because run shape is
# routing-adjacent pure logic: clients that order a shard's frame to keep
# same-verb commands adjacent (the natural order of a fan-out batch) get
# maximal runs server-side for free.
COALESCIBLE_BLOB_VERBS = frozenset((b"BF.MADD64", b"BF.MEXISTS64"))


def coalescible_frame_runs(cmds: List[Any]) -> List[Tuple[int, int]]:
    """Maximal [start, end) runs (len >= 2) of CONSECUTIVE same-verb
    coalescible blob commands in one pipelined frame.  Pure scan: the server
    frame loop replaces each run with a single fused dispatch; everything
    outside the runs dispatches per command, so frame order is untouched."""
    def verb_of(cmd) -> Optional[bytes]:
        # malformed frames carry non-bytes elements (nested arrays, ints);
        # they are NOT runs — the per-command path replies their errors
        if (
            isinstance(cmd, list)
            and cmd
            and isinstance(cmd[0], (bytes, bytearray))
        ):
            return bytes(cmd[0]).upper()
        return None

    out: List[Tuple[int, int]] = []
    i, n = 0, len(cmds)
    while i < n:
        verb = verb_of(cmds[i])
        if verb not in COALESCIBLE_BLOB_VERBS:
            i += 1
            continue
        j = i + 1
        while j < n and verb_of(cmds[j]) == verb:
            j += 1
        if j - i >= 2:
            out.append((i, j))
        i = j
    return out


def group_by_slot(keys: List[Any]) -> Dict[int, List[Any]]:
    """Keys grouped by slot (cross-slot DEL/UNLINK splitting: one multi-key
    sub-command per slot, NEVER one round trip per key)."""
    groups: Dict[int, List[Any]] = {}
    for key in keys:
        kb = key if isinstance(key, bytes) else str(key).encode()
        groups.setdefault(calc_slot(kb), []).append(key)
    return groups
