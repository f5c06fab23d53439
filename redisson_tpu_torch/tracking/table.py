"""Server-side key-tracking table (the Redis 6 ``CLIENT TRACKING`` role).

One ``TrackingTable`` per ``TpuServer``.  Connections opt in with
``CLIENT TRACKING ON [REDIRECT <client-id>] [BCAST [PREFIX <p>]...]
[NOLOOP]``; from then on:

  * **default mode** — every READ a tracking connection performs records
    (key -> client-id) in a bounded table.  The registration happens
    PRE-dispatch (before the read handler runs): a concurrent writer on
    another worker thread then either applied before our read (we read the
    new value) or scans the table after our registration (we get the
    invalidation) — the ordering race a single-threaded Redis never has.
    The table is bounded by ``max_keys``: overflow evicts the
    least-recently-registered key and sends its trackers a SYNTHETIC
    invalidation (the Redis ``tracking-table-max-keys`` discipline), so a
    client can never hold a stale entry the server no longer remembers.
  * **BCAST mode** — no per-key memory; the connection subscribes key
    PREFIXES and every write under a prefix broadcasts.

Every mutating verb (post-dispatch, after the handler applied), expiry,
``FLUSHALL`` and the slot-migration/failover handoff emit a RESP3
``>2\r\n$10\r\ninvalidate\r\n*1\r\n$<n>\r\n<key>\r\n`` push on the tracking
connection — or on its REDIRECT target (the RESP2-client path: the data
connection stays push-free, a dedicated connection with a reader consumes
the stream).  Pushes ride the existing per-connection writer/completion
queue (``ctx.push`` -> ``write_q``), so FIFO ordering with ``_PendingFrame``
readbacks and the proto-snapshot contract are preserved by construction.

Slot handoffs are FENCE-EPOCH-stamped: ``invalidate_slot(slot, epoch)``
records the highest epoch it emitted for each slot, so a journaled
coordinator's idempotent re-issue (same epoch) or a stale coordinator's
late write (lower epoch) cannot re-storm clients — and a ``RECOVERING``
slot invalidates BEFORE it serves again (``set_slot_recovering``).

Disconnect cleanup: a dying connection's tracked keys leave the table with
it, and a dying REDIRECT *target* breaks tracking for every connection that
pointed at it (their cached state can no longer be invalidated, so serving
it would be silently stale — tracking turns OFF and the break is counted).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Set

from redisson_tpu_torch.net import commands as C
from redisson_tpu_torch.net.resp import Push, RespError
from redisson_tpu_torch.utils.crc16 import calc_slot

# default bound on the per-node tracked-key table (Redis's
# tracking-table-max-keys default is 1e6; this node also holds device state,
# so the default is tighter — CONFIG SET tracking-table-max-keys tunes it)
DEFAULT_MAX_KEYS = 65536


class ConnTracking:
    """Per-connection tracking state (lives on ``CommandContext.tracking``)."""

    __slots__ = ("on", "bcast", "prefixes", "redirect", "noloop", "nkeys")

    def __init__(self):
        self.on = False
        self.bcast = False
        self.prefixes: tuple = ()
        self.redirect: Optional[int] = None  # target client id (RESP2 path)
        self.noloop = False
        self.nkeys = 0  # keys currently tracked for this conn (default mode)

    def flags(self) -> List[bytes]:
        """CLIENT TRACKINGINFO flag list (Redis wording)."""
        out = [b"on" if self.on else b"off"]
        if self.bcast:
            out.append(b"bcast")
        if self.noloop:
            out.append(b"noloop")
        return out


class TrackingTable:
    def __init__(self, server, max_keys: int = DEFAULT_MAX_KEYS):
        self._server = server
        self._lock = threading.Lock()
        self.max_keys = max_keys
        # all registered connections (client id -> CommandContext); tracking
        # needs the id->push route for REDIRECT targets even before the
        # target itself enables anything
        self._conns: Dict[int, object] = {}
        # tracking-ENABLED connections (client id -> ConnTracking)
        self._states: Dict[int, ConnTracking] = {}
        # default-mode memory: key -> client ids, LRU by registration recency
        self._keys: "OrderedDict[str, Set[int]]" = OrderedDict()
        # slot -> tracked keys in it, maintained at registration time so a
        # slot handoff invalidates in O(keys-in-slot) instead of scanning
        # the whole table under the lock (the dispatch hot path shares it)
        self._slot_index: Dict[int, Set[str]] = {}
        # cid -> keys it registered (reverse index): disconnect purge is
        # O(keys-owned-by-conn), not O(table) — same scan-under-the-
        # dispatch-lock hazard as the slot scan
        self._client_keys: Dict[int, Set[str]] = {}
        # BCAST-enabled cids: note_write's stateless prefix match walks
        # only these (the common no-BCAST deployment pays nothing per key)
        self._bcast_cids: Set[int] = set()
        # fence-epoch memory: slot -> highest epoch already invalidated (the
        # idempotence that makes journal-resume re-issues push-storm-free)
        self._slot_epochs: Dict[int, int] = {}
        # `active` is read LOCK-FREE on the dispatch hot path (an int load);
        # it counts tracking-enabled connections so a server with no
        # tracking clients pays one attribute load + one compare per command
        self.active = 0
        self.stats = {
            "pushes": 0,            # invalidation push frames sent
            "keys_invalidated": 0,  # keys named across those frames
            "overflow_evictions": 0,
            "redirect_broken": 0,   # conns whose REDIRECT target died
            "dropped": 0,           # push had no live route (conn raced away)
            "slot_flushes": 0,      # slot-handoff invalidation sweeps
        }

    # -- connection lifecycle -------------------------------------------------

    def register_conn(self, ctx) -> None:
        with self._lock:
            self._conns[ctx.client_id] = ctx

    def unregister_conn(self, ctx) -> None:
        """Disconnect cleanup: drop the conn's tracked keys and, if it was a
        REDIRECT target, break (turn off) tracking for its dependents."""
        cid = ctx.client_id
        synth_target = None
        with self._lock:
            self._conns.pop(cid, None)
            st = self._states.pop(cid, None)
            self._bcast_cids.discard(cid)
            if st is not None and st.on:
                self.active -= 1
            owned = self._purge_client_locked(cid)
            # a dying DATA connection strands its registrations: the server
            # is about to forget them, but the client's near cache (fed
            # through a REDIRECT target that is still alive) may hold the
            # entries those registrations guarded.  Synthetic invalidation
            # through the surviving feed — the same never-silently-stale
            # rule as bounded-table overflow.  Without REDIRECT the push
            # route WAS the dead socket: nothing to tell (Redis behavior).
            if (st is not None and st.on and not st.bcast
                    and st.redirect is not None and owned):
                synth_target = self._conns.get(st.redirect)
            # a dead redirect target orphans its dependents' invalidation
            # stream: their caches can never be invalidated again, so their
            # tracking MUST break loudly (Redis sends tracking-redir-broken;
            # here the state flips off and the break is counted)
            for dep_cid, dep_st in list(self._states.items()):
                if dep_st.redirect == cid:
                    dep_st.on = False
                    dep_st.redirect = None
                    self.active -= 1
                    self._bcast_cids.discard(dep_cid)
                    self.stats["redirect_broken"] += 1
                    del self._states[dep_cid]
                    self._purge_client_locked(dep_cid)
        if synth_target is not None:
            self._push_to(synth_target, owned)

    def _purge_client_locked(self, cid: int) -> List[str]:
        """Drop every registration `cid` holds, O(keys-owned-by-conn) via
        the reverse index.  Returns the names it had registered."""
        owned = self._client_keys.pop(cid, None)
        if not owned:
            return []
        for name in owned:
            cids = self._keys.get(name)
            if cids is None:
                continue
            cids.discard(cid)
            if not cids:
                del self._keys[name]
                self._index_del_locked(name)
        return list(owned)

    # -- slot index (every _keys add/remove mirrors here) ---------------------

    def _index_add_locked(self, name: str) -> None:
        self._slot_index.setdefault(calc_slot(name.encode()), set()).add(name)

    def _index_del_locked(self, name: str) -> None:
        slot = calc_slot(name.encode())
        keys = self._slot_index.get(slot)
        if keys is not None:
            keys.discard(name)
            if not keys:
                del self._slot_index[slot]

    # -- CLIENT TRACKING ------------------------------------------------------

    def enable(self, ctx, *, bcast: bool = False, prefixes=(),
               redirect: Optional[int] = None, noloop: bool = False) -> None:
        with self._lock:
            if redirect is not None and redirect not in self._conns:
                raise RespError(
                    "ERR The client ID you want redirect to does not exist"
                )
            st = self._states.get(ctx.client_id)
            if st is None:
                st = ConnTracking()
            if not st.on:
                self.active += 1
            st.on = True
            st.bcast = bool(bcast)
            st.prefixes = tuple(prefixes) if bcast else ()
            st.redirect = redirect
            st.noloop = bool(noloop)
            self._states[ctx.client_id] = st
            if st.bcast:
                self._bcast_cids.add(ctx.client_id)
            else:
                self._bcast_cids.discard(ctx.client_id)
            ctx.tracking = st

    def disable(self, ctx) -> None:
        with self._lock:
            st = self._states.pop(ctx.client_id, None)
            self._bcast_cids.discard(ctx.client_id)
            if st is not None and st.on:
                self.active -= 1
                st.on = False
            self._purge_client_locked(ctx.client_id)
            ctx.tracking = st

    def state_of(self, ctx) -> Optional[ConnTracking]:
        with self._lock:
            return self._states.get(ctx.client_id)

    # -- dispatch hooks (server/registry.py) ----------------------------------

    def pre_dispatch(self, ctx, cmd: bytes, args) -> None:
        """READ registration, BEFORE the handler runs (see module doc for
        why pre- and not post-: the registration must be visible to any
        writer whose mutation our read missed)."""
        st = ctx.tracking
        if st is None or not st.on or st.bcast:
            return
        name = cmd.decode()
        # OBJCALLV is the transactional READ — write-classified only so it
        # routes to the committing master (the version source); here it
        # registers like any read and must never invalidate
        if name != "OBJCALLV" and C.is_write(name, args):
            return
        keys = C.command_keys(name, args)
        if keys:
            self.note_read(ctx, [self._kname(k) for k in keys])

    def post_dispatch(self, ctx, cmd: bytes, args) -> None:
        """WRITE invalidation, AFTER the handler applied successfully."""
        name = cmd.decode()
        if name in ("FLUSHALL", "FLUSHDB"):
            self.invalidate_all(ctx)
            return
        if name == "OBJCALLV" or not C.is_write(name, args):
            return
        keys = C.command_keys(name, args)
        if keys:
            names = [self._kname(k) for k in keys]
            self.note_write(names, ctx)
            self._note_search_ingest(names)

    def _note_search_ingest(self, names: List[str]) -> None:
        """A write under a search index's prefixes is that index's INGEST
        STREAM: invalidate the index's synthetic query key so tracked
        FT.SEARCH results (near-cached KNN hits) never serve stale.  Writer NOLOOP is deliberately NOT honored — the writer's own
        cached query results are just as stale as anyone's.  Runs only when
        tracking is active (post_dispatch already gated) and only if the
        search service exists."""
        svc = self._server.engine._services.get("search")
        if svc is None:
            return
        try:
            qkeys = svc.ingest_touched(names)
        except Exception:  # noqa: BLE001 — instrumentation must not fail writes
            return
        if qkeys:
            self.note_write(qkeys, None)

    @staticmethod
    def _kname(k) -> str:
        return k.decode() if isinstance(k, (bytes, bytearray)) else str(k)

    # -- default-mode memory --------------------------------------------------

    def note_read(self, ctx, names: List[str]) -> None:
        cid = ctx.client_id
        overflow: List[tuple] = []
        with self._lock:
            st = self._states.get(cid)
            if st is None or not st.on or st.bcast:
                return
            for name in names:
                cids = self._keys.get(name)
                if cids is None:
                    cids = self._keys[name] = set()
                    self._index_add_locked(name)
                elif cid in cids:
                    self._keys.move_to_end(name)
                    continue
                cids.add(cid)
                self._client_keys.setdefault(cid, set()).add(name)
                st.nkeys += 1
                self._keys.move_to_end(name)
            overflow = self._evict_overflow_locked()
        for victim, vcids in overflow:
            targets: Dict[int, List[str]] = {vc: [victim] for vc in vcids}
            self._deliver(targets)

    def _evict_overflow_locked(self) -> List[tuple]:
        """Bounded table: evict oldest-registered keys with a SYNTHETIC
        invalidation to their trackers — the client forgets exactly what
        the server is about to forget (never silently stale).  Returns the
        (key, cids) pairs to deliver AFTER the lock drops."""
        overflow: List[tuple] = []
        while len(self._keys) > self.max_keys:
            victim, vcids = self._keys.popitem(last=False)
            self._index_del_locked(victim)
            self.stats["overflow_evictions"] += 1
            for vc in vcids:
                vst = self._states.get(vc)
                if vst is not None:
                    vst.nkeys -= 1
                ck = self._client_keys.get(vc)
                if ck is not None:
                    ck.discard(victim)
            overflow.append((victim, vcids))
        return overflow

    # -- write-side invalidation ----------------------------------------------

    def note_write(self, names: List[str], writer_ctx=None) -> None:
        """Invalidate `names` for every interested connection.  Default-mode
        entries are POPPED (one shot, like Redis); BCAST prefixes match
        statelessly.  ``writer_ctx`` with NOLOOP set is skipped."""
        if not names:
            return
        writer_cid = writer_ctx.client_id if writer_ctx is not None else None
        targets: Dict[int, List[str]] = {}
        overflow: List[tuple] = []
        with self._lock:
            if not self._states:
                return
            wst = self._states.get(writer_cid) if writer_cid is not None else None
            for name in names:
                cids = self._keys.pop(name, None)
                keep: Set[int] = set()
                if cids:
                    for cid in cids:
                        st = self._states.get(cid)
                        if st is None:
                            continue
                        if cid == writer_cid and st.noloop:
                            # NOLOOP self-write: the push is suppressed AND
                            # the registration survives (see below).  "Self"
                            # is deliberately ONE CONNECTION (Redis's own
                            # scope), NOT every conn sharing the writer's
                            # redirect feed: a same-facade write through a
                            # PLAIN (untracked) handle rides the same armed
                            # pool, and only the push keeps the facade's
                            # near cache coherent for it — widening "self"
                            # to the feed would make any mixed tracked/plain
                            # usage silently stale forever, for a cross-conn
                            # self-push saving that measures as noise
                            # (config6 13.06x -> 13.24x).
                            keep.add(cid)
                            continue
                        st.nkeys -= 1
                        ck = self._client_keys.get(cid)
                        if ck is not None:
                            ck.discard(name)
                        targets.setdefault(cid, []).append(name)
                # a NOLOOP writer's own write REGISTERS the key for it:
                # its near cache seeds the value it just wrote (tracked
                # handles' own-write discipline), so a LATER foreign write
                # must find a registration to invalidate — popping it (or
                # never having one, for a write with no prior read) would
                # leave the seeded entry silently stale forever
                if (wst is not None and wst.on and wst.noloop
                        and not wst.bcast and writer_cid not in keep):
                    keep.add(writer_cid)
                    self._client_keys.setdefault(writer_cid, set()).add(name)
                    wst.nkeys += 1
                if keep:
                    self._keys[name] = keep
                    self._keys.move_to_end(name)
                    if cids is None:
                        self._index_add_locked(name)
                elif cids is not None:
                    self._index_del_locked(name)
                # BCAST: stateless prefix match over the (usually empty)
                # BCAST subset only — not every tracking connection
                for cid in self._bcast_cids:
                    st = self._states.get(cid)
                    if st is None:
                        continue
                    if cid == writer_cid and st.noloop:
                        continue
                    if not st.prefixes or any(
                        name.startswith(p) for p in st.prefixes
                    ):
                        bucket = targets.setdefault(cid, [])
                        if not bucket or bucket[-1] != name:
                            bucket.append(name)
            # write-side registrations count against the same bound
            overflow = self._evict_overflow_locked()
        self._deliver(targets)
        for victim, vcids in overflow:
            self._deliver({vc: [victim] for vc in vcids})

    def note_expired(self, names: List[str]) -> None:
        """TTL reaper / lazy-expiry hook (DeviceStore.on_expired).  An
        expiring hash under a search index's prefixes is ingest-stream
        churn too (sync() prunes the doc), so the index query key
        invalidates exactly like a DEL's would."""
        names = list(names)
        self.note_write(names, None)
        self._note_search_ingest(names)

    def note_objcall_ops(self, ops, writer_ctx=None) -> None:
        """OBJCALLM / OBJCALLMA / TXEXEC frames are keyless on the wire —
        their (factory, name, method, ...) tuples carry the real keys."""
        names = [
            str(op[1]) for op in ops
            if op[1] and C.objcall_is_write(str(op[2]))
        ]
        if names:
            self.note_write(names, writer_ctx)
            self._note_search_ingest(names)

    def invalidate_all(self, writer_ctx=None) -> None:
        """FLUSHALL discipline: one null-payload invalidate per tracking
        connection (the 'everything you cached is gone' frame).  NOLOOP is
        NOT honored here (Redis's rule too): the writer has no way to
        enumerate-and-drop its own cached keys locally, so suppressing the
        flush frame would leave its whole near cache serving deleted data."""
        del writer_ctx  # kept for the post_dispatch call shape
        with self._lock:
            self._keys.clear()
            self._slot_index.clear()
            self._client_keys.clear()
            cids = []
            for cid, st in self._states.items():
                st.nkeys = 0
                cids.append(cid)
        self._deliver({cid: None for cid in cids})

    def invalidate_slot(self, slot: int, epoch: Optional[int] = None,
                        store_names: Optional[List[str]] = None) -> int:
        """Slot-handoff invalidation (migration finalize / RECOVERING
        fence): every tracked key hashing to `slot` invalidates, plus —
        for BCAST listeners — the store's current names in the slot.

        Fence-epoch stamped: a re-issue at the same (or a lower) epoch is a
        journaled coordinator's idempotent resume (or a stale one's late
        write) and emits NOTHING — the fencing that keeps journal replay
        from re-storming every near cache.  Epoch-less calls always emit.
        Recording at the RECOVERING fence deliberately dedupes the resumed
        migration's STABLE finalize at the same epoch: nothing can register
        in between (check_routing answers TRYAGAIN for a RECOVERING slot
        BEFORE pre-dispatch registration), so the fence's own flush already
        covered every registration the finalize would.
        Returns the number of keys invalidated."""
        with self._lock:
            if epoch is not None:
                if epoch <= self._slot_epochs.get(slot, -1):
                    return 0
                self._slot_epochs[slot] = epoch
            if not self._states:
                return 0
            names = list(self._slot_index.get(slot, ()))
        extra = [
            n for n in (store_names or [])
            if n not in names
        ]
        self.stats["slot_flushes"] += 1
        self.note_write(names, None)
        if extra:
            # tracked-table names already covered default-mode clients; the
            # store's remaining names in the slot only matter to BCAST
            # listeners (no per-key memory to consult)
            with self._lock:
                has_bcast = bool(self._bcast_cids)
            if has_bcast:
                self.note_write(extra, None)
        return len(names) + len(extra)

    # -- delivery -------------------------------------------------------------

    def _deliver(self, targets: Dict[int, Optional[List[str]]]) -> None:
        """Send one ``invalidate`` push per target connection — through its
        REDIRECT route when set.  The push rides ``ctx.push`` (the
        per-connection completion queue), so it serializes FIFO with
        pending readback frames and encodes with the TARGET connection's
        negotiated protocol (a RESP2 redirect target gets the ``*2``
        array projection of the same frame — byte-for-byte the proto-2
        encoding of the RESP3 push)."""
        if not targets:
            return
        for cid, names in targets.items():
            with self._lock:
                st = self._states.get(cid)
                route = st.redirect if (st is not None and st.redirect) else cid
                target = self._conns.get(route)
            self._push_to(target, names)

    def _push_to(self, target, names: Optional[List[str]]) -> None:
        push_fn = getattr(target, "push", None) if target is not None else None
        if push_fn is None:
            self.stats["dropped"] += 1
            return
        payload = None if names is None else [n.encode() for n in names]
        try:
            push_fn(Push([b"invalidate", payload]))
            self.stats["pushes"] += 1
            self.stats["keys_invalidated"] += len(names or ())
        except Exception:  # noqa: BLE001 — a dying loop must not fail writes
            self.stats["dropped"] += 1

    # -- introspection --------------------------------------------------------

    def census(self) -> Dict[str, float]:
        """Leak-accounting probe (chaos/census.py): sizes only — monotonic
        counters live in ``stats`` and are exposed as metrics gauges, not
        census rows (a counter that moved is not a leak)."""
        with self._lock:
            return {
                "table_keys": float(len(self._keys)),
                "slot_index_keys": float(
                    sum(len(s) for s in self._slot_index.values())
                ),
                "client_index_keys": float(
                    sum(len(s) for s in self._client_keys.values())
                ),
                "tracking_conns": float(
                    sum(1 for st in self._states.values() if not st.bcast)
                ),
                "bcast_conns": float(
                    sum(1 for st in self._states.values() if st.bcast)
                ),
            }

    def tracked_key_count(self) -> int:
        with self._lock:
            return len(self._keys)
