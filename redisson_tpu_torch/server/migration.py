"""Slot-migration orchestrator: live rebalancing with zero lost acked writes.

A copy of ``redisson_tpu/server/migration.py``.  Redis drives a reshard as:
SETSLOT IMPORTING on the target, SETSLOT MIGRATING on the source, MIGRATE
each key, SETSLOT NODE everywhere; clients follow the MOVED and ASK
redirects.  This orchestrator drives it for the port's nodes, with
records (whole device-backed objects) as the migration unit and the
replication serializer (``server/replication.serialize_records``, the
reference's blob format) as the transfer format.

Protocol walk (per slot):
  1. target: CLUSTER SETSLOT <s> IMPORTING <source>   (admit ASKING traffic)
  2. source: CLUSTER SETSLOT <s> MIGRATING <target>   (absent keys -> ASK;
     record creation in the slot is barred by the store's absent guard)
  3. source: CLUSTER MIGRATESLOTS <s...> until 0      (each batch of records
     moves atomically under its record locks: serialize -> IMPORTRECORDS ->
     delete)
  4. everyone: CLUSTER SETVIEW <new view>; source+target: SETSLOT STABLE
     (clears the window; clients converge via MOVED + refresh)

During the window writes are never dropped: a record still on the source
serves there; a record already moved ASK-redirects; creations ASK-redirect.

Crash safety: pass ``journal_dir=`` and the run becomes a **journaled state
machine**: every phase is recorded write-ahead in a
:class:`~redisson_tpu_torch.server.migration_journal.MigrationJournal`
(PLANNED -> WINDOW_OPEN -> DRAINING(sweep progress) -> VIEW_COMMITTED ->
STABLE/ROLLED_BACK), each ``SETSLOT``/``MIGRATESLOTS`` carries the
migration's fencing ``EPOCH`` (stale coordinators get ``STALEEPOCH``), and
:func:`resume_migrations` replays the journal directory after a
coordinator crash: migrations that died before opening the window roll
back (reverse-draining any ASK-created strays), migrations that died later
complete forward, idempotently, because every re-sent verb is safe under
the recorded epoch and views.  ``crash_after=`` is the deterministic kill
hook that stops the coordinator at a phase boundary.

Admin links ride :class:`~redisson_tpu_torch.net.retry.RetryPolicy`
(bounded exponential backoff + jitter + deadline), so a transient
refuse-connect does not abort a whole reshard.

Device rebalances (``rebalance_devices``) move slots between the mesh
positions of one process on ``Engine.move_slots_records``, journaled in the
same directory.  ``evacuation_plan`` and ``shed_plan`` spread a position's
slots round robin over the survivors (the positions whose lanes are not
quarantined, ``core/ioplane.quarantined_device_ids``), and
``evacuate_device`` runs the whole plan as a journaled device rebalance:
CLUSTER DEVEVACUATE and the residency plane's CLUSTER RESIDENCY SHED.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from redisson_tpu_torch.net.client import NodeClient
from redisson_tpu_torch.net.retry import RetryPolicy, link_policy
from redisson_tpu_torch.server.migration_journal import ImportJournal, MigrationJournal
from redisson_tpu_torch.utils.crc16 import MAX_SLOT


class CoordinatorKilled(BaseException):
    """The deterministic coordinator-kill hook (``crash_after=``): raised
    at a phase boundary to simulate the process dying there.  Derives from
    BaseException so no best-effort ``except Exception`` in the protocol
    path can swallow the 'death' — exactly like a real SIGKILL, nothing
    (including rollback) runs after it."""


def _admin_retry_policy() -> RetryPolicy:
    """Migration control traffic's retry schedule: a fresh policy per link
    (each carries its own jitter RNG) with a deadline that bounds any one
    control verb's total retry budget.  Numbers come from the active link
    profile (RTPU_RETRY_PROFILE): ``lan`` by default, ``wan`` stretches
    attempts, backoff and deadline for cross-host links."""
    return link_policy("admin")


def _admin(addr: str, password: Optional[str], ssl_context=None) -> NodeClient:
    return NodeClient(
        addr, password=password, ping_interval=0,
        retry_policy=_admin_retry_policy(), ssl_context=ssl_context,
    )


def migrate_slots(
    source: str,
    target: str,
    slots: Sequence[int],
    all_nodes: Optional[Sequence[str]] = None,
    password: Optional[str] = None,
    ssl_context=None,
    journal_dir: Optional[str] = None,
    crash_after: Optional[str] = None,
) -> int:
    """Move `slots` from `source` to `target` while both serve traffic.

    `all_nodes` = every node (masters + replicas) that should learn the new
    view; defaults to the masters named in the source's current view plus
    the target.  Returns the number of records moved.

    With ``journal_dir`` the run is journaled + fenced (see module
    docstring); ``crash_after=<PHASE>`` (or ``"DRAINING:<sweep>"``) raises
    :class:`CoordinatorKilled` right after that phase's journal entry —
    the chaos tier's deterministic kill switch.
    """
    journal = (
        MigrationJournal.create(journal_dir, source, target)
        if journal_dir is not None else None
    )
    run = _MigrationRun(
        source, target, slots, all_nodes=all_nodes, password=password,
        ssl_context=ssl_context, journal=journal, crash_after=crash_after,
    )
    return run.execute()


def resume_migrations(
    journal_dir: str,
    password: Optional[str] = None,
    ssl_context=None,
    gc_keep: Optional[int] = 64,
    readdress: Optional[Dict[str, str]] = None,
) -> List[Dict[str, Any]]:
    """Settle every in-flight migration the journal directory records —
    the coordinator-restart path.  Idempotent: re-running it (even after
    ANOTHER crash mid-resume) converges, because every replayed verb
    carries the migration's recorded epoch and views.

    Policy per last-recorded phase:

      * ``PLANNED`` — the window may be partially open but no drain sweep
        was recorded: ROLL BACK (close the window, reverse-drain strays an
        ASK redirect created on the target, restore the recorded old view).
      * ``WINDOW_OPEN`` / ``DRAINING`` / ``VIEW_COMMITTED`` — COMPLETE
        forward: re-open the window (idempotent re-send), drain to zero,
        re-commit the recorded new view, stabilize + propagate.

    Returns one summary dict per journal touched; a migration whose nodes
    are unreachable is reported ``"failed"`` and left non-terminal for the
    next resume pass rather than aborting the others.

    After settling, terminal journals older than the newest ``gc_keep`` are
    pruned (``MigrationJournal.gc`` — the GC policy long-lived coordinators
    need so the journal directory stops growing one file per migration
    forever; terminal IMPORT journals ride the same sweep, in-flight ones
    never do); pass ``gc_keep=None`` to keep everything.

    ``readdress`` maps a DEAD node's address to its promoted successor's
    (``ClusterSupervisor.promote_replica``): every replayed verb, dial, and
    recorded view row naming the old address is rewritten to the new one —
    the replica that REPLPUSH-covered the in-flight import batches becomes
    the migration's target and the pair still converges to STABLE.
    """
    out: List[Dict[str, Any]] = []
    myid_cache: Dict[str, Optional[str]] = {}
    for ij in ImportJournal.in_flight(journal_dir):
        # a torn OPENED line (crash mid-first-append) leaves an import
        # journal with zero intact entries: no batch ever became durable,
        # but no node will claim it (its target is unreadable) — settle it
        # here or it reads in-flight forever and gc pins its coordinator
        # journal for eternity
        if not ij.entries:
            ij.append("ROLLED_BACK", resumed=True,
                      reason="torn import journal; no durable batches")
    for journal in MigrationJournal.in_flight(journal_dir):
        planned = journal.entry("PLANNED")
        if planned is None:  # only a torn PLANNED line: nothing ever ran
            journal.append("ROLLED_BACK", resumed=True, reason="empty journal")
            out.append({"id": journal.migration_id, "action": "rolled_back"})
            continue
        if planned.get("kind") == "device_rebalance":
            # intra-process device moves share the journal
            # directory's epoch allocator but resume through
            # resume_device_rebalances — treating one as a slot migration
            # would dial "dev:N" as a node address
            continue
        if readdress:
            planned = _readdress_planned(
                planned, readdress, myid_cache, password, ssl_context
            )
        run = _MigrationRun(
            planned["source"], planned["target"], planned["slots"],
            all_nodes=planned.get("all_nodes"), password=password,
            ssl_context=ssl_context, journal=journal,
        )
        try:
            if journal.phase == "PLANNED":
                run.resume_rollback(planned)
                out.append({
                    "id": journal.migration_id, "action": "rolled_back",
                    "epoch": journal.epoch,
                })
            else:
                moved = run.resume_complete(planned)
                out.append({
                    "id": journal.migration_id, "action": "completed",
                    "moved": moved, "epoch": journal.epoch,
                })
        except Exception as e:  # noqa: BLE001 — settle the REST of the journals
            out.append({
                "id": journal.migration_id, "action": "failed", "error": repr(e),
            })
    if gc_keep is not None:
        MigrationJournal.gc(journal_dir, keep=gc_keep)
    return out


def _readdress_planned(
    planned: Dict[str, Any],
    readdress: Dict[str, str],
    myid_cache: Dict[str, Optional[str]],
    password: Optional[str],
    ssl_context,
) -> Dict[str, Any]:
    """Rewrite a PLANNED entry's addresses through a failover mapping
    ({dead "host:port": promoted "host:port"}): source/target dials plus
    every recorded view row, whose node id becomes the successor's (fetched
    once per address, best-effort — an unreachable successor keeps the
    recorded id and the resume reports "failed" for the next pass)."""
    def _myid(addr: str) -> Optional[str]:
        if addr not in myid_cache:
            c = None
            try:
                c = _admin(addr, password, ssl_context)
                myid_cache[addr] = _s(c.execute("CLUSTER", "MYID"))
            except Exception:  # noqa: BLE001 — successor unreachable too
                myid_cache[addr] = None
            finally:
                if c is not None:
                    c.close()
        return myid_cache[addr]

    out = dict(planned)
    out["source"] = readdress.get(planned["source"], planned["source"])
    out["target"] = readdress.get(planned["target"], planned["target"])
    if planned.get("all_nodes"):
        out["all_nodes"] = [
            readdress.get(a, a) for a in planned["all_nodes"]
        ]
    if out["target"] != planned["target"]:
        out["target_id"] = _myid(out["target"]) or planned.get("target_id")
    for key in ("old_view", "new_view"):
        rows = planned.get(key)
        if not rows:
            continue
        rewritten = []
        for lo, hi, h, p, nid in (tuple(r) for r in rows):
            addr = f"{h}:{p}"
            if addr in readdress:
                nh, _, np_ = readdress[addr].rpartition(":")
                rewritten.append(
                    (lo, hi, nh, int(np_), _myid(readdress[addr]) or nid)
                )
            else:
                rewritten.append((lo, hi, h, p, nid))
        out[key] = rewritten
    return out


def rearm_recovery(server, journal_dir: str) -> int:
    """Boot-time journal re-arm for a RESTARTED server process.

    A node SIGKILLed mid-migration loses its in-memory window state; its
    restored checkpoint may resurrect records the pre-crash drain already
    shipped to the target.  If the fresh process served those slots
    normally, two processes would accept writes for the same records (the
    restored stale lineage here, the shipped lineage there) and whichever
    fork loses the resumed drain's version reconciliation would silently
    drop acked writes.  So, BEFORE the listener answers its first command,
    the restart path replays the journal directory:

      * this node is the SOURCE of an in-flight migration — re-fence the
        epoch, re-arm the MIGRATING window (``resume_migrations``' drain
        needs it) and mark every slot RECOVERING: all keyed traffic gets
        ``TRYAGAIN`` until the resumed migration reaches STABLE (writes
        held off entirely: brief unavailability instead of a silent fork);
      * this node is the TARGET — re-fence the epoch and re-arm the
        IMPORTING window so in-flight ASK traffic is admitted again.

    The IMPORTING arm additionally replays this node's import
    journals: every batch this node journaled-then-acked is re-applied on
    top of the restored checkpoint (idempotent — ``apply_records``
    reconciles by version), because the source deleted those records on the
    strength of the ack and the SIGKILL took the applied copies with the
    process.  Replay policy per the matching COORDINATOR journal:

      * in flight — replay, keep the import journal open (the resumed
        migration's final SETSLOT STABLE settles it);
      * STABLE — replay (the records are this node's to keep; only their
        durable copy may predate the crash) and terminalize;
      * ROLLED_BACK and this node was the migration's TARGET — do NOT
        replay (the rollback reverse-drained the records home;
        resurrecting them would fork ownership), terminalize;
      * ROLLED_BACK and this node was the SOURCE — the journal holds the
        REVERSE drain's batches, which belong here: replay, terminalize;
      * missing (externally pruned — gc keeps coordinator journals whose
        epoch has an in-flight import journal, so this is abnormal) —
        favor durability: replay and terminalize.

    Returns the number of slot windows re-armed plus import journals
    replayed.  Wired to the CLI as ``tpu-server --journal-dir`` (the
    ClusterSupervisor passes its coordinator journal dir to every node it
    spawns).
    """
    from redisson_tpu_torch.server import replication

    n = 0
    addr = server.address()
    coordinator: Dict[int, MigrationJournal] = {}
    for journal in MigrationJournal.scan(journal_dir):
        planned = journal.entry("PLANNED")
        if planned is not None and planned.get("kind") != "device_rebalance":
            coordinator[journal.epoch] = journal
    for ij in ImportJournal.in_flight(journal_dir):
        if ij.target != addr:
            continue
        cj = coordinator.get(ij.epoch)
        cj_planned = cj.entry("PLANNED") if cj is not None else None
        if cj is not None and cj.phase == "ROLLED_BACK" \
                and (cj_planned or {}).get("source") != addr:
            ij.append("ROLLED_BACK", resumed=True,
                      reason="migration rolled back; records went home")
            continue
        for blob in ij.batch_blobs():
            replication.apply_records(server.engine, blob)
        n += 1
        if cj is None or cj.is_terminal():
            # the replayed records live only in memory until a checkpoint
            # covers them — terminalizing before that would hand a second
            # crash nothing to replay.  On save failure the journal stays
            # in flight on disk for the next boot.
            if server._checkpoint_import_state():
                ij.append("STABLE", resumed=True,
                          reason="migration already settled")
        else:
            server.adopt_import_journal(ij)
    for journal in MigrationJournal.in_flight(journal_dir):
        planned = journal.entry("PLANNED")
        if planned is None or planned.get("kind") == "device_rebalance":
            continue
        slots = [int(s) for s in planned["slots"]]
        epoch = journal.epoch
        if planned["source"] == addr:
            for s in slots:
                server.fence_slot_epoch(s, epoch)
                server.set_slot_migrating(s, planned["target"], epoch)
                server.set_slot_recovering(s, planned["target"], epoch)
                n += 1
        elif planned["target"] == addr:
            for s in slots:
                server.fence_slot_epoch(s, epoch)
                server.set_slot_importing(s, planned["source"])
                n += 1
    return n


class _MigrationRun:
    """One migration as an explicit state machine: phase methods shared by
    the fresh path (``execute``) and the journal-replay paths
    (``resume_complete`` / ``resume_rollback``)."""

    def __init__(
        self,
        source: str,
        target: str,
        slots: Sequence[int],
        all_nodes: Optional[Sequence[str]] = None,
        password: Optional[str] = None,
        ssl_context=None,
        journal: Optional[MigrationJournal] = None,
        crash_after: Optional[str] = None,
    ):
        self.source, self.target = source, target
        self.slots = [int(s) for s in slots]
        self.all_nodes = all_nodes
        self.password, self.ssl_context = password, ssl_context
        self.journal = journal
        self.crash_after = crash_after
        self.epoch: Optional[int] = journal.epoch if journal is not None else None
        self.src: Optional[NodeClient] = None
        self.tgt: Optional[NodeClient] = None

    # -- journal / crash plumbing --------------------------------------------

    def _record(self, phase: str, **data) -> None:
        if self.journal is not None:
            self.journal.append(phase, **data)

    def _crash_point(self, label: str) -> None:
        if self.crash_after is not None and self.crash_after == label:
            raise CoordinatorKilled(f"[chaos] coordinator killed after {label}")

    def _ep(self) -> Tuple:
        """Trailing fencing operands for SETSLOT (epoch-less when not
        journaled — legacy manual migrations stay unfenced)."""
        return ("EPOCH", self.epoch) if self.epoch is not None else ()

    def _ep_lead(self) -> Tuple:
        """Leading fencing operands for MIGRATESLOTS."""
        return ("EPOCH", self.epoch) if self.epoch is not None else ()

    def _connect(self) -> None:
        self.src = _admin(self.source, self.password, self.ssl_context)
        self.tgt = _admin(self.target, self.password, self.ssl_context)

    def _target_reachable(self) -> bool:
        """One cheap fresh-connection PING (no retry schedule): decides
        whether a failed journaled migration may roll back now or must stay
        in flight for a forward resume."""
        c = None
        try:
            c = NodeClient(
                self.target, password=self.password, ping_interval=0,
                retry_attempts=1, ssl_context=self.ssl_context,
            )
            c.execute("PING", timeout=2.0)
            return True
        except Exception:  # noqa: BLE001 — any failure reads as dead
            return False
        finally:
            if c is not None:
                c.close()

    def _close(self) -> None:
        for c in (self.src, self.tgt):
            if c is not None:
                c.close()

    # -- phases ---------------------------------------------------------------

    def _phase_open_window(self) -> None:
        # importing BEFORE migrating: an ASK redirect must never land on a
        # target that would bounce it back MOVED
        for s in self.slots:
            self.tgt.execute(
                "CLUSTER", "SETSLOT", s, "IMPORTING", self.source, *self._ep()
            )
        for s in self.slots:
            self.src.execute(
                "CLUSTER", "SETSLOT", s, "MIGRATING", self.target, *self._ep()
            )

    def _phase_drain(self, moved: int = 0) -> int:
        # one bulk call scans the store once for ALL slots; loop until a
        # sweep moves nothing (absent-guarded creations can't add names
        # behind the scan, so this converges in ~2 sweeps).  Each sweep is
        # journaled — a resumed coordinator knows how far the drain got.
        sweep_no = 0
        while True:
            n = int(
                self.src.execute(
                    "CLUSTER", "MIGRATESLOTS", *self._ep_lead(), *self.slots,
                    timeout=300.0,
                )
            )
            moved += n
            sweep_no += 1
            self._record("DRAINING", moved=moved, sweep=sweep_no, batch=n)
            self._crash_point(f"DRAINING:{sweep_no}")
            if n == 0:
                return moved

    def _phase_commit_view(self, new_view) -> List:
        flat: List = []
        for lo, hi, h, p, nid in new_view:
            flat += [lo, hi, h, p, nid]
        # Source and target MUST learn the new view before the window
        # closes — a target that still believes the old view would
        # MOVED-bounce the slot back at the source forever.
        self.tgt.execute("CLUSTER", "SETVIEW", *flat, timeout=10.0)
        self.src.execute("CLUSTER", "SETVIEW", *flat, timeout=10.0)
        return flat

    def _phase_stabilize(self, flat: List, known_view) -> None:
        for s in self.slots:
            self.src.execute("CLUSTER", "SETSLOT", s, "STABLE", *self._ep())
            self.tgt.execute("CLUSTER", "SETSLOT", s, "STABLE", *self._ep())
        # remaining nodes are best-effort: they converge via MOVED + refresh
        nodes = set(self.all_nodes or [])
        nodes.update(f"{h}:{p}" for _lo, _hi, h, p, _nid in known_view)
        nodes.discard(self.source)
        nodes.discard(self.target)
        for addr in nodes:
            c = None
            try:
                c = _admin(addr, self.password, self.ssl_context)
                c.execute("CLUSTER", "SETVIEW", *flat, timeout=10.0)
            except Exception:  # noqa: BLE001 — down node learns on recovery/MOVED
                pass
            finally:
                if c is not None:
                    c.close()

    # -- fresh run -------------------------------------------------------------

    def execute(self) -> int:
        moved = 0
        window_open = False
        old_view: List[Tuple[int, int, str, int, str]] = []
        self._connect()
        try:
            view = old_view = _fetch_view(self.src)
            target_id = _s(self.tgt.execute("CLUSTER", "MYID"))
            new_view = _reassign(view, self.slots, self.target, target_id)
            # WRITE-AHEAD: the PLANNED entry carries everything a resumed
            # coordinator needs — recorded BEFORE any remote mutation
            self._record(
                "PLANNED", source=self.source, target=self.target,
                slots=self.slots, epoch=self.epoch, old_view=old_view,
                new_view=new_view, target_id=target_id,
                all_nodes=list(self.all_nodes) if self.all_nodes else None,
            )
            self._crash_point("PLANNED")
            # set BEFORE opening: a failure mid-way through either SETSLOT
            # loop leaves a HALF-open window (e.g. target IMPORTING, source
            # untouched) that the rollback must still unwind
            window_open = True
            self._phase_open_window()
            self._record("WINDOW_OPEN")
            self._crash_point("WINDOW_OPEN")
            moved = self._phase_drain()
            self._crash_point("DRAINING")
            flat = self._phase_commit_view(new_view)
            self._record("VIEW_COMMITTED")
            self._crash_point("VIEW_COMMITTED")
            self._phase_stabilize(flat, view)
            self._record("STABLE", moved=moved)
            return moved
        except CoordinatorKilled:
            raise  # a 'dead' coordinator runs nothing — resume owns recovery
        except BaseException as primary:
            if window_open and self.journal is not None \
                    and not self._target_reachable():
                # The target died mid-migration: it may hold
                # journaled import batches whose source copies the drain
                # already deleted, and a rollback that cannot reach it
                # would close the window and restore the old view — the
                # source would then recreate those keys at version 0 and
                # the resumed drain's reconciliation would drop their
                # journaled (newer) lineage.  Leave the journal IN FLIGHT
                # and the window armed instead: drained keys keep
                # ASK-redirecting (brief unavailability, not a fork) until
                # resume_migrations completes the pair forward once the
                # target — or its promoted replica (readdress=) — is back.
                raise
            if window_open:
                try:
                    _rollback(
                        self.src, self.tgt, self.source, self.target,
                        self.slots, old_view, epoch=self.epoch,
                    )
                except BaseException as rb_err:  # noqa: BLE001
                    # the rollback's OWN failure must not mask the original
                    # error: surface the primary, chain the rollback failure
                    raise primary from rb_err
                self._record("ROLLED_BACK", error=repr(primary))
            raise
        finally:
            self._close()

    # -- journal-replay paths --------------------------------------------------

    def resume_complete(self, planned: Dict[str, Any]) -> int:
        """Drive a journaled migration that died at/after WINDOW_OPEN to
        STABLE.  Every step re-sends under the recorded epoch, so redoing
        work the dead coordinator already did is a no-op (SETSLOT and
        SETVIEW are level-triggered; an empty drain sweeps zero records)."""
        self._connect()
        try:
            self._phase_open_window()  # idempotent re-open
            moved = self._phase_drain(moved=int(self.journal.latest("moved", 0)))
            new_view = [tuple(row) for row in planned["new_view"]]
            flat = self._phase_commit_view(new_view)
            self._record("VIEW_COMMITTED", resumed=True)
            old_view = [tuple(row) for row in planned["old_view"]]
            self._phase_stabilize(flat, old_view)
            self._record("STABLE", moved=moved, resumed=True)
            return moved
        finally:
            self._close()

    def resume_rollback(self, planned: Dict[str, Any]) -> None:
        """Unwind a journaled migration that died at PLANNED: the window
        may be half-open and an ASK redirect may have created records on
        the target, but no drain sweep was recorded — rolling back is
        strictly cheaper than completing."""
        self._connect()
        try:
            old_view = [tuple(row) for row in planned["old_view"]]
            _rollback(
                self.src, self.tgt, self.source, self.target, self.slots,
                old_view, epoch=self.epoch,
            )
            self._record("ROLLED_BACK", resumed=True)
        finally:
            self._close()


def _rollback(src, tgt, source: str, target: str, slots, old_view,
              epoch: Optional[int] = None) -> None:
    """Best-effort unwind of a failed migration: pull already-moved records
    back to the source, restore the pre-migration view on BOTH ends, close
    the window.  If the target is unreachable, the window is still closed —
    records already shipped stay safe on the target and a RE-RUN of
    migrate_slots(source, target, slots) converges once it returns
    (IMPORTRECORDS applies by version, the drain resumes where it stopped).
    A journaled rollback carries the migration's fencing epoch so a stale
    coordinator's late rollback cannot disturb a newer migration."""
    ep: Tuple = ("EPOCH", epoch) if epoch is not None else ()
    # close the forward window on the source FIRST: its absent guard must
    # not ASK-bounce the reverse imports about to arrive
    for s in slots:
        try:
            src.execute("CLUSTER", "SETSLOT", s, "STABLE", *ep)
        except Exception:  # noqa: BLE001 — source gone; nothing to unwind into
            pass
    try:
        # reverse-drain: target -> source for anything that already moved
        for s in slots:
            try:
                src.execute("CLUSTER", "SETSLOT", s, "IMPORTING", target, *ep)
                tgt.execute("CLUSTER", "SETSLOT", s, "MIGRATING", source, *ep)
            except Exception:  # noqa: BLE001 — target gone; records stay there
                pass
        try:
            while int(tgt.execute(
                "CLUSTER", "MIGRATESLOTS", *ep, *slots, timeout=300.0
            )) > 0:
                pass
        except Exception:  # noqa: BLE001 — target gone; records stay there
            pass
    finally:
        for s in slots:
            for c in (src, tgt):
                try:
                    c.execute("CLUSTER", "SETSLOT", s, "STABLE", *ep)
                except Exception:  # noqa: BLE001 — unreachable node
                    pass
        # restore the pre-migration view: a target that already installed
        # the NEW view would otherwise claim slots it just gave back
        if old_view:
            flat: List = []
            for lo, hi, h, p, nid in old_view:
                flat += [lo, hi, h, p, nid]
            for c in (src, tgt):
                try:
                    c.execute("CLUSTER", "SETVIEW", *flat, timeout=10.0)
                except Exception:  # noqa: BLE001 — unreachable node
                    pass


# -- journaled DEVICE rebalance (slot -> position handoffs) -------------------
#
# A device move is a slot handoff INSIDE one process (no wire drain, no view
# commit), but it shares the failure mode journaled slot migrations exist
# for: a coordinator killed mid-rebalance leaves half the move set on the
# old device with no record of intent, and a STALE coordinator resuming
# later must not clobber a newer move.  So device moves ride the same
# machinery — one MigrationJournal per rebalance (kind="device_rebalance" in
# PLANNED so the two resume paths never cross), the journal directory's
# monotonic epoch allocator, per-slot fencing on the SlotPlacement
# (PlacementStaleEpoch == the STALEEPOCH reply), and kill-at-every-phase
# resume: PLANNED -> DRAINING (per-batch progress) -> STABLE.

_DEVICE_PHASES = ("PLANNED", "DRAINING", "STABLE")


def rebalance_devices(
    engine,
    targets: Dict[int, int],
    journal_dir: Optional[str] = None,
    crash_after: Optional[str] = None,
    batch: int = 256,
) -> int:
    """Move the slots in ``targets`` ({slot: device_index}) onto their new
    owner devices, fenced and (optionally) journaled.  Returns the number
    of records whose banks moved.  ``crash_after`` raises
    :class:`CoordinatorKilled` right after that phase's journal entry
    (``"PLANNED"``, ``"DRAINING:<sweep>"``, ``"STABLE"``) — the chaos
    tier's deterministic kill switch, same contract as ``migrate_slots``.

    Every slot is fenced at the journal's epoch BEFORE any bank moves, so
    a resumed re-send is idempotent and a stale coordinator (lower epoch
    than a newer rebalance that touched the slot) dies loudly with
    PlacementStaleEpoch instead of silently un-moving it."""
    placement = engine.placement
    if placement is None:
        raise RuntimeError("placement is not enabled on this engine")
    journal = None
    epoch = None
    if journal_dir is not None:
        devs = sorted(set(targets.values()))
        journal = MigrationJournal.create(
            journal_dir, "dev:rebalance", f"dev:{devs}"
        )
        epoch = journal.epoch
        journal.append(
            "PLANNED", kind="device_rebalance", epoch=epoch,
            targets={str(s): int(d) for s, d in targets.items()},
        )
    run = _DeviceRebalanceRun(engine, targets, journal, epoch, crash_after,
                              batch=batch)
    return run.execute()


def resume_device_rebalances(engine, journal_dir: str) -> List[Dict[str, Any]]:
    """Settle every in-flight device rebalance the journal directory
    records — the restart path.  A device move has no rollback shape (the
    banks live in this process either way), so every in-flight rebalance
    completes FORWARD: re-fence at the recorded epoch, re-move (moving an
    already-moved slot is a no-op), STABLE.  Idempotent under repeated
    crashes mid-resume; a slot a NEWER rebalance already fenced higher is
    skipped (stale epoch), counted in the summary."""
    out: List[Dict[str, Any]] = []
    for journal in MigrationJournal.in_flight(journal_dir):
        planned = journal.entry("PLANNED")
        if planned is None or planned.get("kind") != "device_rebalance":
            continue
        targets = {int(s): int(d) for s, d in planned["targets"].items()}
        run = _DeviceRebalanceRun(
            engine, targets, journal, journal.epoch, None
        )
        try:
            moved, stale = run.resume()
            out.append({
                "id": journal.migration_id, "action": "completed",
                "moved": moved, "stale_slots": stale, "epoch": journal.epoch,
            })
        except Exception as e:  # noqa: BLE001 — settle the rest
            out.append({
                "id": journal.migration_id, "action": "failed",
                "error": repr(e),
            })
    return out


def evacuation_plan(placement, dev_index: int) -> Dict[int, int]:
    """Target owners for every slot of ``dev_index``: round robin over the
    surviving positions (every other position whose lane is not itself
    quarantined).  The plan feeds :func:`rebalance_devices` unchanged, so
    an evacuation IS a journaled, resumable device rebalance."""
    from redisson_tpu_torch.core.ioplane import quarantined_device_ids

    if not 0 <= dev_index < placement.n_devices:
        raise ValueError(f"device index {dev_index} outside placement")
    bad = quarantined_device_ids()
    survivors = [
        i for i, d in enumerate(placement.devices)
        if i != dev_index and getattr(d, "id", i) not in bad
    ]
    if not survivors:
        raise ValueError(
            f"no surviving devices to evacuate device {dev_index} onto"
        )
    owner = placement.owner_snapshot()
    slots = (owner == dev_index).nonzero()[0]
    return {
        int(s): survivors[j % len(survivors)]
        for j, s in enumerate(slots)
    }


def shed_plan(placement, dev_index: int, count: int) -> Dict[int, int]:
    """Partial evacuation: target owners for up to ``count`` of
    ``dev_index``'s slots (its lowest), round robin over the survivors —
    the actuator the residency rebalancer drives.  Same contract as
    :func:`evacuation_plan`, bounded so one shed step moves a bite of the
    position, not the whole position."""
    full = evacuation_plan(placement, dev_index)
    if count <= 0 or count >= len(full):
        return full
    keep = sorted(full)[:count]
    return {s: full[s] for s in keep}


def evacuate_device(engine, dev_index: int,
                    journal_dir: Optional[str] = None,
                    crash_after: Optional[str] = None):
    """Evacuate every slot of position ``dev_index`` onto the survivors
    through the journaled device rebalance.  Returns ``(records_moved,
    targets, epoch)``; epoch is None when unjournaled or when the position
    owned no slot (nothing ran).  Keyed traffic on the moving slots rides
    the TRYAGAIN fence; a killed coordinator resumes through
    :func:`resume_device_rebalances`."""
    placement = engine.placement
    if placement is None:
        raise RuntimeError("placement is not enabled on this engine")
    targets = evacuation_plan(placement, dev_index)
    if not targets:
        return 0, targets, None
    moved = rebalance_devices(
        engine, targets, journal_dir=journal_dir, crash_after=crash_after
    )
    epoch = None
    if journal_dir is not None:
        # every target slot was fenced at the journal's epoch before any
        # record moved: read it back off the placement for the reply
        epoch = placement.epoch_of(next(iter(targets)))
    return moved, targets, epoch


class _DeviceRebalanceRun:
    """One device rebalance as a journaled state machine (the
    ``_MigrationRun`` shape without a wire)."""

    def __init__(self, engine, targets: Dict[int, int], journal, epoch,
                 crash_after: Optional[str], batch: int = 256):
        self.engine = engine
        self.targets = dict(targets)
        self.journal = journal
        self.epoch = epoch
        self.crash_after = crash_after
        self.batch = max(1, batch)

    def _record(self, phase: str, **data) -> None:
        if self.journal is not None:
            self.journal.append(phase, **data)

    def _crash_point(self, label: str) -> None:
        if self.crash_after is not None and self.crash_after == label:
            raise CoordinatorKilled(f"[chaos] coordinator killed after {label}")

    def _move(self, moved: int = 0, skip_stale: bool = False):
        """Batched fenced moves (one bulk store scan per batch —
        engine.move_slots_records), one DRAINING journal entry per batch so
        a resumed coordinator knows how far it got.  Returns
        (records_moved, stale_slot_count)."""
        slots = sorted(self.targets)
        stale = 0
        sweep = 0
        for start in range(0, len(slots), self.batch):
            batch = {
                slot: self.targets[slot]
                for slot in slots[start:start + self.batch]
            }
            n, s = self.engine.move_slots_records(
                batch, self.epoch, skip_stale=skip_stale
            )
            moved += n
            stale += s
            sweep += 1
            self._record("DRAINING", moved=moved, sweep=sweep)
            self._crash_point(f"DRAINING:{sweep}")
        return moved, stale

    def execute(self) -> int:
        self._crash_point("PLANNED")
        moved, _stale = self._move()
        self._record("STABLE", moved=moved)
        self._crash_point("STABLE")
        return moved

    def resume(self):
        moved0 = int(self.journal.latest("moved", 0)) if self.journal else 0
        moved, stale = self._move(moved=moved0, skip_stale=True)
        self._record("STABLE", moved=moved, resumed=True)
        return moved, stale


def _s(v) -> str:
    return v.decode() if isinstance(v, (bytes, bytearray)) else str(v)


def _fetch_view(node: NodeClient) -> List[Tuple[int, int, str, int, str]]:
    view = []
    for row in node.execute("CLUSTER", "SLOTS"):
        lo, hi, (host, port, nid) = int(row[0]), int(row[1]), row[2]
        view.append((lo, hi, _s(host), int(port), _s(nid)))
    return view


def _reassign(
    view: List[Tuple[int, int, str, int, str]],
    slots: Sequence[int],
    target: str,
    target_id: str,
) -> List[Tuple[int, int, str, int, str]]:
    """Point `slots` at `target` and re-compress into contiguous ranges."""
    owner: Dict[int, Tuple[str, int, str]] = {}
    for lo, hi, h, p, nid in view:
        for s in range(lo, hi + 1):
            owner[s] = (h, p, nid)
    th, tp = target.rsplit(":", 1)
    for s in slots:
        owner[s] = (th, int(tp), target_id)
    out: List[Tuple[int, int, str, int, str]] = []
    run_start: Optional[int] = None
    prev: Optional[Tuple[str, int, str]] = None
    for s in range(MAX_SLOT):  # slots are 0..MAX_SLOT-1 (16384 of them)
        cur = owner.get(s)
        if cur != prev:
            if prev is not None and run_start is not None:
                out.append((run_start, s - 1, *prev))
            run_start, prev = (s, cur) if cur is not None else (None, None)
    if prev is not None and run_start is not None:
        out.append((run_start, MAX_SLOT - 1, *prev))
    return out
