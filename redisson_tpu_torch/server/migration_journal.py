"""Write-ahead journals for slot migrations.

A copy of ``redisson_tpu/server/migration_journal.py``; the file format is
the reference's, so a journal directory written by either package resumes
on the other.  A crash after ``SETSLOT IMPORTING/MIGRATING`` but before
``SETVIEW`` would strand slots in a window with no record of what was in
flight; the journal is the record.  One append-only file per migration
under a journal directory, one fsync'd entry per phase:

    PLANNED        intent + everything resume needs (source, target, slots,
                   fencing epoch, old view, computed new view, target id)
    WINDOW_OPEN    IMPORTING + MIGRATING sent to both ends
    DRAINING       one entry per MIGRATESLOTS sweep (cumulative progress)
    VIEW_COMMITTED SETVIEW landed on source + target
    STABLE         terminal: windows closed, view propagated
    ROLLED_BACK    terminal: unwound (reverse-drained, old view restored)

Entry format: one line per entry, ``<compact-json>|<crc32-hex>``.  The CRC
makes a torn TAIL line (the crash happened mid-append) detectable:
``open()`` keeps the intact prefix and drops everything from the first bad
line, because the phase a torn entry was recording never reached its
durability point.

Every append is flushed and fsync'd before the phase counts as recorded,
and the journal DIRECTORY is fsync'd when the file is first created (the
file's existence lives in the directory's blocks; ``core/checkpoint.save``
keeps the same discipline).

The fencing ``epoch`` is allocated per migration (max existing + 1 within
the journal directory) and stamped on every ``SETSLOT``/``MIGRATESLOTS``
the coordinator sends; servers reject lower epochs (``STALEEPOCH``, see
``TpuServer.fence_slot_epoch``), so a stale coordinator resuming after a
newer migration touched the slot cannot clobber it, while a legitimate
resume (same epoch) re-sends idempotently.

:class:`ImportJournal` is the receiving side's mirror: the target journals
each accepted IMPORTRECORDS batch before it acks.
"""
from __future__ import annotations

import base64
import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional

from redisson_tpu_torch.utils.durability import fsync_dir as _fsync_dir

PHASES = (
    "PLANNED",
    "WINDOW_OPEN",
    "DRAINING",
    "VIEW_COMMITTED",
    "STABLE",
    "ROLLED_BACK",
)
TERMINAL_PHASES = frozenset({"STABLE", "ROLLED_BACK"})


class MigrationJournal:
    """One migration's write-ahead journal (append-only, fsync'd)."""

    SUFFIX = ".journal"
    # subclasses (ImportJournal) carry their own phase alphabet on the class
    # so append()/is_terminal() validate against the right one
    PHASES = PHASES
    TERMINAL = TERMINAL_PHASES

    def __init__(self, path: str, entries: Optional[List[Dict[str, Any]]] = None,
                 intact_bytes: Optional[int] = None):
        self.path = path
        self.entries: List[Dict[str, Any]] = entries if entries is not None else []
        # byte length of the intact line prefix (set by open()): append()
        # truncates any torn tail back to this boundary before writing, so
        # a new entry never concatenates onto a half-written line
        self._intact_bytes = intact_bytes

    # -- identity ------------------------------------------------------------

    @property
    def migration_id(self) -> str:
        name = os.path.basename(self.path)
        return name[: -len(self.SUFFIX)] if name.endswith(self.SUFFIX) else name

    @property
    def epoch(self) -> int:
        for e in self.entries:
            if "epoch" in e:
                return int(e["epoch"])
        # pre-PLANNED journal (crash before the first append): the filename
        # carries the allocated epoch so the slot is never re-fenced lower
        try:
            return int(self.migration_id.split("-")[1])
        except (IndexError, ValueError):
            return 0

    @property
    def phase(self) -> Optional[str]:
        return self.entries[-1]["phase"] if self.entries else None

    def is_terminal(self) -> bool:
        return self.phase in self.TERMINAL

    def entry(self, phase: str) -> Optional[Dict[str, Any]]:
        """First entry recorded for `phase` (PLANNED is the canonical one)."""
        for e in self.entries:
            if e["phase"] == phase:
                return e
        return None

    def latest(self, key: str, default=None):
        """Newest entry value for `key` (e.g. cumulative ``moved``)."""
        for e in reversed(self.entries):
            if key in e:
                return e[key]
        return default

    # -- write path ----------------------------------------------------------

    def append(self, phase: str, **data) -> Dict[str, Any]:
        """Record one phase entry durably: the entry is on disk (file
        fsync'd; directory too on creation) before this returns — the
        write-AHEAD property callers rely on."""
        if phase not in self.PHASES:
            raise ValueError(
                f"unknown journal phase {phase!r}; one of {self.PHASES}"
            )
        entry: Dict[str, Any] = {"phase": phase, "ts": time.time(), **data}
        payload = json.dumps(entry, sort_keys=True, separators=(",", ":"))
        line = (
            payload + "|" + format(zlib.crc32(payload.encode()) & 0xFFFFFFFF, "08x")
            + "\n"
        )
        parent = os.path.dirname(os.path.abspath(self.path))
        created = not os.path.exists(self.path)
        if created:
            with open(self.path, "ab") as f:
                f.write(line.encode())
                f.flush()
                os.fsync(f.fileno())
            self._intact_bytes = len(line.encode())
        else:
            # a crash mid-append may have left a torn tail line: truncate
            # back to the intact prefix FIRST, or the new entry would
            # concatenate onto the partial line and corrupt both
            end = (
                self._intact_bytes if self._intact_bytes is not None
                else os.path.getsize(self.path)
            )
            with open(self.path, "r+b") as f:
                f.truncate(end)
                f.seek(end)
                f.write(line.encode())
                f.flush()
                os.fsync(f.fileno())
            self._intact_bytes = end + len(line.encode())
        if created:
            _fsync_dir(parent)
        self.entries.append(entry)
        return entry

    # -- read path -----------------------------------------------------------

    @classmethod
    def open(cls, path: str) -> "MigrationJournal":
        """Parse a journal, keeping only the intact prefix: the first
        torn/corrupt line (crash mid-append) and everything after it is
        dropped — that phase never reached its durability point."""
        entries: List[Dict[str, Any]] = []
        with open(path, "rb") as f:
            raw = f.read()
        intact = 0
        for line in raw.split(b"\n"):
            if not line:
                continue
            payload, sep, crc = line.rpartition(b"|")
            if not sep:
                break
            try:
                if int(crc, 16) != zlib.crc32(payload) & 0xFFFFFFFF:
                    break
                entries.append(json.loads(payload.decode()))
            except (ValueError, UnicodeDecodeError):
                break
            intact += len(line) + 1  # the writer always terminates with \n
        return cls(path, entries, intact_bytes=intact)

    @classmethod
    def create(cls, journal_dir: str, source: str, target: str) -> "MigrationJournal":
        """Allocate a journal (and its fencing epoch) for a NEW migration.
        The epoch is one past the highest epoch any journal in the
        directory ever used, so it is monotonic across completed, rolled
        back, AND in-flight migrations."""
        os.makedirs(journal_dir, exist_ok=True)
        epoch = 1 + max((j.epoch for j in cls.scan(journal_dir)), default=0)
        mid = f"mig-{epoch:08d}-{os.getpid()}"
        return cls(os.path.join(journal_dir, mid + cls.SUFFIX))

    @classmethod
    def scan(cls, journal_dir: str) -> List["MigrationJournal"]:
        """Every journal in the directory, oldest epoch first."""
        if not os.path.isdir(journal_dir):
            return []
        out = [
            cls.open(os.path.join(journal_dir, fn))
            for fn in sorted(os.listdir(journal_dir))
            if fn.endswith(cls.SUFFIX)
        ]
        out.sort(key=lambda j: j.epoch)
        return out

    @classmethod
    def in_flight(cls, journal_dir: str) -> List["MigrationJournal"]:
        """Non-terminal journals — what ``resume_migrations`` must settle.
        Includes journals whose ONLY line was torn (crash mid-first-append:
        zero intact entries) — nothing ran, but the file must still be
        terminalized so it stops reading as in-flight."""
        return [j for j in cls.scan(journal_dir) if not j.is_terminal()]

    @classmethod
    def gc(cls, journal_dir: str, keep: int = 64) -> List[str]:
        """Prune settled history for long-lived coordinators: remove
        STABLE/ROLLED_BACK journals older (by epoch) than the newest `keep`
        terminal ones.  In-flight journals are NEVER touched — only a
        terminal entry marks a migration as safe to forget — and epoch
        monotonicity survives because ``create`` allocates one past the
        highest epoch still present (the kept tail).  Returns the removed
        paths.

        Import journals ride the same sweep: a target's TERMINAL
        import journal is pruned by the same keep policy, an in-flight one
        never is — and a coordinator journal whose epoch still has an
        in-flight import journal anywhere is kept regardless of age, because
        the target's boot-time replay (``rearm_recovery``) needs the
        coordinator record to decide replay-vs-discard."""
        if keep < 1:
            raise ValueError(f"gc keep must be >= 1, got {keep}")
        imports = ImportJournal.scan(journal_dir)
        live_import_epochs = {j.epoch for j in imports if not j.is_terminal()}
        groups = (
            [
                j for j in MigrationJournal.scan(journal_dir)
                if j.is_terminal() and j.epoch not in live_import_epochs
            ],
            [j for j in imports if j.is_terminal()],
        )
        removed: List[str] = []
        for group in groups:  # each epoch-sorted; keep applies per kind
            for j in group[:-keep]:
                try:
                    os.remove(j.path)
                except OSError:
                    continue  # racing coordinator already pruned it
                removed.append(j.path)
        if removed:
            _fsync_dir(os.path.abspath(journal_dir))
        return removed


class ImportJournal(MigrationJournal):
    """The RECEIVING side's write-ahead journal.

    ``migrate_slot_batch`` deletes a record from the source the moment the
    target acks its ``IMPORTRECORDS`` batch — so a SIGKILLed target whose
    memory held the only applied copy used to lose every record the source
    had already deleted (the documented target-kill durability gap).  The
    fix is this mirror of :class:`MigrationJournal` on the TARGET node: each
    accepted batch is appended (fsync'd, CRC-per-line, epoch-stamped)
    BEFORE the ack goes out, so the source only deletes records the target
    has made durable, and a restarted target replays its import journals at
    boot (``migration.rearm_recovery``) on top of whatever checkpoint it
    restored — ``apply_records`` reconciles by version, so replay is
    idempotent.

    One file per (migration epoch, target address); same line format, CRC
    torn-tail handling, and directory as the coordinator journals (the
    supervisor's shared ``journal_dir``), distinguished by suffix so the two
    scans never cross.  Phases::

        OPENED        identity: target, source, epoch — first entry
        BATCH         one accepted IMPORTRECORDS blob (base64), pre-ack
        STABLE        terminal: the migration settled (either direction)
        ROLLED_BACK   terminal: the migration rolled back and the records
                      went home — boot replay must NOT resurrect them
    """

    SUFFIX = ".import"
    PHASES = ("OPENED", "BATCH", "STABLE", "ROLLED_BACK")
    TERMINAL = frozenset({"STABLE", "ROLLED_BACK"})

    @classmethod
    def path_for(cls, journal_dir: str, target: str, epoch: int) -> str:
        safe = target.replace(":", "_").replace("/", "_")
        return os.path.join(journal_dir, f"imp-{epoch:08d}-{safe}{cls.SUFFIX}")

    @classmethod
    def open_for(cls, journal_dir: str, target: str, epoch: int,
                 source: Optional[str] = None) -> "ImportJournal":
        """Find-or-create the target's journal for one migration epoch; a
        fresh journal records its OPENED identity entry immediately (so even
        a crash before the first batch leaves the pairing on disk)."""
        os.makedirs(journal_dir, exist_ok=True)
        path = cls.path_for(journal_dir, target, epoch)
        j = cls.open(path) if os.path.exists(path) else cls(path)
        if not j.entries:
            j.append("OPENED", target=target, source=source, epoch=epoch)
        return j

    def append_batch(self, blob: bytes) -> None:
        """Make one transfer batch durable BEFORE it is acked — the
        write-ahead hop that closes the target-kill gap."""
        self.append(
            "BATCH",
            blob=base64.b64encode(bytes(blob)).decode("ascii"),
            nbytes=len(blob),
        )

    def batch_blobs(self) -> List[bytes]:
        """Every journaled batch, in arrival order — the boot replay feed."""
        return [
            base64.b64decode(e["blob"])
            for e in self.entries
            if e["phase"] == "BATCH"
        ]

    def batch_count(self) -> int:
        return sum(1 for e in self.entries if e["phase"] == "BATCH")

    @property
    def target(self) -> Optional[str]:
        opened = self.entry("OPENED")
        return opened.get("target") if opened else None

    @property
    def source(self) -> Optional[str]:
        opened = self.entry("OPENED")
        return opened.get("source") if opened else None
