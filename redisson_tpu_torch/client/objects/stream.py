"""Stream: append-only log with consumer groups.

Parity target: RStream — ``org/redisson/RedissonStream.java`` (1,441 LoC):
XADD (auto/explicit ids), XLEN, XRANGE/XREVRANGE, XREAD, XREADGROUP with
consumer PELs, XACK, XCLAIM/XAUTOCLAIM, XPENDING, XTRIM, XDEL,
createGroup/removeGroup/createConsumer.

Entry ids follow Redis '<ms>-<seq>' ordering and auto-generation rules.

A copy of ``redisson_tpu/client/objects/stream.py`` on the port's engine.
One difference, in host cost only: XREADGROUP ``>`` finds the group's
first undelivered entry by bisection over the ID-ordered entries, where
the reference walks them from the start on every read.  Replies are the
same.
"""
from __future__ import annotations

import bisect
import time
from typing import Any, Dict, List, Optional, Tuple

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord

StreamId = Tuple[int, int]


def parse_id(s) -> StreamId:
    if isinstance(s, tuple):
        return s
    if s in ("-",):
        return (0, 0)
    if s in ("+",):
        return (1 << 62, 1 << 62)
    if "-" in str(s):
        ms, seq = str(s).split("-")
        return (int(ms), int(seq))
    return (int(s), 0)


def fmt_id(i: StreamId) -> str:
    return f"{i[0]}-{i[1]}"


class Stream(RExpirable):
    _kind = "stream"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name,
            self._kind,
            lambda: StateRecord(
                kind=self._kind,
                host={"entries": [], "last_id": (0, 0), "groups": {}},
            ),
        )

    def _wait(self):
        return self._engine.wait_entry(f"__stream__:{self._name}")

    # -- producing ----------------------------------------------------------

    def add(self, fields: Dict[Any, Any], id: Optional[str] = None) -> str:
        """XADD; returns the entry id."""
        enc = {self._codec.encode_map_key(k): self._codec.encode_map_value(v) for k, v in fields.items()}
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if id is None or id == "*":
                ms = int(time.time() * 1000)
                last = rec.host["last_id"]
                eid = (ms, last[1] + 1) if ms <= last[0] else (ms, 0)
                if eid <= last:
                    eid = (last[0], last[1] + 1)
            else:
                eid = parse_id(id)
                if eid <= rec.host["last_id"]:
                    raise ValueError(
                        "The ID specified in XADD is equal or smaller than the "
                        "target stream top item"
                    )
            rec.host["entries"].append((eid, enc))
            rec.host["last_id"] = eid
            self._touch_version(rec)
        self._wait().signal(all_=True)
        return fmt_id(eid)

    def trim(self, max_len: int) -> int:
        """XTRIM MAXLEN."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            drop = max(0, len(rec.host["entries"]) - max_len)
            rec.host["entries"] = rec.host["entries"][drop:]
            if drop:
                self._touch_version(rec)
            return drop

    def trim_by_min_id(self, min_id: str) -> int:
        """XTRIM MINID: drop every entry with an id BELOW min_id (the second
        trim strategy, RedissonStream StreamTrimArgs.minId)."""
        lo = parse_id(min_id)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            before = len(rec.host["entries"])
            rec.host["entries"] = [(i, f) for i, f in rec.host["entries"] if i >= lo]
            drop = before - len(rec.host["entries"])
            if drop:
                self._touch_version(rec)
            return drop

    def last_id(self) -> Optional[str]:
        rec = self._engine.store.get(self._name)
        if rec is None or not rec.host["entries"]:
            return None
        return fmt_id(rec.host["entries"][-1][0])

    def remove(self, *ids: str) -> int:
        """XDEL."""
        targets = {parse_id(i) for i in ids}
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            before = len(rec.host["entries"])
            rec.host["entries"] = [(i, f) for i, f in rec.host["entries"] if i not in targets]
            n = before - len(rec.host["entries"])
            if n:
                self._touch_version(rec)
            return n

    # -- reading ------------------------------------------------------------

    def _decode(self, enc: Dict[bytes, bytes]) -> Dict:
        return {
            self._codec.decode_map_key(k): self._codec.decode_map_value(v)
            for k, v in enc.items()
        }

    def size(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else len(rec.host["entries"])

    def range(self, from_id: str = "-", to_id: str = "+", count: Optional[int] = None) -> Dict[str, Dict]:
        lo, hi = parse_id(from_id), parse_id(to_id)
        rec = self._engine.store.get(self._name)
        if rec is None:
            return {}
        out = {}
        for eid, enc in rec.host["entries"]:
            if lo <= eid <= hi:
                out[fmt_id(eid)] = self._decode(enc)
                if count is not None and len(out) >= count:
                    break
        return out

    def rev_range(self, from_id: str = "+", to_id: str = "-", count: Optional[int] = None) -> Dict[str, Dict]:
        hi, lo = parse_id(from_id), parse_id(to_id)
        rec = self._engine.store.get(self._name)
        if rec is None:
            return {}
        out = {}
        for eid, enc in reversed(rec.host["entries"]):
            if lo <= eid <= hi:
                out[fmt_id(eid)] = self._decode(enc)
                if count is not None and len(out) >= count:
                    break
        return out

    def read(self, from_id: str = "0", count: Optional[int] = None, timeout: float = 0.0) -> Dict[str, Dict]:
        """XREAD: entries strictly after from_id; optionally blocking."""
        after = parse_id(from_id)
        deadline = time.time() + timeout
        while True:
            rec = self._engine.store.get(self._name)
            out = {}
            if rec is not None:
                for eid, enc in rec.host["entries"]:
                    if eid > after:
                        out[fmt_id(eid)] = self._decode(enc)
                        if count is not None and len(out) >= count:
                            break
            if out or time.time() >= deadline:
                return out
            self._wait().wait_for(max(0.0, deadline - time.time()))

    # -- consumer groups ------------------------------------------------------

    def create_group(self, group: str, from_id: str = "$") -> None:
        """XGROUP CREATE ($ = only new entries)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if group in rec.host["groups"]:
                raise ValueError(f"BUSYGROUP consumer group '{group}' already exists")
            start = rec.host["last_id"] if from_id == "$" else parse_id(from_id)
            rec.host["groups"][group] = {"last_delivered": start, "pel": {}, "consumers": {}}
            self._touch_version(rec)

    def remove_group(self, group: str) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host["groups"].pop(group, None)
            self._touch_version(rec)

    def _group(self, rec, group: str) -> dict:
        g = rec.host["groups"].get(group)
        if g is None:
            raise KeyError(f"NOGROUP no such consumer group '{group}'")
        return g

    def read_group(
        self,
        group: str,
        consumer: str,
        count: Optional[int] = None,
        timeout: float = 0.0,
        from_id: str = ">",
    ) -> Dict[str, Dict]:
        """XREADGROUP: '>' delivers new entries into the consumer's PEL;
        an explicit id re-reads that consumer's pending entries."""
        deadline = time.time() + timeout
        while True:
            with self._engine.locked(self._name):
                rec = self._rec_or_create()
                g = self._group(rec, group)
                g["consumers"].setdefault(consumer, time.time())
                out = {}
                if from_id == ">":
                    entries = rec.host["entries"]
                    first = bisect.bisect_right(entries, g["last_delivered"], key=lambda e: e[0])
                    for at in range(first, len(entries)):
                        eid, enc = entries[at]
                        if eid > g["last_delivered"]:
                            g["pel"][eid] = [consumer, time.time(), 1]
                            g["last_delivered"] = eid
                            out[fmt_id(eid)] = self._decode(enc)
                            if count is not None and len(out) >= count:
                                break
                else:
                    after = parse_id(from_id)
                    entries = {i: f for i, f in rec.host["entries"]}
                    for eid, (owner, _, _) in sorted(g["pel"].items()):
                        if owner == consumer and eid > after and eid in entries:
                            out[fmt_id(eid)] = self._decode(entries[eid])
                            if count is not None and len(out) >= count:
                                break
                if out:
                    self._touch_version(rec)
                    return out
            if time.time() >= deadline:
                return {}
            self._wait().wait_for(max(0.0, deadline - time.time()))

    def ack(self, group: str, *ids: str) -> int:
        """XACK."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            g = self._group(rec, group)
            n = 0
            for i in ids:
                if g["pel"].pop(parse_id(i), None) is not None:
                    n += 1
            if n:
                self._touch_version(rec)
            return n

    def pending_range(
        self, group: str, from_id: str = "-", to_id: str = "+", count: Optional[int] = None,
        consumer: Optional[str] = None,
    ) -> List[dict]:
        """XPENDING (extended form)."""
        lo, hi = parse_id(from_id), parse_id(to_id)
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        g = self._group(rec, group)
        out = []
        for eid, (owner, delivered_at, n_deliv) in sorted(g["pel"].items()):
            if lo <= eid <= hi and (consumer is None or owner == consumer):
                out.append(
                    {
                        "id": fmt_id(eid),
                        "consumer": owner,
                        "idle": time.time() - delivered_at,
                        "delivered": n_deliv,
                    }
                )
                if count is not None and len(out) >= count:
                    break
        return out

    def claim(
        self, group: str, consumer: str, min_idle: float, *ids: str, force: bool = False
    ) -> Dict[str, Dict]:
        """XCLAIM: transfer ownership of idle pending entries.  `force`
        creates a PEL entry for an existing stream entry that nobody has
        delivered yet (XCLAIM FORCE semantics)."""
        targets = [parse_id(i) for i in ids]
        now = time.time()
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            g = self._group(rec, group)
            g["consumers"].setdefault(consumer, now)  # XCLAIM auto-creates
            entries = {i: f for i, f in rec.host["entries"]}
            out = {}
            for eid in targets:
                cell = g["pel"].get(eid)
                if cell is None:
                    if not (force and eid in entries):
                        continue
                    cell = [consumer, 0.0, 0]  # fresh forced claim
                elif now - cell[1] < min_idle:
                    continue
                g["pel"][eid] = [consumer, now, cell[2] + 1]
                if eid in entries:
                    out[fmt_id(eid)] = self._decode(entries[eid])
            if out:
                self._touch_version(rec)
            return out

    def auto_claim(
        self, group: str, consumer: str, min_idle: float, start_id: str = "0", count: int = 100
    ) -> Tuple[str, Dict[str, Dict]]:
        """XAUTOCLAIM: scan the PEL from start_id, claiming idle entries."""
        after = parse_id(start_id)
        now = time.time()
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            g = self._group(rec, group)
            g["consumers"].setdefault(consumer, now)  # XAUTOCLAIM auto-creates
            entries = {i: f for i, f in rec.host["entries"]}
            out = {}
            cursor = (0, 0)
            for eid, cell in sorted(g["pel"].items()):
                if eid < after:
                    continue
                if len(out) >= count:
                    cursor = eid
                    break
                if now - cell[1] >= min_idle:
                    g["pel"][eid] = [consumer, now, cell[2] + 1]
                    if eid in entries:
                        out[fmt_id(eid)] = self._decode(entries[eid])
            if out:
                self._touch_version(rec)
            return fmt_id(cursor), out

    def pending_summary(self, group: str) -> dict:
        """XPENDING (summary form): total, smallest/largest pending id, and
        per-consumer pending counts."""
        rec = self._engine.store.get(self._name)
        if rec is None:
            return {"total": 0, "min_id": None, "max_id": None, "consumers": {}}
        g = self._group(rec, group)
        per: Dict[str, int] = {}
        ids = sorted(g["pel"])
        for _eid, (owner, _t, _n) in g["pel"].items():
            per[owner] = per.get(owner, 0) + 1
        return {
            "total": len(ids),
            "min_id": fmt_id(ids[0]) if ids else None,
            "max_id": fmt_id(ids[-1]) if ids else None,
            "consumers": per,
        }

    def create_consumer(self, group: str, consumer: str) -> bool:
        """XGROUP CREATECONSUMER; True if the consumer is new."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            g = self._group(rec, group)
            fresh = consumer not in g["consumers"]
            g["consumers"].setdefault(consumer, time.time())
            if fresh:
                self._touch_version(rec)
            return fresh

    def remove_consumer(self, group: str, consumer: str) -> int:
        """XGROUP DELCONSUMER: drop a consumer, DISCARDING its pending
        entries (Redis semantics); returns #pending discarded."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            g = self._group(rec, group)
            mine = [eid for eid, cell in g["pel"].items() if cell[0] == consumer]
            for eid in mine:
                del g["pel"][eid]
            g["consumers"].pop(consumer, None)
            if mine:
                self._touch_version(rec)
            return len(mine)

    def set_group_id(self, group: str, from_id: str) -> None:
        """XGROUP SETID: move the group's last-delivered cursor."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            g = self._group(rec, group)
            g["last_delivered"] = parse_id(from_id) if from_id != "$" else (
                rec.host["entries"][-1][0] if rec.host["entries"] else (0, 0)
            )
            self._touch_version(rec)

    def list_groups(self) -> List[str]:
        rec = self._engine.store.get(self._name)
        return [] if rec is None else list(rec.host["groups"])

    def list_consumers(self, group: str) -> List[str]:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return []
        return list(self._group(rec, group)["consumers"])
