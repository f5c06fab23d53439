"""ScoredSortedSet: the ZSET object.

Parity target: ``org/redisson/RedissonScoredSortedSet.java`` (2,084 LoC) —
ZADD (+NX/XX/GT/LT), ZSCORE/ZINCRBY, ZRANK/ZREVRANK, ZRANGE/ZRANGEBYSCORE
(+REV, +WITHSCORES), ZPOPMIN/MAX, ZCOUNT, ZREM/ZREMRANGEBY*, ZRANDMEMBER,
ZUNIONSTORE/ZINTERSTORE/ZDIFFSTORE, firstScore/lastScore.

Representation: member(encoded) -> score dict plus a lazily rebuilt sorted
index (score, encoded-member) — rebuild is O(n log n) amortized over reads
after writes; ranks follow Redis tie-break rules (score, then lexicographic
member).  Bulk analytics (rank of a large batch, percentile scans) are the
device upgrade path via argsort kernels; the host index is the semantic
reference implementation.

A copy of ``redisson_tpu/client/objects/scoredsortedset.py`` on the port's engine.
"""
from __future__ import annotations

import bisect
import math
import random
from typing import Any, Dict, Iterable, List, Optional, Tuple

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord

_INF = math.inf


class ScoredSortedSet(RExpirable):
    _kind = "zset"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name,
            self._kind,
            lambda: StateRecord(kind=self._kind, host={"scores": {}, "index": None}),
        )

    def _e(self, v) -> bytes:
        return self._codec.encode(v)

    def _d(self, raw: bytes):
        return self._codec.decode(raw)

    @staticmethod
    def _index_of(rec) -> List[Tuple[float, bytes]]:
        if rec.host["index"] is None:
            rec.host["index"] = sorted(
                ((s, m) for m, s in rec.host["scores"].items()), key=lambda p: (p[0], p[1])
            )
        return rec.host["index"]

    @staticmethod
    def _dirty(rec):
        rec.host["index"] = None

    # -- writes -------------------------------------------------------------

    def add(self, score: float, member) -> bool:
        """ZADD one member; True if newly added (not merely updated)."""
        e = self._e(member)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            fresh = e not in rec.host["scores"]
            rec.host["scores"][e] = float(score)
            self._dirty(rec)
            self._touch_version(rec)
        self._signal_waiters()
        return fresh

    def _signal_waiters(self) -> None:
        """Wake parked take_first/take_last (BZPOPMIN/MAX analog)."""
        self._engine.signal_queue_waiters(self._name)

    def add_all(self, entries: Dict[Any, float]) -> int:
        """ZADD many: {member: score}; returns count of new members."""
        n = 0
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for member, score in entries.items():
                e = self._e(member)
                if e not in rec.host["scores"]:
                    n += 1
                rec.host["scores"][e] = float(score)
            self._dirty(rec)
            self._touch_version(rec)
        self._signal_waiters()
        return n

    def add_all_if_absent(self, entries: Dict[Any, float]) -> int:
        """ZADD NX many (RScoredSortedSet.addAllIfAbsent): count ADDED."""
        n = 0
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for member, score in entries.items():
                e = self._e(member)
                if e not in rec.host["scores"]:
                    rec.host["scores"][e] = float(score)
                    n += 1
            if n:
                self._dirty(rec)
                self._touch_version(rec)
        if n:
            self._signal_waiters()
        return n

    def add_all_if_exist(self, entries: Dict[Any, float]) -> int:
        """ZADD XX CH many: count of existing members whose score CHANGED."""
        n = 0
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for member, score in entries.items():
                e = self._e(member)
                old = rec.host["scores"].get(e)
                if old is not None and old != float(score):
                    rec.host["scores"][e] = float(score)
                    n += 1
            if n:
                self._dirty(rec)
                self._touch_version(rec)
        return n

    def _add_all_cmp(self, entries: Dict[Any, float], pred) -> int:
        n = 0
        fresh = 0
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for member, score in entries.items():
                e = self._e(member)
                old = rec.host["scores"].get(e)
                if old is None or pred(float(score), old):
                    rec.host["scores"][e] = float(score)
                    n += 1
                    fresh += old is None
            if n:
                self._dirty(rec)
                self._touch_version(rec)
        if fresh:
            self._signal_waiters()
        return n

    def add_all_if_greater(self, entries: Dict[Any, float]) -> int:
        """ZADD GT CH many: count added-or-raised."""
        return self._add_all_cmp(entries, lambda new, old: new > old)

    def add_all_if_less(self, entries: Dict[Any, float]) -> int:
        """ZADD LT CH many."""
        return self._add_all_cmp(entries, lambda new, old: new < old)

    def add_score_and_get_rank(self, member, delta: float) -> Optional[int]:
        """ZINCRBY + ZRANK atomically (addScoreAndGetRank)."""
        with self._engine.locked(self._name):
            self.add_score(member, delta)
            return self.rank(member)

    def add_score_and_get_rev_rank(self, member, delta: float) -> Optional[int]:
        with self._engine.locked(self._name):
            self.add_score(member, delta)
            return self.rev_rank(member)

    def first_entry(self) -> Optional[Tuple[Any, float]]:
        """(member, score) of the lowest-scored member (firstEntry)."""
        entries = self.entry_range(0, 0)
        return entries[0] if entries else None

    def last_entry(self) -> Optional[Tuple[Any, float]]:
        entries = self.entry_range(-1, -1)
        return entries[0] if entries else None

    def rank_entry(self, member) -> Optional[Tuple[int, float]]:
        """(rank, score) in one locked read (rankEntry)."""
        with self._engine.locked(self._name):
            r = self.rank(member)
            return None if r is None else (r, self.get_score(member))

    def rev_rank_entry(self, member) -> Optional[Tuple[int, float]]:
        with self._engine.locked(self._name):
            r = self.rev_rank(member)
            return None if r is None else (r, self.get_score(member))

    def add_if_absent(self, score: float, member) -> bool:
        """ZADD NX."""
        e = self._e(member)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if e in rec.host["scores"]:
                return False
            rec.host["scores"][e] = float(score)
            self._dirty(rec)
            self._touch_version(rec)
        self._signal_waiters()
        return True

    def add_if_exists(self, score: float, member) -> bool:
        """ZADD XX CH (RedissonScoredSortedSet.addIfExistsAsync): True only
        when an existing member's score actually CHANGED."""
        e = self._e(member)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = rec.host["scores"].get(e)
            if old is None or old == float(score):
                return False
            rec.host["scores"][e] = float(score)
            self._dirty(rec)
            self._touch_version(rec)
            return True

    def add_if_greater(self, score: float, member) -> bool:
        """ZADD GT (update only if new score is greater)."""
        return self._add_cmp(score, member, lambda new, old: new > old)

    def add_if_less(self, score: float, member) -> bool:
        """ZADD LT."""
        return self._add_cmp(score, member, lambda new, old: new < old)

    def _add_cmp(self, score, member, pred) -> bool:
        """ZADD GT|LT CH (addIfGreater/LessAsync): True when the member was
        ADDED or its score CHANGED — not merely touched with an equal score."""
        e = self._e(member)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            old = rec.host["scores"].get(e)
            if old is not None and not pred(float(score), old):
                return False
            rec.host["scores"][e] = float(score)
            self._dirty(rec)
            self._touch_version(rec)
            fresh = old is None
        if fresh:  # a GT/LT add can introduce a member: wake parked takers
            self._signal_waiters()
        return fresh or old != float(score)

    def add_score(self, member, delta: float) -> float:
        """ZINCRBY."""
        e = self._e(member)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            new = rec.host["scores"].get(e, 0.0) + float(delta)
            rec.host["scores"][e] = new
            self._dirty(rec)
            self._touch_version(rec)
        self._signal_waiters()
        return new

    def remove(self, member) -> bool:
        e = self._e(member)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if rec.host["scores"].pop(e, None) is None:
                return False
            self._dirty(rec)
            self._touch_version(rec)
            return True

    def remove_all(self, members: Iterable) -> bool:
        changed = False
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            for m in members:
                if rec.host["scores"].pop(self._e(m), None) is not None:
                    changed = True
            if changed:
                self._dirty(rec)
                self._touch_version(rec)
        return changed

    def remove_range_by_rank(self, start: int, end: int) -> int:
        """ZREMRANGEBYRANK (inclusive, negative indexes allowed)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            n = len(idx)
            s, e = _norm_range(start, end, n)
            victims = [m for _, m in idx[s : e + 1]]
            for m in victims:
                del rec.host["scores"][m]
            if victims:
                self._dirty(rec)
                self._touch_version(rec)
            return len(victims)

    def remove_range_by_score(
        self, lo: float, lo_inc: bool, hi: float, hi_inc: bool
    ) -> int:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            victims = [
                m
                for m, s in rec.host["scores"].items()
                if _in_score(s, lo, lo_inc, hi, hi_inc)
            ]
            for m in victims:
                del rec.host["scores"][m]
            if victims:
                self._dirty(rec)
                self._touch_version(rec)
            return len(victims)

    # -- reads --------------------------------------------------------------

    def get_score(self, member) -> Optional[float]:
        rec = self._engine.store.get(self._name)
        if rec is None:
            return None
        return rec.host["scores"].get(self._e(member))

    def contains(self, member) -> bool:
        return self.get_score(member) is not None

    def size(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else len(rec.host["scores"])

    def rank(self, member) -> Optional[int]:
        """ZRANK (0-based, ascending)."""
        e = self._e(member)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            score = rec.host["scores"].get(e)
            if score is None:
                return None
            idx = self._index_of(rec)
            i = bisect.bisect_left(idx, (score, e))
            return i

    def rev_rank(self, member) -> Optional[int]:
        r = self.rank(member)
        return None if r is None else self.size() - 1 - r

    def value_range(self, start: int, end: int, reverse: bool = False) -> List:
        """ZRANGE / ZREVRANGE by rank, inclusive."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            n = len(idx)
            s, e = _norm_range(start, end, n)
            picked = idx[s : e + 1]
        if reverse:
            picked = list(reversed(self._rev_slice(idx, start, end)))
            return [self._d(m) for _, m in picked]
        return [self._d(m) for _, m in picked]

    @staticmethod
    def _rev_slice(idx, start, end):
        n = len(idx)
        rev = list(reversed(idx))
        s, e = _norm_range(start, end, n)
        return list(reversed(rev[s : e + 1]))

    def entry_range(self, start: int, end: int) -> List[Tuple[Any, float]]:
        """ZRANGE WITHSCORES -> [(member, score)]."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            s, e = _norm_range(start, end, len(idx))
            return [(self._d(m), sc) for sc, m in idx[s : e + 1]]

    def value_range_by_score(
        self,
        lo: float = -_INF,
        lo_inc: bool = True,
        hi: float = _INF,
        hi_inc: bool = True,
        offset: int = 0,
        count: Optional[int] = None,
    ) -> List:
        """ZRANGEBYSCORE with LIMIT offset count."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            picked = [m for sc, m in idx if _in_score(sc, lo, lo_inc, hi, hi_inc)]
        picked = picked[offset : offset + count if count is not None else None]
        return [self._d(m) for m in picked]

    def count(self, lo: float, lo_inc: bool, hi: float, hi_inc: bool) -> int:
        """ZCOUNT."""
        rec = self._engine.store.get(self._name)
        if rec is None:
            return 0
        return sum(1 for s in rec.host["scores"].values() if _in_score(s, lo, lo_inc, hi, hi_inc))

    def first(self):
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            return self._d(idx[0][1]) if idx else None

    def last(self):
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            return self._d(idx[-1][1]) if idx else None

    def first_score(self) -> Optional[float]:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            return idx[0][0] if idx else None

    def last_score(self) -> Optional[float]:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            return idx[-1][0] if idx else None

    def poll_first(self):
        """ZPOPMIN."""
        e = self.poll_first_entry()
        return None if e is None else e[0]

    def poll_first_entry(self):
        """ZPOPMIN with score: (member, score) or None."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            if not idx:
                return None
            sc, m = idx[0]
            del rec.host["scores"][m]
            self._dirty(rec)
            self._touch_version(rec)
            return self._d(m), sc

    def poll_last(self):
        """ZPOPMAX."""
        e = self.poll_last_entry()
        return None if e is None else e[0]

    def poll_last_entry(self):
        """ZPOPMAX with score: (member, score) or None."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            if not idx:
                return None
            sc, m = idx[-1]
            del rec.host["scores"][m]
            self._dirty(rec)
            self._touch_version(rec)
            return self._d(m), sc

    def random_member(self):
        rec = self._engine.store.get(self._name)
        if rec is None or not rec.host["scores"]:
            return None
        return self._d(random.choice(list(rec.host["scores"].keys())))

    def read_all(self) -> List:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            return [self._d(m) for _, m in self._index_of(rec)]

    # -- RSortable (readSort/sortTo — the Redis SORT surface) ----------------

    def _bucket_value(self, pattern: str, member_str: str):
        from redisson_tpu_torch.client.objects.bucket import Bucket

        if pattern == "#":
            return member_str
        return Bucket(
            self._engine, pattern.replace("*", member_str, 1), self._codec
        ).get()

    def _sorted_members(self, order: str, by_pattern: Optional[str], alpha: bool):
        members = self.read_all()
        if by_pattern is not None:
            def key(m):
                v = self._bucket_value(by_pattern, str(m))
                return str(v) if alpha else float(v if v is not None else 0)
        else:
            key = (lambda m: str(m)) if alpha else (lambda m: float(m))
        return sorted(members, key=key, reverse=(order.upper() == "DESC"))

    def read_sort(
        self,
        order: str = "ASC",
        offset: Optional[int] = None,
        count: Optional[int] = None,
        by_pattern: Optional[str] = None,
        get_patterns: Optional[List[str]] = None,
        alpha: bool = False,
    ) -> List:
        """RSortable.readSort (Redis SORT): sort members by themselves or a
        BY bucket pattern; optional GET projection; LIMIT offset/count."""
        out = self._sorted_members(order, by_pattern, alpha)
        if offset is not None or count is not None:
            off = offset or 0
            out = out[off : off + count] if count is not None else out[off:]
        if get_patterns:
            proj = []
            for m in out:
                for g in get_patterns:
                    proj.append(self._bucket_value(g, str(m)))
            return proj
        return out

    def read_sort_alpha(self, order: str = "ASC", offset=None, count=None,
                        by_pattern=None, get_patterns=None) -> List:
        return self.read_sort(order, offset, count, by_pattern, get_patterns,
                              alpha=True)

    def sort_to(
        self,
        dest_name: str,
        order: str = "ASC",
        offset: Optional[int] = None,
        count: Optional[int] = None,
        by_pattern: Optional[str] = None,
        get_patterns: Optional[List[str]] = None,
        alpha: bool = False,
    ) -> int:
        """SORT ... STORE dest: result lands as a LIST (Redis stores sort
        output as a list regardless of source type)."""
        from redisson_tpu_torch.client.objects.queue import Deque

        out = self.read_sort(order, offset, count, by_pattern, get_patterns, alpha)
        dest = Deque(self._engine, dest_name, self._codec)
        with self._engine.locked(dest._name):
            self._engine.store.delete(dest._name)
            for v in out:
                dest.add_last(v)
        return len(out)

    def __len__(self):
        return self.size()

    def __iter__(self):
        return iter(self.read_all())

    # -- store algebra (ZUNIONSTORE / ZINTERSTORE / ZDIFFSTORE) --------------

    def _gather(self, names):
        out = []
        for nm in names:
            rec = self._engine.store.get(nm)
            out.append({} if rec is None else dict(rec.host["scores"]))
        return out

    @staticmethod
    def _accumulate(maps, op: str, aggregate: str = "SUM") -> Dict[bytes, float]:
        """ONE accumulator for union/inter/diff — shared by the store ops
        AND the read_* variants so aggregation semantics cannot drift."""
        if op == "union":
            acc: Dict[bytes, float] = {}
            for mp in maps:
                for m, s in mp.items():
                    acc[m] = _agg(aggregate, acc[m], s) if m in acc else s
            return acc
        if op == "inter":
            common = set(maps[0]) if maps else set()
            for mp in maps[1:]:
                common &= set(mp)
            acc = {}
            for m in common:
                v = maps[0][m]
                for mp in maps[1:]:
                    v = _agg(aggregate, v, mp[m])
                acc[m] = v
            return acc
        acc = dict(maps[0]) if maps else {}
        for mp in maps[1:]:
            for m in mp:
                acc.pop(m, None)
        return acc

    def _combine_store(self, names, op: str, aggregate: str = "SUM") -> int:
        names = [self._map_name(n) for n in names]
        with self._engine.locked_many((self._name, *names)):
            rec = self._rec_or_create()
            acc = self._accumulate(self._gather((self._name, *names)), op, aggregate)
            rec.host["scores"] = acc
            self._dirty(rec)
            self._touch_version(rec)
        self._signal_waiters()
        return len(acc)

    def union(self, *names: str, aggregate: str = "SUM") -> int:
        return self._combine_store(names, "union", aggregate)

    def intersection(self, *names: str, aggregate: str = "SUM") -> int:
        return self._combine_store(names, "inter", aggregate)

    def diff(self, *names: str) -> int:
        return self._combine_store(names, "diff")

    # -- combination reads (readUnion/readIntersection/readDiff) -------------

    def _combine_read(self, names, op: str, aggregate: str = "SUM") -> List:
        names = [self._map_name(n) for n in names]
        with self._engine.locked_many((self._name, *names)):
            maps = self._gather((self._name, *names))
        acc = self._accumulate(maps, op, aggregate)
        return [self._d(m) for _s, m in sorted((s, m) for m, s in acc.items())]

    def read_union(self, *names: str, aggregate: str = "SUM") -> List:
        """ZUNION read — leaves this set untouched (RScoredSortedSet.readUnion)."""
        return self._combine_read(names, "union", aggregate)

    def read_intersection(self, *names: str, aggregate: str = "SUM") -> List:
        return self._combine_read(names, "inter", aggregate)

    def read_diff(self, *names: str) -> List:
        return self._combine_read(names, "diff")

    def count_intersection(self, *names: str, limit: int = 0) -> int:
        """ZINTERCARD (RScoredSortedSet.countIntersection) — counts the
        accumulator directly; decoding/sorting members to len() them would
        pay the full read cost for a number."""
        names = tuple(self._map_name(n) for n in names)
        with self._engine.locked_many((self._name, *names)):
            n = len(self._accumulate(self._gather((self._name, *names)), "inter"))
        return min(n, limit) if limit else n

    # -- rank-returning adds / member surgery --------------------------------

    def add_and_get_rank(self, score: float, member) -> int:
        """ZADD + ZRANK in one locked step (addAndGetRank)."""
        with self._engine.locked(self._name):
            self.add(score, member)
            return self.rank(member)

    def add_and_get_rev_rank(self, score: float, member) -> int:
        with self._engine.locked(self._name):
            self.add(score, member)
            return self.rev_rank(member)

    def replace(self, old_member, new_member) -> bool:
        """Rename a member keeping its score (RScoredSortedSet.replace)."""
        eo, en = self._e(old_member), self._e(new_member)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            score = rec.host["scores"].pop(eo, None)
            if score is None:
                return False
            rec.host["scores"][en] = score
            self._dirty(rec)
            self._touch_version(rec)
        self._signal_waiters()
        return True

    def retain_all(self, values: Iterable) -> bool:
        """Keep only `values`; True if anything was removed."""
        keep = {self._e(v) for v in values}
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            victims = [m for m in rec.host["scores"] if m not in keep]
            for m in victims:
                del rec.host["scores"][m]
            if victims:
                self._dirty(rec)
                self._touch_version(rec)
            return bool(victims)

    def random_entries(self, count: int) -> Dict:
        """ZRANDMEMBER WITHSCORES as a dict (randomEntries)."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            items = list(rec.host["scores"].items())
        picked = random.sample(items, min(count, len(items)))
        return {self._d(m): s for m, s in picked}

    # -- reversed ranges ------------------------------------------------------

    def value_range_reversed(self, start: int, end: int) -> List:
        """ZREVRANGE by rank (valueRangeReversed)."""
        return [m for m, _s in self.entry_range_reversed(start, end)]

    def entry_range_reversed(self, start: int, end: int) -> List[Tuple[Any, float]]:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = list(reversed(self._index_of(rec)))
        lo, hi = _norm_range(start, end, len(idx))
        return [(self._d(m), s) for s, m in (idx[lo : hi + 1] if hi >= lo else [])]

    # -- counted + blocking pops ---------------------------------------------

    def _poll_many(self, count: int, first: bool) -> List:
        """ONE index build + one slice + one batched delete — popping
        through poll_*_entry would re-sort the whole set per element."""
        if count <= 0:
            return []
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            idx = self._index_of(rec)
            victims = idx[:count] if first else idx[: -count - 1 : -1]
            if not victims:
                return []
            for _s, m in victims:
                del rec.host["scores"][m]
            self._dirty(rec)
            self._touch_version(rec)
            return [self._d(m) for _s, m in victims]

    def poll_first_many(self, count: int) -> List:
        """ZPOPMIN with count (pollFirst(count))."""
        return self._poll_many(count, first=True)

    def poll_last_many(self, count: int) -> List:
        return self._poll_many(count, first=False)

    def _poll_blocking(self, poll_fn, timeout: Optional[float]):
        import time as _t

        deadline = None if timeout is None else _t.time() + timeout
        entry = self._engine.queue_wait_entry(self._name)
        while True:
            v = poll_fn()
            if v is not None:
                return v
            remaining = None if deadline is None else deadline - _t.time()
            if remaining is not None and remaining <= 0:
                return None
            entry.wait_for(min(1.0, remaining) if remaining is not None else 1.0)

    def take_first(self):
        """BZPOPMIN parked on add wakeups (takeFirst)."""
        return self._poll_blocking(self.poll_first, None)

    def take_last(self):
        return self._poll_blocking(self.poll_last, None)

    def poll_first_blocking(self, timeout: Optional[float]):
        return self._poll_blocking(self.poll_first, timeout)

    def poll_last_blocking(self, timeout: Optional[float]):
        return self._poll_blocking(self.poll_last, timeout)


def _agg(mode: str, a: float, b: float) -> float:
    if mode == "SUM":
        return a + b
    if mode == "MIN":
        return min(a, b)
    if mode == "MAX":
        return max(a, b)
    raise ValueError(f"unknown aggregate {mode!r}")


def _in_score(s: float, lo: float, lo_inc: bool, hi: float, hi_inc: bool) -> bool:
    lo_ok = s > lo or (lo_inc and s == lo)
    hi_ok = s < hi or (hi_inc and s == hi)
    return lo_ok and hi_ok


def _norm_range(start: int, end: int, n: int) -> Tuple[int, int]:
    if start < 0:
        start = max(0, n + start)
    if end < 0:
        end = n + end
    return start, min(end, n - 1)
