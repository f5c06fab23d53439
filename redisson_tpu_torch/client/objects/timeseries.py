"""TimeSeries: timestamp-ordered values with TTL and range queries.

Parity target: RTimeSeries — ``org/redisson/RedissonTimeSeries.java`` (989
LoC): add(timestamp, value[, label]) with optional per-entry TTL, get,
range/rangeReversed (+limit), pollFirst/pollLast, first/last/firstTimestamp/
lastTimestamp, removeRange, size.  The reference stores a ZSET by timestamp +
value map; here a sorted host list with vectorized range scans as the device
upgrade path.

A copy of ``redisson_tpu/client/objects/timeseries.py`` on the port's engine.
"""
from __future__ import annotations

import bisect
import time
from typing import Any, Iterable, List, Optional, Tuple

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord


class TimeSeries(RExpirable):
    _kind = "timeseries"

    def _rec_or_create(self) -> StateRecord:
        # host: sorted list of [ts, value_enc, label_enc|None, expire_at|None]
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host=[])
        )

    def _reap(self, rec) -> None:
        now = time.time()
        rec.host[:] = [c for c in rec.host if c[3] is None or c[3] > now]

    def add(self, timestamp: float, value, label=None, ttl: Optional[float] = None) -> None:
        cell = [
            float(timestamp),
            self._codec.encode(value),
            self._codec.encode(label) if label is not None else None,
            time.time() + ttl if ttl else None,
        ]
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            # replace same-timestamp entry (ZADD semantics)
            i = bisect.bisect_left([c[0] for c in rec.host], cell[0])
            if i < len(rec.host) and rec.host[i][0] == cell[0]:
                rec.host[i] = cell
            else:
                rec.host.insert(i, cell)
            self._touch_version(rec)

    def add_all(self, entries: dict, ttl: Optional[float] = None) -> None:
        for ts, v in entries.items():
            self.add(ts, v, ttl=ttl)

    def get(self, timestamp: float):
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            for c in rec.host:
                if c[0] == timestamp:
                    return self._codec.decode(c[1])
            return None

    def remove(self, timestamp: float) -> bool:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            before = len(rec.host)
            rec.host[:] = [c for c in rec.host if c[0] != timestamp]
            changed = len(rec.host) != before
            if changed:
                self._touch_version(rec)
            return changed

    def size(self) -> int:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            return len(rec.host)

    def range(self, from_ts: float, to_ts: float, limit: Optional[int] = None) -> List[Tuple[float, Any]]:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            out = [
                (c[0], self._codec.decode(c[1]))
                for c in rec.host
                if from_ts <= c[0] <= to_ts
            ]
        return out[:limit] if limit is not None else out

    def range_reversed(self, from_ts: float, to_ts: float, limit: Optional[int] = None):
        out = list(reversed(self.range(from_ts, to_ts)))
        return out[:limit] if limit is not None else out

    def remove_range(self, from_ts: float, to_ts: float) -> int:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            before = len(rec.host)
            rec.host[:] = [c for c in rec.host if not (from_ts <= c[0] <= to_ts)]
            n = before - len(rec.host)
            if n:
                self._touch_version(rec)
            return n

    def first(self, count: int = 1) -> List:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            return [self._codec.decode(c[1]) for c in rec.host[:count]]

    def last(self, count: int = 1) -> List:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            return [self._codec.decode(c[1]) for c in rec.host[-count:]][::-1]

    def first_timestamp(self) -> Optional[float]:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            return rec.host[0][0] if rec.host else None

    def last_timestamp(self) -> Optional[float]:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            return rec.host[-1][0] if rec.host else None

    def poll_first(self, count: int = 1) -> List:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            out, rec.host[:count] = [self._codec.decode(c[1]) for c in rec.host[:count]], []
            if out:
                self._touch_version(rec)
            return out

    def poll_last(self, count: int = 1) -> List:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            self._reap(rec)
            if not rec.host:
                return []
            taken = rec.host[-count:]
            del rec.host[-count:]
            self._touch_version(rec)
            return [self._codec.decode(c[1]) for c in reversed(taken)]
