"""BinaryStream + JsonBucket.

Parity targets:
  * RBinaryStream — ``org/redisson/RedissonBinaryStream.java``: stream-style
    read/write over a byte value (GETRANGE/SETRANGE), channel positions.
  * RJsonBucket — ``org/redisson/RedissonJsonBucket.java`` (932 LoC): JSON
    document with path get/set (JSON.GET/JSON.SET of RedisJSON), array ops,
    numeric increment.  Paths use a dotted subset ("a.b[0].c", "$" = root).

A copy of ``redisson_tpu/client/objects/binarystream.py`` on the port's engine.
"""
from __future__ import annotations

import json
import re
from typing import Any, List, Optional

from redisson_tpu_torch.client.objects.base import RExpirable
from redisson_tpu_torch.core.store import StateRecord


class BinaryStream(RExpirable):
    _kind = "binary_stream"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host=bytearray())
        )

    def get(self) -> bytes:
        rec = self._engine.store.get(self._name)
        return b"" if rec is None else bytes(rec.host)

    def set(self, data: bytes) -> None:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host[:] = data
            self._touch_version(rec)

    def size(self) -> int:
        rec = self._engine.store.get(self._name)
        return 0 if rec is None else len(rec.host)

    def read(self, position: int, length: int) -> bytes:
        """GETRANGE-style read."""
        rec = self._engine.store.get(self._name)
        if rec is None:
            return b""
        return bytes(rec.host[position : position + length])

    def write(self, position: int, data: bytes) -> int:
        """SETRANGE-style write (zero-fills a gap); returns new size."""
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if position > len(rec.host):
                rec.host.extend(b"\x00" * (position - len(rec.host)))
            end = position + len(data)
            if end > len(rec.host):
                rec.host.extend(b"\x00" * (end - len(rec.host)))
            rec.host[position:end] = data
            self._touch_version(rec)
            return len(rec.host)

    def append(self, data: bytes) -> int:
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            rec.host.extend(data)
            self._touch_version(rec)
            return len(rec.host)


_PATH_TOKEN = re.compile(r"([^.\[\]]+)|\[(\d+)\]")


def _parse_path(path: str) -> List:
    if path in ("$", "", "."):
        return []
    out: List = []
    for name, idx in _PATH_TOKEN.findall(path.lstrip("$.")):
        out.append(int(idx) if idx else name)
    return out


class JsonBucket(RExpirable):
    """RJsonBucket: JSON document store with path operations."""

    _kind = "json_bucket"

    def _rec_or_create(self) -> StateRecord:
        return self._engine.store.get_or_create(
            self._name, self._kind, lambda: StateRecord(kind=self._kind, host={"doc": None})
        )

    @staticmethod
    def _walk(doc, tokens, create=False):
        """Returns (parent_container, final_token) for a path."""
        cur = doc
        for i, t in enumerate(tokens[:-1]):
            nxt = None
            if isinstance(cur, dict):
                nxt = cur.get(t)
                if nxt is None and create:
                    nxt = cur[t] = {}
            elif isinstance(cur, list) and isinstance(t, int) and t < len(cur):
                nxt = cur[t]
            if nxt is None:
                raise KeyError(".".join(map(str, tokens[: i + 1])))
            cur = nxt
        return cur, tokens[-1] if tokens else None

    def set(self, path: str, value: Any) -> None:
        """JSON.SET."""
        value = json.loads(json.dumps(value))  # enforce JSON-able
        tokens = _parse_path(path)
        with self._engine.locked(self._name):
            rec = self._rec_or_create()
            if not tokens:
                rec.host["doc"] = value
            else:
                if rec.host["doc"] is None:
                    rec.host["doc"] = {}
                parent, last = self._walk(rec.host["doc"], tokens, create=True)
                if isinstance(parent, list):
                    parent[last] = value
                else:
                    parent[last] = value
            self._touch_version(rec)

    def get(self, path: str = "$") -> Any:
        """JSON.GET."""
        rec = self._engine.store.get(self._name)
        if rec is None or rec.host["doc"] is None:
            return None
        tokens = _parse_path(path)
        if not tokens:
            return rec.host["doc"]
        try:
            parent, last = self._walk(rec.host["doc"], tokens)
            return parent[last] if last is not None else parent
        except (KeyError, IndexError, TypeError):
            return None

    def delete(self, path: str = "$") -> bool:
        """JSON.DEL; root delete removes the object."""
        tokens = _parse_path(path)
        with self._engine.locked(self._name):
            if not tokens:
                return self._engine.store.delete(self._name)
            rec = self._rec_or_create()
            if rec.host["doc"] is None:
                return False
            try:
                parent, last = self._walk(rec.host["doc"], tokens)
                if isinstance(parent, dict):
                    del parent[last]
                else:
                    parent.pop(last)
                self._touch_version(rec)
                return True
            except (KeyError, IndexError, TypeError):
                return False

    def increment_and_get(self, path: str, delta) -> Any:
        """JSON.NUMINCRBY."""
        with self._engine.locked(self._name):
            cur = self.get(path)
            if not isinstance(cur, (int, float)):
                raise TypeError(f"value at {path!r} is not a number")
            new = cur + delta
            self.set(path, new)
            return new

    def array_append(self, path: str, *values) -> int:
        """JSON.ARRAPPEND; returns new array length."""
        with self._engine.locked(self._name):
            arr = self.get(path)
            if not isinstance(arr, list):
                raise TypeError(f"value at {path!r} is not an array")
            arr.extend(json.loads(json.dumps(v)) for v in values)
            rec = self._rec_or_create()
            self._touch_version(rec)
            return len(arr)

    def array_size(self, path: str) -> Optional[int]:
        arr = self.get(path)
        return len(arr) if isinstance(arr, list) else None

    def string_size(self, path: str) -> Optional[int]:
        s = self.get(path)
        return len(s) if isinstance(s, str) else None

    def type(self, path: str = "$") -> Optional[str]:
        v = self.get(path)
        if v is None:
            return None
        return {dict: "object", list: "array", str: "string", bool: "boolean", int: "integer", float: "number"}[type(v)]

    def clear(self, path: str = "$") -> int:
        """JSON.CLEAR: empty containers, zero numbers; returns #cleared."""
        with self._engine.locked(self._name):
            v = self.get(path)
            if isinstance(v, dict) or isinstance(v, list):
                self.set(path, {} if isinstance(v, dict) else [])
                return 1
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.set(path, 0)
                return 1
            return 0

    def toggle(self, path: str) -> Optional[bool]:
        """JSON.TOGGLE a boolean; returns the new value."""
        with self._engine.locked(self._name):
            v = self.get(path)
            if not isinstance(v, bool):
                return None
            self.set(path, not v)
            return not v

    def string_append(self, path: str, s: str) -> int:
        """JSON.STRAPPEND; returns the new string length."""
        with self._engine.locked(self._name):
            cur = self.get(path)
            if not isinstance(cur, str):
                raise TypeError(f"value at {path!r} is not a string")
            new = cur + s
            self.set(path, new)
            return len(new)

    def array_insert(self, path: str, index: int, *values) -> int:
        """JSON.ARRINSERT; negative index counts from the end; returns the
        new array length.  All values insert CONTIGUOUSLY at the normalized
        position (inserting relative to the growing list would scatter
        them)."""
        with self._engine.locked(self._name):
            arr = self.get(path)
            if not isinstance(arr, list):
                raise TypeError(f"value at {path!r} is not an array")
            idx = index + len(arr) if index < 0 else index
            idx = max(0, min(idx, len(arr)))
            arr[idx:idx] = [json.loads(json.dumps(v)) for v in values]
            self._touch_version(self._rec_or_create())
            return len(arr)

    def array_pop(self, path: str, index: int = -1) -> Any:
        """JSON.ARRPOP; returns the popped element (None on empty/missing).
        Out-of-range indexes clamp to the nearest end (Redis semantics)."""
        with self._engine.locked(self._name):
            arr = self.get(path)
            if not isinstance(arr, list) or not arr:
                return None
            idx = index + len(arr) if index < 0 else index
            idx = max(0, min(idx, len(arr) - 1))
            v = arr.pop(idx)
            self._touch_version(self._rec_or_create())
            return v

    def array_trim(self, path: str, start: int, stop: int) -> int:
        """JSON.ARRTRIM to [start, stop] inclusive; negative indexes count
        from the end Redis-style (stop=-1 keeps through the last element);
        returns the new length."""
        with self._engine.locked(self._name):
            arr = self.get(path)
            if not isinstance(arr, list):
                raise TypeError(f"value at {path!r} is not an array")
            n = len(arr)
            lo = max(0, start + n if start < 0 else start)
            hi = stop + n if stop < 0 else stop
            arr[:] = arr[lo : hi + 1] if hi >= lo else []
            self._touch_version(self._rec_or_create())
            return len(arr)

    def array_index_of(self, path: str, value, start: int = 0, stop: int = 0) -> int:
        """JSON.ARRINDEX; -1 when absent.  stop=0 means 'to the end';
        negative indexes count from the end (Redis semantics).  The result
        is always an ABSOLUTE position."""
        arr = self.get(path)
        if not isinstance(arr, list):
            return -1
        n = len(arr)
        lo = max(0, start + n if start < 0 else start)
        hi = n if stop == 0 else (stop + n if stop < 0 else min(stop, n))
        hi = max(0, hi)  # a stop below -len must mean "empty range", not a
        # second negative re-interpretation inside list.index
        try:
            return arr.index(value, lo, hi)
        except ValueError:
            return -1

    def object_keys(self, path: str = "$") -> Optional[List[str]]:
        """JSON.OBJKEYS."""
        v = self.get(path)
        return list(v.keys()) if isinstance(v, dict) else None

    def object_size(self, path: str = "$") -> Optional[int]:
        """JSON.OBJLEN."""
        v = self.get(path)
        return len(v) if isinstance(v, dict) else None

    def merge(self, path: str, value: Any) -> None:
        """JSON.MERGE (RFC 7386 merge-patch): dicts merge recursively,
        None values delete keys, everything else replaces."""

        def patch(target, p):
            if not isinstance(p, dict):
                return json.loads(json.dumps(p))
            if not isinstance(target, dict):
                target = {}
            for k, v in p.items():
                if v is None:
                    target.pop(k, None)
                else:
                    target[k] = patch(target.get(k), v)
            return target

        with self._engine.locked(self._name):
            cur = self.get(path)
            self.set(path, patch(cur, value))
