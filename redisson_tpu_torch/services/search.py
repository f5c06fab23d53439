"""Search service: secondary indexes, queries, aggregations and KNN.

A port of ``redisson_tpu/services/search.py`` (RSearch and the condition tree
of LiveObjectSearch: EQ/GT/GE/LT/LE/IN/AND/OR).  Every NUMERIC field of an
index is one column of a dense (docs x fields) float32 matrix on the
engine's device, so a numeric filter over N documents is one elementwise
compare (NaN, the unindexed value, compares false); TEXT words and TAG
values live in host-side inverted indexes; VECTOR fields are the embedding
banks of ``services/vector.py``.

Auto-indexing: `sync()` scans the maps whose names match an index prefix
through the engine store (skipping maps whose record version is unchanged),
and maps report into the index through `add_document` / `remove_document`.
"""
from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# -- schema ------------------------------------------------------------------


class FieldType:
    TEXT = "TEXT"
    TAG = "TAG"
    NUMERIC = "NUMERIC"
    VECTOR = "VECTOR"  # device-resident embedding bank (services/vector.py)


_WORD = re.compile(r"[\w']+")


def tokenize(text: str) -> List[str]:
    return [w.lower() for w in _WORD.findall(str(text))]


# -- condition tree (liveobject/condition/* analog) --------------------------


@dataclass
class Condition:
    def and_(self, other: "Condition") -> "Condition":
        return And([self, other])

    def or_(self, other: "Condition") -> "Condition":
        return Or([self, other])


@dataclass
class Eq(Condition):
    field: str
    value: Any


@dataclass
class In(Condition):
    field: str
    values: Sequence[Any]


@dataclass
class Range(Condition):
    """lo <= field <= hi with open endpoints via inclusive flags."""

    field: str
    lo: float = float("-inf")
    hi: float = float("inf")
    lo_inc: bool = True
    hi_inc: bool = True


def Gt(field: str, v: float) -> Range:
    return Range(field, lo=v, lo_inc=False)


def Ge(field: str, v: float) -> Range:
    return Range(field, lo=v, lo_inc=True)


def Lt(field: str, v: float) -> Range:
    return Range(field, hi=v, hi_inc=False)


def Le(field: str, v: float) -> Range:
    return Range(field, hi=v, hi_inc=True)


@dataclass
class Text(Condition):
    """Full-text: all words must match (FT.SEARCH default AND semantics)."""

    field: str
    query: str


@dataclass
class And(Condition):
    parts: List[Condition] = field(default_factory=list)


@dataclass
class Or(Condition):
    parts: List[Condition] = field(default_factory=list)


# -- index -------------------------------------------------------------------


class _NumericPlane:
    """Dense (docs × numeric-fields) matrix on the block-appended device row
    bank (services/vector.DeviceRowBank): appends and overwrites buffer on
    the host and flush as ONE packed upload + scatter a block, so N
    single-doc ingests cost O(N/block) transfers; a query flushes at most
    the pending tail."""

    def __init__(self, fields: List[str], device="cpu"):
        from redisson_tpu_torch.services.vector import DeviceRowBank

        self.fields = fields
        self.col = {f: i for i, f in enumerate(fields)}
        self._count = 0
        self._device = torch.device(device)
        self._bank = DeviceRowBank(len(fields), device=self._device) if fields else None

    def __len__(self) -> int:
        return self._count

    @property
    def h2d_flushes(self) -> int:
        return self._bank.h2d_flushes if self._bank is not None else 0

    def _row(self, values: Dict[str, Any]) -> np.ndarray:
        row = np.full(len(self.fields), np.nan, np.float32)
        for f, v in values.items():
            if f in self.col and v is not None:
                try:
                    row[self.col[f]] = float(v)
                except (TypeError, ValueError):
                    pass  # non-numeric value in a NUMERIC column: unindexed
        return row

    def append(self, values: Dict[str, Any]) -> int:
        rowid = self._count
        self._count += 1
        if self._bank is not None:
            self._bank.set_row(rowid, self._row(values))
        return rowid

    def replace(self, rowid: int, values: Dict[str, Any]) -> None:
        if self._bank is not None:
            self._bank.set_row(rowid, self._row(values))

    def clear_row(self, rowid: int) -> None:
        # explicit NaN row (NOT the bank's zero-filled kill): NaN is the
        # "unindexed" sentinel every range compare already treats as False
        if self._bank is not None:
            self._bank.set_row(
                rowid, np.full(len(self.fields), np.nan, np.float32)
            )

    def matrix(self) -> torch.Tensor:
        if self._bank is None:
            return torch.zeros((0, 0), dtype=torch.float32, device=self._device)
        bank, _bias, _scale, rows = self._bank.device_planes()
        if bank is None:
            return torch.zeros((0, len(self.fields)), dtype=torch.float32, device=self._device)
        return bank[:rows]

    def range_mask(self, cond: Range) -> np.ndarray:
        """One elementwise compare over all docs on the device (torch ops:
        NaN compares false)."""
        m = self.matrix()
        if m.shape[0] == 0 or cond.field not in self.col:
            return np.zeros(self._count, bool)
        colv = m[:, self.col[cond.field]]
        lo_ok = colv >= cond.lo if cond.lo_inc else colv > cond.lo
        hi_ok = colv <= cond.hi if cond.hi_inc else colv < cond.hi
        mask = torch.where(torch.isnan(colv), False, lo_ok & hi_ok)
        return mask.cpu().numpy()


class SearchIndex:
    """One FT index: schema + doc table + inverted/tag/numeric planes."""

    def __init__(
        self,
        name: str,
        schema: Dict[str, str],
        prefixes: Sequence[str] = ("",),
        doc_mode: str = "entry",
        engine=None,
        vector_specs: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.schema = dict(schema)
        self.prefixes = list(prefixes)
        # device-resident embedding banks (FT VECTOR fields): rowids shared
        # with the numeric plane, banks record-backed so they tear down like
        # every other record.  Requires the engine; an engine-less index
        # (unit-test construction) refuses VECTOR fields rather than
        # silently indexing nothing.
        self.vector_specs = dict(vector_specs or {})
        if self.vector_specs and engine is None:
            raise ValueError("VECTOR fields need an engine-bound index")
        if engine is not None and self.vector_specs:
            from redisson_tpu_torch.services.vector import VectorPlane

            self.vectors = VectorPlane(engine, name, self.vector_specs)
        else:
            self.vectors = None
        # document model for auto-ingestion (SearchService.sync):
        #   "entry" — one doc per dict-valued map ENTRY, id "{map}:{key}"
        #             (the embedded facade's historical model)
        #   "hash"  — one doc per map RECORD, id = map name (RediSearch's
        #             ON HASH model, used by the FT.* wire verbs)
        # One model per index: the two disagree on doc identity, and mixing
        # them through the shared version stamps would suppress each other.
        if doc_mode not in ("entry", "hash"):
            raise ValueError(f"unknown doc_mode {doc_mode!r}")
        self.doc_mode = doc_mode
        self.docs: Dict[str, Dict[str, Any]] = {}          # doc_id -> fields
        self._rowid: Dict[str, int] = {}                   # doc_id -> numeric row
        self._rowdoc: List[Optional[str]] = []             # row -> doc_id
        self._text: Dict[str, Dict[str, set]] = {
            f: {} for f, t in schema.items() if t == FieldType.TEXT
        }                                                   # field -> word -> ids
        self._tag: Dict[str, Dict[Any, set]] = {
            f: {} for f, t in schema.items() if t == FieldType.TAG
        }
        self._numeric = _NumericPlane(
            [f for f, t in schema.items() if t == FieldType.NUMERIC],
            engine.device if engine is not None else "cpu",
        )
        self._synced_versions: Dict[str, int] = {}          # map name -> version
        # synonym groups (FT.SYNUPDATE/SYNDUMP): group id -> lowercase terms,
        # and the reverse map consulted at query time
        self.synonyms: Dict[str, set] = {}
        self._syn_of: Dict[str, set] = {}
        self._lock = threading.RLock()

    # -- synonyms (RediSearch FT.SYNUPDATE / FT.SYNDUMP) ---------------------

    def syn_update(self, group_id: str, terms: Sequence[str]) -> None:
        with self._lock:
            g = self.synonyms.setdefault(group_id, set())
            for t in terms:
                t = str(t).lower()
                g.add(t)
                self._syn_of.setdefault(t, set()).add(group_id)

    def syn_dump(self) -> Dict[str, List[str]]:
        """term -> sorted group ids (the FT.SYNDUMP reply shape)."""
        with self._lock:
            return {t: sorted(gs) for t, gs in self._syn_of.items()}

    # -- document maintenance ------------------------------------------------

    def add(self, doc_id: str, fields: Dict[str, Any]) -> None:
        with self._lock:
            if doc_id in self.docs:
                self._unindex(doc_id)
                self.docs[doc_id] = dict(fields)
                self._index_inverted(doc_id, fields)
                row = self._rowid[doc_id]
                self._numeric.replace(row, fields)
            else:
                self.docs[doc_id] = dict(fields)
                self._index_inverted(doc_id, fields)
                row = self._numeric.append(fields)
                self._rowid[doc_id] = row
                self._rowdoc.append(doc_id)
            if self.vectors:
                self.vectors.set_row(row, fields)

    def remove(self, doc_id: str) -> bool:
        with self._lock:
            if doc_id not in self.docs:
                return False
            self._unindex(doc_id)
            del self.docs[doc_id]
            row = self._rowid.pop(doc_id)
            self._rowdoc[row] = None
            self._numeric.clear_row(row)
            if self.vectors:
                self.vectors.clear_row(row)
            return True

    def _index_inverted(self, doc_id: str, fields: Dict[str, Any]) -> None:
        for f, words in self._text.items():
            for w in tokenize(fields.get(f, "")):
                words.setdefault(w, set()).add(doc_id)
        for f, tags in self._tag.items():
            v = fields.get(f)
            if v is not None:
                tags.setdefault(v, set()).add(doc_id)

    def _unindex(self, doc_id: str) -> None:
        old = self.docs[doc_id]
        for f, words in self._text.items():
            for w in tokenize(old.get(f, "")):
                ids = words.get(w)
                if ids is not None:
                    ids.discard(doc_id)
        for f, tags in self._tag.items():
            v = old.get(f)
            if v is not None and v in tags:
                tags[v].discard(doc_id)

    # -- evaluation ----------------------------------------------------------

    def _eval(self, cond: Optional[Condition]) -> set:
        with self._lock:
            if cond is None:
                return set(self.docs)
            return self._eval_inner(cond)

    def _eval_inner(self, cond: Condition) -> set:
        if isinstance(cond, And):
            sets = [self._eval_inner(p) for p in cond.parts]
            return set.intersection(*sets) if sets else set(self.docs)
        if isinstance(cond, Or):
            out: set = set()
            for p in cond.parts:
                out |= self._eval_inner(p)
            return out
        if isinstance(cond, Text):
            words = tokenize(cond.query)
            plane = self._text.get(cond.field, {})
            sets = []
            for w in words:
                ids = set(plane.get(w, set()))
                # synonym expansion (FT.SYNUPDATE groups): a query term
                # matches docs containing ANY member of its groups —
                # RediSearch semantics, index-time groups applied query-side
                for g in self._syn_of.get(w, ()):
                    for w2 in self.synonyms.get(g, ()):
                        ids |= plane.get(w2, set())
                sets.append(ids)
            return set.intersection(*sets) if sets else set()
        if isinstance(cond, Eq):
            ftype = self.schema.get(cond.field)
            if ftype == FieldType.TAG:
                return set(self._tag.get(cond.field, {}).get(cond.value, set()))
            if ftype == FieldType.NUMERIC:
                v = float(cond.value)
                return self._mask_to_ids(self._numeric.range_mask(Range(cond.field, v, v)))
            if ftype == FieldType.TEXT:
                return self._eval_inner(Text(cond.field, str(cond.value)))
            return {d for d, f in self.docs.items() if f.get(cond.field) == cond.value}
        if isinstance(cond, In):
            out = set()
            for v in cond.values:
                out |= self._eval_inner(Eq(cond.field, v))
            return out
        if isinstance(cond, Range):
            return self._mask_to_ids(self._numeric.range_mask(cond))
        raise TypeError(f"unknown condition {cond!r}")

    def _mask_to_ids(self, mask: np.ndarray) -> set:
        return {
            self._rowdoc[i]
            for i in np.nonzero(mask)[0]
            if self._rowdoc[i] is not None
        }

    def __len__(self) -> int:
        return len(self.docs)


# -- results -----------------------------------------------------------------


@dataclass
class SearchResult:
    total: int
    docs: List[Tuple[str, Dict[str, Any]]]


# -- service -----------------------------------------------------------------


def _edit_distance_le(a: str, b: str, k: int) -> bool:
    """Levenshtein distance <= k (banded DP; FT.SPELLCHECK DISTANCE 1-4)."""
    if abs(len(a) - len(b)) > k:
        return False
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        best = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(
                prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)
            )
            best = min(best, cur[j])
        if best > k:
            return False
        prev = cur
    return prev[-1] <= k


class SearchService:
    """RSearch analog bound to one engine."""

    def __init__(self, engine):
        self._engine = engine
        self._indexes: Dict[str, SearchIndex] = {}
        self._aliases: Dict[str, str] = {}       # alias -> index name
        self._dicts: Dict[str, set] = {}         # FT.DICT* custom dictionaries
        # FT.CURSOR id -> (pending rows, expires_at): abandoned cursors are
        # pruned by idle timeout + a hard cap, like RediSearch's cursor
        # expiry — without it every undrained WITHCURSOR leaks its rows for
        # the server's lifetime
        self._cursors: Dict[int, Tuple[List[Any], float]] = {}
        self._next_cursor = 1
        self._lock = threading.Lock()

    CURSOR_TTL = 300.0
    CURSOR_MAX = 128

    def _prune_cursors_locked(self) -> None:
        import time as _time

        now = _time.time()
        for cid in [c for c, (_r, exp) in self._cursors.items() if exp <= now]:
            del self._cursors[cid]
        while len(self._cursors) > self.CURSOR_MAX:
            del self._cursors[min(self._cursors)]  # oldest id first

    # -- FT.CREATE / DROPINDEX / _LIST ---------------------------------------

    @staticmethod
    def _vector_specs(schema: Dict[str, str], vector) -> Dict[str, Any]:
        """Normalize the `vector` argument ({field: VectorFieldSpec | spec
        kwargs}) and cross-check it against the schema's VECTOR fields."""
        from redisson_tpu_torch.services.vector import VectorFieldSpec

        specs: Dict[str, Any] = {}
        for f, spec in (vector or {}).items():
            if not isinstance(spec, VectorFieldSpec):
                spec = VectorFieldSpec(field=f, **dict(spec))
            specs[f] = spec
        declared = {f for f, t in schema.items() if t == FieldType.VECTOR}
        if declared != set(specs):
            raise ValueError(
                f"VECTOR schema fields {sorted(declared)} need matching "
                f"vector specs (got {sorted(specs)})"
            )
        return specs

    def create_index(
        self,
        name: str,
        schema: Dict[str, str],
        prefixes: Sequence[str] = ("",),
        doc_mode: str = "entry",
        vector: Optional[Dict[str, Any]] = None,
    ) -> SearchIndex:
        specs = self._vector_specs(schema, vector)
        with self._lock:
            if name in self._indexes:
                raise ValueError(f"index '{name}' already exists")
            idx = SearchIndex(
                name, schema, prefixes, doc_mode,
                engine=self._engine, vector_specs=specs,
            )
            self._indexes[name] = idx
        self.sync(name)
        return idx

    def create(
        self,
        name: str,
        schema: Dict[str, str],
        prefixes: Sequence[str] = ("",),
        doc_mode: str = "entry",
        vector: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Wire-friendly FT.CREATE (returns a plain bool so it survives the
        OBJCALL pickle boundary; `create_index` returns the live index)."""
        self.create_index(name, schema, prefixes, doc_mode, vector=vector)
        return True

    def drop_index(self, name: str) -> bool:
        with self._lock:
            idx = self._indexes.pop(name, None)
        if idx is not None and idx.vectors:
            # bank records leave the store with the index: device memory is
            # released through the ordinary teardown path, so the census's
            # ftvec gauges return to baseline
            idx.vectors.drop()
        return idx is not None

    def index_names(self) -> List[str]:
        with self._lock:
            return sorted(self._indexes)

    def _idx(self, name: str) -> SearchIndex:
        with self._lock:
            name = self._aliases.get(name, name)
            idx = self._indexes.get(name)
        if idx is None:
            raise KeyError(f"no such index '{name}'")
        return idx

    def resolve(self, name: str) -> str:
        """Alias -> real index name (identity for real names)."""
        with self._lock:
            return self._aliases.get(name, name)

    # -- FT.ALTER ------------------------------------------------------------

    def alter(self, name: str, field: str, ftype: str) -> None:
        """FT.ALTER idx SCHEMA ADD field type: rebuild the index with the
        widened schema and re-add every stored doc (the numeric plane's
        column set is fixed at construction, so ALTER swaps the index the
        way RediSearch rescans)."""
        old = self._idx(name)
        if field in old.schema:
            raise ValueError(f"field '{field}' already exists")
        schema = dict(old.schema)
        schema[field] = ftype
        fresh = SearchIndex(
            old.name, schema, old.prefixes, old.doc_mode,
            engine=self._engine, vector_specs=old.vector_specs,
        )
        with old._lock:
            for doc_id, fields in old.docs.items():
                fresh.add(doc_id, fields)
        with self._lock:
            self._indexes[old.name] = fresh
        self.sync(old.name)

    # -- FT.ALIAS* -----------------------------------------------------------

    def alias_add(self, alias: str, index: str) -> None:
        self._idx(index)  # KeyError if unknown
        with self._lock:
            if alias in self._aliases:
                raise ValueError(f"alias '{alias}' already exists")
            self._aliases[alias] = self._aliases.get(index, index)

    def alias_update(self, alias: str, index: str) -> None:
        self._idx(index)
        with self._lock:
            self._aliases[alias] = self._aliases.get(index, index)

    def alias_del(self, alias: str) -> None:
        with self._lock:
            if alias not in self._aliases:
                raise ValueError(f"alias '{alias}' does not exist")
            del self._aliases[alias]

    # -- FT.DICT* ------------------------------------------------------------

    def dict_add(self, name: str, *terms: str) -> int:
        with self._lock:
            d = self._dicts.setdefault(name, set())
            before = len(d)
            d.update(terms)
            return len(d) - before

    def dict_del(self, name: str, *terms: str) -> int:
        with self._lock:
            d = self._dicts.get(name, set())
            n = 0
            for t in terms:
                if t in d:
                    d.discard(t)
                    n += 1
            return n

    def dict_dump(self, name: str) -> List[str]:
        with self._lock:
            return sorted(self._dicts.get(name, ()))

    # -- FT.SPELLCHECK -------------------------------------------------------

    def spellcheck(
        self, index: str, query: str, include: Sequence[str] = (),
        exclude: Sequence[str] = (), distance: int = 1,
    ) -> Dict[str, List[Tuple[float, str]]]:
        """Suggestions for query terms absent from the index vocabulary
        (RediSearch FT.SPELLCHECK): candidates come from the index's TEXT
        terms plus INCLUDE dicts, minus EXCLUDE dicts; scored by the share
        of docs containing the suggestion (the RediSearch score shape)."""
        idx = self._idx(index)
        self.sync(self.resolve(index))
        vocab: Dict[str, int] = {}
        with idx._lock:
            ndocs = max(1, len(idx.docs))
            for words in idx._text.values():
                for w, ids in words.items():
                    if ids:
                        vocab[w] = max(vocab.get(w, 0), len(ids))
        with self._lock:
            included = set().union(*(self._dicts.get(d, set()) for d in include)) if include else set()
            excluded = set().union(*(self._dicts.get(d, set()) for d in exclude)) if exclude else set()
        known = (set(vocab) | included) - excluded
        out: Dict[str, List[Tuple[float, str]]] = {}
        for term in tokenize(query):
            if term in known:
                continue
            sugg = [
                (vocab.get(c, 0) / ndocs if c in vocab else 0.0, c)
                for c in known
                if _edit_distance_le(term, c, distance)
            ]
            sugg.sort(key=lambda t: (-t[0], t[1]))
            out[term] = sugg
        return out

    # -- FT.CURSOR -----------------------------------------------------------

    def cursor_create(self, rows: List[Any]) -> int:
        import time as _time

        with self._lock:
            cid = self._next_cursor
            self._next_cursor += 1
            self._cursors[cid] = (list(rows), _time.time() + self.CURSOR_TTL)
            self._prune_cursors_locked()  # after insert: cap includes the new one
            return cid

    def cursor_read(self, cid: int, count: int) -> Tuple[List[Any], int]:
        """Returns (rows, next_cursor_id); 0 = exhausted (and deleted).
        A read refreshes the cursor's idle deadline."""
        import time as _time

        with self._lock:
            self._prune_cursors_locked()
            entry = self._cursors.get(cid)
            if entry is None:
                raise KeyError(f"no such cursor {cid}")
            pending, _exp = entry
            rows, rest = pending[:count], pending[count:]
            if rest:
                self._cursors[cid] = (rest, _time.time() + self.CURSOR_TTL)
                return rows, cid
            del self._cursors[cid]
            return rows, 0

    def cursor_del(self, cid: int) -> None:
        with self._lock:
            if cid not in self._cursors:
                raise KeyError(f"no such cursor {cid}")
            del self._cursors[cid]

    def info(self, name: str) -> Dict[str, Any]:
        idx = self._idx(name)
        out = {
            "name": idx.name,
            "num_docs": len(idx),
            "schema": dict(idx.schema),
            "prefixes": list(idx.prefixes),
        }
        if idx.vectors:
            out["vector_fields"] = idx.vectors.info_rows()
            out["vector_device_bytes"] = idx.vectors.device_bytes()
            out["vector_index_bytes"] = idx.vectors.index_device_bytes()
        return out

    def device_census(self) -> Dict[str, float]:
        """Embedding-bank residency gauges: the bank count and device bytes
        (and per-device rows); they return to baseline after FT.DROPINDEX."""
        with self._lock:
            indexes = list(self._indexes.values())
        banks = 0
        total = 0
        index_bytes = 0
        by_dev: Dict[int, float] = {}
        idx_by_dev: Dict[int, float] = {}
        for idx in indexes:
            if idx.vectors:
                banks += len(idx.vectors.banks)
                total += idx.vectors.device_bytes()
                index_bytes += idx.vectors.index_device_bytes()
                for d, v in idx.vectors.device_bytes_by_device().items():
                    by_dev[d] = by_dev.get(d, 0.0) + float(v)
                for d, v in idx.vectors.index_bytes_by_device().items():
                    idx_by_dev[d] = idx_by_dev.get(d, 0.0) + float(v)
        out = {
            "ftvec_banks": float(banks),
            "ftvec_device_bytes": float(total),
            # the IVF coarse index (centroids + cell table) — its own row
            # so soaks catch a cell-index leak on DROPINDEX even when the
            # bank itself tears down correctly
            "ftvec_index_bytes": float(index_bytes),
        }
        # per-device breakdown: which device holds how many bank /
        # coarse-index bytes.  Rows exist only while a device holds bytes,
        # so DROPINDEX returns every row to absence == zero.
        for d, v in sorted(by_dev.items()):
            out[f"ftvec_device_bytes_dev{d}"] = v
        for d, v in sorted(idx_by_dev.items()):
            out[f"ftvec_index_bytes_dev{d}"] = v
        return out

    # -- tracking-plane integration -------------------------------------------
    #
    # FT.* is keyless on the wire, so the generic key-based tracking hooks
    # never see it.  A tracked FT.SEARCH registers the index's synthetic
    # QUERY KEY instead, and the index's INGEST STREAM (writes landing under
    # its prefixes, index DDL) invalidates that key — hot query results
    # near-cache client-side and go stale the moment the index can change.

    @staticmethod
    def query_key(name: str) -> str:
        return f"__ftq__:{name}"

    def ingest_touched(self, written_names: Sequence[str]) -> List[str]:
        """Query keys of every hash-mode index whose prefixes cover any of
        the written key names (the write-side invalidation hook the server's
        TrackingTable calls post-dispatch)."""
        with self._lock:
            indexes = list(self._indexes.items())
        out = []
        for name, idx in indexes:
            if idx.doc_mode != "hash":
                continue
            if any(
                n.startswith(p)
                for p in idx.prefixes
                for n in written_names
            ):
                out.append(self.query_key(name))
        return out

    # -- KNN (FT VECTOR, services/vector.py) ----------------------------------

    def knn(self, index: str, field: str, queries, k: int,
            condition: Optional[Condition] = None,
            nprobe: Optional[int] = None):
        """One stacked KNN over the index's embedding bank (FLAT exact, or
        routed IVF once the field's coarse quantizer trained; ``nprobe``
        overrides the IVF field's probe width for this query).

        Returns ``(device, finish)``: with the device path on, `device` is
        the (dist, idx) pair of kernel outputs, still on the device, and the
        caller calls ``finish(device)`` (device tensors or their host
        copies); with it off (RTPU_NO_VECTOR), `device` is None and
        ``finish(None)`` scores on the NumPy path.  Either way
        ``finish`` maps rows back to doc ids and returns one
        ``[(doc_id, distance), ...]`` list per query (distance ascending,
        ties toward the lower rowid)."""
        from redisson_tpu_torch.services import vector as V

        idx = self._idx(index)
        bank = idx.vectors.banks.get(field) if idx.vectors else None
        if bank is None:
            raise ValueError(f"'{field}' is not a VECTOR field of '{index}'")
        if nprobe and bank.spec.algo != "IVF":
            # validated HERE, before either scoring path dispatches: the
            # disarmed path resolves inside finish() — past the verb's
            # ValueError->RespError mapping — so a late raise would reply
            # 'ERR internal' disarmed but a clean error armed
            raise ValueError("NPROBE applies to an IVF field")
        q = np.ascontiguousarray(queries, np.float32).reshape(-1, bank.spec.dim)
        nq = q.shape[0]
        allowed = None
        if condition is not None:
            ids = idx._eval(condition)
            with idx._lock:
                allowed = np.fromiter(
                    (idx._rowid[d] for d in ids if d in idx._rowid),
                    np.int64,
                )
            if allowed.size == 0:
                return None, lambda _vals: [[] for _ in range(nq)]
        armed = V.vector_enabled()
        out = (
            bank.knn_async(q, k, allowed_rows=allowed, nprobe=nprobe)
            if armed else None
        )
        if armed and out is None:
            return None, lambda _vals: [[] for _ in range(nq)]

        def finish(vals):
            if vals is None:  # disarmed: score now, on host
                host = bank.knn_host(q, k, allowed_rows=allowed,
                                     nprobe=nprobe)
                if host is None:
                    return [[] for _ in range(nq)]
                dist_h, idx_h, _nq, k_eff = host
            else:
                # the bank reads its device outputs back as rowids
                dist_h, idx_h = bank.resolve_hits(vals)
                k_eff = dist_h.shape[1]
            # winners in reply order: finite entries (k past the live rows
            # leaves +inf padding) whose doc was not deleted meanwhile
            qis, js = np.nonzero(np.isfinite(dist_h[:nq, :k_eff]))
            rowids = idx_h[qis, js].astype(np.int64)
            rowdoc = idx._rowdoc
            n_docs = len(rowdoc)
            docs = [rowdoc[r] if 0 <= r < n_docs else None for r in rowids.tolist()]
            keep = [i for i, doc in enumerate(docs) if doc is not None]
            # the kernel/NumPy paths choose WHICH rows win; the reply scores
            # come from ONE per-pair routine over the host mirror, so both
            # paths give the same bits (vector.pair_scores)
            res = [[] for _ in range(nq)]
            if keep:
                scores = bank.pair_scores(q, qis[keep], rowids[keep]).tolist()
                for i, score in zip(keep, scores):
                    res[qis[i]].append((docs[i], score))
            return res

        if not armed:
            return None, finish
        # the device tensors (dist, idx); (q_count, k_eff) trail
        return tuple(out[:-2]), finish

    # -- document ingestion --------------------------------------------------

    def add_document(self, index: str, doc_id: str, fields: Dict[str, Any]) -> None:
        self._idx(index).add(doc_id, fields)

    def remove_document(self, index: str, doc_id: str) -> bool:
        return self._idx(index).remove(doc_id)

    def sync(self, name: str) -> int:
        """Pull documents from every map whose name matches a prefix — the
        reference's hash auto-indexing, done as a version-diffed scan (maps
        whose record version is unchanged are skipped).  The index's
        doc_mode decides the document model (see SearchIndex.__init__)."""
        idx = self._idx(name)
        from redisson_tpu_torch.client.objects.map import Map

        n = 0
        seen = set()
        for key in self._engine.store.keys():
            if not any(key.startswith(p) for p in idx.prefixes):
                continue
            rec = self._engine.store.get(key)
            if rec is None or rec.kind not in ("map", "map_cache"):
                continue
            seen.add(key)
            if idx._synced_versions.get(key) == rec.version:
                continue
            if idx.doc_mode == "hash":
                # wire hashes hold RAW bytes (typed HSET surface): read
                # through BytesCodec, decode to str below
                from redisson_tpu_torch.client.codec import BytesCodec

                m = Map(self._engine, key, codec=BytesCodec())
                fields = {}
                for k, v in m.read_all_entry_set():
                    ks = k.decode() if isinstance(k, (bytes, bytearray)) else str(k)
                    if idx.schema.get(ks) == FieldType.VECTOR:
                        # raw float32 blob (the RediSearch HSET wire shape):
                        # utf-8 decoding arbitrary vector bytes would throw
                        fields[ks] = bytes(v) if isinstance(
                            v, (bytes, bytearray)
                        ) else v
                        continue
                    vs = v.decode() if isinstance(v, (bytes, bytearray)) else v
                    if idx.schema.get(ks) == FieldType.NUMERIC:
                        try:
                            vs = float(vs)
                        except (TypeError, ValueError):
                            pass
                    fields[ks] = vs
                idx.add(key, fields)
                n += 1
            else:
                for k, v in Map(self._engine, key).read_all_entry_set():
                    if isinstance(v, dict):
                        idx.add(f"{key}:{k}", v)
                        n += 1
            idx._synced_versions[key] = rec.version
        if idx.doc_mode == "hash":
            # deleted hashes leave the store silently; prune their docs or
            # searches keep serving stale fields forever
            for gone in [d for d in list(idx.docs) if d not in seen]:
                idx.remove(gone)
                idx._synced_versions.pop(gone, None)
                n += 1
        return n

    # -- FT.SEARCH -----------------------------------------------------------

    def search(
        self,
        index: str,
        condition: Optional[Condition] = None,
        sort_by: Optional[str] = None,
        descending: bool = False,
        offset: int = 0,
        limit: int = 10,
    ) -> SearchResult:
        idx = self._idx(index)
        ids = idx._eval(condition)
        docs = [(d, idx.docs[d]) for d in ids]
        if sort_by is not None:
            docs.sort(
                key=lambda kv: (kv[1].get(sort_by) is None, kv[1].get(sort_by)),
                reverse=descending,
            )
        else:
            docs.sort(key=lambda kv: kv[0])
        return SearchResult(total=len(docs), docs=docs[offset : offset + limit])

    # -- FT.AGGREGATE ---------------------------------------------------------

    _REDUCERS = {
        "count": lambda xs: len(xs),
        "sum": lambda xs: float(np.sum(xs)) if len(xs) else 0.0,
        "avg": lambda xs: float(np.mean(xs)) if len(xs) else float("nan"),
        "min": lambda xs: float(np.min(xs)) if len(xs) else float("nan"),
        "max": lambda xs: float(np.max(xs)) if len(xs) else float("nan"),
    }

    def aggregate(
        self,
        index: str,
        condition: Optional[Condition] = None,
        group_by: Optional[str] = None,
        reducers: Optional[Dict[str, Tuple[str, Optional[str]]]] = None,
        sort_by: Optional[str] = None,
        descending: bool = False,
        offset: int = 0,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """GROUPBY + REDUCE [+ SORTBY + LIMIT].  `reducers` maps output
        name -> (op, field); ops: count/sum/avg/min/max (field ignored for
        count).  `sort_by` names any OUTPUT column (the group key or a
        reducer name), with offset/limit paging — the FT.AGGREGATE
        SORTBY/LIMIT pipeline stages (RedissonSearch.java aggregate)."""
        idx = self._idx(index)
        ids = idx._eval(condition)
        reducers = reducers or {"count": ("count", None)}
        groups: Dict[Any, List[Dict[str, Any]]] = {}
        for d in ids:
            fields = idx.docs[d]
            key = fields.get(group_by) if group_by else None
            groups.setdefault(key, []).append(fields)
        out = []
        for key, members in groups.items():
            row: Dict[str, Any] = {} if group_by is None else {group_by: key}
            for out_name, (op, f) in reducers.items():
                if op == "count":
                    row[out_name] = len(members)
                else:
                    xs = np.asarray(
                        [float(m[f]) for m in members if m.get(f) is not None],
                        np.float64,
                    )
                    row[out_name] = self._REDUCERS[op](xs)
            out.append(row)
        if sort_by is not None:
            # type-bucketed key: a column mixing numbers and strings must
            # sort deterministically, not raise int-vs-str TypeError
            def _key(r):
                v = r.get(sort_by)
                if v is None:
                    return (2, "", 0.0)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    return (0, "", float(v))
                return (1, str(v), 0.0)

            out.sort(key=_key, reverse=descending)
        else:
            out.sort(key=lambda r: (str(r.get(group_by)) if group_by else ""))
        if offset or limit is not None:
            out = out[offset : None if limit is None else offset + limit]
        return out
