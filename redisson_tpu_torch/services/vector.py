"""Vector search on the card: FT VECTOR fields and their KNN banks.

A port of ``redisson_tpu/services/vector.py``.  Each index field keeps its
embeddings as ONE ``(capacity, width)`` bank in a DeviceStore record named
``__ftvec__{<index>}:<field>``, so dropping the index releases it through
the ordinary store path.  A FLAT KNN query is a score pass and a top-k over
the stacked queries (``core/kernels.knn_topk`` and its forms: the kernels
``knn_score`` and ``knn_select``); an IVF field (``algo="IVF"``) routes each
query to its ``nprobe`` nearest coarse centroids and scores only the rows
listed in those cells (``knn_ivf_topk``: ``knn_score`` + ``knn_select`` for
the route, ``ivf_score`` + ``knn_select`` for the candidates), the
centroids trained by ``kmeans_step`` over the host mirror.  FLOAT16 and
INT8 banks (INT8 with a symmetric per-row scale) are widened to float32
inside the kernels.

Bank layout, as in the reference:
  * block-appended: ingested rows buffer on the host and flush as ONE packed
    uint32 upload (row index, bias bits[, scale bits], row lanes) and one
    scatter, so N single-doc ingests cost O(N / block) transfers;
  * capacity doubles by a copy on the card (``rowbank_grow``);
  * a deleted row is a +inf bias, added into its distance in the kernel;
  * a host mirror holds the DEQUANTIZED float32 rows: the NumPy path, the
    recall oracle and the reply scores read it.

Every reply score comes from ``_pair_score_math`` over the mirror, so the
scores are the same bits whichever path chose the rows.  The IVF index
(centroids, assignments, cell lists) is host state that both paths read.

``SHARDS n > 1`` (``ShardedEmbeddingBank``, reference ``:1500-2007``) splits
a bank row-wise into n EmbeddingBanks under shard-salted record names
(``pick_shard_record_names``: with placement on, shard i's record is owned
by the position (owner + i) % positions).  A query runs one leg a live
shard, concurrently on ``_fanout_pool``, each leg under its own position's
lane, and the legs' (Q, k_s) tops merge on the card in one K19 call
(``kernels.knn_sharded_merge``: a concatenation and one ``knn_select``),
never through the host.  Positions of one card share its stream, so the
legs' kernels queue in order there; ``knn_select``'s shared per-stream
state is left reset by every call, so concurrent callers on one stream
stay sound.  With placement on, every KNN dispatch holds the owning
position's lane (``_lane_gate``).

``RTPU_NO_VECTOR=1`` or ``set_vector(False)`` selects the reference's NumPy
path: a mode the caller chooses, never a fallback that a failure trips.

Residency (``core/residency.py``): a record-backed bank's growth is
admitted against ``device-budget-bytes`` first (``admit_device_alloc``
demotes colder clean records off the owner's device and raises
``VectorBudgetError`` only when not enough could be demoted), every plane
read or write funnels through ``RecordRowBank._rec``, which faults a
demoted bank back in, and ``bank_has_pending`` pins a bank with pending
rows HOT.  A failed bank allocation on the card (``torch.OutOfMemoryError``
from the grown planes' ``torch.zeros``, or the chaos plane's injected
``device_oom``) raises ``DeviceOomError``, the reference's ``-OOM`` reply,
with the pending rows kept.
"""
from __future__ import annotations

import os
import threading
import weakref
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core import residency as _res
from redisson_tpu_torch.core.store import StateRecord
from redisson_tpu_torch.net import client as _net
from redisson_tpu_torch.net.resp import RespError

# -- global switch (the A/B discipline of ioplane.set_overlap) ----------------

_vector = os.environ.get("RTPU_NO_VECTOR", "") not in ("1", "true", "yes")


def vector_enabled() -> bool:
    return _vector


def set_vector(on: bool) -> bool:
    """Flip the process-global device-KNN switch; returns the previous value
    (callers restore it)."""
    global _vector
    prev = _vector
    _vector = bool(on)
    return prev


VECTOR_METRICS = ("L2", "COSINE", "IP")
VECTOR_DTYPES = ("FLOAT32", "FLOAT16", "INT8")
VECTOR_ALGOS = ("FLAT", "IVF")
DEFAULT_BLOCK = 256  # rows buffered per upload (the O(N/block) contract)
DEFAULT_NPROBE = 8
RETRAIN_GROWTH = 1.5   # retrain once the corpus grew this much past the
                       # last training set
KMEANS_ITERS = 6

# -- live tuning knobs (read at use time) -------------------------------------

IVF_CELL_IMBALANCE = float(os.environ.get("RTPU_IVF_CELL_IMBALANCE", "3"))
# cell_cap bound = IVF_CELL_IMBALANCE x mean occupancy; rows past it spill
# to their next-nearest cell (_rebuild_cells)

IVF_CELL_CAP_MAX = int(os.environ.get("RTPU_IVF_CELL_CAP_MAX", "0"))
# hard ceiling on cell_cap (the per-query gather is nprobe x cell_cap);
# 0 = unbounded

DEVICE_BYTES_BUDGET = int(os.environ.get("RTPU_FTVEC_DEVICE_BUDGET", "0"))
# per-bank device bytes budget (0 = unlimited): a bank that would grow past
# it raises VectorBudgetError at flush


def set_ivf_cell_imbalance(value: float) -> float:
    """Set the cell_cap imbalance bound; returns the previous value."""
    global IVF_CELL_IMBALANCE
    prev, IVF_CELL_IMBALANCE = IVF_CELL_IMBALANCE, max(1.0, float(value))
    return prev


def set_ivf_cell_cap_max(value: int) -> int:
    """Set the gather-width ceiling (0 = unbounded); returns the previous."""
    global IVF_CELL_CAP_MAX
    prev, IVF_CELL_CAP_MAX = IVF_CELL_CAP_MAX, max(0, int(value))
    return prev


def set_device_bytes_budget(value: int) -> int:
    """Set the per-bank device-bytes budget (0 = unlimited); returns prev."""
    global DEVICE_BYTES_BUDGET
    prev, DEVICE_BYTES_BUDGET = DEVICE_BYTES_BUDGET, max(0, int(value))
    return prev


class VectorBudgetError(RuntimeError):
    """A bank flush would grow the bank past DEVICE_BYTES_BUDGET."""


class DeviceOomError(RespError):
    """A device allocation failed (``torch.OutOfMemoryError``, real or
    injected by the chaos plane's ``device_oom``) growing a bank: the
    clean, retryable ``-OOM`` reply, counted on the owner lane's fault
    ledger as ``alloc_oom``.  The fixed text keeps the reply the
    reference's.  The rows that triggered the growth stay pending, so
    nothing acked is lost."""

    def __init__(self, name: str):
        super().__init__(
            f"OOM device out of memory growing vector bank '{name}'; "
            f"rows kept pending"
        )


_IVF_SENTINEL = np.int32(0x3FFFFFFF)  # padded cells entry: never a live row


@dataclass
class VectorFieldSpec:
    """One FT VECTOR schema attribute.

    ``algo``   — FLAT (exact) or IVF (sub-linear, recall-gated).
    ``dtype``  — FLOAT32, FLOAT16 or INT8 (symmetric per-row scale).
    ``nlist``  — IVF coarse-cell count (required for IVF).
    ``nprobe`` — default cells probed per query; 0 resolves to min(nlist, 8).
    ``train_min`` — row count at which the coarse quantizer first trains;
                 0 resolves to max(4 * nlist, 256).  Below it IVF scores
                 FLAT (exact).
    ``shards`` — row-parallel shards (``ShardedEmbeddingBank`` past 1)."""

    field: str
    dim: int
    metric: str = "COSINE"
    dtype: str = "FLOAT32"
    algo: str = "FLAT"
    nlist: int = 0
    nprobe: int = 0
    train_min: int = 0
    shards: int = 1

    def __post_init__(self):
        self.metric = str(self.metric).upper()
        self.algo = str(self.algo).upper()
        self.dtype = str(self.dtype).upper()
        self.dim = int(self.dim)
        self.nlist = int(self.nlist)
        self.nprobe = int(self.nprobe)
        self.train_min = int(self.train_min)
        self.shards = int(self.shards)
        if self.shards < 1:
            raise ValueError("SHARDS must be a positive shard count")
        if self.dim <= 0:
            raise ValueError("vector DIM must be positive")
        if self.metric not in VECTOR_METRICS:
            raise ValueError(f"unsupported DISTANCE_METRIC '{self.metric}'")
        if self.algo not in VECTOR_ALGOS:
            raise ValueError(f"unsupported vector algorithm '{self.algo}'")
        if self.dtype not in VECTOR_DTYPES:
            raise ValueError(f"unsupported vector TYPE '{self.dtype}'")
        if self.algo == "IVF":
            if self.nlist < 2:
                raise ValueError("IVF needs NLIST >= 2")
            if self.nprobe <= 0:
                self.nprobe = min(self.nlist, DEFAULT_NPROBE)
            self.nprobe = min(self.nprobe, self.nlist)
            if self.train_min <= 0:
                self.train_min = max(4 * self.nlist, 256)
        elif self.nlist or self.nprobe or self.train_min:
            raise ValueError("NLIST/NPROBE/TRAIN_MIN are IVF attributes")

    def to_meta(self) -> Dict[str, Any]:
        return {
            "field": self.field, "dim": self.dim, "metric": self.metric,
            "dtype": self.dtype, "algo": self.algo, "nlist": self.nlist,
            "nprobe": self.nprobe, "train_min": self.train_min,
            "shards": self.shards,
        }


def parse_vector_value(value, dim: int) -> Optional[np.ndarray]:
    """Decode one document's vector field into a (dim,) float32 row: raw
    little-endian float32 bytes (the RediSearch HSET blob), or a sequence of
    floats / a numpy array.  None for an absent value; ValueError on a
    dimension mismatch."""
    if value is None:
        return None
    if isinstance(value, (bytes, bytearray, memoryview)):
        buf = bytes(value)
        if len(buf) != dim * 4:
            raise ValueError(
                f"vector blob is {len(buf)} bytes; DIM {dim} needs {dim * 4}"
            )
        return np.frombuffer(buf, dtype="<f4").astype(np.float32, copy=True)
    arr = np.asarray(value, dtype=np.float32).reshape(-1)
    if arr.shape[0] != dim:
        raise ValueError(f"vector has {arr.shape[0]} dims; schema says {dim}")
    return np.ascontiguousarray(arr)


def bank_record_name(index: str, field: str) -> str:
    """DeviceStore name of one index-field embedding bank (the ``{index}``
    hashtag maps it to the index's keyspace slot)."""
    return "__ftvec__{%s}:%s" % (index, field)


def shard_record_name(index: str, field: str, shard: int, salt: int) -> str:
    """DeviceStore name of ONE shard of a sharded bank (a stored name, the
    reference's).  The hashtag embeds the shard id and a salt, so each shard
    record owns its own slot: placement gives it that slot's position and
    DEVMOVE moves it like any record."""
    return "__ftvec__{%s#s%d.%d}:%s" % (index, shard, salt, field)


def pick_shard_record_names(engine, index: str, field: str,
                            n: int) -> List[str]:
    """Shard record names whose slots land on distinct positions: shard i
    targets position (owner(base) + i) % positions (``device_span``), and
    the salt is searched until the name's slot maps there (deterministic
    given the placement table).  Placement off: salt 0."""
    p = getattr(engine, "placement", None)
    if p is None:
        return [shard_record_name(index, field, i, 0) for i in range(n)]
    span = p.device_span(p.device_id_for_name(bank_record_name(index, field)), n)
    names = []
    for i, want in enumerate(span):
        for salt in range(512):
            nm = shard_record_name(index, field, i, salt)
            if p.device_id_for_name(nm) == want:
                names.append(nm)
                break
        else:  # 512 probes over 16384 slots always hit
            names.append(shard_record_name(index, field, i, 0))
    return names


def _query_bucket(n: int) -> int:
    """Small pow2 bucket for stacked query counts."""
    b = 1
    while b < n:
        b <<= 1
    return b


# -- bank compression (FP16 / INT8 with symmetric per-row scale) --------------


def phys_width(dim: int, dtype: str) -> int:
    """Physical bank width: the logical dim rounded up so rows pack whole
    uint32 words in the upload (2 f16 / 4 int8 lanes a word).  Padding lanes
    hold zeros, exact no-ops in every dot product and norm."""
    if dtype == "FLOAT16":
        return dim + (dim & 1)
    if dtype == "INT8":
        return (dim + 3) & ~3
    return dim


def quantize_row(row: np.ndarray, dtype: str, pwidth: int):
    """(stored row at physical width, scale f32, dequantized logical f32).
    The kernels widen the stored lanes and the host mirror records exactly
    those widened values, so both paths score the same numbers."""
    dim = row.shape[0]
    if dtype == "FLOAT16":
        stored = np.zeros(pwidth, np.float16)
        stored[:dim] = row.astype(np.float16)
        return stored, np.float32(1.0), stored[:dim].astype(np.float32)
    if dtype == "INT8":
        amax = float(np.max(np.abs(row))) if dim else 0.0
        if not np.isfinite(amax) or amax == 0.0:
            scale = np.float32(1.0)
        else:
            scale = np.float32(amax / 127.0)
        stored = np.zeros(pwidth, np.int8)
        with np.errstate(invalid="ignore"):
            q = np.clip(np.rint(row / scale), -127, 127)
        stored[:dim] = np.nan_to_num(q).astype(np.int8)
        return stored, scale, stored[:dim].astype(np.float32) * scale
    stored = np.zeros(pwidth, np.float32)
    stored[:dim] = row
    return stored, np.float32(1.0), stored[:dim].copy()


_NP_DTYPES = {"FLOAT32": np.float32, "FLOAT16": np.float16, "INT8": np.int8}
_TORCH_DTYPES = {"FLOAT32": torch.float32, "FLOAT16": torch.float16, "INT8": torch.int8}


def _pair_score_math(rows: np.ndarray, qs: np.ndarray,
                     metric: str) -> np.ndarray:
    """The per-pair score of every reply: (M, d) rows against (M, d)
    queries -> (M,) f32 scores, the same NumPy reductions whichever path
    chose the rows."""
    dots = np.einsum("md,md->m", rows, qs, dtype=np.float32)
    if metric == "L2":
        q_sq = np.einsum("md,md->m", qs, qs, dtype=np.float32)
        r_sq = np.einsum("md,md->m", rows, rows, dtype=np.float32)
        return (q_sq - 2.0 * dots + r_sq).astype(np.float32)
    if metric == "COSINE":
        qn = np.sqrt(np.einsum("md,md->m", qs, qs, dtype=np.float32))
        rn = np.sqrt(np.einsum("md,md->m", rows, rows, dtype=np.float32))
        denom = qn * rn
        with np.errstate(invalid="ignore", divide="ignore"):
            cos = np.where(denom > 0.0, dots / denom, 0.0)
        return (1.0 - cos).astype(np.float32)
    return (1.0 - dots).astype(np.float32)  # IP


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class DeviceRowBank:
    """Block-appended device row bank (f32 / f16 / int8 + scale), the
    substrate of the embedding banks and of the search service's numeric
    plane: rows are addressed by the index's doc rowid, mutations buffer in
    ``_pending`` and flush as ONE packed upload and one scatter
    (kernels.rowbank_write_packed*).  The host mirror (always f32 at the
    logical width, dequantized) feeds the NumPy path, the oracle and index
    rebuilds.

    This base class holds its planes itself, on `device` (the numeric
    plane's binding); ``RecordRowBank`` keeps them in a store record."""

    def __init__(self, width: int, block: int = DEFAULT_BLOCK,
                 dtype: str = "FLOAT32", device="cpu"):
        self.width = int(width)          # logical dim
        self.dtype = str(dtype).upper()
        if self.dtype not in VECTOR_DTYPES:
            raise ValueError(f"unsupported bank dtype '{dtype}'")
        self.pwidth = phys_width(self.width, self.dtype)
        self.block = max(1, int(block))
        self.device = torch.device(device)
        self.rows = 0            # logical row count (max rowid + 1)
        self._cap = 0            # device capacity (rows)
        # rowid -> (bias, stored row at pwidth | None, scale)
        self._pending: Dict[int, Tuple[float, Optional[np.ndarray],
                                       np.float32]] = {}
        self._lock = threading.RLock()
        self._host = np.zeros((0, self.width), np.float32)
        self._host_bias = np.zeros((0,), np.float32)
        self.h2d_flushes = 0     # packed uploads (ONE per flush)
        self.grows = 0           # device-side capacity copies

    # -- packed upload geometry ----------------------------------------------

    def _packed_cols(self) -> int:
        if self.dtype == "FLOAT16":
            return 2 + self.pwidth // 2
        if self.dtype == "INT8":
            return 3 + self.pwidth // 4
        return 2 + self.pwidth

    # -- plane seam (overridden by RecordRowBank) -----------------------------

    def _get_planes(self):
        return (
            getattr(self, "_bank", None),
            getattr(self, "_bias", None),
            getattr(self, "_scale", None),
        )

    def _set_planes(self, bank, bias, scale) -> None:
        self._bank, self._bias, self._scale = bank, bias, scale

    def _staging_pool(self):
        return None

    def _record_guard(self):
        """Mutual exclusion for device-plane mutation (the record lock for
        the store-backed binding; the bank's own lock covers this one)."""
        return nullcontext()

    # -- host-side mutation ---------------------------------------------------

    def _mirror(self, rowid: int, bias: float, row: Optional[np.ndarray]) -> None:
        if rowid >= self._host.shape[0]:
            new_cap = max(self.block, self._host.shape[0] * 2)
            while new_cap <= rowid:
                new_cap *= 2
            grown = np.zeros((new_cap, self.width), np.float32)
            grown[: self._host.shape[0]] = self._host
            self._host = grown
            gbias = np.zeros((new_cap,), np.float32)
            gbias[: self._host_bias.shape[0]] = self._host_bias
            self._host_bias = gbias
        self._host[rowid] = 0.0 if row is None else row
        self._host_bias[rowid] = bias

    def _note_row_change(self, rowid: int) -> None:
        """Hook for derived index maintenance (EmbeddingBank's IVF plane);
        called under the bank lock on every set_row."""

    def set_row(self, rowid: int, row: Optional[np.ndarray]) -> None:
        """Install/overwrite one row.  ``row=None`` kills it: data to zeros
        and bias to +inf, so it can never reach a top-k (callers that want
        NaN semantics, like the numeric plane's cleared rows, pass a
        NaN-filled row)."""
        if row is None:
            bias = np.float32(np.inf)
            stored, scale, deq = None, np.float32(1.0), None
        else:
            bias = np.float32(0.0)
            stored, scale, deq = quantize_row(
                np.asarray(row, np.float32), self.dtype, self.pwidth
            )
        with self._lock:
            self._mirror(rowid, float(bias), deq)
            self.rows = max(self.rows, rowid + 1)
            self._pending[rowid] = (float(bias), stored, scale)
            self._note_row_change(rowid)
            if vector_enabled() and len(self._pending) >= self.block:
                self.flush_pending()

    # -- device flush ---------------------------------------------------------

    BUDGETED = False  # RecordRowBank opts in: only the embedding banks
                      # charge the budget, never the numeric plane

    def _projected_device_bytes(self, cap: int) -> int:
        """Device bytes a `cap`-row bank holds: stored rows + bias plane
        (+ INT8 scale column)."""
        per_row = self.pwidth * np.dtype(_NP_DTYPES[self.dtype]).itemsize + 4
        if self.dtype == "INT8":
            per_row += 4
        return cap * per_row

    def _ensure_capacity_locked(self, needed: int) -> None:
        if needed <= self._cap:
            return
        new_cap = max(self.block, self._cap)
        while new_cap < needed:
            new_cap *= 2
        budget = DEVICE_BYTES_BUDGET
        if budget and self.BUDGETED:
            projected = self._projected_device_bytes(new_cap)
            if projected > budget:
                raise VectorBudgetError(
                    f"bank '{getattr(self, 'name', '?')}' would hold "
                    f"{projected} device bytes at capacity {new_cap} — over "
                    f"the {budget}-byte per-device budget; shard the index "
                    f"(SHARDS n) or compress its TYPE"
                )
        if self.BUDGETED:
            # residency admission: growth that would push the owner's
            # device past device-budget-bytes first demotes that device's
            # colder clean records; VectorBudgetError is the LAST resort
            # (raised in admit_device_alloc when not enough was demotable)
            eng = getattr(self, "_engine", None)
            mgr = getattr(eng, "residency", None) if eng is not None else None
            if mgr is not None and _res.tier_enabled():
                delta = (self._projected_device_bytes(new_cap)
                         - self._projected_device_bytes(self._cap))
                pos = self._owner_position()
                mgr.admit_device_alloc(
                    self.device if pos is None else pos, delta,
                    exclude=(getattr(self, "name", ""),),
                )
        dev = self.device
        dev_id = self._fault_position_id()
        # device allocation chokepoint: the injected and the real CUDA OOM
        # converge on one DeviceOomError (_oom); no cache flush and retry,
        # no fall back to the host
        plane = _net._fault_plane
        if plane is not None:
            try:
                plane.on_device_alloc(dev_id, self._projected_device_bytes(new_cap))
            except RuntimeError as e:
                if ioplane.is_out_of_memory(e):
                    self._oom(dev_id, e)
                raise
        try:
            grown = torch.zeros((new_cap, self.pwidth), dtype=_TORCH_DTYPES[self.dtype], device=dev)
            gbias = torch.zeros((new_cap,), dtype=torch.float32, device=dev)
            gscale = (torch.ones((new_cap,), dtype=torch.float32, device=dev)
                      if self.dtype == "INT8" else None)
            bank, bias, scale = self._get_planes()
            if bank is not None and self._cap > 0:
                grown, gbias = K.rowbank_grow(bank, bias, grown, gbias)
                if gscale is not None and scale is not None:
                    gscale = K.rowbank_grow_plane(scale, gscale)
                self.grows += 1
        except RuntimeError as e:
            if ioplane.is_out_of_memory(e):
                self._oom(dev_id, e)
            raise
        self._set_planes(grown, gbias, gscale)
        self._cap = new_cap

    def _fault_position_id(self) -> int:
        """The position a device fault of this bank counts on (0 for a
        bank outside placement, as the reference's device 0)."""
        return 0

    def _oom(self, dev_id: int, cause: BaseException) -> None:
        """The card's memory ran out growing this bank: count the fault on
        the lane's quarantine ledger and raise the one fixed ``-OOM`` reply
        (never the raw error, never a dead connection)."""
        ioplane.note_device_fault(dev_id, "alloc_oom")
        raise DeviceOomError(getattr(self, "name", "?")) from cause

    def _pack_items(self, buf: np.ndarray, items) -> None:
        """Fill the packed upload: col 0 rowid, col 1 bias bits, [col 2
        scale bits for INT8,] the rest the row lanes bitcast."""
        n = len(items)
        buf[:n, 0] = np.fromiter((r for r, _v in items), np.uint32, count=n)
        buf[:n, 1] = np.fromiter(
            (b for _r, (b, _row, _s) in items), np.float32, count=n
        ).view(np.uint32)
        rows = np.zeros((n, self.pwidth), _NP_DTYPES[self.dtype])
        for i, (_r, (_b, row, _s)) in enumerate(items):
            if row is not None:
                rows[i] = row
        if self.dtype == "INT8":
            buf[:n, 2] = np.fromiter(
                (s for _r, (_b, _row, s) in items), np.float32, count=n
            ).view(np.uint32)
            buf[:n, 3:] = rows.view(np.uint32)
        else:
            buf[:n, 2:] = rows.view(np.uint32)

    def flush_pending(self) -> int:
        """Drain the pending rows to the device: ONE packed upload + ONE
        scatter however many rows accumulated.  Returns the rows flushed."""
        with self._lock:
            if not self._pending:
                return 0
            pending, self._pending = self._pending, {}
            try:
                with self._record_guard():
                    self._ensure_capacity_locked(self.rows)
            except (VectorBudgetError, DeviceOomError):
                # the rows stay PENDING (their mirror values are installed),
                # so a later flush drains them
                self._pending = pending
                raise
            with self._record_guard():
                n = len(pending)
                p = K.bucket_size(n, minimum=min(self.block, 256))
                shape = (p, self._packed_cols())
                pool = self._staging_pool()
                if pool is None:
                    buf, slot = np.zeros(shape, np.uint32), None
                else:
                    buf, slot = pool.acquire(shape, np.uint32)
                try:
                    self._pack_items(buf, sorted(pending.items()))
                    staged = K.stage(buf, self.device, non_blocking=pool is not None)
                except BaseException:
                    if pool is not None:
                        pool.release(slot)
                    raise
                if pool is not None:
                    pool.commit(slot, ioplane.record_event(self.device))
                bank, bias, scale = self._get_planes()
                if self.dtype == "INT8":
                    bank, scale, bias = K.rowbank_write_packed_i8(bank, scale, bias, staged, n)
                elif self.dtype == "FLOAT16":
                    bank, bias = K.rowbank_write_packed_f16(bank, bias, staged, n)
                else:
                    bank, bias = K.rowbank_write_packed(bank, bias, staged, n)
                self._set_planes(bank, bias, scale)
                self.h2d_flushes += 1
            return n

    def device_planes(self) -> Tuple[Any, Any, Any, int]:
        """(bank, bias, scale, rows) with every pending row flushed (scale
        is None except for INT8 banks; bank is None before the first
        flush)."""
        with self._lock:
            self.flush_pending()
            bank, bias, scale = self._get_planes()
            return bank, bias, scale, self.rows

    def host_planes(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows x width data, bias) host mirror (dequantized f32)."""
        with self._lock:
            return (
                self._host[: self.rows].copy(),
                self._host_bias[: self.rows].copy(),
            )

    def device_bytes(self) -> int:
        return sum(int(a.nbytes) for a in self._get_planes() if a is not None)

    def logical_f32_bytes(self) -> int:
        """What the same rows would cost uncompressed (the denominator of
        the compression ratio)."""
        return int(self._cap) * (self.width + 1) * 4

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)


# live record-backed banks by (store identity, record name): the residency
# demoter's dirty probe reads this to pin banks with PENDING rows HOT
# (demoting mid-accumulation would turn the next flush into a promotion
# and a flush).  Weak values: a dropped index's bank leaves by dying.
_LIVE_BANKS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def bank_has_pending(store, name: str) -> bool:
    """Lock-free dirty probe for the residency plane (len() of a dict is
    atomic under the GIL; advisory: a racing flush re-touches the record
    and the touch clock pins it anyway)."""
    bank = _LIVE_BANKS.get((id(store), name))
    return bank is not None and len(getattr(bank, "_pending", ())) > 0


class RecordRowBank(DeviceRowBank):
    """DeviceRowBank whose planes live in a DeviceStore StateRecord on the
    engine's device; deleting the record (FT.DROPINDEX) releases them."""

    KIND = "vector_bank"
    BUDGETED = True

    def __init__(self, engine, name: str, width: int,
                 block: int = DEFAULT_BLOCK, dtype: str = "FLOAT32",
                 meta: Optional[dict] = None, reset: bool = True):
        super().__init__(width, block, dtype=dtype, device=engine.device)
        self._engine = engine
        self.name = name
        with engine.locked(name):
            if reset:
                # index definitions are host-side, so a stale bank record of
                # a dropped or rebuilt index must not leak rows into this one
                engine.store.delete_unguarded(name)
            rec = engine.store.get_unguarded(name)
            if rec is None:
                engine.store.put_unguarded(
                    name,
                    StateRecord(
                        kind=self.KIND,
                        meta=dict(meta or {}, rows=0, width=width,
                                  block=self.block, dtype=self.dtype),
                        arrays={},
                    ),
                )
        _LIVE_BANKS[(id(engine.store), name)] = self

    def _rec(self):
        rec = self._engine.store.get_unguarded(self.name)
        if rec is None:
            raise KeyError(f"vector bank '{self.name}' was dropped")
        # residency fault-in: every bank plane read or write funnels
        # through here, so a demoted bank promotes before any caller can
        # see its released planes.  The store getters' one-load guard.
        plane = _res._tier_plane
        if plane is not None and rec.tier is not _res.HOT:
            plane.on_record_access(self._engine.store, self.name, rec)
        return rec

    def _get_planes(self):
        arrays = self._rec().arrays
        return arrays.get("bank"), arrays.get("bias"), arrays.get("scale")

    def _set_planes(self, bank, bias, scale) -> None:
        rec = self._rec()
        planes = {"bank": bank, "bias": bias}
        if scale is not None:
            planes["scale"] = scale
        # the index's centroids and cells may be views of the buffer a
        # promotion cut these planes from
        _res.replace_planes(rec, planes)
        rec.meta["rows"] = self.rows
        rec.version += 1

    def _owner_position(self):
        """The position that owns the bank's record (placement on), else
        None."""
        p = self._engine.placement
        if p is None:
            return None
        rec = self._engine.store.get_unguarded(self.name)
        pos = rec.position if rec is not None else None
        if pos is None:
            pos = p.device_id_for_name(self.name)
        return p.devices[pos]

    def _staging_pool(self):
        return self._engine.staging_pool(self._owner_position())

    def _fault_position_id(self) -> int:
        pos = self._owner_position()
        return 0 if pos is None else pos.id

    def _record_guard(self):
        return self._engine.locked(self.name)

    def drop(self) -> None:
        with self._lock:
            self._pending.clear()
            self._engine.store.delete_unguarded(self.name)

    def sync_external(self) -> None:
        """Adopt record state installed behind this object's back: the row
        count from rec.meta, the host mirror dequantized from the device
        planes (one copy to the host), pending rows dropped (the record is
        the newer truth), and any IVF plane reset so the next query
        retrains over the adopted rows."""
        with self._lock:
            rec = self._engine.store.get_unguarded(self.name)
            if rec is None:
                return
            bank, bias, scale = self._get_planes()
            rows = int(rec.meta.get("rows", 0))
            self._pending.clear()
            self.rows = rows
            self._cap = 0 if bank is None else int(bank.shape[0])
            if bank is None or rows <= 0:
                self._host = np.zeros((0, self.width), np.float32)
                self._host_bias = np.zeros((0,), np.float32)
            else:
                stored = _host(bank)[:rows]
                if self.dtype == "INT8" and scale is not None:
                    sc = _host(scale)[:rows].astype(np.float32)
                    deq = stored.astype(np.float32) * sc[:, None]
                else:
                    deq = stored.astype(np.float32)
                self._host = np.ascontiguousarray(deq[:, : self.width])
                self._host_bias = (
                    _host(bias)[:rows].astype(np.float32)
                    if bias is not None else np.zeros((rows,), np.float32)
                )
            ivf = getattr(self, "_ivf", None)
            if ivf is not None:
                self._ivf = type(ivf)(self.spec)


def sync_banks_from_records(engine, names) -> int:
    """Resync every record-backed bank of the engine's search service whose
    record name is in `names` (records replaced behind the banks' backs,
    e.g. by a replication full-ship).  Returns the banks resynced."""
    svc = getattr(engine, "_services", {}).get("search")
    if svc is None or not names:
        return 0
    wanted = set(names)
    synced = 0
    for idx in list(getattr(svc, "_indexes", {}).values()):
        vectors = getattr(idx, "vectors", None)
        if not vectors:
            continue
        for bank in vectors.banks.values():
            if isinstance(bank, RecordRowBank) and bank.name in wanted:
                bank.sync_external()
                synced += 1
    return synced


class _IvfPlane:
    """Host-canonical IVF coarse index of one embedding bank: centroids,
    per-row cell assignments and the padded per-cell row lists.  Both
    scoring paths read this one state, whichever trained it; the device
    copies (``centroids`` / ``cells`` in the bank's record) are derived and
    re-uploaded when stale."""

    def __init__(self, spec: "VectorFieldSpec"):
        self.spec = spec
        self.centroids: Optional[np.ndarray] = None  # (nlist, dim) f32
        self.assign = np.full(0, -1, np.int32)       # rowid -> cell | -1
        self.cells: Optional[np.ndarray] = None      # (nlist, cap) i32
        self.cell_cap = 0
        self.trained_rows = 0
        self.trains = 0
        self.dirty_rows: set = set()
        self.cells_stale = False
        self.training = False    # a snapshot-train is in flight (off-lock)
        self.stamp = 0           # host index version
        self.uploaded_stamp = -1  # device copy version
        self.index_uploads = 0


class EmbeddingBank(RecordRowBank):
    """One index-field embedding bank and its KNN dispatch.  ``record_name``
    overrides the bank's record name: ``ShardedEmbeddingBank`` makes one
    EmbeddingBank a shard, under the shard's salted name."""

    def __init__(self, engine, index: str, spec: VectorFieldSpec,
                 block: int = DEFAULT_BLOCK, reset: bool = True,
                 record_name: Optional[str] = None):
        self.spec = spec
        self._ivf = _IvfPlane(spec) if spec.algo == "IVF" else None
        super().__init__(
            engine, record_name or bank_record_name(index, spec.field),
            spec.dim, block=block, dtype=spec.dtype,
            meta=dict(spec.to_meta(), index=index), reset=reset,
        )

    # -- IVF host-canonical index maintenance ---------------------------------

    def _note_row_change(self, rowid: int) -> None:
        if self._ivf is not None:
            self._ivf.dirty_rows.add(rowid)

    def _centroid_l2(self, rows: np.ndarray) -> np.ndarray:
        """L2 assignment of rows (M, dim) to the canonical centroids (ties
        to the lower cell, as kmeans_step)."""
        c = self._ivf.centroids
        d = (
            np.sum(rows * rows, axis=1, dtype=np.float32)[:, None]
            - 2.0 * (rows @ c.T)
            + np.sum(c * c, axis=1, dtype=np.float32)[None, :]
        )
        return np.argmin(d, axis=1).astype(np.int32)

    def _needs_train_locked(self) -> bool:
        ivf = self._ivf
        n = self.rows
        return n >= ivf.spec.train_min and (
            ivf.centroids is None
            or n >= int(RETRAIN_GROWTH * ivf.trained_rows)
        )

    def _train_snapshot_locked(self):
        """(n, pts copy, weights, pre-snapshot dirty set) or None when too
        few live rows to seat nlist centroids."""
        ivf = self._ivf
        n = self.rows
        live = np.isfinite(self._host_bias[:n])
        if int(np.count_nonzero(live)) < ivf.spec.nlist:
            return None
        return (
            n,
            self._host[:n].copy(),
            live.astype(np.float32),
            frozenset(ivf.dirty_rows),
        )

    def _train_compute(self, n: int, pts: np.ndarray, w: np.ndarray):
        """The training computation, run without the bank lock:
        kmeans_step iterations on the engine's device (the kmeans kernel on
        the card) when the device path is on, the same NumPy formula when it
        is off.  Either way the result (centroids + assignments) is host
        data the caller installs as the canonical index."""
        nlist = self._ivf.spec.nlist
        live = w > 0.0
        # deterministic seeded init from live rows, on the host, so the same
        # init feeds whichever iteration path runs
        rng = np.random.default_rng(0x1DF5EED ^ n)
        init = rng.choice(np.nonzero(live)[0], nlist, replace=False)
        cent = pts[np.sort(init)].astype(np.float32, copy=True)
        if vector_enabled():
            dev = self.device
            dp, dw, dc = (K.stage(a, dev) for a in (pts, w, cent))
            assign = None
            for _ in range(KMEANS_ITERS):
                dc, assign = K.kmeans_step(dp, dw, dc)
            cent = _host(dc)
            assign = _host(assign)
        else:
            assign = None
            for _ in range(KMEANS_ITERS):
                d = (
                    np.sum(pts * pts, axis=1, dtype=np.float32)[:, None]
                    - 2.0 * (pts @ cent.T)
                    + np.sum(cent * cent, axis=1, dtype=np.float32)[None, :]
                )
                assign = np.argmin(d, axis=1).astype(np.int32)
                sums = np.zeros_like(cent)
                np.add.at(sums, assign, pts * w[:, None])
                counts = np.zeros(cent.shape[0], np.float32)
                np.add.at(counts, assign, w)
                cent = np.where(
                    counts[:, None] > 0.0,
                    sums / np.maximum(counts, 1.0)[:, None],
                    cent,
                )
        return cent, np.where(live, assign, -1).astype(np.int32)

    def _train_now(self) -> None:
        """One training run: snapshot under the lock, iterate outside it
        (so queries and ingest on the field are not stalled), install the
        result under the lock.  Queries during the run score on the previous
        index (or FLAT while untrained)."""
        ivf = self._ivf
        with self._lock:
            if ivf.training:
                return
            snap = self._train_snapshot_locked()
            if snap is None:
                return
            ivf.training = True
        try:
            n, pts, w, pre_dirty = snap
            cent, assign = self._train_compute(n, pts, w)
        finally:
            with self._lock:
                ivf.training = False
        with self._lock:
            ivf.centroids = cent
            if ivf.assign.shape[0] < max(n, self.rows):
                grown = np.full(
                    max(self.rows, n, 2 * max(1, ivf.assign.shape[0])),
                    -1, np.int32,
                )
                grown[: ivf.assign.shape[0]] = ivf.assign
                ivf.assign = grown
            ivf.assign[:n] = assign
            ivf.trained_rows = n
            ivf.trains += 1
            # rows dirty at the snapshot are covered by this training; rows
            # dirtied during it keep their mark
            ivf.dirty_rows -= pre_dirty
            ivf.cells_stale = True

    def _maybe_train(self) -> None:
        """Train/retrain gate, called by both scoring paths before they take
        the bank lock for dispatch."""
        if self._ivf is None:
            return
        with self._lock:
            if not self._needs_train_locked() or self._ivf.training:
                return
        self._train_now()

    def _rebuild_cells(self) -> None:
        """Repack the per-cell row lists into the uniform-stride table
        ((nlist, cell_cap) int32, sentinel-padded, rowids ascending within a
        cell: the tie order both paths share).  cell_cap is bounded at
        IVF_CELL_IMBALANCE x the mean occupancy (and IVF_CELL_CAP_MAX); an
        overfull cell keeps its centroid-closest rows and spills the rest
        to their next-nearest cell with room."""
        ivf = self._ivf
        n = self.rows
        a = ivf.assign[:n].copy()
        live_rows = np.nonzero(a >= 0)[0]
        n_live = live_rows.shape[0]
        counts = np.bincount(a[live_rows], minlength=ivf.spec.nlist)
        avg = max(1, -(-n_live // ivf.spec.nlist))  # ceil
        imb = max(1.0, float(IVF_CELL_IMBALANCE))
        cap = K.bucket_size(max(4, int(round(imb * avg))), minimum=4)
        if IVF_CELL_CAP_MAX:
            cap = min(cap, max(4, int(IVF_CELL_CAP_MAX)))
        cent = ivf.centroids
        overfull = np.nonzero(counts > cap)[0]
        for c in overfull:
            members = live_rows[a[live_rows] == c]
            rows = self._host[members]
            d_own = np.sum((rows - cent[c][None, :]) ** 2, axis=1)
            order = np.argsort(d_own, kind="stable")
            spill = members[order[cap:]]
            # next-nearest cells with room, nearest first (stable)
            srows = self._host[spill]
            d_all = (
                np.sum(srows * srows, axis=1, dtype=np.float32)[:, None]
                - 2.0 * (srows @ cent.T)
                + np.sum(cent * cent, axis=1, dtype=np.float32)[None, :]
            )
            pref = np.argsort(d_all, axis=1, kind="stable")
            for i, rowid in enumerate(spill):
                placed = False
                for cc in pref[i]:
                    if cc != c and counts[cc] < cap:
                        a[rowid] = cc
                        counts[cc] += 1
                        placed = True
                        break
                if not placed:  # pragma: no cover — nlist*cap >= 2*n_live
                    a[rowid] = int(np.argmin(counts))
                    counts[a[rowid]] += 1
            counts[c] = cap
        cells = np.full((ivf.spec.nlist, cap), _IVF_SENTINEL, np.int32)
        # vectorized repack: sort live rows by (cell, rowid), then each row's
        # slot is its rank within its cell's run
        if live_rows.size:
            order = np.lexsort((live_rows, a[live_rows]))
            srows = live_rows[order]
            scells = a[srows]
            starts = np.searchsorted(scells, np.arange(ivf.spec.nlist))
            rank = np.arange(srows.size) - starts[scells]
            keep = rank < cap  # post-balance this is all rows
            cells[scells[keep], rank[keep]] = srows[keep]
        ivf.assign[:n] = a
        ivf.cells = cells
        ivf.cell_cap = cap
        ivf.cells_stale = False
        ivf.stamp += 1

    def _ivf_sync(self) -> None:
        """Bring the canonical host index up to date with the mirror: assign
        rows ingested since the last sync and repack the cell lists.  Called
        under the bank lock from both scoring paths."""
        ivf = self._ivf
        n = self.rows
        if ivf.assign.shape[0] < n:
            grown = np.full(max(n, 2 * max(1, ivf.assign.shape[0])), -1,
                            np.int32)
            grown[: ivf.assign.shape[0]] = ivf.assign
            ivf.assign = grown
        if ivf.centroids is not None and ivf.dirty_rows:
            dirty = np.fromiter(
                (r for r in ivf.dirty_rows if r < n), np.int64
            )
            ivf.dirty_rows.clear()
            if dirty.size:
                live = np.isfinite(self._host_bias[dirty])
                cells = np.full(dirty.size, -1, np.int32)
                if np.any(live):
                    cells[live] = self._centroid_l2(self._host[dirty[live]])
                ivf.assign[dirty] = cells
                ivf.cells_stale = True
        if ivf.centroids is not None and (ivf.cells_stale or ivf.cells is None):
            self._rebuild_cells()

    def _ensure_index_device(self):
        """(device centroids (nlist, pwidth) f32, device cells), uploaded
        into the bank's record when the host index moved past the uploaded
        stamp, so the index lives and dies with the bank's record."""
        ivf = self._ivf
        with self._record_guard():
            rec = self._rec()
            if (
                ivf.uploaded_stamp == ivf.stamp
                and "centroids" in rec.arrays
                and "cells" in rec.arrays
            ):
                return rec.arrays["centroids"], rec.arrays["cells"]
            cent = ivf.centroids
            if self.pwidth != self.width:
                padded = np.zeros((cent.shape[0], self.pwidth), np.float32)
                padded[:, : self.width] = cent
                cent = padded
            dc = K.stage(np.ascontiguousarray(cent, np.float32), self.device)
            dl = K.stage(np.ascontiguousarray(ivf.cells), self.device)
            _res.replace_planes(rec, {"centroids": dc, "cells": dl})
            rec.version += 1
            ivf.uploaded_stamp = ivf.stamp
            ivf.index_uploads += 1
            return dc, dl

    def index_device_bytes(self) -> int:
        """Bytes the coarse index (centroids + cell table) holds on device."""
        try:
            arrays = self._rec().arrays
        except KeyError:
            return 0
        return sum(int(arrays[k].nbytes) for k in ("centroids", "cells") if k in arrays)

    def owner_device_id(self) -> int:
        """The owning position (placement on; the label of the per-device
        census rows), else the index of the device the planes sit on (0
        for the CPU)."""
        try:
            pos = self._owner_position()
        except KeyError:
            pos = None
        return pos.id if pos is not None else (self.device.index or 0)

    def device_bytes_by_device(self) -> Dict[int, int]:
        b = self.device_bytes()
        return {self.owner_device_id(): b} if b else {}

    def index_bytes_by_device(self) -> Dict[int, int]:
        b = self.index_device_bytes()
        return {self.owner_device_id(): b} if b else {}

    def ivf_ready(self) -> bool:
        return self._ivf is not None and self._ivf.centroids is not None

    def _resolve_nprobe(self, nprobe: Optional[int]) -> int:
        p = self.spec.nprobe if not nprobe else int(nprobe)
        return max(1, min(p, self.spec.nlist))

    def retrain(self) -> None:
        """Force a coarse-quantizer retrain now (tests / admin)."""
        if self._ivf is None:
            return
        self._train_now()
        with self._lock:
            if self._ivf.centroids is not None:
                self._rebuild_cells()

    # -- scoring --------------------------------------------------------------

    def _lane_gate(self, n_items: int):
        """Hold the owning position's serving lane for the dispatch: KNN
        occupancy is accounted a position as the sketch verbs' is (nothing
        without placement)."""
        lanes = self._engine.lanes
        pos = self._owner_position() if lanes is not None else None
        if pos is None:
            return nullcontext()
        return lanes.lane(pos).occupy(n_items)

    def _pad_queries(self, q: np.ndarray, qb: int) -> np.ndarray:
        """Stack to the query bucket and the physical bank width (zero lanes,
        exact no-ops in every metric)."""
        out = np.zeros((qb, self.pwidth), np.float32)
        out[: q.shape[0], : self.width] = q
        return out

    def knn_async(self, queries: np.ndarray, k: int,
                  allowed_rows: Optional[np.ndarray] = None,
                  nprobe: Optional[int] = None):
        """Dispatch one stacked KNN: queries (Q, dim) float32 against every
        live row (FLAT) or the routed top-nprobe cells (IVF).  Returns
        (dist, idx, q_count, k_eff) with dist and idx on the device, not yet
        read back (resolve_hits reads them), or None for an empty bank.

        ``allowed_rows`` (hybrid prefilter): int row ids that may score;
        every other row gets +inf through an additive bias operand."""
        q = np.ascontiguousarray(queries, np.float32).reshape(-1, self.width)
        nq = q.shape[0]
        self._maybe_train()  # off-lock; queries meanwhile score the old index
        with self._lock:
            bank, bias, scale, rows = self.device_planes()
            if bank is None or rows == 0:
                return None
            if self._ivf is not None:
                self._ivf_sync()
            staged = K.stage(self._pad_queries(q, _query_bucket(nq)), self.device)
            cand = self._ivf.cell_cap * self._resolve_nprobe(nprobe) if self.ivf_ready() else rows
            with self._lane_gate(nq * max(1, min(rows, cand))):
                dist, idx, k_eff = self.dispatch((bank, bias, scale, rows), staged, k, nprobe, allowed_rows)
        return dist, idx, nq, k_eff

    def dispatch(self, planes, staged, k: int, nprobe: Optional[int] = None,
                 allowed_rows: Optional[np.ndarray] = None):
        """The device program of one staged query batch (Qb, pwidth) over
        the planes (bank, bias, scale, rows) of device_planes(): FLAT, or
        IVF once trained.  Returns (dist, idx, k_eff).  Called under the
        bank lock, after _ivf_sync."""
        bank, bias, scale, rows = planes
        dev, metric = self.device, self.spec.metric
        if self.ivf_ready():
            np_eff = self._resolve_nprobe(nprobe)
            dc, dl = self._ensure_index_device()
            k_eff = max(1, min(int(k), np_eff * self._ivf.cell_cap))
            mask = None
            if allowed_rows is not None:
                m = np.full(self._cap, np.inf, np.float32)
                m[np.asarray(allowed_rows, np.int64)] = 0.0
                mask = K.stage(m, dev)
            dist, idx = K.knn_ivf(bank, scale, bias, mask, dc, dl, staged, rows, k_eff, np_eff, metric)
            return dist, idx, k_eff
        if nprobe and self._ivf is None:
            raise ValueError("NPROBE applies to an IVF field")
        k_eff = max(1, min(int(k), self._cap))
        qbias = None
        if allowed_rows is not None:
            # the reference's (Qb, cap) f32 prefilter bias, staged from the
            # host (256 MB a query batch at 1M rows)
            qb = np.full((staged.shape[0], self._cap), np.inf, np.float32)
            qb[:, np.asarray(allowed_rows, np.int64)] = 0.0
            qbias = K.stage(qb, dev)
        dist, idx = K.knn_flat(bank, scale, bias, qbias, staged, rows, k_eff, metric)
        return dist, idx, k_eff

    def _host_flat_dists(self, q: np.ndarray, host: np.ndarray) -> np.ndarray:
        dots = q @ host.T  # (Q, rows) f32
        metric = self.spec.metric
        if metric == "L2":
            q_sq = np.sum(q * q, axis=1, dtype=np.float32)
            b_sq = np.sum(host * host, axis=1, dtype=np.float32)
            return q_sq[:, None] - 2.0 * dots + b_sq[None, :]
        if metric == "COSINE":
            qn = np.sqrt(np.sum(q * q, axis=1, dtype=np.float32))
            bn = np.sqrt(np.sum(host * host, axis=1, dtype=np.float32))
            denom = qn[:, None] * bn[None, :]
            with np.errstate(invalid="ignore", divide="ignore"):
                cos = np.where(denom > 0.0, dots / denom, 0.0)
            return (1.0 - cos).astype(np.float32)
        return (1.0 - dots).astype(np.float32)  # IP

    def knn_host(self, queries: np.ndarray, k: int,
                 allowed_rows: Optional[np.ndarray] = None,
                 nprobe: Optional[int] = None):
        """Pure-NumPy KNN (the RTPU_NO_VECTOR path): the same float32
        formulas, +inf bias discipline, canonical IVF index and stable tie
        order as the kernels."""
        q = np.ascontiguousarray(queries, np.float32).reshape(-1, self.width)
        self._maybe_train()  # off-lock, same gate as the device path
        with self._lock:
            host, hbias = self.host_planes()
            rows = host.shape[0]
            if rows == 0:
                return None
            if self._ivf is not None:
                self._ivf_sync()
            if self.ivf_ready():
                return self._knn_host_ivf(q, k, allowed_rows, nprobe,
                                          host, hbias)
            if nprobe and self._ivf is None:
                raise ValueError("NPROBE applies to an IVF field")
        dist = self._host_flat_dists(q, host) + hbias[None, :]
        if allowed_rows is not None:
            mask = np.full(rows, np.inf, np.float32)
            mask[np.asarray(allowed_rows, np.int64)] = 0.0
            dist = dist + mask[None, :]
        k_eff = max(1, min(int(k), rows))
        order = np.argsort(dist, axis=1, kind="stable")[:, :k_eff]
        top = np.take_along_axis(dist, order, axis=1)
        return top.astype(np.float32), order.astype(np.int32), q.shape[0], k_eff

    def pair_scores(self, q: np.ndarray, qis: np.ndarray,
                    rowids: np.ndarray) -> np.ndarray:
        """The reply score of every (query, row) hit, recomputed over the
        dequantized mirror by one NumPy reduction: identical bits whichever
        path chose the rows."""
        with self._lock:
            rows = self._host[np.asarray(rowids, np.int64)]       # (M, d)
        qs = np.ascontiguousarray(q, np.float32)[np.asarray(qis, np.int64)]
        return _pair_score_math(rows, qs, self.spec.metric)

    def resolve_hits(self, vals) -> Tuple[np.ndarray, np.ndarray]:
        """The (dist, idx) of one dispatch, device tensors or host arrays,
        as host arrays (dist (Q, k), rowids (Q, k))."""
        return _host(vals[0]), _host(vals[1])

    def _knn_host_ivf(self, q, k, allowed_rows, nprobe, host, hbias):
        """NumPy mirror of the IVF program over the SAME canonical centroids
        and cells: identical routing, candidate order (probe order then cell
        position) and padding semantics."""
        ivf = self._ivf
        np_eff = self._resolve_nprobe(nprobe)
        nq = q.shape[0]
        rows = host.shape[0]
        cent = ivf.centroids
        metric = self.spec.metric
        cd = self._host_flat_dists(q, cent)
        probe = np.argsort(cd, axis=1, kind="stable")[:, :np_eff]
        cand = ivf.cells[probe].reshape(nq, -1)          # (Q, M)
        valid = cand < rows
        safe = np.where(valid, cand, 0)
        rvec = host[safe]                                 # (Q, M, dim)
        dots = np.einsum("qmw,qw->qm", rvec, q, dtype=np.float32)
        if metric == "L2":
            q_sq = np.sum(q * q, axis=1, dtype=np.float32)
            r_sq = np.sum(rvec * rvec, axis=2, dtype=np.float32)
            dist = q_sq[:, None] - 2.0 * dots + r_sq
        elif metric == "COSINE":
            qn = np.sqrt(np.sum(q * q, axis=1, dtype=np.float32))
            rn = np.sqrt(np.sum(rvec * rvec, axis=2, dtype=np.float32))
            denom = qn[:, None] * rn
            with np.errstate(invalid="ignore", divide="ignore"):
                dist = 1.0 - np.where(denom > 0.0, dots / denom, 0.0)
        else:
            dist = 1.0 - dots
        dist = dist + hbias[safe]
        if allowed_rows is not None:
            mask = np.full(rows, np.inf, np.float32)
            mask[np.asarray(allowed_rows, np.int64)] = 0.0
            dist = dist + mask[safe]
        dist = np.where(valid, dist, np.inf).astype(np.float32)
        cand_n = np_eff * ivf.cell_cap
        k_eff = max(1, min(int(k), cand_n))
        order = np.argsort(dist, axis=1, kind="stable")[:, :k_eff]
        top = np.take_along_axis(dist, order, axis=1)
        idx = np.take_along_axis(cand, order, axis=1)
        return top.astype(np.float32), idx.astype(np.int32), nq, k_eff


_FANOUT_POOL = None
_FANOUT_POOL_LOCK = threading.Lock()


def _gmap_decode(g: np.ndarray, local: np.ndarray) -> np.ndarray:
    """Shard-local rowids -> global rowids through one shard's gmap, entries
    out of range (IVF padding sentinels, capacity padding) mapped to -1: the
    one guarded lookup both reply paths share."""
    local = np.asarray(local)
    ok = (local >= 0) & (local < g.shape[0])
    return np.where(ok, g[np.clip(local, 0, max(0, g.shape[0] - 1))], -1)


def _fanout_pool():
    """The worker pool of the sharded banks' legs: each leg stages its
    queries and holds its own shard's lane, so legs dispatched from several
    threads overlap on positions that are different cards (and queue in
    order on one card's stream)."""
    global _FANOUT_POOL
    if _FANOUT_POOL is None:
        with _FANOUT_POOL_LOCK:
            if _FANOUT_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _FANOUT_POOL = ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="rtpu-ftvec-shard"
                )
    return _FANOUT_POOL


class ShardedEmbeddingBank:
    """One index-field embedding bank split ROW-WISE over mesh positions
    (``SHARDS n``; reference ``services/vector.py:1530-1920``): n
    EmbeddingBank shards, each a full bank (its own IVF plane, storage and
    lane accounting) under a shard-salted record, so every per-record
    discipline (DEVMOVE, FT.DROPINDEX, the census) applies shard by shard.
    A manifest record under ``bank_record_name`` lists the shard names.

    Routing: a global rowid goes once to the LEAST-FULL shard (``_route``,
    ``_local``), and each shard keeps its local -> global map (``_gmap``).
    A query runs one ``knn_async`` leg a live shard on ``_fanout_pool``
    (each leg under its position's lane), then merges the legs' (Q, k_s)
    tops on the card in one K19 call (``MeshManager.knn_merge_kernel``),
    never through the host (``STATS.host_colocations`` unmoved,
    ``sharded_knn_merges`` counted).  The NumPy path runs the SAME legs in
    the same shard order and merges them with a stable argsort, and the
    reply scores come from ``_pair_score_math`` over the shard mirrors, so
    both paths give the same replies for every shards x algo x dtype."""

    KIND = "vector_bank_manifest"

    def __init__(self, engine, index: str, spec: VectorFieldSpec,
                 block: int = DEFAULT_BLOCK, reset: bool = True):
        self.spec = spec
        self._engine = engine
        self.index = index
        self.block = max(1, int(block))
        self.name = bank_record_name(index, spec.field)
        self._lock = threading.RLock()
        with engine.locked(self.name):
            old = engine.store.get_unguarded(self.name)
            if reset and old is not None:
                # a rebuilt index must not leak its old shard records
                # (their salted names may differ this time)
                for nm in old.meta.get("shard_names", ()):
                    engine.store.delete_unguarded(nm)
                engine.store.delete_unguarded(self.name)
                old = None
            if old is not None and old.meta.get("shard_names"):
                names = list(old.meta["shard_names"])
            else:
                names = pick_shard_record_names(engine, index, spec.field, spec.shards)
                engine.store.put_unguarded(
                    self.name,
                    StateRecord(
                        kind=self.KIND,
                        meta=dict(spec.to_meta(), index=index, shard_names=list(names)),
                        arrays={},
                    ),
                )
        self.shard_names = names
        self.shards: List[EmbeddingBank] = [
            EmbeddingBank(engine, index, spec, block=block, reset=reset, record_name=nm)
            for nm in names
        ]
        # global rowid -> (shard, shard-local rowid); -1 = never assigned
        self._route = np.full(0, -1, np.int32)
        self._local = np.full(0, -1, np.int32)
        # a shard's local rowid -> global rowid (append-only: a local slot
        # never re-routes, so decoding needs no lock ordering)
        self._gmap: List[np.ndarray] = [np.full(0, -1, np.int32) for _ in names]
        # local slots assigned a shard, the least-full counter: kept here
        # because a shard's own set_row runs outside this lock, so its row
        # count lags the minting
        self._assigned: List[int] = [0 for _ in names]
        self._merge_rr = 0  # round-robin cursor of the merge position
        # staged shard_of_pos operands, keyed by (leg shards, k_s, device)
        self._sop_cache: Dict[Tuple, Any] = {}
        self.rows = 0

    # -- routing --------------------------------------------------------------

    def _grow_routing_locked(self, rowid: int) -> None:
        if rowid < self._route.shape[0]:
            return
        cap = max(self.block, 2 * max(1, self._route.shape[0]))
        while cap <= rowid:
            cap *= 2
        for attr in ("_route", "_local"):
            cur = getattr(self, attr)
            grown = np.full(cap, -1, np.int32)
            grown[: cur.shape[0]] = cur
            setattr(self, attr, grown)

    def _assign_locked(self, rowid: int) -> Tuple[int, int]:
        """Route a new rowid to the least-full shard (ties to the lower
        shard) and mint its local slot."""
        s = int(np.argmin(self._assigned))
        loc = self._assigned[s]
        self._assigned[s] = loc + 1
        self._route[rowid] = s
        self._local[rowid] = loc
        g = self._gmap[s]
        if loc >= g.shape[0]:
            cap = max(DEFAULT_BLOCK, 2 * max(1, g.shape[0]))
            while cap <= loc:
                cap *= 2
            grown = np.full(cap, -1, np.int32)
            grown[: g.shape[0]] = g
            self._gmap[s] = g = grown
        g[loc] = rowid
        return s, loc

    def set_row(self, rowid: int, row: Optional[np.ndarray]) -> None:
        # routing under the facade lock, the shard write outside it: a
        # shard's block flush must not stall ingest to the other shards
        with self._lock:
            self._grow_routing_locked(rowid)
            s = int(self._route[rowid])
            if s < 0:
                s, loc = self._assign_locked(rowid)
            else:
                loc = int(self._local[rowid])
            self.rows = max(self.rows, rowid + 1)
        self.shards[s].set_row(loc, row)

    # -- the EmbeddingBank surface, summed over the shards --------------------

    @property
    def h2d_flushes(self) -> int:
        return sum(sh.h2d_flushes for sh in self.shards)

    @property
    def grows(self) -> int:
        return sum(sh.grows for sh in self.shards)

    def device_bytes(self) -> int:
        return sum(sh.device_bytes() for sh in self.shards)

    def index_device_bytes(self) -> int:
        return sum(sh.index_device_bytes() for sh in self.shards)

    def logical_f32_bytes(self) -> int:
        return sum(sh.logical_f32_bytes() for sh in self.shards)

    def pending_count(self) -> int:
        return sum(sh.pending_count() for sh in self.shards)

    def device_bytes_by_device(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for sh in self.shards:
            for d, b in sh.device_bytes_by_device().items():
                out[d] = out.get(d, 0) + b
        return out

    def index_bytes_by_device(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for sh in self.shards:
            for d, b in sh.index_bytes_by_device().items():
                out[d] = out.get(d, 0) + b
        return out

    def ivf_ready(self) -> bool:
        return any(sh.ivf_ready() for sh in self.shards)

    def retrain(self) -> None:
        for sh in self.shards:
            sh.retrain()

    def flush_pending(self) -> int:
        return sum(sh.flush_pending() for sh in self.shards)

    def drop(self) -> None:
        for sh in self.shards:
            sh.drop()
        with self._engine.locked(self.name):
            self._engine.store.delete_unguarded(self.name)

    def shard_rows(self) -> List[Dict[str, Any]]:
        """A row a shard for FT.INFO and the census."""
        return [
            {
                "shard": i, "record": sh.name, "rows": sh.rows,
                "device": sh.owner_device_id(),
                "device_bytes": sh.device_bytes(),
                "index_device_bytes": sh.index_device_bytes(),
            }
            for i, sh in enumerate(self.shards)
        ]

    # -- scoring --------------------------------------------------------------

    def _legs(self, allowed_rows: Optional[np.ndarray]):
        """[(shard, shard-local allowed rows | None)]: the one leg choice
        both paths share.  Ascending shard order (the merge's tie order),
        empty shards skipped, and a shard the prefilter leaves no row of is
        not dispatched at all."""
        with self._lock:
            if allowed_rows is None:
                return [(s, None) for s in range(len(self.shards)) if self.shards[s].rows > 0]
            al = np.asarray(allowed_rows, np.int64).reshape(-1)
            al = al[(al >= 0) & (al < self._route.shape[0])]
            rs = self._route[al]
            ls = self._local[al]
            legs = []
            for s in range(len(self.shards)):
                if self.shards[s].rows <= 0:
                    continue
                m = rs == s
                if np.any(m):
                    legs.append((s, ls[m].astype(np.int64)))
            return legs

    def _merge_kernel(self, n_legs: int):
        """K19 through MeshManager's geometry-keyed cache: a 4 -> 8 -> 4
        reshard lands back on the program object built before."""
        from redisson_tpu_torch.parallel.manager import MeshManager

        return MeshManager.of(self._engine).knn_merge_kernel(n_legs)

    def _merge_lane_gate(self, position, n_items: int):
        lanes = self._engine.lanes
        if lanes is None or position is None:
            return nullcontext()
        return lanes.lane(position).occupy(n_items)

    def knn_async(self, queries: np.ndarray, k: int,
                  allowed_rows: Optional[np.ndarray] = None,
                  nprobe: Optional[int] = None):
        """Row-parallel KNN: one ``knn_async`` leg a live shard, at once on
        the fan-out pool, then the legs' (Q, k_s) tops merged by K19 on the
        device of the merge leg (the legs rotate as merge legs, each merge
        under that leg's position's lane).  Returns (dist, shard, local,
        q_count, k_eff); resolve_hits decodes (shard, local) to global
        rowids on the host."""
        q = np.ascontiguousarray(queries, np.float32).reshape(-1, self.spec.dim)
        nq = q.shape[0]
        legs = self._legs(allowed_rows)
        if not legs:
            return None
        pool = _fanout_pool()
        futs = [pool.submit(self.shards[s].knn_async, q, k, al, nprobe) for s, al in legs]
        outs = []
        for (s, _al), f in zip(legs, futs):
            o = f.result()
            if o is not None:
                outs.append((s, o))
        if not outs:
            return None
        with self._lock:
            rr = self._merge_rr
            self._merge_rr = rr + 1
        merge_shard, merge_out = outs[rr % len(outs)]
        dest = merge_out[0].device
        position = self.shards[merge_shard]._owner_position()
        dists = [ioplane.colocate(o[0], dest) for _s, o in outs]
        idxs = [ioplane.colocate(o[1], dest) for _s, o in outs]
        key = (tuple(s for s, _o in outs), tuple(o[3] for _s, o in outs), str(dest))
        with self._lock:
            sop = self._sop_cache.get(key)
        if sop is None:
            sop = K.stage(np.concatenate([np.full(o[3], s, np.int32) for s, o in outs]), dest)
            with self._lock:
                if len(self._sop_cache) >= 64:
                    self._sop_cache.clear()
                self._sop_cache[key] = sop
        total = sum(o[3] for _s, o in outs)
        k_out = max(1, min(int(k), total))
        merge = self._merge_kernel(len(outs))
        # the merge charges the merge position's lane on top of the legs
        with self._merge_lane_gate(position, nq * total):
            dist, sid, lidx = merge(tuple(dists), tuple(idxs), sop, k_out)
        ioplane.STATS.count_sharded_merge()
        return dist, sid, lidx, nq, k_out

    def resolve_hits(self, vals) -> Tuple[np.ndarray, np.ndarray]:
        """(dist, shard, local), device tensors or host arrays -> (dist,
        GLOBAL rowids) on the host; non-finite or unmapped entries resolve
        to rowid -1 (callers skip them)."""
        dist = _host(vals[0])
        sid = _host(vals[1])
        lidx = _host(vals[2])
        with self._lock:
            gmaps = list(self._gmap)
        glob = np.full(dist.shape, -1, np.int32)
        finite = np.isfinite(dist)
        if np.any(finite):
            for s in np.unique(sid[finite]):
                m = finite & (sid == s)
                glob[m] = _gmap_decode(gmaps[int(s)], lidx[m])
        return dist, glob

    def knn_host(self, queries: np.ndarray, k: int,
                 allowed_rows: Optional[np.ndarray] = None,
                 nprobe: Optional[int] = None):
        """The NumPy path: the SAME legs (each shard's own ``knn_host``),
        concatenated in the same shard order and merged by one stable
        argsort, position for position the device merge."""
        q = np.ascontiguousarray(queries, np.float32).reshape(-1, self.spec.dim)
        legs = self._legs(allowed_rows)
        if not legs:
            return None
        outs = []
        for s, al in legs:
            o = self.shards[s].knn_host(q, k, allowed_rows=al, nprobe=nprobe)
            if o is not None:
                outs.append((s, o))
        if not outs:
            return None
        with self._lock:
            gmaps = list(self._gmap)
        dist_cat = np.concatenate([o[0] for _s, o in outs], axis=1)
        # an IVF leg may carry padding sentinels (probed cells holding fewer
        # than k live rows): decoded through the same guarded lookup
        glob_cat = np.concatenate([_gmap_decode(gmaps[s], o[1]) for s, o in outs], axis=1)
        k_out = max(1, min(int(k), dist_cat.shape[1]))
        order = np.argsort(dist_cat, axis=1, kind="stable")[:, :k_out]
        top = np.take_along_axis(dist_cat, order, axis=1)
        idx = np.take_along_axis(glob_cat, order, axis=1)
        return top.astype(np.float32), idx.astype(np.int32), q.shape[0], k_out

    def pair_scores(self, q: np.ndarray, qis: np.ndarray,
                    rowids: np.ndarray) -> np.ndarray:
        """The reply score routine over the SHARD mirrors: each global
        rowid's dequantized row, gathered shard by shard, then the one
        per-pair reduction: the bits a plain bank of the same rows gives."""
        rid = np.asarray(rowids, np.int64).reshape(-1)
        with self._lock:
            rs = self._route[rid]
            ls = self._local[rid]
        rows = np.zeros((rid.shape[0], self.spec.dim), np.float32)
        for s in np.unique(rs):
            if s < 0:  # winners are always routed
                continue
            m = rs == s
            sh = self.shards[int(s)]
            with sh._lock:
                rows[m] = sh._host[ls[m]]
        qs = np.ascontiguousarray(q, np.float32)[np.asarray(qis, np.int64)]
        return _pair_score_math(rows, qs, self.spec.metric)


class VectorPlane:
    """Per-index vector fields: field -> EmbeddingBank (or, for SHARDS n > 1,
    ShardedEmbeddingBank) sharing the index's doc rowid space.  SHARDS 1 is
    the plain bank, so its replies are an unsharded index's."""

    def __init__(self, engine, index: str,
                 specs: Dict[str, VectorFieldSpec],
                 block: int = DEFAULT_BLOCK, reset: bool = True):
        self.index = index
        self.banks: Dict[str, Any] = {
            f: (
                ShardedEmbeddingBank(engine, index, spec, block=block, reset=reset)
                if spec.shards > 1
                else EmbeddingBank(engine, index, spec, block=block, reset=reset)
            )
            for f, spec in specs.items()
        }

    def __bool__(self) -> bool:
        return bool(self.banks)

    def set_row(self, rowid: int, fields: Dict[str, Any]) -> None:
        for f, bank in self.banks.items():
            try:
                row = parse_vector_value(fields.get(f), bank.spec.dim)
            except ValueError:
                # malformed blob: the doc stays text/tag/numeric-searchable,
                # just never KNN-visible
                row = None
            bank.set_row(rowid, row)

    def clear_row(self, rowid: int) -> None:
        for bank in self.banks.values():
            bank.set_row(rowid, None)

    def drop(self) -> None:
        for bank in self.banks.values():
            bank.drop()

    def device_bytes(self) -> int:
        return sum(b.device_bytes() for b in self.banks.values())

    def index_device_bytes(self) -> int:
        return sum(b.index_device_bytes() for b in self.banks.values())

    def h2d_flushes(self) -> int:
        return sum(b.h2d_flushes for b in self.banks.values())

    def device_bytes_by_device(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for b in self.banks.values():
            for d, v in b.device_bytes_by_device().items():
                out[d] = out.get(d, 0) + v
        return out

    def index_bytes_by_device(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for b in self.banks.values():
            for d, v in b.index_bytes_by_device().items():
                out[d] = out.get(d, 0) + v
        return out

    def info_rows(self) -> List[Dict[str, Any]]:
        out = []
        for f, b in self.banks.items():
            row = {
                "field": f, "dim": b.spec.dim, "metric": b.spec.metric,
                "algo": b.spec.algo, "dtype": b.spec.dtype,
                "rows": b.rows, "device_bytes": b.device_bytes(),
            }
            if b.spec.algo == "IVF":
                row.update({
                    "nlist": b.spec.nlist, "nprobe": b.spec.nprobe,
                    "trained": b.ivf_ready(),
                    "index_device_bytes": b.index_device_bytes(),
                })
            if isinstance(b, ShardedEmbeddingBank):
                row["shards"] = b.spec.shards
                row["shard_rows"] = b.shard_rows()
            out.append(row)
        return out
