"""Sketch kernel dispatch: host packing helpers, the plain PyTorch version of
each device program, and the wrappers that launch the hand-written CUDA
kernels of ``csrc/``.

Every public function keeps the name of its jitted counterpart in
``redisson_tpu/core/kernels.py``.  A wrapper picks its route from the device
of the state it is given: state on the CPU runs the plain version, state on a
CUDA card launches the kernel, and nothing falls back from one to the other
(a CUDA launch either runs or raises).

Fourteen kernels carry every program here:

  bloom_probe  hash, k probes, AND; out as flags, a uint32 bitmap or a count
  bloom_set    hash, store 1 at the k probes (after bloom_probe: the add
               contract reads every bit as it was before the batch)
  bloom_add    the fused add of a large batch: probes binned by chunk of the
               plane, each touched chunk read and written once; the newly
               result in any of the three forms.  ``bloom_add`` picks it or
               the probe-then-set pair by batch size (``use_fused_add``)
  hll_add      hash, scatter-max of the rank into a uint8 register
  hll_rows     row gather-max of two banks, optional out-of-place write,
               optional float32 estimate per row; 16-byte loads where the
               banks allow them, else 4-byte ones
  bitset_get   GETBIT batch: gather one uint8 lane per op, from one plane
               or, in the table form (bitset_groups), from the planes of
               a level of RBatch groups in one launch
  bitset_set   SETBIT batch: every old bit read before any store of the
               value, in one launch (one block a group, or a cooperative
               grid), from one plane or in the table form
  wc_words     word count: each word's two 32-bit polynomial hashes and
               start from its end position, the ends found on the card
               (wc_extract_words_auto: one launch, the chunk read once,
               ends ranked by decoupled look-back) or given as deltas
               (wc_extract_words: a scan, then a thread a row)
  wc_sort_runs word count: a stable one-sweep radix sort of the 64-bit
               word hashes, then each run's first row compacted to the front
  segment_reduce  KernelMapReduce's shuffle and reduce: sum, max or min of
               int32 or float32 values into n_keys slots; one launch up to
               segment_shared_keys (shared copies merged a cluster at a
               time), a fill and global atomics past it
  knn_score    KNN: the (Q, C) float32 distances of queries to a bank
               (float32, float16 or int8 rows widened in the kernel), the
               metric, bias, the n_rows mask and a per-query bias in one
               pass; the bank streamed past a resident query block, or
               tiled (knn_score_route)
  knn_select   KNN: each row's k smallest (distance, column), ties to the
               lower column (FLAT, the IVF route and the IVF candidates)
  ivf_score    IVF: the rows listed in each query's probed cells, scored
               against that query (+inf for the sentinel padding)
  kmeans       IVF training: one Lloyd iteration as two wrappers,
               kmeans_assign (3xTF32 on the tensor cores up to W 256,
               float32 tiles wider: kmeans_assign_route) and
               kmeans_update (two launches: the rows bucketed by cell in
               row order, then each cell's mean in that order; no float
               atomics)

The sharded vector banks' merge (K19, ``knn_sharded_merge``, reference
``core/kernels.py:840-858``) is a concatenation (a copy) and one
``knn_select`` launch over the (Q, sum of k_s) matrix: its key order
(distance, then column; +inf after every finite value; -0.0 before +0.0)
is the reference's ``lax.top_k(-dist)`` over the concatenation.

bloom_probe, bloom_set, hll_add, bitset_get and bitset_set also take a
shard window (``col_lo``, ``row_lo``, ``lo``): the state is one shard's
columns, rows or bits of a plane sharded over a mesh
(``parallel/sharded.py``), another shard's probe counts as set (bloom),
another shard's op is dropped (hll) or reads 0 (bitset), and each plain
version takes the same window.  ``window_launches`` counts those launches.

The rest of the BitSet programs (popcount, BITOP, BITPOS, length) only
reduce or map a plane elementwise and stay torch ops, as do the row-bank
writes and growth of the vector banks (they bitcast and scatter rows).

Differences from the JAX programs:
  * State is updated in place.  JAX donates the plane and returns a new
    array; the wrappers here write into the tensor they are given and return
    it, so callers keep the ``state = fn(state, ...)`` shape.  The HLL merge
    programs are the exception: they read rows while other rows are written,
    so they write a new bank.
  * ``n_valid`` is a launch argument.  The JAX package cached device scalars
    (``valid_n``) only to save a host-to-device upload per dispatch; a CUDA
    launch argument costs nothing, so ``valid_n`` has no port.
  * 32-bit key words travel as int32 tensors holding the uint32 bits (torch's
    uint32 has no shifts or adds on the CPU); bitmaps come back the same way.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from redisson_tpu_torch.core import _build, ioplane
from redisson_tpu_torch.observe import trace as _obs
from redisson_tpu_torch.ops import bittensor as bt
from redisson_tpu_torch.ops import hll as hll_ops
from redisson_tpu_torch.utils import hashing as H

MIN_BUCKET = 256
BANK_MAX_CELLS = 2**31 - 2048  # int32 flat-index space minus sentinel headroom

# Launches of each hand kernel since the last reset_launches(); a run reads
# them to show that its path went through the kernels.  The server's worker
# threads launch concurrently, so every change goes through _launches_lock.
launches = {"bloom_probe": 0, "bloom_set": 0, "bloom_add": 0, "hll_add": 0, "hll_rows": 0,
            "bitset_get": 0, "bitset_set": 0, "wc_words": 0, "wc_sort_runs": 0,
            "segment_reduce": 0, "knn_score": 0, "knn_select": 0, "ivf_score": 0, "kmeans": 0}
# Of those, the launches with a shard window (parallel/sharded.py: the
# sharded sketch programs' windowed forms of five kernels).
window_launches = {"bloom_probe": 0, "bloom_set": 0, "hll_add": 0, "bitset_get": 0, "bitset_set": 0}
_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for counts in (launches, window_launches):
            for name in counts:
                counts[name] = 0


def count_launch(name: str) -> None:
    with _launches_lock:
        launches[name] += 1


def _count_window(name: str, lo) -> None:
    """Count a launch that just ran with a shard window (lo not None)."""
    if lo is not None:
        with _launches_lock:
            window_launches[name] += 1


# --------------------------------------------------------------------------
# Host-side batch shaping (same policy as the JAX package: bounded padding,
# the padded tail masked by n_valid inside the kernels).
# --------------------------------------------------------------------------

def pow2_bucket(n: int, minimum: int = MIN_BUCKET) -> int:
    b = minimum
    while b < n:
        b <<= 1
    return b


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    """Padded batch size: the next multiple of next_pow2(n)/8, so padding is
    at most 12.5% and every size is a multiple of 32 (the bitmap word)."""
    if n <= minimum:
        return minimum
    step = max(minimum, (1 << (int(n - 1).bit_length())) >> 3)
    return ((n + step - 1) // step) * step


def pad_to(arr: np.ndarray, size: int, axis: int = 0) -> np.ndarray:
    """Zero-pad `arr` along `axis` up to `size`."""
    if arr.shape[axis] == size:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, size - arr.shape[axis])
    return np.pad(arr, pad)


def stage(arr: np.ndarray, device, non_blocking: bool = False) -> torch.Tensor:
    """numpy operand -> tensor on `device`; 32-bit words become int32 bits.
    `non_blocking` only for pinned host memory (a staging pool's slot)."""
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        # a view of a wire blob: on the CPU the tensor would share (and
        # could write) its bytes
        arr = arr.copy()
    return torch.from_numpy(arr).to(device, non_blocking=non_blocking)


def pack_rows(*arrays, size: int, device, pool=None) -> torch.Tensor:
    """Stack 1-D 32-bit arrays into ONE (R, size) buffer (zero padded) and
    copy it to `device` in one transfer.

    `pool` (core/ioplane.StagingPool, pinned host slots) fills a reusable
    slot instead of a fresh allocation and copies without blocking; the
    slot is handed out again only after the event recorded behind the copy
    has passed.  Callers pass a pool only where reuse is safe
    (Engine.staging_pool: never on the CPU, where the tensor would alias
    the slot)."""
    shape = (len(arrays), size)
    if pool is None:
        out, slot = np.zeros(shape, np.uint32), None
    else:
        out, slot = pool.acquire(shape, np.uint32)
    try:
        for i, a in enumerate(arrays):
            out[i, : a.shape[0]] = a.view(np.uint32) if a.dtype == np.int32 else a
        staged = stage(out, device, non_blocking=pool is not None)
    except BaseException:
        if pool is not None:
            pool.release(slot)  # a slot left busy would shrink the pool for good
        raise
    if pool is not None:
        pool.commit(slot, ioplane.record_event(staged.device))
    return staged


def unpack_found(packed, n: int) -> np.ndarray:
    """uint32 bitmap (bit i of word j = op 32j+i) -> bool[n] on the host."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    b = np.unpackbits(np.ascontiguousarray(packed).view(np.uint8), bitorder="little")
    return b[:n].astype(bool)


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _pack_bool_u32(flags: torch.Tensor) -> torch.Tensor:
    """bool[B] (B % 32 == 0) -> B/32 words, bit i of word j = flags[32j+i]."""
    shifts = torch.arange(32, dtype=torch.int64, device=flags.device)
    words = (flags.reshape(-1, 32).to(torch.int64) << shifts).sum(dim=1)
    return _to_int32_bits(words)


# --------------------------------------------------------------------------
# Hot-query staged-buffer cache (read paths only).  Content addressing makes
# reuse exact: any change to the caller's arrays changes the digest.  Kernels
# never write their query operand, so a cached buffer survives any number of
# dispatches.  One cache per engine, so tensors never cross devices.
# --------------------------------------------------------------------------

class QueryCache:
    SLOTS = 8
    MAX_BYTES = 8 << 20  # don't pin giant one-off uploads in device memory

    def __init__(self):
        self._entries: "OrderedDict[bytes, torch.Tensor]" = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def digest(*arrays, extra: bytes = b"") -> bytes:
        h = hashlib.blake2b(digest_size=16)
        for a in arrays:
            a = np.ascontiguousarray(a)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(memoryview(a).cast("B"))
        h.update(extra)
        return h.digest()

    def get(self, digest: bytes):
        with self._lock:
            buf = self._entries.pop(digest, None)
            if buf is not None:
                self._entries[digest] = buf  # LRU refresh
            return buf

    def put(self, digest: bytes, buf: torch.Tensor) -> None:
        if buf.nbytes > self.MAX_BYTES:
            return
        with self._lock:
            self._entries[digest] = buf
            while len(self._entries) > self.SLOTS:
                self._entries.popitem(last=False)

    def cached_staged(self, build, *digest_arrays, extra: bytes = b""):
        """Reuse the staged buffer of identical operands, else build, stage
        and cache it.  `build()` runs only on a miss."""
        digest = self.digest(*digest_arrays, extra=extra)
        buf = self.get(digest)
        if buf is None:
            buf = build()
            self.put(digest, buf)
        return buf

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# --------------------------------------------------------------------------
# Key operands
# --------------------------------------------------------------------------

class Keys(NamedTuple):
    """One batch of keys as int32 tensors of length n (the padded batch).

    u64 keys fill lo/hi; byte keys fill words (W, n) and nbytes (n,).
    tenant, when set, is each op's row in a (T, W) plane."""
    n: int
    tenant: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None
    hi: Optional[torch.Tensor] = None
    words: Optional[torch.Tensor] = None
    nbytes: Optional[torch.Tensor] = None


def _u64_keys(lo, hi, tenant=None) -> Keys:
    return Keys(n=lo.shape[0], tenant=tenant, lo=lo, hi=hi)


def _byte_keys(words, nbytes) -> Keys:
    return Keys(n=nbytes.shape[0], words=words, nbytes=nbytes)


def _hash(keys: Keys):
    if keys.words is None:
        return H.hash_u64_pair(keys.lo, keys.hi)
    return H.hash_packed_bytes(keys.words, keys.nbytes)


def _flat_index(tenant, idx: torch.Tensor, width: int, size: int) -> torch.Tensor:
    """Flat plane position of each probe, or `size` where it is outside.

    Kept bit for bit from the JAX programs: tenant*width + idx is int32
    arithmetic (it wraps), a negative position counts from the end once,
    and whatever is still outside [0, size) reads as 1 / is dropped."""
    if tenant is None:
        g = idx
    else:
        t = tenant.to(torch.int64).reshape((-1,) + (1,) * (idx.dim() - 1))
        g = ((t * width + idx + 2**31) & H.M32) - 2**31
        g = torch.where(g < 0, g + size, g)
    return torch.where((g >= 0) & (g < size), g, size)


def _valid(n: int, n_valid: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) < n_valid


# --------------------------------------------------------------------------
# The kernels: plain versions and CUDA launches
# --------------------------------------------------------------------------

FLAGS, BITS, COUNT = 0, 1, 2


def _require_cuda_operands(state: torch.Tensor, *operands) -> None:
    """The kernel route takes only contiguous operands on the state's card."""
    if not state.is_contiguous():
        raise ValueError("kernel state must be contiguous")
    for t in operands:
        if t is None:
            continue
        if t.device != state.device:
            raise ValueError(f"operand on {t.device}, state on {state.device}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.dtype != torch.int32:
            raise ValueError(f"kernel operands are int32 words, got {t.dtype}")


def _route(state: torch.Tensor) -> str:
    if state.device.type == "cpu":
        return "plain"
    if state.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for tensors on {state.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _key_args(keys: Keys):
    n_words = 0 if keys.words is None else keys.words.shape[0]
    return (_ptr(keys.tenant), _ptr(keys.lo), _ptr(keys.hi), _ptr(keys.words),
            _ptr(keys.nbytes), n_words, keys.n)


def _launch(name: str, fn, state: torch.Tensor, *args) -> None:
    # with tracing armed, the host side of the launch is the frame's
    # `launch` span (the kernel runs after it, in stream order)
    cur = _obs.current_trace() if _obs._tracer is not None else None
    t0 = time.monotonic() if cur is not None else 0.0
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        _build.check(name, fn(*args, stream))
    count_launch(name)
    if cur is not None:
        cur.add_span("launch", t0, time.monotonic(), kernel=name)


# The bloom kernels reduce (h1 + i*h2) mod 2**32 by m with a multiply-high
# (csrc/hash.cuh FastMod) by this constant instead of a division.

def fastmod_magic(m: int) -> int:
    """ceil(2**64 / m) mod 2**64, the FastMod constant of m."""
    if not 1 <= m < 2**32:
        raise ValueError(f"bloom hash domain m={m} must be in [1, 2**32)")
    return (((1 << 64) - 1) // m + 1) & ((1 << 64) - 1)


def fastmod(x: int, magic: int, m: int) -> int:
    """x % m for a uint32 x, computed as FastMod computes it on the card."""
    return (((magic * x) & ((1 << 64) - 1)) * m) >> 64


# The fused add bins a batch's probes by 64 KB chunk of the plane (a
# shared-memory tile) and reads and writes each touched chunk once: it moves
# 16 bytes of entry per probe and whole tiles, so it pays off only when the
# batch touches a good share of a plane that does not fit in L2.
# use_fused_add takes it when the plane is larger than FUSED_ADD_MIN_PLANE
# (the H100's 50 MiB L2: in a plane that fits there the pair's scattered
# stores are L2 hits) and k * n_valid >= FUSED_ADD_PROBES_PER_SECTOR probes
# per 32-byte sector of the plane, the crossover measured on an H100
# (PERF.md section 6); the probe-then-set pair otherwise.  A block of the
# binning passes keeps a histogram of every chunk in shared memory beside
# its staged entries, so a plane of more than ADD_MAX_BINS chunks (512 MiB),
# or a batch of more probes than the uint32-indexed entries hold, takes the
# pair.
ADD_CHUNK_LOG2 = 16
ADD_MAX_BINS = 1 << 13
FUSED_ADD_MIN_PLANE = 50 << 20
FUSED_ADD_PROBES_PER_SECTOR = 0.3
FUSED_ADD_MAX_PROBES = 2**31 - 1


def add_chunks(size: int) -> int:
    """Chunks of the fused add over a plane of `size` bytes."""
    return (size + (1 << ADD_CHUNK_LOG2) - 1) >> ADD_CHUNK_LOG2


# csrc/bloom.cu's kBlock and kStageBytes: a block of the binning passes
# stages up to 2 * kBlock ops' entries (10 bytes per probe) in kStageBytes
# of shared memory beside two words per chunk.
_ADD_BLOCK = 1024
_ADD_STAGE_BYTES = 160 * 1024


def add_ops_per_block(chunks: int, k: int) -> int:
    """Ops per block of the fused add's binning passes (csrc/bloom.cu
    ops_per_block); 0 when the staging memory holds not even one op."""
    fit = (_ADD_STAGE_BYTES - 8 * ((chunks + 3) & ~3)) // (10 * k)
    return max(0, min(fit, 2 * _ADD_BLOCK))


def use_fused_add(size: int, n_valid: int, k: int) -> bool:
    """The size dispatch of bloom_add on the card: fused add or the pair."""
    probes = k * n_valid
    return (FUSED_ADD_MIN_PLANE < size and add_chunks(size) <= ADD_MAX_BINS
            and add_ops_per_block(add_chunks(size), k) > 0
            and FUSED_ADD_PROBES_PER_SECTOR * size / 32 <= probes <= FUSED_ADD_MAX_PROBES)


def _bloom_operands(plane, keys: Keys, n_valid, m, out) -> int:
    """Check a bloom launch's operands; returns n_valid clamped to [0, n]."""
    _require_cuda_operands(plane, keys.tenant, keys.lo, keys.hi, keys.words, keys.nbytes)
    if plane.dtype != torch.uint8:
        raise ValueError("bloom planes are uint8")
    if out == BITS and keys.n % 32:
        raise ValueError("bitmap results need a batch that is a multiple of 32")
    fastmod_magic(m)  # raises outside [1, 2**32)
    return max(0, min(n_valid, keys.n))


def _bloom_result(plane, n: int, out):
    if out == FLAGS:
        return torch.empty(n, dtype=torch.bool, device=plane.device)
    if out == BITS:
        return torch.empty(n // 32, dtype=torch.int32, device=plane.device)
    return torch.zeros((), dtype=torch.int32, device=plane.device)


def _window_cols(idx: torch.Tensor, col_lo: Optional[int], width: int):
    """A shard's column window (parallel/sharded.py): each global probe's
    column in the shard that holds columns [col_lo, col_lo + width), and
    whether this shard holds it; with no window, idx and all True."""
    if col_lo is None:
        return idx, None
    local = idx - col_lo
    owned = (local >= 0) & (local < width)
    return torch.where(owned, local, 0), owned


def _bloom_positions(plane, width, keys: Keys, k, m, col_lo):
    """Flat plane position of every probe; `size` (reads 1, never written)
    outside the plane or, with a window, where another shard holds it."""
    h1, h2 = _hash(keys)
    cols, owned = _window_cols(H.bloom_indexes(h1, h2, k, m), col_lo, width)
    g = _flat_index(keys.tenant, cols, width, plane.numel())
    return g if owned is None else torch.where(owned, g, plane.numel())


def bloom_probe_plain(plane, width, keys: Keys, n_valid, k, m, newly=False, out=FLAGS,
                      col_lo=None):
    """Plain version of bloom_probe: per op, are all k bits set (or, with
    `newly`, was any of them 0); ops >= n_valid give False.  With `col_lo`
    the plane is one shard's columns [col_lo, col_lo + width) of every row
    and another shard's probe counts as set."""
    g = _bloom_positions(plane, width, keys, k, m, col_lo)
    found = bt.contains(plane.reshape(-1), g)
    flags = (~found if newly else found) & _valid(keys.n, n_valid, plane.device)
    if out == BITS:
        return _pack_bool_u32(flags)
    if out == COUNT:
        return flags.sum(dtype=torch.int32)
    return flags


def _window(lo: Optional[int]) -> int:
    """A window's first column, row or bit as the kernels take it: -1 for
    none (the whole plane)."""
    if lo is None:
        return -1
    if lo < 0:
        raise ValueError(f"a shard window starts at a non-negative index, got {lo}")
    return int(lo)


def bloom_probe(plane, width, keys: Keys, n_valid, k, m, newly=False, out=FLAGS, col_lo=None):
    if _route(plane) == "plain":
        return bloom_probe_plain(plane, width, keys, n_valid, k, m, newly, out, col_lo)
    n_valid = _bloom_operands(plane, keys, n_valid, m, out)
    result = _bloom_result(plane, keys.n, out)
    _launch("bloom_probe", _build.library("bloom").rtpu_bloom_probe, plane,
            plane.data_ptr(), plane.numel(), width, *_key_args(keys),
            n_valid, k, m, fastmod_magic(m), _window(col_lo), int(newly), out, result.data_ptr())
    _count_window("bloom_probe", col_lo)
    return result


def bloom_set_plain(plane, width, keys: Keys, n_valid, k, m, col_lo=None):
    g = _bloom_positions(plane, width, keys, k, m, col_lo)
    bt.set_bits(plane.view(-1), g[_valid(keys.n, n_valid, plane.device)])


def bloom_set(plane, width, keys: Keys, n_valid, k, m, col_lo=None) -> None:
    """Set the k bits of every op < n_valid, in place; with `col_lo`, only
    the probes of the shard whose columns the plane holds."""
    if _route(plane) == "plain":
        return bloom_set_plain(plane, width, keys, n_valid, k, m, col_lo)
    n_valid = _bloom_operands(plane, keys, n_valid, m, FLAGS)
    _launch("bloom_set", _build.library("bloom").rtpu_bloom_set, plane,
            plane.data_ptr(), plane.numel(), width, *_key_args(keys),
            n_valid, k, m, fastmod_magic(m), _window(col_lo))
    _count_window("bloom_set", col_lo)


def bloom_add_plain(plane, width, keys: Keys, n_valid, k, m, out=FLAGS):
    """Plain version of an add: the newly result read from the plane as it
    stood before the batch (two equal keys both report it), then every op
    < n_valid sets its k bits, in place."""
    newly = bloom_probe_plain(plane, width, keys, n_valid, k, m, newly=True, out=out)
    bloom_set_plain(plane, width, keys, n_valid, k, m)
    return newly


def bloom_add_fused(plane, width, keys: Keys, n_valid, k, m, out=FLAGS):
    """The fused add kernel, whatever the batch size (bloom_add picks it by
    size).  The plane must be 16-byte aligned and at most ADD_MAX_BINS
    chunks long; scratch is 8 bytes per probe."""
    if _route(plane) == "plain":
        return bloom_add_plain(plane, width, keys, n_valid, k, m, out)
    n_valid = _bloom_operands(plane, keys, n_valid, m, out)
    if plane.data_ptr() % 16:
        raise ValueError("the fused add takes a 16-byte aligned plane")
    if k * n_valid > FUSED_ADD_MAX_PROBES:
        raise ValueError(f"{k * n_valid} probes: the fused add takes at most {FUSED_ADD_MAX_PROBES}")
    chunks = add_chunks(plane.numel())
    if chunks > ADD_MAX_BINS:
        raise ValueError(f"{chunks} chunks: the fused add takes at most {ADD_MAX_BINS} "
                         "(a histogram of them in shared memory)")
    if add_ops_per_block(chunks, k) == 0:
        raise ValueError(f"k = {k}: the fused add stages no op's probes in shared memory")
    dev = plane.device
    newly = torch.empty(keys.n, dtype=torch.bool, device=dev)
    result = newly if out == FLAGS else _bloom_result(plane, keys.n, out)
    scratch = torch.empty(2 * chunks + 1, dtype=torch.int32, device=dev)
    entries = torch.empty(max(1, k * n_valid), dtype=torch.int64, device=dev)
    _launch("bloom_add", _build.library("bloom").rtpu_bloom_add, plane,
            plane.data_ptr(), plane.numel(), width, *_key_args(keys),
            n_valid, k, m, fastmod_magic(m), ADD_CHUNK_LOG2, out, result.data_ptr(),
            newly.data_ptr(), scratch.data_ptr(), entries.data_ptr())
    return result


def bloom_add(plane, width, keys: Keys, n_valid, k, m, out=FLAGS):
    """Add every op < n_valid, in place; returns the newly result (flags,
    bitmap or count) read from the plane as it stood before the batch.  On
    the card a batch of at least use_fused_add's size takes the fused add,
    a smaller one bloom_probe(newly) then bloom_set on the same stream."""
    if _route(plane) == "plain":
        return bloom_add_plain(plane, width, keys, n_valid, k, m, out)
    if use_fused_add(plane.numel(), max(0, min(n_valid, keys.n)), k):
        return bloom_add_fused(plane, width, keys, n_valid, k, m, out)
    newly = bloom_probe(plane, width, keys, n_valid, k, m, newly=True, out=out)
    bloom_set(plane, width, keys, n_valid, k, m)
    return newly


def hll_add_plain(regs, width, keys: Keys, n_valid, p, row_lo=None):
    h1, h2 = _hash(keys)
    idx, rho = hll_ops.idx_rho(h1, h2, p)
    flat = regs.view(-1)
    if row_lo is None:
        g = _flat_index(keys.tenant, idx, width, flat.numel())
    else:
        r = keys.tenant.to(torch.int64) - row_lo
        owned = (r >= 0) & (r < flat.numel() // width)
        g = torch.where(owned, r * width + idx, flat.numel())
    g = torch.where(_valid(keys.n, n_valid, regs.device), g, flat.numel())
    hll_ops.add(flat, g, rho)


def hll_add(regs, width, keys: Keys, n_valid, p, row_lo=None) -> None:
    """Scatter-max the rank of every op < n_valid into its register, in
    place.  With `row_lo` the bank is one shard's rows [row_lo, row_lo +
    rows) of a tenant-sharded bank: an op's row is its tenant - row_lo, and
    another shard's tenant is dropped."""
    if _route(regs) == "plain":
        return hll_add_plain(regs, width, keys, n_valid, p, row_lo)
    if row_lo is not None and keys.tenant is None:
        raise ValueError("a row window needs a tenant per op")
    _require_cuda_operands(regs, keys.tenant, keys.lo, keys.hi, keys.words, keys.nbytes)
    if regs.dtype != torch.uint8 or regs.data_ptr() % 4 or regs.numel() % 4:
        raise ValueError("register banks are uint8, 4-byte aligned, a multiple of 4 long")
    _launch("hll_add", _build.library("hll").rtpu_hll_add, regs,
            regs.data_ptr(), regs.numel(), width, p, *_key_args(keys),
            max(0, min(n_valid, keys.n)), _window(row_lo))
    _count_window("hll_add", row_lo)


def _row_index(rows: torch.Tensor, count: int) -> torch.Tensor:
    """JAX's gather rule for x[rows]: negative rows count from the end once,
    then rows are clamped into [0, count)."""
    r = rows.to(torch.int64)
    return torch.where(r < 0, r + count, r).clamp(0, count - 1)


def hll_rows_plain(x, y=None, a=None, b=None, out=None, estimate=False):
    rows = x if a is None else x[_row_index(a, x.shape[0])]
    if y is not None:
        rows = torch.maximum(rows, y if b is None else y[_row_index(b, y.shape[0])])
    if out is not None:
        out.copy_(rows)
    return hll_ops.estimate(rows) if estimate else None


def hll_rows(x, y=None, a=None, b=None, out=None, estimate=False):
    """Row i = max(x[a_i], y[b_i]) over (., m) uint8 banks; a or b None means
    row i itself, y None means x alone.  Writes the rows to `out` (never one
    of the inputs) and/or returns their float32 estimates.  On the card the
    banks must be 4-byte aligned with m % 4 == 0; 16-byte aligned banks with
    m % 16 == 0 take the kernel's 16-byte loads and stores."""
    if out is not None and (out.data_ptr() == x.data_ptr()
                            or (y is not None and out.data_ptr() == y.data_ptr())):
        raise ValueError("hll_rows writes out of place")
    p_rows = x.shape[0] if a is None else a.shape[0]
    if y is not None and (y.shape[0] if b is None else b.shape[0]) != p_rows:
        raise ValueError("row maps and banks must give the same number of rows")
    if _route(x) == "plain":
        return hll_rows_plain(x, y, a, b, out, estimate)
    _require_cuda_operands(x, a, b)
    m = x.shape[1]
    for t in (x, y, out):
        if t is not None and (t.device != x.device or t.dtype != torch.uint8
                              or not t.is_contiguous() or t.shape[-1] != m
                              or t.data_ptr() % 4 or m % 4):
            raise ValueError("hll_rows takes contiguous 4-byte aligned uint8 banks of one width")
    if out is not None and out.shape[0] != p_rows:
        raise ValueError(f"out has {out.shape[0]} rows, want {p_rows}")
    est = torch.empty(p_rows, dtype=torch.float32, device=x.device) if estimate else None
    if p_rows == 0:
        return est
    _launch("hll_rows", _build.library("hll").rtpu_hll_rows, x,
            x.data_ptr(), x.shape[0], _ptr(y), 0 if y is None else y.shape[0],
            _ptr(a), _ptr(b), p_rows, m, _ptr(out), _ptr(est),
            hll_ops.alpha(m) * m * m)
    return est


# --------------------------------------------------------------------------
# Bloom programs (the JAX package's jitted names)
# --------------------------------------------------------------------------

def _bloom_add(plane, width, keys, n_valid, k, m, out=FLAGS):
    return plane, bloom_add(plane, width, keys, n_valid, k, m, out)


def bloom_add_u64_masked(bits, lo, hi, n_valid, k, m):
    return _bloom_add(bits, bits.shape[0], _u64_keys(lo, hi), n_valid, k, m)


def bloom_contains_u64_masked(bits, lo, hi, n_valid, k, m):
    return bloom_probe(bits, bits.shape[0], _u64_keys(lo, hi), n_valid, k, m)


def bloom_add_bytes_masked(bits, words, nbytes, n_valid, k, m):
    return _bloom_add(bits, bits.shape[0], _byte_keys(words, nbytes), n_valid, k, m)


def bloom_contains_bytes_masked(bits, words, nbytes, n_valid, k, m):
    return bloom_probe(bits, bits.shape[0], _byte_keys(words, nbytes), n_valid, k, m)


def bloom_add_packed(bits, lh, n_valid, k, m):
    return bloom_add_u64_masked(bits, lh[0], lh[1], n_valid, k, m)


def bloom_add_packed_count(bits, lh, n_valid, k, m):
    return _bloom_add(bits, bits.shape[0], _u64_keys(lh[0], lh[1]), n_valid, k, m, out=COUNT)


def bloom_contains_packed(bits, lh, n_valid, k, m):
    return bloom_contains_u64_masked(bits, lh[0], lh[1], n_valid, k, m)


def bloom_contains_packed_bits(bits, lh, n_valid, k, m):
    return bloom_probe(bits, bits.shape[0], _u64_keys(lh[0], lh[1]), n_valid, k, m, out=BITS)


# multi-tenant bank: a (T, W) plane, ops carry a tenant row; the row stride
# is the PHYSICAL width W, so the same kernels serve stacked planes whose
# width exceeds the hash domain m

def bloom_bank_add_u64(bits2d, tenant, lo, hi, n_valid, k, m):
    return _bloom_add(bits2d, bits2d.shape[1], _u64_keys(lo, hi, tenant), n_valid, k, m)


def bloom_bank_contains_u64(bits2d, tenant, lo, hi, n_valid, k, m):
    return bloom_probe(bits2d, bits2d.shape[1], _u64_keys(lo, hi, tenant), n_valid, k, m)


def _tlh_keys(tlh) -> Keys:
    return _u64_keys(tlh[1], tlh[2], tlh[0])


def bloom_bank_add_packed(bits2d, tlh, n_valid, k, m):
    return _bloom_add(bits2d, bits2d.shape[1], _tlh_keys(tlh), n_valid, k, m)


def bloom_bank_add_packed_count(bits2d, tlh, n_valid, k, m):
    return _bloom_add(bits2d, bits2d.shape[1], _tlh_keys(tlh), n_valid, k, m, out=COUNT)


def bloom_bank_add_packed_bits(bits2d, tlh, n_valid, k, m):
    return _bloom_add(bits2d, bits2d.shape[1], _tlh_keys(tlh), n_valid, k, m, out=BITS)


def bloom_bank_contains_packed(bits2d, tlh, n_valid, k, m):
    return bloom_probe(bits2d, bits2d.shape[1], _tlh_keys(tlh), n_valid, k, m)


def bloom_bank_contains_packed_bits(bits2d, tlh, n_valid, k, m):
    return bloom_probe(bits2d, bits2d.shape[1], _tlh_keys(tlh), n_valid, k, m, out=BITS)


def window_from_unique(uniq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(U, 3, Bb) unique flushes + (R,) window slots -> (3, R*Bb), flush i at
    [i*Bb, (i+1)*Bb).  Only copies rows, so it stays torch ops."""
    return uniq.index_select(0, idx).transpose(0, 1).reshape(uniq.shape[1], -1)


def bloom_fused_add_contains(bits, add_lh, n_add, probe_lh, n_probe, k, m):
    """Add one batch, then probe another on the same plane: the probes see
    the adds (stream order)."""
    bits, newly = bloom_add_packed(bits, add_lh, n_add, k, m)
    return bits, newly, bloom_contains_packed(bits, probe_lh, n_probe, k, m)


def bloom_fused_add_contains_bits(bits, add_lh, n_add, probe_lh, n_probe, k, m):
    width = bits.shape[0]
    bits, newly = _bloom_add(bits, width, _u64_keys(add_lh[0], add_lh[1]), n_add, k, m, out=BITS)
    return bits, newly, bloom_contains_packed_bits(bits, probe_lh, n_probe, k, m)


# --------------------------------------------------------------------------
# HLL programs
# --------------------------------------------------------------------------

def hll_add_u64(regs, lo, hi, n_valid, p):
    hll_add(regs, regs.shape[-1], _u64_keys(lo, hi), n_valid, p)
    return regs


def hll_bank_add_u64(regs2d, tenant, lo, hi, n_valid, p):
    hll_add(regs2d, regs2d.shape[1], _u64_keys(lo, hi, tenant), n_valid, p)
    return regs2d


def hll_bank_add_packed(regs2d, tlh, n_valid, p):
    hll_add(regs2d, regs2d.shape[1], _tlh_keys(tlh), n_valid, p)
    return regs2d


def hll_add_packed(regs, lh, n_valid, p):
    return hll_add_u64(regs, lh[0], lh[1], n_valid, p)


def hll_add_bytes(regs, words, nbytes, n_valid, p):
    hll_add(regs, regs.shape[-1], _byte_keys(words, nbytes), n_valid, p)
    return regs


def hll_bank_merge_map(regs2d, src_map):
    """new[r] = max(old[r], old[src_map[r]]), as a new bank."""
    out = torch.empty_like(regs2d)
    hll_rows(regs2d, regs2d, None, src_map, out)
    return out


def hll_bank_merge_map_from(regs2d, src_bank, src_map):
    """new[r] = max(regs2d[r], src_bank[src_map[r]]), as a new bank: rounds
    >= 2 of a duplicate-dst merge read the pre-call snapshot `src_bank`."""
    out = torch.empty_like(regs2d)
    hll_rows(regs2d, src_bank, None, src_map, out)
    return out


def hll_merge(a, b):
    """PFMERGE of two counters into a new one."""
    out = torch.empty_like(a)
    hll_rows(a.view(1, -1), b.view(1, -1), out=out.view(1, -1))
    return out


def hll_estimate(regs):
    """float32 estimate of one (m,) counter (0-d) or of each row of a bank."""
    if regs.dim() == 1:
        return hll_rows(regs.view(1, -1), estimate=True)[0]
    return hll_rows(regs, estimate=True)


def hll_estimate_union(a, b):
    return hll_rows(a.view(1, -1), b.view(1, -1), estimate=True)[0]


def hll_bank_estimate_union_pairs(regs2d, a, b):
    return hll_rows(regs2d, regs2d, a, b, estimate=True)


# --------------------------------------------------------------------------
# BitSet programs (RedissonBitSet surface)
# --------------------------------------------------------------------------

def _bitset_operands(bits, idx) -> None:
    _require_cuda_operands(bits, idx)
    if bits.dtype != torch.uint8 or bits.dim() != 1:
        raise ValueError("bit planes are 1-D uint8")


def _bit_lanes(bits, idx, lo: Optional[int]):
    """Indexes as bt.get_bits/set_bits take them: with a shard window, the
    lane in the shard that holds bits [lo, lo + size), or `size` (reads 0,
    never written) where another shard holds it."""
    if lo is None:
        return idx
    local = idx.to(torch.int64) - lo
    return torch.where((local >= 0) & (local < bits.shape[0]), local, bits.shape[0])


def bitset_get_plain(bits, idx, lo=None):
    return bt.get_bits(bits, _bit_lanes(bits, idx, lo))


def bitset_get(bits, idx, lo=None):
    """GETBIT batch: uint8 lane of every index of the int32 `idx`; an index
    in [-size, -1] counts from the end, any other outside the plane reads 0.
    With `lo` the plane is one shard's bits [lo, lo + size) and another
    shard's index reads 0."""
    if _route(bits) == "plain":
        return bitset_get_plain(bits, idx, lo)
    _bitset_operands(bits, idx)
    out = torch.empty(idx.shape, dtype=torch.uint8, device=bits.device)
    if idx.numel():
        _launch("bitset_get", _build.library("bitset").rtpu_bitset_get, bits,
                bits.data_ptr(), bits.numel(), idx.data_ptr(), idx.numel(), _window(lo),
                out.data_ptr())
        _count_window("bitset_get", lo)
    return out


def bitset_set_plain(bits, idx, n_valid, value, lo=None):
    valid = _valid(idx.shape[0], n_valid, bits.device)
    # masked ops index past every plane (int64, so no wrap brings them back)
    safe = torch.where(valid, _bit_lanes(bits, idx, lo).to(torch.int64), bits.shape[0])
    old = bt.get_bits(bits, safe)
    bt.set_bits(bits, safe, int(value))
    return bits, old


def bitset_set(bits, idx, n_valid, value, lo=None):
    """SETBIT batch, in place: every op < n_valid reports the bit its index
    held before the batch and stores `value` (0 or 1); returns (bits, old
    uint8 per op, 0 for masked and out-of-range ops).  With `lo`, a shard's
    window as in bitset_get: another shard's index reads 0, writes nothing."""
    if _route(bits) == "plain":
        return bitset_set_plain(bits, idx, n_valid, value, lo)
    _bitset_operands(bits, idx)
    if idx.dim() != 1:
        raise ValueError("bitset_set takes a 1-D index batch")
    old = torch.empty(idx.shape, dtype=torch.uint8, device=bits.device)
    if idx.numel():
        _launch("bitset_set", _build.library("bitset").rtpu_bitset_set, bits,
                bits.data_ptr(), bits.numel(), idx.data_ptr(), idx.numel(),
                max(0, min(int(n_valid), idx.numel())), int(bool(value)), _window(lo),
                old.data_ptr())
        _count_window("bitset_set", lo)
    return bits, old


# csrc/bitset.cu's table form: a group is 32 bytes (the plane's address and
# size, its first op, op count, live ops and value)
BITSET_GROUP_WORDS = 8


def bitset_groups_plain(planes, idx, counts, values):
    """bitset_groups' plain version: group g, ops idx[first_g : first_g +
    counts[g]] of the int32 `idx` (groups in order), reads planes[g]
    (values[g] None) or sets values[g] there; (uint8 replies in group
    order, first op of each group)."""
    out = torch.empty(idx.shape, dtype=torch.uint8, device=idx.device)
    firsts, off = [], 0
    for plane, n, value in zip(planes, counts, values):
        ops = idx[off : off + n]
        out[off : off + n] = (bitset_get_plain(plane, ops) if value is None
                              else bitset_set_plain(plane, ops, n, value)[1])
        firsts.append(off)
        off += n
    return out, firsts


def bitset_pack(buf, spans, idx, values):
    """Fill `buf` (int32, BITSET_GROUP_WORDS a group + 2 a op) with
    csrc/bitset.cu's table form of the groups: the gets' groups first, then
    the sets', each launch's groups and ops one contiguous run.  buf holds
    the table (a row of int64 a group: plane address, plane size, first op
    within its launch | op count << 32, live ops | value << 32), the int32
    indexes, then each op's group within its launch.  spans[g] is group g's
    (plane address, size).  Returns (firsts: group g's first op in the
    replies, get groups, get ops, the largest set group's ops)."""
    counts = [int(a.shape[0]) for a in idx]
    total = sum(counts)
    n_groups = len(spans)
    table = buf[: BITSET_GROUP_WORDS * n_groups].view(np.int64).reshape(n_groups, 4)
    ops, gids = buf[BITSET_GROUP_WORDS * n_groups:][:total], buf[BITSET_GROUP_WORDS * n_groups:][total:]
    order = [g for g, v in enumerate(values) if v is None] + [g for g, v in enumerate(values) if v is not None]
    n_get_groups = len(order) - sum(v is not None for v in values)
    firsts = [0] * n_groups
    at = n_get = max_set = 0
    for row, g in enumerate(order):
        n, value = counts[g], values[g]
        if value is None:
            first, gid, code = at, row, 0
        else:
            first, gid, code = at - n_get, row - n_get_groups, int(bool(value))
            max_set = max(max_set, n)
        table[row] = (spans[g][0], spans[g][1], first | (n << 32), n | (code << 32))
        ops[at : at + n] = idx[g]
        gids[at : at + n] = gid
        firsts[g] = at
        at += n
        if value is None:
            n_get = at
    return firsts, n_get_groups, n_get, max_set


def _bitset_table_shape(planes, idx, values) -> None:
    if not planes or len(idx) != len(planes) or len(values) != len(planes):
        raise ValueError("bitset_groups takes at least one group, one plane and value each")


class BitsetLevel(NamedTuple):
    """A table of bit-set groups on the card (bitset_stage): the upload,
    each group's first reply, the get groups and ops, the largest set
    group's ops and the ops in all."""
    staged: torch.Tensor
    firsts: list
    n_get_groups: int
    n_get: int
    max_set: int
    total: int


def bitset_stage(planes, idx, values, pool=None) -> BitsetLevel:
    """bitset_groups' one upload: the checked groups packed by bitset_pack
    and copied to the planes' card (through `pool`'s pinned slots when
    given)."""
    _bitset_table_shape(planes, idx, values)
    device = planes[0].device
    for p in planes:
        if p.device != device or p.dtype != torch.uint8 or p.dim() != 1 or not p.is_contiguous():
            raise ValueError("bit planes are 1-D contiguous uint8 on one card")
    spans = sorted((p.data_ptr(), p.numel()) for p in planes)
    if any(a + n > b for (a, n), (b, _) in zip(spans, spans[1:])):
        raise ValueError("bitset_groups' planes must not overlap")
    total = sum(int(a.shape[0]) for a in idx)
    if total >= 2**31:
        raise ValueError("bitset_groups takes fewer than 2**31 ops a call")
    words = BITSET_GROUP_WORDS * len(planes) + 2 * total
    if pool is None:
        buf, slot = np.zeros(words, np.int32), None
    else:
        buf, slot = pool.acquire((words,), np.int32)
    try:
        layout = bitset_pack(buf, [(p.data_ptr(), p.numel()) for p in planes], idx, values)
        staged = stage(buf, device, non_blocking=pool is not None)
    except BaseException:
        if pool is not None:
            pool.release(slot)
        raise
    if pool is not None:
        pool.commit(slot, ioplane.record_event(device))
    return BitsetLevel(staged, *layout, total)


def bitset_launch(planes, level: BitsetLevel) -> torch.Tensor:
    """The launches of a staged table on its planes: one bitset_get for its
    get groups, one bitset_set for its set groups; the uint8 replies."""
    out = torch.empty(level.total, dtype=torch.uint8, device=planes[0].device)
    lib = _build.library("bitset")
    n_groups = len(level.firsts)
    base = level.staged.data_ptr()
    ops = base + 4 * BITSET_GROUP_WORDS * n_groups
    gids = ops + 4 * level.total
    if level.n_get_groups:
        _launch("bitset_get", lib.rtpu_bitset_get_groups, planes[0], base, level.n_get_groups, ops, gids,
                level.n_get, out.data_ptr())
    if level.n_get_groups < n_groups:
        sets = base + 4 * BITSET_GROUP_WORDS * level.n_get_groups
        _launch("bitset_set", lib.rtpu_bitset_set_groups, planes[0], sets, n_groups - level.n_get_groups,
                level.max_set, ops + 4 * level.n_get, gids + 4 * level.n_get, level.total - level.n_get,
                out.data_ptr() + level.n_get)
    return out


def bitset_groups(planes, idx, values, pool=None):
    """GETBIT and SETBIT groups on distinct planes in one upload and at most
    one bitset_get and one bitset_set launch: group g reads planes[g] at its
    host int32 indexes idx[g] (values[g] None) or sets values[g] (0 or 1)
    there, every old bit of a group read before any of its writes.  Returns
    (uint8 replies, firsts): group g's at [firsts[g], firsts[g] + len(idx[g])).
    On CPU planes, bitset_groups_plain (replies in group order)."""
    _bitset_table_shape(planes, idx, values)
    if _route(planes[0]) == "plain":
        counts = [int(a.shape[0]) for a in idx]
        return bitset_groups_plain(planes, torch.from_numpy(np.concatenate(idx).astype(np.int32)), counts, values)
    level = bitset_stage(planes, idx, values, pool)
    return bitset_launch(planes, level), level.firsts


bitset_popcount = bt.popcount
bitset_and = bt.bit_and
bitset_or = bt.bit_or
bitset_xor = bt.bit_xor
bitset_not = bt.bit_not
bitset_bitpos = bt.bitpos
bitset_length = bt.length_hint


# --------------------------------------------------------------------------
# Word count (MapReduce device path, BASELINE config 4)
#
# A word is keyed by two 32-bit polynomial hashes of its bytes b+1 weighted
# A**min(j,63) and B**min(j,63) (j: the byte's place in the word), mixed with
# its length; words longer than 63 bytes that share a 63-byte prefix, a
# length and the sum of their other bytes collide (the JAX package's
# documented bound).  Buffers hold text with whitespace normalised to 0x20.
# --------------------------------------------------------------------------

WC_POW = 64
WC_POW_A, WC_POW_B = 0x01000193, 40503  # FNV-32 prime, and the second base
WC_LEN_A, WC_LEN_B = 2654435761, 0x9E3779B9
WC_SENTINEL = 0xFFFFFFFF
WC_BIG = 0x7FFFFFFF
# csrc/wordcount.cu kTile: rows (or bytes) a block of its scans takes
WC_TILE = 4096


def _wc_pow_table(p: int) -> torch.Tensor:
    out, v = [], 1
    for _ in range(WC_POW):
        out.append(v)
        v = (v * p) & H.M32
    return torch.tensor(out, dtype=torch.int64)


_WC_TABLE_A, _WC_TABLE_B = _wc_pow_table(WC_POW_A), _wc_pow_table(WC_POW_B)


def _wc_tiles(n: int) -> int:
    return (n + WC_TILE - 1) // WC_TILE


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 its low 32 bits hold, as int64."""
    return ((x + 2**31) & H.M32) - 2**31


def _wc_prelude_plain(buf):
    """Per byte: the last whitespace at or before it, and the two prefix
    sums mod 2**32 of the weighted bytes (the JAX program's scan)."""
    n = buf.numel()
    idx = torch.arange(n, dtype=torch.int64, device=buf.device)
    ws = buf == 32
    last_ws = torch.cummax(torch.where(ws, idx, -1), 0).values
    cap = (idx - last_ws - 1).clamp(max=WC_POW - 1)
    b1 = buf.to(torch.int64) + 1
    zero = torch.zeros((), dtype=torch.int64, device=buf.device)
    ca = torch.where(ws, zero, (b1 * _WC_TABLE_A.to(buf.device)[cap]) & H.M32)
    cb = torch.where(ws, zero, (b1 * _WC_TABLE_B.to(buf.device)[cap]) & H.M32)
    return last_ws, torch.cumsum(ca, 0) & H.M32, torch.cumsum(cb, 0) & H.M32


def _wc_gather_plain(buf, e, valid, base: int):
    """Each row's (ha, hb, start) from its end e, as int32 bits; rows not
    valid hold the sentinel.  e is read as JAX's gather reads it."""
    n = buf.numel()
    last_ws, cum_a, cum_b = _wc_prelude_plain(buf)
    g = torch.where(e < 0, e + n, e).clamp(0, n - 1)
    lw = last_ws[g]
    prev = lw.clamp(min=0)
    ha = (cum_a[g] - torch.where(lw >= 0, cum_a[prev], 0)) & H.M32
    hb = (cum_b[g] - torch.where(lw >= 0, cum_b[prev], 0)) & H.M32
    ln = (e - lw) & H.M32
    ha = ha ^ ((ln * WC_LEN_A) & H.M32)
    hb = (hb + ln * WC_LEN_B) & H.M32
    start = (lw + 1 + (base & H.M32)) & H.M32
    return tuple(_to_int32_bits(torch.where(valid, x, WC_SENTINEL)) for x in (ha, hb, start))


def _wc_check_buf(buf) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("word-count buffers are 1-D uint8")
    if not 1 <= buf.numel() < 2**31:
        raise ValueError(f"a word-count buffer holds 1 to 2**31 - 1 bytes, got {buf.numel()}")


def wc_extract_words_plain(buf, end_deltas, n_words: int, base: int):
    n = buf.numel()
    ends = _wrap_i32(_wrap_i32(torch.cumsum(end_deltas.to(torch.int64), 0)) - 1)
    valid = torch.arange(end_deltas.numel(), device=buf.device) < n_words
    e = torch.where(valid, ends.clamp(max=n - 1), 0)
    return _wc_gather_plain(buf, e, valid, base)


def wc_extract_words_auto_plain(buf, n_words: int, eb: int, base: int):
    n = buf.numel()
    ws = buf == 32
    following = torch.cat([ws[1:], torch.ones(1, dtype=torch.bool, device=buf.device)])
    found = torch.nonzero(~ws & following).reshape(-1)[:eb]
    ends = torch.full((eb,), n - 1, dtype=torch.int64, device=buf.device)
    ends[: found.numel()] = found
    valid = torch.arange(eb, device=buf.device) < n_words
    return _wc_gather_plain(buf, torch.where(valid, ends, 0), valid, base)


# The per-(device, stream) state of wc_words, segment_reduce and knn_select.
# Server worker threads launch these kernels concurrently: under this lock
# two calls never take the same tag, and a state is never replaced while
# another thread is between taking it and launching on it.
_state_lock = threading.Lock()
_tagged_states: dict = {}


def _tagged_state(kernel: str, device, words: int, dtype=torch.int64, stream=None):
    """The state `kernel`'s calls on this device and stream share (a ticket
    word, then words that carry the tag of the call that wrote them), and
    this call's tag.  A word of another tag is not yet written, so the state
    is zeroed only when it is made (or the tags wrap); every call leaves the
    ticket at 0.  `stream` defaults to the device's current stream."""
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    key = (kernel, device, stream)
    with _state_lock:
        state = _tagged_states.get(key)
        if state is None or state[0].numel() < words:
            state = _tagged_states[key] = [torch.zeros(words, dtype=dtype, device=device), 0]
        state[1] += 1
        if state[1] >= 2**31:
            state[0].zero_()
            state[1] = 1
        return state[0], state[1]


def _wc_rows(buf, rows: int, out, at: int):
    """The three (rows,) int32 outputs: new tensors, or rows [at, at + rows)
    of the caller's three (out)."""
    if out is None:
        return [torch.empty(rows, dtype=torch.int32, device=buf.device) for _ in range(3)]
    if len(out) != 3 or any(t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                            or t.device != buf.device for t in out):
        raise ValueError(f"out: three contiguous 1-D int32 tensors on the buffer's {buf.device}")
    if at < 0 or any(at + rows > t.numel() for t in out):
        raise ValueError(f"rows [{at}, {at + rows}) past out's {min(t.numel() for t in out)} rows")
    return [t[at: at + rows] for t in out]


def _wc_launch(buf, deltas, rows: int, n_words: int, base: int, out=None, at: int = 0):
    _wc_check_buf(buf)
    if not buf.is_contiguous():
        raise ValueError("word-count buffers must be contiguous")
    dev = buf.device
    res = _wc_rows(buf, rows, out, at)
    if rows == 0:
        return tuple(res)  # nothing to write: no launch
    n_words = max(-1, min(int(n_words), rows))
    lib = _build.library("wordcount")
    if deltas is None:
        region, tag = _tagged_state("wc_words", dev, lib.rtpu_wc_words_region_words(buf.numel()))
        _launch("wc_words", lib.rtpu_wc_words_auto, buf, buf.data_ptr(), buf.numel(), rows, n_words,
                int(base) & H.M32, region.data_ptr(), tag, *(t.data_ptr() for t in res))
        return tuple(res)
    if deltas.device != dev or deltas.dim() != 1:
        raise ValueError(f"deltas: 1-D on the buffer's {dev}, got {tuple(deltas.shape)} on {deltas.device}")
    deltas = deltas.to(torch.int32).contiguous()
    scratch = torch.empty(_wc_tiles(rows) + 1, dtype=torch.int32, device=dev)
    ends = torch.empty(rows + 1, dtype=torch.int32, device=dev)
    _launch("wc_words", lib.rtpu_wc_words_deltas, buf, buf.data_ptr(), buf.numel(), deltas.data_ptr(), rows,
            n_words, int(base) & H.M32, scratch.data_ptr(), ends.data_ptr(), *(t.data_ptr() for t in res))
    return tuple(res)


def _wc_plain_into(got, buf, rows: int, out, at: int):
    if out is None:
        return got
    res = _wc_rows(buf, rows, out, at)
    for r, g in zip(res, got):
        r.copy_(g)
    return tuple(res)


def wc_extract_words(buf, end_deltas, n_words: int, base: int):
    """buf: (N,) uint8 text, whitespace normalised to 0x20; end_deltas: (E,)
    integer deltas of the word ends (ends = cumsum(deltas) - 1, int32);
    n_words: the real words; base: the chunk's offset in the whole text.
    Returns (ha, hb, start), each (E,) int32 holding uint32 bits; rows at or
    past n_words hold 0xFFFFFFFF, so they sort after every real word."""
    if _route(buf) == "plain":
        _wc_check_buf(buf)
        return wc_extract_words_plain(buf, end_deltas, n_words, base)
    return _wc_launch(buf, end_deltas, end_deltas.numel(), n_words, base)


def wc_extract_words_auto(buf, n_words: int, eb: int, base: int, out=None, at: int = 0):
    """wc_extract_words with the ends found on the card: every non-space
    byte followed by a space (the last byte counts as followed by one), in
    ascending order, the first eb of them; eb <= N.  The buffer may start
    at any byte (a slice of a larger one).  With out (three 1-D int32
    tensors of a whole stream), the rows land in rows [at, at + eb) of them
    and those views are returned."""
    _wc_check_buf(buf)
    if not 0 <= eb <= buf.numel():
        raise ValueError(f"eb = {eb}: the auto form returns at most N = {buf.numel()} rows")
    if _route(buf) == "plain":
        return _wc_plain_into(wc_extract_words_auto_plain(buf, n_words, eb, base), buf, eb, out, at)
    return _wc_launch(buf, None, eb, n_words, base, out, at)


def _wc_sort_operands(ha, hb, start) -> int:
    n = ha.numel()
    if not (ha.shape == hb.shape == start.shape == (n,)):
        raise ValueError("wc_sort_runs takes three 1-D tensors of one length")
    if not 1 <= n < 2**31:
        raise ValueError(f"wc_sort_runs takes 1 to 2**31 - 1 rows, got {n}")
    return n


def wc_sort_runs_plain(ha, hb, start, d_max: int):
    n = _wc_sort_operands(ha, hb, start)
    # the unsigned key (ha:hb) in signed order: flip its top bit
    key = ((H.lanes(ha) << 32) | H.lanes(hb)) ^ (-(2**63))
    key, perm = torch.sort(key, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=ha.device)
    first[1:] = key[1:] != key[:-1]
    idx = torch.arange(n, dtype=torch.int32, device=ha.device)
    fp, perm2 = torch.sort(torch.where(first, idx, WC_BIG), stable=True)
    d = min(n, d_max)
    return torch.stack([fp[:d], start.to(torch.int32)[perm][perm2][:d]])


def wc_sort_runs(ha, hb, start, d_max: int):
    """Count words by sorting: a stable sort of the rows by the unsigned
    64-bit key (ha:hb), then every run's first row (its index, its start) in
    index order, then the other rows as (0x7FFFFFFF, start) in sorted order.
    Returns the first min(N, d_max) rows as (2, min(N, d_max)) int32, the
    starts as uint32 bits."""
    if _route(ha) == "plain":
        return wc_sort_runs_plain(ha, hb, start, d_max)
    n = _wc_sort_operands(ha, hb, start)
    _require_cuda_operands(ha, hb, start)
    d = min(n, int(d_max))
    if d < 0:
        raise ValueError(f"d_max = {d_max}")
    lib = _build.library("wordcount")
    region_bytes = lib.rtpu_wc_sort_region_bytes(n)  # the look-back's zeroed scratch
    dev = ha.device
    keys = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
    vals = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    region = torch.empty(region_bytes, dtype=torch.uint8, device=dev)
    scan = torch.empty(_wc_tiles(n) + 1, dtype=torch.int32, device=dev)
    out = torch.empty((2, d), dtype=torch.int32, device=dev)
    _launch("wc_sort_runs", lib.rtpu_wc_sort_runs, ha,
            ha.data_ptr(), hb.data_ptr(), start.data_ptr(), n, d, keys[0].data_ptr(),
            vals[0].data_ptr(), keys[1].data_ptr(), vals[1].data_ptr(), region.data_ptr(),
            scan.data_ptr(), out.data_ptr())
    return out


# --------------------------------------------------------------------------
# KernelMapReduce's segment reduction
# --------------------------------------------------------------------------

SEGMENT_OPS = ("sum", "max", "min")


def _segment_identity(dtype, reduce: str):
    if reduce == "sum":
        return 0
    if dtype.is_floating_point:
        return -float("inf") if reduce == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "max" else info.max


def segment_reduce_plain(keys, vals, n_keys: int, reduce: str):
    k = keys.to(torch.int64)
    k = torch.where(k < 0, k + n_keys, k)
    keep = (k >= 0) & (k < n_keys)
    k, v = k[keep], vals[keep]
    if reduce == "sum" and not vals.dtype.is_floating_point:
        acc = torch.zeros(n_keys, dtype=torch.int64, device=vals.device).index_add_(0, k, v.to(torch.int64))
        bits = torch.iinfo(vals.dtype).bits
        if bits < 64:  # the sum wraps in the values' width, as JAX's does
            acc = ((acc + 2 ** (bits - 1)) & (2**bits - 1)) - 2 ** (bits - 1)
        return acc.to(vals.dtype)
    out = torch.full((n_keys,), _segment_identity(vals.dtype, reduce), dtype=vals.dtype, device=vals.device)
    if reduce == "sum":
        return out.index_add_(0, k, v)
    return out.index_reduce_(0, k, v, "amax" if reduce == "max" else "amin", include_self=True)


def segment_reduce(keys, vals, n_keys: int, reduce: str = "sum"):
    """(n_keys,) reduction of vals by key, as JAX's
    ``init.at[keys].add/max/min(vals)``: sum starts from 0, max from the
    type's least value (or -inf), min from its greatest (or +inf); a key in
    [-n_keys, 0) counts from the end once, any other key outside [0, n_keys)
    is dropped.  The card takes int32 or float32 values and int32 or int64
    keys (other integer keys are widened to int64); a float32 sum there adds
    in atomic order, so it matches a sequential sum only to rounding."""
    if reduce not in SEGMENT_OPS:
        raise ValueError(f"unsupported reduce {reduce!r}")
    if n_keys < 1:
        raise ValueError(f"n_keys = {n_keys}")
    if keys.shape != vals.shape or keys.dim() != 1:
        raise ValueError("segment_reduce takes 1-D keys and values of one length")
    if keys.dtype.is_floating_point or keys.dtype.is_complex or keys.dtype == torch.bool:
        raise ValueError(f"keys must be integers, got {keys.dtype}")
    if _route(vals) == "plain":
        return segment_reduce_plain(keys, vals, n_keys, reduce)
    if vals.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"the segment_reduce kernel takes int32 or float32 values, got {vals.dtype}")
    if keys.dtype not in (torch.int32, torch.int64):
        keys = keys.to(torch.int64)
    if keys.device != vals.device:
        raise ValueError(f"keys on {keys.device}, values on {vals.device}")
    keys, vals = keys.contiguous(), vals.contiguous()
    out = torch.empty(n_keys, dtype=vals.dtype, device=vals.device)
    # the clusters' ticket, and the tag of the call whose first cluster has
    # written out
    state, tag = _tagged_state("segment_reduce", vals.device, 2, torch.int32)
    _launch("segment_reduce", _build.library("segment").rtpu_segment_reduce, vals,
            keys.data_ptr(), keys.element_size(), vals.data_ptr(), int(vals.dtype == torch.float32),
            SEGMENT_OPS.index(reduce), vals.numel(), n_keys, state.data_ptr(), tag, out.data_ptr())
    return out


def segment_shared_keys(device) -> int:
    """The most keys segment_reduce reduces in one launch on `device` (a
    block's copy of the result in shared memory); past it, two launches."""
    with torch.cuda.device(device):
        return int(_build.library("segment").rtpu_segment_shared_keys())


# --------------------------------------------------------------------------
# Vector search (FT VECTOR FLAT and IVF): KNN scoring, top-k selection, the
# IVF candidate scoring and k-means.  Distances are lower-is-better: L2 the
# squared euclidean (|q|^2 - 2 q.b) + |b|^2, COSINE 1 - cos (1 where a norm
# is 0), IP 1 - q.b.  Rows at or past n_rows and rows whose bias is +inf
# never reach a top-k; the k kept are the smallest by (distance, position),
# so ties go to the lower position, as lax.top_k's stable order gives them.
# The products are exact float32 (no TF32) on both routes.
# --------------------------------------------------------------------------

KNN_METRICS = ("L2", "COSINE", "IP")
_BANK_TYPES = {torch.float32: 0, torch.float16: 1, torch.int8: 2}
# csrc/knn.cu's knn_select: keys a round selects at most (kRound); the
# longest row that takes one warp (kSmallCols); the fewest columns of a
# block's segment; the keys a row's last block merges at most (kPool:
# segments x min(k, 256)); the blocks a call aims at for each SM (about one
# wave of resident blocks: more, shorter segments were slower on the H100)
SELECT_ROUND, SELECT_SMALL, SELECT_SEG_MIN, SELECT_POOL, SELECT_BLOCKS_PER_SM = 256, 2048, 16384, 4096, 3


def _bank_f32(bank, scale):
    """FLOAT16 rows, and INT8 rows times their per-row scale, as float32."""
    if bank.dtype == torch.float32:
        return bank
    rows = bank.to(torch.float32)
    if scale is not None:
        rows = rows * scale[..., None]
    return rows


def _metric_plain(dots, q_sq, b_sq, metric: str):
    if metric == "L2":
        return q_sq - 2.0 * dots + b_sq
    if metric == "COSINE":
        denom = torch.sqrt(q_sq) * torch.sqrt(b_sq)
        return 1.0 - torch.where(denom > 0.0, dots / denom, 0.0)
    return 1.0 - dots


def knn_score_plain(bank, scale, bias, qbias, q, n_rows: int, metric: str):
    rows = _bank_f32(bank, scale)
    dots = q @ rows.T
    dist = _metric_plain(dots, (q * q).sum(1)[:, None], (rows * rows).sum(1)[None, :], metric)
    if bias is not None:
        dist = dist + bias[None, :]
    live = torch.arange(bank.shape[0], device=bank.device) < n_rows
    dist = torch.where(live[None, :], dist, torch.inf)
    return dist if qbias is None else dist + qbias


def _check_f32(name: str, t, shape, device) -> None:
    if t is None:
        return
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: float32 {tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _bank_operands(bank, scale, bias, q, metric: str) -> None:
    if bank.dim() != 2 or bank.dtype not in _BANK_TYPES:
        raise ValueError(f"a bank is (C, W) float32, float16 or int8, got {bank.dtype} {tuple(bank.shape)}")
    if metric not in KNN_METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if q.dim() != 2 or q.shape[1] != bank.shape[1]:
        raise ValueError(f"queries (Q, {bank.shape[1]}), got {tuple(q.shape)}")
    _check_f32("q", q, q.shape, bank.device)
    _check_f32("scale", scale, (bank.shape[0],), bank.device)
    _check_f32("bias", bias, (bank.shape[0],), bank.device)


def _contig(t):
    return None if t is None else t.contiguous()


# csrc/knn.cu's two designs of knn_score: the tile route (tile_dots), and
# the streamed route with element loads or with 16-byte copies (rows of a
# multiple of 16 bytes on a 16-byte aligned bank), which takes W <= 256
KNN_TILE, KNN_STREAM_ELEMS, KNN_STREAM_VEC = 0, 1, 2
KNN_STREAM_MAX_W = 256
KNN_NARROW_ROWS = 16384  # csrc/knn.cu kNarrowRows


def knn_score_route(bank, q) -> int:
    """The knn_score design for a bank (C, W) and queries (Q, W): the tile
    route for rows wider than 256 and for more than 8 queries against a
    narrow bank of at most 16,384 rows (the IVF route's centroids: a few
    streamed tiles leave most SMs idle); the streamed route otherwise, with
    16-byte copies where the rows and the bank's base allow them."""
    c, w = bank.shape
    if w > KNN_STREAM_MAX_W or (c <= KNN_NARROW_ROWS and q.shape[0] > 8):
        return KNN_TILE
    aligned = (w * bank.element_size()) % 16 == 0 and bank.data_ptr() % 16 == 0
    return KNN_STREAM_VEC if aligned else KNN_STREAM_ELEMS


def knn_score(bank, scale, bias, qbias, q, n_rows: int, metric: str, route: Optional[int] = None):
    """(Q, C) float32 distances of the queries q (Q, W) float32 to the rows
    of bank (C, W) float32, float16 or int8 (times scale (C,) when given),
    plus bias (C,) when given, +inf from row n_rows on, plus qbias (Q, C)
    when given (0 keeps a row, +inf drops it).  route: the card's design
    (KNN_TILE, KNN_STREAM_ELEMS or KNN_STREAM_VEC), knn_score_route's by
    default."""
    _bank_operands(bank, scale, bias, q, metric)
    _check_f32("qbias", qbias, (q.shape[0], bank.shape[0]), bank.device)
    if _route(bank) == "plain":
        return knn_score_plain(bank, scale, bias, qbias, q, n_rows, metric)
    c, w = bank.shape
    out = torch.empty((q.shape[0], c), dtype=torch.float32, device=bank.device)
    bank, scale, bias, qbias, q = (_contig(t) for t in (bank, scale, bias, qbias, q))
    _launch("knn_score", _build.library("knn").rtpu_knn_score, bank,
            bank.data_ptr(), _BANK_TYPES[bank.dtype], _ptr(scale), _ptr(bias), _ptr(qbias),
            q.data_ptr(), c, w, q.shape[0], max(0, min(int(n_rows), c)), KNN_METRICS.index(metric),
            knn_score_route(bank, q) if route is None else route, out.data_ptr())
    return out


def _order_keys(dist):
    """int64 keys ordering (dist, column) as the kernel's unsigned 64-bit
    key does: the float's bits mapped to an unsigned order (negative floats
    flipped, positive ones with the top bit set), less 2**31 so it stays
    signed, over the column."""
    bits = dist.contiguous().view(torch.int32).to(torch.int64)
    u = bits & H.M32
    order = torch.where(u >= 2**31, ~u & H.M32, u | 2**31)
    col = torch.arange(dist.shape[1], dtype=torch.int64, device=dist.device)
    return ((order - 2**31) << 32) | col


def knn_select_plain(dist, k: int, ids=None):
    key, _ = torch.topk(_order_keys(dist), k, dim=1, largest=False, sorted=True)
    pos = key & H.M32
    vals = dist.gather(1, pos)
    idx = pos.to(torch.int32) if ids is None else ids.gather(1, pos)
    return vals, idx


class SelectPlan(NamedTuple):
    """How csrc/knn.cu's knn_select splits a call: segs 0 takes one warp a
    row; segs > 0 gives each row segs blocks of seg_len columns (segment s
    covers [s seg_len, min(n, (s + 1) seg_len)), none empty).  scratch_words:
    the int64 words of the per-call scratch (the segments' lists, then each
    row's last key of a round); state_words: those of the state the calls
    share (each row's bound and ticket, left reset by every call)."""
    segs: int
    seg_len: int
    scratch_words: int
    state_words: int


def knn_select_plan(r: int, n: int, k: int, sms: int = 132) -> SelectPlan:
    """The plan of a knn_select call on R x n with k: rows of at most
    SELECT_SMALL columns take one warp; longer ones as many segments as keep
    about SELECT_BLOCKS_PER_SM blocks a call on each of `sms` SMs, each at
    least SELECT_SEG_MIN columns, with segments x min(k, 256) <= SELECT_POOL."""
    kr = min(k, SELECT_ROUND)
    state = 2 * r  # a row's bound, then its ticket
    if n <= SELECT_SMALL:
        return SelectPlan(0, n, r, state)
    want = -(-SELECT_BLOCKS_PER_SM * sms // r)
    segs = max(1, min(want, n // SELECT_SEG_MIN, SELECT_POOL // kr))
    seg_len = -(-n // segs)
    seg_len += -seg_len % 4
    segs = -(-n // seg_len)
    return SelectPlan(segs, seg_len, r * segs * kr + r, state)


_select_states: dict = {}
_sm_counts: dict = {}


def _sm_count(device) -> int:
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


def _select_state(device, words: int):
    """The rows' bounds (all ones) and tickets (zero), a pair of words a
    row, that knn_select's calls on this device and stream share; every
    call leaves them so.  Made anew when a call has more rows than any
    before it."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    with _state_lock:
        state = _select_states.get(key)
        if state is None or state.numel() < words:
            state = torch.zeros(words, dtype=torch.int64, device=device)
            state[0::2] = -1
            _select_states[key] = state
        return state


def knn_select(dist, k: int, ids=None):
    """Per row of dist (R, n) float32, its k smallest entries by (value,
    column): (vals (R, k) float32, idx (R, k) int32), idx the column or,
    with ids (R, n) int32, ids[row][column].  1 <= k <= n."""
    if dist.dim() != 2 or dist.dtype != torch.float32:
        raise ValueError(f"knn_select takes a (R, n) float32 matrix, got {dist.dtype} {tuple(dist.shape)}")
    r, n = dist.shape
    if not 1 <= k <= n:
        raise ValueError(f"k = {k} for rows of {n}")
    if ids is not None and (ids.shape != dist.shape or ids.dtype != torch.int32 or ids.device != dist.device):
        raise ValueError("ids: int32 of the matrix's shape, on its device")
    if _route(dist) == "plain":
        return knn_select_plain(dist, k, ids)
    if n >= 2**31:
        raise ValueError(f"the knn_select kernel takes n < 2**31, got {n}")
    dist, ids = dist.contiguous(), _contig(ids)
    plan = knn_select_plan(r, n, k, _sm_count(dist.device))
    scratch = torch.empty(plan.scratch_words, dtype=torch.int64, device=dist.device)
    state = _select_state(dist.device, plan.state_words)
    vals = torch.empty((r, k), dtype=torch.float32, device=dist.device)
    idx = torch.empty((r, k), dtype=torch.int32, device=dist.device)
    _launch("knn_select", _build.library("knn").rtpu_knn_select, dist,
            dist.data_ptr(), n, r, k, _ptr(ids), vals.data_ptr(), idx.data_ptr(), plan.segs, plan.seg_len,
            scratch.data_ptr(), state.data_ptr())
    return vals, idx


def _sharded_merge(select, dists, idxs, shard_of_pos, k: int):
    dist_cat = torch.cat(list(dists), dim=1)
    idx_cat = torch.cat(list(idxs), dim=1)
    vals, pos = select(dist_cat.contiguous(), int(k))
    pos = pos.long()
    return vals, shard_of_pos[pos], idx_cat.gather(1, pos)


def knn_sharded_merge_plain(dists, idxs, shard_of_pos, k: int):
    return _sharded_merge(knn_select_plain, dists, idxs, shard_of_pos, k)


def knn_sharded_merge(dists, idxs, shard_of_pos, k: int):
    """The global top-k of a sharded bank's legs: dists/idxs are tuples of
    per-shard (Q, k_s) float32 / int32 top-k outputs on one device,
    shard_of_pos (sum k_s,) int32 the shard of each concatenated column.
    Concatenates the legs in order and keeps each row's k smallest by
    (distance, concatenated position) with one knn_select launch.  Returns
    (dist (Q, k) float32, shard (Q, k) int32, local index (Q, k) int32)."""
    return _sharded_merge(knn_select, dists, idxs, shard_of_pos, k)


def ivf_score_plain(bank, scale, bias, qmask, cells, probe, q, n_rows: int, metric: str):
    cand = cells[probe.long()].reshape(q.shape[0], -1)
    valid = (cand >= 0) & (cand < min(int(n_rows), bank.shape[0]))
    safe = torch.where(valid, cand, 0).long()
    rows = _bank_f32(bank[safe], None if scale is None else scale[safe])
    dots = torch.einsum("qmw,qw->qm", rows, q)
    dist = _metric_plain(dots, (q * q).sum(1)[:, None], (rows * rows).sum(2), metric)
    if bias is not None:
        dist = dist + bias[safe]
    if qmask is not None:
        dist = dist + qmask[safe]
    return torch.where(valid, dist, torch.inf), cand.to(torch.int32)


def ivf_score(bank, scale, bias, qmask, cells, probe, q, n_rows: int, metric: str):
    """The IVF candidates of each query: slot j of cell probe[r][p] (cells
    (nlist, cap) int32 row lists, probe (Q, nprobe) int32) scored against
    q row r as knn_score scores, plus bias and qmask (C,) when given; a
    negative row id or one >= n_rows (the sentinel padding) scores +inf.
    Returns (dist, ids), each (Q, nprobe * cap), in probe order then cell
    order; ids holds the slot's row id."""
    _bank_operands(bank, scale, bias, q, metric)
    _check_f32("qmask", qmask, (bank.shape[0],), bank.device)
    if cells.dim() != 2 or cells.dtype != torch.int32 or probe.dim() != 2 or probe.dtype != torch.int32:
        raise ValueError("cells (nlist, cap) and probe (Q, nprobe) are int32")
    if probe.shape[0] != q.shape[0]:
        raise ValueError(f"probe has {probe.shape[0]} rows for {q.shape[0]} queries")
    if _route(bank) == "plain":
        return ivf_score_plain(bank, scale, bias, qmask, cells, probe, q, n_rows, metric)
    _require_cuda_operands(bank, cells, probe)
    (nlist, cap), nprobe = cells.shape, probe.shape[1]
    r, (c, w) = q.shape[0], bank.shape
    out = torch.empty((r, nprobe * cap), dtype=torch.float32, device=bank.device)
    ids = torch.empty((r, nprobe * cap), dtype=torch.int32, device=bank.device)
    bank, scale, bias, qmask, q = (_contig(t) for t in (bank, scale, bias, qmask, q))
    _launch("ivf_score", _build.library("knn").rtpu_ivf_score, bank,
            bank.data_ptr(), _BANK_TYPES[bank.dtype], _ptr(scale), _ptr(bias), _ptr(qmask), q.data_ptr(),
            cells.data_ptr(), probe.data_ptr(), c, w, r, nlist, nprobe, cap, max(0, min(int(n_rows), c)),
            KNN_METRICS.index(metric), out.data_ptr(), ids.data_ptr())
    return out, ids


def knn_flat(bank, scale, bias, qbias, q, n_rows: int, k: int, metric: str):
    """FLAT KNN in every form: knn_score (scale for an INT8 bank, qbias for
    the hybrid prefilter, each None when absent), then knn_select."""
    return knn_select(knn_score(bank, scale, bias, qbias, q, n_rows, metric), k)


def knn_topk(bank, bias, q, n_rows: int, k: int, metric: str):
    """FLAT KNN: (dist (Q, k) float32, idx (Q, k) int32) of the k smallest
    distances of each query to the live rows; entries past the live rows
    carry +inf and ids that mean nothing."""
    return knn_flat(bank, None, bias, None, q, n_rows, k, metric)


def knn_topk_q(bank, scale, bias, q, n_rows: int, k: int, metric: str):
    """knn_topk over an INT8 bank: each row times its scale (C,)."""
    return knn_flat(bank, scale, bias, None, q, n_rows, k, metric)


def knn_topk_masked(bank, bias, qbias, q, n_rows: int, k: int, metric: str):
    """knn_topk with a per-query additive bias (Q, C): 0 keeps a row, +inf
    drops it (the hybrid prefilter)."""
    return knn_flat(bank, None, bias, qbias, q, n_rows, k, metric)


def knn_topk_masked_q(bank, scale, bias, qbias, q, n_rows: int, k: int, metric: str):
    return knn_flat(bank, scale, bias, qbias, q, n_rows, k, metric)


def knn_ivf(bank, scale, bias, qmask, centroids, cells, q, n_rows: int, k: int, nprobe: int, metric: str):
    """IVF KNN in every form: the route (knn_score over the centroids, then
    knn_select of nprobe), ivf_score of the probed cells (scale and qmask
    None when absent), then knn_select over the candidates."""
    route = knn_score(centroids, None, None, None, q, centroids.shape[0], metric)
    _, probe = knn_select(route, nprobe)
    dist, ids = ivf_score(bank, scale, bias, qmask, cells, probe, q, n_rows, metric)
    return knn_select(dist, k, ids)


def knn_ivf_topk(bank, bias, centroids, cells, q, n_rows: int, k: int, nprobe: int, metric: str):
    """IVF KNN: route each query to its nprobe nearest centroids (nlist, W),
    score the rows listed in those cells (cells (nlist, cap) int32, padded
    with a sentinel >= n_rows), keep the k smallest by (distance, candidate
    position: probe order, then place in the cell) and return (dist (Q, k),
    row ids (Q, k) int32); +inf entries carry ids that mean nothing."""
    return knn_ivf(bank, None, bias, None, centroids, cells, q, n_rows, k, nprobe, metric)


def knn_ivf_topk_q(bank, scale, bias, centroids, cells, q, n_rows: int, k: int, nprobe: int, metric: str):
    return knn_ivf(bank, scale, bias, None, centroids, cells, q, n_rows, k, nprobe, metric)


def knn_ivf_topk_masked(bank, bias, qmask, centroids, cells, q, n_rows: int, k: int, nprobe: int,
                        metric: str):
    """knn_ivf_topk with an additive (C,) mask: 0 keeps a row, +inf drops it."""
    return knn_ivf(bank, None, bias, qmask, centroids, cells, q, n_rows, k, nprobe, metric)


def knn_ivf_topk_masked_q(bank, scale, bias, qmask, centroids, cells, q, n_rows: int, k: int, nprobe: int,
                          metric: str):
    return knn_ivf(bank, scale, bias, qmask, centroids, cells, q, n_rows, k, nprobe, metric)


def kmeans_assign_plain(points, weights, centroids):
    d = ((points * points).sum(1)[:, None] - 2.0 * (points @ centroids.T)
         + (centroids * centroids).sum(1)[None, :])
    return torch.where(weights > 0.0, torch.argmin(d, dim=1), -1).to(torch.int32)


def kmeans_update_plain(points, weights, centroids, assign):
    live = assign >= 0
    cell = assign[live].long()
    sums = torch.zeros_like(centroids).index_add_(0, cell, (points * weights[:, None])[live])
    counts = torch.zeros(centroids.shape[0], dtype=torch.float32, device=points.device)
    counts.index_add_(0, cell, weights[live])
    return torch.where(counts[:, None] > 0.0, sums / torch.clamp(counts, min=1.0)[:, None], centroids)


def kmeans_step_plain(points, weights, centroids):
    assign = kmeans_assign_plain(points, weights, centroids)
    return kmeans_update_plain(points, weights, centroids, assign), assign


def _kmeans_operands(points, weights, centroids) -> None:
    if points.dim() != 2 or centroids.dim() != 2 or points.shape[1] != centroids.shape[1]:
        raise ValueError("points (N, W) and centroids (L, W)")
    _check_f32("points", points, points.shape, points.device)
    _check_f32("weights", weights, (points.shape[0],), points.device)
    _check_f32("centroids", centroids, centroids.shape, points.device)


# csrc/kmeans.cu's two designs of kmeans_assign: the tile route (tile_dots,
# float32 FMAs, any W) and the tensor-core route (3xTF32 on mma.sync, W <= 256)
KMEANS_TILE, KMEANS_MMA = 0, 1
KMEANS_MMA_MAX_W = 256


def kmeans_assign_route(points, centroids) -> int:
    """The kmeans_assign design for points (N, W) and centroids (L, W): the
    tensor-core route up to W 256, the tile route for wider rows."""
    return KMEANS_MMA if points.shape[1] <= KMEANS_MMA_MAX_W else KMEANS_TILE


def kmeans_assign(points, weights, centroids):
    """Each point's (N, W) float32 nearest centroid (L, W) by L2, the first
    minimum winning: (N,) int32, -1 where weights (N,) is not > 0.  On the
    card, by kmeans_assign_route's design for W."""
    _kmeans_operands(points, weights, centroids)
    if _route(points) == "plain":
        return kmeans_assign_plain(points, weights, centroids)
    (n, w), l = points.shape, centroids.shape[0]
    route = kmeans_assign_route(points, centroids)
    points, weights, centroids = points.contiguous(), weights.contiguous(), centroids.contiguous()
    assign = torch.empty(n, dtype=torch.int32, device=points.device)
    _launch("kmeans", _build.library("kmeans").rtpu_kmeans_assign, points,
            points.data_ptr(), weights.data_ptr(), centroids.data_ptr(), n, w, l, route, assign.data_ptr())
    return assign


def kmeans_update(points, weights, centroids, assign):
    """Each centroid (L, W) the weighted mean of the points (N, W) that
    assign (N,) int32 gives it (-1: none), an empty cell keeping its
    centroid.  On the card two launches: the rows bucketed by cell in row
    order a tile at a time, then one block a cell adds its bucket in that
    order, with no float atomics, so two runs give the same bits."""
    _kmeans_operands(points, weights, centroids)
    if assign.shape != (points.shape[0],) or assign.dtype != torch.int32 or assign.device != points.device:
        raise ValueError("assign: (N,) int32 on the points' device")
    if _route(points) == "plain":
        return kmeans_update_plain(points, weights, centroids, assign)
    (n, w), l = points.shape, centroids.shape[0]
    if w > 1024 or n >= 2**31 - 1:
        raise ValueError(f"the kmeans kernel takes W <= 1024 and N < 2**31 - 1, got {(n, w)}")
    points, weights, centroids = points.contiguous(), weights.contiguous(), centroids.contiguous()
    lib = _build.library("kmeans")
    scratch = torch.empty(lib.rtpu_kmeans_update_scratch(n, l), dtype=torch.int32, device=points.device)
    new_c = torch.empty_like(centroids)
    _launch("kmeans", lib.rtpu_kmeans_update, points,
            points.data_ptr(), weights.data_ptr(), centroids.data_ptr(), assign.contiguous().data_ptr(), n, w, l,
            scratch.data_ptr(), new_c.data_ptr())
    return new_c


def kmeans_step(points, weights, centroids):
    """One Lloyd iteration of the IVF coarse quantizer over points (N, W)
    float32 with weights (N,) (0 for a dead row): kmeans_assign, then
    kmeans_update.  Returns (new centroids (L, W) float32, assignment (N,)
    int32, -1 for a dead row)."""
    assign = kmeans_assign(points, weights, centroids)
    return kmeans_update(points, weights, centroids, assign), assign


# Row-bank writes and growth (the embedding banks' and the numeric plane's
# ingest): torch ops, as they only bitcast, reshape and scatter rows.  A
# packed upload (P, cols) holds 32-bit words as int32: col 0 the row index,
# col 1 the row's new bias bits (0.0 live, +inf dead), then the row lanes
# (FLOAT16: two a word, INT8: four a word after a scale column, least
# significant first, numpy's .view(np.uint32) packing on little-endian).
# Rows past n_valid and indexes outside the bank are dropped.  The writes
# are in place and return the planes they were given.

def _packed_rows(packed, n_valid: int, cap: int):
    rows = packed[: max(0, min(int(n_valid), packed.shape[0]))]
    idx = rows[:, 0].to(torch.int64)
    keep = (idx >= 0) & (idx < cap)
    return rows[keep], idx[keep]


def _words_as(words, dtype):
    return words.contiguous().view(dtype)


def rowbank_write_packed(bank, bias, packed, n_valid: int):
    rows, idx = _packed_rows(packed, n_valid, bank.shape[0])
    bank[idx] = _words_as(rows[:, 2:], torch.float32)
    bias[idx] = _words_as(rows[:, 1:2], torch.float32).reshape(-1)
    return bank, bias


def rowbank_write_packed_f16(bank, bias, packed, n_valid: int):
    rows, idx = _packed_rows(packed, n_valid, bank.shape[0])
    bank[idx] = _words_as(rows[:, 2:], torch.float16)
    bias[idx] = _words_as(rows[:, 1:2], torch.float32).reshape(-1)
    return bank, bias


def rowbank_write_packed_i8(bank, scale, bias, packed, n_valid: int):
    rows, idx = _packed_rows(packed, n_valid, bank.shape[0])
    bank[idx] = _words_as(rows[:, 3:], torch.int8)
    scale[idx] = _words_as(rows[:, 2:3], torch.float32).reshape(-1)
    bias[idx] = _words_as(rows[:, 1:2], torch.float32).reshape(-1)
    return bank, scale, bias


def rowbank_grow(bank, bias, grown_bank, grown_bias):
    """Copy a bank and its bias into the first rows of larger zeroed planes."""
    c = bank.shape[0]
    grown_bank[:c] = bank
    grown_bias[:c] = bias
    return grown_bank, grown_bias


def rowbank_grow_plane(plane, grown):
    grown[: plane.shape[0]] = plane
    return grown
