"""MapReduce service, a port of ``redisson_tpu/services/mapreduce.py``.

Three ways to run a job:
  * ``MapReduce`` (``client.get_map_reduce``): mapper(key, value, collector)
    and reducer(key, values) over a map's entries, mapper chunks and reducer
    partitions on local threads, or, with ``executor=`` (an ExecutorService
    handle, embedded or over the wire), as executor tasks that worker
    processes (``python -m redisson_tpu_torch.node``) claim and run: a
    worker that dies mid-task has its task re-run on a survivor;
  * ``KernelMapReduce``: an array-native job, a torch ``map_fn`` mapped over
    the values with ``torch.func.vmap`` and the shuffle and reduce as one
    segment reduction (the ``segment_reduce`` kernel on the card);
  * ``word_count`` (BASELINE config 4) and ``device_word_count``: the
    values joined into byte buffers, words hashed on the card (``wc_words``)
    and counted by sorting (``wc_sort_runs``); a map that has not changed
    re-scans from its staged device view; with ``executor=`` the chunks
    are counted on the worker processes.

Differences from the reference:
  * ``map_fn`` is a torch function run under ``torch.func.vmap`` (the
    reference's is a JAX function run under ``jax.vmap``).
  * No fallback hides a kernel: a failed build or launch raises through
    ``word_count``.  Non-ASCII whitespace still takes the host path (the
    byte kernel cannot see it), and ``STATS`` counts it.  More distinct
    words than the reduce holds (2**17) sort again on the device with room
    for every word, where the reference counts on the host.

On an engine with placement on (``Engine.enable_placement``), a scan has a
chunk for each position at least and chunk i runs on ``devices[i % D]``'s
device; a chunk on another device than the stream's is merged onto it by
``ioplane.colocate`` (a peer copy, never a host gather).  Positions on one
card write their rows straight into the stream.
"""
from __future__ import annotations

import pickle
import re
import threading
import time
import uuid
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core.engine import resolve_device
from redisson_tpu_torch.services.executor import inject_client
from redisson_tpu_torch.utils import hashing as H

# device scans made, scans served from a staged view, and word counts that
# took the host path (non-ASCII whitespace)
STATS = {"device_scans": 0, "view_hits": 0, "host_fallbacks": 0}


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


class Collector:
    """Per-mapper emission buffer: a key goes to partition h1(key) % n."""

    def __init__(self, n_partitions: int):
        self._parts: List[Dict[Any, List[Any]]] = [defaultdict(list) for _ in range(n_partitions)]
        self._n = n_partitions

    def emit(self, key, value) -> None:
        kb = key.encode() if isinstance(key, str) else repr(key).encode()
        words, nbytes = H.pack_keys([kb])
        h1, _ = H.hash_packed_bytes(torch.from_numpy(words.view(np.int32)),
                                    torch.from_numpy(nbytes.view(np.int32)))
        self._parts[int(h1[0]) % self._n][key].append(value)


def _part_name(job: str, chunk_idx: int, run: str, pi: int) -> str:
    return f"mr:{job}:c{chunk_idx}:r{run}:p{pi}"


def _mr_map_task(map_name, keys, mapper, n_parts, job, chunk_idx, codec, *, client):
    """Mapper chunk task (MapperTask.java:50-78 analog): read the chunk in
    ONE batched call, run the user mapper into an in-memory Collector, flush
    each partition buffer with ONE bulk multimap merge (vs the reference's
    per-emit write).

    Partition names are RUN-scoped (fresh uuid per execution): a requeued
    clone writes to its own names, so a stale slow worker can neither
    append duplicates to nor delete/clobber the winning run's output — the
    coordinator tells reducers exactly which run won (the acked one).
    Loser runs' partitions are unreferenced garbage reaped by the cleanup
    task.  `codec` is the source map's codec: the worker must encode lookup
    keys exactly as the writer did, or get_all matches nothing."""
    from redisson_tpu_torch.client.codec import PickleCodec

    run = uuid.uuid4().hex[:8]
    source = client.get_map(map_name, codec=codec)
    entries = source.get_all(keys)
    c = Collector(n_parts)
    for k, v in entries.items():
        mapper(k, v, c)
    for pi, pmap in enumerate(c._parts):
        if pmap:
            mm = client.get_list_multimap(
                _part_name(job, chunk_idx, run, pi), codec=PickleCodec()
            )
            mm.put_all_entries(dict(pmap))
    return {"entries": len(entries), "run": run}


def _mr_reduce_task(job, pi, chunk_runs, reducer, result_name, result_codec, *, client):
    """Reducer partition task (ReducerTask.java analog): fold each key's
    value list across every WINNING mapper run's partition output
    (`chunk_runs` = [(chunk_idx, run), ...] from the acked map results),
    optionally write into the named result map, return the reduced dict so
    the coordinator can merge without re-reading.

    IDEMPOTENT: reads only — a requeued re-run (worker died mid-fold) sees
    every chunk again and the result-map write is a full overwrite of this
    partition's keys.  Partition cleanup belongs to the COORDINATOR
    (_mr_cleanup_task in its finally), never to the reducer: deleting as we
    read would make a re-run silently undercount the already-consumed
    chunks."""
    from redisson_tpu_torch.client.codec import PickleCodec

    grouped: Dict[Any, List[Any]] = defaultdict(list)
    for ci, run in chunk_runs:
        mm = client.get_list_multimap(_part_name(job, ci, run, pi), codec=PickleCodec())
        for k, v in mm.entries():
            grouped[k].append(v)
    out = {k: reducer(k, vals) for k, vals in grouped.items()}
    if result_name and out:
        client.get_map(result_name, codec=result_codec).put_all(out)
    return out


def _wc_chunk_task(map_name, keys, codec, *, client):
    """word_count mapper chunk: one batched read + the shared C-speed
    Counter pass.  Returns the chunk's {word: count} dict (small —
    vocabulary-sized).  Idempotent by construction: no grid writes."""
    vals = client.get_map(map_name, codec=codec).get_all(keys)
    return _host_word_count([str(v) for v in vals.values()])


def _mr_cleanup_task(job, names=None, *, client):
    """Best-effort partition reaper.  `names` (the coordinator's known
    partition names — winning runs x partitions) deletes directly; names is
    None on FAILED jobs where winning runs are unknown, falling back to a
    `mr:{job}:*` pattern sweep.  The scan is the exception path only — a
    KEYS scan per successful job would cost O(total keyspace) every run.
    A stale clone that flushes after this sweep leaks until a failed-job
    sweep touches it; that residual is leak-shaped, never correctness-shaped
    (reducers only read run names the coordinator handed them)."""
    keys = client.get_keys()
    if names is None:
        try:
            names = list(keys.get_keys(f"mr:{job}:*"))
        except Exception:  # noqa: BLE001 — best-effort cleanup
            return 0
    n = 0
    for name in names:
        try:
            n += int(keys.delete(name))  # per-name: slot-routable
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass
    return n


# grid-aware tasks get the worker's client injected (the @RInject analog;
# WorkerNode._run_one and ExecutorService._run_task both honor the marker)
_mr_map_task = inject_client(_mr_map_task)
_mr_reduce_task = inject_client(_mr_reduce_task)
_mr_cleanup_task = inject_client(_mr_cleanup_task)
_wc_chunk_task = inject_client(_wc_chunk_task)


def _await_payload_task(executor, task_id: str, timeout: float):
    """Cross-process task wait that works for local ExecutorService handles
    AND wire proxies: poll task_state (cheap), fetch the result when done.
    Results submitted via submit_payload come back as pickled bytes from
    remote workers but as live objects from in-process worker threads —
    normalize both."""
    deadline = time.time() + timeout
    while True:
        state = executor.task_state(task_id)
        if state in ("finished", "failed", "cancelled"):
            raw = executor.await_task_result(task_id, 5.0)
            if isinstance(raw, (bytes, bytearray, memoryview)):
                return pickle.loads(bytes(raw))  # noqa: S301 — coordinator's own task
            return raw
        if state is None:
            raise KeyError(f"unknown task {task_id}")
        if time.time() > deadline:
            raise TimeoutError(f"task {task_id} not finished within {timeout}s")
        time.sleep(0.02)


class MapReduce:
    """Generic map-reduce over a Map or collection handle.

    mapper(key, value, collector)           — RMapper.map analog
    reducer(key, values) -> value           — RReducer.reduce analog
    collator(result_dict) -> Any (optional) — RCollator analog

    With `executor=` an ExecutorService handle (local or wire proxy), mapper
    chunks and reducer partitions ship as claimable tasks run by WorkerNode
    processes / registered workers (CoordinatorTask.java:77-136); without
    one, the in-process thread path runs (useful for small jobs and tests).
    mapper/reducer/collator must then be module-level picklable callables.
    """

    def __init__(
        self,
        engine,
        mapper: Callable,
        reducer: Callable,
        collator: Optional[Callable] = None,
        workers: int = 4,
        executor=None,
    ):
        self._engine = engine
        self._mapper = mapper
        self._reducer = reducer
        self._collator = collator
        self._workers = max(1, workers)
        self._executor = executor
        self._timeout: Optional[float] = None

    def timeout(self, seconds: float) -> "MapReduce":
        self._timeout = seconds
        return self

    def _entries(self, source) -> List[Tuple[Any, Any]]:
        if hasattr(source, "read_all_entry_set"):
            return source.read_all_entry_set()
        if hasattr(source, "read_all"):
            return [(None, v) for v in source.read_all()]
        return list(source)

    def execute(self, source, result_map=None):
        """Run the full pipeline; returns the reduced dict (or the collator
        output if a collator was set).  Writes into `result_map` if given
        (the reference's execute(resultMapName))."""
        if self._executor is not None:
            return self._execute_distributed(source, result_map)
        entries = self._entries(source)
        n_parts = self._workers
        chunk = max(1, (len(entries) + self._workers - 1) // self._workers)
        collectors: List[Collector] = []
        threads = []
        errors: List[BaseException] = []

        def run_mapper(chunk_entries):
            c = Collector(n_parts)
            try:
                for k, v in chunk_entries:
                    self._mapper(k, v, c)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
            collectors.append(c)

        # mapper wave (MapperTask fan-out; threads play the worker role)
        for i in range(0, len(entries), chunk):
            t = threading.Thread(target=run_mapper, args=(entries[i : i + chunk],))
            t.start()
            threads.append(t)
        for t in threads:
            t.join(self._timeout)
        if errors:
            raise errors[0]

        # shuffle: merge per-mapper partition buffers (the multimap state)
        partitions: List[Dict[Any, List[Any]]] = [defaultdict(list) for _ in range(n_parts)]
        for c in collectors:
            for pi, pmap in enumerate(c._parts):
                for k, vals in pmap.items():
                    partitions[pi][k].extend(vals)

        # reducer wave (one ReducerTask per partition)
        result: Dict[Any, Any] = {}
        res_lock = threading.Lock()
        rthreads = []

        def run_reducer(pmap):
            out = {k: self._reducer(k, vals) for k, vals in pmap.items()}
            with res_lock:
                result.update(out)

        for pmap in partitions:
            if pmap:
                t = threading.Thread(target=run_reducer, args=(pmap,))
                t.start()
                rthreads.append(t)
        for t in rthreads:
            t.join(self._timeout)

        if result_map is not None:
            result_map.put_all(result)
        if self._collator is not None:
            return self._collator(result)
        return result

    def _execute_distributed(self, source, result_map=None):
        """Coordinator for the worker-process path (CoordinatorTask.java:
        77-136): mapper chunks fan out as executor tasks, then one reducer
        task per partition; every task is claim-fenced and orphan-requeued
        by the executor machinery, so a worker dying mid-chunk re-runs on a
        survivor (TasksService re-scheduling)."""
        ex = self._executor
        name = getattr(source, "_name", None)
        if name is None:
            raise TypeError("distributed MapReduce needs a named Map handle")
        codec = getattr(source, "_codec", None)
        keys = source.read_all_keys()
        job = uuid.uuid4().hex[:12]
        n_parts = self._workers
        timeout = self._timeout or 120.0
        chunk = max(1, (len(keys) + self._workers - 1) // self._workers)
        chunks = [keys[i : i + chunk] for i in range(0, len(keys), chunk)]
        try:
            tids = [
                ex.submit_payload(
                    pickle.dumps(
                        (_mr_map_task, (name, ck, self._mapper, n_parts, job, ci, codec), {}),
                        protocol=pickle.HIGHEST_PROTOCOL,
                    )
                )
                for ci, ck in enumerate(chunks)
            ]
            # the acked map result names the WINNING run per chunk — stale
            # clones wrote under other run ids nobody will ever read
            chunk_runs = [
                (ci, _await_payload_task(ex, tid, timeout)["run"])
                for ci, tid in enumerate(tids)
            ]
            result_name = getattr(result_map, "_name", None)
            result_codec = getattr(result_map, "_codec", None)
            rtids = [
                ex.submit_payload(
                    pickle.dumps(
                        (
                            _mr_reduce_task,
                            (job, pi, chunk_runs, self._reducer, result_name, result_codec),
                            {},
                        ),
                        protocol=pickle.HIGHEST_PROTOCOL,
                    )
                )
                for pi in range(n_parts)
            ]
            result: Dict[Any, Any] = {}
            for tid in rtids:
                result.update(_await_payload_task(ex, tid, timeout))
        except BaseException:
            # failed/abandoned job: winning runs unknown — pattern sweep
            self._submit_cleanup(ex, job, None)
            raise
        else:
            # success: delete exactly the winning runs' partition names
            # (no keyspace scan on the common path); stale-clone orphans
            # wait for a failed-job sweep — a leak, never a correctness
            # hazard, because reducers only read runs the coordinator named
            self._submit_cleanup(
                ex,
                job,
                [
                    _part_name(job, ci, run, pi)
                    for ci, run in chunk_runs
                    for pi in range(n_parts)
                ],
            )
        if self._collator is not None:
            return self._collator(result)
        return result

    @staticmethod
    def _submit_cleanup(ex, job: str, names) -> None:
        """Fire-and-forget cleanup task (rides the executor so it works from
        any coordinator — local handle or wire proxy)."""
        try:
            ex.submit_payload(
                pickle.dumps(
                    (_mr_cleanup_task, (job, names), {}),
                    protocol=pickle.HIGHEST_PROTOCOL,
                )
            )
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass


class KernelMapReduce:
    """Array-native map-reduce: ``torch.func.vmap(map_fn)`` over the values,
    then one segment reduction into ``n_keys`` slots.

    map_fn: value_row -> (key_id, mapped_value), written in torch
    reduce: 'sum' | 'max' | 'min'
    device: where the job runs (the CUDA card by default, as ``create()``)
    """

    def __init__(self, map_fn: Callable, reduce: str = "sum", n_keys: int = 1024, device="cuda"):
        if reduce not in K.SEGMENT_OPS:
            raise ValueError(f"unsupported reduce {reduce!r}")
        self._n_keys = n_keys
        self._reduce = reduce
        self._device = resolve_device(device)
        self._mapped = torch.func.vmap(map_fn)

    def execute(self, values) -> np.ndarray:
        """values: (N, ...) array or tensor; returns the (n_keys,) result."""
        if not isinstance(values, torch.Tensor):
            values = torch.from_numpy(np.ascontiguousarray(values))
        keys, mapped = self._mapped(values.to(self._device))
        return K.segment_reduce(keys, mapped, self._n_keys, self._reduce).cpu().numpy()


# every ASCII codepoint str.isspace() considers whitespace (str.split's
# separator set): \t\n\x0b\x0c\r plus the \x1c-\x1f file/group/record/unit
# separators — miss one and the device path diverges from str.split()
_WS_TRANSLATE = bytes.maketrans(b"\t\n\x0b\x0c\r\x1c\x1d\x1e\x1f", b" " * 9)

# any whitespace OUTSIDE that ASCII set (NBSP, ideographic space, \x85, ...)
_UNICODE_WS_RE = re.compile(r"[^\S \t\n\x0b\x0c\r\x1c\x1d\x1e\x1f]")

# gc.disable() is a process-wide toggle: a depth counter makes the pause
# reentrant across overlapping scans (one scan finishing must not re-enable
# collection under another still running)
_gc_guard = threading.Lock()
_gc_depth = 0
_gc_was_enabled = False


class _gc_paused:
    def __enter__(self):
        import gc

        global _gc_depth, _gc_was_enabled
        with _gc_guard:
            if _gc_depth == 0:
                _gc_was_enabled = gc.isenabled()
                gc.disable()
            _gc_depth += 1

    def __exit__(self, *exc):
        import gc

        global _gc_depth
        with _gc_guard:
            _gc_depth -= 1
            if _gc_depth == 0 and _gc_was_enabled:
                gc.enable()
        return False


def _host_word_count(vals: List[str]) -> Dict[str, int]:
    """Single-pass host count: per-value split + Counter.update."""
    c: Counter = Counter()
    for v in vals:
        c.update(v.split())
    return dict(c)


def _host_fallback(vals: List[str]) -> Dict[str, int]:
    STATS["host_fallbacks"] += 1
    return _host_word_count(vals)


def _lap(parts: Optional[Dict[str, float]], name: str, t0: float, device) -> float:
    """Add the seconds since t0 to parts[name], once the device has done the
    work queued so far, and return the new start; no-op without parts."""
    if parts is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    parts[name] = parts.get(name, 0.0) + t - t0
    return t


# distinct-word capacity of the device reduce (2**bits); shared by every
# path so cached views and fresh builds can never disagree on the cutoff
_WC_D_MAX_BITS = 17


class _WcScanView:
    """Tokenized device view of a value set: hashed word streams resident on
    the device plus the normalized byte blobs for decode.  Validity
    is keyed by the record's (nonce, version): any mutation (or a
    delete/recreate) changes it and the next scan rebuilds."""

    __slots__ = ("key", "ha", "hb", "st", "blobs", "padded", "nw")

    def __init__(self, key, ha, hb, st, blobs, padded, nw):
        self.key = key
        self.ha, self.hb, self.st = ha, hb, st
        self.blobs, self.padded, self.nw = blobs, padded, nw


class _WcViewCache:
    """At most `cap` staged views per engine (LRU): each view holds three
    device words per source word, so an unbounded cache would eat device
    memory."""

    def __init__(self, cap: int = 2):
        self._cap = cap
        self._lock = threading.Lock()
        self._views: "dict[str, _WcScanView]" = {}

    def get(self, name: str, key) -> Optional[_WcScanView]:
        with self._lock:
            v = self._views.get(name)
            if v is None:
                return None
            if v.key != key:
                # known stale: drop NOW so its device arrays free even if
                # the rebuild ends on the host path and never calls put()
                self._views.pop(name)
                return None
            # refresh recency so eviction is true LRU, not FIFO
            self._views.pop(name)
            self._views[name] = v
            return v

    def put(self, name: str, view: _WcScanView) -> None:
        with self._lock:
            self._views.pop(name, None)
            self._views[name] = view
            while len(self._views) > self._cap:
                self._views.pop(next(iter(self._views)))


def _wc_chunk_bytes(vals: List[str]) -> Optional[Tuple[bytes, np.ndarray, int]]:
    """One chunk's text: the values joined by spaces, whitespace normalised
    to 0x20 and padded with it to a bucket size, and its word count; None
    for non-ASCII whitespace, which the byte kernel cannot see."""
    joined = " ".join(vals) + " "
    if not joined.isascii() and _UNICODE_WS_RE.search(joined):
        return None
    big = joined.encode().translate(_WS_TRANSLATE)
    buf = np.full(K.bucket_size(len(big)), 32, np.uint8)
    buf[: len(big)] = np.frombuffer(big, np.uint8)
    ws = buf == 32
    return big, buf, int(np.count_nonzero(~ws[:-1] & ws[1:]))


def _wc_tokenize(vals: List[str], n_chunks: int, device, key=None,
                 parts: Optional[Dict[str, float]] = None, devices=None) -> Optional[_WcScanView]:
    """Host join + device hashing, chunk by chunk; None means "use the host
    path" (non-ASCII whitespace).  Each chunk's end positions are found on
    the device (wc_extract_words_auto): the host ships only the text, and
    each chunk's rows land at their place in the stream's three tensors.
    `parts`, when given, sums the seconds of the join and encode, the H2D
    copies and the hashing.  `devices` (placement's positions): chunk i is
    hashed on devices[i % D]'s device and its rows are copied device to
    device into the stream where that is another device."""
    if devices is not None and len(devices) > 1:
        n_chunks = max(n_chunks, len(devices))
    csize = max(1, (len(vals) + n_chunks - 1) // n_chunks)
    chunks = []
    t = time.perf_counter()
    for ci in range(0, len(vals), csize):
        chunk = _wc_chunk_bytes(vals[ci : ci + csize])
        if chunk is None:
            return None
        chunks.append(chunk)
    t = _lap(parts, "join_encode_s", t, device)
    ebs = [K.bucket_size(max(1, n_ends)) for _, _, n_ends in chunks]
    ha, hb, st = (torch.empty(sum(ebs), dtype=torch.int32, device=device) for _ in range(3))
    at = base = 0
    for i, ((big, buf, n_ends), eb) in enumerate(zip(chunks, ebs)):
        chunk_dev = device if not devices else torch.device(getattr(devices[i % len(devices)], "device", device))
        staged = torch.from_numpy(buf).to(chunk_dev)
        t = _lap(parts, "h2d_s", t, device)
        if chunk_dev == ha.device:
            K.wc_extract_words_auto(staged, n_ends, eb, base, out=(ha, hb, st), at=at)
        else:
            for dst, rows in zip((ha, hb, st), K.wc_extract_words_auto(staged, n_ends, eb, base)):
                dst[at:at + eb] = ioplane.colocate(rows, ha.device)
        t = _lap(parts, "wc_words_s", t, device)
        at += eb
        base += buf.shape[0]
    return _WcScanView(key, ha, hb, st, [c[0] for c in chunks], [c[1].shape[0] for c in chunks],
                       sum(c[2] for c in chunks))


def prewarm_word_count(
    total_chars: int,
    total_words: int,
    n_chunks: int = 2,  # word_count's device path always scans in 2 chunks
    d_max_bits: int = None,
    device="cuda",
) -> None:
    """Run the word-count kernels once at the shapes a corpus of
    ~total_chars/~total_words will use, off the serving path: the kernels'
    libraries are built and loaded, and the device allocator holds blocks of
    those sizes, before the first real scan."""
    device = resolve_device(device)
    if d_max_bits is None:
        d_max_bits = _WC_D_MAX_BITS
    b = K.bucket_size(max(1, -(-total_chars // n_chunks)))
    eb = min(b, K.bucket_size(max(1, -(-total_words // n_chunks))))
    buf = np.full(b, 32, np.uint8)
    buf[:4] = np.frombuffer(b"abc ", np.uint8)  # one real token
    staged = torch.from_numpy(buf).to(device)
    # the sort's shape is the whole stream: n_chunks * eb
    stream = [torch.empty(n_chunks * eb, dtype=torch.int32, device=device) for _ in range(3)]
    for i in range(n_chunks):
        K.wc_extract_words_auto(staged, 1, eb, 0, out=stream, at=i * eb)
    K.wc_sort_runs(*stream, 1 << d_max_bits).cpu()


def _wc_reduce(view: _WcScanView, d_max: int, parts: Optional[Dict[str, float]] = None) -> Dict[str, int]:
    """Count runs of the sorted word stream.  More than d_max distinct words
    sort again with room for every row, still on the device.  `parts`, when
    given, sums the seconds of the sort, the D2H copy and the decode."""
    out = None
    for d in (d_max, view.ha.numel()):
        t = time.perf_counter()
        fused = K.wc_sort_runs(view.ha, view.hb, view.st, d)
        t = _lap(parts, "wc_sort_runs_s", t, view.ha.device)
        host = fused.cpu().numpy()  # ONE fetch for both result rows
        t = _lap(parts, "d2h_s", t, view.ha.device)
        out = _wc_decode(view, host)
        _lap(parts, "decode_s", t, view.ha.device)
        if out is not None:
            break
    return out


def _wc_decode(view: _WcScanView, host: np.ndarray) -> Optional[Dict[str, int]]:
    """{word: count} from wc_sort_runs' rows on the host; None when the rows
    hold fewer run starts than there are distinct words."""
    fp = host[0]
    off = host[1].view(np.uint32)
    # padding ends carry sentinel hashes that sort AFTER every real word,
    # so positions [0, nw) of the sorted array are the real words
    nw = view.nw
    finite = fp < nw
    if fp.size < view.ha.numel() and bool(finite[-1]):
        return None  # every fp row is a real run start: distinct > d_max
    fps = fp[finite]
    counts = np.diff(np.concatenate([fps, [nw]]))
    out: Dict[str, int] = {}
    bounds = np.cumsum([0] + view.padded)
    for o, c in zip(off[finite], counts):
        ci = int(np.searchsorted(bounds, o, side="right")) - 1
        local = int(o - bounds[ci])
        bg = view.blobs[ci]
        end = local
        while end < len(bg) and bg[end] != 32:
            end += 1
        out[bg[local:end].decode(errors="replace")] = int(c)
    return out


def device_word_count(vals: List[str], d_max_bits: int = _WC_D_MAX_BITS, n_chunks: int = 2,
                      device="cuda") -> Dict[str, int]:
    """Word count on the device (wc_extract_words_auto + wc_sort_runs).

    The host joins the values into byte buffers and normalizes whitespace;
    the device finds and hashes the words and counts them by sorting, again
    with room for every word when there are more than 2**d_max_bits
    distinct ones.  The host path counts instead when the values hold
    non-ASCII whitespace."""
    if not vals:
        return {}
    view = _wc_tokenize(vals, n_chunks, resolve_device(device))
    if view is None:
        return _host_fallback(vals)
    STATS["device_scans"] += 1
    return _wc_reduce(view, 1 << d_max_bits)


def word_count(source_map, workers: int = 4, executor=None, timeout: float = 120.0,
               parts: Optional[Dict[str, float]] = None) -> Dict[str, int]:
    """The canonical example (and BASELINE config 4): count words across all
    values of a map, on its engine's device.  A map that has not changed
    since its last count re-scans from the staged device view; the host
    counts only for non-ASCII whitespace.  With `executor=`, the keys split
    into `workers` chunks that ship to WorkerNode processes (the
    reference's worker-JVM model; escapes the coordinator's GIL), each
    counted there by the host Counter pass.  `parts`, when given, receives the seconds
    of this scan's parts (read_values_s, join_encode_s, h2d_s, wc_words_s,
    wc_sort_runs_s, d2h_s, decode_s; a view hit has only the last three);
    timing them synchronizes the device between the parts."""
    if executor is not None:
        keys = source_map.read_all_keys()
        codec = getattr(source_map, "_codec", None)
        chunk = max(1, (len(keys) + workers - 1) // workers)
        tids = [
            executor.submit_payload(
                pickle.dumps(
                    (_wc_chunk_task, (source_map._name, keys[i : i + chunk], codec), {}),
                    protocol=pickle.HIGHEST_PROTOCOL,
                )
            )
            for i in range(0, len(keys), chunk)
        ]
        total: Counter = Counter()
        for tid in tids:
            total.update(_await_payload_task(executor, tid, timeout))
        return dict(total)
    engine = getattr(source_map, "_engine", None)
    device = engine.device if engine is not None else resolve_device("cuda")
    name = getattr(source_map, "_name", None)
    cache = rec = None
    if engine is not None and name is not None and getattr(source_map, "_scan_view_safe", False):
        rec = engine.store.get(name)
        cache = engine.service("wc_scan_views", _WcViewCache)
    # snapshot the validity key BEFORE reading values: store.get returns the
    # LIVE record (mutations bump version in place on it), so the key must be
    # captured as values, not re-read through the alias after the scan
    key0 = (rec.nonce, rec.version) if rec is not None else None
    if cache is not None and key0 is not None:
        view = cache.get(name, key0)
        if view is not None:
            STATS["view_hits"] += 1
            return _wc_reduce(view, 1 << _WC_D_MAX_BITS, parts)
    # pause cyclic gc for the scan: the value read + tokenize allocate
    # millions of short-lived objects next to the map's own millions, and
    # collection passes triggered mid-scan cost hundreds of ms of pure
    # latency (nothing here creates cycles; gen0 pressure is the trigger)
    with _gc_paused():
        t = time.perf_counter()
        raw = source_map.read_all_values()
        if set(map(type, raw)) <= {str}:
            vals = raw  # all str (a StringCodec map): skip the 1M-item copy
        else:
            vals = [v if type(v) is str else str(v) for v in raw]
        if not vals:
            return {}
        key = None
        if key0 is not None:
            # revalidate after the read: a mutation racing the value read
            # must not get its torn view cached under ANY version
            rec2 = engine.store.get(name)
            if rec2 is not None and (rec2.nonce, rec2.version) == key0:
                key = key0
        _lap(parts, "read_values_s", t, device)
        placement = getattr(engine, "placement", None) if engine is not None else None
        view = _wc_tokenize(vals, 2, device, key, parts,
                            devices=placement.devices if placement is not None else None)
        if view is None:
            return _host_fallback(vals)
        STATS["device_scans"] += 1
        out = _wc_reduce(view, 1 << _WC_D_MAX_BITS, parts)
        if cache is not None and key is not None:
            cache.put(name, view)
        return out
