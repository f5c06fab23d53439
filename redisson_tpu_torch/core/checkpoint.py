"""Checkpoint / restore of the DeviceStore — the RDB-snapshot analog.

A port of ``redisson_tpu/core/checkpoint.py``, in the same file format, so a
checkpoint written by either package loads in the other.  The device state
is pulled to the host (one device-to-host copy a tensor; a sharded plane is
gathered whole), serialized with the host state into one versioned
container, and written atomically (tmp + rename), so a crash mid-save never
corrupts the previous snapshot.

Restore re-creates every StateRecord and copies its arrays onto the
engine's device (``torch.from_numpy(a).to(device)``, one copy a tensor).
A snapshot carries plain host arrays, never a device layout: a checkpoint
taken on one device or mesh restores on any other, and a sharded record
restores as one tensor that its next dispatch lays on the mesh again
(``parallel/manager.MeshManager.ensure_state``).  The hash version of
``utils/hashing`` is part of the format and is checked on load and on
restore.

Wire format (version 1):
    8-byte magic  b"RTPUCKP1"
    pickle(protocol 4) of {
        "format": 1, "saved_at": epoch-seconds, "hash_version": int,
        "records": [
            {"name", "kind", "meta", "version", "nonce", "expire_at",
             "host_pickled": bytes, "arrays": {name: np.ndarray}},
            ...
        ],
    }
    8-byte trailer magic b"RTPUCRC1" + 4-byte big-endian CRC32 of everything
    before the trailer: a torn write truncates the tail, so a missing or
    mismatched trailer is the crash-consistency detector.

The arrays are the reference's numpy dtypes and shapes (the expanded
one-uint8-per-bit planes, uint8 registers, int32 and float32 rows), since
the port's records hold the same ones.  Class names are a wire format too:
the payload and each record's host state are pickled through
``net/safe_pickle.dumps``, which writes any class of this package under the
reference's module name, and read back through the restricted unpickler,
which binds those names to this package's classes without importing
``redisson_tpu``.

Durability generations: ``save`` keeps the last ``keep`` good snapshots
(the previous head rotates to ``<path>.1``, the one before to ``<path>.2``,
...) and fsyncs the parent DIRECTORY after the final ``os.replace``.
``load`` verifies the CRC trailer and, when the head is corrupt or
truncated, falls back to the newest intact generation LOUDLY (logged and
counted in ``STATS``).

The storage fault hook (``_storage_plane``) returns the installed chaos
plane (``chaos/faults.py``), which injects ENOSPC, torn writes and fsync
failures at the snapshot write and fsync.
"""
from __future__ import annotations

import itertools
import logging
import os
import pickle
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from redisson_tpu_torch.core import residency as _residency
from redisson_tpu_torch.net import safe_pickle
from redisson_tpu_torch.utils.durability import fsync_dir as _fsync_dir

MAGIC = b"RTPUCKP1"
TRAILER_MAGIC = b"RTPUCRC1"
FORMAT = 1
DEFAULT_GENERATIONS = 3  # head + 2 rotated backups

_log = logging.getLogger("redisson_tpu_torch.checkpoint")

# durability bookkeeping: corruption must be OBSERVABLE, not just survived
STATS: Dict[str, int] = {
    "corrupt_generations": 0,   # candidates that failed CRC/magic on load
    "generation_fallbacks": 0,  # loads served by a non-head generation
}


class CheckpointCorruptError(ValueError):
    """A checkpoint file failed structural verification (bad magic,
    truncated payload, CRC mismatch, unreadable pickle) — distinct from
    version/hash INCOMPATIBILITY, which raises plain ValueError and never
    falls back (an incompatible head means incompatible generations)."""


def _storage_plane():
    # the same process-global plane net/client.py consults; checkpoint I/O
    # is cold path, so no zero-cost contract applies here
    from redisson_tpu_torch.net import client as _net

    return _net._fault_plane


# serializes same-process savers (AutoCheckpointer thread vs SAVE command);
# cross-process uniqueness comes from the tmp-file name
_save_lock = threading.Lock()
_save_seq = itertools.count()


def _hash_version() -> int:
    from redisson_tpu_torch.utils import hashing as H

    return getattr(H, "HASH_VERSION", 1)


def _dumps(obj) -> bytes:
    return safe_pickle.dumps(obj, protocol=4)


def _snapshot_records(engine) -> List[Dict[str, Any]]:
    """Materialize every live record to host memory under the store lock."""
    store = engine.store
    out: List[Dict[str, Any]] = []
    with store._lock:
        items = [(n, r) for n, r in store._states.items() if not r.expired()]
    for name, rec in items:
        # per-record lock: a compound mutation replaces arrays wholesale, so
        # holding the record lock gives a consistent (kind, meta, arrays) cut;
        # the host state is serialized inside the lock
        with engine.locked(name):
            out.append(
                {
                    "name": name,
                    "kind": rec.kind,
                    "meta": dict(rec.meta),
                    "version": rec.version,
                    # creation identity survives a restore: transfers compare
                    # (nonce, version), and a fresh nonce would read as a
                    # recreated record
                    "nonce": rec.nonce,
                    "expire_at": rec.expire_at,
                    "host_pickled": _dumps(rec.host),
                    "arrays": _residency.record_host_arrays(rec),
                }
            )
    return out


def generation_path(path: str, gen: int) -> str:
    """Generation 0 is the head; generation N is the Nth-newest backup."""
    return path if gen == 0 else f"{path}.{gen}"


def save(engine, path: str, keep: int = DEFAULT_GENERATIONS) -> int:
    """Snapshot the full DeviceStore to `path`. Returns #records saved.

    Keeps the ``keep - 1`` previous snapshots as rotated generations
    (``<path>.1`` newest).  The write path is: tmp file -> fsync(file) ->
    rotate old generations -> ``os.replace`` onto the head -> fsync(parent
    dir), so no crash point can lose BOTH the old head and the new one."""
    with _save_lock:
        records = _snapshot_records(engine)
        payload = {
            "format": FORMAT,
            "saved_at": time.time(),
            "hash_version": _hash_version(),
            "records": records,
        }
        body = MAGIC + _dumps(payload)
        data = body + TRAILER_MAGIC + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
        tmp = f"{path}.tmp.{os.getpid()}.{next(_save_seq)}"
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        plane = _storage_plane()
        if plane is not None:
            data = plane.on_storage_write(tmp, data)
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                if plane is not None:
                    plane.on_storage_fsync(tmp)
                os.fsync(f.fileno())
            # rotate: previous head -> .1, .1 -> .2, ... (newest first);
            # anything past `keep - 1` backups falls off the end
            if keep > 1 and os.path.exists(path):
                for gen in range(keep - 1, 1, -1):
                    older = generation_path(path, gen - 1)
                    if os.path.exists(older):
                        os.replace(older, generation_path(path, gen))
                os.replace(path, generation_path(path, 1))
            os.replace(tmp, path)
            # the renames live in the DIRECTORY's blocks
            _fsync_dir(parent)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return len(records)


def _loads(data: bytes):
    # the wire policy alone: numpy only by the reconstruction globals that
    # array pickles name, never by module (a checkpoint file and a RESTORE
    # blob are client-reachable bytes)
    return safe_pickle.safe_loads(data)


def read_verified(path: str):
    """Read + structurally verify ONE checkpoint file; returns the payload
    dict or raises :class:`CheckpointCorruptError`."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise CheckpointCorruptError(f"not a redisson_tpu checkpoint: {path!r}")
    trailer_len = len(TRAILER_MAGIC) + 4
    if len(data) < len(MAGIC) + trailer_len or data[-trailer_len:-4] != TRAILER_MAGIC:
        raise CheckpointCorruptError(
            f"checkpoint truncated (CRC trailer missing): {path!r}"
        )
    body = data[:-trailer_len]
    (crc,) = struct.unpack(">I", data[-4:])
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise CheckpointCorruptError(
            f"checkpoint CRC mismatch (torn write?): {path!r}"
        )
    try:
        return _loads(body[len(MAGIC):])
    except Exception as e:  # noqa: BLE001 — CRC passed but pickle didn't: corrupt
        raise CheckpointCorruptError(
            f"checkpoint payload unreadable: {path!r}: {e}"
        ) from e


def _load_lineage(path: str):
    """Try the head, then each rotated generation, newest first.  Returns
    ``(payload, generation_index)``; corruption is counted and logged
    loudly, and only the exhaustion of EVERY generation re-raises (the
    head's error, so callers see the primary failure)."""
    head_err: Optional[Exception] = None
    gen = 0
    while True:
        cand = generation_path(path, gen)
        if gen > 0 and not os.path.exists(cand):
            break
        try:
            payload = read_verified(cand)
        except FileNotFoundError as e:
            # gen 0 only: save()'s crash window between the rotation rename
            # and the head install leaves NO head but an intact .1
            if head_err is None:
                head_err = e
            gen += 1
            continue
        except CheckpointCorruptError as e:
            STATS["corrupt_generations"] += 1
            _log.error("checkpoint generation %s corrupt: %s", gen, e)
            if head_err is None:
                head_err = e
            gen += 1
            continue
        if gen > 0:
            STATS["generation_fallbacks"] += 1
            _log.error(
                "checkpoint head %r missing/corrupt; falling back to "
                "generation %d (%r)", path, gen, cand,
            )
        return payload, gen
    assert head_err is not None
    raise head_err


def _to_device(value, device) -> torch.Tensor:
    """One host array onto the engine's device: one copy."""
    return torch.from_numpy(np.ascontiguousarray(value)).to(device)


def _check_hash_version(payload, what: str) -> None:
    hv = payload.get("hash_version", 1)
    if hv != _hash_version():
        # bloom/HLL indexes are a function of the hash: a mismatched hash
        # version would silently corrupt membership answers
        raise ValueError(f"{what} hash_version={hv} != runtime {_hash_version()}")


def load(engine, path: str) -> int:
    """Restore a snapshot into the engine's store. Returns #records loaded.

    Existing records with the same name are overwritten (RESTORE REPLACE
    semantics); records whose TTL already elapsed are skipped.  A corrupt
    or truncated head falls back to the newest intact generation — loudly:
    logged, counted in ``STATS``, and raising :class:`CheckpointCorruptError`
    only when NO generation survives."""
    from redisson_tpu_torch.core.store import StateRecord

    payload, _gen = _load_lineage(path)
    if payload.get("format") != FORMAT:
        raise ValueError(f"unsupported checkpoint format {payload.get('format')}")
    _check_hash_version(payload, "checkpoint")

    now = time.time()
    n = 0
    for r in payload["records"]:
        if r["expire_at"] is not None and r["expire_at"] <= now:
            continue
        arrays = {k: _to_device(v, engine.device) for k, v in r["arrays"].items()}
        rec = StateRecord(
            kind=r["kind"],
            meta=r["meta"],
            arrays=arrays,
            host=_loads(r["host_pickled"]) if "host_pickled" in r else r.get("host"),
            version=r["version"],
            expire_at=r["expire_at"],
        )
        if "nonce" in r:
            # restore is NOT a recreation: keep the record's creation
            # identity (checkpoints without the field keep the fresh nonce)
            rec.nonce = r["nonce"]
        with engine.locked(r["name"]):
            engine.store.put(r["name"], rec)
        n += 1
    return n


class AutoCheckpointer:
    """Background periodic snapshotter (the `save <sec> <changes>` RDB knob).

    Runs `save()` every `interval` seconds on a daemon thread; failures are
    recorded on `.last_error` and never kill the loop."""

    def __init__(self, engine, path: str, interval: float = 300.0):
        self.engine = engine
        self.path = path
        self.interval = interval
        self.last_save: float | None = None
        self.last_error: Exception | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="rtpu-checkpoint", daemon=True
        )

    def start(self) -> "AutoCheckpointer":
        self._thread.start()
        return self

    def _save(self) -> None:
        try:
            save(self.engine, self.path)
            self.last_save = time.time()
            self.last_error = None
        except Exception as e:  # noqa: BLE001 - keep the loop alive
            self.last_error = e

    def _run(self):
        while not self._stop.wait(self.interval):
            self._save()

    def stop(self, flush: bool = True, join_timeout: float = 5.0) -> bool:
        """Stop the loop, then take a FINAL snapshot (flush-on-stop: writes
        since the last tick would otherwise die with the process).

        Returns whether the thread joined; ``False`` means a save longer
        than ``join_timeout`` is still running on the daemon thread, and
        the final snapshot is skipped (the in-flight save is the freshest)."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout)
        joined = not self._thread.is_alive()
        if flush and joined and self._thread.ident is not None:
            self._save()
        return joined


# -- single-record portable blobs (RObject.dump/restore + the DUMP verb) -----

def dump_record(engine, name: str) -> bytes:
    """ONE record as a self-contained blob: the checkpoint record's field
    set (kind/meta/host/arrays/expire_at) plus the hash_version stamp."""
    with engine.locked(name), _residency.no_promote():
        rec = engine.store.get(name)
        if rec is None:
            raise KeyError(f"object '{name}' does not exist")
        payload = {
            "format": 1,
            "hash_version": _hash_version(),
            "kind": rec.kind,
            "meta": dict(rec.meta),
            "expire_at": rec.expire_at,
            "host_pickled": _dumps(rec.host),
            "arrays": _residency.record_host_arrays(rec),
        }
    return _dumps(payload)


def restore_record(
    engine, name: str, state: bytes, ttl=None, replace: bool = False,
    persist: bool = False,
) -> None:
    """Install a dump_record blob under `name`.  BUSYKEY unless `replace`
    (Redis RESTORE semantics); `ttl` (seconds) overrides the blob's own
    expire_at; `persist` strips expiry; hash-version mismatches refuse as
    checkpoint.load does.  A blob whose carried TTL has already elapsed
    refuses loudly rather than replying OK and serving nothing."""
    from redisson_tpu_torch.core.store import StateRecord

    payload = _loads(bytes(state))  # restricted unpickler: wire-reachable
    if not isinstance(payload, dict) or payload.get("format") != 1:
        raise ValueError("unrecognized dump payload")
    _check_hash_version(payload, "dump")
    host = _loads(payload["host_pickled"])  # inner state is wire-reachable too
    with engine.locked(name):
        if not replace and engine.store.exists(name):
            raise ValueError(f"BUSYKEY object '{name}' already exists")
        rec = StateRecord(
            kind=payload["kind"],
            meta=dict(payload["meta"]),
            arrays={k: _to_device(v, engine.device) for k, v in payload["arrays"].items()},
            host=host,
        )
        if persist:
            rec.expire_at = None
        elif ttl is not None:
            rec.expire_at = time.time() + ttl
        else:
            carried = payload.get("expire_at")
            if carried is not None and carried <= time.time():
                raise ValueError(
                    "dump TTL already elapsed; pass an explicit ttl or "
                    "persist=True (wire: RESTORE ... PERSIST)"
                )
            rec.expire_at = carried
        engine.store.delete(name)
        engine.store.put(name, rec)


def _device_copy(value):
    """A deep copy of one record array on its own device(s)."""
    from redisson_tpu_torch.parallel.sharded import ShardedPlane

    if isinstance(value, ShardedPlane):
        parts = np.empty(value.parts.shape, dtype=object)
        for d, s, part in value.each():
            parts[d, s] = part.clone()
        return ShardedPlane(value.mesh, value.axis, parts)
    return value.clone()


def clone_record(engine, src_name: str, dst_name: str, replace: bool = False) -> bool:
    """COPY semantics shared by RObject.copy_to and the COPY verb: clone one
    record under a new name.  Tensors get a device-side deep copy (kernels
    update a record's tensors in place, so a shared tensor would carry a
    write to either side into the other); host state deep-copies via
    pickle."""
    from redisson_tpu_torch.core.store import StateRecord

    with engine.locked_many([src_name, dst_name]), _residency.no_promote():
        rec = engine.store.get(src_name)
        if rec is None:
            return False
        if engine.store.exists(dst_name) and not replace:
            return False
        if rec.stash is None and rec.cold_path is None:
            arrays = {k: _device_copy(v) for k, v in rec.arrays.items()}
        else:
            # a demoted source: the clone lands HOT from the host view, and
            # the source stays WARM/COLD (a copy must not double its
            # device footprint)
            arrays = {
                k: _to_device(np.array(v), engine.device)  # never the stash's memory
                for k, v in _residency.record_host_arrays(rec).items()
            }
        clone = StateRecord(
            kind=rec.kind,
            meta=pickle.loads(pickle.dumps(dict(rec.meta))),
            arrays=arrays,
            host=pickle.loads(pickle.dumps(rec.host)),
        )
        clone.expire_at = rec.expire_at
        engine.store.delete(dst_name)
        engine.store.put(dst_name, clone)
    return True
