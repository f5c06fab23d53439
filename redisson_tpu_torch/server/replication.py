"""Record-level async replication: the master ships changed StateRecords.

A port of ``redisson_tpu/server/replication.py``.  Redisson delegates
replication to Redis; here the server IS the data plane, so replication is
native: instead of replaying a command stream, the master ships whole
changed records (a record is a few device tensors and a host struct, and
every mutation bumps its version).  Per-record last-writer-wins,
asynchronous (a replica lags its master by up to one sweep interval);
REPLFLUSH forces a synchronous ship, the WAIT analog BatchOptions.syncSlaves
uses.

Wire protocol (internal commands; net/commands.py marks them keyless):
  replica -> master : REPLREGISTER <host> <port>     (after the full sync)
  replica -> master : REPLSNAPSHOT [BEGIN|FETCH|END]  -> serialized records
  master  -> replica: REPLPUSH <blob> | REPLPUSHSEG   (a batch of records)
  master  -> replica: REPLPING <offset> <ts>          (clean-sweep heartbeat)
  any     -> master : REPLFLUSH                       (ship now, wait)

The blobs are the reference's, byte format and all: an LZ4-framed pickle of
``{"format": 1, "records": [...], "live": [...]}`` whose records carry the
reference's numpy dtypes and shapes, so either package's master feeds
either package's replica.  Two places differ from the reference:

  * The payload and each record's host state are decoded by
    ``net/safe_pickle.safe_loads`` (the restricted unpickler checkpoints
    and RESTORE use), never by plain ``pickle.loads``: REPLPUSH is reachable
    on any replica's port, so a blob naming a class outside the allowed
    set is refused before anything runs.
  * K23 and K24 are torch ops.  A full ship installs through
    ``core/ioplane.scatter_host_arrays`` (one host-to-device copy of the
    record's arrays, cut on the device).  A block delta is applied by
    ``_apply_array_delta``: the plane, viewed as (nblocks, block),
    takes the changed blocks by ``index_copy_`` on a clone.  CUDA's
    ``index_copy_`` asserts on an out-of-range index, and a device-side
    assert poisons the process's CUDA context, so every array of an item
    is validated on the host (``_validate_array_delta``) before any patch
    launches, and the record is replaced only once every patch is made.
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import residency as _residency
from redisson_tpu_torch.net import safe_pickle
from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.net.retry import replica_link_kwargs
from redisson_tpu_torch.observe import trace as _obs
from redisson_tpu_torch.parallel.sharded import ShardedPlane
from redisson_tpu_torch.utils import lz4block

# Records whose arrays total fewer bytes than this always ship in full: the
# delta bookkeeping (a host baseline and a block index) costs more than it
# saves.  Above it, the shipper keeps a host baseline of the last shipped
# state and ships only the changed blocks (Redis's partial resync analog).
DELTA_MIN_BYTES = 65536
# one REPLPUSH frame never exceeds this: larger blobs ship as REPLPUSHSEG
# slices, so no sendall outlives a socket timeout and the replica never
# reassembles an unbounded single frame
SEGMENT_BYTES = 8 << 20
# 256-byte blocks ~ word granularity for scattered writers (a bloom add sets
# k single bits spread over the plane, so coarse blocks would mark
# everything dirty); the int32 index a block is 1.6% overhead
_DELTA_BLOCK_BYTES = 256
# a delta that moves more than this share of a record's blocks ships in full
_DELTA_MAX_SHARE = 0.6


def _block_elems(dtype) -> int:
    return max(1, _DELTA_BLOCK_BYTES // np.dtype(dtype).itemsize)


def _np_dtype(value) -> np.dtype:
    """The numpy dtype of a record array: a tensor, a ShardedPlane or any
    array numpy reads."""
    if isinstance(value, ShardedPlane):
        value = value.parts[0, 0]
    if isinstance(value, torch.Tensor):
        return torch.empty(0, dtype=value.dtype).numpy().dtype
    return np.dtype(value.dtype)


def _to_blocks(a: np.ndarray) -> np.ndarray:
    """Ravel + zero-pad to whole blocks -> (nblocks, block_elems) view."""
    be = _block_elems(a.dtype)
    flat = a.ravel()
    nblocks = -(-flat.size // be)
    if nblocks * be != flat.size:
        flat = np.concatenate([flat, np.zeros(nblocks * be - flat.size, a.dtype)])
    return flat.reshape(nblocks, be)


def _encode_record_delta(item: dict, base: dict) -> Optional[dict]:
    """Per-array block diff of a snapshot item against the kept baseline.

    Returns {akey: {"idx", "data", "shape", "dtype", "nblocks"} | None for
    an unchanged array}, or None when a full ship is the right answer (the
    array set, a shape or a dtype changed, or more than 60% of the blocks
    moved, so the delta would not pay for itself)."""
    cur_arrays = item["arrays"]
    base_arrays = base["arrays"]
    if set(cur_arrays) != set(base_arrays):
        return None
    out = {}
    total = changed = 0
    for akey, cur in cur_arrays.items():
        b = base_arrays[akey]
        if cur.shape != b.shape or cur.dtype != b.dtype:
            return None
        cb, bb = _to_blocks(cur), _to_blocks(b)
        dirty = (cb != bb).any(axis=1)
        idx = np.nonzero(dirty)[0].astype(np.int32)
        total += cb.shape[0]
        changed += idx.size
        # the expected geometry travels WITH the delta: the replica checks
        # it against its own plane before any block is written
        out[akey] = None if idx.size == 0 else {
            "idx": idx,
            "data": cb[idx],
            "shape": tuple(cur.shape),
            "dtype": str(cur.dtype),
            "nblocks": int(cb.shape[0]),
        }
    if total and changed / total > _DELTA_MAX_SHARE:
        return None
    return out


def _validate_array_delta(name: str, akey: str, cur, d: dict) -> None:
    """Reject a delta whose shipped geometry differs from the replica's own
    plane BEFORE any block is written (reference ``:127-159``).  A shape
    divergence would land blocks at wrong row-major offsets, and on the
    card an index past the plane is a device-side assert that poisons the
    process's CUDA context.  Raising here fails the REPLPUSH loudly, so the
    master's shipper falls back to a full ship."""
    shape = d.get("shape")
    if shape is not None and tuple(cur.shape) != tuple(shape):
        raise ValueError(
            f"REPLPUSH delta shape mismatch for {name!r}/{akey}: replica has "
            f"{tuple(cur.shape)}, master shipped {tuple(shape)}"
        )
    cur_dtype = _np_dtype(cur)
    dtype = d.get("dtype")
    if dtype is not None and str(cur_dtype) != dtype:
        raise ValueError(
            f"REPLPUSH delta dtype mismatch for {name!r}/{akey}: replica has "
            f"{cur_dtype}, master shipped {dtype}"
        )
    be = _block_elems(cur_dtype)
    nblocks = -(-int(np.prod(cur.shape)) // be)
    if int(d.get("nblocks", nblocks)) != nblocks:
        raise ValueError(
            f"REPLPUSH delta block-count mismatch for {name!r}/{akey}: replica "
            f"plane has {nblocks} blocks, master shipped {d.get('nblocks')}"
        )
    idx = np.asarray(d["idx"])
    if idx.size and (int(idx.max()) >= nblocks or int(idx.min()) < 0):
        raise ValueError(
            f"REPLPUSH delta block index out of range for {name!r}/{akey}: "
            f"[{int(idx.min())}, {int(idx.max())}] vs {nblocks} blocks"
        )
    data = np.asarray(d["data"])
    if data.shape != (idx.size, be) or data.dtype != cur_dtype:
        raise ValueError(
            f"REPLPUSH delta data for {name!r}/{akey} is {data.dtype}"
            f"{data.shape}, expected {cur_dtype}{(idx.size, be)}"
        )


def _as_tensor(cur) -> torch.Tensor:
    if isinstance(cur, ShardedPlane):
        return cur.gather()  # the whole plane; its next dispatch re-lays it
    if isinstance(cur, torch.Tensor):
        return cur
    return torch.from_numpy(np.ascontiguousarray(np.asarray(cur)))


def _apply_array_delta(cur, d: dict) -> torch.Tensor:
    """K24 (reference ``:102-181``): the plane with the delta's blocks
    written, as a new tensor on the plane's device; `cur` is untouched.

    The clone is one device-to-device copy; the clone's bytes up to its
    last whole block, viewed as (blocks, 256 bytes), take the changed
    blocks by one ``index_copy_`` (on bytes, so every dtype takes the same
    copy), and a last block that the plane only partly fills is written on
    its own, up to the plane's end.  A block index repeated in
    the delta keeps its last data (deduplicated on the host: CUDA's
    ``index_copy_`` leaves the winner of a duplicate undefined).  The
    caller has run ``_validate_array_delta``, so every index is in range."""
    src = _as_tensor(cur)
    idx = np.asarray(d["idx"], np.int64)
    data = np.asarray(d["data"])
    shape = tuple(src.shape)
    n = src.numel()
    be = data.shape[1] if data.ndim == 2 else _block_elems(_np_dtype(src))
    full = n // be
    # the last occurrence of each index wins; a delta the encoder made has
    # no repeat, and its data is used as it came, without a host copy
    _, first_rev = np.unique(idx[::-1], return_index=True)
    if first_rev.size != idx.size:
        keep = np.sort(idx.size - 1 - first_rev)
        idx, data = idx[keep], data[keep]
    flat = src.reshape(-1).clone()
    raw = flat.view(torch.uint8)
    block = raw.numel() // max(1, n) * be  # bytes a block
    dev = flat.device
    whole = idx < full
    if whole.any():
        rows = data if whole.all() else data[whole]
        rows = np.ascontiguousarray(rows).view(np.uint8).reshape(-1, block)
        at = torch.from_numpy(idx if whole.all() else idx[whole]).to(dev)
        raw[: full * block].view(full, block).index_copy_(
            0, at, torch.from_numpy(rows).to(dev))
    if not whole.all():
        tail = np.ascontiguousarray(data[~whole][-1]).view(np.uint8)
        raw[full * block:] = torch.from_numpy(tail[: raw.numel() - full * block]).to(dev)
    return flat.view(shape)


# the one definition of a shipped record's identity head: REPLSNAPSHOT,
# IMPORTRECORDS and REPLPUSH frames all carry exactly these fields next to
# either "arrays" (full) or "arrays_delta" + "delta_base" (block delta)
_HEAD_FIELDS = ("name", "kind", "meta", "version", "nonce", "expire_at",
                "host_pickled")


def _record_head(rec, name: str) -> dict:
    """Serialize one record's non-array state; the caller holds its lock.
    The host state is pickled through ``safe_pickle.dumps``, which writes
    the port's classes under the reference's names."""
    return {
        "name": name,
        "kind": rec.kind,
        "meta": dict(rec.meta),
        "version": rec.version,
        "nonce": rec.nonce,
        "expire_at": rec.expire_at,
        "host_pickled": safe_pickle.dumps(rec.host, protocol=4),
    }


# LZ4-framed replication blobs (REPLSNAPSHOT / REPLPUSH / IMPORTRECORDS):
# magic + 4-byte big-endian uncompressed length + one LZ4 block.  Decoding
# accepts bare pickles too (a pickle starts with \x80, so the magic cannot
# collide).
_WIRE_LZ4_MAGIC = b"RLZ4"

# resumable full sync: the master stages ONE serialized snapshot and the
# replica pulls it in offset-addressed chunks, so a link that drops
# mid-ship resumes at the byte it stopped at
SNAPSHOT_CHUNK_BYTES = 4 << 20
SNAP_STAGE_STALE_S = 120.0
SNAP_STAGE_MAX = 16


def pull_snapshot(client, timeout: float = 60.0,
                  chunk_bytes: Optional[int] = None,
                  max_link_errors: int = 8,
                  max_restarts: int = 2) -> bytes:
    """Replica-side resumable REPLSNAPSHOT pull.

    ``REPLSNAPSHOT BEGIN`` stages the cut on the master and replies
    ``[xfer_id, total, crc32, chunk]``; ``FETCH <id> <offset>`` streams it
    chunk by chunk: a dropped link retries the SAME offset (the staged blob
    is immutable), a ``SNAPEXPIRED`` reply (master restarted, stage reaped)
    restarts from a fresh BEGIN.  The assembled bytes are CRC-checked
    against the BEGIN header before they are returned, so a torn or
    mixed-stage snapshot never reaches ``apply_records``.  A master that
    answers BEGIN with the whole blob (the legacy one-ship form) has it
    returned as is."""
    restarts = 0
    while True:
        begin = ["REPLSNAPSHOT", "BEGIN"]
        if chunk_bytes:
            begin += ["CHUNK", int(chunk_bytes)]
        reply = client.execute(*begin, timeout=timeout)
        if isinstance(reply, RespError):
            raise reply
        if isinstance(reply, (bytes, bytearray, memoryview)):
            return bytes(reply)  # legacy full-blob master
        xfer_id = reply[0].decode() if isinstance(reply[0], (bytes, bytearray)) \
            else str(reply[0])
        total, crc = int(reply[1]), int(reply[2])
        buf = bytearray()
        errors = 0
        expired = False
        while len(buf) < total:
            try:
                part = client.execute(
                    "REPLSNAPSHOT", "FETCH", xfer_id, len(buf),
                    timeout=timeout,
                )
                if isinstance(part, RespError):
                    raise part
            except RespError as e:
                if str(e).startswith("SNAPEXPIRED") and restarts < max_restarts:
                    restarts += 1
                    expired = True
                    break
                raise
            except (ConnectionError, OSError, TimeoutError):
                # the resume: the next FETCH asks for the SAME offset
                errors += 1
                if errors > max_link_errors:
                    raise
                continue
            if not part:
                raise ConnectionError(
                    f"REPLSNAPSHOT FETCH returned no data at offset "
                    f"{len(buf)}/{total}"
                )
            buf += bytes(part)
        if expired:
            continue
        blob = bytes(buf)
        if zlib.crc32(blob) != crc:
            raise ValueError(
                f"REPLSNAPSHOT torn: crc mismatch over {total} bytes "
                f"(transfer {xfer_id})"
            )
        try:  # release the stage eagerly; the reaper is the backstop
            client.execute("REPLSNAPSHOT", "END", xfer_id, timeout=5.0)
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass
        return blob


def _wire_payload(records: List[dict], live: Optional[List[str]],
                  offset: Optional[int] = None,
                  ts: Optional[float] = None) -> bytes:
    payload = {"format": 1, "records": records}
    if live is not None:
        payload["live"] = live
    if offset is not None:
        # the bounded-staleness stamp: this blob carries the master's
        # sweep-cut offset.  Scoped covers and migration transfers ship
        # unstamped (they advance no cut).
        payload["repl_offset"] = int(offset)
        payload["repl_ts"] = float(ts if ts is not None else time.time())
    raw = safe_pickle.dumps(payload, protocol=4)
    if len(raw) > 0xFFFFFFFF:  # the BE32 length frame caps at 4 GB: raw
        return raw
    packed = lz4block.compress(raw)
    if len(packed) + 8 >= len(raw):  # incompressible: ship raw
        return raw
    return _WIRE_LZ4_MAGIC + len(raw).to_bytes(4, "big") + packed


def _unwire_payload(blob: bytes) -> bytes:
    if blob[:4] == _WIRE_LZ4_MAGIC:
        raw_len = int.from_bytes(blob[4:8], "big")
        return lz4block.decompress(bytes(blob[8:]), raw_len)
    return blob


def _device_cut(value):
    """A record array's copy taken under its lock: a device copy of a
    tensor (a ShardedPlane gathered whole), a host array as is."""
    if isinstance(value, ShardedPlane):
        return value.gather()
    if isinstance(value, torch.Tensor):
        return value.clone()
    return np.asarray(value)


def snapshot_records(engine, names: List[str]) -> Dict[str, dict]:
    """A consistent cut of `names` without the device-to-host copy under
    the record lock: under each lock the host state is pickled and each
    tensor copied on the device (the copy is waited for before the lock is
    released, so a later mutation on another stream cannot race it); the
    device-to-host pull of every copy is then ONE transfer a device,
    outside the locks (``ioplane.gather_device_results``).  A WARM or COLD
    record ships its stash or spill bytes and stays demoted."""
    staged = []
    for name in names:
        with engine.locked(name):
            rec = engine.store.get_unguarded(name)
            if rec is None or rec.expired():
                continue
            item = _record_head(rec, name)
            if rec.stash is not None or rec.cold_path is not None:
                # a demoted record: its exact bytes already live on the
                # host (gather passes numpy through); never promote
                item["arrays"] = _residency.record_host_arrays(rec)
            else:
                item["arrays"] = {k: _device_cut(v) for k, v in rec.arrays.items()}
            for dev in {v.device for v in item["arrays"].values()
                        if isinstance(v, torch.Tensor)}:
                ioplane.wait_device(dev)
            staged.append(item)
    keys = [sorted(item["arrays"]) for item in staged]
    host = ioplane.gather_device_results(
        [[item["arrays"][k] for k in ks] for item, ks in zip(staged, keys)]
    )
    out = {}
    for item, ks, vals in zip(staged, keys, host):
        item["arrays"] = dict(zip(ks, vals))
        out[item["name"]] = item
    return out


def serialize_records(
    engine, names: Optional[List[str]] = None, include_live: bool = True
) -> Tuple[bytes, List[Tuple[str, int, int]]]:
    """Consistent host-side cut of (all | named) records.

    Returns (blob, [(name, nonce, version), ...]): the shipped identities,
    so the caller tracks each replica's progress without decoding the
    blob.  The nonce travels with the version because a deleted and
    recreated record restarts at version 0 under a fresh nonce.  The blob
    also carries the full live-name list: deletions bump no version, so the
    receiving replica prunes the records absent from it."""
    store = engine.store
    with store._lock:
        live = [n for n, r in store._states.items() if not r.expired()]
        items = [
            (n, store._states[n]) for n in live if names is None or n in names
        ]
    out = []
    shipped: List[Tuple[str, int, int]] = []
    for name, rec in items:
        with engine.locked(name):
            engine.store.claim(rec)  # after the kernels queued on its lane
            item = _record_head(rec, name)
            item["arrays"] = _residency.record_host_arrays(rec)
            out.append(item)
            shipped.append((name, rec.nonce, rec.version))
    # include_live=False for record TRANSFER blobs (slot migration): the
    # live-name list makes apply_records prune everything absent from it
    return _wire_payload(out, live if include_live else None), shipped


def _place_singly(host_arrays: dict, device) -> dict:
    """One copy an array, each in its native byte order."""
    out = {}
    for k, v in host_arrays.items():
        a = np.asarray(v)
        a = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("="))
        out[k] = torch.from_numpy(a).to(device)
    return out


def _hydrate_full_arrays(engine, name: str, host_arrays: dict) -> dict:
    """Full-ship install: the record's arrays onto the engine's device as
    ONE packed upload (K23, ``ioplane.scatter_host_arrays``) through the
    staging pool of the record's lane (its owner position's with placement
    on), holding that lane like any dispatch (QoS class ``bulk``), so
    replica reads see the hydration in the lane's occupancy ledger.

    MUST be called WITHOUT the record lock: the upload takes the lane
    gate, and the dispatch path's lock order is lane -> record.  A host
    array the packing refuses (a dtype that does not round-trip) falls back
    to one copy an array; a device error propagates and fails the frame."""
    position = engine.device_for_name(name)
    device = getattr(position, "device", None) or engine.device
    stats = getattr(engine, "hydration_stats", None)
    if stats is None:
        stats = engine.hydration_stats = {
            "records_packed": 0, "records_fallback": 0, "bytes": 0,
        }
    nbytes = sum(int(getattr(v, "nbytes", 0) or 0) for v in host_arrays.values())
    t0 = time.monotonic()
    try:
        ioplane.scatter_layout(host_arrays)
        packed = True
    except (TypeError, ValueError):
        packed = False
    if not packed:
        arrays = _place_singly(host_arrays, device)
        stats["records_fallback"] += 1
    else:
        pool = engine.staging_pool(position)
        lane = (engine.lanes.lane(position)
                if engine.lanes is not None and position is not None else None)
        if lane is not None:
            with lane.occupy(len(host_arrays), qos_class="bulk", nbytes=nbytes):
                arrays = ioplane.scatter_host_arrays(host_arrays, device, pool)
        else:
            arrays = ioplane.scatter_host_arrays(host_arrays, device, pool)
        stats["records_packed"] += 1
        stats["bytes"] += nbytes
    if _obs._tracer is not None:
        tr = _obs.current_trace()
        if tr is not None:
            tr.add_span("hydrate", t0, time.monotonic(),
                        device=getattr(position, "id", 0),
                        arrays=len(host_arrays), nbytes=nbytes)
    return arrays


def apply_records(engine, blob: bytes, on_applied=None, on_payload=None) -> int:
    """Install shipped records (last-writer-wins by version); returns the
    count applied (installed or pruned).

    ``on_applied`` (optional) receives the names whose state this frame
    changed, after the apply: the tracking plane invalidates near caches
    through it, since a record arriving by a transfer changes the keyspace
    exactly like a write.  ``on_payload`` (optional) receives the decoded
    payload after a SUCCESSFUL apply: the replication verbs take the
    bounded-staleness stamp from it; a failed apply never advances the
    replica's offset."""
    from redisson_tpu_torch.core.store import StateRecord

    payload = safe_pickle.safe_loads(_unwire_payload(blob))
    applied = 0
    changed = []
    for item in payload["records"]:
        name = item["name"]
        nonce = item.get("nonce")
        # decoded before any lock or device work: a refused host state
        # fails the frame with nothing written
        host = safe_pickle.safe_loads(item["host_pickled"])
        hydrated = None
        if "arrays_delta" not in item:
            # hydrate OUTSIDE the record lock (lock order lane -> record);
            # the lock-free peek only skips hydrating a plainly stale ship,
            # and the authoritative check reruns under the lock
            peek = engine.store.get_unguarded(name)
            if not (
                peek is not None
                and (nonce is None or peek.nonce == nonce)
                and peek.version >= item["version"]
            ):
                hydrated = _hydrate_full_arrays(engine, name, item["arrays"])
        with engine.locked(name):
            existing = engine.store.get_unguarded(name)
            if (
                existing is not None
                and (nonce is None or existing.nonce == nonce)
                and existing.version >= item["version"]
            ):
                # a stale ship (an out-of-order push of the SAME
                # incarnation): keep the newer state.  A nonce mismatch
                # means the master recreated the record: install it even
                # at a lower version.
                continue
            if "arrays_delta" in item:
                # a block delta against the version this replica last
                # applied: any mismatch raises, so the REPLPUSH fails and
                # the master full-ships on its next sweep
                if (
                    existing is None
                    or existing.nonce != nonce
                    or existing.version != item["delta_base"]
                ):
                    raise ValueError(
                        f"REPLPUSH delta base mismatch for {name!r}: have "
                        f"{None if existing is None else (existing.nonce, existing.version)}, "
                        f"need ({nonce}, {item['delta_base']})"
                    )
                deltas = item["arrays_delta"]
                for akey, d in deltas.items():
                    cur = existing.arrays.get(akey)
                    if cur is None:
                        raise ValueError(f"delta for unknown array {name!r}/{akey}")
                    if d is not None:
                        _validate_array_delta(name, akey, cur, d)
                arrays = {
                    akey: existing.arrays[akey] if d is None
                    else _apply_array_delta(existing.arrays[akey], d)
                    for akey, d in deltas.items()
                }
            else:
                arrays = hydrated
                if arrays is None:
                    # went from stale to fresh between the peek and the
                    # lock (rare): one copy an array
                    arrays = _place_singly(item["arrays"], engine.home(name))
            rec = StateRecord(
                kind=item["kind"],
                meta=item["meta"],
                arrays=arrays,
                host=host,
            )
            rec.version = item["version"]
            if nonce is not None:
                rec.nonce = nonce
            rec.expire_at = item["expire_at"]
            engine.store.put_unguarded(name, rec)
            applied += 1
            changed.append(name)
    live = payload.get("live")
    if live is not None:
        # prune the records the master no longer has (deletion propagation)
        live_set = set(live)
        with engine.store._lock:
            stale = [n for n in engine.store._states if n not in live_set]
        for n in stale:
            engine.store.delete_unguarded(n)
            applied += 1
            changed.append(n)
    if on_applied is not None and changed:
        try:
            on_applied(changed)
        except Exception:  # noqa: BLE001 — invalidation fan-out must not
            pass           # fail the transfer frame
    if on_payload is not None:
        try:
            on_payload(payload)
        except Exception:  # noqa: BLE001 — stamp recording must not fail
            pass           # the transfer frame either
    return applied


class ReplicaHandle:
    """Master-side link to one registered replica."""

    def __init__(self, address: str, password: Optional[str] = None, server=None):
        self.address = address
        # nodes of one grid share credentials and transport security
        # (server.link_client carries TLS when it is on)
        if server is not None:
            self.client = server.link_client(address, **replica_link_kwargs())
        else:
            from redisson_tpu_torch.net.client import NodeClient

            self.client = NodeClient(
                address, password=password, **replica_link_kwargs()
            )
        # record name -> (nonce, version) last shipped; the nonce detects a
        # delete + recreate between sweeps (the version restarts)
        self.shipped: Dict[str, Tuple[int, int]] = {}
        self.healthy = True
        # monotonic time of the last offset carrier (push or REPLPING) this
        # handle received: throttles the clean-sweep heartbeat
        self.last_beat = 0.0


class ReplicationSource:
    """Master-side shipper: a debounced scan of record versions that pushes
    what changed.

    The scan is cheap (a version compare a record, host memory only); the
    arrays are serialized only for dirty records.  The interval bounds a
    replica's lag under steady writes."""

    def __init__(self, server, interval: float = 0.2):
        self.server = server
        self.interval = interval
        self._replicas: Dict[str, ReplicaHandle] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # name -> {"nonce", "version", "arrays": {akey: np}} of the last
        # shipped state, kept only for records above DELTA_MIN_BYTES
        self._baseline: Dict[str, dict] = {}
        # one sweep at a time: a manual flush() racing the interval thread
        # would double-ship full planes and interleave h.shipped updates
        self._ship_mutex = threading.Lock()
        # chaos hook: a stalled stream ships NOTHING until resumed
        self._stalled = threading.Event()
        # the replication offset: one tick a sweep CUT; every push of the
        # sweep carries it and clean replicas hear it by REPLPING
        self.offset = 0
        self.stats = {"pushes": 0, "bytes": 0, "records_full": 0,
                      "records_delta": 0, "heartbeats": 0}

    def stall(self) -> None:
        """Stop shipping (chaos: a replication-stream stall) until resume()."""
        self._stalled.set()

    def resume(self) -> None:
        self._stalled.clear()

    @property
    def stalled(self) -> bool:
        return self._stalled.is_set()

    def register(self, address: str) -> None:
        with self._lock:
            if address not in self._replicas:
                self._replicas[address] = ReplicaHandle(
                    address, password=self.server.password, server=self.server
                )
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="rtpu-repl-ship"
                )
                self._thread.start()

    def unregister(self, address: str) -> None:
        with self._lock:
            h = self._replicas.pop(address, None)
        if h is not None:
            h.client.close()

    def replicas(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def flush(self) -> int:
        """Ship everything dirty NOW, synchronously (the WAIT analog)."""
        return self._ship_once()

    def cover(self, names: Optional[List[str]] = None) -> int:
        """Ship to the replicas NOW, scoped to `names` when given (full
        arrays, no live-name list: no prune semantics), else everything
        dirty; returns how many replicas are healthy after the push (the
        import-ack covering hop of slot migration)."""
        if names is None:
            self._ship_once()
        else:
            self._cover_names(names)
        with self._lock:
            return sum(1 for h in self._replicas.values() if h.healthy)

    def _cover_names(self, names: List[str]) -> int:
        """Name-scoped synchronous ship."""
        if self._stalled.is_set():
            return 0  # a stalled stream ships NOTHING
        with self._lock:
            replicas = list(self._replicas.values())
        if not replicas or not names:
            return 0
        with self._ship_mutex:
            snap = snapshot_records(self.server.engine, sorted(set(names)))
            if not snap:
                return 0
            records = []
            shipped_now = []
            for name, item in snap.items():
                head = {k: item[k] for k in _HEAD_FIELDS}
                head["arrays"] = item["arrays"]
                records.append(head)
                shipped_now.append((name, item["nonce"], item["version"]))
            blob = _wire_payload(records, None)
            total = 0
            for h in replicas:
                try:
                    self._push_blob(h, blob)
                    h.healthy = True
                except Exception as e:  # noqa: BLE001 — the interval sweep retries
                    if isinstance(e, RespError):
                        # the replica is alive but refused the apply:
                        # forget what it holds, so the next sweep full-ships
                        for name, _n, _v in shipped_now:
                            h.shipped.pop(name, None)
                    else:
                        h.healthy = False
                    continue
                for name, nonce, version in shipped_now:
                    # the interval sweep skips these versions; the delta
                    # baseline stays put (a later mutation full-ships once)
                    h.shipped[name] = (nonce, version)
                total += len(shipped_now)
                self.stats["pushes"] += 1
                self.stats["bytes"] += len(blob)
                self.stats["records_full"] += len(records)
            return total

    def _dirty_for(self, handle: ReplicaHandle) -> Tuple[List[str], List[str]]:
        """(records to ship, shipped names since deleted on the master)."""
        engine = self.server.engine
        with engine.store._lock:
            live = {n: r for n, r in engine.store._states.items() if not r.expired()}
        dirty = []
        for n, r in live.items():
            sh = handle.shipped.get(n)
            if sh is None or sh[0] != r.nonce or sh[1] < r.version:
                dirty.append(n)
        deleted = [n for n in handle.shipped if n not in live]
        return dirty, deleted

    def _ship_once(self) -> int:
        if self._stalled.is_set():
            return 0
        with self._ship_mutex:
            return self._ship_once_locked()

    def _heartbeat(self, handles: List[ReplicaHandle], offset: int,
                   ts: float) -> None:
        """Offset-only keepalive for replicas with nothing dirty this sweep:
        a clean replica holds everything the cut holds, so its applied
        offset advances to the cut without a byte of state, and
        ``max_staleness`` reads stay serveable on an idle keyspace.
        Throttled to half the sweep interval a handle, so flush()-polling
        callers (the WAIT loop) cannot flood the link."""
        now = time.monotonic()
        for h in handles:
            if now - h.last_beat < self.interval * 0.5:
                continue
            try:
                reply = h.client.execute("REPLPING", offset, ts, timeout=5.0)
                if isinstance(reply, RespError):
                    raise reply
                h.healthy = True
                h.last_beat = now
                self.stats["heartbeats"] += 1
            except Exception:  # noqa: BLE001 — down OR promoted (refuses)
                h.healthy = False

    def _ship_once_locked(self) -> int:
        with self._lock:
            replicas = list(self._replicas.values())
        if not replicas:
            return 0
        engine = self.server.engine
        union: set = set()
        plan = []
        for h in replicas:
            names, deleted = self._dirty_for(h)
            plan.append((h, names, deleted))
            union.update(names)
        # one offset tick a sweep CUT: every stamped push below carries it,
        # clean replicas hear it by REPLPING
        self.offset += 1
        offset, ts = self.offset, time.time()
        if not union and not any(d for _, _, d in plan):
            self._heartbeat(replicas, offset, ts)
            return 0
        # ONE snapshot serves every replica this sweep; its arrays are
        # block-diffed against the baseline BEFORE the baseline advances
        snap = snapshot_records(engine, sorted(union))
        with engine.store._lock:
            live = [n for n, r in engine.store._states.items() if not r.expired()]
        # the block diff, only for records some replica can take as a
        # delta (its shipped state is the current baseline)
        deltas: Dict[str, Tuple[int, dict]] = {}
        for name, item in snap.items():
            base = self._baseline.get(name)
            if base is None or base["nonce"] != item["nonce"]:
                continue
            want = (item["nonce"], base["version"])
            if not any(h.shipped.get(name) == want for h, _, _ in plan):
                continue
            d = _encode_record_delta(item, base)
            if d is not None:
                deltas[name] = (base["version"], d)
        total = 0
        delivered: set = set()
        for h, names, deleted in plan:
            if not names and not deleted:
                self._heartbeat([h], offset, ts)
                continue
            # the blob's live-name list makes the replica prune deletions,
            # so a deletions-only sweep ships an empty record set
            records = []
            shipped_now = []
            n_delta = 0
            for name in names:
                item = snap.get(name)
                if item is None:
                    continue  # died between the dirty scan and the snapshot
                head = {k: item[k] for k in _HEAD_FIELDS}
                dv = deltas.get(name)
                if dv is not None and h.shipped.get(name) == (item["nonce"], dv[0]):
                    head["delta_base"] = dv[0]
                    head["arrays_delta"] = dv[1]
                    n_delta += 1
                else:
                    head["arrays"] = item["arrays"]
                records.append(head)
                shipped_now.append((name, item["nonce"], item["version"]))
            blob = _wire_payload(records, live, offset=offset, ts=ts)
            try:
                self._push_blob(h, blob)
                h.healthy = True
                h.last_beat = time.monotonic()
            except Exception as e:  # noqa: BLE001 — retried next sweep
                if isinstance(e, RespError):
                    # the replica is alive but REFUSED the apply (a delta
                    # base mismatch, a diverged plane): forget what it
                    # holds, so the next sweep ships those records in full
                    for name in names:
                        h.shipped.pop(name, None)
                else:
                    h.healthy = False  # transport failure: replica down
                continue
            for name, nonce, version in shipped_now:
                h.shipped[name] = (nonce, version)
                delivered.add(name)
            for name in deleted:
                h.shipped.pop(name, None)
            total += len(shipped_now) + len(deleted)
            self.stats["pushes"] += 1
            self.stats["bytes"] += len(blob)
            self.stats["records_delta"] += n_delta
            self.stats["records_full"] += len(records) - n_delta
        # a baseline advances only for records at least one replica took
        # this sweep: when every push failed, the old baseline still
        # matches what the replicas hold, so the retry stays a delta
        for name, item in snap.items():
            if name not in delivered:
                continue
            nbytes = sum(a.nbytes for a in item["arrays"].values())
            if nbytes >= DELTA_MIN_BYTES:
                self._baseline[name] = {
                    "nonce": item["nonce"],
                    "version": item["version"],
                    "arrays": item["arrays"],
                }
        live_set = set(live)
        for name in [n for n in self._baseline if n not in live_set]:
            del self._baseline[name]
        return total

    _xfer_seq = 0

    @staticmethod
    def _push_blob(h: ReplicaHandle, blob: bytes) -> None:
        """One REPLPUSH, or REPLPUSHSEG slices for an oversized blob.
        Raises on transport failures AND on -ERR replies: a replica that
        refused the apply has not been shipped to."""
        def _checked(reply):
            if isinstance(reply, RespError):
                raise reply
            return reply

        if len(blob) <= SEGMENT_BYTES:
            _checked(h.client.execute("REPLPUSH", blob, timeout=30.0))
            return
        nsegs = -(-len(blob) // SEGMENT_BYTES)
        ReplicationSource._xfer_seq += 1
        xfer_id = f"x{id(h) & 0xFFFFFF:x}-{ReplicationSource._xfer_seq}"
        for seq in range(nsegs):
            chunk = blob[seq * SEGMENT_BYTES:(seq + 1) * SEGMENT_BYTES]
            _checked(h.client.execute("REPLPUSHSEG", xfer_id, seq, nsegs,
                                      chunk, timeout=60.0))

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._ship_once()
            except Exception:  # noqa: BLE001 — keep the shipper alive
                pass

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            for h in self._replicas.values():
                h.client.close()
            self._replicas.clear()
