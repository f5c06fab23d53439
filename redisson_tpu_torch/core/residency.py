"""Tiered device residency: HOT on the device, WARM in host RAM, COLD on
disk.

A port of ``redisson_tpu/core/residency.py``.  The device's memory is a
cache over host RAM and checkpoint-backed storage:

  * **HOT**  — the record's tensors live on its device (the only state
    with the plane off);
  * **WARM** — the record's tensors are released; a host-RAM numpy mirror
    (``rec.stash``) holds the exact bytes.  Promotion is ONE packed
    host-to-device copy through the owner lane's pinned staging slot
    (``ioplane.scatter_host_arrays``, K23), onto the same device, so the
    warm kernel pool re-hits with no rebuild;
  * **COLD** — the host mirror is spilled to a checkpoint-container file
    (MAGIC + CRC trailer, ``checkpoint.read_verified`` reads it back with
    the restricted unpickler) and dropped; promotion adds exactly one
    verified file read.  A spill written by either package loads in the
    other: the file is the reference's byte for byte.

Fault-in on first touch: the DeviceStore getters fire
``plane.on_record_access`` AFTER releasing the store lock; a WARM or COLD
record promotes synchronously before the caller sees it, so handlers never
observe a tier.  Demotion is safe by construction: only clean state
demotes (vector banks with pending rows pin HOT), fenced or migrating
slots never demote (``fence_check``), records touched within
``min_idle_s`` never demote (the touch clock closes the get-then-read
race), and sharded or host-only records are ineligible for the budget's
demotions: a numpy plane and a ``ShardedPlane`` pin HOT there, a
``torch.Tensor`` on any device (the CPU's included) may demote.  A forced
demotion (``demote(force=True)``, CLUSTER RESIDENCY DEMOTE) takes any
record with arrays, as the reference's does: its fault-in brings every
array back as a tensor on the owner's card.  With ``cold_after_s`` set, a
sweep spills WARM records idle that long COLD.

**What a device is here.**  The ledgers (``hot_bytes_by_device``,
``census``, the budget's victims, CLUSTER RESIDENCY's rows) key a record
by its owner position (``StateRecord.position``) when placement is on,
and by its tensors' device index when it is off.  The reference keys by
the JAX device of each single-device array, which is the record's
position on the CPU's 8 forced devices, so both packages give the same
rows there.  The budget is per position, as the reference's is per
device: with one position a card (the reference's layout) it is the
card's; positions sharing a card each have it.  A fault-in uploads onto
the owner position's card through that position's lane pool.

Arming follows the trace plane's discipline: ``_tier_plane`` is the ONE
module global every store-getter site loads.  ``None`` (the default)
costs one load plus an ``is None`` branch and allocates nothing; armed, the
plane routes to the store's own :class:`ResidencyManager`.  The plane arms
only when a manager is installed (``enable_residency`` /
``set_tier(True)``).  ``RTPU_NO_TIER=1`` is the hard kill-switch:
``set_tier(True)`` becomes a no-op, so even ``CONFIG SET
residency-enabled yes`` cannot arm the guard.

Lock discipline (the dispatch path's order is lane -> record):

  * promotion runs WITHOUT the store lock (getters fire the hook after
    release), takes the record lock first, then the per-record transition
    lock, then TRIES the owner lane's bulk gate for ``gate_timeout_s`` — a
    dispatch holding the gate while waiting on this record's lock would
    otherwise deadlock lock against lock; on timeout the upload proceeds
    gateless.  A promotion fired from inside a lane occupancy (bulk or
    interactive: ``ioplane.current_stream()`` is set) takes no gate at
    all: its thread already holds one;
  * demotion try-acquires the record lock (never blocks a serving path)
    and snapshots and swaps the tensors entirely under it.

Ordering on the card: a demotion claims the record for its thread's
stream (``DeviceStore.claim``), so its device-to-host copy follows every
kernel queued on the record's lane stream, and the released tensors go
back to the allocator only once that stream passed them; a promotion
uploads on the stream current where it is fired (the lane's inside an
occupancy), and the command that touched the record claims it behind the
copy.  A packed upload refused for a dtype (one torch has no dtype for,
a non-native byte order) falls back to one upload an array, the same
bytes (``upload_array``), as the reference's does.  A promotion that
raises (``torch.cuda.OutOfMemoryError`` among others) leaves the record
WARM or COLD with its stash or spill intact, and the error reaches the
caller: no fallback puts the record on the CPU.
"""
from __future__ import annotations

import collections
import itertools
import os
import pickle
import struct
import threading
import time
import zlib
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

# interned tier constants: guard sites compare with ``is``
HOT = "hot"
WARM = "warm"
COLD = "cold"

_SPILL_FMT = 1

# -- per-device byte budget ----------------------------------------------------

DEVICE_BUDGET_BYTES = int(os.environ.get("RTPU_DEVICE_BUDGET_BYTES", "0"))
# per-device budget (per position with placement on) over every record
# kind's device bytes (0 = unlimited): the sweeper demotes the
# least-recently-touched clean records until each device fits.


def set_device_budget_bytes(value: int) -> int:
    """Set the per-device byte budget (0 = unlimited); returns previous."""
    global DEVICE_BUDGET_BYTES
    prev, DEVICE_BUDGET_BYTES = DEVICE_BUDGET_BYTES, max(0, int(value))
    return prev


# -- the disarm switch (RTPU_NO_TIER) ------------------------------------------


class _TierPlane:
    """Router the armed store-getter sites call: resolves the touched
    store's OWN manager (several engines in one process never cross-wire),
    so the module global stays a single is-None guard."""

    def on_record_access(self, store, name: str, rec) -> None:
        if getattr(_tls, "bypass", False):
            return  # census / serializer scan: observe, never promote
        mgr = getattr(store, "residency", None)
        if mgr is not None:
            mgr.on_access(name, rec)


_PLANE = _TierPlane()

# THE guard every getter site loads: None = disarmed.  Starts disarmed;
# enable_residency()/set_tier(True) arms it when a manager exists to route
# to, and RTPU_NO_TIER=1 pins it disarmed for good.
_NO_TIER = os.environ.get("RTPU_NO_TIER", "") in ("1", "true", "yes")
_tier_plane: Optional[_TierPlane] = None

_tls = threading.local()

# the default of ResidencyManager's gate_timeout_s: how long a promotion
# outside a lane occupancy waits for the owner lane's bulk gate before it
# uploads without it
GATE_TIMEOUT_S = 0.25


def tier_enabled() -> bool:
    return _tier_plane is not None


def set_tier(on: bool) -> bool:
    """Arm or disarm the residency plane; returns the previous armed state
    (callers restore it).  Under RTPU_NO_TIER=1 arming is refused: the
    environment variable is the operator's bit-identity guarantee and
    beats any in-process caller."""
    global _tier_plane
    prev = _tier_plane is not None
    _tier_plane = _PLANE if (on and not _NO_TIER) else None
    return prev


def pin_disarmed() -> None:
    """Disarm the plane for the rest of the process, as ``RTPU_NO_TIER=1``
    does (the server's ``--no-tier``): no later ``set_tier(True)``, nor
    ``CONFIG SET residency-enabled yes``, arms it."""
    global _NO_TIER
    _NO_TIER = True
    set_tier(False)


class no_promote:
    """Context: observe records without faulting them in (a metrics scrape
    or a checkpoint cut walking every record must never drag the whole
    WARM set back onto the device)."""

    def __enter__(self):
        self._prev = getattr(_tls, "bypass", False)
        _tls.bypass = True
        return self

    def __exit__(self, *exc):
        _tls.bypass = self._prev
        return False


# -- residency-aware host views (work disarmed too) ----------------------------


def host_array(value) -> np.ndarray:
    """One record array as a host numpy array of its own dtype and shape
    (a ``ShardedPlane`` gathered whole, as the reference's ``np.asarray``
    of a mesh-sharded array)."""
    from redisson_tpu_torch.parallel.sharded import ShardedPlane

    if isinstance(value, ShardedPlane):
        return value.numpy()
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def record_host_arrays(rec) -> Dict[str, Any]:
    """Host-side numpy view of a record's named arrays REGARDLESS of tier:
    the one seam the checkpoint, DUMP, COPY, replication and migration
    serializers read through, so a WARM or COLD record saves and ships
    without promotion."""
    stash = getattr(rec, "stash", None)
    if stash is not None:
        return dict(stash)
    path = getattr(rec, "cold_path", None)
    if path is not None:
        return load_spill(path)
    return {k: host_array(v) for k, v in rec.arrays.items()}


def record_device_bytes(rec) -> int:
    """Device bytes this record holds RIGHT NOW (0 for WARM/COLD)."""
    total = 0
    for a in rec.arrays.values():
        n = getattr(a, "nbytes", None)
        if n is not None:
            total += int(n)
    return total


def _storage_ptr(a) -> int:
    if not isinstance(a, torch.Tensor):
        return 0
    return a.untyped_storage().data_ptr()


def replace_planes(rec, planes: Dict[str, Any]) -> None:
    """Write `planes` into the record's arrays, and give each array it
    keeps a storage of its own where that array shares one with a plane
    nothing references any more.  A promotion cuts every array of a record
    out of ONE merged device buffer (K23); a record that then replaces
    only some of them (a vector bank grows its bank, bias and scale but
    keeps its index's centroids and cells) would otherwise keep the whole
    old buffer alive through the kept views, bytes the ledgers never
    count.  Costs one device copy of each kept view, once per promotion."""
    old = {_storage_ptr(rec.arrays.get(k)) for k in planes}
    old -= {_storage_ptr(v) for v in planes.values()}
    old.discard(0)
    rec.arrays.update(planes)
    if not old:
        return
    for k, a in list(rec.arrays.items()):
        if k not in planes and _storage_ptr(a) in old:
            rec.arrays[k] = a.clone()


def upload_array(value, device) -> torch.Tensor:
    """One host array as a tensor on `device`, the same bytes: the fault-in's
    per-array path for what the packed upload refuses.  A non-native byte
    order is read in the native one (the same values); a ``bfloat16``
    array (``ml_dtypes``, which torch.from_numpy does not read) travels
    as its uint16 bit patterns and is viewed as ``torch.bfloat16``."""
    a = np.ascontiguousarray(value)
    if not a.dtype.isnative:
        a = a.astype(a.dtype.newbyteorder("="))
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.uint16)).to(device).view(torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _host_bytes(arrays: Dict[str, Any]) -> int:
    return sum(int(getattr(a, "nbytes", 0)) for a in arrays.values())


def _array_device(rec, a) -> Optional[int]:
    """The ledger key of one record array: its owner position with
    placement on, else its device index; None for an array that is not
    one tensor (a numpy plane, a ShardedPlane), which pins the record HOT
    and counts on no device."""
    if not isinstance(a, torch.Tensor):
        return None
    if rec.position is not None:
        return int(rec.position)
    return a.device.index or 0


def _device_id(device) -> int:
    """The ledger key of a device argument: a position's id, a torch
    device's index, 0 for None."""
    if device is None:
        return 0
    dev_id = getattr(device, "id", None)
    if dev_id is not None:
        return int(dev_id)
    return torch.device(device).index or 0


# -- COLD spill container (checkpoint format: MAGIC + pickle + CRC) ------------


def write_spill(path: str, arrays: Dict[str, Any]) -> int:
    """One record's host arrays as a verified container file: the same
    MAGIC/CRC-trailer shape as checkpoints, read back by ``load_spill``
    through ``checkpoint.read_verified`` (COLD promotion = exactly one
    verified file read).  The reference's writer, so the two packages
    write the same bytes.  Returns the file's byte count."""
    from redisson_tpu_torch.core import checkpoint as ckpt

    payload = {
        "format": _SPILL_FMT,
        "arrays": {k: host_array(v) for k, v in arrays.items()},
    }
    body = ckpt.MAGIC + pickle.dumps(payload, protocol=4)
    data = body + ckpt.TRAILER_MAGIC + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(data)


def load_spill(path: str) -> Dict[str, Any]:
    """Read + CRC-verify one spill file back to host arrays (raises
    ``CheckpointCorruptError`` on a torn or forged file)."""
    from redisson_tpu_torch.core import checkpoint as ckpt

    payload = ckpt.read_verified(path)
    if (not isinstance(payload, dict) or payload.get("format") != _SPILL_FMT
            or not isinstance(payload.get("arrays"), dict)):
        raise ckpt.CheckpointCorruptError(f"not a residency spill: {path!r}")
    return dict(payload["arrays"])


# -- the manager ---------------------------------------------------------------


class ResidencyManager:
    """Per-engine tier manager: touch clock, fault-in, clock/LRU demotion
    against the per-device byte budget, COLD spill, and the census rows
    the ``CLUSTER RESIDENCY`` verb and the METRICS multi-gauge render."""

    def __init__(self, engine, spill_dir: Optional[str] = None,
                 min_idle_s: float = 0.25, cold_after_s: float = 0.0,
                 sweep_interval: float = 0.0,
                 gate_timeout_s: float = GATE_TIMEOUT_S):
        self.engine = engine
        self._spill_dir = spill_dir
        self._owns_spill_dir = False
        self.min_idle_s = float(min_idle_s)
        # WARM records idle longer than this spill COLD at a sweep (0 =
        # never on their own)
        self.cold_after_s = float(cold_after_s)
        # how long a promotion outside a lane occupancy waits for the owner
        # lane's bulk gate before it uploads without it
        self.gate_timeout_s = float(gate_timeout_s)
        # touch clock: name -> (sequence, monotonic seconds); plain dict
        # writes are atomic under the GIL, so the getter path takes no lock
        self._clock = itertools.count(1)
        self._touch: Dict[str, Tuple[int, float]] = {}
        # per-record transition locks (promote/demote mutual exclusion)
        self._tlocks: Dict[str, threading.Lock] = {}
        self._tguard = threading.Lock()
        # demotion pins: probes that flag a record dirty pin it HOT.  A
        # vector bank mid-accumulation (pending rows) must not demote
        # between a row write and its flush.
        self.pin_probes: List[Callable[[str, Any], bool]] = [
            self._vector_pending_probe,
        ]
        # slot-fence probe (the server wires migrating/importing/
        # recovering): fenced slots never demote, their records are
        # mid-handoff
        self.fence_check: Callable[[str], bool] = lambda name: False
        self.promotions = 0
        self.demotions_warm = 0
        self.demotions_cold = 0
        self.cold_loads = 0
        self.fault_in_ms_total = 0.0
        self.fault_in_ms_max = 0.0
        # bounded ring of promotion durations (the fault-in p99's source)
        self.fault_in_samples: Deque[float] = collections.deque(maxlen=4096)
        self._sweeper: Optional[threading.Thread] = None
        self._sweep_interval = 0.0
        self._stop = threading.Event()
        # set by close(): no demotion starts, so a detach cannot strand one
        self._closing = False
        if sweep_interval > 0:
            self.start_sweeper(sweep_interval)

    # -- plumbing -------------------------------------------------------------

    def _tlock(self, name: str) -> threading.Lock:
        with self._tguard:
            lk = self._tlocks.get(name)
            if lk is None:
                lk = self._tlocks[name] = threading.Lock()
            return lk

    def spill_dir(self) -> str:
        if self._spill_dir is None:
            import tempfile

            self._spill_dir = tempfile.mkdtemp(prefix="rtpu-residency-")
            self._owns_spill_dir = True
        else:
            os.makedirs(self._spill_dir, exist_ok=True)
        return self._spill_dir

    def _spill_path(self, name: str) -> str:
        import hashlib

        h = hashlib.sha256(name.encode()).hexdigest()[:32]
        return os.path.join(self.spill_dir(), f"{h}.spill")

    def _vector_pending_probe(self, name: str, rec) -> bool:
        if rec.kind != "vector_bank":
            return False
        from redisson_tpu_torch.services.vector import bank_has_pending

        return bank_has_pending(self.engine.store, name)

    def touch_age(self, name: str) -> float:
        t = self._touch.get(name)
        return float("inf") if t is None else time.monotonic() - t[1]

    # -- the getter hook (armed path) -----------------------------------------

    def on_access(self, name: str, rec) -> None:
        self._touch[name] = (next(self._clock), time.monotonic())
        if rec.tier is not HOT and rec.tier != HOT:
            self.fault_in(name, rec)

    # -- fault-in (promotion) -------------------------------------------------

    def fault_in(self, name: str, rec) -> None:
        """Promote a WARM/COLD record back to HOT: one packed host-to-device
        copy through the owner lane's staging slot (COLD first pays one
        verified spill read).  Synchronous: the touching command proceeds
        only once the tensors are on the device (in stream order), so its
        QoS admission window charges the fault-in.  A failed upload leaves
        the record in its tier with its stash or spill, and raises."""
        eng = self.engine
        t0 = time.monotonic()
        from_tier = rec.tier
        with eng.locked(name):
            with self._tlock(name):
                if rec.tier == HOT:
                    return  # raced with another promoter
                stash = rec.stash
                if stash is None:
                    path = rec.cold_path
                    if path is None:
                        # nothing to restore (an empty record demoted)
                        rec.tier = HOT
                        return
                    stash = load_spill(path)
                    self.cold_loads += 1
                nbytes = _host_bytes(stash)
                device = eng.device_for_name(name)
                self._upload(name, rec, stash, device)
                rec.stash = None
                if rec.cold_path is not None:
                    try:
                        os.unlink(rec.cold_path)
                    except OSError:
                        pass
                    rec.cold_path = None
                rec.tier = HOT
                self.promotions += 1
        dt_ms = (time.monotonic() - t0) * 1e3
        self.fault_in_ms_total += dt_ms
        if dt_ms > self.fault_in_ms_max:
            self.fault_in_ms_max = dt_ms
        self.fault_in_samples.append(dt_ms)
        from redisson_tpu_torch.observe import trace as _obs

        if _obs._tracer is not None:
            tr = _obs.current_trace()
            if tr is not None:
                from redisson_tpu_torch.core.ioplane import current_stream

                tr.add_span(
                    "promote", t0, time.monotonic(), record=name,
                    tier=from_tier, bytes=nbytes,
                    stream=current_stream() or "bulk",
                )

    def _upload(self, name: str, rec, stash: Dict[str, Any], device) -> None:
        """ONE packed host-to-device copy of the stash onto `device` (a
        position with placement on, else the engine's device).  The owner
        lane's bulk gate is TRIED, never waited on without a bound, so a
        dispatch holding it while waiting on this record's lock cannot
        deadlock against us; a promotion fired inside a lane occupancy
        (bulk or interactive) takes no gate, its thread holds one.

        The tensors returned are views of ONE merged device buffer, so a
        record that later replaces some of its arrays must do it through
        :func:`replace_planes`: a kept view would hold the whole old buffer
        on the card, bytes no ledger counts."""
        from redisson_tpu_torch.core import ioplane

        lane = None
        if device is not None and self.engine.lanes is not None:
            lane = self.engine.lanes.lane(device)
        gate = None
        if lane is not None and ioplane.current_stream() is None:
            if lane._gate.acquire(timeout=self.gate_timeout_s):
                gate = lane._gate
        try:
            target = self.engine.device if device is None else device.device
            pool = self.engine.staging_pool(device)
            try:
                arrays = ioplane.scatter_host_arrays(stash, target, pool=pool)
            except (TypeError, ValueError):
                # the packed path refused a dtype (one torch has no dtype
                # for, or a byte order it does not read): each array
                # uploads on its own, the same bytes
                arrays = {k: upload_array(v, target) for k, v in stash.items()}
            rec.arrays.update(arrays)
            # the tensors are the upload's stream's from here on
            rec.stream = None
            self.engine.store.claim(rec)
        finally:
            if gate is not None:
                gate.release()

    # -- demotion -------------------------------------------------------------

    def _demotable(self, name: str, rec) -> bool:
        """Clean, single-tensor, unfenced, idle: the safe-by-construction
        predicate.  Anything ambiguous pins HOT."""
        if rec.tier != HOT or not rec.arrays or rec.expired():
            return False
        if self.touch_age(name) < self.min_idle_s:
            return False  # touched too recently: closes the get-read race
        if self.fence_check(name):
            return False  # migrating/importing/recovering slot
        for probe in self.pin_probes:
            try:
                if probe(name, rec):
                    return False  # dirty (pending vector rows)
            except Exception:  # noqa: BLE001 — a broken probe pins, never
                return False   # unpins: fail safe
        for a in rec.arrays.values():
            if _array_device(rec, a) is None:
                return False  # a host-side or sharded plane
        return True

    def demote(self, name: str, cold: bool = False,
               force: bool = False) -> bool:
        """Release one record's tensors to its host stash (WARM), or spill
        the stash to disk (COLD).  Never blocks a serving path: the record
        lock is TRY-acquired; a busy record just stays HOT.  Returns True
        iff the tier actually changed."""
        eng = self.engine
        ctx = eng.try_locked(name)
        if ctx is None:
            return False
        with ctx:
            with self._tlock(name):
                if self._closing:
                    return False  # the plane is being detached
                rec = eng.store.get_unguarded(name)
                if rec is None:
                    return False
                if rec.tier == HOT:
                    if not force and not self._demotable(name, rec):
                        return False
                    if force and (not rec.arrays or self.fence_check(name)):
                        return False
                    # one device-to-host copy a tensor (a ShardedPlane
                    # gathered whole, a numpy plane as it is), each after
                    # the kernels queued on the record (``claim``); a
                    # forced demotion takes any record, as the reference's
                    # does, and the fault-in brings it back as tensors on
                    # its owner's card
                    eng.store.claim(rec)
                    stash = {k: host_array(v) for k, v in rec.arrays.items()}
                    dev = -1
                    for a in rec.arrays.values():
                        d = _array_device(rec, a)
                        if d is not None:
                            dev = d
                            break
                    rec.arrays.clear()
                    rec.stash = stash
                    rec.stash_dev = dev
                    rec.tier = WARM
                    self.demotions_warm += 1
                    if not cold:
                        return True
                if cold and rec.tier == WARM and rec.stash is not None:
                    path = self._spill_path(name)
                    write_spill(path, rec.stash)
                    rec.cold_path = path
                    rec.cold_bytes = _host_bytes(rec.stash)
                    rec.stash = None
                    rec.tier = COLD
                    self.demotions_cold += 1
                    return True
        return False

    # -- pressure / budget ----------------------------------------------------

    def hot_bytes_by_device(self) -> Dict[int, int]:
        """Device bytes by ledger key (position or device index) over every
        live record: the demotion pressure signal."""
        out: Dict[int, int] = {}
        with no_promote():
            for _kind, rec in self.engine.store.census_records():
                for a in list(rec.arrays.values()):
                    d = _array_device(rec, a)
                    if d is not None:
                        out[d] = out.get(d, 0) + int(a.nbytes)
        return out

    def _candidates_on(self, dev_id: int, exclude=()) -> List[Tuple[float, str, int]]:
        """(idle_age, name, device_bytes) of demotable records whose tensors
        live on `dev_id`, coldest (longest-idle) first."""
        cands: List[Tuple[float, str, int]] = []
        with self.engine.store._lock:
            items = list(self.engine.store._states.items())
        for name, rec in items:
            if name in exclude or rec.expired() or rec.tier != HOT:
                continue
            nbytes = 0
            on_dev = False
            for a in list(rec.arrays.values()):
                if _array_device(rec, a) == dev_id:
                    on_dev = True
                    nbytes += int(a.nbytes)
            if on_dev and self._demotable(name, rec):
                cands.append((self.touch_age(name), name, nbytes))
        cands.sort(reverse=True)  # longest idle first
        return cands

    def make_room(self, dev_id: int, need_bytes: int, exclude=()) -> int:
        """Demote longest-idle clean records off `dev_id` until
        `need_bytes` are freed (or candidates run out).  Returns freed."""
        freed = 0
        for _age, name, nbytes in self._candidates_on(dev_id, exclude):
            if freed >= need_bytes:
                break
            if self.demote(name):
                freed += nbytes
        return freed

    def admit_device_alloc(self, device, delta_bytes: int,
                           exclude=()) -> None:
        """Growth admission against ``device-budget-bytes``: demote colder
        records first, refuse (VectorBudgetError) only as the LAST resort."""
        budget = DEVICE_BUDGET_BYTES
        if not budget or delta_bytes <= 0:
            return
        dev_id = _device_id(device)
        hot = self.hot_bytes_by_device().get(dev_id, 0)
        over = hot + delta_bytes - budget
        if over <= 0:
            return
        freed = self.make_room(dev_id, over, exclude=exclude)
        if freed < over:
            from redisson_tpu_torch.services.vector import VectorBudgetError

            raise VectorBudgetError(
                f"allocating {delta_bytes} bytes on device {dev_id} exceeds "
                f"the {budget}-byte device-budget-bytes and only {freed} of "
                f"the needed {over} bytes were demotable (the rest is hot, "
                f"dirty, or fenced)"
            )

    # -- sweeper --------------------------------------------------------------

    def sweep(self) -> Dict[str, int]:
        """One control-loop pass: (1) demote each over-budget device back
        under ``device-budget-bytes``; (2) spill WARM records idle for
        ``cold_after_s`` or longer COLD (with it set); (3) GC spill files
        of deleted records."""
        out = {"demoted": 0, "colded": 0, "freed_bytes": 0}
        budget = DEVICE_BUDGET_BYTES
        if budget:
            for dev_id, hot in self.hot_bytes_by_device().items():
                if hot > budget:
                    before = self.demotions_warm
                    out["freed_bytes"] += self.make_room(dev_id, hot - budget)
                    out["demoted"] += self.demotions_warm - before
        if self.cold_after_s > 0:
            with self.engine.store._lock:
                warm = [
                    n for n, r in self.engine.store._states.items()
                    if r.tier == WARM and not r.expired()
                ]
            for name in warm:
                if self.touch_age(name) >= self.cold_after_s:
                    if self.demote(name, cold=True):
                        out["colded"] += 1
        self._gc_spills()
        return out

    def _gc_spills(self) -> None:
        if self._spill_dir is None or not os.path.isdir(self._spill_dir):
            return
        with self.engine.store._lock:
            live = {
                r.cold_path for r in self.engine.store._states.values()
                if r.cold_path is not None
            }
        for fn in os.listdir(self._spill_dir):
            if not fn.endswith(".spill"):
                continue
            path = os.path.join(self._spill_dir, fn)
            if path not in live:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def start_sweeper(self, interval: float) -> None:
        if self._sweeper is not None:
            return
        self._sweep_interval = float(interval)
        self._stop.clear()

        def _run():
            while not self._stop.wait(self._sweep_interval):
                try:
                    self.sweep()
                except Exception:  # noqa: BLE001 — sweep must never die
                    pass

        self._sweeper = threading.Thread(
            target=_run, name="rtpu-residency", daemon=True
        )
        self._sweeper.start()

    def _halt_sweeper(self) -> None:
        self._stop.set()
        t = self._sweeper
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        self._sweeper = None

    def close(self) -> float:
        """Stop every demotion before a detach: no demotion starts after
        this returns (each checks ``_closing`` under its record's transition
        lock, and every transition lock is taken once here, so one already
        past the check has finished), and the sweeper is stopped.  Returns
        the sweeper's interval (0.0 if none ran) for :meth:`reopen`."""
        interval = self._sweep_interval if self._sweeper is not None else 0.0
        self._closing = True
        self._halt_sweeper()
        with self._tguard:
            locks = list(self._tlocks.values())
        for lk in locks:
            with lk:
                pass
        return interval

    def reopen(self, sweep_interval: float) -> None:
        """Undo :meth:`close` (a detach that failed part way)."""
        self._closing = False
        if sweep_interval > 0:
            self.start_sweeper(sweep_interval)

    def stop(self) -> None:
        self._halt_sweeper()
        if self._owns_spill_dir and self._spill_dir is not None:
            import shutil

            shutil.rmtree(self._spill_dir, ignore_errors=True)
            self._spill_dir = None
            self._owns_spill_dir = False

    # -- census / observability -----------------------------------------------

    def census(self) -> Dict[str, float]:
        """Per-device per-tier byte rows (nonzero only, so DEL drains them
        to absence) plus the monotonic counters."""
        hot: Dict[int, int] = {}
        warm: Dict[int, int] = {}
        cold: Dict[int, int] = {}
        with self.engine.store._lock:
            items = list(self.engine.store._states.items())
        with no_promote():
            for _name, rec in items:
                if rec.expired():
                    continue
                if rec.tier == WARM and rec.stash is not None:
                    d = rec.stash_dev
                    warm[d] = warm.get(d, 0) + _host_bytes(rec.stash)
                elif rec.tier == COLD:
                    d = rec.stash_dev
                    cold[d] = cold.get(d, 0) + int(rec.cold_bytes)
                else:
                    for a in list(rec.arrays.values()):
                        d = _array_device(rec, a)
                        if d is not None:
                            hot[d] = hot.get(d, 0) + int(a.nbytes)
        rows: Dict[str, float] = {}
        for tier, per in (("hot", hot), ("warm", warm), ("cold", cold)):
            for d, n in sorted(per.items()):
                if n:
                    rows[f"residency_bytes_dev{d}_{tier}"] = float(n)
        rows["residency_promotions"] = float(self.promotions)
        rows["residency_demotions_warm"] = float(self.demotions_warm)
        rows["residency_demotions_cold"] = float(self.demotions_cold)
        rows["residency_cold_loads"] = float(self.cold_loads)
        rows["residency_fault_in_ms_total"] = round(self.fault_in_ms_total, 3)
        rows["residency_fault_in_ms_max"] = round(self.fault_in_ms_max, 3)
        return rows

    def tier_of(self, name: str) -> Optional[str]:
        with no_promote():
            rec = self.engine.store.get_unguarded(name)
        return None if rec is None else rec.tier
