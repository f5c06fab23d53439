"""Embedded execution engine shared by every object handle.

The engine owns:
  * the torch device that holds all state (a CUDA card by default),
  * the DeviceStore (the "server state"),
  * key packing (codec bytes / int64 -> padded int32 word tensors),
  * the query cache for read paths (core/kernels.py QueryCache),
  * the pinned double-buffered staging pool of flush packing
    (core/ioplane.py StagingPool),
  * per-record mutual exclusion: every compound mutation of one object runs
    under its record lock, one writer per object,
  * engine-scoped services (``service``: the word count's scan views),
  * ONE wheel timer (``timer``, utils/timer.py) with the pools that run its
    tasks: write-behind flushes and delayed-queue transfers
    (``schedule_timeout`` on ``timer_pool``), lock watchdogs
    (``start_renewal`` on their own pool), MapCache listener events
    (``events_pool``, one worker), never a thread per timeout,
  * the synchronizers' wait entries (``wait_entry``; the blocking queues'
    ``queue_wait_entry``) and the identity a remote caller's locks are
    held under (``impersonate``),
  * the in-process pub/sub hub (``pubsub``) the server's SUBSCRIBE and
    PUBLISH verbs and the topics use,
  * the background expiry sweep (``eviction``): started on first use, it
    reaps the store's expired records (``__store__``) on the cadence of
    ``config`` (``min_cleanup_delay`` .. ``max_cleanup_delay``),
  * the closers of the services that started threads on it (``on_shutdown``:
    executor workers and schedules, remote-service workers), which
    ``shutdown`` runs first, so a shut-down engine leaves no thread of its
    own behind.

With ``enable_placement`` the 16384-slot table maps onto the mesh
positions (``server/placement.py``): every record installed from then on is
owned by its slot's position (``StateRecord.position``), the engine keeps a
serving lane a position (``lanes``, ``core/ioplane.LaneSet``), and
``move_slot_records`` hands a slot to another position under the record
locks, fenced by epoch.

A trimmed copy of ``redisson_tpu/core/engine.py``: residency and the warm
pool (``prewarm`` and its ``all_devices``) belong to the operations slice.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from redisson_tpu_torch.client.codec import DEFAULT_CODEC, Codec
from redisson_tpu_torch.config import Config
from redisson_tpu_torch.core import ioplane
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core.pubsub import PubSubHub
from redisson_tpu_torch.core.store import DeviceStore
from redisson_tpu_torch.utils import hashing as H


def resolve_device(device) -> torch.device:
    """The device to hold state on; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "redisson_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _device_key(device) -> Tuple[str, int]:
    """A torch device with its index filled in (cuda is cuda:0 unless said)."""
    device = torch.device(device)
    return device.type, device.index or 0


class Engine:
    def __init__(self, config=None, device="cuda"):
        self.device = resolve_device(device)
        self.config = config if config is not None else Config()
        self.store = DeviceStore()
        self.pubsub = PubSubHub()
        self.default_codec: Codec = DEFAULT_CODEC
        self.query_cache = K.QueryCache()
        # staging shared by every flush packer of this engine
        self.staging = ioplane.StagingPool(pin=self.device.type == "cuda")
        # name -> [RLock, refcount]: entries exist only while someone holds or
        # waits on them, so object churn can't grow the registry unboundedly
        self._record_locks: dict[str, list] = {}
        self._locks_guard = threading.Lock()
        self._services: dict = {}
        self._eviction = None
        self._wait_entries: dict = {}
        self._holder_override = threading.local()
        self._timer = None
        self._timer_pool = None
        self._renewal_pool_ = None
        self._events_pool_ = None
        # (name, holder) -> Timeout: active lock-watchdog renewals, all on
        # the ONE shared wheel timer
        self._renewals: dict[tuple, Any] = {}
        self._closers: list = []
        self._closed = False
        # device-sharded serving: slot -> position placement and a serving
        # lane a position; None keeps the single-device engine
        self.placement = None
        self.lanes = None

    @property
    def eviction(self):
        """The expiry sweep, started on first use with the store's reaper."""
        def make():
            from redisson_tpu_torch.core.eviction import EvictionScheduler

            sched = EvictionScheduler(
                min_delay=self.config.min_cleanup_delay,
                max_delay=self.config.max_cleanup_delay,
            )
            sched.schedule("__store__", self.store.reap_expired)
            return sched

        return self._lazy("_eviction", make)

    def _lazy(self, attr: str, make):
        """The engine's lazily made service under `attr` (made under the
        registry guard); raises once the engine is shut down."""
        with self._locks_guard:
            if self._closed:
                raise RuntimeError("engine is shut down")
            value = getattr(self, attr)
            if value is None:
                value = make()
                setattr(self, attr, value)
            return value

    # -- locking ------------------------------------------------------------

    def _acquire_entry(self, name: str) -> list:
        with self._locks_guard:
            entry = self._record_locks.get(name)
            if entry is None:
                entry = self._record_locks[name] = [threading.RLock(), 0]
            entry[1] += 1
            return entry

    def _release_entry(self, name: str, entry: list) -> None:
        with self._locks_guard:
            entry[1] -= 1
            if entry[1] == 0:
                self._record_locks.pop(name, None)

    @contextmanager
    def locked(self, name: str):
        entry = self._acquire_entry(name)
        try:
            with entry[0]:
                yield
        finally:
            self._release_entry(name, entry)

    @contextmanager
    def locked_many(self, names: Iterable[str]):
        """Acquire several record locks in sorted-name order (deadlock-free
        for concurrent multi-object ops like PFMERGE)."""
        entries = [(n, self._acquire_entry(n)) for n in sorted(set(names))]
        acquired = []
        try:
            for _n, entry in entries:
                entry[0].acquire()
                acquired.append(entry)
            yield
        finally:
            for entry in reversed(acquired):
                entry[0].release()
            for n, entry in entries:
                self._release_entry(n, entry)

    # -- services and timers -------------------------------------------------

    def service(self, key: str, factory):
        """Engine-scoped lazy singleton: one instance per engine, whichever
        handle asks first."""
        with self._locks_guard:
            svc = self._services.get(key)
            if svc is None:
                svc = self._services[key] = factory()
            return svc

    # -- synchronizer identities and wait entries ------------------------------

    @contextmanager
    def impersonate(self, holder_id: Optional[str]):
        """Execute with an explicit synchronizer-holder identity: the server
        runs remote calls under the CLIENT's uuid:threadId (the reference's
        LockName travels from client to Lua the same way)."""
        if holder_id is None:
            yield
            return
        prev = getattr(self._holder_override, "value", None)
        self._holder_override.value = holder_id
        try:
            yield
        finally:
            self._holder_override.value = prev

    def holder_override(self) -> Optional[str]:
        return getattr(self._holder_override, "value", None)

    def wait_entry(self, key: str):
        """Shared per-key wait latch (one latch per waiting object).

        Idle entries (no waiters, no buffered signal, untouched for 60s) are
        pruned by a sweep on the eviction thread; every park is a bounded
        retry loop, so a signal lost to a prune costs one park timeout,
        never a hang."""
        from redisson_tpu_torch.core.pubsub import WaitEntry

        with self._locks_guard:
            we = self._wait_entries.get(key)
            if we is None:
                we = self._wait_entries[key] = WaitEntry()
        we.touch()  # a fetched entry is in use: restart its idle clock
        try:
            self.eviction.schedule("__wait_entry_gc__", self._gc_wait_entries)
        except RuntimeError:
            # engine shut down between the entry fetch and the schedule; the
            # caller's park loop is bounded, so skipping the GC is harmless
            pass
        return we

    def _gc_wait_entries(self, max_idle: float = 60.0) -> int:
        with self._locks_guard:
            stale = [k for k, we in self._wait_entries.items() if we.idle(max_idle)]
            for k in stale:
                del self._wait_entries[k]
        return len(stale)

    def queue_wait_entry(self, name: str):
        """The wait entry blocking-queue-family consumers park on: the one
        authority for the __q_wait__ key format (paired with
        signal_queue_waiters)."""
        return self.wait_entry(f"__q_wait__:{name}")

    def signal_queue_waiters(self, name: str) -> None:
        """Wake queue-family waiters parked on `name` without making a wait
        entry when nobody waits."""
        e = self._wait_entries.get(f"__q_wait__:{name}")
        if e is not None:
            e.signal(all_=True)

    # -- timers --------------------------------------------------------------

    @property
    def timer(self):
        """ONE shared wheel timer for every timeout of this engine."""
        from redisson_tpu_torch.utils.timer import HashedWheelTimer

        return self._lazy("_timer", HashedWheelTimer)

    @property
    def timer_pool(self):
        """Small shared pool that RUNS timed tasks: wheel ticks only
        enqueue, so a task blocking on a record lock (or on user MapWriter
        I/O) never stalls every other timeout."""
        return self._lazy("_timer_pool", lambda: ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="rtpu-timer-task"))

    def schedule_timeout(self, fn, delay: float):
        """Run `fn` ~`delay` seconds from now on the shared timer pool.
        Returns the wheel Timeout (cancellable until it fires)."""
        pool = self.timer_pool
        return self.timer.new_timeout(lambda: pool.submit(fn), delay)

    @property
    def events_pool(self):
        """SINGLE-worker pool delivering entry events (MapCache listeners):
        events of one object arrive in mutation order, and a mutator never
        runs user listeners while it holds the record lock."""
        return self._lazy("_events_pool_", lambda: ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rtpu-events"))

    @property
    def _renewal_pool(self):
        """Dedicated pool for lease renewals: sharing a pool with user work
        (MapWriter flushes) would let a blocked writer starve renewals past
        lease expiry, two holders of one lock.  Several workers, so one
        renewal stuck on a contended record lock delays no other."""
        return self._lazy("_renewal_pool_", lambda: ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="rtpu-renewal"))

    def start_renewal(self, name: str, holder: str, renew, interval: float) -> None:
        """Register a watchdog renewal for (lock name, holder): one renewal
        per (entry, holder) whatever the reentrancy; `renew()` returns True
        to keep renewing, False to stop."""
        key = (name, holder)

        def tick():
            # runs on the renewal POOL (renew takes record locks and must
            # not block the wheel thread)
            try:
                keep = bool(renew())
            except Exception:  # noqa: BLE001 — a failing renew stops renewing
                keep = False
            with self._locks_guard:
                if key not in self._renewals or not keep or self._closed:
                    self._renewals.pop(key, None)
                    return
            nxt = self._schedule_renewal_tick(tick, interval)
            with self._locks_guard:
                if key in self._renewals:
                    self._renewals[key] = nxt
                else:
                    nxt.cancel()  # cancel_renewal raced the reschedule

        with self._locks_guard:
            if key in self._renewals:
                return  # reentrant re-acquire keeps the existing renewal
            self._renewals[key] = None  # claim the slot before scheduling
        first = self._schedule_renewal_tick(tick, interval)
        with self._locks_guard:
            if key in self._renewals:
                self._renewals[key] = first
            else:
                first.cancel()  # cancelled between claim and schedule

    def _schedule_renewal_tick(self, tick, interval: float):
        pool = self._renewal_pool
        return self.timer.new_timeout(lambda: pool.submit(tick), interval)

    def cancel_renewal(self, name: str, holder: Optional[str] = None) -> None:
        """Stop renewals for a lock (all holders when holder is None: the
        force_unlock path)."""
        with self._locks_guard:
            keys = [k for k in self._renewals
                    if k[0] == name and (holder is None or k[1] == holder)]
            for k in keys:
                t = self._renewals.pop(k)
                if t is not None:  # None = start_renewal's claim placeholder
                    t.cancel()

    # -- device placement and staging ----------------------------------------

    def enable_placement(self, devices=None, n_devices: Optional[int] = None):
        """Map the 16384-slot table onto mesh positions (`devices`, default
        `n_devices` local positions of the engine's device kind, all when
        None): every record installed from here on is owned by its slot's
        position, frames routed to different positions dispatch down their
        own lanes, and coalesced runs fuse a position at a time.  Returns
        the SlotPlacement.

        The positions must all be the engine's device: the object handles
        stage their keys on it, so records on several cards would need
        handles that stage on a record's card (ROADMAP queue 1: placement
        over positions on more than one card)."""
        from redisson_tpu_torch.parallel.mesh import local_devices
        from redisson_tpu_torch.server.placement import SlotPlacement

        if devices is None:
            devices = local_devices(self.device, count=n_devices)
            n_devices = None
        placement = SlotPlacement(devices=devices, n_devices=n_devices)
        home = _device_key(self.device)
        if any(_device_key(getattr(d, "device", d)) != home for d in placement.devices):
            raise NotImplementedError(
                "placement over positions on more than one device is not served "
                "yet (ROADMAP queue 1); every position must be the engine's "
                f"device {self.device}"
            )
        with self._locks_guard:
            self.placement = placement
            self.lanes = ioplane.LaneSet(placement.devices)
        self.store.placement_hook = self._place_record
        return placement

    def device_for_name(self, name: str):
        """Owner position of `name`'s slot, or None with placement off."""
        p = self.placement
        return None if p is None else p.device_for_name(name)

    def _place_record(self, name: str, rec) -> None:
        """DeviceStore placement hook: the record's owner is its slot's
        position.  Every position is on the engine's device, so no tensor
        moves."""
        p = self.placement
        if p is not None:
            rec.position = p.device_id_for_name(name)

    def move_slots_records(self, targets: Dict[int, int],
                           epoch: Optional[int] = None,
                           skip_stale: bool = False) -> Tuple[int, int]:
        """Bulk fenced slot -> position handoff: fence and repoint every slot
        of ``targets`` ({slot: position index}), then re-own the affected
        records in ONE store scan, each under its record lock (a dispatch in
        flight holds the lock and finishes under the old owner).  Returns
        (records moved, stale slots); a stale coordinator's epoch raises
        PlacementStaleEpoch unless ``skip_stale`` counts it instead."""
        from redisson_tpu_torch.server.placement import PlacementStaleEpoch
        from redisson_tpu_torch.utils.crc16 import calc_slot

        p = self.placement
        if p is None:
            raise RuntimeError("placement is not enabled on this engine")
        fenced: Dict[int, int] = {}
        stale = 0
        for slot, dev_index in targets.items():
            try:
                p.assign(slot, dev_index, epoch)  # fences + repoints routing
                fenced[slot] = dev_index
            except PlacementStaleEpoch:
                if not skip_stale:
                    raise
                stale += 1  # a newer rebalance owns this slot now
        if not fenced:
            return 0, stale
        moving = [
            (n, fenced[s])
            for n in self.store.keys()
            for s in (calc_slot(n.encode()),)
            if s in fenced
        ]
        moved = 0
        for name, dev_index in moving:
            with self.locked(name):
                rec = self.store.get_unguarded(name)
                if rec is not None and rec.position != dev_index:
                    rec.position = dev_index
                    moved += 1
        return moved, stale

    def move_slot_records(self, slot: int, dev_index: int,
                          epoch: Optional[int] = None) -> int:
        """One fenced slot -> position handoff (CLUSTER DEVMOVE's unit)."""
        moved, _stale = self.move_slots_records({slot: dev_index}, epoch)
        return moved

    def staging_pool(self, device=None):
        """The engine's pinned double-buffered staging pool, or None when the
        overlap plane is off (the serial A/B reference) or the device is
        the CPU, where slot reuse would rewrite a staged tensor
        (ioplane.staging_reuse_safe).  With placement on and a `device` (a
        position) given, that position's lane pool (its interactive slot
        inside an interactive occupancy): each lane's uploads double-buffer
        on their own."""
        if not (ioplane.overlap_enabled() and ioplane.staging_reuse_safe(self.device)):
            return None
        if device is not None and self.lanes is not None:
            lane = self.lanes.lane(device)
            # an interactive occupancy marks its thread, so its packing
            # stages through the lane's interactive slot
            if ioplane.current_stream() == "interactive":
                return lane.ipool
            return lane.pool
        return self.staging

    # -- key packing --------------------------------------------------------

    @staticmethod
    def is_int_batch(objs) -> bool:
        return isinstance(objs, np.ndarray) and objs.dtype.kind in "iu"

    def pack_keys(self, objs, codec: Optional[Codec],
                  cache_hot: bool = False) -> Tuple[str, tuple, int]:
        """Normalize a key batch for the hash kernels.

        Returns (kind, arrays, n_valid):
          kind="u64":   arrays = ONE (2, B) int32 tensor (rows lo, hi)
          kind="bytes": arrays = (words[W, B], nbytes[B]) int32 tensors

        numpy integer arrays are hashed as int64 directly, skipping the codec.
        """
        codec = codec or self.default_codec
        if self.is_int_batch(objs):
            arr = np.ascontiguousarray(objs, dtype=np.int64)
            n = arr.shape[0]
            b = K.bucket_size(max(1, n))

            def build():
                lo, hi = H.int_keys_to_u32_pair(arr)
                return K.pack_rows(lo, hi, size=b, device=self.device, pool=self.staging_pool())

            if cache_hot and n >= 4096:
                # hot-set reuse, READ paths only: a serving loop re-probing
                # the same working set skips the pack and the upload
                return "u64", self.query_cache.cached_staged(build, arr, extra=b"u64%d" % b), n
            return "u64", build(), n
        if isinstance(objs, (bytes, str, int, float)) or not isinstance(objs, (list, tuple, np.ndarray)):
            objs = [objs]
        encoded = [o if isinstance(o, bytes) else codec.encode(o) for o in objs]
        n = len(encoded)
        words, nbytes = H.pack_keys(encoded)
        b = K.pow2_bucket(max(1, n))
        w = max(4, K.pow2_bucket(max(1, words.shape[0]), minimum=4))
        words = K.stage(K.pad_to(K.pad_to(words, b, axis=1), w, axis=0), self.device)
        nbytes = K.stage(K.pad_to(nbytes, b), self.device)
        return "bytes", (words, nbytes), n

    # -- lifecycle ----------------------------------------------------------

    def on_shutdown(self, closer) -> None:
        """Run `closer()` at the start of ``shutdown``: a service that
        starts threads registers the call that stops and joins them."""
        with self._locks_guard:
            self._closers.append(closer)

    def shutdown(self):
        with self._locks_guard:
            closers, self._closers = self._closers, []
        for close in closers:
            close()
        with self._locks_guard:
            self._closed = True
            eviction, self._eviction = self._eviction, None
            timer, self._timer = self._timer, None
            pools = (self._timer_pool, self._renewal_pool_, self._events_pool_)
            self._timer_pool = self._renewal_pool_ = self._events_pool_ = None
            renewals = list(self._renewals.values())
            self._renewals.clear()
            self._services.clear()
        for t in renewals:
            if t is not None:
                t.cancel()
        if timer is not None:
            timer.stop()
        for p in pools:
            if p is not None:
                p.shutdown(wait=False, cancel_futures=True)
        if eviction is not None:
            eviction.close()
        self.pubsub.close()
        self.query_cache.clear()
        self.staging.clear()
        if self.lanes is not None:
            self.lanes.clear()
        self.store.flushall()
