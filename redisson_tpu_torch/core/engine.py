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
  * engine-scoped services (``service``: the word count's scan views) and
    the timers of write-behind maps (``schedule_timeout``),
  * the in-process pub/sub hub (``pubsub``) the server's SUBSCRIBE and
    PUBLISH verbs use,
  * the background expiry sweep (``eviction``): started on first use, it
    reaps the store's expired records (``__store__``) on the cadence of
    ``config`` (``min_cleanup_delay`` .. ``max_cleanup_delay``).

A trimmed copy of ``redisson_tpu/core/engine.py``: device placement,
residency, serving lanes, lock renewal and the warm pool belong to later
slices.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterable, Optional, Tuple

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
        self._closed = False

    @property
    def eviction(self):
        """The expiry sweep, started on first use with the store's reaper."""
        with self._locks_guard:
            if self._closed:
                raise RuntimeError("engine is shut down")
            if self._eviction is None:
                from redisson_tpu_torch.core.eviction import EvictionScheduler

                self._eviction = EvictionScheduler(
                    min_delay=self.config.min_cleanup_delay,
                    max_delay=self.config.max_cleanup_delay,
                )
                self._eviction.schedule("__store__", self.store.reap_expired)
            return self._eviction

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

    @staticmethod
    def schedule_timeout(fn, delay: float) -> threading.Timer:
        """Run `fn` on its own daemon thread ~`delay` seconds from now;
        the returned timer can be cancelled until it fires."""
        timer = threading.Timer(delay, fn)
        timer.daemon = True
        timer.start()
        return timer

    # -- device placement and staging ----------------------------------------

    def device_for_name(self, name: str):
        """Owner device of `name`'s slot; None, as the port has no placement
        yet (every record lives on self.device)."""
        return None

    def staging_pool(self, device=None):
        """The engine's pinned double-buffered staging pool, or None when the
        overlap plane is off (the serial A/B reference) or the device is
        the CPU, where slot reuse would rewrite a staged tensor
        (ioplane.staging_reuse_safe).  `device` names a placement lane's
        pool in the reference; the port has one pool."""
        if not (ioplane.overlap_enabled() and ioplane.staging_reuse_safe(self.device)):
            return None
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

    def shutdown(self):
        with self._locks_guard:
            self._closed = True
            eviction, self._eviction = self._eviction, None
            self._services.clear()
        if eviction is not None:
            eviction.close()
        self.pubsub.close()
        self.query_cache.clear()
        self.staging.clear()
        self.store.flushall()
