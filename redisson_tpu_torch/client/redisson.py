"""RedissonTpu: the entry facade of the port (Redisson.create analog).

One client over one embedded Engine, with the factories of
``redisson_tpu/client/redisson.py`` for the objects the port has: sketches,
bit sets, buckets and counters, maps and map caches, adders, sets, sorted
sets, lists, multimaps, the twelve queue classes, locks, semaphores,
latches, rate limiters, topics, keys, MapReduce, search and batches.
Object handles are cheap and stateless; create them freely.  The stream,
geo, time-series, binary-stream, local-cached-map and cache-manager
factories come with those objects (ROADMAP M7).
"""
from __future__ import annotations

from typing import Optional

from redisson_tpu_torch.client.codec import Codec
from redisson_tpu_torch.core.batch import Batch
from redisson_tpu_torch.core.engine import Engine


class RedissonTpu:
    def __init__(self, engine: Engine):
        self._engine = engine

    @classmethod
    def create(cls, config=None, device="cuda") -> "RedissonTpu":
        """Embedded-mode client whose state lives on `device` (a CUDA card
        unless the caller asks for the CPU)."""
        return cls(Engine(config, device))

    @property
    def engine(self) -> Engine:
        return self._engine

    def get_bloom_filter(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.bloom import BloomFilter

        return BloomFilter(self._engine, name, codec)

    def get_bloom_filter_array(self, name: str):
        from redisson_tpu_torch.client.objects.bloom_array import BloomFilterArray

        return BloomFilterArray(self._engine, name)

    def get_hyper_log_log(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.hyperloglog import HyperLogLog

        return HyperLogLog(self._engine, name, codec)

    def get_hyper_log_log_array(self, name: str):
        from redisson_tpu_torch.client.objects.hll_array import HyperLogLogArray

        return HyperLogLogArray(self._engine, name)

    def get_bit_set(self, name: str):
        from redisson_tpu_torch.client.objects.bitset import BitSet

        return BitSet(self._engine, name)

    # -- value / counter objects -------------------------------------------

    def get_bucket(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.bucket import Bucket

        return Bucket(self._engine, name, codec)

    def get_buckets(self, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.bucket import Buckets

        return Buckets(self._engine, codec)

    def get_atomic_long(self, name: str):
        from redisson_tpu_torch.client.objects.bucket import AtomicLong

        return AtomicLong(self._engine, name)

    def get_atomic_double(self, name: str):
        from redisson_tpu_torch.client.objects.bucket import AtomicDouble

        return AtomicDouble(self._engine, name)

    def get_id_generator(self, name: str):
        from redisson_tpu_torch.client.objects.bucket import IdGenerator

        return IdGenerator(self._engine, name)

    # -- maps and MapReduce ----------------------------------------------------

    def get_map(self, name: str, codec: Optional[Codec] = None, options=None):
        from redisson_tpu_torch.client.objects.map import Map

        return Map(self._engine, name, codec, options)

    def get_map_reduce(self, mapper, reducer, collator=None, workers: int = 4, executor=None):
        from redisson_tpu_torch.services.mapreduce import MapReduce

        return MapReduce(self._engine, mapper, reducer, collator, workers, executor)

    # -- maps, collections and multimaps -------------------------------------

    def get_map_cache(self, name: str, codec: Optional[Codec] = None, options=None):
        from redisson_tpu_torch.client.objects.map import MapCache

        mc = MapCache(self._engine, name, codec, options)
        self._engine.eviction.schedule_for_record(self._engine, mc._name, mc.reap_expired)
        return mc

    def get_long_adder(self, name: str):
        from redisson_tpu_torch.client.objects.adder import LongAdder

        return LongAdder(self._engine, name)

    def get_double_adder(self, name: str):
        from redisson_tpu_torch.client.objects.adder import DoubleAdder

        return DoubleAdder(self._engine, name)

    def get_set(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.set import Set

        return Set(self._engine, name, codec)

    def get_set_cache(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.set import SetCache

        sc = SetCache(self._engine, name, codec)
        self._engine.eviction.schedule_for_record(self._engine, sc._name, sc.reap_expired)
        return sc

    def get_sorted_set(self, name: str, codec: Optional[Codec] = None, key=None):
        from redisson_tpu_torch.client.objects.set import SortedSet

        return SortedSet(self._engine, name, codec, key)

    def get_lex_sorted_set(self, name: str):
        from redisson_tpu_torch.client.objects.set import LexSortedSet

        return LexSortedSet(self._engine, name)

    def get_scored_sorted_set(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.scoredsortedset import ScoredSortedSet

        return ScoredSortedSet(self._engine, name, codec)

    def get_list(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.list import RList

        return RList(self._engine, name, codec)

    def get_list_multimap(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.multimap import ListMultimap

        return ListMultimap(self._engine, name, codec)

    def get_set_multimap(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.multimap import SetMultimap

        return SetMultimap(self._engine, name, codec)

    def get_list_multimap_cache(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.multimap import ListMultimapCache

        mm = ListMultimapCache(self._engine, name, codec)
        self._engine.eviction.schedule_for_record(self._engine, mm._name, mm.reap_expired)
        return mm

    def get_set_multimap_cache(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.multimap import SetMultimapCache

        mm = SetMultimapCache(self._engine, name, codec)
        self._engine.eviction.schedule_for_record(self._engine, mm._name, mm.reap_expired)
        return mm

    # -- queues -------------------------------------------------------------

    def get_queue(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.queue import Queue

        return Queue(self._engine, name, codec)

    def get_deque(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.queue import Deque

        return Deque(self._engine, name, codec)

    def get_blocking_queue(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.queue import BlockingQueue

        return BlockingQueue(self._engine, name, codec)

    def get_blocking_deque(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.queue import BlockingDeque

        return BlockingDeque(self._engine, name, codec)

    def get_bounded_blocking_queue(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.queue import BoundedBlockingQueue

        return BoundedBlockingQueue(self._engine, name, codec)

    def get_priority_queue(self, name: str, codec: Optional[Codec] = None, key=None):
        from redisson_tpu_torch.client.objects.queue import PriorityQueue

        return PriorityQueue(self._engine, name, codec, key)

    def get_priority_deque(self, name: str, codec: Optional[Codec] = None, key=None):
        from redisson_tpu_torch.client.objects.queue import PriorityDeque

        return PriorityDeque(self._engine, name, codec, key)

    def get_priority_blocking_queue(self, name: str, codec: Optional[Codec] = None, key=None):
        from redisson_tpu_torch.client.objects.queue import PriorityBlockingQueue

        return PriorityBlockingQueue(self._engine, name, codec, key)

    def get_priority_blocking_deque(self, name: str, codec: Optional[Codec] = None, key=None):
        from redisson_tpu_torch.client.objects.queue import PriorityBlockingDeque

        return PriorityBlockingDeque(self._engine, name, codec, key)

    def get_ring_buffer(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.queue import RingBuffer

        return RingBuffer(self._engine, name, codec)

    def get_delayed_queue(self, destination_queue) -> "object":
        from redisson_tpu_torch.client.objects.queue import DelayedQueue

        return DelayedQueue(
            self._engine,
            f"redisson_delay_queue:{{{destination_queue.name}}}",
            destination_queue._codec,
            destination_queue,
        )

    def get_transfer_queue(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.queue import TransferQueue

        return TransferQueue(self._engine, name, codec)

    # -- synchronizers ------------------------------------------------------

    def get_lock(self, name: str):
        from redisson_tpu_torch.client.objects.lock import Lock

        return Lock(self._engine, name)

    def get_fair_lock(self, name: str):
        from redisson_tpu_torch.client.objects.lock import FairLock

        return FairLock(self._engine, name)

    def get_spin_lock(self, name: str):
        from redisson_tpu_torch.client.objects.lock import SpinLock

        return SpinLock(self._engine, name)

    def get_fenced_lock(self, name: str):
        from redisson_tpu_torch.client.objects.lock import FencedLock

        return FencedLock(self._engine, name)

    def get_read_write_lock(self, name: str):
        from redisson_tpu_torch.client.objects.lock import ReadWriteLock

        return ReadWriteLock(self._engine, name)

    def get_multi_lock(self, *locks):
        from redisson_tpu_torch.client.objects.lock import MultiLock

        return MultiLock(*locks)

    def get_red_lock(self, *locks):
        from redisson_tpu_torch.client.objects.lock import RedLock

        return RedLock(*locks)

    def get_semaphore(self, name: str):
        from redisson_tpu_torch.client.objects.semaphore import Semaphore

        return Semaphore(self._engine, name)

    def get_permit_expirable_semaphore(self, name: str):
        from redisson_tpu_torch.client.objects.semaphore import PermitExpirableSemaphore

        return PermitExpirableSemaphore(self._engine, name)

    def get_count_down_latch(self, name: str):
        from redisson_tpu_torch.client.objects.semaphore import CountDownLatch

        return CountDownLatch(self._engine, name)

    def get_rate_limiter(self, name: str):
        from redisson_tpu_torch.client.objects.semaphore import RateLimiter

        return RateLimiter(self._engine, name)

    # -- messaging ----------------------------------------------------------

    def get_topic(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.topic import Topic

        return Topic(self._engine, name, codec)

    def get_pattern_topic(self, pattern: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.topic import PatternTopic

        return PatternTopic(self._engine, pattern, codec)

    def get_sharded_topic(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.topic import ShardedTopic

        return ShardedTopic(self._engine, name, codec)

    def get_reliable_topic(self, name: str, codec: Optional[Codec] = None):
        from redisson_tpu_torch.client.objects.topic import ReliableTopic

        return ReliableTopic(self._engine, name, codec)

    # -- keyspace admin (RKeys) ---------------------------------------------

    def get_keys(self):
        from redisson_tpu_torch.client.objects.keys import Keys

        return Keys(self._engine)

    # -- search ---------------------------------------------------------------

    def get_search(self):
        """The engine's search service (FT indexes, KNN over VECTOR fields)."""
        from redisson_tpu_torch.services.search import SearchService

        return self._engine.service("search", lambda: SearchService(self._engine))

    # -- batching (RBatch) --------------------------------------------------

    def create_batch(self, skip_result: bool = False, atomic: bool = False) -> Batch:
        """An RBatch over this client's engine: ops queued on its proxies run
        at execute(), grouped per object and verb (core/batch.py)."""
        return Batch(self._engine, skip_result=skip_result, atomic=atomic)

    def shutdown(self) -> None:
        self._engine.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
