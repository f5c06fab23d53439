"""RedissonTpu: the entry facade of the port (Redisson.create analog).

One client over one embedded Engine, with the sketch, bit set, bucket, map,
MapReduce, search and batch factories of ``redisson_tpu/client/redisson.py``.
Object handles are cheap and stateless; create them freely.  The other
factories belong to later slices.
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
