"""RedissonTpu: the entry facade of the port (Redisson.create analog).

One client over one embedded Engine, with the sketch factories of
``redisson_tpu/client/redisson.py``.  Object handles are cheap and
stateless; create them freely.  The other factories belong to later slices.
"""
from __future__ import annotations

from typing import Optional

from redisson_tpu_torch.client.codec import Codec
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

    def shutdown(self) -> None:
        self._engine.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
