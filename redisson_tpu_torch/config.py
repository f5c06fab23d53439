"""Engine configuration: the knobs the port reads.

A trimmed copy of ``redisson_tpu/config.py``'s ``Config``
(``org/redisson/config/Config.java:83-87``): the engine's expiry sweep
(``core/eviction.py``) reads its two cleanup delays, and every object
handle and ``Keys`` map names through ``name_mapper``.  The client-mode,
cluster, replicated and mesh sections, the SPI slots and the YAML/JSON
loaders come with ROADMAP M8, where a caller reads them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class Config:
    """Global framework config (org/redisson/config/Config.java analog)."""

    min_cleanup_delay: float = 5.0      # eviction min delay (Config.java:83-87)
    max_cleanup_delay: float = 1800.0   # eviction max delay 30min
    # logical object name -> stored key, applied at handle construction
    # (NameMapper SPI): must expose map(name) and unmap(key)
    name_mapper: Any = None
