"""The reference's tests/test_query_cache.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_digest_is_content_addressed": "the port's API: the query cache is core/kernels.QueryCache on the engine, no module-level K._QCACHE or K.query_digest (ROADMAP K-Q may remove the cache)",
    "test_cache_lru_and_size_cap": "the port's API: the query cache is core/kernels.QueryCache on the engine, no module-level K._QCACHE or K.query_digest (ROADMAP K-Q may remove the cache)",
    "test_bloom_array_hot_flush_reuses_buffer": "the port's API: the query cache is core/kernels.QueryCache on the engine, no module-level K._QCACHE or K.query_digest (ROADMAP K-Q may remove the cache)",
    "test_small_flushes_bypass_cache": "the port's API: the query cache is core/kernels.QueryCache on the engine, no module-level K._QCACHE or K.query_digest (ROADMAP K-Q may remove the cache)",
}

globals().update(_torch_port_suite.load("test_query_cache", WAITING, __name__))
