"""The reference's tests/test_localcache_adder_jcache.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and
the slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_checkpoint_save_during_concurrent_map_writes": "M11 (core/checkpoint.py)",
}

globals().update(_torch_port_suite.load("test_localcache_adder_jcache", WAITING, __name__))
