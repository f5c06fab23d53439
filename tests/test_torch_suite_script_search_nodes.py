"""The reference's tests/test_script_search_nodes.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_embedded_nodes_group": "M8 (the nodes group, client/nodes.py)",
    "test_remote_nodes_group": "M8 (the nodes group, client/nodes.py)",
    "test_jcache_replace_preserves_ttl": "M7 part 4 (jcache)",
    "test_jcache_statistics_disabled": "M7 part 4 (jcache)",
    "test_jcache_remove_all_counts": "M7 part 4 (jcache)",
    "test_localcache_no_double_broadcast_on_fast_put_if_absent": "M7 part 4 (local caches)",
}

globals().update(_torch_port_suite.load("test_script_search_nodes", WAITING, __name__))
