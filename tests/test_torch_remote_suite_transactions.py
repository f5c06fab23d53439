"""The reference's tests/test_transactions.py, unedited, on the port's server and
clients (tests/_torch_port_suite.py).  ``WAITING`` names each test left
out and the slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "TestFacadeMatrix::test_cluster": "M8 (ClusterRunner)",
    "TestFacadeMatrix::test_cluster_cross_shard_atomicity": "M8 (ClusterRunner)",
    "TestViews::test_local_cached_map_handshake": "M7 part 4 (local caches)",
    "TestViews::test_embedded_view_breadth": "M7 part 4 (a local cached map view)",
}

globals().update(_torch_port_suite.load("test_transactions", WAITING, __name__))
