"""The reference's tests/test_aio_cluster.py, unedited, on the port's
cluster (harness.ClusterRunner on the CPU, client.aio.AsyncClusterRedisson;
tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_async_cluster_follows_moved_after_reshard": "M11 (migrate_slots)",
    "test_async_cluster_ask_redirect_during_window": "M11 (CLUSTER SETSLOT, MIGRATESLOT)",
}

globals().update(_torch_port_suite.load("test_aio_cluster", WAITING, __name__))
