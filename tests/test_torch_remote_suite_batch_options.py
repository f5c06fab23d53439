"""The reference's tests/test_batch_options.py, unedited, on the port's server and
clients (tests/_torch_port_suite.py).  ``WAITING`` names each test left
out and the slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_remote_batch_full_surface_mixed_types": "M8 (ClusterRunner)",
    "test_atomic_batch_no_interleaving": "M8 (ClusterRunner)",
    "test_atomic_batch_crossslot_rejected": "M8 (ClusterRunner)",
    "test_batch_result_order_is_submission_order": "M8 (ClusterRunner)",
    "test_remote_batch_run_coalesces_server_side": "M8 (ClusterRunner)",
    "test_atomic_batch_includes_bloom_ops_in_lock_group": "M8 (ClusterRunner)",
    "test_batch_sync_slaves_replica_sees_writes": "M11 (replica reads, REPLFLUSH) on M8's ClusterRunner",
}

globals().update(_torch_port_suite.load("test_batch_options", WAITING, __name__))
