"""The reference's tests/test_transactions.py, unedited, on the port's server and
clients (tests/_torch_port_suite.py).  ``WAITING`` names each test left
out and the slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "TestFacadeMatrix::test_cluster": "M8 (ClusterRunner)",
    "TestFacadeMatrix::test_cluster_cross_shard_atomicity": "M8 (ClusterRunner)",
}

globals().update(_torch_port_suite.load("test_transactions", WAITING, __name__))
