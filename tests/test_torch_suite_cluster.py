"""The reference's tests/test_cluster.py, unedited, on the port's cluster
(harness.ClusterRunner on the CPU, client.cluster.ClusterRedisson;
tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_failover_coordinator_auto_promotes": "M11 (FailoverCoordinator, replicas)",
    "test_failover_coordinator_keeps_unpromotable_master_pending": "M11 (FailoverCoordinator)",
}

globals().update(_torch_port_suite.load("test_cluster", WAITING, __name__))
