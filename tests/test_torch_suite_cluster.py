"""The reference's tests/test_cluster.py, unedited, on the port's cluster
(harness.ClusterRunner on the CPU, client.cluster.ClusterRedisson;
tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_replication_prunes_deleted_records": "M11 (replicas, REPLFLUSH)",
    "test_replication_and_replica_reads": "M11 (replicas, replica reads)",
    "test_manual_failover_promote": "M11 (replicas, promote)",
    "test_failover_coordinator_auto_promotes": "M11 (FailoverCoordinator, replicas)",
    "test_password_protected_cluster_bootstrap_and_replication": "M11 (replicas, REPLFLUSH)",
    "test_replication_recreate_within_ship_interval": "M11 (replicas, REPLFLUSH)",
    "test_failover_coordinator_keeps_unpromotable_master_pending": "M11 (FailoverCoordinator)",
}

globals().update(_torch_port_suite.load("test_cluster", WAITING, __name__))
