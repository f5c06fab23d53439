"""The reference's tests/test_cluster.py, unedited, on the port's cluster
(harness.ClusterRunner on the CPU, client.cluster.ClusterRedisson;
tests/_torch_port_suite.py).  Every test runs (``WAITING`` is empty)."""
from tests import _torch_port_suite

WAITING: dict = {}

globals().update(_torch_port_suite.load("test_cluster", WAITING, __name__))
