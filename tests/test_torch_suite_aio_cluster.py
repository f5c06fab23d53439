"""The reference's tests/test_aio_cluster.py, unedited, on the port's
cluster (harness.ClusterRunner on the CPU, client.aio.AsyncClusterRedisson;
tests/_torch_port_suite.py).  Every test runs (``WAITING`` is empty)."""
from tests import _torch_port_suite

WAITING: dict = {}

globals().update(_torch_port_suite.load("test_aio_cluster", WAITING, __name__))
