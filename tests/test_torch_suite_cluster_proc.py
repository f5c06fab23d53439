"""The reference's tests/test_cluster_proc.py, unedited, on the port's
process cluster (cluster.ClusterSupervisor spawning ``python -m
redisson_tpu_torch.server --device cpu`` children;
tests/_torch_port_suite.py, whose soak configs default to the CPU too).
Every test runs: none waits for a slice."""
import pytest

from tests import _torch_port_suite

WAITING = {}

globals().update(_torch_port_suite.load("test_cluster_proc", WAITING, __name__))


@pytest.fixture(autouse=True)
def _time_limit():
    # each test here starts server processes: a limit of its own
    with _torch_port_suite.time_limit(120):
        yield
