"""The reference's tests/test_coordinator_ha.py, unedited, on the port's
coordinator HA (server/monitor.HAFailoverCoordinator)
(tests/_torch_port_suite.py).  Every test runs (``WAITING`` is empty)."""
import pytest

from tests import _torch_port_suite

WAITING: dict = {}

globals().update(_torch_port_suite.load("test_coordinator_ha", WAITING, __name__))


@pytest.fixture(autouse=True)
def _time_limit():
    # each test here starts a cluster of servers: a limit of its own
    with _torch_port_suite.time_limit(120):
        yield
