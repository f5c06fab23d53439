"""The reference's tests/test_soak.py, unedited, on the port's soak
harnesses (redisson_tpu_torch/chaos/soak.py; tests/_torch_port_suite.py
binds each ``*SoakConfig`` to one whose device is the CPU).  Nothing waits
for a slice."""
import pytest

from tests import _torch_port_suite

globals().update(_torch_port_suite.load("test_soak", {}, __name__))


@pytest.fixture(autouse=True)
def _time_limit():
    # each test here starts servers and storms them: a limit of its own
    with _torch_port_suite.time_limit(300):
        yield
