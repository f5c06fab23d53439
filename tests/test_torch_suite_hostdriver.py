"""The reference's tests/test_hostdriver.py, unedited, on the port's host
drivers and supervisor (tests/_torch_port_suite.py).  ``WAITING`` names
each test left out and the slice it waits for."""
import pytest

from tests import _torch_port_suite

WAITING = {
    # not waiting for a slice: it asserts the reference's module name in
    # the remote script; the port's starts ``-m redisson_tpu_torch.server``
    "test_ssh_remote_script_pipeline": "none (the reference's module name)",
}

globals().update(_torch_port_suite.load("test_hostdriver", WAITING, __name__))


@pytest.fixture(autouse=True)
def _time_limit():
    # each test here starts server processes: a limit of its own
    with _torch_port_suite.time_limit(120):
        yield
