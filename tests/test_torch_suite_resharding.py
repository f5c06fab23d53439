"""The reference's tests/test_resharding.py, unedited, on the port
(tests/_torch_port_suite.py), with the CPU's 8 mesh positions.  ``WAITING``
names each test left out and the slice it waits for."""
from tests import _torch_port_suite

WAITING: dict = {}

globals().update(_torch_port_suite.load("test_resharding", WAITING, __name__))
