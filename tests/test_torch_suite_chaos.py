"""The reference's tests/test_chaos.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` is empty: every test runs."""
from tests import _torch_port_suite

WAITING = {}

globals().update(_torch_port_suite.load("test_chaos", WAITING, __name__))
