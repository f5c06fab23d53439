"""The reference's tests/test_observe.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` is empty: every test runs."""
from tests import _torch_port_suite

WAITING = {}

globals().update(_torch_port_suite.load("test_observe", WAITING, __name__))
