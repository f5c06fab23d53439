"""The reference's tests/test_edge_coverage.py, unedited, on the port
(tests/_torch_port_suite.py); every test runs (``WAITING`` is empty)."""
from tests import _torch_port_suite

WAITING = {}

globals().update(_torch_port_suite.load("test_edge_coverage", WAITING, __name__))
