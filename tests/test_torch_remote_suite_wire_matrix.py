"""The reference's tests/test_wire_matrix.py, unedited, on the port's
server and clients (tests/_torch_port_suite.py).  ``WAITING`` names each
test left out and the slice it waits for."""
from tests import _torch_port_suite

WAITING = {}

globals().update(_torch_port_suite.load("test_wire_matrix", WAITING, __name__))
