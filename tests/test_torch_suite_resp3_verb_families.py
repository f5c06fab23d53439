"""The reference's tests/test_resp3_verb_families.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {}

globals().update(_torch_port_suite.load("test_resp3_verb_families", WAITING, __name__))
