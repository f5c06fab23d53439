"""The reference's tests/test_typed_commands.py, unedited, on the port
(tests/_torch_port_suite.py).  Every test runs (``WAITING`` is empty)."""
from tests import _torch_port_suite

WAITING: dict = {}

globals().update(_torch_port_suite.load("test_typed_commands", WAITING, __name__))
