"""The reference's tests/test_typed_commands.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_config_and_wait": "M11 (WAIT, server/verbs/admin.py)",
}

globals().update(_torch_port_suite.load("test_typed_commands", WAITING, __name__))
