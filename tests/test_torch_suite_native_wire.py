"""The reference's tests/test_native_wire.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_replication_wire_payload_roundtrip": "M11 part 3 (server/replication.py)",
}

globals().update(_torch_port_suite.load("test_native_wire", WAITING, __name__))
