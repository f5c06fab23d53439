"""The reference's tests/test_objcallm.py, unedited, on the port's server and
clients (tests/_torch_port_suite.py).  ``WAITING`` names each test left
out and the slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_objcallm_cluster_survives_stale_routing": "M11 (slot migration)",
}

globals().update(_torch_port_suite.load("test_objcallm", WAITING, __name__))
