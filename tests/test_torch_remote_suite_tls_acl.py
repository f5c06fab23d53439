"""The reference's tests/test_tls_acl.py, unedited, on the port's server and
clients (tests/_torch_port_suite.py).  ``WAITING`` names each test left
out and the slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_cluster_over_tls_with_migration": "M11 (slot migration)",
}

globals().update(_torch_port_suite.load("test_tls_acl", WAITING, __name__))
