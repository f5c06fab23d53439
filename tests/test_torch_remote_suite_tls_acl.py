"""The reference's tests/test_tls_acl.py, unedited, on the port's server and
clients (tests/_torch_port_suite.py).  Every test runs (``WAITING`` is empty)."""
from tests import _torch_port_suite

WAITING: dict = {}

globals().update(_torch_port_suite.load("test_tls_acl", WAITING, __name__))
