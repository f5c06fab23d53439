"""The reference's tests/test_batch_options.py, unedited, on the port's server and
clients (tests/_torch_port_suite.py).  ``WAITING`` names each test left
out and the slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_batch_sync_slaves_replica_sees_writes": "M11 (replica reads, REPLFLUSH)",
}

globals().update(_torch_port_suite.load("test_batch_options", WAITING, __name__))
