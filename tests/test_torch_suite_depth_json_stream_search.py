"""The reference's tests/test_depth_json_stream_search.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_role_breadcrumb_distinguishes_promoted_from_restarted": "M11 (replicas, REPLICAOF)",
}

globals().update(_torch_port_suite.load("test_depth_json_stream_search", WAITING, __name__))
