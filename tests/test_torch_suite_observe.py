"""The reference's tests/test_observe.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_trace_ring_bounded_and_census_drains": "M11 part 6 (the chaos census, chaos/census.ResourceCensus)",
}

globals().update(_torch_port_suite.load("test_observe", WAITING, __name__))
