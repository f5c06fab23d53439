"""The reference's tests/test_qos_plane.py, unedited, on the port
(tests/_torch_port_suite.py), with the CPU's 8 mesh positions standing in
for the ``devices`` fixture.  Every test runs: none waits for a slice."""
from tests import _torch_port_suite
from tests._torch_port_suite import devices  # noqa: F401  (the fixture)

WAITING = {}

globals().update(_torch_port_suite.load("test_qos_plane", WAITING, __name__))
