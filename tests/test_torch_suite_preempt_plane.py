"""The reference's tests/test_preempt_plane.py, unedited, on the port
(tests/_torch_port_suite.py), with the CPU's 8 mesh positions standing in
for the ``devices`` fixture.  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite
from tests._torch_port_suite import devices  # noqa: F401  (the fixture)

WAITING: dict = {}

globals().update(_torch_port_suite.load("test_preempt_plane", WAITING, __name__))
