"""The reference's tests/test_tracking.py, unedited, on the port's server and
clients (tests/_torch_port_suite.py).  ``WAITING`` names each test left
out and the slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    # not waiting for a slice: its subprocess runs the source text
    # "from redisson_tpu.net.resp import ...", which no loader reaches;
    # tests/test_torch_resp.py holds the port's RTPU_NO_NATIVE codec
    "test_invalidate_push_byte_identity_no_native_subprocess": "none (runs the reference in a subprocess)",
}

globals().update(_torch_port_suite.load("test_tracking", WAITING, __name__))
