"""The reference's tests/test_tracking.py, unedited, on the port's server and
clients (tests/_torch_port_suite.py).  ``WAITING`` names each test left
out and the slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_epochless_handoff_invalidates_after_fenced_migration": "M11 (slot migration)",
    "test_tracking_soak_migration_smoke": "M11 (the chaos soak harness, slot migration)",
    "test_tracking_soak_kill_failover": "M11 (the chaos soak harness, failover)",
    "test_tracking_census_and_metrics_gauges": "M11 (the resource census, chaos/census.py)",
    # not waiting for a slice: its subprocess runs the source text
    # "from redisson_tpu.net.resp import ...", which no loader reaches;
    # tests/test_torch_resp.py holds the port's RTPU_NO_NATIVE codec
    "test_invalidate_push_byte_identity_no_native_subprocess": "none (runs the reference in a subprocess)",
}

globals().update(_torch_port_suite.load("test_tracking", WAITING, __name__))
