"""The reference's tests/test_read_scaling.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_read_scale_soak_smoke": "M11 parts 4 and 6 (the chaos soak harness, chaos/soak.py)",
    "test_read_scale_soak_kill_failover": "M11 parts 4 and 6 (the chaos soak harness, failover)",
    # not waiting for a slice: its subprocess runs the source text
    # "from redisson_tpu.harness import ...", which no loader reaches;
    # tests/test_torch_replication.py drives the same read stream against
    # the port's master and replica
    "test_replica_replies_byte_identical_native_and_fallback": "none (runs the reference in a subprocess)",
}

globals().update(_torch_port_suite.load("test_read_scaling", WAITING, __name__))
