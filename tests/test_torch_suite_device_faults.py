"""The reference's tests/test_device_faults.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and
why."""
from tests import _torch_port_suite

WAITING = {
    "test_lane_watchdog_bounds_hung_readback": "calls jax directly: it stages its value with jax.device_put onto a JAX device (tests/test_torch_faults.py::test_an_injected_hung_readback_trips_the_armed_watchdog holds the case on the port)",
    "test_fault_reply_digest_identical_without_native": "runs the reference in a subprocess whose script imports redisson_tpu, which the loader cannot redirect there; tests/test_torch_faults.py::test_fault_reply_digest_equal_with_and_without_the_native_codec runs the same stream on the port",
}

globals().update(_torch_port_suite.load("test_device_faults", WAITING, __name__))
