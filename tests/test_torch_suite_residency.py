"""The reference's tests/test_residency.py, unedited, on the port's
residency plane (core/residency.py, CLUSTER RESIDENCY, the pressure
rebalancer) (tests/_torch_port_suite.py).  ``WAITING`` names each test
left out and why.

Two of the suite's tests run the reference in a subprocess, through the
source text "from redisson_tpu... import ...", which no loader reaches:
``test_wire_replies_bit_identical_armed_vs_disarmed_both_wire_planes`` and
``test_plane_disarmed_by_default_and_env_killswitch_beats_arm``.  They
still pass here, holding the reference; tests/test_torch_residency.py
holds the port to the same two contracts in subprocesses of its own."""
import pytest

from tests import _torch_port_suite

WAITING = {
    # not waiting for a slice: it counts jax.device_put, which the port
    # never calls (its one upload is ioplane.scatter_host_arrays'
    # Tensor.to); tests/test_torch_residency.py holds the port's promotion
    # to one scatter_host_arrays call and one host-to-device copy
    "test_promotion_costs_exactly_one_h2d": "none (counts jax.device_put, which the port never calls)",
}

globals().update(_torch_port_suite.load("test_residency", WAITING, __name__))


@pytest.fixture(autouse=True)
def _time_limit():
    with _torch_port_suite.time_limit(120):
        yield
