"""The reference's tests/test_replication_delta.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    # not waiting for a slice: it re-pads the replica's plane with
    # jax.numpy.pad, which takes no torch tensor; tests/test_torch_replication.py
    # holds the same divergence with torch's pad
    "test_shape_divergence_raises_and_full_ships": "none (pads a plane with jax.numpy)",
}

globals().update(_torch_port_suite.load("test_replication_delta", WAITING, __name__))
