"""The reference's tests/test_core_store.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_kernel_padding_sentinel_keeps_padding_lanes_zero": "the port's API: ops/bittensor.make takes the device, the kernels take a Keys operand, not the reference's jitted masked programs",
    "test_hash_empty_batch": "the port's API: utils/hashing.hash_packed_bytes takes torch tensors, no array-module argument",
}

globals().update(_torch_port_suite.load("test_core_store", WAITING, __name__))
