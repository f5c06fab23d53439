"""The reference's tests/test_overlap_plane.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_staging_pool_double_buffers_and_degrades_to_oneoff": "the port's API: StagingPool.commit takes a CUDA event (query/synchronize), the test's fake is a JAX array (is_ready/block_until_ready)",
    "test_staging_pool_waits_only_for_inflight_uploads": "the port's API: StagingPool.commit takes a CUDA event (query/synchronize), the test's fake is a JAX array (is_ready/block_until_ready)",
}

globals().update(_torch_port_suite.load("test_overlap_plane", WAITING, __name__))
