"""The reference's tests/test_vector_sharded.py, unedited, on the port
(tests/_torch_port_suite.py), with the CPU's 8 mesh positions.  ``WAITING``
names each test left out and why."""
from tests import _torch_port_suite

WAITING = {
    "test_mesh_warm_pool_sharded_knn_survives_reshard": "M11 (the warm pool, core/warmpool.py: Engine.prewarm)",
}

globals().update(_torch_port_suite.load("test_vector_sharded", WAITING, __name__))
