"""The reference's tests/test_map_compute_semantics.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for.  The suite allowlists its own module name for the
compute callables it pickles; here they live in this runner's module, so
the runner allows its own name as well."""
from redisson_tpu_torch.net import safe_pickle
from tests import _torch_port_suite

safe_pickle.allow_module(__name__)

WAITING = {}

globals().update(_torch_port_suite.load("test_map_compute_semantics", WAITING, __name__))
