"""The reference's tests/test_mapreduce_distributed.py, unedited, on the
port (tests/_torch_port_suite.py): its coordinator (MapReduce and
word_count with ``executor=``) and its server are the port's, while its
worker processes are the reference's nodes (the file spawns
``python -m redisson_tpu.node``), which unpickle and run the port's task
functions, importing ``redisson_tpu_torch`` in their own process.  The
port's own node is held in tests/test_torch_services.py.  ``WAITING``
names each test left out and the slice it waits for."""
from tests import _torch_port_suite

WAITING: dict = {}

globals().update(_torch_port_suite.load("test_mapreduce_distributed", WAITING, __name__))
