"""The reference's collection and synchronizer suites, run unedited against
the port's embedded client (``redisson_tpu_torch.create(device="cpu")``).

Every test class of tests/test_collections.py, and the embedded leg of the
list/set, sorted-set, topic/queue/bucket, synchronizer and sorted-set/
set-cache semantics suites and of the multimap, permit-expirable semaphore,
fair-lock and JSON bucket tests, is collected here a second time: the same test bodies,
with the ``client`` and ``embedded_client`` fixtures giving a fresh port
client, and the wire leg's ``remote_client`` a port RemoteRedisson on a
port server on the CPU; in the test bodies ``RemoteRedisson`` and
``ServerThread`` are the port's.  A test that cannot run against the port
yet is named in ``WAITING`` beside the module it waits for, and is not
collected here.
"""
import types

import pytest

import redisson_tpu_torch
from redisson_tpu_torch.client.remote import RemoteRedisson
from tests import test_collections as C
from tests import test_list_set_semantics as LS
from tests import test_multimap_pes_json_semantics as MP
from tests import test_sortedset_setcache_semantics as SS
from tests import test_synchronizer_semantics as SY
from tests import test_topic_queue_bucket_semantics as TQ
from tests import test_zset_semantics as ZS

from tests._torch_port_suite import CpuServerThread

# test -> the module of the reference it waits for
WAITING: dict = {}


@pytest.fixture()
def client():
    c = redisson_tpu_torch.create(device="cpu")
    yield c
    c.shutdown()


embedded_client = client


@pytest.fixture(scope="module")
def remote_client():
    with CpuServerThread(port=0) as st:
        c = RemoteRedisson(st.address, timeout=60.0)
        yield c
        c.shutdown()


# the reference's names in the test bodies that bind the port's classes here
PORT_NAMES = {"RemoteRedisson": RemoteRedisson, "ServerThread": CpuServerThread}


def _rebound(fn):
    if not isinstance(fn, types.FunctionType):
        return fn
    names = {k: v for k, v in PORT_NAMES.items() if k in fn.__globals__}
    if not names:
        return fn
    out = types.FunctionType(fn.__code__, {**fn.__globals__, **names}, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    out.__dict__.update(fn.__dict__)
    return out


def _port_of(cls):
    """`cls` as collected here: the same test methods, less WAITING's,
    with the reference's wire client and server names bound to the port's."""
    waiting = {k.split("::")[1]: None for k in WAITING if k.split("::")[0] == cls.__name__}
    methods = {k: _rebound(v) for k, v in vars(cls).items() if k.startswith("test")}
    return type(cls.__name__, (cls,), {"__module__": __name__, **methods, **waiting})


SUITES = [
    *(getattr(C, n) for n in dir(C) if n.startswith("Test")),
    *(getattr(LS, n) for n in dir(LS) if n.startswith("Test")),
    *(getattr(ZS, n) for n in dir(ZS) if n.startswith("Test")),
    *(getattr(TQ, n) for n in dir(TQ) if n.startswith("Test")),
    *(getattr(SY, n) for n in dir(SY) if n.startswith("Test")),
    *(getattr(SS, n) for n in dir(SS) if n.startswith("Test")),
    MP.TestListMultimap, MP.TestSetMultimap, MP.TestPermitExpirableSemaphore, MP.TestFairLock,
    MP.TestJsonBucket, MP.TestInterfaceDiffTail,
]
for _cls in SUITES:
    globals()[_cls.__name__] = _port_of(_cls)
del _cls
