"""The reference's collection and synchronizer suites, run unedited against
the port's embedded client (``redisson_tpu_torch.create(device="cpu")``).

Every test class of tests/test_collections.py, and the embedded leg of the
list/set, sorted-set, topic/queue/bucket, synchronizer and sorted-set/
set-cache semantics suites and of the multimap, permit-expirable semaphore
and fair-lock tests, is collected here a second time: the same test bodies,
with the ``client`` and ``embedded_client`` fixtures giving a fresh port
client.  A test that cannot run against the port yet is named in
``WAITING`` beside the module it waits for, and is not collected here.
"""
import pytest

import redisson_tpu_torch
from tests import test_collections as C
from tests import test_list_set_semantics as LS
from tests import test_multimap_pes_json_semantics as MP
from tests import test_sortedset_setcache_semantics as SS
from tests import test_synchronizer_semantics as SY
from tests import test_topic_queue_bucket_semantics as TQ
from tests import test_zset_semantics as ZS

# test -> the module of the reference it waits for
WAITING = {
    "TestTopic::test_cross_client_topic": "client/remote.py (a RemoteRedisson subscriber)",
    "TestLockDepth::test_wire_lock_identity_travels": "client/remote.py (a lock held over the wire)",
    "TestSpinLock::test_wire_spin_lock": "client/remote.py (a spin lock over the wire)",
}


@pytest.fixture()
def client():
    c = redisson_tpu_torch.create(device="cpu")
    yield c
    c.shutdown()


embedded_client = client


def _port_of(cls):
    """`cls` as collected here: the same test methods, less WAITING's."""
    waiting = {k.split("::")[1]: None for k in WAITING if k.split("::")[0] == cls.__name__}
    return type(cls.__name__, (cls,), {"__module__": __name__, **waiting})


SUITES = [
    *(getattr(C, n) for n in dir(C) if n.startswith("Test")),
    *(getattr(LS, n) for n in dir(LS) if n.startswith("Test")),
    *(getattr(ZS, n) for n in dir(ZS) if n.startswith("Test")),
    *(getattr(TQ, n) for n in dir(TQ) if n.startswith("Test")),
    *(getattr(SY, n) for n in dir(SY) if n.startswith("Test")),
    *(getattr(SS, n) for n in dir(SS) if n.startswith("Test")),
    MP.TestListMultimap, MP.TestSetMultimap, MP.TestPermitExpirableSemaphore, MP.TestFairLock,
    MP.TestInterfaceDiffTail,
]
for _cls in SUITES:
    globals()[_cls.__name__] = _port_of(_cls)
del _cls
