"""The reference's tests/test_preempt_plane.py, unedited, on the port
(tests/_torch_port_suite.py), with the CPU's 8 mesh positions standing in
for the ``devices`` fixture.  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite
from tests._torch_port_suite import devices  # noqa: F401  (the fixture)

_REPLICAS = "M11 (replicas: ClusterRunner(replicas_per_master=1), server/replication.py)"

WAITING = {
    "test_replica_profile_derives_staleness_offset": _REPLICAS,
    "test_execute_many_read_legs_ride_the_replica_plane": _REPLICAS,
}

globals().update(_torch_port_suite.load("test_preempt_plane", WAITING, __name__))
