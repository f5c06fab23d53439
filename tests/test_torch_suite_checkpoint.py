"""The reference's tests/test_checkpoint.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "TestCrashConsistency::test_torn_write_falls_back_to_previous_generation": "M11 part 6 (the storage fault plane, chaos/faults.FaultPlane)",
    "TestCrashConsistency::test_torn_write_at_explicit_byte": "M11 part 6 (the storage fault plane, chaos/faults.FaultPlane)",
    "TestCrashConsistency::test_enospc_fails_loudly_and_preserves_lineage": "M11 part 6 (the storage fault plane, chaos/faults.FaultPlane)",
    "TestCrashConsistency::test_fsync_failure_fails_the_save": "M11 part 6 (the storage fault plane, chaos/faults.FaultPlane)",
    "TestCrashConsistency::test_census_records_corruption": "M11 part 6 (the chaos census, chaos/census.ResourceCensus)",
}

globals().update(_torch_port_suite.load("test_checkpoint", WAITING, __name__))
