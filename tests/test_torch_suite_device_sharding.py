"""The reference's tests/test_device_sharding.py, unedited, on the port
(tests/_torch_port_suite.py), with the CPU's 8 mesh positions.  ``WAITING``
names each test left out and the slice it waits for, or why torch cannot
hold it."""
from tests import _torch_port_suite

_IDENTITY = ("asserts a tensor's device identity across CPU positions: torch has one CPU "
             "device, so positions share it; tests/test_torch_placement.py holds the "
             "record's owner position instead")
_D2D = ("asserts a device-to-device copy across CPU positions: positions on torch's one CPU "
        "device share it, so a merge copies nothing; tests/test_torch_placement.py holds the "
        "merge and its zero host gathers")

WAITING = {
    "test_records_commit_to_owner_device": _IDENTITY,
    "test_put_unguarded_places_like_migration_import": _IDENTITY,
    "test_device_rebalance_kill_at_every_phase": (
        "asserts a tensor's device identity across CPU positions (torch has one CPU device); "
        "tests/test_torch_migration.py runs the same kill-at-every-phase rebalance against the "
        "reference's and holds each record's owner position"),
    "test_move_slot_records_fenced_and_bit_identical": _IDENTITY,
    "test_gather_device_results_buckets_per_device": _IDENTITY,
    "test_hll_union_across_devices_matches_single_device_and_stays_on_device": _D2D,
    "test_bitset_bitop_across_devices_stays_on_device": _D2D,
    "test_wordcount_spreads_chunks_and_merges_without_host_gather": _D2D,
}

globals().update(_torch_port_suite.load("test_device_sharding", WAITING, __name__))
