"""The reference's tests/test_cluster_proc.py, unedited, on the port's
process cluster (cluster.ClusterSupervisor spawning ``python -m
redisson_tpu_torch.server --device cpu`` children;
tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
import pytest

from tests import _torch_port_suite

WAITING = {
    "test_rearm_recovery_fences_restored_source": "M11 (migration journals, rearm_recovery)",
    "test_cross_process_kill_mid_drain_smoke": "M11 (the chaos soak harness, migrate_slots)",
    "test_cross_process_kill_at_every_phase": "M11 (the chaos soak harness, migrate_slots)",
    "test_cross_process_target_kill_mid_drain_smoke": "M11 (the chaos soak harness, migrate_slots)",
    "test_cross_process_double_kill_at_every_phase": "M11 (the chaos soak harness, migrate_slots)",
    "test_rolling_restart_preserves_acked_writes": "M11 (rolling_restart: SAVE, REPLFLUSH)",
    "test_import_survives_kill_after_stable": "M11 (migrate_slots, checkpoints)",
    "test_promote_replica_carries_import_window_across_failover": "M11 (replicas, promote_replica)",
    "test_fleet_soak_two_cycles_every_phase": "M11 (the fleet soak harness)",
}

globals().update(_torch_port_suite.load("test_cluster_proc", WAITING, __name__))


@pytest.fixture(autouse=True)
def _time_limit():
    # each test here starts server processes: a limit of its own
    with _torch_port_suite.time_limit(120):
        yield
