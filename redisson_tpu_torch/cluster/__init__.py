"""Process-level cluster plane: real server OS processes, real TCP topology
wiring, real signals.

A copy of ``redisson_tpu/cluster/__init__.py`` for the cluster serving path:

  * :mod:`~redisson_tpu_torch.cluster.supervisor` — :class:`ClusterSupervisor`
    (spawn / wait_ready / kill / stop / restart, per-node logs + exit codes);
  * :mod:`~redisson_tpu_torch.cluster.topology` — the single slot-assignment +
    SETVIEW program shared with the in-process harness;
  * :mod:`~redisson_tpu_torch.cluster.hostdriver` — where node processes RUN:
    :class:`LocalHostDriver` (subprocesses), :class:`SshHostDriver` (remote
    spawn over an ssh channel), :class:`K8sDriver` (pod-spec codegen);
  * :mod:`~redisson_tpu_torch.cluster.qos_control` — the fleet-wide tenant
    budget loop (:class:`QosRebalancer`), which
    ``ClusterSupervisor.start_qos_rebalance`` runs;
  * :mod:`~redisson_tpu_torch.cluster.residency_control` — the fleet-wide
    device-memory pressure loop (:class:`ResidencyRebalancer`: demote
    first through CLUSTER RESIDENCY SWEEP, then shed through SHED);
  * :mod:`~redisson_tpu_torch.cluster.chaos` — process-chaos primitives
    (the coordinator killed at a journal phase, SIGKILL-at-phase storms).
"""
from redisson_tpu_torch.cluster.hostdriver import (  # noqa: F401
    HostDriver,
    K8sDriver,
    LocalHostDriver,
    LoopbackTransport,
    NodeHandle,
    SshHostDriver,
    SshTransport,
)
from redisson_tpu_torch.cluster.residency_control import (  # noqa: F401
    ResidencyRebalancer,
    parse_residency_table,
)
from redisson_tpu_torch.cluster.supervisor import (  # noqa: F401
    ClusterSupervisor,
    NodeProc,
    NodeStartupError,
)
from redisson_tpu_torch.cluster.topology import (  # noqa: F401
    PlacementDegraded,
    assign_hosts,
    split_slots,
)
