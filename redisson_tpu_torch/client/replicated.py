"""ReplicatedRedisson: master discovery over plain replicated nodes.

The reference's ``redisson_tpu/client/replicated.py`` finds the master of a
replication group by a ROLE scan and reads from its replicas.  The port's
server takes no replica before the replication slice (REPLICAOF replies an
error until then), so the client comes with it: creating one raises
NotImplementedError naming ROADMAP M11.
"""
from __future__ import annotations

_M11 = "ReplicatedRedisson comes with the replication slice (ROADMAP M11)"


class ReplicatedRedisson:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_M11)

    @classmethod
    def create(cls, config) -> "ReplicatedRedisson":
        raise NotImplementedError(_M11)
