"""Wire-verb handler families; importing this package registers every verb.

The port serves four of the reference's nine families: connection (the
handshake and pub/sub), keyspace (keys, TTLs, strings, counters and
hashes), sketch (bit sets, bloom filters and banks, HyperLogLogs and
banks), with their shared preludes in ``common``.  Any other verb replies
the reference's unknown-command error.
"""
from redisson_tpu_torch.server.verbs import connection  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import keyspace  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import sketch  # noqa: F401,E402
