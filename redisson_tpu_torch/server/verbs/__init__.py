"""Wire-verb handler families; importing this package registers every verb.

The port serves six of the reference's nine families: connection (the
handshake and pub/sub), keyspace (keys, TTLs, strings, counters, hashes and
the first set, list and sorted-set verbs), sketch (bit sets, bloom filters
and banks, HyperLogLogs and banks), collections (the hash extras, sets,
lists, the multi-pops and the blocking verbs, BLMPOP and BZMPOP among
them) and zset (the rest of the sorted-set surface, RENAMENX, BITPOS and
SORT), with their shared preludes in ``common``.  The admin, objcall_tx,
streamgeo and modules families, and COPY, are still to come (ROADMAP M7,
M11); any verb the port does not serve replies the reference's
unknown-command error.  Order mirrors the reference's registration order.
"""
from redisson_tpu_torch.server.verbs import connection  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import keyspace  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import sketch  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import collections  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import zset  # noqa: F401,E402
