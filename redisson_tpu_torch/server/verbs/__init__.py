"""Wire-verb handler families; importing this package registers every verb.

The port serves the reference's nine families: connection (the handshake
and pub/sub), keyspace (keys, TTLs, strings, counters, hashes and the first
set, list and sorted-set verbs), sketch (bit sets, bloom filters and banks,
HyperLogLogs and banks), admin (only its script and function verbs:
EVALSHA, EVAL, SCRIPT, FCALL, FCALL_RO, FUNCTION), objcall_tx (generic
object calls and the wire transactions), collections (the hash extras,
sets, lists, the multi-pops and the blocking verbs, BLMPOP and BZMPOP
among them), zset (the rest of the sorted-set surface, RENAMENX, BITPOS
and SORT), streamgeo (X* and GEO*) and modules (JSON.* and FT.*), with
their shared preludes in ``common``.  IMPORTRECORDS and COPY come with
ROADMAP M11 part 4; any verb the port does not serve replies the
reference's unknown-command error.  Order mirrors the reference's
registration order.
"""
from redisson_tpu_torch.server.verbs import connection  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import keyspace  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import sketch  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import admin  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import objcall_tx  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import collections  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import zset  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import streamgeo  # noqa: F401,E402
from redisson_tpu_torch.server.verbs import modules  # noqa: F401,E402
