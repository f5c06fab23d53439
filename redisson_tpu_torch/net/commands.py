"""Command metadata registry shared by server and cluster client.

Parity target: the reference's static command registry
(``org/redisson/client/protocol/RedisCommands.java`` — ~447 `RedisCommand`
definitions carrying reply decoders and routing attributes).  Here the
registry carries what this wire needs: which args are keys (slot
routing + server-side MOVED checks) and whether the command mutates state
(replica READONLY enforcement + client read/write routing, the readMode
analog of ``connection/MasterSlaveEntry`` + balancers).
"""
from __future__ import annotations

from typing import List, Optional, Tuple


class CommandSpec:
    __slots__ = ("name", "write", "key_at", "multi_key", "global_cmd",
                 "key_stride", "key_count", "numkeys_at")

    def __init__(self, name: str, write: bool, key_at: Optional[int],
                 multi_key: bool = False, key_stride: int = 1,
                 key_count: Optional[int] = None,
                 numkeys_at: Optional[int] = None):
        self.name = name
        self.write = write
        self.key_at = key_at  # index into args AFTER the command name; None = keyless
        self.multi_key = multi_key  # keys run from key_at to end of args
        self.key_stride = key_stride  # MSET-style interleaved key-value lists
        self.key_count = key_count  # bounded key runs (SMOVE/LMOVE: first 2)
        # EVAL-style dynamic key lists: args[numkeys_at] holds the count and
        # the keys follow it (ZUNIONSTORE dest numkeys k1..kn)
        self.numkeys_at = numkeys_at
        self.global_cmd = key_at is None and numkeys_at is None


def _spec(table, names, write, key_at, multi_key=False):
    for n in names.split():
        table[n] = CommandSpec(n, write, key_at, multi_key)


SPECS: dict = {}

# keyless / administrative (never redirected)
_spec(SPECS, "PING ECHO AUTH HELLO SELECT CLIENT QUIT DBSIZE TIME INFO MEMORY "
             "CLUSTER KEYS SAVE ROLE REPLICAOF REPLREGISTER "
             "REPLPUSH REPLPUSHSEG REPLFLUSH REPLSNAPSHOT REPLICAS SUBSCRIBE UNSUBSCRIBE "
             "PSUBSCRIBE PUNSUBSCRIBE PUBLISH METRICS ASKING "
             "READONLY READWRITE REPLSTATE REPLPING", False, None)

# keyless but state-mutating: a replica must refuse these (REPLPUSH is the
# one sanctioned mutation path on a replica; IMPORTRECORDS is the slot-
# migration transfer frame, master-to-master; OBJCALLM batches carry writes
# inside their pickled payload, so the frame routes as a write)
_spec(SPECS, "FLUSHALL RESTORESTATE IMPORTRECORDS OBJCALLM OBJCALLMA", True, None)

# single-key reads
_spec(SPECS, "EXISTS TTL PTTL TYPE GET GETBIT BITCOUNT GETBITS GETBITSB "
             "BF.EXISTS BF.MEXISTS BF.INFO BF.MEXISTS64 BFA.MEXISTS64 "
             "PFCOUNT", False, 0)

# single-key writes
_spec(SPECS, "EXPIRE PEXPIRE PERSIST SET INCR INCRBY DECR SETBIT SETBITS "
             "SETBITSB BF.RESERVE BF.ADD BF.MADD BF.MADD64 BFA.RESERVE "
             "BFA.MADD64 PFADD64 PFADD HLLA.RESERVE HLLA.MADD64 "
             "HLLA.MERGEROWS", True, 0)
_spec(SPECS, "HLLA.ESTIMATE HLLA.ESTPAIRS", False, 0)

# typed data commands (Redis-compatible verbs over the object handles)
_spec(SPECS, "HGET HMGET HGETALL HEXISTS HLEN HKEYS HVALS SISMEMBER SMEMBERS "
             "SCARD LLEN LRANGE LINDEX ZSCORE ZCARD ZRANK ZRANGE STRLEN", False, 0)
_spec(SPECS, "HSET HDEL SADD SREM LPUSH RPUSH LPOP RPOP ZADD ZREM ZINCRBY "
             "GETSET GETDEL APPEND", True, 0)
_spec(SPECS, "MGET", False, 0, multi_key=True)
SPECS["MSET"] = CommandSpec("MSET", True, 0, multi_key=True, key_stride=2)

# typed surface expansion (strings/keys/hash/set/list/zset verbs)
_spec(SPECS, "GETRANGE EXPIRETIME PEXPIRETIME HSTRLEN HRANDFIELD HSCAN SSCAN "
             "ZSCAN SRANDMEMBER SMISMEMBER ZCOUNT ZRANGEBYSCORE "
             "ZREVRANGEBYSCORE ZREVRANGE ZMSCORE ZRANDMEMBER ZREVRANK LPOS",
      False, 0)
_spec(SPECS, "SETNX SETEX PSETEX GETEX SETRANGE INCRBYFLOAT DECRBY EXPIREAT "
             "PEXPIREAT HSETNX HINCRBY HINCRBYFLOAT SPOP LSET LINSERT LREM "
             "LTRIM LPUSHX RPUSHX ZPOPMIN ZPOPMAX ZREMRANGEBYSCORE "
             "ZREMRANGEBYRANK", True, 0)
_spec(SPECS, "RANDOMKEY SCAN", False, None)
_spec(SPECS, "TOUCH", False, 0, multi_key=True)
SPECS["MSETNX"] = CommandSpec("MSETNX", True, 0, multi_key=True, key_stride=2)
_spec(SPECS, "SINTER SUNION SDIFF", False, 0, multi_key=True)
_spec(SPECS, "SINTERSTORE SUNIONSTORE SDIFFSTORE", True, 0, multi_key=True)
# bounded key runs: first two args are keys, the rest are operands
for _n in ("SMOVE", "LMOVE", "RPOPLPUSH"):
    SPECS[_n] = CommandSpec(_n, True, 0, multi_key=True, key_count=2)
# EVAL-style numkeys commands
SPECS["SINTERCARD"] = CommandSpec("SINTERCARD", False, None, numkeys_at=0)
SPECS["ZUNIONSTORE"] = CommandSpec("ZUNIONSTORE", True, 0, numkeys_at=1)
SPECS["ZINTERSTORE"] = CommandSpec("ZINTERSTORE", True, 0, numkeys_at=1)

# typed surface expansion: lex zset ranges, multi-pops, blocking
# verbs, generic COPY/SORT.  Blocking verbs route as writes (they consume).
_spec(SPECS, "BITPOS ZLEXCOUNT ZRANGEBYLEX ZREVRANGEBYLEX", False, 0)
_spec(SPECS, "ZREMRANGEBYLEX SORT", True, 0)
# BLPOP/BRPOP/BZPOPMIN/BZPOPMAX <key>... <timeout> — route by FIRST key
# (cluster semantics already require all keys in one slot, as in the
# reference's isBlockingCommand handling)
_spec(SPECS, "BLPOP BRPOP BZPOPMIN BZPOPMAX", True, 0)
for _n in ("COPY", "RENAMENX", "ZRANGESTORE", "BLMOVE", "BRPOPLPUSH"):
    SPECS[_n] = CommandSpec(_n, True, 0, multi_key=True, key_count=2)
SPECS["ZDIFF"] = CommandSpec("ZDIFF", False, None, numkeys_at=0)
SPECS["ZINTER"] = CommandSpec("ZINTER", False, None, numkeys_at=0)
SPECS["ZUNION"] = CommandSpec("ZUNION", False, None, numkeys_at=0)
SPECS["ZDIFFSTORE"] = CommandSpec("ZDIFFSTORE", True, 0, numkeys_at=1)
SPECS["LMPOP"] = CommandSpec("LMPOP", True, None, numkeys_at=0)
SPECS["ZMPOP"] = CommandSpec("ZMPOP", True, None, numkeys_at=0)
SPECS["BLMPOP"] = CommandSpec("BLMPOP", True, None, numkeys_at=1)
SPECS["BZMPOP"] = CommandSpec("BZMPOP", True, None, numkeys_at=1)

# typed stream + geo verbs
_spec(SPECS, "XLEN XRANGE XREVRANGE XPENDING GEOPOS GEODIST GEOSEARCH", False, 0)
_spec(SPECS, "XADD XDEL XTRIM XACK XCLAIM XAUTOCLAIM GEOADD", True, 0)
# XINFO <STREAM|GROUPS|CONSUMERS> <key>, XGROUP <sub> <key> — key at index 1
_spec(SPECS, "XINFO", False, 1)
_spec(SPECS, "XGROUP", True, 1)
SPECS["GEOSEARCHSTORE"] = CommandSpec("GEOSEARCHSTORE", True, 0, multi_key=True, key_count=2)
# XREAD/XREADGROUP key lists follow the STREAMS marker — extracted by a
# dedicated branch in command_keys (not expressible as a static position)
_spec(SPECS, "XREAD", False, None)
_spec(SPECS, "XREADGROUP", True, None)

# redis-stack module verbs: JSON documents route by key; FT indexes are
# not keyspace keys (RediSearch coordinates cluster-side), so FT.* is
# keyless — served by whichever node the client drives
_spec(SPECS, "JSON.GET JSON.TYPE JSON.STRLEN JSON.ARRLEN JSON.ARRINDEX "
             "JSON.OBJKEYS JSON.OBJLEN", False, 0)
_spec(SPECS, "JSON.SET JSON.DEL JSON.NUMINCRBY JSON.STRAPPEND JSON.ARRAPPEND "
             "JSON.ARRINSERT JSON.ARRPOP JSON.ARRTRIM JSON.CLEAR JSON.TOGGLE "
             "JSON.MERGE", True, 0)
_spec(SPECS, "FT.SEARCH FT.MSEARCH FT.AGGREGATE FT.INFO FT._LIST "
             "FT.SPELLCHECK FT.DICTDUMP FT.CURSOR", False, None)
_spec(SPECS, "FT.CREATE FT.DROPINDEX FT.ALTER FT.ALIASADD FT.ALIASUPDATE "
             "FT.ALIASDEL FT.DICTADD FT.DICTDEL", True, None)

# bitfields (Redis bit-layout over the BitSet record)
_spec(SPECS, "BITFIELD", True, 0)
_spec(SPECS, "BITFIELD_RO", False, 0)

# pubsub introspection + sharded pubsub (routing for S* happens client-side
# by channel slot, same as the plain SUBSCRIBE discipline)
_spec(SPECS, "PUBSUB SSUBSCRIBE SUNSUBSCRIBE SPUBLISH", False, None)

# legacy GEO radius forms (GEORADIUS may STORE -> write)
_spec(SPECS, "GEORADIUS GEORADIUSBYMEMBER", True, 0)
_spec(SPECS, "GEORADIUS_RO GEORADIUSBYMEMBER_RO", False, 0)

# script/function invocation: keys follow the numkeys arg (EVAL-style);
# FCALL_RO is replica-servable, the rest mutate
SPECS["EVALSHA"] = CommandSpec("EVALSHA", True, None, numkeys_at=1)
SPECS["EVAL"] = CommandSpec("EVAL", True, None, numkeys_at=1)
SPECS["FCALL"] = CommandSpec("FCALL", True, None, numkeys_at=1)
SPECS["FCALL_RO"] = CommandSpec("FCALL_RO", False, None, numkeys_at=1)
# admin verbs: keyless, replica-servable (CONFIG/SCRIPT admin is node-local;
# WAIT on a replica reports 0 attached replicas)
_spec(SPECS, "SCRIPT FUNCTION CONFIG WAIT", False, None)

# transactions: MULTI/DISCARD/UNWATCH/RESET are connection-local; WATCH
# routes by its keys (queue-time MOVED checks); EXEC and TXEXEC mutate
# (replicas must refuse); OBJCALLV is the transactional read — it routes
# like OBJCALL and is replica-UNSAFE (the version must come from the
# master that will commit), so it stays a write for routing purposes
_spec(SPECS, "MULTI DISCARD UNWATCH RESET", False, None)
_spec(SPECS, "WATCH", False, 0, multi_key=True)
_spec(SPECS, "EXEC TXEXEC", True, None)
SPECS["OBJCALLV"] = CommandSpec("OBJCALLV", True, 1)

# record serialization (RObject.dump/restore; the MIGRATE recipe)
_spec(SPECS, "DUMP", False, 0)
_spec(SPECS, "RESTORE", True, 0)

# multi-key
_spec(SPECS, "DEL UNLINK", True, 0, multi_key=True)
_spec(SPECS, "RENAME", True, 0, multi_key=True)
_spec(SPECS, "PFMERGE", True, 0, multi_key=True)
# BITOP <op> <dest> <src>... — keys start at arg index 1
SPECS["BITOP"] = CommandSpec("BITOP", True, 1, multi_key=True)
# OBJCALL <factory> <name> <method> ... — key is arg index 1; writeness
# depends on the method (objcall_is_write)
SPECS["OBJCALL"] = CommandSpec("OBJCALL", True, 1)

# Object-method prefixes that never mutate state: these may be served by a
# replica (client read routing) and are allowed on a READONLY replica.
# Everything not matching is treated as a write — the safe default.
READ_METHOD_PREFIXES = (
    "get", "contains", "count", "estimate", "is_", "peek", "size", "read",
    "ttl", "remaining", "available", "keys", "values", "entries", "range",
    "index_of", "to_", "iterator", "scan", "first", "last", "tenants",
    "cardinality", "length", "union_count", "try_iterate", "random",
    "element", "stream_info", "state", "tenant_bit_counts", "name",
    "pending_summary", "object_keys", "object_size", "array_index_of",
    "array_size", "string_size", "type", "unlock_channel", "list_",
)


# Read-PREFIXED method families that nonetheless mutate: get_and_* returns
# the old value but installs a new one (AtomicLong.get_and_add,
# Bucket.get_and_set, MapCache.get_and_put, ...).  Checked before the read
# prefixes so these route to masters and invalidate tracked readers.
WRITE_METHOD_PREFIXES = ("get_and_",)


def objcall_is_write(method: str) -> bool:
    m = method.lower()
    if any(m.startswith(p) for p in WRITE_METHOD_PREFIXES):
        return True
    return not any(m.startswith(p) for p in READ_METHOD_PREFIXES)


# verbs that PARK server-side until data arrives or their timeout lapses
# (the reference's isBlockingCommand set): multiplexed clients must give
# these a dedicated connection or they head-of-line-block every other reply
BLOCKING_COMMANDS = frozenset(
    {"BLPOP", "BRPOP", "BLMOVE", "BRPOPLPUSH", "BZPOPMIN", "BZPOPMAX",
     "BLMPOP", "BZMPOP"}
)
# verbs whose block timeout is the FIRST argument (the rest carry it last)
BLOCK_TIMEOUT_FIRST = frozenset({"BLMPOP", "BZMPOP"})


def is_blocking(cmd, args) -> bool:
    # command names arrive as str OR bytes (encode_command accepts both)
    cu = (cmd.decode() if isinstance(cmd, (bytes, bytearray)) else str(cmd)).upper()
    if cu in BLOCKING_COMMANDS:
        return True
    if cu in ("XREAD", "XREADGROUP"):
        return any(
            (bytes(a) if isinstance(a, (bytes, bytearray)) else str(a).encode()).upper() == b"BLOCK"
            for a in args
        )
    return False


def lookup(cmd: str) -> Optional[CommandSpec]:
    return SPECS.get(cmd.upper())


def command_keys(cmd: str, args: List[bytes]) -> List[bytes]:
    """Key args of an encoded command (args EXCLUDE the command name)."""
    spec = lookup(cmd)
    if spec is None:
        return []
    if spec.name in ("XREAD", "XREADGROUP", "SORT"):
        # markers may arrive as str (client-side routing) or bytes (wire)
        uppers = [
            (bytes(a) if isinstance(a, (bytes, bytearray)) else str(a).encode()).upper()
            for a in args
        ]
        if spec.name == "SORT":
            # the STORE destination is a key too — omitting it would let a
            # cluster write the result onto whichever node owns the source
            keys = [args[0]] if args else []
            for j, u in enumerate(uppers):
                if u == b"STORE" and j + 1 < len(args):
                    keys.append(args[j + 1])
            return keys
        # XREAD/XREADGROUP: keys are the first half after the STREAMS marker
        if b"STREAMS" not in uppers:
            return []
        rest = args[uppers.index(b"STREAMS") + 1 :]
        return list(rest[: len(rest) // 2])
    if spec.numkeys_at is not None:
        if len(args) <= spec.numkeys_at:
            return []
        try:
            n = int(args[spec.numkeys_at])
        except (TypeError, ValueError):
            return []
        keys = list(args[spec.numkeys_at + 1 : spec.numkeys_at + 1 + n])
        if spec.key_at is not None and spec.key_at < spec.numkeys_at:
            keys.insert(0, args[spec.key_at])  # STORE dest before numkeys
        return keys
    if spec.key_at is None or len(args) <= spec.key_at:
        return []
    if spec.multi_key:
        keys = list(args[spec.key_at :: spec.key_stride])
        if spec.key_count is not None:
            keys = keys[: spec.key_count]
        return keys
    return [args[spec.key_at]]


def is_write(cmd: str, args: List[bytes]) -> bool:
    spec = lookup(cmd)
    if spec is None:
        return True  # unknown commands are treated as writes (safe default)
    if spec.name == "OBJCALL" and len(args) >= 3:
        method = args[2]
        if isinstance(method, bytes):
            method = method.decode()
        return objcall_is_write(method)
    return spec.write
