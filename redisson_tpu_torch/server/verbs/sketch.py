"""Bit/bloom/HLL device-plane verbs: RBitSet, RedisBloom-compatible BF.*,
bloom/HLL bank blob fast paths, PF* (the sketch hot path).

A copy of ``redisson_tpu/server/verbs/sketch.py`` over the port's objects,
so every verb lands on the hand kernels the embedded path runs:
BF.MEXISTS64 and the other bloom probes on ``bloom_probe``, the adds on
``bloom_set`` or ``bloom_add``, PFADD and HLLA.MADD64 on ``hll_add``,
PFCOUNT, PFMERGE and the HLLA estimates and merges on ``hll_rows``, the bit
writes on ``bitset_set`` and the bit reads on ``bitset_get``.  Device
results stay tensors inside ``LazyReply`` and leave with the frame's one
grouped readback.  Integer-key bloom probes come back as an int32 bitmap
(bit i of word j = key 32j + i), decoded on the host by
``kernels.unpack_found``.
"""

from typing import Any, List

from redisson_tpu_torch.net.resp import RespError
from redisson_tpu_torch.server.registry import (
    LazyReply,
    register,
    _s,
    _int,
)
from redisson_tpu_torch.server.verbs.common import _bitset

# -- bits (RBitSet surface; batched forms are primary) ------------------------


@register("SETBIT")
def cmd_setbit(server, ctx, args):
    old = _bitset(server, _s(args[0])).set(_int(args[1]), bool(_int(args[2])))
    return 1 if old else 0


@register("GETBIT")
def cmd_getbit(server, ctx, args):
    return 1 if _bitset(server, _s(args[0])).get(_int(args[1])) else 0


@register("BITCOUNT")
def cmd_bitcount(server, ctx, args):
    return _bitset(server, _s(args[0])).cardinality()


@register("BITOP")
def cmd_bitop(server, ctx, args):
    from redisson_tpu_torch.ops import bittensor as bt

    op = bytes(args[0]).upper()
    dest = _s(args[1])
    srcs = [_s(a) for a in args[2:]]
    bs = _bitset(server, dest)
    if op == b"AND":
        bs.and_(*srcs)
    elif op == b"OR":
        bs.or_(*srcs)
    elif op == b"XOR":
        bs.xor(*srcs)
    elif op == b"NOT":
        bs.from_byte_array(_bitset(server, srcs[0]).to_byte_array())
        bs.not_()
    else:
        raise RespError("ERR syntax error")
    # reply = dest byte length; computed from the device WITHOUT a per-op
    # sync (the length rides the frame's grouped transfer)
    with server.engine.locked(dest):
        rec = server.engine.store.get(dest)
        if rec is None:
            return 0
        length_dev = bt.length_tensor(rec.arrays["bits"])
    return LazyReply(
        device=(length_dev,),
        finish=lambda v: (n := int(v[0])) // 8 + (1 if n % 8 else 0),
    )


def _bf_type(tok: bytes):
    """u<w> (1..63) or i<w> (1..64) -> (signed, width)."""
    t = bytes(tok)
    if len(t) < 2 or t[:1] not in (b"u", b"i"):
        raise RespError("ERR Invalid bitfield type. Use something like i16 u8.")
    signed = t[:1] == b"i"
    try:
        width = int(t[1:])
    except ValueError:
        raise RespError("ERR Invalid bitfield type. Use something like i16 u8.")
    if not 1 <= width <= (64 if signed else 63):
        raise RespError("ERR Invalid bitfield type. Use something like i16 u8.")
    return signed, width


def _bf_offset(tok: bytes, width: int) -> int:
    t = bytes(tok)
    if t[:1] == b"#":
        return int(t[1:]) * width
    return int(t)


@register("BITFIELD")
def cmd_bitfield(server, ctx, args):
    """BITFIELD key [GET ty off] [SET ty off v] [INCRBY ty off n]
    [OVERFLOW WRAP|SAT|FAIL] — Redis bit-layout semantics (offset 0 is the
    MSB of byte 0, matching GETBIT/SETBIT numbering) over the BitSet record;
    fields read/write through the batched get_each/set_each forms so one
    subcommand costs one indexed kernel, not w scalar ops
    (client/protocol/RedisCommands.java BITFIELD def)."""
    import numpy as np

    bs = _bitset(server, _s(args[0]))
    overflow = "WRAP"
    out: List[Any] = []
    i = 1

    def read_field(signed, width, off):
        idx = np.arange(off, off + width, dtype=np.int64)
        nbits = bs.size()
        bits = np.zeros(width, np.uint64)
        in_range = idx < nbits  # bits past the plane read 0 (Redis strings)
        if in_range.any():
            bits[in_range] = np.asarray(bs.get_each(idx[in_range]), np.uint64)
        val = 0
        for b in bits:
            val = (val << 1) | int(b)
        if signed and width and (val >> (width - 1)) & 1:
            val -= 1 << width
        return val

    def write_field(width, off, val):
        mask = (1 << width) - 1
        uval = val & mask
        bits = np.array(
            [(uval >> (width - 1 - k)) & 1 for k in range(width)], dtype=bool
        )
        idx = np.arange(off, off + width, dtype=np.int64)
        if bits.any():
            bs.set_each(idx[bits], True)
        if (~bits).any():
            bs.set_each(idx[~bits], False)

    def apply_overflow(signed, width, val):
        """-> (in-range value, failed) per OVERFLOW mode."""
        lo = -(1 << (width - 1)) if signed else 0
        hi = (1 << (width - 1)) - 1 if signed else (1 << width) - 1
        if lo <= val <= hi:
            return val, False
        if overflow == "FAIL":
            return 0, True
        if overflow == "SAT":
            return (lo if val < lo else hi), False
        span = 1 << width  # WRAP: two's-complement modular arithmetic
        wrapped = val % span
        if signed and wrapped > hi:
            wrapped -= span
        return wrapped, False

    while i < len(args):
        op = bytes(args[i]).upper()
        if op == b"OVERFLOW":
            mode = bytes(args[i + 1]).upper().decode()
            if mode not in ("WRAP", "SAT", "FAIL"):
                raise RespError("ERR Invalid OVERFLOW type specified")
            overflow = mode
            i += 2
        elif op == b"GET":
            signed, width = _bf_type(args[i + 1])
            off = _bf_offset(args[i + 2], width)
            out.append(read_field(signed, width, off))
            i += 3
        elif op == b"SET":
            signed, width = _bf_type(args[i + 1])
            off = _bf_offset(args[i + 2], width)
            new = _int(args[i + 3])
            with server.engine.locked(_s(args[0])):
                old = read_field(signed, width, off)
                new, failed = apply_overflow(signed, width, new)
                if failed:
                    out.append(None)
                else:
                    write_field(width, off, new)
                    out.append(old)
            i += 4
        elif op == b"INCRBY":
            signed, width = _bf_type(args[i + 1])
            off = _bf_offset(args[i + 2], width)
            delta = _int(args[i + 3])
            with server.engine.locked(_s(args[0])):
                cur = read_field(signed, width, off)
                new, failed = apply_overflow(signed, width, cur + delta)
                if failed:
                    out.append(None)
                else:
                    write_field(width, off, new)
                    out.append(new)
            i += 4
        else:
            raise RespError(f"ERR syntax error near '{_s(args[i])}'")
    return out


@register("BITFIELD_RO")
def cmd_bitfield_ro(server, ctx, args):
    """Read-only BITFIELD: GET subcommands only (replica-servable)."""
    for i in range(1, len(args), 3):
        if bytes(args[i]).upper() != b"GET":
            raise RespError(
                "ERR BITFIELD_RO only supports the GET subcommand"
            )
    return cmd_bitfield(server, ctx, args)


# batched forms: SETBITS name idx... / GETBITS name idx... (one kernel each)
@register("SETBITS")
def cmd_setbits(server, ctx, args):
    import numpy as np

    idx = np.asarray([_int(a) for a in args[1:]], np.int64)
    old, n = _bitset(server, _s(args[0])).set_each_async(idx, True)
    return LazyReply(device=(old,), finish=lambda v: [int(x) for x in v[0][:n]])


@register("GETBITS")
def cmd_getbits(server, ctx, args):
    import numpy as np

    idx = np.asarray([_int(a) for a in args[1:]], np.int64)
    got, n = _bitset(server, _s(args[0])).get_each_async(idx)
    return LazyReply(device=(got,), finish=lambda v: [int(x) for x in v[0][:n]])


# blob forms: indexes travel as ONE little-endian i32 buffer and previous
# bit values return as ONE byte blob — RESP integer encode/parse for
# thousands of per-bit args is pure overhead at batch sizes (bytes on the
# wire are the cost that matters)
@register("SETBITSB")
def cmd_setbitsb(server, ctx, args):
    import numpy as np

    idx = np.frombuffer(bytes(args[1]), dtype="<i4").astype(np.int64)
    old, n = _bitset(server, _s(args[0])).set_each_async(idx, True)
    return LazyReply(
        device=(old,), finish=lambda v: np.asarray(v[0][:n], np.uint8).tobytes()
    )


@register("GETBITSB")
def cmd_getbitsb(server, ctx, args):
    import numpy as np

    idx = np.frombuffer(bytes(args[1]), dtype="<i4").astype(np.int64)
    got, n = _bitset(server, _s(args[0])).get_each_async(idx)
    return LazyReply(
        device=(got,), finish=lambda v: np.asarray(v[0][:n], np.uint8).tobytes()
    )


# -- bloom filter (RedisBloom-compatible verbs + batch-first forms) ----------

def _bloom(server, name: str):
    from redisson_tpu_torch.client.objects.bloom import BloomFilter

    return BloomFilter(server.engine, name)


@register("BF.RESERVE")
def cmd_bf_reserve(server, ctx, args):
    bf = _bloom(server, _s(args[0]))
    error_rate = float(args[1])
    capacity = _int(args[2])
    if not bf.try_init(capacity, error_rate):
        raise RespError("ERR item exists")  # RedisBloom wording
    return "+OK"


@register("BF.ADD")
def cmd_bf_add(server, ctx, args):
    bf = _bloom(server, _s(args[0]))
    return 1 if bf.add(bytes(args[1])) else 0


@register("BF.MADD")
def cmd_bf_madd(server, ctx, args):
    bf = _bloom(server, _s(args[0]))
    newly = bf.add_each([bytes(a) for a in args[1:]])
    return [int(v) for v in newly]


@register("BF.EXISTS")
def cmd_bf_exists(server, ctx, args):
    bf = _bloom(server, _s(args[0]))
    return 1 if bf.contains(bytes(args[1])) else 0


@register("BF.MEXISTS")
def cmd_bf_mexists(server, ctx, args):
    bf = _bloom(server, _s(args[0]))
    found = bf.contains_each([bytes(a) for a in args[1:]])
    return [int(v) for v in found]


@register("BF.INFO")
def cmd_bf_info(server, ctx, args):
    bf = _bloom(server, _s(args[0]))
    rec = server.engine.store.get(bf.name)
    if rec is None:
        raise RespError("ERR not found")
    return [
        b"Capacity", rec.meta.get("expected_insertions", 0),
        b"Size", rec.meta["m"],
        b"Number of hashes", rec.meta["k"],
        b"Number of items inserted", bf.count(),
    ]


# Binary batch forms — the remote RBatch hot path (BASELINE north star):
# one command carries the whole key batch as a little-endian int64 blob, the
# reply is a 0/1 byte per key.  This is the wire shape of "one fused kernel
# dispatch per flush".

@register("BF.MADD64")
def cmd_bf_madd64(server, ctx, args):
    import numpy as np

    keys = np.frombuffer(bytes(args[1]), dtype="<i8")
    newly, n = _bloom(server, _s(args[0])).add_each_async(keys)
    return LazyReply(
        device=(newly,),
        finish=lambda v: np.asarray(v[0], np.uint8)[:n].tobytes(),
    )


@register("BF.MEXISTS64")
def cmd_bf_mexists64(server, ctx, args):
    import numpy as np

    from redisson_tpu_torch.core import kernels as K

    keys = np.frombuffer(bytes(args[1]), dtype="<i8")
    found, n = _bloom(server, _s(args[0])).contains_each_async(keys)

    def finish(vals):
        arr = vals[0]
        if arr.dtype in (np.int32, np.uint32):  # packed bitmap (int keys)
            arr = K.unpack_found(arr, n)
        return np.asarray(arr[:n], np.uint8).tobytes()

    return LazyReply(device=(found,), finish=finish)


# -- frame-run coalescing (the adaptive coalescing plane) -----------
# A pipelined frame carrying a RUN of same-verb BF.MADD64 / BF.MEXISTS64
# commands against different filters (the config-5 fan-out: one command per
# tenant filter) used to cost one device dispatch per command.  The server
# frame loop (server/server.py) hands such runs here: same-geometry filters
# stack into one (F, S) bank, the whole run executes as ONE kernel, and each
# command's reply is a device slice riding the frame's single d2h gather.
# Under the overlap plane (core/ioplane) that gather runs on the writer
# task's completion queue, so a 64-filter wave's readback overlaps the NEXT
# wave's staging (engine staging pool) and upload — back-to-back waves
# pipeline instead of serializing on the d2h floor.

def coalesce_bloom_run(server, ctx, cmds: List[List[bytes]]):
    """Fused dispatch for a same-verb BF blob run.  Returns one LazyReply
    per command, or None when the run is ineligible (caller falls back to
    per-command dispatch, which reproduces exact per-command semantics and
    errors).  Prechecks mirror Registry.dispatch's pre-dispatch gates; any
    state that would make them diverge (open MULTI, unauthenticated
    connection, pending ASKING, routing redirect) disqualifies the run.
    Only an ineligible run returns None: any other failure raises to the
    caller."""
    import numpy as np

    from redisson_tpu_torch.core import coalesce as CO

    if ctx.multi_queue is not None or not ctx.authenticated or ctx.asking:
        return None
    verb = bytes(cmds[0][0]).upper()
    add = verb == b"BF.MADD64"
    names: List[str] = []
    keys_list = []
    for cmd in cmds:
        if len(cmd) != 3:
            return None
        if server.cluster_view or server.role == "replica":
            try:
                server.check_routing(verb.decode(), cmd[1:], asking=False)
            except RespError:
                return None  # redirect/readonly: per-command path replies
        try:
            names.append(_s(cmd[1]))
            keys = np.frombuffer(bytes(cmd[2]), dtype="<i8")
        except (ValueError, UnicodeDecodeError):
            # malformed blob/name: NOTHING was dispatched yet, so the run is
            # simply ineligible — per-command dispatch errors only the bad
            # command and serves the rest (uncoalesced semantics, exactly)
            return None
        if keys.size == 0:
            return None  # empty-blob replies follow the per-command path
        keys_list.append(keys)
    from redisson_tpu_torch.utils.metrics import run_hooks_end, run_hooks_start

    hooks = getattr(server, "hooks", None) or ()
    name = verb.decode() + ".COALESCED"
    tokens = run_hooks_start(hooks, name, (len(cmds),))
    try:
        if add:
            flags, lengths = CO.fused_bloom_add_async(server.engine, names, keys_list)
        else:
            flags, lengths = CO.fused_bloom_contains_async(
                server.engine, names, keys_list
            )
    except CO.CoalesceIneligible:
        run_hooks_end(tokens, name, None)
        return None
    except BaseException as e:
        run_hooks_end(tokens, name, e)
        raise
    run_hooks_end(tokens, name, None)

    def reply(seg):
        return LazyReply(
            device=(seg,),
            finish=lambda v: np.asarray(v[0], np.uint8).tobytes(),
        )

    out = []
    off = 0
    for n in lengths:
        out.append(reply(flags[off : off + n]))
        off += n
    return out


@register("BFA.RESERVE")
def cmd_bfa_reserve(server, ctx, args):
    from redisson_tpu_torch.client.objects.bloom_array import BloomFilterArray

    arr = BloomFilterArray(server.engine, _s(args[0]))
    arr.try_init(_int(args[1]), _int(args[2]), float(args[3]))
    return "+OK"


@register("BFA.MADD64")
def cmd_bfa_madd64(server, ctx, args):
    import numpy as np
    from redisson_tpu_torch.client.objects.bloom_array import BloomFilterArray

    arr = BloomFilterArray(server.engine, _s(args[0]))
    tenants = np.frombuffer(bytes(args[1]), dtype="<i4")
    keys = np.frombuffer(bytes(args[2]), dtype="<i8")
    newly, n = arr.add_each_async(tenants, keys)
    if n == 0:
        return b""
    return LazyReply(
        device=(newly,),
        finish=lambda v: np.asarray(v[0], np.uint8)[:n].tobytes(),
    )


@register("BFA.MEXISTS64")
def cmd_bfa_mexists64(server, ctx, args):
    import numpy as np
    from redisson_tpu_torch.client.objects.bloom_array import BloomFilterArray
    from redisson_tpu_torch.core import kernels as K

    arr = BloomFilterArray(server.engine, _s(args[0]))
    tenants = np.frombuffer(bytes(args[1]), dtype="<i4")
    keys = np.frombuffer(bytes(args[2]), dtype="<i8")
    found, n = arr.contains_async(tenants, keys)
    if n == 0:
        return b""
    return LazyReply(
        device=(found,),
        finish=lambda v: np.asarray(K.unpack_found(v[0], n), np.uint8).tobytes(),
    )


@register("PFADD64")
def cmd_pfadd64(server, ctx, args):
    import numpy as np

    keys = np.frombuffer(bytes(args[1]), dtype="<i8")
    return 1 if _hll(server, _s(args[0])).add_all(keys) else 0


# -- hyperloglog BANK blob verbs (the multi-tenant sketch fast path: one
# -- blob frame per flush, mirroring the BFA.* bloom-bank discipline) --------

def _hll_array(server, name: str):
    from redisson_tpu_torch.client.objects.hll_array import HyperLogLogArray

    return HyperLogLogArray(server.engine, name)


@register("HLLA.RESERVE")
def cmd_hlla_reserve(server, ctx, args):
    """HLLA.RESERVE name tenants — idempotent init replies 0 like BFA."""
    ok = _hll_array(server, _s(args[0])).try_init(tenants=_int(args[1]))
    return 1 if ok else 0


@register("HLLA.MADD64")
def cmd_hlla_madd64(server, ctx, args):
    """HLLA.MADD64 name <i32 tenant blob> <i64 key blob> — ONE fused
    scatter-max dispatch for the whole flush."""
    import numpy as np

    t = np.frombuffer(bytes(args[1]), dtype="<i4")
    k = np.frombuffer(bytes(args[2]), dtype="<i8")
    _hll_array(server, _s(args[0])).add(t, k)
    return "+OK"


@register("HLLA.MERGEROWS")
def cmd_hlla_mergerows(server, ctx, args):
    """HLLA.MERGEROWS name <i32 dst blob> <i32 src blob> — batched pairwise
    PFMERGE (the dense gather+max kernel)."""
    import numpy as np

    dst = np.frombuffer(bytes(args[1]), dtype="<i4")
    src = np.frombuffer(bytes(args[2]), dtype="<i4")
    try:
        _hll_array(server, _s(args[0])).merge_rows(dst, src)
    except ValueError as e:
        raise RespError(f"ERR {e}")
    return "+OK"


@register("HLLA.ESTIMATE")
def cmd_hlla_estimate(server, ctx, args):
    """HLLA.ESTIMATE name -> <f64 blob> of per-tenant estimates.  The
    estimate stays on device as a readback future (overlap plane): the reply
    rides the frame's grouped d2h and drains on the writer task."""
    import numpy as np

    est = _hll_array(server, _s(args[0])).estimate_all_async()
    return LazyReply(
        device=(est,),
        finish=lambda v: np.ascontiguousarray(v[0], dtype="<f8").tobytes(),
    )


@register("HLLA.ESTPAIRS")
def cmd_hlla_estpairs(server, ctx, args):
    """HLLA.ESTPAIRS name <i32 a blob> <i32 b blob> -> <f64 blob> of
    per-pair union estimates (PFCOUNT a b without mutation); device-form
    lazy reply like HLLA.ESTIMATE."""
    import numpy as np

    a = np.frombuffer(bytes(args[1]), dtype="<i4")
    b = np.frombuffer(bytes(args[2]), dtype="<i4")
    est = _hll_array(server, _s(args[0])).estimate_union_pairs_async(a, b)
    return LazyReply(
        device=(est,),
        finish=lambda v: np.ascontiguousarray(v[0], dtype="<f8").tobytes(),
    )


# -- hyperloglog (PFADD/PFCOUNT/PFMERGE parity, RedissonHyperLogLog.java) ----

def _hll(server, name: str):
    from redisson_tpu_torch.client.objects.hyperloglog import HyperLogLog
    from redisson_tpu_torch.client.codec import BytesCodec

    return HyperLogLog(server.engine, name, BytesCodec())


@register("PFADD")
def cmd_pfadd(server, ctx, args):
    name = _s(args[0])
    h = _hll(server, name)
    if len(args) == 1:
        # Redis contract: 1 only if the key was created by this call
        with server.engine.locked(name):
            created = not server.engine.store.exists(name)
            h.create_if_absent()
        return 1 if created else 0
    return 1 if h.add_all([bytes(a) for a in args[1:]]) else 0


@register("PFCOUNT")
def cmd_pfcount(server, ctx, args):
    names = [_s(a) for a in args]
    if len(names) == 1:
        return int(_hll(server, names[0]).count())
    return int(_hll(server, names[0]).count_with(*names[1:]))


@register("PFMERGE")
def cmd_pfmerge(server, ctx, args):
    dest = _hll(server, _s(args[0]))
    dest.merge_with(*[_s(a) for a in args[1:]])
    return "+OK"


