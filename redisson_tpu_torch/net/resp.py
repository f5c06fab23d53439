"""RESP2/RESP3 framing: command/reply encoder + incremental reply parser.

Parity targets: ``client/handler/CommandEncoder.java:104-175`` (RESP array
writer) and ``client/handler/CommandDecoder.java:58-270`` (ReplayingDecoder
over markers ``_ , + - : $ = % * > ~ # |``).  Both halves of the hot wire
path run in native C++ (``native/resp.cpp`` of this package, via ctypes, ``_native.load()``):

  * decode: ``rtpu_resp_scan`` tokenizes the byte stream; this module
    reconstructs nested Python values from the flat token stream.  The
    parser keeps its receive buffer as a bytearray plus a consumed-offset
    window with amortized compaction, so partial frames (replication
    full-ships, deep pipelined waves) cost O(n) total copying instead of
    the O(n²) of rebuilding the buffer per feed.
  * encode: the value tree is flattened ONCE into parallel op/val/off
    arrays plus a contiguous byte pool, and ``rtpu_encode_reply`` emits the
    finished frame into a reusable arena — no per-value ``b"".join`` or
    ``%d`` churn on the server's reply path.

Every entry point keeps a pure-Python fallback with identical byte-level
semantics (``encode_reply_python`` / ``encode_command_python`` / the
``_scan_python`` tokenizer); ``RTPU_NO_NATIVE=1`` forces the fallback and
tests/test_torch_resp.py holds both paths to the reference codec byte for byte.

Wire values map: simple/bulk/verbatim → bytes, error → RespError, int and
big-number → int, double → float, bool → bool, null → None, array → list,
map → dict, set → set, push (RESP3 out-of-band) → Push(list).  RESP3
attribute frames (``|``) are parsed and discarded (the decorated value is
returned plain), mirroring clients that don't surface attributes.
"""
from __future__ import annotations

import ctypes
import threading
from array import array
from typing import Any, List, Optional, Tuple

from redisson_tpu_torch.net import _native

CRLF = b"\r\n"


class RespError(Exception):
    """Server-signalled error reply (-ERR ...)."""

    @property
    def code(self) -> str:
        msg = self.args[0] if self.args else ""
        return msg.split(" ", 1)[0] if msg else ""


class Push(list):
    """RESP3 out-of-band push message (pubsub delivery)."""


# -- encoder: flat-description builder + native emitter -----------------------

# ops consumed by rtpu_encode_reply (keep in sync with native/resp.cpp);
# the marker character rides in bits 8..15 of the op word.
_E_BULK, _E_LINE, _E_NUM, _E_LIT, _E_NUMBULK = 1, 2, 3, 4, 5
_E_INTRUN, _E_BULKRUN = 6, 7
_OP_NUM_INT = _E_NUM | (0x3A << 8)     # :
_OP_NUM_ARRAY = _E_NUM | (0x2A << 8)   # *
_OP_NUM_MAP = _E_NUM | (0x25 << 8)     # %
_OP_NUM_SET = _E_NUM | (0x7E << 8)     # ~
_OP_NUM_PUSH = _E_NUM | (0x3E << 8)    # >
_OP_LINE_INT = _E_LINE | (0x3A << 8)   # :<bignum text>
_OP_LINE_DOUBLE = _E_LINE | (0x2C << 8)  # ,
_OP_LINE_ERROR = _E_LINE | (0x2D << 8)   # -
# static literal indices (kLits in native/resp.cpp)
_LIT_NULL3, _LIT_NULLB, _LIT_TRUE, _LIT_FALSE = 0, 1, 2, 3
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class _EncScratch(threading.local):
    """Per-thread reusable encode buffers: flat description lists, the byte
    pool, and the output arena (a fresh set per encode call would dominate
    the hot path)."""

    def __init__(self):
        self.ops: list = []
        self.vals: list = []
        self.offs: list = []
        self.pool = bytearray()
        self.out = ctypes.create_string_buffer(1 << 12)


_enc_scratch = _EncScratch()

# scratch buffers grown beyond this are released after the emit instead of
# living for the thread's lifetime (rare oversized replies must not pin
# their high-water mark in every worker thread)
_SCRATCH_TRIM = 1 << 22

# lazily resolved native handle for the encoder fast path (module-global so
# the per-call cost is one load + one identity check)
_ENC_UNSET = object()
_enc_lib: Any = _ENC_UNSET


def _encoder_lib():
    global _enc_lib
    if _enc_lib is _ENC_UNSET:
        _enc_lib = _native.load()
    return _enc_lib


def _flatten(value: Any, proto: int, ops, vals, offs, pool) -> None:
    """Append `value`'s pre-order flat description.

    Exact-type dispatch (``type(x) is bytes`` beats a 5-deep isinstance
    chain) with inlined leaf handling inside container loops; subclasses
    fall through to the full isinstance chain whose order — and every
    proto-2/3 projection — mirrors encode_reply_python exactly.  The
    byte-identity contract between the two paths depends on it."""
    t = type(value)
    if t is bytes:
        ops.append(_E_BULK)
        vals.append(len(value))
        offs.append(len(pool))
        pool += value
        return
    if t is int:
        if _I64_MIN <= value <= _I64_MAX:
            ops.append(_OP_NUM_INT)
            vals.append(value)
            offs.append(0)
        else:
            txt = b"%d" % value
            ops.append(_OP_LINE_INT)
            vals.append(len(txt))
            offs.append(len(pool))
            pool += txt
        return
    if t is str:
        raw = value.encode()
        ops.append(_E_BULK)
        vals.append(len(raw))
        offs.append(len(pool))
        pool += raw
        return
    if t is list or t is tuple:
        n_el = len(value)
        ops.append(_OP_NUM_ARRAY)
        vals.append(n_el)
        offs.append(0)
        if n_el >= 8 and _flatten_run(value, n_el, ops, vals, offs, pool):
            return
        # bound methods: ~15 appends per small aggregate makes the attribute
        # chase measurable at this depth
        ops_a, vals_a, offs_a = ops.append, vals.append, offs.append
        for v in value:
            tv = type(v)
            if tv is bytes:
                ops_a(_E_BULK)
                vals_a(len(v))
                offs_a(len(pool))
                pool += v
            elif tv is int and _I64_MIN <= v <= _I64_MAX:
                ops_a(_OP_NUM_INT)
                vals_a(v)
                offs_a(0)
            elif v is None:
                ops_a(_E_LIT)
                vals_a(_LIT_NULL3 if proto >= 3 else _LIT_NULLB)
                offs_a(0)
            elif tv is float and proto >= 3:
                txt = repr(v).encode()
                ops_a(_OP_LINE_DOUBLE)
                vals_a(len(txt))
                offs_a(len(pool))
                pool += txt
            else:
                _flatten(v, proto, ops, vals, offs, pool)
        return
    if t is dict:
        if proto >= 3:
            ops.append(_OP_NUM_MAP)
            vals.append(len(value))
        else:
            ops.append(_OP_NUM_ARRAY)
            vals.append(2 * len(value))
        offs.append(0)
        for k, v in value.items():
            _flatten(k, proto, ops, vals, offs, pool)
            _flatten(v, proto, ops, vals, offs, pool)
        return
    if value is None:
        ops.append(_E_LIT)
        vals.append(_LIT_NULL3 if proto >= 3 else _LIT_NULLB)
        offs.append(0)
        return
    if value is True or value is False:
        if proto >= 3:
            ops.append(_E_LIT)
            vals.append(_LIT_TRUE if value else _LIT_FALSE)
            offs.append(0)
        else:
            ops.append(_OP_NUM_INT)
            vals.append(1 if value else 0)
            offs.append(0)
        return
    _flatten_slow(value, proto, ops, vals, offs, pool)


def _flatten_run(value, n_el: int, ops, vals, offs, pool) -> bool:
    """Describe a homogeneous array body as ONE run token (C walks it) —
    the O(1)-description path for the two dominant reply shapes.

    The gate is an exact-type census (``set(map(type, ...))`` runs at C
    speed): only lists of exact bytes/bytearray or exact int qualify.
    Anything looser — bool (projected differently), int-like ``__index__``
    objects or buffer-protocol types the pure encoder rejects, memoryviews
    whose len() counts elements rather than bytes, subclasses — falls back
    to the per-element path, which mirrors encode_reply_python exactly.
    The equivalence contract (native and fallback accept/reject the same
    values) depends on this gate staying exact."""
    kinds = set(map(type, value))
    if kinds == {int}:
        try:
            run = array("q", value)
        except OverflowError:
            return False  # a big number in the body: per-element path
        ops.append(_E_INTRUN)
        vals.append(n_el)
        offs.append(len(pool))
        pool += run.tobytes()
        return True
    if kinds <= {bytes, bytearray}:
        blob = b"".join(value)
        ops.append(_E_BULKRUN)
        vals.append(n_el)
        offs.append(len(pool))
        pool += array("q", map(len, value)).tobytes()
        pool += blob
        return True
    return False


def _flatten_slow(value: Any, proto: int, ops, vals, offs, pool) -> None:
    """Subclasses and rarer types — the full chain, in encode_reply_python's
    exact dispatch order (bool/None handled by the caller's identity checks;
    bool cannot be subclassed, so isinstance(int) here is never a bool)."""
    if isinstance(value, int):
        if _I64_MIN <= value <= _I64_MAX:
            ops.append(_OP_NUM_INT)
            vals.append(value)
            offs.append(0)
        else:
            txt = b"%d" % value
            ops.append(_OP_LINE_INT)
            vals.append(len(txt))
            offs.append(len(pool))
            pool += txt
        return
    if isinstance(value, float):
        if proto >= 3:
            txt = repr(value).encode()
            ops.append(_OP_LINE_DOUBLE)
            vals.append(len(txt))
            offs.append(len(pool))
            pool += txt
            return
        import math as _math

        txt = (
            str(int(value)) if _math.isfinite(value) and value == int(value)
            else repr(value)
        ).encode()
        ops.append(_E_BULK)
        vals.append(len(txt))
        offs.append(len(pool))
        pool += txt
        return
    if isinstance(value, (bytes, bytearray, memoryview)):
        value = bytes(value)  # normalizes non-byte-format memoryview len()
        ops.append(_E_BULK)
        vals.append(len(value))
        offs.append(len(pool))
        pool += value
        return
    if isinstance(value, str):
        raw = value.encode()
        ops.append(_E_BULK)
        vals.append(len(raw))
        offs.append(len(pool))
        pool += raw
        return
    if isinstance(value, RespError):
        msg = (str(value.args[0]) if value.args else "ERR").encode()
        ops.append(_OP_LINE_ERROR)
        vals.append(len(msg))
        offs.append(len(pool))
        pool += msg
        return
    if isinstance(value, Push):
        ops.append(_OP_NUM_PUSH if proto >= 3 else _OP_NUM_ARRAY)
        vals.append(len(value))
        offs.append(0)
        for v in value:
            _flatten(v, proto, ops, vals, offs, pool)
        return
    if isinstance(value, (list, tuple)):
        ops.append(_OP_NUM_ARRAY)
        vals.append(len(value))
        offs.append(0)
        for v in value:
            _flatten(v, proto, ops, vals, offs, pool)
        return
    if isinstance(value, (set, frozenset)):
        ops.append(_OP_NUM_SET if proto >= 3 else _OP_NUM_ARRAY)
        vals.append(len(value))
        offs.append(0)
        for v in sorted(value, key=repr):
            _flatten(v, proto, ops, vals, offs, pool)
        return
    if isinstance(value, dict):
        if proto >= 3:
            ops.append(_OP_NUM_MAP)
            vals.append(len(value))
        else:
            ops.append(_OP_NUM_ARRAY)
            vals.append(2 * len(value))
        offs.append(0)
        for k, v in value.items():
            _flatten(k, proto, ops, vals, offs, pool)
            _flatten(v, proto, ops, vals, offs, pool)
        return
    raise TypeError(f"cannot encode reply of type {type(value).__name__}")


def _emit_flat(lib, sc: _EncScratch) -> bytes:
    """One native call turning the scratch's flat description into bytes."""
    pool = sc.pool
    # the description lists convert to packed C arrays in one shot (array()
    # from a list is a C-speed copy — far cheaper than per-node ctypes sets)
    a_ops = array("i", sc.ops)
    a_vals = array("q", sc.vals)
    a_offs = array("q", sc.offs)
    n = len(a_ops)
    # arena sizing: 32 bytes/token + the pool covers every non-run token
    # exactly; run tokens (framing per element, not per token) can exceed it
    # — the emitter then returns -1 and the arena grows geometrically
    need = len(pool) + 32 * n + 16
    out = sc.out
    if len(out) < need:
        sc.out = out = ctypes.create_string_buffer(max(need, 2 * len(out)))
    pool_ref = ctypes.c_char.from_buffer(pool) if pool else None
    try:
        while True:
            w = lib.rtpu_encode_reply(
                a_ops.buffer_info()[0],
                a_vals.buffer_info()[0],
                a_offs.buffer_info()[0],
                n,
                ctypes.addressof(pool_ref) if pool_ref is not None else 0,
                ctypes.addressof(out),
                len(out),
            )
            if w >= 0:
                break
            if w != -1:  # flattener/native drift; fail loudly
                raise RuntimeError(f"rtpu_encode_reply failed ({w})")
            sc.out = out = ctypes.create_string_buffer(4 * len(out))
    finally:
        del pool_ref
    result = ctypes.string_at(out, w)
    # one oversized reply must not pin O(largest-reply) memory in every
    # worker thread forever: trim the grown arena/pool back after use
    if len(out) > _SCRATCH_TRIM:
        sc.out = ctypes.create_string_buffer(1 << 12)
    if len(pool) > _SCRATCH_TRIM:
        sc.pool = bytearray()
    return result


# containers below this many elements encode faster through the pure path
# (the native emit's fixed FFI/scratch cost needs elements to amortize over)
_REPLY_RUN_MIN = 8
# ... and payloads above this size are faster through the pure path too: the
# flat-description arena costs two extra full-payload copies (pool + arena)
# that a b"".join never pays, and memcpy dominates past a few KB (measured
# crossover ~8-16KB; bulk uploads like BF.MADD64's 80KB key blobs regress
# without this gate)
_BIG_ITEM = 8192


def _first_item_is_big(value) -> bool:
    """Cheap homogeneity heuristic: reply arrays/frames carry same-shaped
    elements, so element 0's size predicts the payload mass."""
    try:
        v0 = value[0]
    except (IndexError, KeyError, TypeError):
        return False
    return isinstance(v0, (bytes, bytearray, memoryview)) and len(v0) > _BIG_ITEM


def encode_reply(value: Any, proto: int = 3) -> bytes:
    """Encode a server reply value for the negotiated protocol.

    Scalars and small containers take the direct pure path (a %-format or a
    short join beats any FFI round trip); larger containers — where the
    pure encoder pays one bytes object per element plus a join — flatten
    once and emit through the native arena.  Byte-identical to
    encode_reply_python either way."""
    if type(value) is bytes:
        return b"$%d\r\n" % len(value) + value + CRLF
    if isinstance(value, (bytes, bytearray, memoryview)):
        # bytes() first: a non-byte-format memoryview's len() counts
        # elements, not bytes
        value = bytes(value)
        return b"$%d\r\n" % len(value) + value + CRLF
    if value is None:
        return b"_\r\n" if proto >= 3 else b"$-1\r\n"
    if value is True or value is False:
        if proto >= 3:
            return b"#t\r\n" if value else b"#f\r\n"
        return b":1\r\n" if value else b":0\r\n"
    if isinstance(value, int):
        return b":%d\r\n" % value
    if isinstance(value, str):
        return encode_bulk(value.encode())
    if isinstance(value, (float, RespError)):
        return encode_reply_python(value, proto)
    lib = _enc_lib
    if lib is _ENC_UNSET:
        lib = _encoder_lib()
    if lib is None:
        return encode_reply_python(value, proto)
    try:
        if len(value) < _REPLY_RUN_MIN:
            return encode_reply_python(value, proto)
    except TypeError:
        pass
    if type(value) in (list, tuple) and _first_item_is_big(value):
        return encode_reply_python(value, proto)
    sc = _enc_scratch
    del sc.ops[:], sc.vals[:], sc.offs[:]
    del sc.pool[:]
    _flatten(value, proto, sc.ops, sc.vals, sc.offs, sc.pool)
    return _emit_flat(lib, sc)


def encode_replies(values, proto: int = 3) -> bytes:
    """Encode a whole frame's reply values in ONE native emit (the server's
    aggregated-write path): every value flattens into the same description,
    the arena is written once, one bytes object comes out.  Small frames
    join per-value dispatched encodes instead (each value still picks its
    own best path)."""
    lib = _enc_lib
    if lib is _ENC_UNSET:
        lib = _encoder_lib()
    if lib is None:
        return b"".join(encode_reply_python(v, proto) for v in values)
    if len(values) < _REPLY_RUN_MIN or _first_item_is_big(values):
        return b"".join(encode_reply(v, proto) for v in values)
    sc = _enc_scratch
    del sc.ops[:], sc.vals[:], sc.offs[:]
    del sc.pool[:]
    # a frame of homogeneous scalar replies (pipelined GET/contains waves) is
    # a run with no aggregate header — one description token for the lot
    if len(values) >= 8 and _flatten_run(
        values, len(values), sc.ops, sc.vals, sc.offs, sc.pool
    ):
        return _emit_flat(lib, sc)
    for v in values:
        _flatten(v, proto, sc.ops, sc.vals, sc.offs, sc.pool)
    return _emit_flat(lib, sc)


def _flatten_arg(a, ops, vals, offs, pool) -> None:
    t = type(a)
    if t is bytes:
        pass
    elif t is str:
        a = a.encode()
    elif isinstance(a, str):
        a = a.encode()
    elif isinstance(a, int):
        if _I64_MIN <= a <= _I64_MAX:
            ops.append(_E_NUMBULK)
            vals.append(a)
            offs.append(0)
            return
        a = b"%d" % a
    elif isinstance(a, float):
        a = repr(a).encode()
    elif not isinstance(a, (bytes, bytearray, memoryview)):
        raise TypeError(f"cannot encode {type(a).__name__} as a RESP argument")
    ops.append(_E_BULK)
    vals.append(len(a))
    offs.append(len(pool))
    pool += a


def encode_command(*args) -> bytes:
    """Encode one command as a RESP array of bulk strings.  A single small
    command cannot amortize an FFI round trip, so this is always the pure
    path — pipelined frames go native through encode_commands."""
    return encode_command_python(*args)


# below this many commands a pipelined frame's native emit doesn't amortize
# its fixed FFI/scratch cost — the joined pure encoders win
_CMD_FRAME_MIN = 8


def encode_commands(commands) -> bytes:
    """Encode a whole pipelined frame in ONE native call (the
    CommandBatchEncoder one-flush discipline at the encoder level): one flat
    description, one arena write, one bytes object out."""
    lib = _enc_lib
    if lib is _ENC_UNSET:
        lib = _encoder_lib()
    if lib is None or len(commands) < _CMD_FRAME_MIN:
        return b"".join(encode_command_python(*c) for c in commands)
    # bulk-upload frames (BF.MADD64-style multi-KB blob args) gain nothing
    # from the native emit and pay two extra full-payload copies — scan a
    # bounded prefix for a big arg and route such frames to the join path
    for c in commands[:128]:
        for a in c:
            if type(a) is bytes and len(a) > _BIG_ITEM:
                return b"".join(encode_command_python(*c) for c in commands)
    sc = _enc_scratch
    del sc.ops[:], sc.vals[:], sc.offs[:]
    del sc.pool[:]
    ops, vals, offs, pool = sc.ops, sc.vals, sc.offs, sc.pool
    for c in commands:
        ops.append(_OP_NUM_ARRAY)
        vals.append(len(c))
        offs.append(0)
        for a in c:
            _flatten_arg(a, ops, vals, offs, pool)
    return _emit_flat(lib, sc)


# -- pure-Python encoders (the documented fallback + identity reference) ------


def encode_command_python(*args) -> bytes:
    """Pure-Python command encoder (fallback + native-identity reference)."""
    parts = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        elif isinstance(a, int):
            a = b"%d" % a
        elif isinstance(a, float):
            a = repr(a).encode()
        elif not isinstance(a, (bytes, bytearray, memoryview)):
            raise TypeError(f"cannot encode {type(a).__name__} as a RESP argument")
        parts.append(b"$%d\r\n" % len(a))
        parts.append(bytes(a))
        parts.append(CRLF)
    return b"".join(parts)


def encode_simple(s: str) -> bytes:
    return b"+" + s.encode() + CRLF


def encode_error(msg: str) -> bytes:
    return b"-" + msg.encode() + CRLF


def encode_int(n: int) -> bytes:
    return b":%d\r\n" % n


def encode_bulk(data: Optional[bytes]) -> bytes:
    if data is None:
        return b"$-1\r\n"
    return b"$%d\r\n" % len(data) + data + CRLF


def encode_reply_python(value: Any, proto: int = 3) -> bytes:
    """Pure-Python reply encoder (fallback + native-identity reference).

    proto 3 (HELLO 3): the full typed surface — null `_`, boolean `#`,
    double `,`, map `%`, set `~`, push `>` (CommandDecoder.java:58-270
    marker set).  proto 2: the strictly RESP2-compliant projection real
    Redis uses pre-HELLO — maps flatten to field-value arrays, sets and
    pushes become plain arrays, doubles become bulk strings, booleans
    become integers, null is the empty bulk."""
    if value is None:
        return b"_\r\n" if proto >= 3 else b"$-1\r\n"
    if value is True or value is False:
        if proto >= 3:
            return b"#t\r\n" if value else b"#f\r\n"
        return encode_int(1 if value else 0)
    if isinstance(value, int):
        return encode_int(value)
    if isinstance(value, float):
        if proto >= 3:
            return b"," + repr(value).encode() + CRLF
        # RESP2 projection keeps Redis's float formatting: integral scores
        # print without '.0' (ZSCORE 3 replies "3", not "3.0")
        import math as _math

        txt = (
            str(int(value)) if _math.isfinite(value) and value == int(value)
            else repr(value)
        )
        return encode_bulk(txt.encode())
    if isinstance(value, (bytes, bytearray, memoryview)):
        return encode_bulk(bytes(value))
    if isinstance(value, str):
        return encode_bulk(value.encode())
    if isinstance(value, RespError):
        return encode_error(str(value.args[0]) if value.args else "ERR")
    if isinstance(value, Push):
        marker = b">" if proto >= 3 else b"*"
        return marker + b"%d\r\n" % len(value) + b"".join(
            encode_reply_python(v, proto) for v in value
        )
    if isinstance(value, (list, tuple)):
        return b"*%d\r\n" % len(value) + b"".join(
            encode_reply_python(v, proto) for v in value
        )
    if isinstance(value, (set, frozenset)):
        marker = b"~" if proto >= 3 else b"*"
        return marker + b"%d\r\n" % len(value) + b"".join(
            encode_reply_python(v, proto) for v in sorted(value, key=repr)
        )
    if isinstance(value, dict):
        if proto >= 3:
            out = [b"%%%d\r\n" % len(value)]
            for k, v in value.items():
                out.append(encode_reply_python(k, proto))
                out.append(encode_reply_python(v, proto))
            return b"".join(out)
        out = [b"*%d\r\n" % (2 * len(value))]
        for k, v in value.items():
            out.append(encode_reply_python(k, proto))
            out.append(encode_reply_python(v, proto))
        return b"".join(out)
    raise TypeError(f"cannot encode reply of type {type(value).__name__}")


# -- token kinds (keep in sync with native/resp.cpp) -------------------------

T_SIMPLE, T_ERROR, T_INT, T_BULK, T_NULL, T_ARRAY = 1, 2, 3, 4, 5, 6
T_MAP, T_SET, T_DOUBLE, T_BOOL, T_PUSH = 7, 8, 9, 10, 11
T_ATTR, T_BIGNUM = 12, 13


class ProtocolError(Exception):
    pass


def _scan_python(buf, base: int = 0) -> Tuple[int, List[Tuple[int, int, int]], int]:
    """Pure-Python fallback tokenizer, identical contract to rtpu_resp_scan:
    scans buf[base:] and returns (n_values, tokens[(type, val, off)],
    consumed-relative-to-base).  Works on bytes AND bytearray (token offsets
    are absolute; single bytes compare as ints so no per-marker slice)."""
    tokens: List[Tuple[int, int, int]] = []
    pos = base
    n_values = 0
    committed = (base, 0)
    blen = len(buf)
    find = buf.find

    def parse() -> bool:
        nonlocal pos
        if pos >= blen:
            return False
        t = buf[pos]
        end = find(CRLF, pos + 1)
        if end < 0:
            return False
        loff, nxt = pos + 1, end + 2
        if t == 0x2B:  # +
            tokens.append((T_SIMPLE, end - loff, loff)); pos = nxt; return True
        if t == 0x2D:  # -
            tokens.append((T_ERROR, end - loff, loff)); pos = nxt; return True
        if t == 0x3A or t == 0x28:  # : (
            tokens.append((T_INT, int(buf[loff:end]), loff)); pos = nxt; return True
        if t == 0x23:  # '#'
            line = buf[loff:end]
            if line != b"t" and line != b"f":
                raise ProtocolError("bad boolean")
            tokens.append((T_BOOL, 1 if line == b"t" else 0, loff)); pos = nxt; return True
        if t == 0x2C:  # ,
            tokens.append((T_DOUBLE, end - loff, loff)); pos = nxt; return True
        if t == 0x5F:  # _
            tokens.append((T_NULL, 0, loff)); pos = nxt; return True
        if t == 0x24 or t == 0x3D:  # $ =
            n = int(buf[loff:end])
            if n == -1:
                tokens.append((T_NULL, 0, loff)); pos = nxt; return True
            if n < 0:
                raise ProtocolError("bad bulk length")
            if nxt + n + 2 > blen:
                return False
            if buf[nxt + n : nxt + n + 2] != CRLF:
                raise ProtocolError("bulk not CRLF-terminated")
            tokens.append((T_BULK, n, nxt)); pos = nxt + n + 2; return True
        if t == 0x2A or t == 0x7E or t == 0x3E or t == 0x25:  # * ~ > %
            n = int(buf[loff:end])
            if n == -1:
                tokens.append((T_NULL, 0, loff)); pos = nxt; return True
            if n < 0:
                raise ProtocolError("bad aggregate length")
            kind = (
                T_ARRAY if t == 0x2A else T_SET if t == 0x7E
                else T_PUSH if t == 0x3E else T_MAP
            )
            tokens.append((kind, n, loff)); pos = nxt
            for _ in range(2 * n if t == 0x25 else n):
                if not parse():
                    return False
            return True
        if t == 0x7C:  # | — RESP3 attribute: n pairs, then the value
            n = int(buf[loff:end])
            if n < 0:
                raise ProtocolError("bad attribute length")
            tokens.append((T_ATTR, n, loff)); pos = nxt
            for _ in range(2 * n):
                if not parse():
                    return False
            return parse()
        raise ProtocolError(f"unknown RESP marker {bytes((t,))!r}")

    while pos < blen:
        try:
            ok = parse()
        except ValueError as e:  # int() failures on malformed headers
            raise ProtocolError(str(e)) from e
        if not ok:
            del tokens[committed[1] :]
            break
        n_values += 1
        committed = (pos, len(tokens))
    return n_values, tokens, committed[0] - base


class _TokenBuf:
    """Reusable native token array — one per parser, grown on demand (a
    fresh 1.5MB ctypes array per recv() would dominate the hot path)."""

    __slots__ = ("cap", "arr")

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self.arr = (_native.RtpuToken * cap)()

    def grow(self, factor: int = 4) -> None:
        self.cap *= factor
        self.arr = (_native.RtpuToken * self.cap)()


def _scan_native(
    lib, tb: "_TokenBuf", buf, base: int = 0
) -> Tuple[int, List[Tuple[int, int, int]], int]:
    """Native scan of buf[base:] — zero-copy: the window is a ctypes view
    over the parser's bytearray, released before the caller compacts."""
    nbytes = len(buf) - base
    while True:
        ntok = ctypes.c_uint64(0)
        consumed = ctypes.c_uint64(0)
        if isinstance(buf, bytes):
            win = buf if base == 0 else buf[base:]
        else:
            # zero-copy window into the parser's bytearray: a one-char view
            # at the offset, passed by reference (no per-size array type)
            win = ctypes.byref(ctypes.c_char.from_buffer(buf, base))
        try:
            n = lib.rtpu_resp_scan(
                win, nbytes, tb.arr, tb.cap, ctypes.byref(ntok), ctypes.byref(consumed)
            )
        finally:
            del win  # release the buffer export before any bytearray mutation
        if n == -2:
            # one value alone overflowed the token buffer: grow and rescan
            tb.grow()
            continue
        if n < 0:
            raise ProtocolError("malformed RESP stream")
        arr = tb.arr
        out = [(t.type, t.val, t.off + base) for t in arr[: ntok.value]]
        return n, out, consumed.value


def _build_values(buf, tokens: List[Tuple[int, int, int]], n_values: int) -> List[Any]:
    """Reconstruct nested Python values from the flat token stream.  `buf`
    may be bytes or a memoryview over the parser's bytearray (payload slices
    are materialized to bytes either way)."""
    it = iter(tokens)

    def build() -> Any:
        kind, val, off = next(it)
        if kind == T_BULK or kind == T_SIMPLE:
            return bytes(buf[off : off + val])
        if kind == T_INT:
            return val
        if kind == T_NULL:
            return None
        if kind == T_ERROR:
            return RespError(bytes(buf[off : off + val]).decode("utf-8", "replace"))
        if kind == T_DOUBLE:
            txt = bytes(buf[off : off + val])
            if txt == b"inf":
                return float("inf")
            if txt == b"-inf":
                return float("-inf")
            return float(txt)
        if kind == T_BOOL:
            return bool(val)
        if kind == T_BIGNUM:
            return int(bytes(buf[off : off + val]))
        if kind == T_ARRAY:
            return [build() for _ in range(val)]
        if kind == T_PUSH:
            return Push(build() for _ in range(val))
        if kind == T_SET:
            items = [build() for _ in range(val)]
            try:
                return set(items)
            except TypeError:
                return items
        if kind == T_MAP:
            return {_hashable(build()): build() for _ in range(val)}
        if kind == T_ATTR:
            for _ in range(2 * val):
                build()  # attribute pairs: parsed, then discarded
            return build()
        raise ProtocolError(f"unknown token kind {kind}")

    return [build() for _ in range(n_values)]


def _hashable(v: Any) -> Any:
    return tuple(v) if isinstance(v, list) else v


# threshold below which compaction is skipped (the window just advances) —
# keeps tiny request/reply traffic from paying a delete per feed
_COMPACT_MIN = 1 << 16


class RespParser:
    """Incremental reply parser: feed() bytes, pop complete values.

    One instance per connection — the CommandsQueue-side decode state
    (client/handler/CommandDecoder.java keeps equivalent state in the
    channel pipeline).  The receive buffer is a bytearray window: feed()
    appends in place, `_pos` tracks consumed bytes, and the buffer compacts
    only when the consumed prefix dominates — O(total bytes) copying even
    when a 4MB bulk arrives in 1KB chunks (the old bytes-concat pattern was
    O(n²) under exactly that load).
    """

    def __init__(self, use_native: bool = True):
        self._buf = bytearray()
        self._pos = 0
        self._lib = _native.load() if use_native else None
        self._tokens = _TokenBuf() if self._lib is not None else None

    def feed(self, data) -> List[Any]:
        buf = self._buf
        buf += data
        values: List[Any] = []
        # loop until no progress: a scan pass can commit a prefix and leave a
        # complete value behind it (e.g. after a token-buffer growth retry)
        while len(buf) > self._pos:
            if self._lib is not None:
                n, tokens, consumed = _scan_native(self._lib, self._tokens, buf, self._pos)
            else:
                n, tokens, consumed = _scan_python(buf, self._pos)
            if n == 0:
                break
            mv = memoryview(buf)
            try:
                values.extend(_build_values(mv, tokens, n))
            finally:
                mv.release()
            self._pos += consumed
        pos = self._pos
        if pos and (pos == len(buf) or (pos >= _COMPACT_MIN and 2 * pos >= len(buf))):
            del buf[:pos]
            self._pos = 0
        return values

    @property
    def pending_bytes(self) -> int:
        return len(self._buf) - self._pos


class _SlotScratch(threading.local):
    """Per-thread scratch for calc_slots: the offs/lens/out ctypes arrays are
    grown-on-demand and reused, so a steady stream of routing calls stops
    allocating three arrays per call."""

    def __init__(self):
        self.cap = 0
        self.offs = None
        self.lens = None
        self.out = None

    def ensure(self, n: int):
        if self.cap < n:
            cap = max(16, n, 2 * self.cap)
            self.offs = (ctypes.c_uint64 * cap)()
            self.lens = (ctypes.c_uint64 * cap)()
            self.out = (ctypes.c_uint16 * cap)()
            self.cap = cap
        return self.offs, self.lens, self.out


_slot_scratch = _SlotScratch()


def calc_slots(keys: List[bytes]) -> List[int]:
    """Batched cluster-slot calc (CRC16 + {hashtag}), native when available."""
    lib = _native.load()
    if lib is None:
        from redisson_tpu_torch.utils.crc16 import calc_slot

        return [calc_slot(k) for k in keys]
    n = len(keys)
    if n == 0:
        return []
    offs, lens, out = _slot_scratch.ensure(n)
    if n == 1:
        # single-key fast path (the routing layer's common case): no join,
        # no offset-table fill
        k = keys[0]
        offs[0] = 0
        lens[0] = len(k)
        lib.rtpu_calc_slots(bytes(k), offs, lens, 1, out)
        return [out[0]]
    pos = 0
    for i, k in enumerate(keys):
        offs[i] = pos
        lens[i] = len(k)
        pos += len(k)
    lib.rtpu_calc_slots(b"".join(keys), offs, lens, n, out)
    return out[:n]
