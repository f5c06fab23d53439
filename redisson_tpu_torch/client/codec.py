"""Codec SPI: pluggable value serialization (value <-> bytes at the
object-handle boundary).

A copy of ``redisson_tpu/client/codec.py``.  Sketch objects feed the
encoded bytes of non-integer keys to the hash, so a codec's output is part
of what a bloom plane or HLL bank means: every codec here writes the
reference's bytes, and each package decodes the other's.  The default is
JSON with a pickle fallback for values JSON cannot express; maps encode keys
and values through the map split points (CompositeCodec); compression
wrappers (zlib, bz2, lzma, LZ4 through ``utils/lz4block``) nest any inner
codec.

Object references (``ReferenceCodec``): a handle stored inside another
object persists as a typed reference whose payload names the handle's
module.  The payload is a persisted format, so the port writes the
reference's module path (``redisson_tpu.client.objects.<mod>``) and binds
it, on read, to this package's module of the same path
(``redisson_tpu_torch.client.objects.<mod>``) without importing
``redisson_tpu``, as ``net/safe_pickle`` does for class names in a pickle.
"""
from __future__ import annotations

import json
import pickle
import struct
import zlib
from itertools import repeat
from typing import Any

from redisson_tpu_torch.net.safe_pickle import PORT_ROOT, WIRE_ROOT, wire_module
from redisson_tpu_torch.utils import lz4block


class Codec:
    """Encoder/decoder pair. Subclasses must be stateless & thread-safe."""

    name = "codec"

    def encode(self, value: Any) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes) -> Any:
        raise NotImplementedError

    # map key/value split points (CompositeCodec overrides)
    def encode_map_key(self, value: Any) -> bytes:
        return self.encode(value)

    def decode_map_key(self, data: bytes) -> Any:
        return self.decode(data)

    def encode_map_value(self, value: Any) -> bytes:
        return self.encode(value)

    def decode_map_value(self, data: bytes) -> Any:
        return self.decode(data)

    def decode_map_values(self, datas: list) -> list:
        """decode_map_value over a map's stored values, in order."""
        decode = self.decode_map_value
        return [decode(d) for d in datas]


class JsonCodec(Codec):
    """Default codec (parity: codec/JsonJacksonCodec.java).

    JSON with a one-byte tag; values JSON can't express fall back to pickle
    (tag 'P') so arbitrary Python objects still round-trip, like the
    reference's default typing support.
    """

    name = "json"

    def encode(self, value: Any) -> bytes:
        try:
            return b"J" + json.dumps(value, separators=(",", ":"), sort_keys=True).encode()
        except (TypeError, ValueError):
            return b"P" + pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)

    def decode(self, data: bytes) -> Any:
        tag, body = data[:1], data[1:]
        if tag == b"J":
            return json.loads(body)
        if tag == b"P":
            return pickle.loads(body)
        raise ValueError(f"unknown JsonCodec tag {tag!r}")


class PickleCodec(Codec):
    """Binary python-native codec (parity: codec/SerializationCodec.java)."""

    name = "pickle"

    def encode(self, value: Any) -> bytes:
        return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)

    def decode(self, data: bytes) -> Any:
        return pickle.loads(data)


class StringCodec(Codec):
    """UTF-8 strings (parity: client/codec/StringCodec.java)."""

    name = "string"

    def encode(self, value: Any) -> bytes:
        if isinstance(value, bytes):
            return value
        return str(value).encode()

    def decode(self, data: bytes) -> Any:
        return data.decode()

    def decode_map_values(self, datas: list) -> list:
        return [d.decode() for d in datas]


class BytesCodec(Codec):
    """Raw bytes passthrough (parity: client/codec/ByteArrayCodec.java)."""

    name = "bytes"

    def encode(self, value: Any) -> bytes:
        if isinstance(value, (bytes, bytearray, memoryview)):
            return bytes(value)
        raise TypeError(f"BytesCodec requires bytes, got {type(value)}")

    def decode(self, data: bytes) -> Any:
        return data


class LongCodec(Codec):
    """Signed 64-bit integers (parity: client/codec/LongCodec.java)."""

    name = "long"

    def encode(self, value: Any) -> bytes:
        return struct.pack("<q", int(value))

    def decode(self, data: bytes) -> Any:
        return struct.unpack("<q", data)[0]


class DoubleCodec(Codec):
    """Float64 (parity: client/codec/DoubleCodec.java)."""

    name = "double"

    def encode(self, value: Any) -> bytes:
        return struct.pack("<d", float(value))

    def decode(self, data: bytes) -> Any:
        return struct.unpack("<d", data)[0]


class CompositeCodec(Codec):
    """Different codecs for map key / map value (parity: codec/CompositeCodec.java)."""

    name = "composite"

    def __init__(self, map_key_codec: Codec, map_value_codec: Codec, value_codec: Codec | None = None):
        self.key_codec = map_key_codec
        self.value_codec_ = map_value_codec
        self.plain = value_codec or map_value_codec

    def encode(self, value):
        return self.plain.encode(value)

    def decode(self, data):
        return self.plain.decode(data)

    def encode_map_key(self, value):
        return self.key_codec.encode(value)

    def decode_map_key(self, data):
        return self.key_codec.decode(data)

    def encode_map_value(self, value):
        return self.value_codec_.encode(value)

    def decode_map_value(self, data):
        return self.value_codec_.decode(data)


class ZlibCodec(Codec):
    """Compression wrapper around an inner codec (parity: codec/LZ4Codec.java /
    SnappyCodecV2.java — wrap-any-codec pattern; zlib is the in-stdlib stand-in)."""

    name = "zlib"

    def __init__(self, inner: Codec | None = None, level: int = 1):
        self.inner = inner or JsonCodec()
        self.level = level

    def encode(self, value):
        return zlib.compress(self.inner.encode(value), self.level)

    def decode(self, data):
        return self.inner.decode(zlib.decompress(data))


try:  # optional, gated: msgpack is not in the baked image
    import msgpack  # type: ignore

    class MsgPackCodec(Codec):  # pragma: no cover - optional dep
        name = "msgpack"

        def encode(self, value):
            return msgpack.packb(value)

        def decode(self, data):
            return msgpack.unpackb(data)

except ImportError:  # pragma: no cover
    MsgPackCodec = None  # type: ignore


class Bz2Codec(Codec):
    """bz2 compression wrapper (higher ratio / slower than Zlib — the LZ4-vs-
    Snappy trade of the reference's two compression codecs)."""

    name = "bz2"

    # no module-object attributes: codecs must PICKLE (they travel with
    # OBJCALL frames per the getMap(name, codec) contract)
    def __init__(self, inner: Codec | None = None):
        self.inner = inner or JsonCodec()

    def encode(self, value):
        import bz2

        return bz2.compress(self.inner.encode(value))

    def decode(self, data):
        import bz2

        return self.inner.decode(bz2.decompress(data))


class LzmaCodec(Codec):
    """xz/lzma compression wrapper."""

    name = "lzma"

    def __init__(self, inner: Codec | None = None):
        self.inner = inner or JsonCodec()

    def encode(self, value):
        import lzma

        return lzma.compress(self.inner.encode(value))

    def decode(self, data):
        import lzma

        return self.inner.decode(lzma.decompress(data))


class Lz4Codec(Codec):
    """LZ4 block compression wrapper — the reference's recommended
    compression codec (codec/LZ4Codec.java).  Backed by the pure-python
    block implementation in utils/lz4block.py (standard block format:
    interoperable with any LZ4 block decoder); the frame is a 4-byte
    BIG-ENDIAN uncompressed length + the block — LZ4Codec.java writes the
    length with Netty ``ByteBuf.writeInt`` (network byte order), so the
    frame is byte-compatible with reference-written values."""

    name = "lz4"

    def __init__(self, inner: Codec | None = None):
        self.inner = inner or JsonCodec()

    def encode(self, value):
        raw = self.inner.encode(value)
        return len(raw).to_bytes(4, "big") + lz4block.compress(raw)

    def decode(self, data):
        be = int.from_bytes(data[:4], "big")
        try:
            raw = lz4block.decompress(data[4:], be)
        except ValueError as e:
            # at-rest compat: frames written before the wire-compat fix
            # carried the length little-endian; exactly one byte order
            # passes the decompressor's size check, so the retry is
            # unambiguous.  A genuinely corrupt frame surfaces the ORIGINAL
            # (big-endian, current-format) error, never the retry's.
            le = int.from_bytes(data[:4], "little")
            if le == be:
                raise
            try:
                raw = lz4block.decompress(data[4:], le)
            except ValueError:
                raise e from None
        return self.inner.decode(raw)


class ProtobufCodec(Codec):
    """Protocol-buffers codec for one message class (parity:
    codec/ProtobufCodec.java — values must be instances of `message_cls`)."""

    name = "protobuf"

    def __init__(self, message_cls):
        self.message_cls = message_cls

    def encode(self, value):
        if not isinstance(value, self.message_cls):
            raise TypeError(
                f"ProtobufCodec({self.message_cls.__name__}) cannot encode {type(value).__name__}"
            )
        return value.SerializeToString()

    def decode(self, data):
        msg = self.message_cls()
        msg.ParseFromString(bytes(data))
        return msg


class CborCodec(Codec):
    """CBOR binary codec (parity: codec/CborJacksonCodec.java) — a pure
    RFC 8949 core-type subset (int, bytes, str, list, dict, bool, None,
    float64), self-contained because the image carries no cbor library.
    Interoperable with any standards-compliant CBOR decoder for these
    types."""

    name = "cbor"

    def encode(self, value: Any) -> bytes:
        out = bytearray()
        self._enc(value, out)
        return bytes(out)

    @staticmethod
    def _head(major: int, arg: int, out: bytearray) -> None:
        if arg < 24:
            out.append((major << 5) | arg)
        elif arg < 0x100:
            out.append((major << 5) | 24); out += arg.to_bytes(1, "big")
        elif arg < 0x10000:
            out.append((major << 5) | 25); out += arg.to_bytes(2, "big")
        elif arg < 0x100000000:
            out.append((major << 5) | 26); out += arg.to_bytes(4, "big")
        else:
            out.append((major << 5) | 27); out += arg.to_bytes(8, "big")

    def _enc(self, v: Any, out: bytearray) -> None:
        if v is False:
            out.append(0xF4)
        elif v is True:
            out.append(0xF5)
        elif v is None:
            out.append(0xF6)
        elif isinstance(v, int):
            if not (-(1 << 64) <= v < (1 << 64)):
                raise TypeError(
                    "CBOR integer out of uint64 argument range "
                    "(RFC 8949 bignum tags are not supported)"
                )
            if v >= 0:
                self._head(0, v, out)
            else:
                self._head(1, -1 - v, out)
        elif isinstance(v, float):
            out.append(0xFB); out += struct.pack(">d", v)
        elif isinstance(v, (bytes, bytearray, memoryview)):
            b = bytes(v); self._head(2, len(b), out); out += b
        elif isinstance(v, str):
            b = v.encode(); self._head(3, len(b), out); out += b
        elif isinstance(v, (list, tuple)):
            self._head(4, len(v), out)
            for item in v:
                self._enc(item, out)
        elif isinstance(v, dict):
            self._head(5, len(v), out)
            for k, val in v.items():
                self._enc(k, out); self._enc(val, out)
        else:
            raise TypeError(f"CborCodec cannot encode {type(v).__name__}")

    def decode(self, data: bytes) -> Any:
        try:
            v, i = self._dec(bytes(data), 0)
        except (IndexError, struct.error):
            raise ValueError("truncated CBOR input") from None
        if i != len(data):
            raise ValueError("trailing bytes after CBOR value")
        return v

    @staticmethod
    def _arg(data: bytes, i: int):
        info = data[i] & 0x1F
        i += 1
        if info < 24:
            return info, i
        n = {24: 1, 25: 2, 26: 4, 27: 8}.get(info)
        if n is None:
            raise ValueError(f"unsupported CBOR additional info {info}")
        if i + n > len(data):  # a short slice would silently mis-decode
            raise ValueError("truncated CBOR input")
        return int.from_bytes(data[i:i + n], "big"), i + n

    def _dec(self, data: bytes, i: int):
        major = data[i] >> 5
        if major == 7:
            b = data[i]
            if b == 0xF4:
                return False, i + 1
            if b == 0xF5:
                return True, i + 1
            if b == 0xF6:
                return None, i + 1
            if b == 0xFB:
                return struct.unpack(">d", data[i + 1:i + 9])[0], i + 9
            raise ValueError(f"unsupported CBOR simple/float byte {b:#x}")
        arg, i = self._arg(data, i)
        if major == 0:
            return arg, i
        if major == 1:
            return -1 - arg, i
        if major in (2, 3):
            if i + arg > len(data):
                raise ValueError("truncated CBOR input")
            chunk = data[i:i + arg]
            return (chunk if major == 2 else chunk.decode()), i + arg
        if major == 4:
            out = []
            for _ in range(arg):
                v, i = self._dec(data, i)
                out.append(v)
            return out, i
        if major == 5:
            d = {}
            for _ in range(arg):
                k, i = self._dec(data, i)
                v, i = self._dec(data, i)
                d[k] = v
            return d, i
        raise ValueError(f"unsupported CBOR major type {major}")


DEFAULT_CODEC = JsonCodec()

_REGISTRY = {
    c.name: c
    for c in [
        JsonCodec(), PickleCodec(), StringCodec(), BytesCodec(), LongCodec(),
        DoubleCodec(), ZlibCodec(), Bz2Codec(), LzmaCodec(), CborCodec(),
    ]
}
if MsgPackCodec is not None:
    _REGISTRY["msgpack"] = MsgPackCodec()


def by_name(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown codec '{name}' (have {sorted(_REGISTRY)})") from None


# -- object references (RedissonReference analog) -----------------------------

_RREF_MAGIC = b"\x00RREF1\x00"
_RREF_MODULE_PREFIX = WIRE_ROOT + ".client.objects."


class ObjectRef:
    """Inert descriptor decoded where no engine is available (e.g. a pickled
    codec shipped to a worker process): identifies the referenced object
    without binding a live handle."""

    __slots__ = ("module", "cls", "name", "codec")

    def __init__(self, module: str, cls: str, name: str, codec: str):
        self.module, self.cls, self.name, self.codec = module, cls, name, codec

    def __repr__(self):
        return f"ObjectRef({self.cls}:{self.name})"

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and (
            (self.module, self.cls, self.name) == (other.module, other.cls, other.name)
        )

    def __hash__(self):
        return hash((self.module, self.cls, self.name))


def _codec_spec(codec) -> object:
    """Serialize a codec as a rebuildable spec: class name + nested inner
    chain (compression wrappers).  Codecs whose configuration a spec cannot
    carry (CompositeCodec's two halves, parameterized codecs) rebuild as
    None -> the handle falls back to the default codec."""
    if codec is None:
        return None
    spec: dict = {"cls": type(codec).__name__}
    inner = getattr(codec, "inner", None)
    if isinstance(inner, Codec):
        spec["inner"] = _codec_spec(inner)
    return spec


def _codec_from_spec(spec) -> "Codec | None":
    if not isinstance(spec, dict):
        return None
    cls = globals().get(spec.get("cls", ""))
    if not (isinstance(cls, type) and issubclass(cls, Codec)):
        return None
    if cls is ReferenceCodec:  # never nested on purpose; unwrap defensively
        return _codec_from_spec(spec.get("inner"))
    inner = _codec_from_spec(spec.get("inner")) if spec.get("inner") else None
    try:
        return cls(inner) if inner is not None else cls()
    except TypeError:
        return None  # constructor needs config a spec can't carry


def _is_ref(data) -> bool:
    """Magic-prefix test without copying the (possibly large) payload.
    Non-bytes inputs (counter records store raw ints; codecs pass them
    through) are never references."""
    if type(data) is bytes:
        return data.startswith(_RREF_MAGIC)
    if not isinstance(data, (bytearray, memoryview)):
        return False
    return bytes(data[: len(_RREF_MAGIC)]) == _RREF_MAGIC


class ReferenceCodec(Codec):
    """RedissonReference support (liveobject/core/RedissonObjectBuilder.java,
    RedissonReference.java): storing an RObject handle INSIDE another object
    persists a typed reference — module/class/name/codec — not a serialized
    copy of its state; reading it back yields a LIVE handle bound to the same
    engine.  Every handle's codec is wrapped with this at construction
    (client/objects/base.py), so references work uniformly across maps,
    buckets, queues, and nested combinations.

    Non-handle values pass straight through to the inner codec; the magic
    prefix contains a NUL so neither JSON nor pickle output can collide with
    it (a raw BytesCodec payload theoretically could — same caveat class as
    the reference's codec-specific reference handling)."""

    name = "reference"

    def __init__(self, inner: Codec, engine=None):
        from redisson_tpu_torch.client.objects.base import RObject

        self.inner = inner
        self._engine = engine
        # bound once: a map's put_all tests every key and value against it
        self._robject = RObject

    def __reduce__(self):
        # engines never cross process boundaries; a shipped codec decodes
        # references as inert ObjectRef descriptors
        return (ReferenceCodec, (self.inner, None))

    def encode(self, value: Any) -> bytes:
        if isinstance(value, self._robject):
            cls = type(value)
            inner = getattr(value, "_codec", None)
            if isinstance(inner, ReferenceCodec):
                inner = inner.inner
            payload = {
                # the reference's module path: a persisted format
                "m": wire_module(cls.__module__) or cls.__module__,
                "c": cls.__name__,
                # LOGICAL name: the decode path rebuilds through a factory
                # whose ctor re-applies the NameMapper (a stored key here
                # would double-map)
                "n": value._unmap_name(value._name),
                "codec": _codec_spec(inner),
            }
            return _RREF_MAGIC + json.dumps(payload).encode()
        return self.inner.encode(value)

    def decode(self, data: bytes) -> Any:
        if not _is_ref(data):
            return self.inner.decode(data)
        payload = json.loads(bytes(data)[len(_RREF_MAGIC) :])
        if self._engine is None:
            return ObjectRef(payload["m"], payload["c"], payload["n"], payload["codec"])
        # forged/foreign payloads must fail LOUDLY even when they would
        # otherwise fall into the inert-descriptor path below
        _validate_ref_module(payload["m"])
        if payload.get("codec") is not None and _codec_from_spec(payload["codec"]) is None:
            # recorded codec is unrebuildable from its spec (CompositeCodec
            # halves, parameterized codecs): a live handle would silently
            # decode with the DEFAULT codec — stay an inert descriptor, the
            # same contract as remote resolve_ref
            return ObjectRef(payload["m"], payload["c"], payload["n"], payload["codec"])
        return _build_handle(self._engine, payload)

    # references are opaque to map key/value splitting
    def encode_map_key(self, value: Any) -> bytes:
        if isinstance(value, self._robject):
            return self.encode(value)
        return self.inner.encode_map_key(value)

    def decode_map_key(self, data: bytes) -> Any:
        if _is_ref(data):
            return self.decode(data)
        return self.inner.decode_map_key(data)

    def encode_map_value(self, value: Any) -> bytes:
        if isinstance(value, self._robject):
            return self.encode(value)
        return self.inner.encode_map_value(value)

    def decode_map_value(self, data: bytes) -> Any:
        if _is_ref(data):
            return self.decode(data)
        return self.inner.decode_map_value(data)

    def decode_map_values(self, datas: list) -> list:
        # one C-level pass finds whether any value is a reference; a record
        # that is not bytes (a raw int, a bytearray) takes the per-value path
        try:
            plain = not any(map(bytes.startswith, datas, repeat(_RREF_MAGIC)))
        except TypeError:
            plain = False
        if plain:
            return self.inner.decode_map_values(datas)
        return super().decode_map_values(datas)


def _validate_ref_module(module) -> None:
    """Import safety: only classes under the reference's
    ``redisson_tpu.client.objects`` path resolve, each to this package's
    module of the same path (a stored blob must never become an arbitrary
    import gadget)."""
    if not str(module).startswith(_RREF_MODULE_PREFIX):
        raise ValueError(f"reference to non-object module '{module}'")


def _build_handle(engine, payload: dict):
    """Rebuild a live handle from a reference payload.

    Import safety: see _validate_ref_module; additionally the class must be
    an RObject subclass."""
    import importlib

    from redisson_tpu_torch.client.objects.base import RObject

    module = payload["m"]
    _validate_ref_module(module)
    port_module = PORT_ROOT + module[len(WIRE_ROOT):]
    try:
        cls = getattr(importlib.import_module(port_module), payload["c"], None)
    except ImportError:
        cls = None
    if cls is None or not (isinstance(cls, type) and issubclass(cls, RObject)):
        raise ValueError(f"reference to unknown object class '{payload['c']}'")
    codec = _codec_from_spec(payload.get("codec"))
    return cls(engine, payload["n"], codec)
