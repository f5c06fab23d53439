"""Codecs: value <-> bytes at the object-handle boundary.

Sketch objects feed the encoded bytes of non-integer keys to the hash, so a
codec's output is part of what a bloom plane or HLL bank means: these are
byte-for-byte copies of the codecs in ``redisson_tpu/client/codec.py``.
The default is JSON with a pickle fallback for values JSON cannot express.
Maps encode keys and values through the map split points, as the
reference's do.  Compression, composite and reference codecs belong to
later slices.
"""
from __future__ import annotations

import json
import pickle
import struct
from typing import Any


class Codec:
    """Encoder/decoder pair. Subclasses must be stateless & thread-safe."""

    name = "codec"

    def encode(self, value: Any) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes) -> Any:
        raise NotImplementedError

    # map key/value split points (a composite codec overrides them)
    def encode_map_key(self, value: Any) -> bytes:
        return self.encode(value)

    def decode_map_key(self, data: bytes) -> Any:
        return self.decode(data)

    def encode_map_value(self, value: Any) -> bytes:
        return self.encode(value)

    def decode_map_value(self, data: bytes) -> Any:
        return self.decode(data)


class JsonCodec(Codec):
    """Default codec: JSON with a one-byte tag; values JSON can't express fall
    back to pickle (tag 'P')."""

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
    """Binary Python-native codec."""

    name = "pickle"

    def encode(self, value: Any) -> bytes:
        return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)

    def decode(self, data: bytes) -> Any:
        return pickle.loads(data)


class StringCodec(Codec):
    """UTF-8 strings."""

    name = "string"

    def encode(self, value: Any) -> bytes:
        if isinstance(value, bytes):
            return value
        return str(value).encode()

    def decode(self, data: bytes) -> Any:
        return data.decode()


class BytesCodec(Codec):
    """Raw bytes passthrough."""

    name = "bytes"

    def encode(self, value: Any) -> bytes:
        if isinstance(value, (bytes, bytearray, memoryview)):
            return bytes(value)
        raise TypeError(f"BytesCodec requires bytes, got {type(value)}")

    def decode(self, data: bytes) -> Any:
        return data


class LongCodec(Codec):
    """Signed 64-bit integers."""

    name = "long"

    def encode(self, value: Any) -> bytes:
        return struct.pack("<q", int(value))

    def decode(self, data: bytes) -> Any:
        return struct.unpack("<q", data)[0]


DEFAULT_CODEC = JsonCodec()
