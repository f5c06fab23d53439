"""The port's codecs (``redisson_tpu_torch/client/codec.py``,
``utils/lz4block.py``) against the reference's, on a seeded corpus.

Every codec must write the reference's bytes, and each package must decode
the other's.  The LZ4 block codec's native path and its ``RTPU_NO_NATIVE``
path (the pure-Python one) must agree with each other and with the
reference's.  A bloom filter and an HLL fed keys through each codec must
give the reference's plane and registers on the CPU, and a map value
holding a handle must be stored as the reference's bytes and read back as a
live handle of the port.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.client import codec as RC
from redisson_tpu.utils import lz4block as RL
from redisson_tpu_torch import state
from redisson_tpu_torch.client import codec as TC
from redisson_tpu_torch.utils import lz4block as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(seed: int = 7, n: int = 24) -> list:
    """JSON-, CBOR- and pickle-friendly values: strings (ASCII and not),
    ints across the uint64 range, floats, bytes, nested lists and dicts."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        word = "".join(chr(c) for c in rng.integers(97, 123, rng.integers(1, 40)))
        out += [
            word,
            word + " värde ✓" * int(rng.integers(0, 3)),
            int(rng.integers(-(1 << 62), 1 << 62)) * int(rng.integers(1, 3)),
            float(rng.normal() * 10.0 ** int(rng.integers(-5, 6))),
            {"k": word, "n": [int(x) for x in rng.integers(0, 1000, 5)], "f": float(i) / 7,
             "nested": {"b": bool(i % 2), "z": None}},
            [word] * int(rng.integers(1, 60)),
        ]
    return out


def _bytes_corpus(seed: int = 9, n: int = 24) -> list:
    rng = np.random.default_rng(seed)
    out = [b"", b"\x00", bytes(range(256)) * 3]
    for _ in range(n):
        raw = rng.integers(0, 256, int(rng.integers(1, 300))).astype(np.uint8).tobytes()
        out += [raw, raw * int(rng.integers(2, 40))]
    return out


# (id, reference codec, port codec, the values it takes)
def _cases():
    corpus, raw = _corpus(), _bytes_corpus()
    strings = [v for v in corpus if isinstance(v, str)]
    ints = [v for v in corpus if isinstance(v, int) and not isinstance(v, bool)]
    floats = [v for v in corpus if isinstance(v, float)] + [float(v) for v in ints[:5]]
    pick = [tuple(v) if isinstance(v, list) else v for v in corpus] + [frozenset({1, 2})]
    cases = [
        ("json", RC.JsonCodec(), TC.JsonCodec(), corpus),
        ("pickle", RC.PickleCodec(), TC.PickleCodec(), pick),
        ("string", RC.StringCodec(), TC.StringCodec(), strings),
        ("bytes", RC.BytesCodec(), TC.BytesCodec(), raw),
        ("long", RC.LongCodec(), TC.LongCodec(), ints),
        ("double", RC.DoubleCodec(), TC.DoubleCodec(), floats),
        ("composite", RC.CompositeCodec(RC.StringCodec(), RC.PickleCodec()),
         TC.CompositeCodec(TC.StringCodec(), TC.PickleCodec()), pick),
        ("zlib", RC.ZlibCodec(), TC.ZlibCodec(), corpus),
        ("zlib-string-6", RC.ZlibCodec(RC.StringCodec(), 6), TC.ZlibCodec(TC.StringCodec(), 6), strings),
        ("bz2", RC.Bz2Codec(), TC.Bz2Codec(), corpus),
        ("lzma", RC.LzmaCodec(), TC.LzmaCodec(), corpus),
        ("lz4", RC.Lz4Codec(), TC.Lz4Codec(), corpus),
        ("lz4-bytes", RC.Lz4Codec(RC.BytesCodec()), TC.Lz4Codec(TC.BytesCodec()), raw),
        ("cbor", RC.CborCodec(), TC.CborCodec(), corpus + raw),
    ]
    if RC.MsgPackCodec is not None and TC.MsgPackCodec is not None:
        cases.append(("msgpack", RC.MsgPackCodec(), TC.MsgPackCodec(), corpus))
    try:
        from google.protobuf import wrappers_pb2
    except ImportError:
        pass
    else:
        msgs = [wrappers_pb2.StringValue(value=s) for s in strings]
        cases.append(("protobuf", RC.ProtobufCodec(wrappers_pb2.StringValue),
                      TC.ProtobufCodec(wrappers_pb2.StringValue), msgs))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name,ref,port,values", CASES, ids=[c[0] for c in CASES])
def test_codec_bytes_equal_the_reference_and_decode_both_ways(name, ref, port, values):
    for v in values:
        blob = port.encode(v)
        assert blob == ref.encode(v), (name, v)
        assert ref.decode(blob) == v
        assert port.decode(ref.encode(v)) == v
        for enc in ("encode_map_key", "encode_map_value"):
            assert getattr(port, enc)(v) == getattr(ref, enc)(v)
        assert port.decode_map_value(ref.encode_map_value(v)) == v


def test_registry_names_the_same_codecs():
    assert sorted(TC._REGISTRY) == sorted(RC._REGISTRY)
    for name in RC._REGISTRY:
        assert type(TC.by_name(name)).__name__ == type(RC.by_name(name)).__name__
    with pytest.raises(ValueError, match="unknown codec"):
        TC.by_name("nope")


def test_lz4_frames_of_the_old_byte_order_still_decode():
    """The reference reads a frame whose length was written little-endian
    (an older format): the port does too, and a corrupt frame raises the
    big-endian error."""
    raw = RC.JsonCodec().encode({"a": "b" * 300})
    block = RL.compress(raw)
    old = len(raw).to_bytes(4, "little") + block
    assert TC.Lz4Codec().decode(old) == RC.Lz4Codec().decode(old)
    with pytest.raises(ValueError):
        TC.Lz4Codec().decode(len(raw).to_bytes(4, "big") + block[:-2])


def test_lz4_native_and_python_paths_agree_with_the_reference():
    """Both of the port's paths write the reference's native bytes (what the
    reference stores when its library loads).  The reference's Python
    fallback keys an exact dict and can pick other chance matches in
    incompressible input: its frames decode here, byte for byte."""
    rng = np.random.default_rng(19)
    datas = _bytes_corpus(11) + [s.encode() for s in _corpus(13) if isinstance(s, str)]
    datas += [b"a" * 100_000, b"x" * 14 + b"y"]
    datas += [rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes() for _ in range(24)]
    native = TL._lib()
    assert native is not None, "the host library builds with g++ on this box"
    for d in datas:
        packed = TL.compress(d)
        assert packed == TL.compress_python(d) == RL.compress(d)
        assert TL.decompress(packed, len(d)) == TL.decompress_python(packed, len(d)) == d
        assert RL.decompress(packed, len(d)) == RL.decompress_python(packed, len(d)) == d
        theirs = RL.compress_python(d)
        assert TL.decompress(theirs, len(d)) == TL.decompress_python(theirs, len(d)) == d
    with pytest.raises(ValueError):
        TL.decompress(TL.compress(b"hello " * 50)[:-3], 300)
    with pytest.raises(ValueError):
        TL.decompress_python(b"\x01\x41\x09\x00\xff\xff", 100)


def test_lz4_no_native_process_matches_the_native_bytes():
    """RTPU_NO_NATIVE=1 in a fresh interpreter: the codec takes the Python
    path and writes the same frames."""
    data = [s for s in _corpus(17) if isinstance(s, str)]
    code = (
        "import sys, json\n"
        "from redisson_tpu_torch.utils import lz4block as L\n"
        "from redisson_tpu_torch.client.codec import Lz4Codec\n"
        "assert L._lib() is None\n"
        "vals = json.loads(sys.stdin.read())\n"
        "sys.stdout.write(json.dumps([Lz4Codec().encode(v).hex() for v in vals]))\n"
    )
    import json

    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    env = {**os.environ, "RTPU_NO_NATIVE": "1", "PYTHONPATH": path}
    out = subprocess.run([sys.executable, "-c", code], input=json.dumps(data), env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert [bytes.fromhex(h) for h in json.loads(out.stdout)] == [TC.Lz4Codec().encode(v) for v in data]


# -- sketches fed through each codec ---------------------------------------------


SKETCH_CODECS = [c for c in CASES if c[0] not in ("bytes", "lz4-bytes", "long", "double", "protobuf")]


@pytest.fixture(scope="module")
def clients():
    j = redisson_tpu.create()
    t = redisson_tpu_torch.create(device="cpu")
    yield j, t
    j.shutdown()
    t.shutdown()


def _state(client, name):
    rec = client.engine.store.get(name)
    if isinstance(client, redisson_tpu.client.redisson.RedissonTpu):
        return rec.kind, dict(rec.meta), {k: np.asarray(v) for k, v in rec.arrays.items()}, rec.host
    return state.to_reference(rec)


def _same_state(j, t, name):
    jk, jm, ja, jh = _state(j, name)
    tk, tm, ta, th = _state(t, name)
    assert (jk, jm, jh) == (tk, tm, th)
    assert ja.keys() == ta.keys()
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k])


@pytest.mark.parametrize("name,ref,port,values", SKETCH_CODECS, ids=[c[0] for c in SKETCH_CODECS])
def test_sketches_fed_through_each_codec_match_the_reference(clients, name, ref, port, values):
    j, t = clients
    # one key kind a batch: strings (encoded by the codec), then bytes (hashed
    # as they are, in both packages)
    keys = [v for v in values if isinstance(v, str)] or [repr(v) for v in values]
    raw = [b"raw-%d" % i for i in range(16)]
    for client, codec in ((j, ref), (t, port)):
        bf = client.get_bloom_filter(f"codec:bf:{name}", codec)
        assert bf.try_init(5000, 0.01)
        bf.add_all(keys[: len(keys) // 2])
        for key in keys[len(keys) // 2:]:
            bf.add(key)
        bf.add_all(raw)
        hll = client.get_hyper_log_log(f"codec:hll:{name}", codec)
        hll.add_all(keys)
        hll.add_all(raw)
    _same_state(j, t, f"codec:bf:{name}")
    _same_state(j, t, f"codec:hll:{name}")
    jbf, tbf = j.get_bloom_filter(f"codec:bf:{name}", ref), t.get_bloom_filter(f"codec:bf:{name}", port)
    probe = keys + ["absent-%d" % i for i in range(50)]
    assert [jbf.contains(k) for k in probe] == [tbf.contains(k) for k in probe]
    assert j.get_hyper_log_log(f"codec:hll:{name}", ref).count() == \
        t.get_hyper_log_log(f"codec:hll:{name}", port).count()


# -- references ----------------------------------------------------------------


def test_map_value_holding_a_handle_stores_the_reference_bytes(clients):
    j, t = clients
    for client in (j, t):
        inner = client.get_list("codec:ref:inner", TC.StringCodec() if client is t else RC.StringCodec())
        inner.add("x")
        outer = client.get_map("codec:ref:outer")
        outer.put("l", inner)
        outer.put("plain", {"v": 1})
        client.get_bucket("codec:ref:slot").set(client.get_atomic_long("codec:ref:ctr"))
    _same_state(j, t, "codec:ref:outer")
    _same_state(j, t, "codec:ref:slot")
    raw = t.engine.store.get("codec:ref:outer").host
    payload = [v for v in raw.values() if v.startswith(TC._RREF_MAGIC)][0]
    assert b'"m": "redisson_tpu.client.objects.list"' in payload
    got = t.get_map("codec:ref:outer").get("l")
    assert type(got).__module__ == "redisson_tpu_torch.client.objects.list"
    assert got.read_all() == ["x"] and type(got._codec.inner) is TC.StringCodec
    # the entries the reference stored read back through the port's codec:
    # the handle as a live port handle, the plain value as itself
    port_codec = t.get_map("codec:ref:outer")._codec
    back = {port_codec.decode_map_key(k): port_codec.decode_map_value(v)
            for k, v in j.engine.store.get("codec:ref:outer").host.items()}
    assert back["plain"] == {"v": 1}
    assert type(back["l"]).__module__ == "redisson_tpu_torch.client.objects.list"
    assert back["l"].name == "codec:ref:inner" and back["l"].read_all() == ["x"]
    ctr = t.get_bucket("codec:ref:slot").get()
    assert type(ctr).__name__ == "AtomicLong" and ctr.increment_and_get() == 1


def test_bulk_value_read_decodes_as_the_per_value_read(clients):
    """A map's whole-value read (decode_map_values) gives what
    decode_map_value gives value by value: plain values, references (live
    handles), and records that are not bytes."""
    _j, t = clients
    for inner in (TC.StringCodec(), TC.JsonCodec(), TC.Lz4Codec(TC.StringCodec())):
        m = t.get_map(f"codec:bulk:{inner.name}", inner)
        m.put_all({f"k{i}": f"v{i}" for i in range(20)})
        codec = m._codec
        datas = list(t.engine.store.get(m.name).host.values())
        want = [codec.decode_map_value(d) for d in datas]
        assert codec.decode_map_values(datas) == want == m.read_all_values()
        m.put("h", t.get_list("codec:bulk:inner"))
        got = m.read_all_values()
        assert len(got) == 21 and type(got[-1]).__module__ == "redisson_tpu_torch.client.objects.list"
        assert got[:-1] == want
    codec = t.get_map("codec:bulk:raw", TC.BytesCodec())._codec
    datas = [b"a", bytearray(b"b"), 7, codec.encode_map_value(t.get_list("codec:bulk:inner"))]
    got = codec.decode_map_values(datas)
    assert got[:3] == [b"a", bytearray(b"b"), 7] and got[3].name == "codec:bulk:inner"


def test_handles_pickle_as_the_reference_object_ref(clients):
    import pickle

    from redisson_tpu_torch.net import safe_pickle

    j, t = clients
    for jh, th in ((j.get_map("codec:p:m"), t.get_map("codec:p:m")),
                   (j.get_list("codec:p:l", RC.Lz4Codec(RC.StringCodec())),
                    t.get_list("codec:p:l", TC.Lz4Codec(TC.StringCodec()))),
                   (j.get_atomic_long("codec:p:a"), t.get_atomic_long("codec:p:a"))):
        assert safe_pickle.dumps(th, protocol=4) == pickle.dumps(jh, protocol=4)
        assert safe_pickle.dumps([th, th], protocol=4) == pickle.dumps([jh, jh], protocol=4)
        ref = safe_pickle.safe_loads(pickle.dumps(jh, protocol=4))
        assert isinstance(ref, TC.ObjectRef)
        assert (ref.module, ref.cls, ref.name) == (type(jh).__module__, type(jh).__name__, jh.name)


def test_reference_from_a_foreign_module_is_refused(clients):
    import json

    _j, t = clients
    codec = t.get_map("codec:sec")._codec
    for module in ("os.path", "redisson_tpu_torch.client.objects.map", "redisson_tpu.core.store"):
        evil = TC._RREF_MAGIC + json.dumps({"m": module, "c": "Map", "n": "x", "codec": None}).encode()
        with pytest.raises(ValueError):
            codec.decode(evil)
    unknown = TC._RREF_MAGIC + json.dumps(
        {"m": "redisson_tpu.client.objects.nothing", "c": "Map", "n": "x", "codec": None}).encode()
    with pytest.raises(ValueError, match="unknown object class"):
        codec.decode(unknown)
