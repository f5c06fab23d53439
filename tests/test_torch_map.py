"""The port's Map against the reference's, on the CPU: one op stream through
redisson_tpu.create() and through redisson_tpu_torch.create(device="cpu"),
every reply and the stored encoded bytes equal; the map codecs' bytes; the
loader and writer SPIs; the record's nonce."""
import numpy as np
import pytest

import redisson_tpu
import redisson_tpu_torch
from redisson_tpu.client import codec as rcodec
from redisson_tpu.client.objects import map as rmap
from redisson_tpu_torch import state
from redisson_tpu_torch.client import codec as tcodec
from redisson_tpu_torch.client.objects import map as tmap


@pytest.fixture()
def clients():
    j = redisson_tpu.create()
    t = redisson_tpu_torch.create(device="cpu")
    yield j, t
    j.shutdown()
    t.shutdown()


CODECS = ["JsonCodec", "StringCodec", "PickleCodec", "BytesCodec", "LongCodec"]
VALUES = {
    "JsonCodec": [0, -1, 2.5, "s", "répé", [1, "a"], {"b": 1, "a": [2]}, None, True, {1, 2}, (3, 4)],
    "StringCodec": ["", "a b", "répé", "x" * 300, 17, 2.5],
    "PickleCodec": [0, "s", b"raw", (1, 2), {"k": [1.5]}, None, frozenset({3})],
    "BytesCodec": [b"", b"\x00\xff", bytearray(b"ab"), memoryview(b"cd")],
    "LongCodec": [0, -1, 2**63 - 1, -(2**63), 7],
}


@pytest.mark.parametrize("name", CODECS)
def test_codec_bytes_equal_the_reference(name):
    r, t = getattr(rcodec, name)(), getattr(tcodec, name)()
    for v in VALUES[name]:
        enc = r.encode(v)
        for fn in ("encode", "encode_map_key", "encode_map_value"):
            assert getattr(t, fn)(v) == getattr(r, fn)(v) == enc
        for fn in ("decode", "decode_map_key", "decode_map_value"):
            assert getattr(t, fn)(enc) == getattr(r, fn)(enc)


def _stream(client, codec):
    """One op stream over a fresh map: the replies, then the stored bytes."""
    m = client.get_map("m", codec=codec)
    out = [m.is_empty(), m.size(), m.get("absent"), m.put("a", 1), m.put("a", 2), m.fast_put("b", 3),
           m.fast_put("b", 4), m.put_if_absent("a", 9), m.put_if_absent("c", 5), m.fast_put_if_absent("c", 6)]
    m.put_all({"d": 7, "e": [1, 2], "f": {"x": 1}, 10: "int key"})
    out += [m.get_all(["a", "b", "zz", 10]), m.contains_key("d"), m.contains_key("zz"), m.contains_value(7),
            m.contains_value(99), m.size(), sorted(map(str, m.read_all_keys())),
            sorted(map(str, m.read_all_values())), sorted(map(str, m.read_all_entry_set())),
            m.remove("d"), m.remove("d"), m.fast_remove("a", "zz", "b"), m.remove_if_equals("c", 6),
            m.remove_if_equals("c", 5), m.replace("e", "E"), m.replace("zz", 1),
            m.replace_if_equals("e", "E", "E2"), m.replace_if_equals("e", "no", "x"),
            m.add_and_get("n", 5), m.add_and_get("n", 2.5),
            m.compute("n", lambda k, old: old * 2), m.compute("gone", lambda k, old: None),
            m.compute_if_absent("p", lambda k: k + "!"), m.compute_if_absent("p", lambda k: "other"),
            m.compute_if_present("p", lambda k, old: old + "?"), m.compute_if_present("zz", lambda k, o: 1),
            m.merge("q", 1, lambda a, b: a + b), m.merge("q", 1, lambda a, b: a + b),
            m.merge("q", 1, lambda a, b: None),
            m.put_if_exists("p", "P"), m.put_if_exists("zz", 1), m.fast_put_if_exists("p", "P2"),
            m.fast_replace("p", "P3"), m.fast_replace("zz", 0),
            sorted(map(str, m.key_set_by_pattern("*"))), sorted(map(str, m.values_by_pattern("p*"))),
            sorted(map(str, m.entry_set_by_pattern("?"))), m.value_size("p"), m.value_size("zz"),
            sorted(map(str, m.key_iterator(pattern="e*"))), len(list(m.entry_iterator())),
            len(m.random_keys(3)), len(m.random_entries(2)), "p" in m, len(m), m["p"]]
    with pytest.raises(KeyError):
        m["zz"]
    m["r"] = "set"
    out.append(m.get("r"))
    with pytest.raises(TypeError):
        m.add_and_get("r", 1)
    stored = dict(client.engine.store.get("m").host)
    m.clear()
    out += [m.size(), m.is_exists(), m.delete(), m.is_exists(), m.size(), m.get("r")]
    return out, stored


class Recorder:
    def __init__(self):
        self.log = []

    def write(self, entries):
        self.log.append(("write", dict(entries)))

    def delete(self, keys):
        self.log.append(("delete", list(keys)))

    def load(self, key):
        return None if key == "zz" else f"loaded-{key}"

    def load_all_keys(self):
        return ["l1", "l2", "a"]


@pytest.mark.parametrize("codec", ["JsonCodec", "PickleCodec"])
def test_map_stream_replies_and_bytes_equal_the_reference(clients, codec):
    j, t = clients
    ref = _stream(j, getattr(rcodec, codec)())
    got = _stream(t, getattr(tcodec, codec)())
    assert got[0] == ref[0]
    assert got[1] == ref[1]


def test_string_map_replies_and_bytes_equal_the_reference(clients):
    j, t = clients
    assert _string_stream(t, tcodec.StringCodec()) == _string_stream(j, rcodec.StringCodec())


def _string_stream(client, codec):
    """StringCodec holds text: the numeric ops do not apply."""
    m = client.get_map("s", codec=codec)
    out = [m.put("a", "x"), m.put("a", "y"), m.fast_put(1, "one"), m.get_all(["a", "1", 1]),
           m.put_if_absent("b", "z"), m.replace("b", "w"), m.remove("a"), sorted(m.read_all_keys()),
           sorted(m.read_all_values()), m.value_size("b"), m.contains_value("w")]
    m.put_all({f"k{i}": f"v {i}" for i in range(20)})
    out += [m.size(), sorted(m.read_all_entry_set())]
    return out, dict(client.engine.store.get("s").host)


def _spi_stream(client, mod, rec, mode):
    """Read-through loads and write-through (or write-behind, drained by
    flush_write_behind) writes; the replies, the stored bytes, the writer's
    log."""
    m = client.get_map("spi", options=mod.MapOptions(loader=rec, writer=rec, write_mode=mode))
    out = [m.get("x"), m.get("zz"), m.put("a", 1), m.fast_put("b", 2), m.put_if_absent("a", 3)]
    m.put_all({"c": 3, "d": 4})
    out += [m.remove("a"), m.fast_remove("b", "zz"), m.replace("c", 5), m.remove_if_equals("d", 4),
            m.add_and_get("n", 1), m.compute_if_absent("y", lambda k: None), m.read_all_map()]
    m.flush_write_behind()
    return out, dict(client.engine.store.get("spi").host), rec.log


@pytest.mark.parametrize("mode", [rmap.MapOptions.WRITE_THROUGH, rmap.MapOptions.WRITE_BEHIND])
def test_loader_and_writer_equal_the_reference(clients, mode):
    j, t = clients
    ref = _spi_stream(j, rmap, Recorder(), mode)
    got = _spi_stream(t, tmap, Recorder(), mode)
    assert got == ref and got[2]


def test_write_behind_batches_on_a_timer(clients):
    _, t = clients
    rec = Recorder()
    m = t.get_map("wb", options=tmap.MapOptions(writer=rec, write_mode=tmap.MapOptions.WRITE_BEHIND,
                                                write_behind_delay=0.05))
    m.put("a", 1)
    m.put("b", 2)
    m.remove("a")
    import time

    deadline = time.time() + 5
    while not rec.log and time.time() < deadline:
        time.sleep(0.01)
    assert rec.log == [("write", {"b": 2}), ("delete", ["a"])]


def test_load_all_equals_the_reference(clients):
    j, t = clients
    out = []
    for c, mod in ((j, rmap), (t, tmap)):
        m = c.get_map("la", options=mod.MapOptions(loader=Recorder()))
        m.put("a", "kept")
        out.append((m.load_all(), m.read_all_map(), m.load_all(replace_existing=True), m.read_all_map(),
                    c.get_map("none").load_all()))
    assert out[0] == out[1]


def test_map_state_carries_across(clients):
    j, t = clients
    rm = j.get_map("carry")
    rm.put_all({"a": 1, "b": [2]})
    rrec = j.engine.store.get("carry")
    t.engine.store.put("carry", state.from_reference("map", rrec.meta, {}, "cpu", rrec.host))
    m = t.get_map("carry")
    assert m.read_all_map() == rm.read_all_map()
    m.put("c", 3)
    rm.put("c", 3)
    assert state.to_reference(t.engine.store.get("carry"))[3] == j.engine.store.get("carry").host


def test_record_nonce_tells_a_recreated_map_apart(clients):
    _, t = clients
    m = t.get_map("n")
    m.put("a", 1)
    rec = t.engine.store.get("n")
    first = (rec.nonce, rec.version)
    m.delete()
    m.put("a", 1)
    rec2 = t.engine.store.get("n")
    assert rec2.version == first[1] and rec2.nonce != first[0]
    assert 0 <= rec2.nonce < 2**63


def test_engine_service_is_one_per_engine(clients):
    _, t = clients
    made = []
    a = t.engine.service("k", lambda: made.append(1) or object())
    assert t.engine.service("k", object) is a and made == [1]
    other = redisson_tpu_torch.create(device="cpu")
    assert other.engine.service("k", object) is not a
    other.shutdown()


def test_map_rename_and_expiry(clients):
    _, t = clients
    m = t.get_map("e")
    m.put("a", 1)
    m.rename("e2")
    assert m.get("a") == 1 and not t.get_map("e").is_exists()
    assert m.expire(100) and 0 < m.remain_time_to_live() <= 100
    m.expire_at(0)
    assert m.size() == 0 and not m.is_exists()
    assert np.isfinite(len(m))
