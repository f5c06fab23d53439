"""The port's RESP codec (redisson_tpu_torch/net/resp.py, its own native
library built from redisson_tpu_torch/native/resp.cpp) against the
reference's (redisson_tpu/net/resp.py): the same bytes from the encoder and
the same values from the parser on the same seeded frames, in RESP2 and
RESP3, through the native codec and through the pure-Python one."""
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from redisson_tpu.net import resp as RR
from redisson_tpu.utils.crc16 import calc_slot
from redisson_tpu_torch.net import _native as TN
from redisson_tpu_torch.net import resp as TR
from redisson_tpu_torch.utils import crc16 as TC

ROOT = Path(__file__).resolve().parent.parent


def _matrix(mod):
    """Every RESP2/RESP3 reply type, pushes, errors, nested arrays and
    blobs of 0 B to 4 MiB, built with `mod`'s RespError and Push."""
    rng = np.random.default_rng(7)
    return [
        None, True, False, 0, 1, -1, 42, -(2**63), 2**63 - 1, 2**70, -(2**70),
        3.5, -0.0, 7.0, float("inf"), float("-inf"), 1e-9, 0.1,
        b"", b"raw", b"embedded\r\nCRLF", b"x" * 5000, bytearray(b"ba"),
        memoryview(b"mv"), "text", "unicode-é中",
        *(rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (1, 255, 65_537, 4 << 20)),
        mod.RespError("ERR something bad"), mod.RespError("MOVED 12 h:1"), mod.RespError(),
        mod.Push([b"message", b"chan", b"payload"]), mod.Push([]),
        mod.Push([b"invalidate", [b"k1", b"k2"]]),
        [], [1, 2, 3], [b"a"] * 64, list(range(100)), [[b"n", [1, [2.5, None]]]],
        [1, True, 3], [b"mixed", 1, None, True, 2.5, "s", mod.RespError("ERR inner")],
        (1, 2), {}, {b"k": 1, b"j": [1, 2]}, {1: {2: {3: b"deep"}}},
        set(), {1, 2, 3}, frozenset([b"a", b"b"]), {b"x", 1},
        [b"bulk-run-%d" % i for i in range(32)] + [b""],
        [None] * 16, [2**70] * 10, [1.25] * 12,
    ]


def _random_value(mod, rng: random.Random, depth: int = 0):
    kinds = ["int", "bigint", "bytes", "str", "float", "none", "bool", "err"]
    if depth < 3:
        kinds += ["list", "intlist", "bulklist", "dict", "set", "push"] * 2
    k = rng.choice(kinds)
    if k == "int":
        return rng.randrange(-2**63, 2**63)
    if k == "bigint":
        return rng.randrange(2**63, 2**80) * rng.choice((1, -1))
    if k == "bytes":
        return bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 40)))
    if k == "str":
        return "".join(chr(rng.randrange(32, 500)) for _ in range(rng.randrange(0, 12)))
    if k == "float":
        return rng.choice([rng.uniform(-1e6, 1e6), float(rng.randrange(-50, 50))])
    if k == "none":
        return None
    if k == "bool":
        return rng.random() < 0.5
    if k == "err":
        return mod.RespError(f"ERR code {rng.randrange(100)}")
    if k == "list":
        return [_random_value(mod, rng, depth + 1) for _ in range(rng.randrange(0, 12))]
    if k == "intlist":
        return [rng.randrange(-2**63, 2**63) for _ in range(rng.randrange(8, 40))]
    if k == "bulklist":
        return [b"m%d" % i for i in range(rng.randrange(8, 40))]
    if k == "dict":
        return {bytes(rng.getrandbits(8) for _ in range(4)): _random_value(mod, rng, depth + 1)
                for _ in range(rng.randrange(0, 6))}
    if k == "set":
        return {rng.randrange(1000) for _ in range(rng.randrange(0, 8))}
    return mod.Push([_random_value(mod, rng, depth + 1) for _ in range(rng.randrange(0, 5))])


def _randoms(mod, n: int = 300):
    rng = random.Random(1234)
    return [_random_value(mod, rng) for _ in range(n)]


def _plain(v):
    """A parsed value with each package's RespError and Push made neutral."""
    if isinstance(v, (RR.Push, TR.Push)):
        return ("push", [_plain(x) for x in v])
    if isinstance(v, (RR.RespError, TR.RespError)):
        return ("error", v.args)
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


COMMANDS = [
    ("PING",), ("SET", b"k", 5), ("X", 3.5, True, 2**80, -(2**63), bytearray(b"zz"), memoryview(b"mm")),
    ("HSET", "h", *sum([[f"f{i}", b"v%d" % i] for i in range(40)], [])),
    ("BF.MADD64", "bf", np.arange(1000, dtype="<i8").tobytes()), ("EMPTY", b""),
]


def test_the_port_loads_its_own_library_from_its_build_dir():
    lib = TN.load()
    assert lib is not None, "g++ builds the library on first use"
    path = TN.library_path()
    assert path.parent == ROOT / "redisson_tpu_torch" / "_build" and path.exists()
    assert TN.SOURCE == ROOT / "redisson_tpu_torch" / "native" / "resp.cpp"
    assert Path(lib._name) == path
    # the source is the reference's library source, byte for byte
    assert TN.SOURCE.read_bytes() == (ROOT / "native" / "resp.cpp").read_bytes()


@pytest.mark.parametrize("proto", [2, 3])
def test_encoder_matches_the_reference(proto):
    for mine, theirs in zip(_matrix(TR), _matrix(RR)):
        want = RR.encode_reply(theirs, proto)
        assert TR.encode_reply(mine, proto) == want, repr(theirs)[:80]
        assert TR.encode_reply_python(mine, proto) == want, repr(theirs)[:80]
    for mine, theirs in zip(_randoms(TR), _randoms(RR)):
        want = RR.encode_reply_python(theirs, proto)
        assert TR.encode_reply(mine, proto) == want
        assert TR.encode_reply_python(mine, proto) == want
    frames = [_randoms(TR, 40), _randoms(RR, 40)]
    assert TR.encode_replies(frames[0], proto) == RR.encode_replies(frames[1], proto)


def test_commands_errors_and_simple_strings_match_the_reference():
    for cmd in COMMANDS:
        want = RR.encode_command(*cmd)
        assert TR.encode_command(*cmd) == want == TR.encode_command_python(*cmd)
    assert TR.encode_commands(COMMANDS) == RR.encode_commands(COMMANDS)
    for msg in ("ERR unknown command 'X'", "WRONGTYPE x", ""):
        assert TR.encode_error(msg) == RR.encode_error(msg)
    assert TR.encode_simple("OK") == RR.encode_simple("OK")


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("proto", [2, 3])
def test_parser_matches_the_reference(proto, use_native):
    values = _matrix(RR) + _randoms(RR, 200)
    stream = b"".join(RR.encode_reply_python(v, proto) for v in values)
    stream += RR.encode_commands(COMMANDS)
    want = [_plain(v) for v in RR.RespParser(use_native=False).feed(stream)]
    # whole, and in ragged chunks of a seeded size
    assert [_plain(v) for v in TR.RespParser(use_native=use_native).feed(stream)] == want
    parser, got, rng, at = TR.RespParser(use_native=use_native), [], random.Random(proto), 0
    while at < len(stream):
        step = rng.choice((1, 7, 64, 1000, 65_536, 1 << 20))
        got += parser.feed(stream[at:at + step])
        at += step
    assert [_plain(v) for v in got] == want and parser.pending_bytes == 0


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_a_small_frame_split_at_every_byte(use_native):
    frame = b"".join(RR.encode_reply_python(v, 3) for v in (
        RR.Push([b"message", b"c", b"p"]), {b"k": [1, 2.5, None]}, b"blob\r\n", -7, True,
        RR.RespError("ERR x"), {1, 2}))
    frame += RR.encode_command("BF.MEXISTS64", "f", np.arange(3, dtype="<i8").tobytes())
    want = [_plain(v) for v in RR.RespParser(use_native=False).feed(frame)]
    for cut in range(len(frame) + 1):
        parser = TR.RespParser(use_native=use_native)
        got = parser.feed(frame[:cut]) + parser.feed(frame[cut:])
        assert [_plain(v) for v in got] == want, cut


def test_protocol_errors_match():
    for bad in (b"?what\r\n", b"$-2\r\n", b"*x\r\n"):
        outcomes = []
        for mod in (RR, TR):
            try:
                outcomes.append(("ok", [_plain(v) for v in mod.RespParser(use_native=False).feed(bad)]))
            except mod.ProtocolError as e:
                outcomes.append(("protocol", str(e)))
        assert outcomes[0] == outcomes[1], bad


def test_calc_slots_match_the_reference():
    keysets = [[b"one-key"], [b"foo", b"bar{tag}baz", b"{user1000}.following", b"", b"{}", b"{x}"],
               [b"k%d" % i for i in range(300)], [b"single{h}"], [b"k%d" % i for i in range(40)]]
    for keys in keysets:
        want = [calc_slot(k) for k in keys]
        assert TR.calc_slots(keys) == want
        assert [TC.calc_slot(k) for k in keys] == want
    assert TR.calc_slots([]) == []


_NO_NATIVE_DRIVER = r"""
import json, random, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from tests import test_torch_resp as T
from redisson_tpu.net import _native as RN, resp as RR
from redisson_tpu_torch.net import _native as TN, resp as TR
assert RN.load() is None and TN.load() is None
same = all(TR.encode_reply(a, p) == RR.encode_reply(b, p)
           for p in (2, 3) for a, b in zip(T._matrix(TR) + T._randoms(TR), T._matrix(RR) + T._randoms(RR)))
stream = b"".join(RR.encode_reply(v, 3) for v in T._randoms(RR, 100))
parsed = [T._plain(v) for v in TR.RespParser().feed(stream)] == [T._plain(v) for v in RR.RespParser().feed(stream)]
print(json.dumps({"encode": same, "parse": parsed,
                  "slots": TR.calc_slots([b"a", b"{b}c"]) == RR.calc_slots([b"a", b"{b}c"])}))
"""


def test_both_codecs_fall_back_to_python_under_the_same_switch():
    env = dict(os.environ, RTPU_NO_NATIVE="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _NO_NATIVE_DRIVER, str(ROOT)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"encode": True, "parse": True, "slots": True}
