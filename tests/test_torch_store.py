"""The port's DeviceStore against the reference's: keys() and the
get/put/delete_unguarded accessors the vector banks and the search
service's sync read, including expired records."""
import time

import pytest

from redisson_tpu.core import store as RS
from redisson_tpu_torch.core import store as S


def _fill(mod):
    st = mod.DeviceStore()
    for name, kind in (("a:1", "bloom"), ("a:2", "map"), ("b:1", "hll"), ("__ftvec__{i}:emb", "vector_bank")):
        st.put(name, mod.StateRecord(kind=kind))
    st.put("gone", mod.StateRecord(kind="map", expire_at=time.time() - 1.0))
    st.put("later", mod.StateRecord(kind="map", expire_at=time.time() + 3600.0))
    return st


@pytest.mark.parametrize("pattern", [None, "*", "a:*", "?:1", "__ftvec__*", "nomatch", "[ab]:2"])
def test_keys_match_the_reference(pattern):
    want = sorted(_fill(RS).keys(pattern))
    got = sorted(_fill(S).keys(pattern))
    assert got == want
    assert "gone" not in got


def test_unguarded_accessors_match_the_reference():
    out = []
    for mod in (RS, S):
        st = _fill(mod)
        trace = [st.get_unguarded("a:1").kind, st.get_unguarded("missing"), st.get_unguarded("gone"),
                 st.get_unguarded("later").kind]
        st.put_unguarded("new", mod.StateRecord(kind="vector_bank", meta={"rows": 3}))
        trace.append(st.get_unguarded("new").meta)
        trace += [st.delete_unguarded("new"), st.delete_unguarded("new"), st.get_unguarded("new"),
                  st.delete_unguarded("gone"), sorted(st.keys())]
        out.append(trace)
    assert out[1] == out[0]


def test_get_unguarded_drops_an_expired_record():
    st = _fill(S)
    rec = st.get_unguarded("later")
    rec.expire_at = time.time() - 1.0
    assert st.get_unguarded("later") is None
    assert "later" not in st.keys() and not st.delete("later")


def _expiry_trace(mod):
    """__len__, peek, reap_expired and on_expired on the same operations."""
    st = _fill(mod)
    heard = []
    st.on_expired = heard.append
    trace = [len(st), st.peek("a:1"), st.peek("gone"), st.peek("missing"), len(st)]
    st.put("soon", mod.StateRecord(kind="bucket", expire_at=time.time() - 0.5))
    st.put("soon2", mod.StateRecord(kind="bucket", expire_at=time.time() - 0.5))
    trace += [len(st), st.get("soon"), sorted(n for names in heard for n in names)]
    trace += [st.reap_expired(), sorted(n for names in heard for n in names), len(st), st.reap_expired()]
    st.put("late", mod.StateRecord(kind="bucket"))
    st.expire("late", time.time() - 1.0)
    trace += [st.exists("late"), heard[-1], st.delete("missing"), len(st)]
    st.on_expired = lambda names: 1 / 0  # a failing hook never fails the store
    st.put("x", mod.StateRecord(kind="bucket", expire_at=time.time() - 1.0))
    trace += [st.get("x"), st.reap_expired(), len(st)]
    return trace


def test_expiry_and_length_match_the_reference():
    want = _expiry_trace(RS)
    assert _expiry_trace(S) == want
    assert want[:5] == [6, True, False, False, 6]
