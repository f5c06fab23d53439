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
