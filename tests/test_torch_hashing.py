"""The port's hash chain (plain PyTorch, int64 lanes) against the JAX
package's, bit for bit: HASH_VERSION 1 is a persisted format."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu.ops import hll as jhll
from redisson_tpu.utils import hashing as JH
from redisson_tpu_torch.ops import hll as thll
from redisson_tpu_torch.utils import hashing as TH

EDGE_KEYS = [0, 1, -1, 2**63 - 1, -(2**63 - 1), -(2**63), 2**32 - 1, 2**32, 2654435761]


def _t(a):
    """numpy uint32 words -> the port's int32 word tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().astype(np.uint32)


def test_version_matches_reference():
    assert (TH.HASH_VERSION, TH.HASH_NAME) == (JH.HASH_VERSION, JH.HASH_NAME)
    assert (TH.SEED1, TH.SEED2) == (JH.SEED1, JH.SEED2)


@pytest.mark.parametrize("keys", [
    np.array(EDGE_KEYS, np.int64),
    np.random.default_rng(0).integers(-(2**63), 2**63 - 1, 4096, dtype=np.int64),
    np.arange(-300, 300, dtype=np.int64) * 2654435761,
], ids=["edge", "random", "strided"])
def test_hash_u64_pair_bit_for_bit(keys):
    lo, hi = JH.int_keys_to_u32_pair(keys)
    j1, j2 = JH.hash_u64_pair(jnp.asarray(lo), jnp.asarray(hi), jnp)
    t1, t2 = TH.hash_u64_pair(_t(lo), _t(hi))
    np.testing.assert_array_equal(_u32(t1), np.asarray(j1))
    np.testing.assert_array_equal(_u32(t2), np.asarray(j2))


@pytest.mark.parametrize("maxlen", [0, 1, 3, 4, 5, 8, 13, 17])
def test_hash_packed_bytes_bit_for_bit(maxlen):
    rng = np.random.default_rng(maxlen)
    keys = [rng.bytes(int(n)) for n in rng.integers(0, maxlen + 1, 200)] + [b"\x00" * maxlen, b""]
    words, nbytes = JH.pack_keys(keys)
    words = np.pad(words, ((0, 3), (0, 0)))  # extra all-zero word rows are masked out
    j1, j2 = JH.hash_packed_bytes(jnp.asarray(words), jnp.asarray(nbytes), jnp)
    t1, t2 = TH.hash_packed_bytes(_t(words), _t(nbytes))
    np.testing.assert_array_equal(_u32(t1), np.asarray(j1))
    np.testing.assert_array_equal(_u32(t2), np.asarray(j2))


def test_hash_packed_bytes_zero_width():
    nbytes = np.array([0, 3, 9], np.uint32)
    words = np.zeros((0, 3), np.uint32)
    j1, j2 = JH.hash_packed_bytes(jnp.asarray(words), jnp.asarray(nbytes), jnp)
    t1, t2 = TH.hash_packed_bytes(_t(words), _t(nbytes))
    np.testing.assert_array_equal(_u32(t1), np.asarray(j1))
    np.testing.assert_array_equal(_u32(t2), np.asarray(j2))


@pytest.mark.parametrize("k,m", [(1, 1024), (7, 96256), (7, 95_850_583), (13, 2**31 - 1025)])
def test_bloom_indexes_bit_for_bit(k, m):
    keys = np.random.default_rng(k).integers(-(2**63), 2**63 - 1, 1000, dtype=np.int64)
    keys[:len(EDGE_KEYS)] = EDGE_KEYS
    lo, hi = JH.int_keys_to_u32_pair(keys)
    j1, j2 = JH.hash_u64_pair(lo, hi, np)
    want = np.asarray(JH.bloom_indexes(jnp.asarray(j1), jnp.asarray(j2), k, m, jnp))
    got = TH.bloom_indexes(*TH.hash_u64_pair(_t(lo), _t(hi)), k, m)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [4, 10, 14, 16])
def test_idx_rho_bit_for_bit(p):
    rng = np.random.default_rng(p)
    h1 = rng.integers(0, 2**32, 2000, dtype=np.uint64).astype(np.uint32)
    # rank covers every clz: h2 = 0 and each power of two and its neighbours
    powers = [np.uint32(1) << np.uint32(s) for s in range(32)]
    h2 = np.concatenate([np.array([0, 2**32 - 1], np.uint32), powers,
                         np.array([x - 1 for x in powers[1:]], np.uint32),
                         rng.integers(0, 2**32, 2000 - 65, dtype=np.uint64).astype(np.uint32)])
    j_idx, j_rho = jhll.idx_rho(jnp.asarray(h1), jnp.asarray(h2), p)
    t_idx, t_rho = thll.idx_rho(TH.lanes(_t(h1)), TH.lanes(_t(h2)), p)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_rho.numpy(), np.asarray(j_rho))
    assert t_rho.dtype == torch.uint8


def test_fmix32_wraps_like_uint32():
    x = np.array([0, 1, 2**31, 2**32 - 1, 0xDEADBEEF, 0x85EBCA6B], np.uint32)
    np.testing.assert_array_equal(_u32(TH.fmix32(TH.lanes(_t(x)))), JH.fmix32(x, np))


@pytest.mark.parametrize("keys", [[], [b""], [b"a", b"abcdefgh", b"xyz"]], ids=["empty", "one", "mixed"])
def test_host_pack_keys_matches(keys):
    for a, b in zip(TH.pack_keys(keys), JH.pack_keys(keys)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_host_int_keys_to_u32_pair_matches():
    keys = np.array(EDGE_KEYS, np.int64)
    for a, b in zip(TH.int_keys_to_u32_pair(keys), JH.int_keys_to_u32_pair(keys)):
        np.testing.assert_array_equal(a, b)
