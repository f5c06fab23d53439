"""The port's flagship fused step (``redisson_tpu_torch.graft_entry``, K10)
against ``__graft_entry__._fused_step_factory`` run by JAX on the CPU, on
the same numpy inputs made from a seed.

``found``, the bloom plane and the HLL registers must be equal bit for bit:
at small shapes over two consecutive steps (in-batch duplicate keys, rows
past ``n_valid``, tenants wrapping from the end and past the last row), and
once at ``entry()``'s own shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from redisson_tpu_torch import graft_entry as G
from redisson_tpu_torch.core import kernels as TK

# small shapes: 4 tenants, m 2**12, p 10, 256 lanes
SMALL = dict(k=7, m=1 << 12, p=10, tenants=4)
SMALL_B, SMALL_VALID = 256, 229


def _ref_step(k, m, p, tenants):
    return jax.jit(ref_entry._fused_step_factory(k, m, p, tenants))


def _batch(rng, b, tenants, dup_from=None):
    """(tenant int32, lo uint32, hi uint32): a quarter of the lanes repeat
    an earlier lane of the batch, and a few repeat `dup_from`'s keys."""
    tenant = rng.integers(0, tenants, b).astype(np.int32)
    lo = rng.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32)
    src = rng.integers(0, b // 2, b // 4)
    dst = rng.integers(b // 2, b, b // 4)
    tenant[dst], lo[dst], hi[dst] = tenant[src], lo[src], hi[src]
    if dup_from is not None:
        t0, l0, h0 = dup_from
        tenant[:16], lo[:16], hi[:16] = t0[:16], l0[:16], h0[:16]
    return tenant, lo, hi


def _port(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def _assert_step_equal(got, want):
    found, bits, regs = got
    want_found, want_bits, want_regs = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(found.numpy(), want_found)
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    np.testing.assert_array_equal(regs.numpy(), want_regs)


def test_small_steps_match_the_reference_with_duplicates_and_masked_rows():
    k, m, p, tenants = SMALL["k"], SMALL["m"], SMALL["p"], SMALL["tenants"]
    ref = _ref_step(k, m, p, tenants)
    step = G.fused_step_factory(k, m, p, tenants)
    rng = np.random.default_rng(2024)
    bits = torch.zeros((tenants, m), dtype=torch.uint8)
    regs = torch.zeros((tenants, 1 << p), dtype=torch.uint8)
    jbits = jnp.zeros((tenants, m), jnp.uint8)
    jregs = jnp.zeros((tenants, 1 << p), jnp.uint8)
    first, founds = None, []
    for n_valid in (SMALL_VALID, SMALL_B - 3):
        tenant, lo, hi = _batch(rng, SMALL_B, tenants, dup_from=first)
        # tenants that wrap from the end and that lie past the last row
        tenant[SMALL_B // 2:SMALL_B // 2 + 4] = (-1, -tenants, tenants, tenants + 2)
        want = ref(jbits, jregs, jnp.asarray(tenant), jnp.asarray(lo), jnp.asarray(hi),
                   jnp.int32(n_valid))
        got = step(bits, regs, _port(tenant), _port(lo), _port(hi), n_valid)
        _assert_step_equal(got, want)
        assert got[1] is bits and got[2] is regs  # state updated in place
        jbits, jregs = want[1], want[2]
        first = (tenant, lo, hi)
        founds.append((got[0].numpy().copy(), n_valid, tenant))
    # on the empty plane only the valid lanes past the last row (read as
    # set) are found: in-batch duplicates are found by neither lane
    found0, valid0, tenant0 = founds[0]
    want0 = (tenant0 >= tenants) & (np.arange(SMALL_B) < valid0)
    assert want0.sum() == 2
    np.testing.assert_array_equal(found0, want0)
    # the second batch re-sends 16 valid keys of the first: all found
    assert founds[1][0][:16].all()
    assert not founds[1][0][founds[1][1]:].any()


def test_uint32_operands_and_the_plain_route_make_no_launches():
    k, m, p, tenants = SMALL["k"], SMALL["m"], SMALL["p"], SMALL["tenants"]
    rng = np.random.default_rng(5)
    tenant, lo, hi = _batch(rng, SMALL_B, tenants)
    a = G.fused_step(torch.zeros((tenants, m), dtype=torch.uint8),
                     torch.zeros((tenants, 1 << p), dtype=torch.uint8),
                     _port(tenant), _port(lo), _port(hi), SMALL_VALID, k)
    TK.reset_launches()
    b = G.fused_step(torch.zeros((tenants, m), dtype=torch.uint8),
                     torch.zeros((tenants, 1 << p), dtype=torch.uint8),
                     torch.from_numpy(tenant), torch.from_numpy(lo.copy()),
                     torch.from_numpy(hi.copy()), torch.tensor(SMALL_VALID), k)
    assert sum(TK.launches.values()) == 0  # the CPU runs the plain versions
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_entry_shape_matches_the_reference():
    ref_fn, ref_args = ref_entry.entry()
    step, args = G.entry(device="cpu")
    assert args[0].shape == (G.ENTRY_TENANTS, G.ENTRY_M) and args[5] == 3996
    np.testing.assert_array_equal(args[2].numpy(), np.asarray(ref_args[2]))
    np.testing.assert_array_equal(args[3].numpy().view(np.uint32), np.asarray(ref_args[3]))
    want = jax.jit(ref_fn)(*ref_args)
    _assert_step_equal(step(*args), want)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        G.entry()


def test_step_rejects_a_plane_of_another_geometry():
    step = G.fused_step_factory(**SMALL)
    with pytest.raises(ValueError, match="plane"):
        step(torch.zeros((2, 64), dtype=torch.uint8), torch.zeros((4, 1024), dtype=torch.uint8),
             torch.zeros(32, dtype=torch.int32), torch.zeros(32, dtype=torch.int32),
             torch.zeros(32, dtype=torch.int32), 32)
