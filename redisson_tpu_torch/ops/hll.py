"""Dense HyperLogLog registers as a uint8 tensor, plain PyTorch versions.

Scheme (persisted format, shared with ``redisson_tpu/ops/hll.py``):
p = 14 (m = 16384 registers), register index = h1 & (m-1),
rho = clz32(h2) + 1.  A bank of counters is a (T, m) uint8 tensor.

The estimator works from a 256-bin histogram of register values, the form
the CUDA kernel (``csrc/hll.cu``) uses too, so both compute the same float32
value: the sum of 2**-r is exact (float64 over exact powers of two, rounded
once to float32), and every log is taken in float64 and rounded once to
float32.  The JAX package sums float32 ``exp2(-r)`` terms in its backend's
order with its backend's log; its estimate agrees with this one within the
rounding of those float32 functions.

The contract with the JAX package, held by tests/test_torch_kernels.py:
the float32 estimate agrees to 1e-6 of itself (raw estimate and large-range
correction) and to m * 2**-20 in linear counting, and the PFCOUNT reply is
the estimate rounded, so it differs from the reference's rounded estimate
by at most one more than that tolerance (at p = 14, in no drawn state below
1e5 keys).  Matching the reference bit for bit is not possible: XLA:CPU's
float32 ``exp2`` and ``log`` are not correctly rounded and its summation
order follows no simple rule, and a TPU rounds differently again.
"""
from __future__ import annotations

import torch

DEFAULT_P = 14
NBINS = 256  # every uint8 register value has its bin
_TWO32 = 4294967296.0


def m_of(p: int) -> int:
    return 1 << p


def alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def make(p: int, device) -> torch.Tensor:
    return torch.zeros((m_of(p),), dtype=torch.uint8, device=device)


def make_bank(tenants: int, p: int, device) -> torch.Tensor:
    return torch.zeros((tenants, m_of(p)), dtype=torch.uint8, device=device)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64 lanes in [0, 2**32) as 32-bit words; clz32(0) = 32."""
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        top = x < (1 << (32 - shift))  # the `shift` high bits are all zero
        n = n + torch.where(top, shift, 0)
        x = torch.where(top, x << shift, x)
    return torch.where(x == 0, 32, n)


def idx_rho(h1: torch.Tensor, h2: torch.Tensor, p: int = DEFAULT_P):
    """Register index (int64) and rank (uint8) from a pair of hash lanes."""
    idx = h1 & (m_of(p) - 1)
    rho = (clz32(h2) + 1).to(torch.uint8)
    return idx, rho


def add(regs: torch.Tensor, idx: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """PFADD batch, in place: scatter-max of ranks; idx outside [0, m) dropped."""
    keep = (idx >= 0) & (idx < regs.shape[-1])
    regs.scatter_reduce_(0, idx[keep], rho[keep], reduce="amax")
    return regs


def add_bank(regs: torch.Tensor, tenant: torch.Tensor, idx: torch.Tensor,
             rho: torch.Tensor) -> torch.Tensor:
    """PFADD into a (T, m) bank, in place.  As in the JAX version, a negative
    tenant or index counts from the end once; anything still outside the
    bank is dropped."""
    t_count, m = regs.shape
    tenant = torch.where(tenant < 0, tenant + t_count, tenant)
    idx = torch.where(idx < 0, idx + m, idx)
    keep = (tenant >= 0) & (tenant < t_count) & (idx >= 0) & (idx < m)
    flat = tenant[keep] * m + idx[keep]
    regs.view(-1).scatter_reduce_(0, flat, rho[keep], reduce="amax")
    return regs


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PFMERGE: register-wise max (a new tensor)."""
    return torch.maximum(a, b)


def histogram(regs: torch.Tensor) -> torch.Tensor:
    """Register-value counts along the last axis: (..., NBINS) int64."""
    counts = torch.zeros(regs.shape[:-1] + (NBINS,), dtype=torch.int64, device=regs.device)
    return counts.scatter_add_(-1, regs.to(torch.int64), torch.ones_like(regs, dtype=torch.int64))


def _log32(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float()


def estimate_from_histogram(counts: torch.Tensor, m: int) -> torch.Tensor:
    """float32 cardinality estimate per histogram row (see module note)."""
    weights = torch.tensor([2.0 ** -r for r in range(NBINS)], dtype=torch.float64,
                           device=counts.device)
    inv = (counts.double() * weights).sum(dim=-1).float()
    e = torch.tensor(alpha(m) * m * m, dtype=torch.float32, device=counts.device) / inv
    zeros = counts[..., 0].float()
    m32 = torch.full_like(zeros, float(m))
    lin = m32 * (_log32(m32) - _log32(torch.clamp(zeros, min=1.0)))
    e = torch.where(e <= 2.5 * m, torch.where(zeros > 0, lin, e), e)
    large = -_TWO32 * torch.log1p((-e / _TWO32).double()).float()
    return torch.where(e > torch.tensor(_TWO32 / 30.0, dtype=torch.float32), large, e)


def estimate(regs: torch.Tensor) -> torch.Tensor:
    """PFCOUNT on the trailing register axis -> float32 estimate(s)."""
    return estimate_from_histogram(histogram(regs), regs.shape[-1])


def estimate_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return estimate(torch.maximum(a, b))
