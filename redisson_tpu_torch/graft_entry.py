"""The flagship fused step (K10): the port's counterpart of
``__graft_entry__.py``'s ``entry()``.

One micro-batch flush of a multi-tenant sketch plane, as
``__graft_entry__._fused_step_factory`` computes it: for each op, in this
order,

  1. ``found``: are all k bloom bits of its key set in its tenant's row of
     the (T, m) plane as it stood *before* the batch (two equal keys in one
     batch are found by neither, unless an earlier batch added them);
  2. the bloom insert of those k bits;
  3. the HLL scatter-max of its rank into its tenant's row of the
     (T, 2**p) register bank.

Ops at or past ``n_valid`` are not found and write nothing.

The step is built from the hand kernels already ported, launched on the
current stream in that order: ``bloom_probe`` (``found``), then
``bloom_set``, or the fused ``bloom_add`` where ``kernels.use_fused_add``
takes it (its own newly flags are not ``found``: ``found`` always comes
from the probe), then ``hll_add``.  State lives where its tensors live: on a
CUDA card every step launches the kernels or raises, on the CPU it runs
their plain versions.  The plane and the bank are updated in place and
returned, so callers keep the reference's ``(found, bits, regs) =
step(bits, regs, ...)`` shape.

The reference indexes the plane two-dimensionally and reads a row outside
it as set (``fill_value=1``) and drops its writes; the kernels index it
flat in int32, which is the same index while ``|tenant| * m < 2**31``
(16 tenants of 2**20 lanes: any tenant below 2,048 in magnitude).

``dryrun_multichip`` is the counterpart of ``__graft_entry__``'s: one
sharded step through the engine path (object handles -> MeshManager -> the
windowed kernels) over a dp 2 x shard 4 mesh of 8 positions, then a live
reshard 4 -> 8 -> 4 under traffic with no probe lost, and the reference's
checkpoint round trip of the sharded records: saved gathered, loaded into a
fresh engine as whole tensors, re-sharded lazily on their next dispatch.
On one card the 8 positions share it: the run holds the
programs and the reshard, not a collective across GPUs.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core.engine import resolve_device
from redisson_tpu_torch.ops import hll as hll_ops

# entry()'s shape: __graft_entry__.entry()'s k, m, p, tenants and batch
ENTRY_K, ENTRY_M, ENTRY_P, ENTRY_TENANTS = 7, 1 << 20, hll_ops.DEFAULT_P, 16
ENTRY_BATCH, ENTRY_PAD = 4096, 100


def _words(t: torch.Tensor) -> torch.Tensor:
    """A key or tenant operand as the int32 words the kernels take."""
    if t.dtype == torch.int32:
        return t.contiguous()
    if t.dtype == torch.uint32:
        return t.contiguous().view(torch.int32)
    raise TypeError(f"key and tenant operands are int32 or uint32, got {t.dtype}")


def fused_step(bloom_bits, hll_regs, tenant, lo, hi, n_valid, k: int = ENTRY_K):
    """One fused step over (T, m) ``bloom_bits`` and (T, 2**p) ``hll_regs``
    (uint8); ``tenant``, ``lo`` and ``hi`` are (B,) int32 or uint32.  The
    plane's width m is the bloom hash domain.  Returns
    ``(found, bloom_bits, hll_regs)``: ``found`` a (B,) bool tensor, the
    state updated in place."""
    if bloom_bits.dim() != 2 or hll_regs.dim() != 2:
        raise ValueError("the plane and the register bank are (tenants, width)")
    if bloom_bits.dtype != torch.uint8 or hll_regs.dtype != torch.uint8:
        raise ValueError("the plane and the register bank are uint8")
    regs_width = hll_regs.shape[1]
    p = regs_width.bit_length() - 1
    if regs_width != 1 << p:
        raise ValueError(f"register rows of {regs_width}: not a power of two")
    m = bloom_bits.shape[1]
    keys = K.Keys(n=lo.shape[0], tenant=_words(tenant), lo=_words(lo), hi=_words(hi))
    n_valid = max(0, min(int(n_valid), keys.n))
    found = K.bloom_probe(bloom_bits, m, keys, n_valid, k, m)
    if K.use_fused_add(bloom_bits.numel(), n_valid, k):
        K.bloom_add_fused(bloom_bits, m, keys, n_valid, k, m)
    else:
        K.bloom_set(bloom_bits, m, keys, n_valid, k, m)
    K.hll_add(hll_regs, regs_width, keys, n_valid, p)
    return found, bloom_bits, hll_regs


def fused_step_factory(k: int, m: int, p: int, tenants: int):
    """The step for one geometry, as ``__graft_entry__._fused_step_factory``
    makes it: the state must be (tenants, m) and (tenants, 2**p)."""

    def step(bloom_bits, hll_regs, tenant, lo, hi, n_valid):
        if tuple(bloom_bits.shape) != (tenants, m):
            raise ValueError(f"plane {tuple(bloom_bits.shape)}, step made for {(tenants, m)}")
        if tuple(hll_regs.shape) != (tenants, hll_ops.m_of(p)):
            raise ValueError(f"bank {tuple(hll_regs.shape)}, step made for {(tenants, hll_ops.m_of(p))}")
        return fused_step(bloom_bits, hll_regs, tenant, lo, hi, n_valid, k)

    return step


def entry(device="cuda"):
    """(step, example_args) at ``__graft_entry__.entry()``'s shape: k 7, m
    2**20, p ``DEFAULT_P``, 16 tenants, 4,096 lanes, ``n_valid`` 3,996.  The
    state lives on the CUDA card unless the caller asks for the CPU; without
    a card this raises."""
    dev = resolve_device(device)
    step = fused_step_factory(ENTRY_K, ENTRY_M, ENTRY_P, ENTRY_TENANTS)
    # drawn as __graft_entry__.entry() draws its own: tenants, then lo, then hi
    rng = np.random.default_rng(0)
    tenant = rng.integers(0, ENTRY_TENANTS, ENTRY_BATCH).astype(np.int32)
    lo, hi = (rng.integers(0, 1 << 32, ENTRY_BATCH).astype(np.uint32).view(np.int32) for _ in range(2))
    return step, (
        torch.zeros((ENTRY_TENANTS, ENTRY_M), dtype=torch.uint8, device=dev),
        torch.zeros((ENTRY_TENANTS, hll_ops.m_of(ENTRY_P)), dtype=torch.uint8, device=dev),
        torch.from_numpy(tenant).to(dev),
        torch.from_numpy(lo).to(dev),
        torch.from_numpy(hi).to(dev),
        ENTRY_BATCH - ENTRY_PAD,
    )


def dryrun_multichip(n_devices: int = 8, device="cuda") -> dict:
    """One sharded step THROUGH THE ENGINE PATH on an n-position mesh: a
    sharded bloom bank (columns over `shard`, ops over `dp`), a sharded
    bit set and a tenant-sharded HLL bank, then a live reshard shard 4 ->
    n -> 4 while a writer adds to the bank: every acknowledged add is found
    after it, and the HLL registers move without changing.  Raises on any
    failure; returns what it saw."""
    import os
    import tempfile
    import threading

    import redisson_tpu_torch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.parallel import mesh as M
    from redisson_tpu_torch.parallel.manager import MeshManager

    cfg = Config()
    cfg.mesh.dp = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    cfg.mesh.shard = n_devices // cfg.mesh.dp
    cfg.mesh.n_devices = n_devices
    client = redisson_tpu_torch.create(cfg, device)
    try:
        mgr = MeshManager.of(client._engine)
        n_shard = mgr.n_shard
        if dict(mgr.mesh.shape) != {M.DP_AXIS: cfg.mesh.dp, M.SHARD_AXIS: n_shard}:
            raise AssertionError(f"mesh {mgr.mesh.shape}, asked dp {cfg.mesh.dp} x shard {cfg.mesh.shard}")
        tenants = 2 * n_shard
        B = 64 * cfg.mesh.dp
        rng = np.random.default_rng(0)
        keys = rng.integers(0, 1 << 60, B).astype(np.int64)
        tenant = (np.arange(B) % tenants).astype(np.int32)

        bf = client.get_sharded_bloom_filter_array("dryrun:bloom")
        if not bf.try_init(tenants, expected_insertions=10_000, false_probability=0.01):
            raise AssertionError("dryrun: bloom bank exists")
        if not bf.add_each(tenant, keys).all():
            raise AssertionError("fresh random keys must all report newly added")
        if not bf.contains_each(tenant, keys).all():
            raise AssertionError("keys just added must all be found")

        bs = client.get_sharded_bit_set("dryrun:bits")
        bs.try_init(1 << 20)
        idxs = rng.integers(0, 1 << 20, 256)
        bs.set_each(idxs)
        if not bs.get_each(idxs).all() or bs.cardinality() != len(np.unique(idxs)):
            raise AssertionError("sharded bit set lost a bit")

        h = client.get_sharded_hll_array("dryrun:hll")
        h.try_init(tenants, p=8)
        h.add_each(tenant, keys)
        ests = h.estimate_all()
        if ests.shape != (tenants,) or not (ests > 0).all():
            raise AssertionError(f"sharded HLL estimates {ests}")

        # checkpoint round trip: gather on save, lazy re-shard on the next
        # dispatch of the fresh engine
        from redisson_tpu_torch.core import checkpoint

        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "dryrun.ckp")
            if checkpoint.save(client._engine, path) < 2:
                raise AssertionError("dryrun: the checkpoint missed a sharded record")
            fresh = redisson_tpu_torch.create(cfg, device)
            try:
                if checkpoint.load(fresh._engine, path) < 2:
                    raise AssertionError("dryrun: the checkpoint load missed a record")
                bf2 = fresh.get_sharded_bloom_filter_array("dryrun:bloom")
                if not bf2.contains_each(tenant, keys).all():
                    raise AssertionError("sharded bloom state lost in the checkpoint")
                if not np.array_equal(fresh.get_sharded_hll_array("dryrun:hll").estimate_all(), ests):
                    raise AssertionError("sharded HLL state changed in the checkpoint")
            finally:
                fresh.shutdown()

        # live resharding under traffic: the dual-routing window is per
        # record (a dispatch in flight finishes on the old geometry under
        # the record lock, later ones adapt the plane)
        dp0, shard0 = cfg.mesh.dp, n_shard
        acked, errs = [], []

        def writer():
            try:
                r2 = np.random.default_rng(7)
                for _ in range(12):
                    ks = r2.integers(0, 1 << 60, 64).astype(np.int64)
                    tn = (np.arange(64) % tenants).astype(np.int32)
                    bf.add_each(tn, ks)
                    acked.append((tn, ks))  # acknowledged once add_each returned
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(e)

        th = threading.Thread(target=writer)
        th.start()
        while len(acked) < 3 and th.is_alive():
            time.sleep(0.01)
        mgr.reshard(dp=1, shard=n_devices)
        while len(acked) < 7 and th.is_alive():
            time.sleep(0.01)
        mgr.reshard(dp=dp0, shard=shard0)
        th.join(timeout=300)
        if th.is_alive():
            raise AssertionError("writer wedged during the reshard")
        if errs:
            raise AssertionError(f"writer failed during the reshard: {errs}")
        lost = sum(int((~bf.contains_each(tn, ks)).sum()) for tn, ks in acked)
        if lost:
            raise AssertionError(f"{lost} probes lost across the reshard")
        ests2 = h.estimate_all()
        mgr.reshard(dp=1, shard=n_devices)
        if not np.array_equal(h.estimate_all(), ests2):
            raise AssertionError("HLL registers changed across a reshard")
        mgr.reshard(dp=dp0, shard=shard0)
        out = {"mesh": dict(mgr.mesh.shape), "positions": n_devices,
               "devices": sorted({str(p.device) for p in mgr.mesh.devices.flat}),
               "bloom_m": bf.get_size(), "tenants": tenants, "acked_batches": len(acked),
               "lost_probes": lost, "reshards": f"{shard0}->{n_devices}->{shard0}"}
    finally:
        client.shutdown()
    print(f"dryrun_multichip OK: mesh={out['mesh']} positions={n_devices} on {out['devices']}, bloom "
          f"m={out['bloom_m']} sharded over {shard0}, hll tenants={tenants}, engine path, live reshard "
          f"{out['reshards']} under traffic: {len(acked)} acked batches, 0 lost probes, checkpoint "
          f"round trip of the sharded records", flush=True)
    return out
