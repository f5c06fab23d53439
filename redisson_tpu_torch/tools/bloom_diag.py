"""Time the sketch kernels' design choices on one CUDA card.

    python3 -m redisson_tpu_torch.tools.bloom_diag [--sections S,...] [--out FILE]

Sections of the run (all times are device times between CUDA events, on
fresh batches; k = 7 as on the main path):
  stores   bloom_set and bloom_probe on batches of 2**20 keys into single
           planes of 8 MB (inside the 50 MB L2), 96 MB (config 1) and 768 MB:
           whether a random byte store costs a sector's trip to memory
           (kernels.FUSED_ADD_MIN_PLANE);
  passes   the fused add's device time by pass (tools/bloom_diag.cu
           diag_add_passes), with csrc/bloom.cu's ops per block and with
           1024, and without the apply's in-place route for sparse chunks,
           beside the probe-then-set pair on the same batch: config 1's 1M
           batch, batches around the dispatch threshold, config 2's populate;
  dispatch the fused add against the probe-then-set pair by batch size on the
           config-1 plane, the config-2 bank and planes of 4, 32 and 64 MB,
           each half full: where the fused add starts to pay
           (kernels.FUSED_ADD_PROBES_PER_SECTOR);
  hll      the card's floor for a scatter-max (tools/bloom_diag.cu
           diag_rmw): ten sets of 1M random register ops each, as plain
           byte loads, plain byte stores, a CAS from a guess of four empty
           registers (no load) and a load then a CAS, into banks of 16 KB
           (one counter), 8, 64 and 128 MB and config 3's 10,000 x 16,384
           (164 MB), each zeroed and filled as counters of ~0.06, 0.6, 6
           and 65,536 keys per register leave them (config 3 after its ten
           batches, after 100 and 1,000, counters of ~1e9 keys); hll_add on
           config 3's add stream, on config-3 banks so filled and on one
           counter; hll_rows' estimate on four register distributions
           (zeros, config 3's bank after its adds and merge, the synthetic
           P(r) ~ 2**-r bank of chip_smoke.py, counters of ~1e9 keys)
           beside a streaming read of the bank, its 4-byte-load path, and
           the merge map beside torch.maximum.
--sections picks some of them (default: all).  The JSON of the run goes to
--out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from redisson_tpu_torch.core import _build
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.ops import bittensor as bt
from redisson_tpu_torch.utils import hashing as H

HERE = Path(__file__).resolve().parent
KH = 7
C1_M = 95_850_583  # config 1: 1e7 keys at 0.01
C2_T, C2_M = 1000, 96_256


def log(msg: str) -> None:
    print(msg, flush=True)


def time_launches(fn, reps: int) -> float:
    """Median device ms of fn(i), i < reps, enqueued behind a sleep kernel so
    that the events bracket device work and not the host's launch cost."""
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)
    ev[0].record()
    for i in range(reps):
        fn(i)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def batch(rng, n: int, dev, tenants: int = 0) -> K.Keys:
    b = K.bucket_size(n)
    keys = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    lo, hi = np.zeros(b, np.uint32), np.zeros(b, np.uint32)
    lo[:n], hi[:n] = H.int_keys_to_u32_pair(keys)
    t = None
    if tenants:
        t = np.zeros(b, np.int32)
        t[:n] = rng.integers(0, tenants, n)
        t = K.stage(t, dev)
    return K.Keys(n=b, tenant=t, lo=K.stage(lo, dev), hi=K.stage(hi, dev))


def half_full(shape, dev) -> torch.Tensor:
    return (torch.rand(shape, device=dev) < 0.5).to(torch.uint8)


def diag_library():
    target = _build.BUILD_DIR / "libbloom_diag.so"
    _build.BUILD_DIR.mkdir(exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(HERE / "bloom_diag.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(target))
    P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
    for fn, argtypes in (("diag_add_passes", [P, L, L, P, P, P, I, I, L, U, I, I, I, I, P, P, P, P, P, P]),
                         ("diag_rmw", [P, P, P, I, I, P, P]),
                         ("diag_read", [P, L, P, P])):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = I
    return lib


PASSES = ("count", "scan", "scatter", "apply", "finish")
# (ops per block, 0 = csrc/bloom.cu's rule; apply's in-place route for sparse chunks)
PASS_SETTINGS = ((0, 1), (1024, 1), (0, 0))


def stores(dev, rng) -> list:
    rows = []
    for label, size in (("8 MB", 8 << 20), ("96 MB (config 1)", bt.padded_size(C1_M)), ("768 MB", 768 << 20)):
        batches = [batch(rng, 1 << 20, dev) for _ in range(8)]
        n = K.bucket_size(1 << 20)
        plane = torch.zeros(size, dtype=torch.uint8, device=dev)
        set_ms = time_launches(lambda i: K.bloom_set(plane, size, batches[i], 1 << 20, KH, size), 8)
        probe_ms = time_launches(lambda i: K.bloom_probe(plane, size, batches[i], 1 << 20, KH, size,
                                                         out=K.BITS), 8)
        stores_n = KH * (1 << 20)
        rows.append({"plane": label, "bytes": size, "ops": 1 << 20, "batch": n, "set_ms": set_ms,
                     "probe_ms": probe_ms, "set_g_stores_per_s": stores_n / set_ms / 1e6,
                     "probe_g_loads_per_s": stores_n / probe_ms / 1e6})
        log(f"stores {label}: set {set_ms:.4f} ms ({rows[-1]['set_g_stores_per_s']:.1f} G stores/s), "
            f"probe {probe_ms:.4f} ms ({rows[-1]['probe_g_loads_per_s']:.1f} G loads/s)")
        del plane
    return rows


def passes(dev, rng) -> list:
    """Device ms of each pass of the fused add, median of 3 runs, each on a
    fresh copy of its plane, and of the probe-then-set pair on the same
    batch and plane."""
    lib = diag_library()
    size1 = bt.padded_size(C1_M)
    keys = rng.integers(-(2**63), 2**63 - 1, 10_000_000, dtype=np.int64)
    lo, hi = H.int_keys_to_u32_pair(keys)
    b = K.bucket_size(len(keys))
    populate = K.Keys(n=b, tenant=K.stage(K.pad_to(rng.integers(0, C2_T, len(keys)).astype(np.int32), b), dev),
                      lo=K.stage(K.pad_to(lo, b), dev), hi=K.stage(K.pad_to(hi, b), dev))
    one_m = (1 << 20) - 1000
    half1 = half_full(size1, dev)
    cases = [("config-1 1M batch, zeroed plane", torch.zeros(size1, dtype=torch.uint8, device=dev), size1, C1_M,
              batch(rng, one_m, dev), one_m),
             ("config-1 1M batch, half-full plane", half1, size1, C1_M, batch(rng, one_m, dev), one_m)]
    for n in (1 << 16, 1 << 17, 1 << 18):
        cases.append((f"config-1 plane half full, {n} ops ({KH * n * 32 / size1:.2f} probes per sector)", half1,
                      size1, C1_M, batch(rng, n, dev), n))
    cases.append(("config-2 10M populate, zeroed bank", torch.zeros((C2_T, C2_M), dtype=torch.uint8, device=dev),
                  C2_M, C2_M, populate, len(keys)))
    rows = []
    stream = torch.cuda.current_stream().cuda_stream
    for label, plane, width, m, kb, nv in cases:
        want = K.bloom_add_plain(plane.clone(), width, kb, nv, KH, m, K.BITS)
        works = [plane.clone() for _ in range(3)]
        pair_ms = time_launches(lambda i: (K.bloom_probe(works[i], width, kb, nv, KH, m, newly=True, out=K.BITS),
                                           K.bloom_set(works[i], width, kb, nv, KH, m)), 3)
        del works
        for ops, sparse in PASS_SETTINGS:
            runs = []
            for _ in range(3):
                work = plane.clone()
                newly = torch.empty(kb.n, dtype=torch.bool, device=dev)
                out = torch.empty(kb.n // 32, dtype=torch.int32, device=dev)
                scratch = torch.empty(2 * K.add_chunks(work.numel()) + 1, dtype=torch.int32, device=dev)
                entries = torch.empty(KH * nv, dtype=torch.int64, device=dev)
                ms = (ctypes.c_float * 5)()
                torch.cuda._sleep(2_000_000)  # the host enqueues every pass before the first runs
                _build.check("diag_add_passes", lib.diag_add_passes(
                    work.data_ptr(), work.numel(), width, None if kb.tenant is None else kb.tenant.data_ptr(),
                    kb.lo.data_ptr(), kb.hi.data_ptr(), kb.n, nv, m, K.fastmod_magic(m), K.ADD_CHUNK_LOG2, ops,
                    sparse, K.BITS, out.data_ptr(), newly.data_ptr(), scratch.data_ptr(), entries.data_ptr(), ms,
                    stream))
                runs.append(list(ms))
                if not torch.equal(out, want):
                    raise AssertionError(f"diag_add_passes differs from the plain add: {label}")
                del work, entries
            med = [statistics.median(r[i] for r in runs) for i in range(5)]
            rows.append({"case": label, "ops_per_block": ops or "rule", "sparse_route": bool(sparse),
                         **dict(zip(PASSES, med)), "total": sum(med), "pair_ms": pair_ms})
            log(f"passes {label}, ops/block {ops or 'rule'}, sparse route {bool(sparse)}: "
                + ", ".join(f"{p} {t:.4f}" for p, t in zip(PASSES, med))
                + f" = {sum(med):.4f} ms (pair {pair_ms:.4f} ms)")
        del plane
    del cases, half1
    torch.cuda.empty_cache()
    return rows


def add_routes(plane, width, m, batches, n):
    """Median ms per batch of the fused add and of the pair, each on its own
    copy of `plane`, timed in turns fused, pair, pair, fused."""
    def fused(work):
        return lambda i: K.bloom_add_fused(work, width, batches[i], n, KH, m, K.COUNT)

    def pair(work):
        def go(i):
            K.bloom_probe(work, width, batches[i], n, KH, m, newly=True, out=K.COUNT)
            K.bloom_set(work, width, batches[i], n, KH, m)
        return go

    times = {"fused": [], "pair": []}
    for route in ("fused", "pair", "pair", "fused"):
        work = plane.clone()
        times[route].append(time_launches((fused if route == "fused" else pair)(work), len(batches)))
        del work
    return min(times["fused"]), min(times["pair"])


def dispatch(dev, rng) -> list:
    rows = []
    size1 = bt.padded_size(C1_M)
    planes = [("config-1 plane", half_full(size1, dev), size1, C1_M, 0),
              ("config-2 bank", half_full((C2_T, C2_M), dev), C2_M, C2_M, C2_T),
              ("4 MB plane", half_full(4 << 20, dev), 4 << 20, 4 << 20, 0),
              ("32 MB plane", half_full(32 << 20, dev), 32 << 20, 32 << 20, 0),
              ("64 MB plane", half_full(64 << 20, dev), 64 << 20, 64 << 20, 0)]
    for label, plane, width, m, tenants in planes:
        sectors = plane.numel() / 32
        for n in (1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20):
            batches = [batch(rng, n, dev, tenants) for _ in range(6)]
            fused_ms, pair_ms = add_routes(plane, width, m, batches, n)
            rows.append({"plane": label, "bytes": plane.numel(), "ops": n,
                         "probes_per_sector": KH * n / sectors, "fused_ms": fused_ms, "pair_ms": pair_ms})
            log(f"dispatch {label} n={n} probes/sector {KH * n / sectors:.4f}: fused {fused_ms:.4f} ms, "
                f"pair {pair_ms:.4f} ms")
        del plane
        torch.cuda.empty_cache()
    return rows


HLL_P = 14
C3_T, C3_BATCH, C3_BATCHES = 10_000, 1_000_000, 10
RMW_MODES = ("load", "store", "cas", "load_cas")
# keys per register of the filled banks: config 3 after its ten batches
# (1,000 keys a counter), after 100 and 1,000, and counters of ~1e9 keys
FILLS = (0.0, 1000 / (1 << HLL_P), 10_000 / (1 << HLL_P), 100_000 / (1 << HLL_P), 2.0**16)


def ranks(n: int, dev) -> torch.Tensor:
    """Ranks as clz32(h2) + 1 of a uniform odd h2 gives them: P(r) = 2**-r."""
    u = torch.rand(n, device=dev, dtype=torch.float64)
    return torch.clamp(torch.floor(-torch.log2(u)) + 1, 1, 32).to(torch.uint8)


def filled_bank(shape, keys_per_register: float, dev) -> torch.Tensor:
    """Registers of counters fed ~keys_per_register keys a register: the max
    of a Poisson number of ranks, P(register <= r) = exp(-n 2**-r); all 0
    for n = 0."""
    if keys_per_register == 0:
        return torch.zeros(shape, dtype=torch.uint8, device=dev)
    u = torch.rand(shape, device=dev, dtype=torch.float64)
    return torch.clamp(torch.ceil(torch.log2(keys_per_register / -torch.log(u))), 0, 33).to(torch.uint8)


def rmw_floor(lib, dev, stream) -> list:
    """diag_rmw's modes, each from a fresh copy of the bank fed ten fresh
    sets of 1M random positions: the floor of a scatter-max by bank size and
    by how full the bank is.  Loads and stores (their time does not depend
    on the registers) on the zeroed banks only."""
    rows = []
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    m = 1 << HLL_P
    sizes = [(f"one counter {m}", m), ("8 MB", 8 << 20), ("64 MB", 64 << 20), ("128 MB", 128 << 20),
             (f"config-3 bank {C3_T}x{m}", C3_T * m)]
    for label, nbytes in sizes:
        sets = [(torch.randint(0, nbytes, (C3_BATCH,), device=dev).to(torch.int32), ranks(C3_BATCH, dev))
                for _ in range(C3_BATCHES)]
        for fill in FILLS:
            start = filled_bank(nbytes, fill, dev)
            modes = RMW_MODES if fill == 0 else ("cas", "load_cas")
            row = {"bank": label, "bytes": nbytes, "keys_per_register": fill, "ops": C3_BATCH,
                   "registers_zero": (start == 0).float().mean().item(),
                   "words_zero": (start.view(torch.int32) == 0).float().mean().item()}
            for turn in modes + modes[::-1]:
                regs = start.clone()
                ms = time_launches(lambda i: _build.check("diag_rmw", lib.diag_rmw(
                    regs.data_ptr(), sets[i][0].data_ptr(), sets[i][1].data_ptr(), C3_BATCH,
                    RMW_MODES.index(turn), sink.data_ptr(), stream)), len(sets))
                row[f"{turn}_ms"] = min(row.get(f"{turn}_ms", ms), ms)
                del regs
            rows.append(row)
            log(f"hll floor {label}, {fill:g} keys a register ({row['words_zero']:.3f} of words 0), "
                f"{C3_BATCH} random ops: " + ", ".join(f"{name} {row[name + '_ms']:.4f} ms" for name in modes))
            del start
        del sets
        torch.cuda.empty_cache()
    return rows


def hll_add_banks(dev, rng) -> list:
    """hll_add (csrc/hll.cu) fed ten batches of new keys: config 3's stream
    (1M ops into 10,000 x 16,384) from a zeroed bank and from banks filled
    as FILLS says, and one counter fed 1M ops a batch.  Its final registers
    equal the plain version's."""
    m = 1 << HLL_P
    cases = [(f"config-3 bank, {fill:g} keys a register", C3_T, C3_BATCH, fill) for fill in FILLS]
    cases.append((f"one counter {m}, {C3_BATCH} ops a batch", 0, C3_BATCH, 0.0))
    rows = []
    for label, tenants, n, fill in cases:
        batches = [batch(rng, n, dev, tenants) for _ in range(C3_BATCHES)]
        start = filled_bank((tenants, m) if tenants else (m,), fill, dev)
        ref = start.clone()
        for kb in batches:
            K.hll_add_plain(ref, m, kb, n, HLL_P)
        row = {"case": label, "bytes": start.numel(), "ops": n, "batches": C3_BATCHES}
        for turn in range(2):
            regs = start.clone()
            ms = time_launches(lambda i: K.hll_add(regs, m, batches[i], n, HLL_P), len(batches))
            if not torch.equal(regs, ref):
                raise AssertionError(f"hll_add differs from the plain version: {label}")
            row["ms"] = min(row.get("ms", ms), ms)
            del regs
        rows.append(row)
        log(f"hll_add {label}: {row['ms']:.4f} ms a batch")
        del batches, start, ref
        torch.cuda.empty_cache()
    return rows


def synthetic_bank(dev) -> torch.Tensor:
    """chip_smoke.py's timing bank: P(r) ~ 2**-r, about half the registers 0."""
    u = torch.rand((C3_T, 1 << HLL_P), device=dev)
    return torch.clamp(torch.floor(-torch.log2(u)) * (u < 0.9), 0, 33).to(torch.uint8)


def config3_bank(dev) -> torch.Tensor:
    """The bank as chip_smoke.py's config 3 leaves it: ten 1M add batches
    (keys and tenants from its seed), then even rows merged with odd ones."""
    crng = np.random.default_rng(7)
    regs = torch.zeros((C3_T, 1 << HLL_P), dtype=torch.uint8, device=dev)
    b = K.bucket_size(C3_BATCH)
    for _ in range(C3_BATCHES):
        t = crng.integers(0, C3_T, C3_BATCH).astype(np.int32)
        lo, hi = H.int_keys_to_u32_pair(crng.integers(0, 1 << 60, C3_BATCH).astype(np.int64))
        K.hll_bank_add_packed(regs, K.pack_rows(t, lo, hi, size=b, device=dev), C3_BATCH, HLL_P)
    src_map = torch.arange(C3_T, dtype=torch.int32, device=dev)
    src_map[0::2] += 1
    return K.hll_bank_merge_map(regs, src_map)


def hll_rows_estimates(lib, dev, stream) -> list:
    """The estimate of every row on four register distributions, beside a
    streaming read of the bank; the 4-byte-load path; the merge map beside
    torch.maximum."""
    m = 1 << HLL_P
    rows = []
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for label, make in (("zeros", lambda: torch.zeros((C3_T, m), dtype=torch.uint8, device=dev)),
                        ("config 3 after its adds and merge", lambda: config3_bank(dev)),
                        ("synthetic P(r) ~ 2**-r", lambda: synthetic_bank(dev)),
                        ("counters of ~1e9 keys", lambda: filled_bank((C3_T, m), 2.0**16, dev))):
        bank = make()
        want = K.hll_rows_plain(bank, estimate=True)
        got = K.hll_rows(bank, estimate=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True, msg=f"kernel on {label}")
        small = (bank.to(torch.int32) <= 7).float().mean().item()
        row = {"bank": label, "registers_le_7": small}
        routes = {"kernel": lambda i: K.hll_rows(bank, estimate=True),
                  "read_floor": lambda i: lib.diag_read(bank.data_ptr(), bank.numel(), sink.data_ptr(), stream)}
        for route in list(routes) + list(routes)[::-1]:
            ms = time_launches(routes[route], 20)
            row[f"{route}_ms"] = min(row.get(f"{route}_ms", ms), ms)
        if label.startswith("synthetic"):
            buf = torch.empty(bank.numel() + 4, dtype=torch.uint8, device=dev)
            narrow = buf[4:].view(C3_T, m)  # 4-byte aligned only: the 4-byte-load path
            narrow.copy_(bank)
            torch.testing.assert_close(K.hll_rows(narrow, estimate=True), want, rtol=0, atol=0, equal_nan=True)
            row["kernel_4_byte_loads_ms"] = time_launches(lambda i: K.hll_rows(narrow, estimate=True), 20)
            del buf, narrow
            y = synthetic_bank(dev)
            src_map = torch.randperm(C3_T, device=dev).to(torch.int32)
            out, ref = torch.empty_like(bank), torch.empty_like(bank)
            K.hll_rows_plain(bank, y, None, src_map, out=ref)
            K.hll_rows(bank, y, None, src_map, out=out)
            if not torch.equal(out, ref):
                raise AssertionError("hll_rows merge map differs from the plain version")
            for route in ("kernel", "torch.maximum", "torch.maximum", "kernel"):
                fn = {"kernel": lambda i: K.hll_rows(bank, y, None, src_map, out=out),
                      "torch.maximum": lambda i: torch.maximum(bank, y, out=out)}[route]
                ms = time_launches(fn, 20)
                row[f"merge_{route}_ms"] = min(row.get(f"merge_{route}_ms", ms), ms)
            del y, out, ref
        rows.append(row)
        log(f"hll_rows estimate, {label} ({small:.4f} of registers <= 7): " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_ms")))
        del bank, want, got
        torch.cuda.empty_cache()
    return rows


def hll(dev, rng) -> dict:
    lib = diag_library()
    stream = torch.cuda.current_stream().cuda_stream
    return {"floor": rmw_floor(lib, dev, stream), "add": hll_add_banks(dev, rng),
            "rows": hll_rows_estimates(lib, dev, stream)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--sections", default="stores,passes,dispatch,hll")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bloom_diag: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    sections = {"stores": stores, "passes": passes, "dispatch": dispatch, "hll": hll}
    result = {"card": card}
    for name in args.sections.split(","):
        result[name] = sections[name](dev, rng)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
