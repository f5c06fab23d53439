"""Time one-edit variants of kernels against their shipped design, in
turns, in one process on one card:

    python3 -m redisson_tpu_torch.tools.variant_ab [--out FILE]

from the repository root.  A variant is csrc/<library>.cu with the edits
listed in VARIANTS, built with the flags of core/_build.py into
_build/variants/ and loaded in place of the library, so that the public
wrappers launch it.  Each variant is timed against the shipped library in
the order shipped, variant, variant, shipped, with chip_smoke.py's timing
(CUDA events behind a sleep kernel), at the main path's shapes:

  kmeans_assign, config 7's training shape (50,000 x 128 points, 1,536
  centroids of the clustered corpus; the tensor-core route):
    three_hi   each of the three mma.sync products takes the high TF32
               parts (hi*hi three times): the low parts' splits go, the
               count of mma instructions stays (its sums are wrong: timed
               only)
    one_hi     the hi*hi product alone: a third of the mma instructions and
               no low parts (one TF32 product): timed, and its points that
               differ from the plain version outside chip_smoke.py's
               TIE_GAP counted
  bitset_get and bitset_set, config 5's shape (500 ops into its 1 MiB
  plane) and 1M ops into 2**28 lanes, 20 batches each on a plane 30% set,
  and the table form at fanout's level (128 such planes x 500 ops, all
  reads or all sets; staged beforehand, the launches alone):
    grid_only  every set by the cooperative grid kernel (the one-block
               form off), checked against the plain version bit for bit
  kmeans_update, config 7's training shape on the assignment kmeans_assign
  gives, the seven-step design of commit 44d9f96 (a memset, count, tile
  sums, scan, tile apply, scatter, sum) cut after each step:
    update_upto_<step>  returns right after <step>'s launch, so the
               differences of consecutive cuts time each step (timed only)
  and the two-launch update that replaced it:
    update_bucket_only  returns after the bucket kernel (timed only)
  wc_words at config 4's first chunk (the auto form; the delta form timed
  beside it), the four-launch design of commit 9c33264 cut after each of
  its first three launches:
    wc_upto_<step>  returns right after <step>'s launch (end count, scan,
               end write; timed only)
  and the one-launch design that replaced it, checked against the plain
  version bit for bit:
    tile_16k   tiles of 16 KB (four vectors a thread) for 8 KB
    halo_64    a 64-byte halo before each tile for 256
    memset     the look-back region cleared by a memset each call, in place
               of the call's tag in its status words
    cut_ranks  stops each tile after the look-back (timed only)
    cut_loads  reads no byte of the buffer: every vector is "w23 " four
               times (timed only)
    cut_writes hashes and stages every word but writes no row (timed only)
    cut_hash   stages each word's first and last byte but hashes none
               (timed only)
    cut_words  neither finds nor hashes a tile's words, writes its rows
               (timed only)
    threads_128     blocks of 128 threads, four vectors each (8 KB tiles)
    threads_128_4k  blocks of 128 threads, two vectors each (4 KB tiles)
  segment_reduce, 8,388,608 values into 1,024 keys (int32 sum, float32
  max), the design of 9c33264 cut:
    seg_upto_fill  returns after the fill (timed only)
    seg_no_flush   the shared copies never added into the result (timed
               only)
  and the one-launch design, checked against the plain version:
    cluster_1  no cluster: each block writes its own row
    cluster_8  clusters of 8 blocks for 4
    groups_4   four groups of four values a thread in flight for two
    cut_loop   no reduce loop: the copies, merges and atomics alone (timed
               only)

A variant whose edit texts do not occur in the source (a design since
replaced: the update steps apply to 44d9f96's csrc/kmeans.cu, the
wc_upto_ and seg_ cuts to 9c33264's sources, so run the script in a
checkout of that commit with this copy of it) is skipped and said so.  --only picks variants by name.  It prints one line per variant
and shape and, with --out, writes them as JSON.  The card's name and power
limit come first.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from redisson_tpu_torch.core import _build

# library -> variant -> [(text of the shipped source, its replacement)];
# each text must occur exactly once
_RETURN = "\n  return static_cast<int>(cudaGetLastError());"
# the launches of 44d9f96's rtpu_kmeans_update, in order
_UPDATE_STEPS = {
    "memset": "if (err != cudaSuccess) return static_cast<int>(err);\n  kmeans_count_kernel",
    "count": "kmeans_count_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, s>>>(a, N, chunks, offs);",
    "tile_sum": "kmeans_tile_sum_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(offs, M, tiles);",
    "scan": "kmeans_scan_kernel<<<1, kScanThreads, 0, s>>>(tiles, n_tiles);",
    "tile_apply": "kmeans_tile_apply_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(offs, M, tiles);",
    "scatter": "kmeans_scatter_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, s>>>(a, N, chunks, offs, order);",
}
# the launches of 9c33264's rtpu_wc_words (the auto form), in order
_WC_STEPS = {
    "end_count": "end_count_kernel<<<(unsigned)t, kThreads, 0, s>>>(b, n, sc);",
    "scan": "scan_single_kernel<<<1, kThreads, 0, s>>>(sc, t, nullptr);",
    "end_write": "end_write_kernel<<<(unsigned)t, kThreads, 0, s>>>(b, n, sc, e, rows);",
}
_SEG_FILL = ("fill_kernel<V, O><<<(unsigned)(fb < kMaxBlocks ? fb : kMaxBlocks), kThreads, 0, s>>>(o, "
             "n_keys);")
_BUCKET_LAUNCH = ("kmeans_bucket_kernel<<<B, kThreads, 0, s>>>(static_cast<const int32_t*>(assign), N, L, R, lst, "
                  "order);")
VARIANTS = {
    "kmeans": {
        "three_hi": [("mma_tf32(acc[i][j], al[i], bh[j]);", "mma_tf32(acc[i][j], ah[i], bh[j]);"),
                     ("mma_tf32(acc[i][j], ah[i], bl[j]);", "mma_tf32(acc[i][j], ah[i], bh[j]);")],
        "one_hi": [("mma_tf32(acc[i][j], al[i], bh[j]);", ""), ("mma_tf32(acc[i][j], ah[i], bl[j]);", "")],
        **{f"update_upto_{step}": [(text, (text.split("\n")[0] + _RETURN + "\n  kmeans_count_kernel")
                                    if step == "memset" else text + _RETURN)]
           for step, text in _UPDATE_STEPS.items()},
        # the two-launch update cut after its bucket kernel
        "update_bucket_only": [(_BUCKET_LAUNCH, _BUCKET_LAUNCH + _RETURN)],
    },
    "bitset": {"grid_only": [("if (max_count <= kBlockOps) {", "if (false) {")]},
    # the four-launch wc_words of 9c33264 cut after each of its first three
    # launches (end count, scan, end write; the fourth is the words kernel)
    "wordcount": {**{f"wc_upto_{step}": [(text, text + "\n    return (int)cudaGetLastError();")]
                     for step, text in _WC_STEPS.items()},
                  # the one-launch design's choices
                  "tile_16k": [("constexpr int kWordVecs = 2;", "constexpr int kWordVecs = 4;")],
                  "halo_64": [("constexpr int kHalo = 256;", "constexpr int kHalo = 64;")],
                  "memset": [("const uint32_t call_tag = static_cast<uint32_t>(tag);",
                              "cudaMemsetAsync(region, 0, 8 * (1 + tiles), s);\n  const uint32_t call_tag = 1u;")],
                  # cuts of the one-launch design (timed only): return after
                  # the look-back; hash and stage every word but write no row
                  "cut_ranks": [("if (round_first >= nw) break;", "if (round_first >= 0) break;")],
                  "cut_loads": [("uint4 v = __ldg(reinterpret_cast<const uint4*>(span + u0));",
                                 "uint4 v = make_uint4(0x20333277u, 0x20333277u, 0x20333277u, 0x20333277u);")],
                  "cut_hash": [("j < woff + warp_count && base_row + j < nw; j += 32) {",
                                "j < woff + warp_count && base_row + j < nw && n < 0; j += 32) {")],
                  "cut_words": [("    if (warp_first < nw) {  // warp-uniform", "    if (warp_first < nw && n < 0) {")],
                  "threads_128": [("constexpr int kWordThreads = 256;", "constexpr int kWordThreads = 128;"),
                                  ("constexpr int kWordVecs = 2;", "constexpr int kWordVecs = 4;")],
                  "threads_128_4k": [("constexpr int kWordThreads = 256;", "constexpr int kWordThreads = 128;")],
                  "cut_writes": [("const int64_t row_end = round_first + round_count < nw ? round_first + round_count : nw;",
                                  "const int64_t row_end = n < 0 ? nw : base_row;")]},
    # 9c33264's segment_reduce: the fill alone, and everything but the flush
    # of the shared copies into the result (its global atomics)
    "segment": {"seg_upto_fill": [(_SEG_FILL, _SEG_FILL + "\n  return cudaGetLastError();")],
                "seg_no_flush": [("j += blockDim.x) {\n      const V a = acc[j];\n      if (changed(a, id)) combine<O>",
                                  "j += blockDim.x) {\n      const V a = acc[j];\n      if (changed(a, id) && n < 0) combine<O>")],
                # the one-launch design's choices
                "cluster_1": [("constexpr int kCluster = 4;", "constexpr int kCluster = 1;")],
                "cluster_8": [("constexpr int kCluster = 4;", "constexpr int kCluster = 8;")],
                "groups_4": [("constexpr int kGroups = 2;", "constexpr int kGroups = 4;")],
                # a cut of the one-launch design (timed only): no reduce loop
                "cut_loop": [("  reduce_into<K, V, O>(acc, keys, vals, n, head, groups, n_keys);\n\n  cg::",
                              "  if (n < 0) reduce_into<K, V, O>(acc, keys, vals, n, head, groups, n_keys);\n\n  cg::")]},
}

# variants that stop a kernel part way: timed only
CUTS = {name for lib in VARIANTS.values() for name in lib
        if name.startswith(("update_upto_", "update_bucket_only", "wc_upto_", "seg_", "cut_"))}


def applies(lib: str, name: str) -> bool:
    """Whether every edit text of the variant occurs once in csrc/<lib>.cu."""
    src = (_build.CSRC / f"{lib}.cu").read_text()
    return all(src.count(old) == 1 for old, _new in VARIANTS[lib][name])


def build_variants(todo) -> dict:
    """csrc/<lib>.cu with VARIANTS[lib][name]'s edits for each (lib, name)
    of `todo`, all nvcc processes at once; each loaded with the shipped
    library's entry points.  Returns {(lib, name): handle}."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for lib, name in todo:
        src = (_build.CSRC / f"{lib}.cu").read_text()
        for old, new in VARIANTS[lib][name]:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {lib}/{name}: {old!r} occurs {src.count(old)} times in {lib}.cu")
            src = src.replace(old, new)
        cu, so = out / f"{lib}_{name}.cu", out / f"lib{lib}_{name}.so"
        cu.write_text(src)
        log = open(out / f"{lib}_{name}.log", "w")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs.append((lib, name, so, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    handles = {}
    for lib, name, so, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {lib}/{name}:\n{(out / f'{lib}_{name}.log').read_text()}")
        handles[lib, name] = _build.bind(ctypes.CDLL(str(so)), lib)
    return handles


def registers(log_path, kernel: str) -> str:
    """ptxas's register counts for the entry points whose name holds
    `kernel`, from a build log."""
    log = log_path.read_text().splitlines()
    found = []
    for i, line in enumerate(log):
        if "Compiling entry function" in line and kernel in line:
            for nxt in log[i + 1: i + 4]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    found.append(m.group(1))
                    break
    return "/".join(found)


@contextlib.contextmanager
def loaded(lib: str, handle: ctypes.CDLL):
    """The wrappers launch `handle`'s kernels in place of the library's."""
    shipped = _build.library(lib)
    _build._libs[lib] = handle
    try:
        yield
    finally:
        _build._libs[lib] = shipped


def in_turns(lib: str, variant: ctypes.CDLL, timed) -> dict:
    """timed() with the shipped library, the variant, the variant, the
    shipped library."""
    out = {"shipped_ms": [], "variant_ms": []}
    for which in ("shipped", "variant", "variant", "shipped"):
        with loaded(lib, variant if which == "variant" else _build.library(lib)):
            out[f"{which}_ms"].append(timed())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--only", help="comma-separated variant names (default: every variant)")
    args = ap.parse_args()
    sys.path.insert(0, str(_build._PKG.parent))
    import chip_smoke as CS
    from redisson_tpu_torch.client.objects.bitset import _DEFAULT_BITS
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.ops import bittensor as bt

    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    only = None if args.only is None else set(args.only.split(","))
    todo = []
    for lib, variants in VARIANTS.items():
        for name in variants:
            if only is not None and name not in only:
                continue
            if applies(lib, name):
                todo.append((lib, name))
            else:
                print(f"{lib} {name}: skipped, its edits do not occur in csrc/{lib}.cu", flush=True)
    s = time.perf_counter()
    handles = build_variants(todo)
    print(f"built {len(todo)} variants in {time.perf_counter() - s:.1f}s", flush=True)
    results = []

    # wc_words at config 4's first chunk (both forms), segment_reduce at the
    # KernelMapReduce shape (int32 sum, float32 max), as chip_smoke.py builds
    # them; a variant that computes the whole function is also held to the
    # plain version bit for bit
    if any(lib == "wordcount" for lib, _ in todo):
        buf, n_words, eb, base = CS.wc_chunks(CS.config4_values(), dev)[0]
        host = buf.cpu().numpy()
        ws = host == 32
        deltas = torch.from_numpy(np.diff(np.concatenate([[-1], np.nonzero(~ws & np.concatenate(
            [ws[1:], [True]]))[0]])).astype(np.int32)).to(dev)
        want = K.wc_extract_words_auto_plain(buf, n_words, eb, base)
        for lib, name in todo:
            if lib != "wordcount":
                continue
            times = in_turns(lib, handles[lib, name], lambda: CS.time_kernel(
                lambda i: K.wc_extract_words_auto(buf, n_words, eb, base)))
            r = {"kernel": "wc_words", "variant": name, "shape": f"config 4's first chunk, {buf.numel()} bytes, "
                 f"eb {eb}", **times}
            r.update({f"deltas_{k}": v for k, v in in_turns(lib, handles[lib, name], lambda: CS.time_kernel(
                lambda i: K.wc_extract_words(buf, deltas, deltas.numel(), base))).items()})
            if name not in CUTS:
                with loaded(lib, handles[lib, name]):
                    got = K.wc_extract_words_auto(buf, n_words, eb, base)
                    torch.cuda.synchronize()
                    r["equal_to_plain"] = all(torch.equal(g, w) for g, w in zip(got, want))
            results.append(r)
        del buf, deltas, want
    if any(lib == "segment" for lib, _ in todo):
        gen = np.random.default_rng(1234)
        ivals = torch.from_numpy(gen.integers(-(2**31), 2**31 - 1, CS.KMR_N).astype(np.int32)).to(dev)
        fvals = torch.from_numpy(gen.normal(0, 1000, CS.KMR_N).astype(np.float32)).to(dev)
        keys = torch.remainder(ivals, CS.KMR_KEYS)
        for lib, name in todo:
            if lib != "segment":
                continue
            for vals, reduce, kind in ((ivals, "sum", "int32"), (fvals, "max", "float32")):
                times = in_turns(lib, handles[lib, name], lambda: CS.time_kernel(
                    lambda i: K.segment_reduce(keys, vals, CS.KMR_KEYS, reduce)))
                r = {"kernel": "segment_reduce", "variant": name,
                     "shape": f"{kind} {reduce}, {CS.KMR_N} values into {CS.KMR_KEYS} keys", **times}
                if name not in CUTS:
                    with loaded(lib, handles[lib, name]):
                        got = K.segment_reduce(keys, vals, CS.KMR_KEYS, reduce)
                        r["equal_to_plain"] = torch.equal(got, K.segment_reduce_plain(keys, vals, CS.KMR_KEYS,
                                                                                      reduce))
                results.append(r)
        del ivals, fvals, keys
    torch.cuda.empty_cache()

    # kmeans_assign and kmeans_update at config 7's training shape, as
    # chip_smoke.py builds it
    if any(lib == "kmeans" for lib, _ in todo):
        n, w, nlist = CS.C7_POINTS[1][0], CS.C7_POINTS[1][1], CS.C7_NLIST
        rng = np.random.default_rng(4321)
        pts = torch.from_numpy(CS.c7_clustered(np.random.default_rng(CS.C7_SEED), n, w)).to(dev)
        weights = torch.ones(n, device=dev)
        weights[torch.from_numpy(rng.choice(n, 200, replace=False)).to(dev)] = 0.0
        pts[weights == 0] = 0.0
        init = np.sort(np.random.default_rng(0x1DF5EED ^ n).choice(np.nonzero(weights.cpu().numpy())[0], nlist,
                                                                     replace=False))
        cent = pts[torch.from_numpy(init).to(dev)].clone()
        plain = K.kmeans_assign_plain(pts, weights, cent)
        a0 = K.kmeans_assign(pts, weights, cent)
        d = ((pts * pts).sum(1)[:, None] - 2 * (pts @ cent.T) + (cent * cent).sum(1)[None, :]).double()
        two = torch.topk(d, 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > CS.TIE_GAP * two[:, 0].abs().clamp(min=1.0)
        del d, two
        shipped_regs = registers(_build.BUILD_DIR / "kmeans.log", "kmeans_mma_kernel")
        for lib, name in todo:
            if lib != "kmeans":
                continue
            variant = handles[lib, name]
            if name.startswith("update_"):
                times = in_turns("kmeans", variant, lambda: CS.time_kernel(
                    lambda i: K.kmeans_update(pts, weights, cent, a0), reps=50))
                results.append({"kernel": "kmeans_update", "variant": name, "shape": f"{n} x {w} x {nlist}", **times})
                continue
            times = in_turns("kmeans", variant, lambda: CS.time_kernel(lambda i: K.kmeans_assign(pts, weights, cent),
                                                                       reps=50))
            r = {"kernel": "kmeans_assign", "variant": name, "shape": f"{n} x {w} x {nlist}", **times,
                 "registers": registers(_build.BUILD_DIR / "variants" / f"kmeans_{name}.log", "kmeans_mma_kernel"), "shipped_registers": shipped_regs}
            if name == "one_hi":
                with loaded("kmeans", variant):
                    got = K.kmeans_assign(pts, weights, cent)
                r["differ_outside_gap"] = int((got[clear] != plain[clear]).sum())
                r["differ_near_ties"] = int((got[~clear] != plain[~clear]).sum())
                r["points_outside_gap"], r["near_tied_points"] = int(clear.sum()), int((~clear).sum())
            results.append(r)
        del pts, weights, cent, plain, clear, a0
        torch.cuda.empty_cache()

    # bitset_get and bitset_set at config 5's shape and on 1M ops into 2**28
    # lanes (one plane: 20 batches each on a plane 30% set), and the table
    # form at fanout's level (128 planes x 500 ops, all reads or all sets)
    rng = np.random.default_rng(99)
    shapes = {"config 5": (bt.padded_size(_DEFAULT_BITS), CS.C5_BITS, CS.C5_BIT_OPS),
              "2**28 lanes": (1 << CS.BITMAP_LOG2, 1 << CS.BITMAP_LOG2, CS.BITMAP_OPS)}
    for lib, name in todo:
        if lib != "bitset":
            continue
        variant = handles[lib, name]
        for label, (size, hi, n_ops) in shapes.items():
            base = (torch.rand(size, device=dev) < 0.3).to(torch.uint8)
            batches = [CS.index_batch(rng, n_ops, hi, dev) for _ in range(20)]
            for kernel in ("bitset_get", "bitset_set"):
                def timed():
                    plane = base.clone()
                    K.bitset_set(base.clone(), batches[0], n_ops, 1)  # a launch of this library before the timing
                    if kernel == "bitset_get":
                        return CS.time_kernel(lambda i: K.bitset_get(plane, batches[i]), reps=len(batches))
                    return CS.time_kernel(lambda i: K.bitset_set(plane, batches[i], n_ops, 1), reps=len(batches),
                                          warm=lambda: None)

                times = in_turns("bitset", variant, timed)
                equal = True
                with loaded("bitset", variant):
                    for b in batches[:3]:
                        for n_valid in (0, 1, n_ops // 2, n_ops):
                            for value in (0, 1):
                                x, y = base.clone(), base.clone()
                                got = K.bitset_set(x, b, n_valid, value)[1]
                                want = K.bitset_set_plain(y, b, n_valid, value)[1]
                                torch.cuda.synchronize()
                                equal = equal and torch.equal(got, want) and torch.equal(x, y)
                        equal = equal and torch.equal(K.bitset_get(base, b), K.bitset_get_plain(base, b))
                results.append({"kernel": kernel, "variant": name, "shape": f"{label}: {n_ops} ops", **times,
                                "equal_to_plain": equal})
            del base, batches
            torch.cuda.empty_cache()
        groups = 2 * CS.C5_TENANTS
        planes = [(torch.rand(bt.padded_size(_DEFAULT_BITS), device=dev) < 0.3).to(torch.uint8)
                  for _ in range(groups)]
        for kernel, value in (("bitset_get", None), ("bitset_set", 1)):
            values = [value] * groups
            batches = [[CS.host_indexes(rng, CS.C5_BIT_OPS, 0, CS.C5_BITS) for _ in range(groups)]
                       for _ in range(20)]
            levels = [K.bitset_stage(planes, b, values) for b in batches]
            times = in_turns("bitset", variant, lambda: CS.time_kernel(lambda i: K.bitset_launch(planes, levels[i])))
            with loaded("bitset", variant):
                try:
                    equal = CS.assert_groups_equal(f"{kernel} {name}", planes, batches[0], values) == 0.0
                except AssertionError:
                    equal = False
            results.append({"kernel": kernel, "variant": name,
                            "shape": f"the table form, {groups} planes x {CS.C5_BIT_OPS} ops", **times,
                            "equal_to_plain": equal})
        del planes
        torch.cuda.empty_cache()

    for r in results:
        extra = {k: v for k, v in r.items() if k not in ("kernel", "variant", "shape", "shipped_ms", "variant_ms")}
        print(f"{r['kernel']} {r['variant']} at {r['shape']}: shipped "
              + " / ".join(f"{t:.4f}" for t in r["shipped_ms"]) + " ms, variant "
              + " / ".join(f"{t:.4f}" for t in r["variant_ms"]) + " ms; " + json.dumps(extra), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r.get("equal_to_plain") is False]
    return 1 if bad else 0

if __name__ == "__main__":
    sys.exit(main())
