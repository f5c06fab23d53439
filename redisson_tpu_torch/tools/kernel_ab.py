"""Time two trees' kernels in turns on one CUDA card, e.g. a parent commit
against its change.

    python3 -m redisson_tpu_torch.tools.kernel_ab [--paths] [--out FILE] TREE [TREE ...]

Each TREE is a checkout of this repository (say the parent unpacked with
`git archive` into a git-ignored directory, and `.` for the change); give
them in the order to run, e.g. `parent . . parent`.  For each, a fresh
process, started in that tree with only that tree on its path, builds the
tree's kernels and runs its own chip_smoke.py phases check_bitset
(bitset_get and bitset_set at config 5's shape and on 1M indexes into a
2**28-lane plane), check_wordcount (config 4's stream: wc_words in both
forms, wc_sort_runs, segment_reduce's int32 sum and float32 max) and check_vector (knn_score, knn_select,
ivf_score, kmeans at config 7's shapes and 1M x 128), each kernel checked
against its plain version as chip_smoke.py checks it; then config 7's IVF batch at nprobe 2, 4 and 8
through the public wrappers every tree has (the route's knn_select,
ivf_score, the candidates' knn_select), on the same inputs in every tree
(the digest of the trained centroids printed: equal digests, equal bits);
fanout's bit-set levels (128 planes x 500 ops): 128 one-plane launches
through the public wrappers every tree has, and the table form's launches
(kernels.bitset_stage / bitset_launch) where the tree has them; with
--paths also run_fanout (ops/s and launches a rep), run_config4 and
run_config7 through that tree's create().  It prints every kernel's times
by run (the k-means step's assign and update on lines of their own), the
IVF batch's and the fanout levels', then the paths' fanout ops/s,
word-count walls and config 7's per-leg qps, and writes the JSON of the
run to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import hashlib, json, sys
import numpy as np, torch
import chip_smoke as CS
from redisson_tpu_torch.core import _build
build_s = _build.build_all()
dev = torch.device("cuda")
values = CS.config4_values()
kernels = CS.check_bitset(dev, np.random.default_rng(99))
kernels.update(CS.check_wordcount(dev, np.random.default_rng(1234), values))
kernels.update(CS.check_vector(dev, np.random.default_rng(4321)))
out = {"build_s": build_s,
       "kernels": {k: {key: v for key, v in r.items() if isinstance(v, (int, float))} for k, r in kernels.items()}}
# config 7's IVF batch through the public wrappers, which every tree has: the
# route's select (k = nprobe), ivf_score and the candidates' select (k 10,
# with row ids), on the same inputs in every tree (a seeded k-means of the
# clustered corpus, as check_vector trains it)
from redisson_tpu_torch.core import kernels as K
n, w, nlist = CS.C7_POINTS[1][0], CS.C7_POINTS[1][1], CS.C7_NLIST
vecs = CS.c7_clustered(np.random.default_rng(CS.C7_SEED), n, w)
pts = torch.from_numpy(vecs).to(dev)
ones = torch.ones(n, device=dev)
init = np.sort(np.random.default_rng(0x1DF5EED ^ n).choice(n, nlist, replace=False))
cent = pts[torch.from_numpy(init).to(dev)].clone()
for _ in range(CS.KMEANS_ITERS):
    cent, assign = K.kmeans_step(pts, ones, cent)
out["trained_centroids_sha256"] = hashlib.sha256(cent.cpu().numpy().tobytes()).hexdigest()
cells = torch.from_numpy(CS.c7_cells(assign.cpu().numpy(), nlist)[0]).to(dev)
q = torch.from_numpy(CS.c7_queries(np.random.default_rng(CS.C7_SEED + 1), vecs, CS.C7_QB)).to(dev)
bias = torch.zeros(n, device=dev)
route = K.knn_score(cent, None, None, None, q, nlist, "COSINE")
out["ivf"] = {}
for nprobe in CS.C7_NPROBES:
    probe = K.knn_select(route, nprobe)[1]
    cd, cids = K.ivf_score(pts, None, bias, None, cells, probe, q, n, "COSINE")
    out["ivf"][nprobe] = {
        "route_select_ms": CS.time_kernel(lambda i: K.knn_select(route, nprobe)),
        "ivf_score_ms": CS.time_kernel(lambda i: K.ivf_score(pts, None, bias, None, cells, probe, q, n, "COSINE")),
        "cand_select_ms": CS.time_kernel(lambda i: K.knn_select(cd, CS.C7_K, cids))}
# fanout's bit-set levels (128 planes of 1 MiB x 500 ops, all reads or all
# sets): 128 one-plane launches, which every tree has, and the table form's
# launches where the tree has it, on the same indexes
from redisson_tpu_torch.client.objects.bitset import _DEFAULT_BITS
from redisson_tpu_torch.ops import bittensor as bt
rng = np.random.default_rng(55)
groups = 2 * CS.C5_TENANTS
planes = [(torch.rand(bt.padded_size(_DEFAULT_BITS), device=dev) < 0.3).to(torch.uint8) for _ in range(groups)]
batches = [[rng.integers(0, CS.C5_BITS, CS.C5_BIT_OPS).astype(np.int32) for _ in range(groups)] for _ in range(20)]
single = [[torch.from_numpy(a).to(dev) for a in b] for b in batches]
out["fanout_level"] = {
    "get_one_plane_launches_ms": CS.time_kernel(lambda i: [K.bitset_get(p, a) for p, a in zip(planes, single[i])]),
    "set_one_plane_launches_ms": CS.time_kernel(
        lambda i: [K.bitset_set(p, a, CS.C5_BIT_OPS, 1) for p, a in zip(planes, single[i])])}
if hasattr(K, "bitset_stage"):
    for verb, value in (("get", None), ("set", 1)):
        levels = [K.bitset_stage(planes, b, [value] * groups) for b in batches]
        out["fanout_level"][verb + "_table_ms"] = CS.time_kernel(lambda i: K.bitset_launch(planes, levels[i]))
        del levels
del planes, single
torch.cuda.empty_cache()
if PATHS:
    import redisson_tpu_torch
    client = redisson_tpu_torch.create()
    fan = CS.run_fanout(client, np.random.default_rng(13))
    out["fanout"] = {"ops_per_s": fan["ops_per_s"], "pool_on_ops_per_s": fan["pool_on_ops_per_s"],
                     "pool_off_ops_per_s": fan["pool_off_ops_per_s"],
                     "launches_a_rep": [r["launches"] for r in fan["reps"]]}
    out["config4"] = {k: v for k, v in CS.run_config4(client, values).items() if isinstance(v, (int, float, dict))}
    out["config7"] = CS.run_config7(client)
    client.shutdown()
print("AB " + json.dumps(out, default=str))
"""


def run_tree(tree: str, paths: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD.replace("PATHS", str(paths))], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    line = next(x for x in reversed(proc.stdout.splitlines()) if x.startswith("AB "))
    return json.loads(line[3:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for tree in args.trees:
        runs.append({"tree": tree, **run_tree(tree, args.paths)})
        print(f"ran {tree}", flush=True)
    names = list(runs[0]["kernels"])
    for key in ("ms", "assign_ms", "update_ms"):
        vals = [r["kernels"].get("kmeans", {}).get(key) for r in runs]
        print(f"kmeans {'step' if key == 'ms' else key[:-3]}: "
              + "  ".join("-" if v is None else f"{v:.4f}" for v in vals))
    for name in names:
        keys = sorted({k for r in runs for k in r["kernels"].get(name, {}) if k.endswith("_ms") or k == "ms"})
        for key in keys:
            vals = [r["kernels"].get(name, {}).get(key) for r in runs]
            print(f"{name} {key}: " + "  ".join("-" if v is None else f"{v:.4f}" for v in vals))
    for nprobe in runs[0]["ivf"]:
        for key in runs[0]["ivf"][nprobe]:
            vals = [r["ivf"][nprobe][key] for r in runs]
            print(f"ivf nprobe {nprobe} {key}: " + "  ".join(f"{v:.4f}" for v in vals))
    print("IVF training's centroids after KMEANS_ITERS Lloyd steps, sha256: "
          + "  ".join(r["trained_centroids_sha256"][:16] for r in runs))
    for key in runs[0]["fanout_level"]:
        vals = [r["fanout_level"].get(key) for r in runs]
        print(f"fanout level {key}: " + "  ".join("-" if v is None else f"{v:.4f}" for v in vals))
    if args.paths:
        for r in runs:
            fan = r["fanout"]
            bits = [(x["bitset_get"], x["bitset_set"]) for x in fan["launches_a_rep"]]
            print(f"{r['tree']}: fanout ops/s {', '.join(f'{v:.4e}' for v in fan['ops_per_s'])}; (bitset_get, "
                  f"bitset_set) launches a rep {bits}; staging pool on / off "
                  f"{', '.join(f'{v:.4e}' for v in fan['pool_on_ops_per_s'])} / "
                  f"{', '.join(f'{v:.4e}' for v in fan['pool_off_ops_per_s'])}")
        for r in runs:
            c4, c7 = r["config4"], r["config7"]
            qps = ", ".join(f"{leg} {v['qps']:.1f}" for leg, v in c7["legs"].items())
            print(f"{r['tree']}: config4 word_count cold {c4['cold_s']:.4f} s, warm {c4['warm_s'] * 1e3:.3f} ms; "
                  f"config7 qps {qps}; v7_sift parts " + json.dumps(c7["parts"].get("v7_sift")))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
