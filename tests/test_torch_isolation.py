"""redisson_tpu_torch stands alone: it imports neither JAX nor anything of
redisson_tpu, lands on the CPU only when asked, and a CPU run launches no
kernel."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import redisson_tpu_torch
from redisson_tpu_torch.core import kernels as K

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "redisson_tpu_torch"


def _modules():
    names = ["redisson_tpu_torch"]
    for info in pkgutil.walk_packages([str(PKG)], prefix="redisson_tpu_torch."):
        names.append(info.name)
    return names


def test_the_walk_covers_the_search_modules():
    assert {"redisson_tpu_torch.services.vector", "redisson_tpu_torch.services.search",
            "redisson_tpu_torch.net.resp"} <= set(_modules())


def test_the_walk_covers_the_server_modules():
    assert {"redisson_tpu_torch.server.server", "redisson_tpu_torch.server.verbs.sketch",
            "redisson_tpu_torch.server.verbs.keyspace", "redisson_tpu_torch.server.registry",
            "redisson_tpu_torch.net.client", "redisson_tpu_torch.net._native",
            "redisson_tpu_torch.tracking.table"} <= set(_modules())


def test_the_walk_covers_the_collection_modules():
    assert {"redisson_tpu_torch.utils.timer", "redisson_tpu_torch.client.objects.list",
            "redisson_tpu_torch.client.objects.queue", "redisson_tpu_torch.client.objects.set",
            "redisson_tpu_torch.client.objects.scoredsortedset", "redisson_tpu_torch.client.objects.multimap",
            "redisson_tpu_torch.client.objects.lock", "redisson_tpu_torch.client.objects.semaphore",
            "redisson_tpu_torch.client.objects.topic", "redisson_tpu_torch.client.objects.adder",
            "redisson_tpu_torch.client.objects.keys", "redisson_tpu_torch.server.verbs.collections",
            "redisson_tpu_torch.server.verbs.zset"} <= set(_modules())


@pytest.mark.parametrize("path", sorted(p for p in PKG.rglob("*") if p.suffix in (".py", ".cpp", ".cu", ".cuh")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_the_reference_native_directory(path):
    """The port builds its own copy of the RESP library
    (redisson_tpu_torch/native/resp.cpp into redisson_tpu_torch/_build/);
    nothing reaches the reference's native/ directory or its library."""
    text = path.read_text()
    for needle in ("native/build", "librtpu.so", "_REPO_ROOT", "../native", '"native", "build"'):
        assert needle not in text, f"{path}: {needle}"


def test_every_module_imports_with_jax_and_the_reference_blocked():
    script = f"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")) or name == "redisson_tpu" \\
                or name.startswith("redisson_tpu."):
            raise ImportError("blocked: " + name)
        return None

for mod in [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "redisson_tpu."))
            or m == "redisson_tpu"]:
    del sys.modules[mod]
sys.meta_path.insert(0, Block())
import importlib
for name in {_modules()!r} + ["chip_smoke"]:
    importlib.import_module(name)
leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "redisson_tpu"
          or m.startswith("redisson_tpu.")]
assert not leaked, leaked
print("ok", len({_modules()!r}))
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "redisson_tpu"), f"{path}: imports {name}"


def test_create_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        redisson_tpu_torch.create()
    with pytest.raises(RuntimeError):
        redisson_tpu_torch.create(device="cuda:0")
    assert redisson_tpu_torch.create(device="cpu").engine.device.type == "cpu"


def test_wrappers_refuse_other_devices():
    meta = torch.zeros(1024, dtype=torch.uint8, device="meta")
    lh = torch.zeros((2, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.bloom_contains_packed_bits(meta, lh, 10, 3, 1000)


def test_cpu_run_leaves_launch_counters_at_zero():
    K.reset_launches()
    c = redisson_tpu_torch.create(device="cpu")
    arr = c.get_bloom_filter_array("a")
    arr.try_init(4, 1000, 0.01)
    arr.add_flushes([(np.zeros(40, np.int32), np.arange(40))])
    arr.contains(np.zeros(40, np.int32), np.arange(40))
    h = c.get_hyper_log_log("h")
    h.add_all(["x", "y"])
    assert h.count() == 2
    bs = c.get_bit_set("bits")
    bs.set_each(np.arange(5))
    assert bs.get_each(np.arange(6)).tolist() == [1, 1, 1, 1, 1, 0]
    from redisson_tpu_torch.services import mapreduce as MR

    m = c.get_map("wc")
    m.put_all({"a": "x y x", "b": "y"})
    assert MR.word_count(m) == MR.word_count(m) == {"x": 2, "y": 2}
    kmr = MR.KernelMapReduce(lambda v: (v % 3, v), "sum", 3, device="cpu")
    assert kmr.execute(np.arange(6, dtype=np.int32)).tolist() == [3, 5, 7]
    svc = c.get_search()
    svc.create_index("v", {"emb": "VECTOR"}, vector={"emb": {"dim": 4, "algo": "IVF", "nlist": 2, "train_min": 8}})
    for i in range(12):
        svc.add_document("v", f"d{i}", {"emb": np.arange(4, dtype=np.float32) + i})
    dev, fin = svc.knn("v", "emb", np.ones(4, np.float32), 3)
    assert [d for d, _s in fin(dev)[0]] and svc._idx("v").vectors.banks["emb"].ivf_ready()
    assert K.launches == {"bloom_probe": 0, "bloom_set": 0, "bloom_add": 0, "hll_add": 0, "hll_rows": 0,
                          "bitset_get": 0, "bitset_set": 0, "wc_words": 0, "wc_sort_runs": 0,
                          "segment_reduce": 0, "knn_score": 0, "knn_select": 0, "ivf_score": 0,
                          "kmeans": 0}
