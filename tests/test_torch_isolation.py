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


def test_the_walk_covers_the_remote_modules():
    assert {"redisson_tpu_torch.net.safe_pickle", "redisson_tpu_torch.net.detectors",
            "redisson_tpu_torch.net.retry", "redisson_tpu_torch.client.remote",
            "redisson_tpu_torch.client.aio", "redisson_tpu_torch.tracking.nearcache",
            "redisson_tpu_torch.services.transactions",
            "redisson_tpu_torch.server.verbs.objcall_tx"} <= set(_modules())


def test_the_walk_covers_the_services_modules():
    assert {"redisson_tpu_torch.client.objects.stream", "redisson_tpu_torch.client.objects.geo",
            "redisson_tpu_torch.client.objects.timeseries", "redisson_tpu_torch.client.objects.binarystream",
            "redisson_tpu_torch.server.verbs.streamgeo", "redisson_tpu_torch.server.verbs.modules",
            "redisson_tpu_torch.server.verbs.admin", "redisson_tpu_torch.services.script",
            "redisson_tpu_torch.services.liveobject", "redisson_tpu_torch.services.remote",
            "redisson_tpu_torch.services.elements", "redisson_tpu_torch.services.executor",
            "redisson_tpu_torch.node"} <= set(_modules())


def test_the_walk_covers_the_cluster_modules():
    assert {"redisson_tpu_torch.cluster", "redisson_tpu_torch.cluster.topology",
            "redisson_tpu_torch.cluster.supervisor", "redisson_tpu_torch.cluster.hostdriver",
            "redisson_tpu_torch.harness", "redisson_tpu_torch.client.cluster",
            "redisson_tpu_torch.client.routing", "redisson_tpu_torch.client.replicated",
            "redisson_tpu_torch.net.balancer", "redisson_tpu_torch.net.dns",
            "redisson_tpu_torch.config"} <= set(_modules())


def test_the_walk_covers_the_cache_and_codec_modules():
    assert {"redisson_tpu_torch.graft_entry", "redisson_tpu_torch.client.jcache",
            "redisson_tpu_torch.client.objects.localcache", "redisson_tpu_torch.utils.lz4block",
            "redisson_tpu_torch.client.codec"} <= set(_modules())


_BLOCKER = """
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
"""


def test_a_reply_naming_the_reference_loads_through_the_port_unpickler():
    """A reference client's codec frame and a reference server's E reply
    name redisson_tpu classes; with redisson_tpu and jax unimportable the
    port's unpickler binds them to the port's classes."""
    import pickle

    from redisson_tpu.client.codec import JsonCodec, StringCodec
    from redisson_tpu.net.resp import RespError

    blob = pickle.dumps([JsonCodec(), ("E", RespError("ERR x")), StringCodec()])
    assert b"redisson_tpu.client.codec" in blob
    script = _BLOCKER + f"""
from redisson_tpu_torch.client import codec
from redisson_tpu_torch.net import resp
from redisson_tpu_torch.net.safe_pickle import safe_loads
got = safe_loads(bytes.fromhex({blob.hex()!r}))
assert type(got[0]) is codec.JsonCodec and type(got[2]) is codec.StringCodec, got
assert type(got[1][1]) is resp.RespError and got[1][1].args == ("ERR x",), got
assert not [m for m in sys.modules if m == "redisson_tpu" or m.startswith("redisson_tpu.")]
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_a_reference_stored_handle_resolves_to_a_port_handle():
    """A map value the reference stored as a handle reference names the
    reference's module path; with redisson_tpu and jax unimportable the
    port's codec binds it to the port's class of the same path."""
    import redisson_tpu

    ref = redisson_tpu.create()
    try:
        inner = ref.get_list("iso:inner")
        ref.get_map("iso:outer").put("l", inner)
        raw = next(iter(ref.engine.store.get("iso:outer").host.values()))
    finally:
        ref.shutdown()
    assert b"redisson_tpu.client.objects.list" in raw
    script = _BLOCKER + f"""
import redisson_tpu_torch
c = redisson_tpu_torch.create(device="cpu")
c.get_list("iso:inner").add("x")
got = c.get_map("iso:outer")._codec.decode_map_value(bytes.fromhex({raw.hex()!r}))
assert type(got).__module__ == "redisson_tpu_torch.client.objects.list", type(got)
assert got.read_all() == ["x"]
c.shutdown()
assert not [m for m in sys.modules if m == "redisson_tpu" or m.startswith(("redisson_tpu.", "jax"))]
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


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


def test_the_node_help_runs_with_jax_and_the_reference_blocked():
    """``python -m redisson_tpu_torch.node --help`` with jax and redisson_tpu
    unimportable."""
    script = _BLOCKER + """
import runpy
sys.argv = ["redisson_tpu_torch.node", "--help"]
try:
    runpy.run_module("redisson_tpu_torch.node", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert not [m for m in sys.modules if m == "redisson_tpu" or m.startswith(("redisson_tpu.", "jax"))]
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--executors" in out.stdout and "--workers" in out.stdout


def test_an_executor_task_pickles_and_unpickles_with_jax_and_the_reference_blocked():
    """A port coordinator's task payloads (MapReduce's mapper and word
    count's chunk task, inject_client's marker kept) round-trip through
    pickle, and run, with jax and redisson_tpu unimportable."""
    script = _BLOCKER + """
import pickle
import redisson_tpu_torch
from redisson_tpu_torch.services import mapreduce as MR
from redisson_tpu_torch.services.executor import inject_client

payload = pickle.dumps((MR._wc_chunk_task, ("wc", ["a", "b"], None), {}))
fn, args, kwargs = pickle.loads(payload)
assert fn is MR._wc_chunk_task and fn._inject_client, fn
c = redisson_tpu_torch.create(device="cpu")
c.get_map("wc").put_all({"a": "x y x", "b": "y"})
assert fn(*args, client=c, **kwargs) == {"x": 2, "y": 2}
ex = c.get_executor_service("iso")
ex.register_workers(1)
assert ex.submit(MR._host_word_count, ["p q p"]).get(30) == {"p": 2, "q": 1}
c.shutdown()
assert not [m for m in sys.modules if m == "redisson_tpu" or m.startswith(("redisson_tpu.", "jax"))]
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
