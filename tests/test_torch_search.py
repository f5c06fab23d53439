"""The search service and its vector banks, on both packages, on the CPU.

Each case of the reference's embedded ``svc`` suite
(tests/test_vector_search.py) runs on a ``redisson_tpu`` SearchService and
on a ``redisson_tpu_torch`` one (device="cpu": the kernels' plain
versions), keeps the reference test's own assertions on both, and holds the
two packages' replies equal: doc ids and scores byte for byte (the scores
come from the same per-pair NumPy routine over the same mirror, so they are
the same bits whichever path chose the rows).

IVF cases compare replies on the same installed index: the reference trains
its coarse quantizer (XLA:CPU's kmeans_step), and the port installs those
centroids and assignments before its queries, since the two packages'
k-means may differ in the last bits (tests/test_torch_vector.py holds
kmeans_step itself to its tolerance).  Each package's own training is
exercised by the recall assertions, which both must meet.
"""
import threading

import numpy as np
import pytest
import torch

from redisson_tpu.core.engine import Engine as REngine
from redisson_tpu.services import search as RS
from redisson_tpu.services import vector as RV
from redisson_tpu_torch.core.engine import Engine
from redisson_tpu_torch.services import search as S
from redisson_tpu_torch.services import vector as V


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _force(dev, finish):
    if dev is None:
        return finish(None)
    return finish(tuple(_host(v) for v in dev))


class Pkg:
    """One package's search surface."""

    def __init__(self, name, svc, vmod, smod, prepare):
        self.name, self.svc, self.V, self.S, self.prepare = name, svc, vmod, smod, prepare


def _snapshot(bank):
    ivf = bank._ivf
    return (ivf.centroids.copy(), ivf.assign.copy(), ivf.trained_rows, ivf.trains)


def _install(bank, snap):
    cent, assign, trained, trains = snap
    ivf = bank._ivf
    ivf.centroids, ivf.assign = cent.copy(), assign.copy()
    ivf.trained_rows, ivf.trains = trained, trains
    ivf.dirty_rows.clear()
    ivf.cells, ivf.cells_stale = None, True


def _run_both(scenario, *args):
    """Run `scenario(pkg, *args)` on the reference (training its IVF banks
    at each prepare) and then on the port (installing the reference's index
    at the same prepares); return both results."""
    snaps = []

    def ref_prepare(bank):
        bank.retrain()
        snaps.append(_snapshot(bank))

    it = iter(snaps)

    def port_prepare(bank):
        _install(bank, next(it))

    ref = scenario(Pkg("ref", RS.SearchService(REngine()), RV, RS, ref_prepare), *args)
    port = scenario(Pkg("port", S.SearchService(Engine(device="cpu")), V, S, port_prepare), *args)
    return ref, port


def _same(scenario, *args):
    ref, port = _run_both(scenario, *args)
    assert port == ref
    return port


def _mk_index(p, name="vi", n=40, dim=8, metric="L2", seed=0):
    p.svc.create_index(
        name, {"price": "NUMERIC", "emb": "VECTOR"},
        vector={"emb": {"dim": dim, "metric": metric}},
    )
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    for i in range(n):
        p.svc.add_document(name, f"d{i}", {"price": i, "emb": vecs[i]})
    return vecs


def _disarmed(p, *args, **kw):
    prev = p.V.set_vector(False)
    try:
        dev, fin = p.svc.knn(*args, **kw)
        assert dev is None
        return fin(None)
    finally:
        p.V.set_vector(prev)


# -- FLAT (tests/test_vector_search.py:72-199) --------------------------------


def _knn_exact(p, metric):
    vecs = _mk_index(p, metric=metric, n=60, dim=12, seed=3)
    q = np.random.default_rng(7).standard_normal(12).astype(np.float32)
    res = _force(*p.svc.knn("vi", "emb", q, 10))[0]
    dots = vecs @ q
    if metric == "L2":
        dist = np.sum((vecs - q[None, :]) ** 2, axis=1)
    elif metric == "COSINE":
        dist = 1 - dots / (np.linalg.norm(vecs, axis=1) * np.linalg.norm(q))
    else:
        dist = 1 - dots
    assert [d for d, _s in res] == [f"d{i}" for i in np.argsort(dist, kind="stable")[:10]]
    return res


@pytest.mark.parametrize("metric", ["L2", "COSINE", "IP"])
def test_knn_exact_vs_bruteforce(metric):
    _same(_knn_exact, metric)


def _armed_disarmed_ordering(p):
    _mk_index(p, n=50, dim=16, metric="COSINE", seed=5)
    q = np.random.default_rng(9).standard_normal(16).astype(np.float32)
    armed = _force(*p.svc.knn("vi", "emb", q, 8))
    disarmed = _disarmed(p, "vi", "emb", q, 8)
    assert armed == disarmed
    return armed


def test_armed_disarmed_identical_ordering():
    _same(_armed_disarmed_ordering)


def _hybrid(p):
    _mk_index(p, n=40, dim=8, seed=1)
    q = np.random.default_rng(2).standard_normal(8).astype(np.float32)
    res = _force(*p.svc.knn("vi", "emb", q, 10, condition=p.S.Range("price", hi=9.5)))[0]
    assert res and all(int(d[1:]) <= 9 for d, _s in res)
    dev, fin = p.svc.knn("vi", "emb", q, 5, condition=p.S.Range("price", lo=1e9))
    assert dev is None and fin(None) == [[]]
    return res


def test_hybrid_prefilter_masks_scores():
    _same(_hybrid)


def _update_delete(p):
    vecs = _mk_index(p, n=20, dim=8, seed=4)
    target = vecs[3] + 0.001
    out = [_force(*p.svc.knn("vi", "emb", target, 1))[0]]
    assert out[0][0][0] == "d3"
    p.svc.add_document("vi", "d3", {"price": 3, "emb": vecs[3] + 100.0})
    out.append(_force(*p.svc.knn("vi", "emb", target, 1))[0])
    winner = out[-1][0][0]
    assert winner != "d3"
    p.svc.remove_document("vi", winner)
    out.append(_force(*p.svc.knn("vi", "emb", target, 20))[0])
    assert winner not in [d for d, _s in out[-1]]
    return out


def test_update_and_delete_move_vectors():
    _same(_update_delete)


def _schema_validation(p):
    for bad in ({"dim": 4, "metric": "HAMMING"}, {"dim": 0}):
        with pytest.raises(ValueError):
            p.svc.create_index("bad", {"emb": "VECTOR"}, vector={"emb": bad})
    with pytest.raises(ValueError):
        p.svc.create_index("bad2", {"emb": "VECTOR"}, vector={})
    p.svc.create_index("ok", {"t": "TEXT", "emb": "VECTOR"}, vector={"emb": {"dim": 4}})
    p.svc.add_document("ok", "d0", {"t": "hello", "emb": b"tooshort"})
    assert p.svc.search("ok", None).total == 1
    res = _force(*p.svc.knn("ok", "emb", np.ones(4, np.float32), 3))
    assert res == [[]]
    return res, p.svc.index_names()


def test_vector_schema_validation():
    _same(_schema_validation)


def _block_append(p):
    p.svc.create_index("tb", {"price": "NUMERIC", "emb": "VECTOR"}, vector={"emb": {"dim": 4}})
    idx = p.svc._idx("tb")
    n = p.V.DEFAULT_BLOCK * 3 + 17
    rng = np.random.default_rng(0)
    for i in range(n):
        p.svc.add_document("tb", f"d{i}", {"price": i, "emb": rng.standard_normal(4).astype(np.float32)})
    bank = idx.vectors.banks["emb"]
    counts = [bank.h2d_flushes]
    assert counts[0] == 3
    res = _force(*p.svc.knn("tb", "emb", np.ones(4, np.float32), 5))
    counts.append(bank.h2d_flushes)
    assert counts[1] == 4
    assert idx._numeric.h2d_flushes <= 4
    ids = idx._eval(p.S.Range("price", lo=n - 10))
    assert len(ids) == 10 and idx._numeric.h2d_flushes <= 5
    assert bank.grows == 2  # 256 -> 512 -> 1024 rows, each a copy on the device
    return counts, idx._numeric.h2d_flushes, sorted(ids), res


def test_block_append_transfer_counts():
    _same(_block_append)


def _numeric_plane(p):
    p.svc.create_index("np1", {"x": "NUMERIC"})
    for i in range(10):
        p.svc.add_document("np1", f"d{i}", {"x": i})
    first = p.svc._idx("np1")._eval(p.S.Range("x", lo=3, hi=6))
    assert first == {f"d{i}" for i in range(3, 7)}
    p.svc.add_document("np1", "d4", {"x": None})
    p.svc.remove_document("np1", "d5")
    after = p.svc._idx("np1")._eval(p.S.Range("x", lo=3, hi=6))
    assert after == {"d3", "d6"}
    excl = p.svc._idx("np1")._eval(p.S.Range("x", lo=3, hi=6, lo_inc=False, hi_inc=False))
    return sorted(first), sorted(after), sorted(excl)


def test_numeric_plane_incremental_and_correct():
    _same(_numeric_plane)


def _alter(p):
    _mk_index(p, n=10, dim=8, seed=6)
    p.svc.alter("vi", "tag", "TAG")
    assert p.svc._idx("vi").schema["tag"] == "TAG"
    q = np.random.default_rng(1).standard_normal(8).astype(np.float32)
    res = _force(*p.svc.knn("vi", "emb", q, 3))[0]
    assert len(res) == 3
    return res


def test_alter_preserves_vector_fields():
    _same(_alter)


def _census(p):
    _mk_index(p, n=8, dim=8)
    rec = p.svc._engine.store.get(p.V.bank_record_name("vi", "emb"))
    assert rec is not None and rec.kind == "vector_bank"
    out = [p.svc.device_census()]
    _force(*p.svc.knn("vi", "emb", np.ones(8, np.float32), 2))
    out.append(p.svc.device_census())
    assert out[-1]["ftvec_device_bytes"] > 0
    assert p.svc.drop_index("vi")
    assert p.svc._engine.store.get(p.V.bank_record_name("vi", "emb")) is None
    out.append(p.svc.device_census())
    assert out[-1] == {"ftvec_banks": 0.0, "ftvec_device_bytes": 0.0, "ftvec_index_bytes": 0.0}
    return out


def test_bank_record_and_census():
    _same(_census)


def test_shards_raise_not_implemented():
    """SHARDS n > 1 builds the sharded bank (it raised NotImplementedError
    before the sharded banks were ported); SHARDS 1 the plain one, SHARDS 0
    a ValueError (tests/test_torch_vector_sharded.py holds their replies)."""
    svc = S.SearchService(Engine(device="cpu"))
    svc.create_index("sh", {"emb": "VECTOR"}, vector={"emb": {"dim": 4, "shards": 2}})
    bank = svc._idx("sh").vectors.banks["emb"]
    assert isinstance(bank, V.ShardedEmbeddingBank) and len(bank.shards) == 2
    svc.create_index("s1", {"emb": "VECTOR"}, vector={"emb": {"dim": 4, "shards": 1}})
    assert not isinstance(svc._idx("s1").vectors.banks["emb"], V.ShardedEmbeddingBank)
    with pytest.raises(ValueError, match="SHARDS"):
        svc.create_index("s0", {"emb": "VECTOR"}, vector={"emb": {"dim": 4, "shards": 0}})
    assert svc.index_names() == ["s1", "sh"]


# -- IVF and compressed banks (tests/test_vector_search.py:660-877) ----------


def _clustered(n, dim, n_clusters, seed, spread=0.25):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    vecs = (centers[rng.integers(n_clusters, size=n)] + spread * rng.standard_normal((n, dim))).astype(np.float32)
    return vecs, rng


def _ingest(p, name, spec, vecs):
    p.svc.create_index(name, {"emb": "VECTOR"}, vector={"emb": spec})
    for i, v in enumerate(vecs):
        p.svc.add_document(name, f"d{i}", {"emb": v})
    return p.svc._idx(name).vectors.banks["emb"]


def _recall(got, vecs, queries, k):
    d64 = np.sum((vecs.astype(np.float64)[None, :, :] - queries.astype(np.float64)[:, None, :]) ** 2, axis=2)
    hits = 0
    for qi in range(queries.shape[0]):
        truth = set(np.argsort(d64[qi], kind="stable")[:k].tolist())
        hits += len(truth & {int(doc[1:]) for doc, _s in got[qi][:k]})
    return hits / (k * queries.shape[0])


def _ivf_clustered(p, own_training):
    vecs, rng = _clustered(1200, 16, 12, seed=9)
    bank = _ingest(p, "ivc", {"dim": 16, "metric": "L2", "algo": "IVF", "nlist": 12, "nprobe": 3,
                              "train_min": 256}, vecs)
    if not own_training:
        p.prepare(bank)
    queries = (vecs[rng.integers(1200, size=16)] + 0.05 * rng.standard_normal((16, 16))).astype(np.float32)
    got = [_force(*p.svc.knn("ivc", "emb", queries, 10, nprobe=n)) for n in (None, 6, 12)]
    r_small, r_more, r_all = (_recall(g, vecs, queries, 10) for g in got)
    assert r_small >= 0.9 and r_more >= r_small - 1e-9 and r_all == 1.0, (p.name, r_small, r_more, r_all)
    return got


def test_ivf_recall_clustered_vs_oracle():
    """Each package trains its own quantizer and meets the reference's
    recall bounds; on the reference's installed index the replies agree."""
    _run_both(_ivf_clustered, True)
    _same(_ivf_clustered, False)


def _ivf_uniform(p, own_training):
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((1000, 32)).astype(np.float32)
    bank = _ingest(p, "ivu", {"dim": 32, "metric": "L2", "algo": "IVF", "nlist": 10, "nprobe": 2,
                              "train_min": 200}, vecs)
    if not own_training:
        p.prepare(bank)
    queries = rng.standard_normal((16, 32)).astype(np.float32)
    got = [_force(*p.svc.knn("ivu", "emb", queries, 10, nprobe=n)) for n in (2, 5, 10)]
    r2, r5, r10 = (_recall(g, vecs, queries, 10) for g in got)
    assert r2 <= r5 + 1e-9 <= r10 + 2e-9 and r10 == 1.0 and r2 < 1.0, (p.name, r2, r5, r10)
    return got


def test_ivf_recall_adversarial_uniform():
    _run_both(_ivf_uniform, True)
    _same(_ivf_uniform, False)


def _all_cells(p, algo, dtype):
    vecs, rng = _clustered(700, 12, 8, seed=21)
    spec = {"dim": 12, "metric": "L2", "algo": algo, "dtype": dtype}
    if algo == "IVF":
        spec.update(nlist=8, nprobe=3, train_min=128)
    bank = _ingest(p, "cell", spec, vecs)
    if algo == "IVF":
        p.prepare(bank)
    queries = (vecs[rng.integers(700, size=5)] + 0.03 * rng.standard_normal((5, 12))).astype(np.float32)
    armed = _force(*p.svc.knn("cell", "emb", queries, 7))
    assert armed == _disarmed(p, "cell", "emb", queries, 7)
    p.svc.drop_index("cell")
    return armed


@pytest.mark.parametrize("algo", ["FLAT", "IVF"])
@pytest.mark.parametrize("dtype", ["FLOAT32", "FLOAT16", "INT8"])
def test_armed_disarmed_identical_all_cells(algo, dtype):
    _same(_all_cells, algo, dtype)


def _quantized(p, dtype):
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((600, 32)).astype(np.float32)
    bank = _ingest(p, "qb", {"dim": 32, "metric": "L2", "dtype": dtype}, vecs)
    _force(*p.svc.knn("qb", "emb", vecs[0], 1))
    ratio = bank.device_bytes() / bank.logical_f32_bytes()
    assert ratio <= (0.6 if dtype == "FLOAT16" else 0.35), ratio
    target = vecs[3] + 0.001
    out = [_force(*p.svc.knn("qb", "emb", target, 1))[0]]
    assert out[0][0][0] == "d3"
    p.svc.add_document("qb", "d3", {"emb": vecs[3] + 50.0})
    out.append(_force(*p.svc.knn("qb", "emb", target, 1))[0])
    winner = out[-1][0][0]
    assert winner != "d3"
    p.svc.remove_document("qb", winner)
    out.append(_force(*p.svc.knn("qb", "emb", target, 20))[0])
    assert winner not in [d for d, _s in out[-1]]
    got = _force(*p.svc.knn("qb", "emb", vecs[7], 1))[0][0]
    assert got[0] == "d7" and got[1] < 0.01
    p.svc.drop_index("qb")
    return out, got, ratio


@pytest.mark.parametrize("dtype", ["FLOAT16", "INT8"])
def test_quantized_bank_compression_and_updates(dtype):
    _same(_quantized, dtype)


def _int8_symmetric(p):
    p.svc.create_index("sc", {"emb": "VECTOR"}, vector={"emb": {"dim": 4, "dtype": "INT8"}})
    small = np.array([0.01, -0.02, 0.03, 0.015], np.float32)
    big = np.array([500.0, -800.0, 100.0, 250.0], np.float32)
    p.svc.add_document("sc", "small", {"emb": small})
    p.svc.add_document("sc", "big", {"emb": big})
    a = _force(*p.svc.knn("sc", "emb", small, 1))[0][0]
    assert a[0] == "small" and a[1] < 1e-4
    b = _force(*p.svc.knn("sc", "emb", big, 1))[0][0]
    assert b[0] == "big"
    return a, b


def test_int8_quantization_is_symmetric_per_row():
    _same(_int8_symmetric)


def _drift(p):
    vecs, rng = _clustered(1600, 12, 10, seed=31)
    bank = _ingest(p, "dr", {"dim": 12, "metric": "L2", "algo": "IVF", "nlist": 10, "nprobe": 4,
                             "train_min": 300}, vecs[:400])
    _force(*p.svc.knn("dr", "emb", vecs[0], 1))
    assert bank.ivf_ready() and bank._ivf.trains == 1
    t0 = bank._ivf.trained_rows
    for i in range(400, 1600):
        p.svc.add_document("dr", f"d{i}", {"emb": vecs[i]})
    queries = (vecs[rng.integers(400, 1600, size=12)] + 0.05 * rng.standard_normal((12, 12))).astype(np.float32)
    got = _force(*p.svc.knn("dr", "emb", queries, 10))
    assert bank._ivf.trains >= 2 and bank._ivf.trained_rows > t0
    assert _recall(got, vecs, queries, 10) >= 0.9
    # the replies on the reference's index, installed after the drift
    p.prepare(bank)
    return t0, bank._ivf.trained_rows, _force(*p.svc.knn("dr", "emb", queries, 10))


def test_ivf_centroid_retrain_on_growth_drift():
    ref, port = _run_both(_drift)
    assert port[:2] == ref[:2]  # the same training thresholds on both
    assert port[2] == ref[2]


def test_ivf_retrain_under_concurrent_ingest():
    """The port alone (its training races its own ingest): no exceptions,
    and the final index answers exactly like its own NumPy path."""
    p = Pkg("port", S.SearchService(Engine(device="cpu")), V, S, None)
    vecs, rng = _clustered(900, 8, 6, seed=41)
    _ingest(p, "cc", {"dim": 8, "metric": "L2", "algo": "IVF", "nlist": 6, "nprobe": 3, "train_min": 200},
            vecs[:250])
    errs, stop = [], threading.Event()

    def writer():
        try:
            for i in range(250, 900):
                p.svc.add_document("cc", f"d{i}", {"emb": vecs[i]})
                if stop.is_set():
                    return
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    def reader():
        try:
            while not stop.is_set():
                _force(*p.svc.knn("cc", "emb", vecs[int(rng.integers(250))], 5))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    w = threading.Thread(target=writer)
    rs = [threading.Thread(target=reader) for _ in range(2)]
    w.start()
    for t in rs:
        t.start()
    w.join(timeout=60)
    stop.set()
    for t in rs:
        t.join(timeout=30)
    assert not errs, errs
    bank = p.svc._idx("cc").vectors.banks["emb"]
    assert bank._ivf.trains >= 1
    queries = vecs[rng.integers(900, size=8)].astype(np.float32)
    assert _force(*p.svc.knn("cc", "emb", queries, 6)) == _disarmed(p, "cc", "emb", queries, 6)


def _ivf_in_record(p):
    vecs, _rng = _clustered(600, 8, 6, seed=51)
    bank = _ingest(p, "rec", {"dim": 8, "metric": "L2", "algo": "IVF", "nlist": 6, "nprobe": 2,
                              "train_min": 128}, vecs)
    p.prepare(bank)
    res = _force(*p.svc.knn("rec", "emb", vecs[0], 3))
    _force(*p.svc.knn("rec", "emb", vecs[1], 3))
    assert bank._ivf.index_uploads == 1  # an unchanged index is not uploaded again
    rec = p.svc._engine.store.get(p.V.bank_record_name("rec", "emb"))
    assert {"bank", "bias", "centroids", "cells"} <= set(rec.arrays)
    census = [p.svc.device_census()]
    assert census[0]["ftvec_index_bytes"] > 0
    assert p.svc.drop_index("rec")
    census.append(p.svc.device_census())
    assert census[-1]["ftvec_index_bytes"] == 0.0 and census[-1]["ftvec_device_bytes"] == 0.0
    return res, census


def test_ivf_index_lives_in_bank_record():
    _same(_ivf_in_record)


def _ivf_hybrid(p):
    vecs, rng = _clustered(800, 8, 6, seed=61)
    p.svc.create_index("hy", {"price": "NUMERIC", "emb": "VECTOR"},
                       vector={"emb": {"dim": 8, "metric": "L2", "algo": "IVF", "nlist": 6, "nprobe": 4,
                                       "train_min": 128}})
    for i, v in enumerate(vecs):
        p.svc.add_document("hy", f"d{i}", {"price": i, "emb": v})
    p.prepare(p.svc._idx("hy").vectors.banks["emb"])
    res = _force(*p.svc.knn("hy", "emb", vecs[5], 10, condition=p.S.Range("price", hi=99.5)))[0]
    assert res and all(int(d[1:]) <= 99 for d, _s in res)
    return res


def test_ivf_hybrid_prefilter_masks():
    _same(_ivf_hybrid)


def test_get_search_is_one_service_per_engine():
    import redisson_tpu_torch

    c = redisson_tpu_torch.create(device="cpu")
    assert c.get_search() is c.get_search()
    assert isinstance(c.get_search(), S.SearchService)


# -- budget, OOM, live knobs, record resync ------------------------------------


def _budget(p):
    rng = np.random.default_rng(41)
    n, dim = 600, 16
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    cap = 1 << (n - 1).bit_length()
    prev = p.V.set_device_bytes_budget(p.V.DeviceRowBank(dim)._projected_device_bytes(cap) // 2)
    try:
        p.svc.create_index("cap1", {"emb": "VECTOR"}, vector={"emb": {"dim": dim, "metric": "L2"}})
        with pytest.raises(p.V.VectorBudgetError) as err:
            for i in range(n):
                p.svc.add_document("cap1", f"d{i}", {"emb": vecs[i]})
            _force(*p.svc.knn("cap1", "emb", vecs[0], 1))
        bank = p.svc._idx("cap1").vectors.banks["emb"]
        pending = bank.pending_count()
        assert pending > 0  # refused rows stay pending: nothing acked is lost
    finally:
        p.V.set_device_bytes_budget(prev)
    res = _force(*p.svc.knn("cap1", "emb", vecs[7], 1))  # the budget lifted, the rows flush
    assert res[0][0][0] == "d7" and bank.pending_count() == 0
    return str(err.value).split(";")[0], pending, res  # the reference also suggests SHARDS


def test_device_bytes_budget_refuses_growth_and_keeps_rows():
    _same(_budget)


def test_device_oom_maps_to_the_oom_reply(monkeypatch):
    """torch.cuda.OutOfMemoryError growing a bank raises DeviceOomError (a
    RespError with the reference's fixed -OOM message), rows kept pending."""
    from redisson_tpu_torch.net.resp import RespError

    svc = S.SearchService(Engine(device="cpu"))
    svc.create_index("oom", {"emb": "VECTOR"}, vector={"emb": {"dim": 4}})
    svc.add_document("oom", "d0", {"emb": np.ones(4, np.float32)})
    real = torch.zeros

    def refuse(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(V.torch, "zeros", refuse)
    with pytest.raises(V.DeviceOomError) as err:
        svc.knn("oom", "emb", np.ones(4, np.float32), 1)
    assert isinstance(err.value, RespError) and err.value.code == "OOM"
    assert str(err.value) == str(RV.DeviceOomError(V.bank_record_name("oom", "emb")))
    assert svc._idx("oom").vectors.banks["emb"].pending_count() == 1
    monkeypatch.setattr(V.torch, "zeros", real)
    assert _force(*svc.knn("oom", "emb", np.ones(4, np.float32), 1)) == [[("d0", 0.0)]]


def _knobs(p):
    vecs, _rng = _clustered(480, 8, 6, seed=51)
    bank = _ingest(p, "knob", {"dim": 8, "metric": "L2", "algo": "IVF", "nlist": 6, "nprobe": 3,
                               "train_min": 128}, vecs)
    p.prepare(bank)
    out = [_force(*p.svc.knn("knob", "emb", vecs[0], 3)), bank._ivf.cell_cap]
    prev = p.V.set_ivf_cell_cap_max(8)
    try:
        bank._ivf.cells_stale = True
        out += [_force(*p.svc.knn("knob", "emb", vecs[0], 3)), bank._ivf.cell_cap]
    finally:
        p.V.set_ivf_cell_cap_max(prev)
    prev = p.V.set_ivf_cell_imbalance(8.0)
    try:
        bank._ivf.cells_stale = True
        out += [_force(*p.svc.knn("knob", "emb", vecs[0], 3)), bank._ivf.cell_cap]
    finally:
        p.V.set_ivf_cell_imbalance(prev)
    assert out[3] == 8 < out[1] < out[5]
    return out


def test_ivf_gather_knobs_are_live():
    _same(_knobs)


def _resync(p):
    vecs = _mk_index(p, n=30, dim=8, seed=8)
    bank = p.svc._idx("vi").vectors.banks["emb"]
    before = _force(*p.svc.knn("vi", "emb", vecs[2], 3))
    rec = p.svc._engine.store.get(bank.name)
    # a record replaced behind the bank (as a replication full-ship does):
    # row 2 now holds row 5's vector
    planes = rec.arrays["bank"]
    rec.arrays["bank"] = _swap_row(planes, 2, 5)
    assert p.V.sync_banks_from_records(p.svc._engine, [bank.name]) == 1
    after = _force(*p.svc.knn("vi", "emb", vecs[5], 2))
    assert {d for d, _s in after[0]} == {"d2", "d5"}
    return before, after


def _swap_row(planes, dst, src):
    if isinstance(planes, torch.Tensor):
        out = planes.clone()
        out[dst] = planes[src]
        return out
    return planes.at[dst].set(planes[src])


def test_sync_banks_from_records_adopts_replaced_state():
    p_engine = Engine(device="cpu")
    svc = p_engine.service("search", lambda: S.SearchService(p_engine))
    r_engine = REngine()
    rsvc = r_engine.service("search", lambda: RS.SearchService(r_engine))
    got = _resync(Pkg("port", svc, V, S, None))
    want = _resync(Pkg("ref", rsvc, RV, RS, None))
    assert got == want
