"""The port's sharded vector banks (``services/vector.ShardedEmbeddingBank``)
and K19 (``kernels.knn_sharded_merge``) against the reference's, on the CPU.

  * K19: the reference's ``knn_sharded_merge`` jitted on JAX's CPU against
    the port's (the plain version on the CPU), on seeded inputs of 64
    queries, 1 to 8 legs of k_s 10, with ties across legs, +inf dead rows
    and -0.0 against +0.0.  Tolerance: none, bit for bit.
  * Shard record names (stored state) equal the reference's, with placement
    off and with 8 positions.
  * FT.CREATE ... SHARDS 4 and 8 on a ``devices=8`` port server and on a
    reference server, FLAT and IVF over FLOAT32, FLOAT16 and INT8, then
    FT.SEARCH (with and without a prefilter), FT.MSEARCH and FT.INFO, in
    RESP2 and RESP3: every reply's bytes equal the reference's but the KNN
    replies', which are held to ``wire_stream.knn_agree`` (scores within
    ``KNN_TIE``, near-tied ids as sets); each package's replies with the
    device path off (``set_vector(False)``) are its armed bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu.client.redisson import RedissonTpu as RefRedissonTpu
from redisson_tpu.core import kernels as RK
from redisson_tpu.core.engine import Engine as RefEngine
from redisson_tpu.server.server import ServerThread as RefServerThread
from redisson_tpu.services import vector as RV
from redisson_tpu_torch.client.redisson import RedissonTpu
from redisson_tpu_torch.core import kernels as K
from redisson_tpu_torch.core.engine import Engine
from redisson_tpu_torch.parallel import mesh as M
from redisson_tpu_torch.server import ServerThread
from redisson_tpu_torch.services import vector as V
from redisson_tpu_torch.tools import wire_stream as W

_ref_merge = jax.jit(RK.knn_sharded_merge, static_argnums=(3,))


def _legs(n_legs: int, case: str, seed: int, q: int = 64, ks: int = 10):
    rng = np.random.default_rng(seed)
    dists = []
    for _ in range(n_legs):
        d = rng.standard_normal((q, ks)).astype(np.float32)
        if case == "ties":
            d = (np.round(d * 2) / 2).astype(np.float32)  # equal distances across legs
        elif case == "inf":
            d[rng.random(d.shape) < 0.4] = np.inf        # dead rows
        elif case == "zeros":
            m = rng.random(d.shape)
            d[m < 0.3] = 0.0
            d[(m >= 0.3) & (m < 0.6)] = -0.0
        dists.append(np.sort(d, axis=1, kind="stable"))  # a leg is its shard's sorted top-k
    idxs = [rng.integers(0, 5000, (q, ks)).astype(np.int32) for _ in range(n_legs)]
    sop = np.concatenate([np.full(ks, s, np.int32) for s in range(n_legs)])
    return dists, idxs, sop


@pytest.mark.parametrize("case", ["random", "ties", "inf", "zeros"])
@pytest.mark.parametrize("n_legs", range(1, 9))
def test_k19_matches_the_reference_bit_for_bit(n_legs, case):
    dists, idxs, sop = _legs(n_legs, case, seed=19 * n_legs + len(case))
    for k in sorted({1, 5, 10, 40, 80}):
        k_out = max(1, min(k, 10 * n_legs))  # k above the legs' total: all of them
        want = _ref_merge(tuple(map(jnp.asarray, dists)), tuple(map(jnp.asarray, idxs)),
                          jnp.asarray(sop), k_out)
        got = K.knn_sharded_merge(tuple(map(torch.from_numpy, dists)),
                                  tuple(map(torch.from_numpy, idxs)), torch.from_numpy(sop), k_out)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and g.shape == w.shape
            assert g.numpy().tobytes() == w.tobytes(), (n_legs, case, k)


def test_k19_plain_is_the_wrapper_on_the_cpu():
    dists, idxs, sop = _legs(5, "ties", seed=3)
    args = (tuple(map(torch.from_numpy, dists)), tuple(map(torch.from_numpy, idxs)),
            torch.from_numpy(sop), 17)
    for a, b in zip(K.knn_sharded_merge(*args), K.knn_sharded_merge_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("placed", [False, True], ids=["placement-off", "8-positions"])
def test_shard_record_names_equal_the_reference(placed):
    ref, port = RefEngine(), Engine(device="cpu")
    if placed:
        ref.enable_placement()
        port.enable_placement(devices=M.local_devices("cpu", 8))
    try:
        for index, field, n in (("idx", "emb", 4), ("docs", "v", 8), ("a{b}", "e", 3), ("z", "w", 12)):
            got = V.pick_shard_record_names(port, index, field, n)
            assert got == RV.pick_shard_record_names(ref, index, field, n)
            assert len(set(got)) == n
            if placed and "{" not in index:  # a hashtag in the index name pins every shard
                owners = [port.placement.device_id_for_name(nm) for nm in got]
                assert len(set(owners)) == min(n, 8)
    finally:
        ref.shutdown()
        port.shutdown()


def _vectors(seed: int, n: int = 240, dim: int = 12, clusters: int = 8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    vecs = (centers[rng.integers(clusters, size=n)]
            + 0.25 * rng.standard_normal((n, dim))).astype(np.float32)
    return vecs, rng


def _stream(algo: str, dtype: str, shards: int):
    index = f"s{shards}{algo}{dtype}".lower()
    prefix = index + ":"
    vecs, rng = _vectors(seed=shards * 10 + len(dtype) + len(algo))
    dim = vecs.shape[1]
    attrs = ["TYPE", dtype, "DIM", str(dim), "DISTANCE_METRIC", "L2", "SHARDS", str(shards)]
    if algo == "IVF":
        attrs += ["NLIST", "6", "NPROBE", "3", "TRAIN_MIN", "24"]  # 30 rows a shard at 8
    setup = [("FT.CREATE", index, "ON", "HASH", "PREFIX", "1", prefix, "SCHEMA",
              "price", "NUMERIC", "emb", "VECTOR", algo, str(len(attrs)), *attrs)]
    setup += [("HSET", f"{prefix}{i}", "price", str(i), "emb", W.f32_blob(v))
              for i, v in enumerate(vecs)]
    qs = (vecs[rng.integers(len(vecs), size=4)]
          + 0.03 * rng.standard_normal((4, dim))).astype(np.float32)
    queries = [("FT.SEARCH", index, "(*)=>[KNN 7 @emb $v]", "PARAMS", "2", "v", W.f32_blob(qs[0])),
               ("FT.SEARCH", index, "(@price:[2 150])=>[KNN 6 @emb $v]", "PARAMS", "2", "v",
                W.f32_blob(qs[1])),
               ("FT.MSEARCH", index, "(*)=>[KNN 5 @emb $v]", "PARAMS", "2", "v", W.f32_blob(qs)),
               ("FT.MSEARCH", index, "(*)=>[KNN 40 @emb $v]", "PARAMS", "2", "v", W.f32_blob(qs[2:])),
               ("FT.INFO", index)]
    return index, setup, queries


def _serve(st, facade, setup, waves, index, train_from=None):
    W.replies(st.server.host, st.server.port, [setup])
    search = facade(st.server.engine).get_search()
    if train_from is not None:
        W.train_ivf(train_from, search, index)
    armed = W.replies(st.server.host, st.server.port, waves)
    return search, armed


@pytest.mark.parametrize("dtype", ["FLOAT32", "FLOAT16", "INT8"])
@pytest.mark.parametrize("algo", ["FLAT", "IVF"])
@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_search_replies_equal_the_reference(shards, algo, dtype):
    index, setup, queries = _stream(algo, dtype, shards)
    waves = [queries, [("HELLO", "3")] + queries]
    with RefServerThread(port=0, devices="all", workers=4) as rs, \
            ServerThread(port=0, device="cpu", devices=8, workers=4) as ps:
        W.replies(rs.server.host, rs.server.port, [setup])
        ref_search = RefRedissonTpu(rs.server.engine).get_search()
        ref_search.sync(index)
        _search, got = _serve(ps, RedissonTpu, setup, waves, index,
                              train_from=ref_search if algo == "IVF" else None)
        want = W.replies(rs.server.host, rs.server.port, waves)
        bank = _search._idx(index).vectors.banks["emb"]
        assert isinstance(bank, V.ShardedEmbeddingBank) and len(bank.shards) == shards
        runs = {}
        for name, st, mod in (("ref", rs, RV), ("port", ps, V)):
            prev = mod.set_vector(False)
            try:
                runs[name] = W.replies(st.server.host, st.server.port, waves)
            finally:
                mod.set_vector(prev)
    for cmds, (graw, g), (wraw, w) in zip(waves, got, want):
        assert W.compare(cmds, g, w) == []
        spans_g, spans_w = W.reply_spans(graw), W.reply_spans(wraw)
        differ = {W._verb(cmds[i]) for i, (a, b) in enumerate(zip(spans_g, spans_w)) if a != b}
        assert differ <= {b"FT.SEARCH", b"FT.MSEARCH"}, differ
        info = g[-1]
        attr = [r for r in info[info.index(b"attributes") + 1] if r[0] == b"emb"][0]
        shard_rows = attr[attr.index(b"shard_rows") + 1]
        assert len(shard_rows) == shards and sum(r[3] for r in shard_rows) == 240
        assert len({r[5] for r in shard_rows}) == shards  # one position a shard
        if algo == "IVF":
            assert attr[attr.index(b"trained") + 1] == 1
    # the device path off gives each package's armed bytes (less HELLO's
    # reply, which holds the connection's id)
    for name, armed in (("port", got), ("ref", want)):
        for cmds, (raw_off, _), (raw_on, _) in zip(waves, runs[name], armed):
            off, on = W.reply_spans(raw_off), W.reply_spans(raw_on)
            keep = [i for i, c in enumerate(cmds) if c[0] != "HELLO"]
            assert [off[i] for i in keep] == [on[i] for i in keep], name


def test_sharded_merge_counts_and_stays_off_the_host():
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.services.search import SearchService

    eng = Engine(device="cpu")
    eng.enable_placement(devices=M.local_devices("cpu", 8))
    try:
        svc = SearchService(eng)
        svc.create_index("m", {"emb": "VECTOR"}, vector={"emb": {"dim": 8, "metric": "L2", "shards": 4}})
        vecs, _rng = _vectors(seed=4, n=100, dim=8)
        for i, v in enumerate(vecs):
            svc.add_document("m", f"d{i}", {"emb": v})
        before = ioplane.STATS.snapshot()
        K.reset_launches()
        dev, finish = svc.knn("m", "emb", vecs[:3], 5)
        assert len(dev) == 3  # (dist, shard, local) stay on the device until finish
        res = finish(dev)
        after = ioplane.STATS.snapshot()
        assert after["sharded_knn_merges"] == before["sharded_knn_merges"] + 1
        assert after["host_colocations"] == before["host_colocations"]
        assert [r[0][0] for r in res] == ["d0", "d1", "d2"]
        lanes = eng.lanes.census()
        assert lanes["active_dispatches"] == 0
    finally:
        eng.shutdown()
