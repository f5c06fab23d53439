"""The vector programs of the port against the JAX package, on the CPU.

Each plain version of redisson_tpu_torch/core/kernels.py (knn_topk and its
three forms, knn_ivf_topk and its three forms, kmeans_step, knn_select,
ivf_score, the three packed row writes and both grows) against the JAX
program of the same name on the same seeded numpy inputs.

Tolerances, and why:
  * distances: float32 within 1e-5 relative of the terms they are made of
    (|q|^2 + |b|^2 for L2, |q| |b| for IP, 1 for COSINE), as XLA:CPU and
    torch add the products of a dot in different orders;
  * ids: equal to the float64 oracle's stable order (ties to the lower
    position) at every place whose float64 distance differs from its
    neighbours' by more than 1e-4 relative, exact duplicates (equal in
    float64) counting as one group; +inf entries carry ids that mean
    nothing and are not compared;
  * k-means: centroids within 1e-5 relative of their scale, assignments
    equal wherever a point's two nearest centroids differ by more than
    1e-4 relative;
  * knn_select on one matrix, the packed writes and the grows: bit for bit.

The kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisson_tpu.core import kernels as RK
from redisson_tpu_torch.core import kernels as K

METRICS = ("L2", "COSINE", "IP")
DTYPES = ("FLOAT32", "FLOAT16", "INT8")
SENTINEL = 0x3FFFFFFF


def _bank(rng, cap, w, dtype, dup=True):
    """A (cap, w) bank in `dtype` (INT8 with a per-row scale) whose rows 5-7
    copy rows 1-3 (exact ties) when `dup`."""
    rows = rng.standard_normal((cap, w)).astype(np.float32)
    if dup:
        rows[5:8] = rows[1:4]
    rows[9] = 0.0  # a zero row: COSINE distance 1
    if dtype == "FLOAT16":
        return rows.astype(np.float16), None
    if dtype == "INT8":
        scale = (np.abs(rows).max(1) / 127.0).astype(np.float32)
        scale[scale == 0] = 1.0
        q = np.clip(np.rint(rows / scale[:, None]), -127, 127).astype(np.int8)
        return q, scale
    return rows, None


def _deq(bank, scale):
    rows = bank.astype(np.float64)
    return rows * scale[:, None] if scale is not None else rows


def _oracle(rows64, q, metric, bias=None, live=None, qbias=None):
    """(Q, C) float64 distances with the programs' conventions."""
    q64 = q.astype(np.float64)
    dots = q64 @ rows64.T
    if metric == "L2":
        d = (q64 * q64).sum(1)[:, None] - 2 * dots + (rows64 * rows64).sum(1)[None, :]
    elif metric == "COSINE":
        den = np.sqrt((q64 * q64).sum(1))[:, None] * np.sqrt((rows64 * rows64).sum(1))[None, :]
        with np.errstate(invalid="ignore", divide="ignore"):
            d = 1 - np.where(den > 0, dots / den, 0.0)
    else:
        d = 1 - dots
    if bias is not None:
        d = d + bias[None, :]
    if live is not None:
        d = np.where(live[None, :], d, np.inf)
    if qbias is not None:
        d = d + qbias
    return d


def _scale_of(rows64, q, metric):
    q64 = q.astype(np.float64)
    if metric == "L2":
        return ((q64 * q64).sum(1) + (rows64 * rows64).sum(1).max())[:, None]
    if metric == "IP":
        return np.maximum(1.0, np.linalg.norm(q64, axis=1) * np.linalg.norm(rows64, axis=1).max())[:, None]
    return np.ones((q.shape[0], 1))


def _check_ids(got, d64, k, label):
    """got (Q, k) ids against the float64 oracle d64 (Q, M): equal to its
    stable order at every place whose group of equal distances stands
    more than 1e-4 relative from its neighbours."""
    for r in range(d64.shape[0]):
        order = np.argsort(d64[r], kind="stable")
        ds = d64[r][order]
        for j in range(min(k, ds.size)):
            if not np.isfinite(ds[j]):
                break
            tol = 1e-4 * max(1.0, abs(ds[j]))
            lo = j
            while lo > 0 and ds[lo - 1] == ds[j]:
                lo -= 1
            hi = j
            while hi + 1 < ds.size and ds[hi + 1] == ds[j]:
                hi += 1
            isolated = (lo == 0 or ds[j] - ds[lo - 1] > tol) and (hi + 1 == ds.size or ds[hi + 1] - ds[j] > tol)
            if isolated:
                assert int(got[r, j]) == int(order[j]), (label, r, j, got[r, : j + 1], order[: j + 1])


def _check_dists(got, d64, order_ids, scale, label):
    want = np.take_along_axis(d64, order_ids.astype(np.int64), axis=1)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin), label
    err = np.abs(got[fin] - want[fin]) / np.broadcast_to(scale, want.shape)[fin]
    assert err.size == 0 or err.max() <= 1e-5, (label, err.max())


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", [False, True])
def test_knn_topk_matches_jax(metric, dtype, masked):
    rng = np.random.default_rng(_seed(metric, dtype, masked))
    cap, w, n_rows, qn, k = 96, 12, 80, 8, 10
    bank, scale = _bank(rng, cap, w, dtype)
    bias = np.zeros(cap, np.float32)
    bias[[2, 11, 40]] = np.inf  # dead rows
    q = rng.standard_normal((qn, w)).astype(np.float32)
    q[3] = 0.0  # a zero query: COSINE 1 everywhere
    q[4] = _deq(bank, scale)[5].astype(np.float32)  # a duplicated row's exact copy
    qbias = None
    if masked:
        qbias = np.where(rng.random((qn, cap)) < 0.3, np.inf, 0.0).astype(np.float32)
    if masked:
        fn, rfn = (K.knn_topk_masked_q, RK.knn_topk_masked_q) if scale is not None else \
                  (K.knn_topk_masked, RK.knn_topk_masked)
    else:
        fn, rfn = (K.knn_topk_q, RK.knn_topk_q) if scale is not None else (K.knn_topk, RK.knn_topk)
    head = (bank, scale) if scale is not None else (bank,)
    tail = (bias,) + ((qbias,) if masked else ()) + (q,)
    got_d, got_i = fn(*map(_t, head + tail), n_rows, k, metric)
    ref_d, ref_i = rfn(*map(_j, head + tail), n_rows, k, metric)
    got_d, got_i = got_d.numpy(), got_i.numpy()
    ref_d, ref_i = np.asarray(ref_d), np.asarray(ref_i)
    assert got_d.dtype == np.float32 and got_i.dtype == np.int32 and got_i.shape == (qn, k)
    rows64 = _deq(bank, scale)
    live = np.arange(cap) < n_rows
    d64 = _oracle(rows64, q, metric, bias, live, qbias)
    scl = _scale_of(rows64, q, metric)
    for label, dd, ii in (("port", got_d, got_i), ("jax", ref_d, ref_i)):
        _check_ids(ii, d64, k, f"{label} {metric} {dtype} masked={masked}")
        safe = np.where(np.isfinite(dd), ii, 0)
        _check_dists(dd, d64, safe, scl, f"{label} {metric} {dtype}")
    fin = np.isfinite(ref_d)
    assert np.array_equal(np.isfinite(got_d), fin)
    # query 4 is row 5's exact copy, and row 5 row 1's: the lower index first
    if metric == "L2" and not masked:
        assert list(got_i[4][:2]) == list(ref_i[4][:2]) == [1, 5]


@pytest.mark.parametrize("k", [1, 5, 80, 96])
def test_knn_topk_k_edges(k):
    """k = 1, k above the live rows (80 of 96), k = cap."""
    rng = np.random.default_rng(k)
    bank, _ = _bank(rng, 96, 8, "FLOAT32")
    bias = np.zeros(96, np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    got_d, got_i = K.knn_topk(_t(bank), _t(bias), _t(q), 80, k, "L2")
    ref_d, ref_i = RK.knn_topk(_j(bank), _j(bias), _j(q), 80, k, "L2")
    ref_d, ref_i = np.asarray(ref_d), np.asarray(ref_i)
    assert np.array_equal(np.isinf(got_d.numpy()), np.isinf(ref_d))
    assert int(np.isfinite(ref_d).sum(1).max()) == min(k, 80)
    d64 = _oracle(_deq(bank, None), q, "L2", bias, np.arange(96) < 80)
    _check_ids(got_i.numpy(), d64, k, "port")
    _check_ids(ref_i, d64, k, "jax")


def test_knn_topk_every_row_dead():
    rng = np.random.default_rng(3)
    bank, _ = _bank(rng, 64, 8, "FLOAT32")
    bias = np.full(64, np.inf, np.float32)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    got_d, _ = K.knn_topk(_t(bank), _t(bias), _t(q), 64, 5, "COSINE")
    ref_d, _ = RK.knn_topk(_j(bank), _j(bias), _j(q), 64, 5, "COSINE")
    assert np.isinf(got_d.numpy()).all() and np.isinf(np.asarray(ref_d)).all()


def _sel_matrix(rng, r, n):
    d = rng.standard_normal((r, n)).astype(np.float32)
    d[:, ::7] = d[:, :1]  # exact ties across the row
    d[0, :] = 1.0  # a row of one value
    d[1, 3::5] = np.inf
    d[2, :] = np.inf
    d[2, 10] = -3.0
    d[3, : n // 2] = np.float32(2.5)
    return d


@pytest.mark.parametrize("k", [1, 3, 33, 64, 257, 600])
def test_knn_select_matches_lax_top_k(k):
    """The tie order is the contract: on one matrix, knn_select's (values,
    columns) equal lax.top_k's of the negated matrix bit for bit (ties to
    the lower column, +inf last)."""
    rng = np.random.default_rng(k)
    d = _sel_matrix(rng, 6, 700)
    vals, idx = K.knn_select(_t(d), k)
    import jax

    neg, ridx = jax.lax.top_k(-jnp.asarray(d), k)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.array_equal(vals.numpy(), -np.asarray(neg))


def test_knn_select_maps_columns_through_ids():
    rng = np.random.default_rng(5)
    d = _sel_matrix(rng, 4, 50)
    ids = rng.integers(0, 10**6, (4, 50)).astype(np.int32)
    vals, idx = K.knn_select(_t(d), 7, _t(ids))
    pv, pc = K.knn_select(_t(d), 7)
    assert np.array_equal(vals.numpy(), pv.numpy())
    assert np.array_equal(idx.numpy(), np.take_along_axis(ids, pc.numpy().astype(np.int64), 1))
    with pytest.raises(ValueError):
        K.knn_select(_t(d), 51)


@pytest.mark.parametrize("nprobe", [2, 4, 8])
def test_knn_select_plain_matches_lax_top_k_at_the_ivf_shapes(nprobe):
    """config 7's IVF batch: the route (64 queries x 1,536 centroids, k =
    nprobe) and the candidates (64 x nprobe * 112 slots with their row ids,
    k 10, +inf on sentinel slots), bit for bit against lax.top_k."""
    import jax

    rng = np.random.default_rng(nprobe)
    route = rng.standard_normal((64, 1536)).astype(np.float32)
    route[:, ::97] = route[:, :1]
    vals, idx = K.knn_select(_t(route), nprobe)
    neg, ridx = jax.lax.top_k(-jnp.asarray(route), nprobe)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.array_equal(vals.numpy(), -np.asarray(neg))
    slots = nprobe * 112
    cand = rng.standard_normal((64, slots)).astype(np.float32)
    cand[rng.random((64, slots)) < 0.7] = np.inf
    cand[:, 5] = cand[:, 3]
    ids = rng.integers(0, 50_000, (64, slots)).astype(np.int32)
    vals, idx = K.knn_select(_t(cand), 10, _t(ids))
    neg, ridx = jax.lax.top_k(-jnp.asarray(cand), 10)
    assert np.array_equal(idx.numpy(), np.take_along_axis(ids, np.asarray(ridx), 1))
    assert np.array_equal(vals.numpy(), -np.asarray(neg))


@pytest.mark.parametrize("r,n,k,sms", [(64, 1536, 4, 132), (64, 448, 10, 132), (64, K.SELECT_SMALL, 10, 132),
                                       (64, K.SELECT_SMALL + 1, 10, 132), (64, 65536, 10, 132),
                                       (64, 1_048_576, 10, 132), (3, 1_048_576, 10, 132), (64, 1_048_576, 700, 132),
                                       (19, 40001, 257, 132), (70000, 5000, 1, 132), (1, 2**31 - 1, 256, 8)])
def test_knn_select_plan_covers_every_column_once(r, n, k, sms):
    """The segments of a plan cover columns 0 .. n exactly once, none empty;
    a row's lists fit the last block's merge; the scratch holds every segment's list and each row's last key, the
    state a bound and a ticket a row."""
    plan = K.knn_select_plan(r, n, k, sms)
    kr = min(k, K.SELECT_ROUND)
    assert plan.state_words == 2 * r
    if n <= K.SELECT_SMALL:
        assert plan.segs == 0 and plan.scratch_words == r
        return
    assert plan.segs >= 1 and plan.seg_len % 4 == 0
    assert plan.segs * kr <= K.SELECT_POOL
    starts = [s * plan.seg_len for s in range(plan.segs)]
    ends = [min(n, a + plan.seg_len) for a in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(a < b for a, b in zip(starts, ends))
    assert all(b == a for b, a in zip(ends[:-1], starts[1:]))
    assert plan.segs == 1 or plan.seg_len >= K.SELECT_SEG_MIN
    assert plan.scratch_words == r * plan.segs * kr + r
    if (r, n, k) == (64, 1_048_576, 10):
        assert plan.segs == -(-K.SELECT_BLOCKS_PER_SM * sms // r)  # about SELECT_BLOCKS_PER_SM blocks an SM


def test_knn_select_hands_the_kernel_its_plan(monkeypatch):
    """The wrapper allocates the plan's scratch and a state of a bound and
    a ticket a row, and passes the plan's segments to the kernel."""
    calls, made, states = [], [], []
    empty = torch.empty

    class Lib:
        rtpu_knn_select = "knn_select"

    def state(device, words):
        states.append(torch.zeros(words, dtype=torch.int64))
        return states[-1]

    monkeypatch.setattr(torch, "empty", lambda *a, **kw: made.append(empty(*a, **kw)) or made[-1])
    monkeypatch.setattr(K, "_route", lambda t: "cuda")
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    monkeypatch.setattr(K._build, "library", lambda name: Lib)
    monkeypatch.setattr(K, "_select_state", state)
    monkeypatch.setattr(K, "_launch", lambda name, fn, t, *args: calls.append((name, fn, args)))
    for r, n, k in ((64, 65536, 10), (64, 1536, 4), (5, 9000, 300)):
        calls.clear()
        made.clear()
        K.knn_select(torch.zeros((r, n)), k)
        plan = K.knn_select_plan(r, n, k, 132)
        ((name, fn, args),) = calls
        assert (name, fn) == ("knn_select", "knn_select")
        assert args[1:4] == (n, r, k) and args[7:9] == (plan.segs, plan.seg_len)
        (scratch,) = [t for t in made if t.dtype == torch.int64]
        assert scratch.numel() == plan.scratch_words and args[9] == scratch.data_ptr()
        assert states[-1].numel() == plan.state_words and args[10] == states[-1].data_ptr()


@pytest.mark.parametrize("route", [None, K.KNN_TILE, K.KNN_STREAM_ELEMS, K.KNN_STREAM_VEC])
def test_knn_score_on_cpu_tensors_is_the_plain_version_by_any_route(route):
    """A card route named for CPU tensors changes nothing: the wrapper
    computes its plain version, bit for bit."""
    rng = np.random.default_rng(3)
    bank = _t(rng.integers(-127, 128, (300, 12)).astype(np.int8))
    scale = _t(rng.random(300).astype(np.float32))
    q = _t(rng.standard_normal((9, 12)).astype(np.float32))
    for metric in K.KNN_METRICS:
        want = K.knn_score_plain(bank, scale, None, None, q, 250, metric)
        got = K.knn_score(bank, scale, None, None, q, 250, metric, route=route)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), metric


def test_knn_score_route_by_width_and_alignment():
    """The streamed route up to W = 256, with 16-byte copies where a row is
    a multiple of 16 bytes on a 16-byte aligned bank, element loads
    otherwise; the tile route past W = 256, and for more than 8 queries
    against a bank of at most 16,384 rows."""
    q = torch.zeros((64, 1))
    for c, qn, route in ((16384, 64, K.KNN_TILE), (16385, 64, K.KNN_STREAM_VEC), (16384, 9, K.KNN_TILE),
                         (16384, 8, K.KNN_STREAM_VEC), (1536, 1, K.KNN_STREAM_VEC), (1536, 65, K.KNN_TILE)):
        assert K.knn_score_route(torch.zeros((c, 128)), torch.zeros((qn, 128))) == route, (c, qn)
    cases = [(torch.float32, 4, K.KNN_STREAM_VEC), (torch.float32, 128, K.KNN_STREAM_VEC),
             (torch.float32, 256, K.KNN_STREAM_VEC), (torch.float32, 70, K.KNN_STREAM_ELEMS),
             (torch.float32, 1, K.KNN_STREAM_ELEMS), (torch.float32, 257, K.KNN_TILE),
             (torch.float16, 8, K.KNN_STREAM_VEC), (torch.float16, 6, K.KNN_STREAM_ELEMS),
             (torch.float16, 1024, K.KNN_TILE), (torch.int8, 16, K.KNN_STREAM_VEC),
             (torch.int8, 12, K.KNN_STREAM_ELEMS), (torch.int8, 272, K.KNN_TILE)]
    for dtype, w, route in cases:
        bank = torch.zeros((20000, w), dtype=dtype)
        assert K.knn_score_route(bank, q) == route, (dtype, w)
    flat = torch.zeros(20000 * 128 + 16, dtype=torch.float32)
    off = next(i for i in range(16) if flat[i:].data_ptr() % 16 == 4)
    assert K.knn_score_route(flat[off:off + 20000 * 128].view(20000, 128), q) == K.KNN_STREAM_ELEMS


def _cells(rng, n_rows, nlist, cap):
    """Sentinel-padded cell lists of ascending row ids, some rows past
    n_rows (they must score +inf) and one empty cell."""
    cells = np.full((nlist, cap), SENTINEL, np.int32)
    assign = rng.integers(0, nlist - 1, n_rows + 6)
    for c in range(nlist - 1):
        members = np.nonzero(assign == c)[0][:cap]
        cells[c, : members.size] = members
    return cells


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", [False, True])
def test_knn_ivf_topk_matches_jax(metric, dtype, masked):
    """Both packages on the same installed centroids and cells."""
    rng = np.random.default_rng(_seed(metric, dtype, masked, "ivf"))
    cap, w, n_rows, qn, nlist, ccap, nprobe, k = 128, 8, 110, 8, 6, 40, 3, 12
    bank, scale = _bank(rng, cap, w, dtype)
    bias = np.zeros(cap, np.float32)
    bias[[4, 20, 31]] = np.inf
    cent = rng.standard_normal((nlist, w)).astype(np.float32)
    cells = _cells(rng, n_rows, nlist, ccap)
    q = rng.standard_normal((qn, w)).astype(np.float32)
    qmask = np.where(rng.random(cap) < 0.25, np.inf, 0.0).astype(np.float32) if masked else None
    if masked:
        fn, rfn = (K.knn_ivf_topk_masked_q, RK.knn_ivf_topk_masked_q) if scale is not None else \
                  (K.knn_ivf_topk_masked, RK.knn_ivf_topk_masked)
    else:
        fn, rfn = (K.knn_ivf_topk_q, RK.knn_ivf_topk_q) if scale is not None else \
                  (K.knn_ivf_topk, RK.knn_ivf_topk)
    head = (bank, scale) if scale is not None else (bank,)
    args = head + (bias,) + ((qmask,) if masked else ()) + (cent, cells, q)
    got_d, got_i = fn(*map(_t, args), n_rows, k, nprobe, metric)
    ref_d, ref_i = rfn(*map(_j, args), n_rows, k, nprobe, metric)
    got_d, got_i, ref_d, ref_i = got_d.numpy(), got_i.numpy(), np.asarray(ref_d), np.asarray(ref_i)
    # the oracle over the same routing (float64 centroid distances)
    rows64 = _deq(bank, scale)
    cd64 = _oracle(cent.astype(np.float64), q, metric)
    fin = np.isfinite(ref_d)
    assert np.array_equal(np.isfinite(got_d), fin)
    for r in range(qn):
        route = np.argsort(cd64[r], kind="stable")
        assert (cd64[r][route[nprobe]] - cd64[r][route[nprobe - 1]]) > 1e-6  # routing not near-tied
        cand = cells[route[:nprobe]].reshape(-1)
        valid = cand < n_rows
        safe = np.where(valid, cand, 0)
        d = _oracle(rows64[safe], q[r:r + 1], metric, bias[safe],
                    valid, None if qmask is None else qmask[safe][None, :])
        pos = np.argsort(d[0], kind="stable")
        for label, ii, dd in (("port", got_i, got_d), ("jax", ref_i, ref_d)):
            # map ids back to candidate positions where the id is unique
            pos_of = {int(c): p for p, c in enumerate(cand) if valid[p]}
            got_pos = np.array([pos_of.get(int(x), -1) if np.isfinite(v) else -1
                                for x, v in zip(ii[r], dd[r])])
            _check_ids(got_pos[None, :], d, k, f"{label} ivf {metric} {dtype} row {r}")
            want = d[0][pos[:k]]
            ok = np.isfinite(want)
            assert np.array_equal(np.isfinite(dd[r]), ok)
            scl = _scale_of(rows64, q[r:r + 1], metric)[0, 0]
            assert np.all(np.abs(dd[r][ok] - want[ok]) <= 1e-5 * scl), label


def test_ivf_score_matches_the_reference_candidates():
    rng = np.random.default_rng(11)
    cap, w, n_rows, nlist, ccap = 64, 8, 50, 5, 16
    bank, scale = _bank(rng, cap, w, "INT8")
    bias = np.zeros(cap, np.float32)
    bias[7] = np.inf
    cells = _cells(rng, n_rows, nlist, ccap)
    cells[0, 0] = -5  # a negative id scores +inf
    q = rng.standard_normal((3, w)).astype(np.float32)
    probe = np.array([[0, 1], [4, 2], [3, 3]], np.int32)
    dist, ids = K.ivf_score(_t(bank), _t(scale), _t(bias), None, _t(cells), _t(probe), _t(q), n_rows, "L2")
    cand = cells[probe].reshape(3, -1)
    assert np.array_equal(ids.numpy(), cand)
    valid = (cand >= 0) & (cand < n_rows)
    d = dist.numpy()
    assert np.array_equal(np.isfinite(d), valid & (bias[np.where(valid, cand, 0)] == 0))
    rows64 = _deq(bank, scale)
    for r in range(3):
        for p in np.nonzero(np.isfinite(d[r]))[0]:
            want = _oracle(rows64[cand[r, p]][None, :], q[r:r + 1], "L2")[0, 0]
            assert abs(d[r, p] - want) <= 1e-5 * _scale_of(rows64, q[r:r + 1], "L2")[0, 0]


@pytest.mark.parametrize("dead", [0, 40])
def test_kmeans_step_matches_jax(dead):
    rng = np.random.default_rng(21 + dead)
    n, w, nlist = 600, 12, 9
    centers = rng.standard_normal((nlist, w)).astype(np.float32) * 3
    pts = (centers[rng.integers(nlist, size=n)] + 0.5 * rng.standard_normal((n, w))).astype(np.float32)
    weights = np.ones(n, np.float32)
    weights[rng.choice(n, dead, replace=False)] = 0.0
    pts[weights == 0] = 0.0  # dead rows are zeros in the host mirror
    cent = pts[np.sort(rng.choice(np.nonzero(weights)[0], nlist, replace=False))].copy()
    cent[-1] = 100.0  # a centroid no point is nearest: an empty cell keeps it
    got_c, got_a = K.kmeans_step(_t(pts), _t(weights), _t(cent))
    ref_c, ref_a = RK.kmeans_step(_j(pts), _j(weights), _j(cent))
    got_c, got_a, ref_c, ref_a = got_c.numpy(), got_a.numpy(), np.asarray(ref_c), np.asarray(ref_a)
    assert got_a.dtype == np.int32 and np.array_equal(got_a == -1, weights == 0)
    assert np.array_equal(got_c[-1], cent[-1]) and np.array_equal(ref_c[-1], cent[-1])
    d64 = _oracle(cent.astype(np.float64), pts, "L2")
    two = np.sort(d64, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > 1e-4 * np.maximum(1.0, np.abs(two[:, 0]))
    assert clear.mean() > 0.95
    assert np.array_equal(got_a[clear], ref_a[clear])
    scale = np.abs(ref_c).max()
    assert np.abs(got_c - ref_c).max() <= 1e-5 * scale


@pytest.mark.parametrize("case", ["duplicates", "one_centroid", "every_point_dead"])
def test_kmeans_assign_plain_edges_match_jax(case):
    """The contract the card's assign routes are held to, on the plain
    version and the JAX program: exact duplicate centroids go to the lower
    index (the first minimum), one centroid takes every live point, and
    every point dead gives -1 everywhere and leaves every centroid."""
    rng = np.random.default_rng({"duplicates": 5, "one_centroid": 6, "every_point_dead": 7}[case])
    n, w, nlist = 700, 16, 9
    centers = rng.standard_normal((nlist, w)).astype(np.float32) * 3
    pts = (centers[rng.integers(nlist, size=n)] + 0.5 * rng.standard_normal((n, w))).astype(np.float32)
    weights = np.ones(n, np.float32)
    weights[rng.choice(n, 30, replace=False)] = 0.0
    if case == "every_point_dead":
        weights[:] = 0.0
    pts[weights == 0] = 0.0
    cent = centers.copy()
    if case == "duplicates":
        cent[6] = cent[1]
        cent[7] = cent[1]
        cent[8] = cent[3]
    elif case == "one_centroid":
        cent = cent[:1].copy()
    got_c, got_a = K.kmeans_step(_t(pts), _t(weights), _t(cent))
    ref_c, ref_a = RK.kmeans_step(_j(pts), _j(weights), _j(cent))
    got_a, ref_a, got_c, ref_c = got_a.numpy(), np.asarray(ref_a), got_c.numpy(), np.asarray(ref_c)
    # the float64 first minimum, and the points whose best stands 1e-4
    # (relative) clear of every centroid that is not a copy of it
    d64 = _oracle(cent.astype(np.float64), pts, "L2")
    want = np.where(weights > 0, np.argmin(d64, axis=1), -1)
    best = d64[np.arange(n), np.argmin(d64, axis=1)]
    same = (cent[np.argmin(d64, axis=1)][:, None, :] == cent[None, :, :]).all(2)
    other = np.where(same, np.inf, d64).min(1)
    clear = (other - best) > 1e-4 * np.maximum(1.0, np.abs(best))
    assert clear.mean() > 0.95
    assert np.array_equal(got_a[clear], want[clear]) and np.array_equal(ref_a[clear], want[clear])
    assert np.array_equal(got_a == -1, weights == 0) and np.array_equal(ref_a == -1, weights == 0)
    if case == "duplicates":
        assert not np.isin(got_a, [6, 7, 8]).any() and not np.isin(ref_a, [6, 7, 8]).any()
        assert (got_a == 1).any() and (got_a == 3).any()
    if case == "one_centroid":
        assert np.array_equal(got_a, ref_a)
    if case == "every_point_dead":
        assert np.array_equal(got_a, ref_a) and np.array_equal(got_c, cent) and np.array_equal(ref_c, cent)
    assert np.abs(got_c - ref_c).max() <= 1e-5 * np.abs(ref_c).max()


def test_kmeans_assign_route_by_width():
    """The tensor-core route up to W = 256, the tile route past it."""
    for w, route in ((1, K.KMEANS_MMA), (7, K.KMEANS_MMA), (128, K.KMEANS_MMA), (256, K.KMEANS_MMA),
                     (257, K.KMEANS_TILE), (1024, K.KMEANS_TILE)):
        assert K.kmeans_assign_route(torch.zeros((10, w)), torch.zeros((3, w))) == route, w


@pytest.mark.parametrize("w", [12, 256, 257])
def test_kmeans_assign_on_cpu_tensors_is_the_plain_version_at_either_routes_width(w):
    """On CPU tensors the wrapper runs the plain version, at the widths of
    the tensor-core route (12, 256) and of the tile route (257) alike."""
    rng = np.random.default_rng(8)
    pts = _t(rng.standard_normal((200, w)).astype(np.float32))
    weights = _t((rng.random(200) < 0.8).astype(np.float32))
    cent = _t(rng.standard_normal((7, w)).astype(np.float32))
    got = K.kmeans_assign(pts, weights, cent)
    assert torch.equal(got, K.kmeans_assign_plain(pts, weights, cent))


def _packed(rng, idx, width_words, extra):
    p = np.zeros((len(idx) + 3, 2 + extra + width_words), np.uint32)
    p[: len(idx), 0] = idx
    p[: len(idx), 1] = np.where(rng.random(len(idx)) < 0.3, np.float32(np.inf), np.float32(0)).view(np.uint32)
    p[:, 2:] = rng.integers(0, 2**32, (p.shape[0], p.shape[1] - 2), dtype=np.uint64).astype(np.uint32)
    if extra:
        p[:, 2] = rng.random(p.shape[0]).astype(np.float32).view(np.uint32)
    p[-3:, 0] = [1, 2, 3]  # past n_valid: dropped
    return p


@pytest.mark.parametrize("dtype", DTYPES)
def test_rowbank_write_packed_matches_jax(dtype):
    """The packed writes, bit for bit: FLOAT16 two lanes a word and INT8
    four, least significant first (numpy's .view(np.uint32) packing)."""
    rng = np.random.default_rng(_seed(dtype))
    cap, w = 40, 12
    idx = np.array([5, 0, 39, 17, 60, 8], np.uint32)  # 60: outside the bank, dropped
    n_valid = len(idx)
    if dtype == "FLOAT32":
        bank0, words, extra = np.zeros((cap, w), np.float32), w, 0
    elif dtype == "FLOAT16":
        bank0, words, extra = np.zeros((cap, w), np.float16), w // 2, 0
    else:
        bank0, words, extra = np.zeros((cap, w), np.int8), w // 4, 1
    packed = _packed(rng, idx, words, extra)
    bias0 = np.zeros(cap, np.float32)
    tp = torch.from_numpy(packed.view(np.int32))
    if dtype == "INT8":
        scale0 = np.ones(cap, np.float32)
        gb, gs, gbias = K.rowbank_write_packed_i8(_t(bank0.copy()), _t(scale0.copy()), _t(bias0.copy()), tp,
                                                  n_valid)
        rb, rs, rbias = RK.rowbank_write_packed_i8(_j(bank0), _j(scale0), _j(bias0), jnp.asarray(packed),
                                                   n_valid)
        assert np.array_equal(gs.numpy().view(np.uint32), np.asarray(rs).view(np.uint32))
    else:
        fn, rfn = ((K.rowbank_write_packed, RK.rowbank_write_packed) if dtype == "FLOAT32"
                   else (K.rowbank_write_packed_f16, RK.rowbank_write_packed_f16))
        gb, gbias = fn(_t(bank0.copy()), _t(bias0.copy()), tp, n_valid)
        rb, rbias = rfn(_j(bank0), _j(bias0), jnp.asarray(packed), n_valid)
    gbn, rbn = gb.numpy(), np.asarray(rb)
    assert gbn.dtype == rbn.dtype
    assert np.array_equal(gbn.view(np.uint8), rbn.view(np.uint8))
    assert np.array_equal(gbias.numpy().view(np.uint32), np.asarray(rbias).view(np.uint32))
    row = packed[0, 2 + extra:]
    assert np.array_equal(gbn[5].view(np.uint8), row.view(np.uint8))


def test_rowbank_grows_match_jax():
    rng = np.random.default_rng(2)
    bank = rng.standard_normal((8, 4)).astype(np.float16)
    bias = rng.standard_normal(8).astype(np.float32)
    gb, gbias = K.rowbank_grow(_t(bank), _t(bias), torch.zeros((16, 4), dtype=torch.float16), torch.zeros(16))
    rb, rbias = RK.rowbank_grow(_j(bank), _j(bias), jnp.zeros((16, 4), jnp.float16), jnp.zeros(16))
    assert np.array_equal(gb.numpy(), np.asarray(rb)) and np.array_equal(gbias.numpy(), np.asarray(rbias))
    scale = rng.random(8).astype(np.float32)
    g = K.rowbank_grow_plane(_t(scale), torch.ones(16))
    r = RK.rowbank_grow_plane(_j(scale), jnp.ones(16))
    assert np.array_equal(g.numpy(), np.asarray(r))
