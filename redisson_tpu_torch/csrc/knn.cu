// Vector search kernels: KNN scoring, top-k selection and the IVF candidate
// gather.
//
// knn_score replaces the scoring of the knn_topk family of
// redisson_tpu/core/kernels.py (:698-720; _knn_distances :646, _bank_f32
// :666) and of the IVF route (_ivf_route :759): out (R, C) float32, for
// each query row r and bank row c, the metric of q_r and the bank row
// widened to float32 (knn_tile.cuh), plus bias[c] (+inf marks a dead row),
// +inf for c >= n_rows, plus the optional per-query bias qbias[r][c] (0 keeps
// a row, +inf drops it; the hybrid prefilter).  Bound on an H100: at the
// main path's shapes (Q 64, d 64-128) the float32 FMAs on the CUDA cores
// (2 R C W operations at 67 TFLOP/s) above the bank's bytes.  The design is
// the simple one: tiles of both operands in shared memory, each thread
// MQ x MC products a step; the norms ride the same pass.  A Q of 8 or less
// takes a tile of 8 queries by 256 rows, larger Qs 64 by 128 (64 by 32 for a
// bank of at most 16,384 rows, such as the IVF route's centroids).
//
// knn_select replaces the lax.top_k of the same programs (:680, :686, :794)
// and of the route: per row of a (R, n) float32 matrix, the k smallest
// entries in the order of the key (dist, column): the float's bits mapped
// to an unsigned order, then the column, as one 64-bit value.  Ties go to
// the lower column and +inf sorts after every finite value, as lax.top_k's
// stable order gives them; torch.topk promises no such order.  With `ids`
// the column is mapped through ids[r][column] (the IVF candidates' rows).
// Bound on an H100: the bytes of the matrix, read once.  Each warp keeps a
// sorted list of its best keys spread over its lanes (KPL slots a lane) and
// offers it 32 keys at a time: a key enters only below the list's k-th, so
// after the first k a warp mostly reads and compares.  Stage 1 splits each
// row into segments of kSeg columns, one block a segment, and merges its 8
// warps' lists into the segment's best; stage 2 takes each row's segment
// lists the same way (one block a row).  A list holds at most kRound = 256
// keys; a larger k runs in rounds of 256, each skipping the keys the rounds
// before it took, so it costs a pass over the row per 256 keys.
//
// ivf_score replaces the candidate scoring of _knn_ivf_body (:782,
// _ivf_candidate_dists :739): for query r and probe p (cell probe[r][p]),
// slot j of the cell's row list cells[cell][j] scores against q_r with the
// same metrics and widening, plus bias and the optional (C,) mask qmask; a
// slot whose row id is negative or >= n_rows (the sentinel 0x3FFFFFFF pads
// ragged cells) scores +inf.  out (R, nprobe * cap) float32 and ids (R,
// nprobe * cap) int32 (the slot's row id), in probe order, then cell order,
// which is the reference's candidate order.  Bound on an H100: the gathered
// rows' bytes.  Eight lanes a candidate, so a block has 32 rows in flight:
// each lane reads every eighth lane of its row and a shuffle tree adds the
// products.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "knn_tile.cuh"

namespace {

using namespace rtpu_tile;

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- knn_score

constexpr int64_t kNarrowRows = 16384;

template <int TQT, int MQ, int MC, int BT>
__global__ void __launch_bounds__(kThreads)
knn_score_kernel(const void* __restrict__ bank, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ qbias,
                 const float* __restrict__ q, int64_t C, int W, int64_t R, int64_t n_rows,
                 int metric, float* __restrict__ out) {
  using S = Shape<TQT, MQ, MC>;
  __shared__ Smem<TQT, MQ, MC> sm;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * S::BC;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * S::BQ;
  float acc[MQ][MC];
  tile_dots<TQT, MQ, MC, BT>(sm, bank, scale, C, W, q, R, c0, q0, acc);
  const int tq = threadIdx.x / S::TCT, tc = threadIdx.x % S::TCT;
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    const int64_t gq = q0 + tq + TQT * i;
    if (gq >= R) continue;
    const float qsq = sm.nrm[S::BC + tq + TQT * i];
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      const int64_t gc = c0 + tc + S::TCT * j;
      if (gc >= C) continue;
      float d = metric_of(metric, acc[i][j], qsq, sm.nrm[tc + S::TCT * j]);
      if (bias != nullptr) d = __fadd_rn(d, bias[gc]);
      if (gc >= n_rows) d = INFINITY;
      if (qbias != nullptr) d = __fadd_rn(d, qbias[gq * C + gc]);
      out[gq * C + gc] = d;
    }
  }
}

template <int TQT, int MQ, int MC>
cudaError_t score_launch(int bt, const void* bank, const float* scale, const float* bias,
                         const float* qbias, const float* q, int64_t C, int W, int64_t R,
                         int64_t n_rows, int metric, float* out, cudaStream_t s) {
  using S = Shape<TQT, MQ, MC>;
  const dim3 grid(static_cast<unsigned>((C + S::BC - 1) / S::BC),
                  static_cast<unsigned>((R + S::BQ - 1) / S::BQ));
  if (bt == kF32) {
    knn_score_kernel<TQT, MQ, MC, kF32><<<grid, kThreads, 0, s>>>(bank, scale, bias, qbias, q, C, W, R,
                                                                 n_rows, metric, out);
  } else if (bt == kF16) {
    knn_score_kernel<TQT, MQ, MC, kF16><<<grid, kThreads, 0, s>>>(bank, scale, bias, qbias, q, C, W, R,
                                                                 n_rows, metric, out);
  } else {
    knn_score_kernel<TQT, MQ, MC, kI8><<<grid, kThreads, 0, s>>>(bank, scale, bias, qbias, q, C, W, R,
                                                                n_rows, metric, out);
  }
  return cudaGetLastError();
}

// --------------------------------------------------------------- knn_select

constexpr int kWarps = kThreads / 32;
constexpr int64_t kSeg = 4096;
constexpr int kRound = 256;
constexpr uint64_t kNone = ~0ull;  // above every real key (a column < 2**31)

__device__ __forceinline__ uint64_t key_of(float d, int64_t col) {
  const uint32_t b = __float_as_uint(d);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<uint64_t>(o) << 32) | static_cast<uint32_t>(col);
}

__device__ __forceinline__ float dist_of(uint64_t key) {
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// A warp's k smallest keys, ascending: lane l holds places l*KPL .. l*KPL+KPL-1.
template <int KPL>
struct WarpList {
  uint64_t v[KPL];
  uint64_t kth;  // the key at place k - 1 (kNone while the list is short)
  int k_lane, k_slot;

  __device__ __forceinline__ void init(int k) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) v[j] = kNone;
    kth = kNone;
    k_lane = (k - 1) / KPL;
    k_slot = (k - 1) % KPL;
  }

  // every lane calls with the same y, a key not in the list
  __device__ __forceinline__ void insert(uint64_t y, int lane) {
    int p = 0;
#pragma unroll
    for (int j = 0; j < KPL; ++j) p += __popc(__ballot_sync(kFull, v[j] < y));
    const uint64_t up = __shfl_up_sync(kFull, v[KPL - 1], 1);
#pragma unroll
    for (int j = KPL - 1; j >= 0; --j) {
      const int g = lane * KPL + j;
      const uint64_t below = j == 0 ? up : v[j > 0 ? j - 1 : 0];
      if (g > p) v[j] = below;
      else if (g == p) v[j] = y;
    }
    uint64_t mine = v[0];
#pragma unroll
    for (int j = 1; j < KPL; ++j)
      if (j == k_slot) mine = v[j];
    kth = __shfl_sync(kFull, mine, k_lane);
  }

  // one key a lane; those below the k-th enter, lowest lane first
  __device__ __forceinline__ void offer(uint64_t x, bool ok, int lane) {
    unsigned m = __ballot_sync(kFull, ok && x < kth);
    while (m) {
      const uint64_t y = __shfl_sync(kFull, x, __ffs(m) - 1);
      insert(y, lane);
      m &= m - 1;
      m &= __ballot_sync(kFull, ok && x < kth);
    }
  }
};

// One block takes columns [seg * seg_len, +seg_len) of row blockIdx.y (of a
// float matrix, or of keys with KEYS) and writes its kr smallest keys: to
// keys_out[(row * gridDim.x + seg) * kr + place], or, when final, as
// (dist, column or ids[row][column]) at places base.. of the row's k outputs,
// the last key also to last[row].  lower (when not null): only keys above
// lower[row] count.
template <int KPL, bool KEYS>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ dist, const uint64_t* __restrict__ keys_in, int64_t n,
              int64_t seg_len, const uint64_t* __restrict__ lower, int kr, bool final_,
              uint64_t* __restrict__ keys_out, float* __restrict__ vals, int32_t* __restrict__ idx,
              int k, int base, const int32_t* __restrict__ ids, int64_t ids_n,
              uint64_t* __restrict__ last) {
  __shared__ uint64_t pool[kWarps * kRound];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.y;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * seg_len;
  const int64_t end = start + seg_len < n ? start + seg_len : n;
  const bool has_lower = lower != nullptr;
  const uint64_t lo = has_lower ? lower[row] : 0;
  WarpList<KPL> wl;
  wl.init(kr);
  for (int64_t i0 = start + warp * 32; i0 < end; i0 += kThreads) {
    const int64_t i = i0 + lane;
    uint64_t x = kNone;
    if (i < end) x = KEYS ? keys_in[row * n + i] : key_of(dist[row * n + i], i);
    wl.offer(x, i < end && (!has_lower || x > lo), lane);
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int g = lane * KPL + j;
    if (g < kr) pool[warp * kr + g] = wl.v[j];
  }
  __syncthreads();
  if (warp != 0) return;
  WarpList<KPL> m;
  m.init(kr);
  for (int i0 = 0; i0 < kWarps * kr; i0 += 32) {
    const int i = i0 + lane;
    const bool ok = i < kWarps * kr;
    m.offer(ok ? pool[i] : kNone, ok, lane);
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int g = lane * KPL + j;
    if (g >= kr) continue;
    const uint64_t key = m.v[j];
    if (!final_) {
      keys_out[(row * gridDim.x + blockIdx.x) * kr + g] = key;
      continue;
    }
    const uint32_t col = static_cast<uint32_t>(key);
    vals[row * k + base + g] = dist_of(key);
    idx[row * k + base + g] = ids != nullptr ? ids[row * ids_n + col] : static_cast<int32_t>(col);
    if (g == kr - 1) last[row] = key;
  }
}

template <int KPL>
void select_pass(bool keys, const dim3& grid, cudaStream_t s, const float* dist, const uint64_t* keys_in,
                 int64_t n, int64_t seg_len, const uint64_t* lower, int kr, bool final_,
                 uint64_t* keys_out, float* vals, int32_t* idx, int k, int base, const int32_t* ids,
                 int64_t ids_n, uint64_t* last) {
  if (keys) {
    select_kernel<KPL, true><<<grid, kThreads, 0, s>>>(dist, keys_in, n, seg_len, lower, kr, final_,
                                                       keys_out, vals, idx, k, base, ids, ids_n, last);
  } else {
    select_kernel<KPL, false><<<grid, kThreads, 0, s>>>(dist, keys_in, n, seg_len, lower, kr, final_,
                                                        keys_out, vals, idx, k, base, ids, ids_n, last);
  }
}

void select_dispatch(int kr, bool keys, const dim3& grid, cudaStream_t s, const float* dist,
                     const uint64_t* keys_in, int64_t n, int64_t seg_len, const uint64_t* lower,
                     bool final_, uint64_t* keys_out, float* vals, int32_t* idx, int k, int base,
                     const int32_t* ids, int64_t ids_n, uint64_t* last) {
  if (kr <= 32) {
    select_pass<1>(keys, grid, s, dist, keys_in, n, seg_len, lower, kr, final_, keys_out, vals, idx, k, base,
                   ids, ids_n, last);
  } else if (kr <= 64) {
    select_pass<2>(keys, grid, s, dist, keys_in, n, seg_len, lower, kr, final_, keys_out, vals, idx, k, base,
                   ids, ids_n, last);
  } else if (kr <= 128) {
    select_pass<4>(keys, grid, s, dist, keys_in, n, seg_len, lower, kr, final_, keys_out, vals, idx, k, base,
                   ids, ids_n, last);
  } else {
    select_pass<8>(keys, grid, s, dist, keys_in, n, seg_len, lower, kr, final_, keys_out, vals, idx, k, base,
                   ids, ids_n, last);
  }
}

// ---------------------------------------------------------------- ivf_score

// A group of kGroup lanes scores one candidate: each lane takes every
// kGroup-th lane of the row (a group reads 32 consecutive bytes of a float32
// row a step), so a warp has 4 rows in flight and a block 32.
constexpr int kGroup = 8;

template <int BT>
__global__ void __launch_bounds__(kThreads)
ivf_score_kernel(const void* __restrict__ bank, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ qmask,
                 const float* __restrict__ q, const int32_t* __restrict__ cells,
                 const int32_t* __restrict__ probe, int64_t C, int W, int nlist, int nprobe, int cap,
                 int64_t n_rows, int metric, float* __restrict__ out, int32_t* __restrict__ ids) {
  extern __shared__ float qv[];
  __shared__ float qsq_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = threadIdx.x % kGroup, group = threadIdx.x / kGroup;
  const int64_t r = blockIdx.y;
  const int p = blockIdx.x;
  for (int d = threadIdx.x; d < W; d += kThreads) qv[d] = q[r * W + d];
  __syncthreads();
  if (warp == 0) {
    float a = 0.0f;
    for (int d = lane; d < W; d += 32) a = fmaf(qv[d], qv[d], a);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
    if (lane == 0) qsq_s = a;
  }
  __syncthreads();
  const float qsq = qsq_s;
  const int cell = probe[r * nprobe + p];
  const bool cell_ok = cell >= 0 && cell < nlist;
  // every lane runs every step (the shuffles below take the whole warp)
  for (int j0 = 0; j0 < cap; j0 += kThreads / kGroup) {
    const int j = j0 + group;
    const int32_t cand = (cell_ok && j < cap) ? cells[static_cast<int64_t>(cell) * cap + j] : -1;
    const bool valid = cand >= 0 && cand < n_rows && cand < C;  // uniform in a group
    float dot = 0.0f, rsq = 0.0f;
    if (valid) {
#pragma unroll 4
      for (int d = sub; d < W; d += kGroup) {
        const float x = bank_at<BT>(bank, scale, cand, W, d);
        dot = fmaf(x, qv[d], dot);
        rsq = fmaf(x, x, rsq);
      }
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(kFull, dot, off);
      rsq += __shfl_xor_sync(kFull, rsq, off);
    }
    if (sub == 0 && j < cap) {
      float dd = INFINITY;
      if (valid) {
        dd = metric_of(metric, dot, qsq, rsq);
        if (bias != nullptr) dd = __fadd_rn(dd, bias[cand]);
        if (qmask != nullptr) dd = __fadd_rn(dd, qmask[cand]);
      }
      const int64_t at = (r * nprobe + p) * cap + j;
      out[at] = dd;
      ids[at] = cand;
    }
  }
}

}  // namespace

// out (R, C) float32: the distances of the R query rows of q (R, W) float32
// to the C rows of bank (C, W; bank_type 0 float32, 1 float16, 2 int8 times
// scale when scale is not null), metric 0 L2, 1 COSINE, 2 IP, plus bias (C,)
// when not null, +inf from row n_rows on, plus qbias (R, C) when not null.
extern "C" int rtpu_knn_score(const void* bank, int bank_type, const void* scale, const void* bias,
                              const void* qbias, const void* q, int64_t C, int W, int64_t R,
                              int64_t n_rows, int metric, void* out, void* stream) {
  if (bank_type < kF32 || bank_type > kI8 || metric < 0 || metric > 2 || W < 1 || C < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const float*>(scale);
  const auto b = static_cast<const float*>(bias);
  const auto qb = static_cast<const float*>(qbias);
  const auto qq = static_cast<const float*>(q);
  const auto o = static_cast<float*>(out);
  if (R <= 8) return static_cast<int>(score_launch<1, 8, 1>(bank_type, bank, sc, b, qb, qq, C, W, R, n_rows, metric, o, s));
  // a narrow bank (the IVF route's centroids) in tiles of 32 rows, so its
  // few tiles still spread over the SMs
  if (C <= kNarrowRows)
    return static_cast<int>(score_launch<16, 4, 2>(bank_type, bank, sc, b, qb, qq, C, W, R, n_rows, metric, o, s));
  return static_cast<int>(score_launch<16, 4, 8>(bank_type, bank, sc, b, qb, qq, C, W, R, n_rows, metric, o, s));
}

// Per row of dist (R, n) float32, its k smallest (dist, column) keys in
// order: vals (R, k) float32 and idx (R, k) int32 (the column, or
// ids[row][column] when ids (R, n) is not null).  1 <= k <= n < 2**31.
// scratch: R * ceil(n / 4096) * min(k, 256) + R uint64.
extern "C" int rtpu_knn_select(const void* dist, int64_t n, int64_t R, int k, const void* ids, void* vals,
                               void* idx, void* scratch, void* stream) {
  if (n < 1 || n >= (int64_t{1} << 31) || R < 1 || R > 65535 || k < 1 || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto d = static_cast<const float*>(dist);
  const auto id = static_cast<const int32_t*>(ids);
  const auto v = static_cast<float*>(vals);
  const auto ix = static_cast<int32_t*>(idx);
  const int64_t segs = (n + kSeg - 1) / kSeg;
  const int kmax = k < kRound ? k : kRound;
  auto keys = static_cast<uint64_t*>(scratch);
  uint64_t* last = keys + R * segs * kmax;
  for (int base = 0; base < k; base += kRound) {
    const int kr = k - base < kRound ? k - base : kRound;
    const uint64_t* lower = base > 0 ? last : nullptr;
    if (segs == 1) {
      select_dispatch(kr, false, dim3(1, static_cast<unsigned>(R)), s, d, nullptr, n, n, lower, true, nullptr,
                      v, ix, k, base, id, n, last);
    } else {
      select_dispatch(kr, false, dim3(static_cast<unsigned>(segs), static_cast<unsigned>(R)), s, d, nullptr, n,
                      kSeg, lower, false, keys, v, ix, k, base, id, n, last);
      const int64_t m = segs * kr;
      select_dispatch(kr, true, dim3(1, static_cast<unsigned>(R)), s, nullptr, keys, m, m, nullptr, true,
                      nullptr, v, ix, k, base, id, n, last);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// out (R, nprobe * cap) float32 and ids (same shape) int32: slot j of cell
// probe[r][p] (cells (nlist, cap) int32) scored against q row r, the bank
// as in rtpu_knn_score, plus bias (C,) and qmask (C,) when not null; a slot
// whose row id is negative or >= n_rows scores +inf.
extern "C" int rtpu_ivf_score(const void* bank, int bank_type, const void* scale, const void* bias,
                              const void* qmask, const void* q, const void* cells, const void* probe,
                              int64_t C, int W, int64_t R, int nlist, int nprobe, int cap, int64_t n_rows,
                              int metric, void* out, void* ids, void* stream) {
  if (bank_type < kF32 || bank_type > kI8 || metric < 0 || metric > 2 || W < 1 || R < 1 || R > 65535 ||
      nprobe < 1 || cap < 1 || nlist < 1 || static_cast<size_t>(W) * 4 > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nprobe), static_cast<unsigned>(R));
  const size_t smem = static_cast<size_t>(W) * sizeof(float);
  const auto sc = static_cast<const float*>(scale);
  const auto b = static_cast<const float*>(bias);
  const auto qm = static_cast<const float*>(qmask);
  const auto qq = static_cast<const float*>(q);
  const auto cl = static_cast<const int32_t*>(cells);
  const auto pr = static_cast<const int32_t*>(probe);
  const auto o = static_cast<float*>(out);
  const auto id = static_cast<int32_t*>(ids);
  if (bank_type == kF32) {
    ivf_score_kernel<kF32><<<grid, kThreads, smem, s>>>(bank, sc, b, qm, qq, cl, pr, C, W, nlist, nprobe, cap,
                                                       n_rows, metric, o, id);
  } else if (bank_type == kF16) {
    ivf_score_kernel<kF16><<<grid, kThreads, smem, s>>>(bank, sc, b, qm, qq, cl, pr, C, W, nlist, nprobe, cap,
                                                       n_rows, metric, o, id);
  } else {
    ivf_score_kernel<kI8><<<grid, kThreads, smem, s>>>(bank, sc, b, qm, qq, cl, pr, C, W, nlist, nprobe, cap,
                                                      n_rows, metric, o, id);
  }
  return static_cast<int>(cudaGetLastError());
}
