// k-means kernels: one Lloyd iteration of the IVF coarse quantizer.
//
// Replaces kmeans_step of redisson_tpu/core/kernels.py (:861), which the
// IVF training runs KMEANS_ITERS times over the bank's host mirror
// (redisson_tpu/services/vector.py:984-1026).  Two entry points:
//
//   kmeans_assign: each point's nearest centroid by the squared L2
//   distance (|p|^2 - 2 p.c) + |c|^2, the first minimum winning; -1 where
//   the point's weight is not > 0 (a dead row).  Bound on an H100: the
//   float32 FMAs of the (N x d) x (d x L) product on the CUDA cores.  One
//   block takes 64 points and walks every tile of 128 centroids with the
//   tiled product of knn_tile.cuh (float32 FMAs, no tensor cores), keeping
//   each point's best (distance, centroid) in registers; the 16 threads that
//   share a point then reduce their bests by (distance, index), so the
//   first minimum wins whatever the thread order.
//
//   kmeans_update: each centroid becomes the weighted mean of its points,
//   sums of (point * weight) and of weights taken in row order, one
//   rounding a term (no FMA contraction), and an empty cell keeps its
//   centroid.  No float atomics: they add in an order that changes from run
//   to run, and the centroids are host state that every later IVF reply
//   depends on, so two trainings must give the same bits.  The rows are
//   first bucketed by assignment with a stable counting sort (row order
//   kept within a bucket), so that each centroid's block reads only its own
//   rows:
//     kmeans_count   counts[c][b], the rows of chunk b (256 rows) assigned
//                    to c (integer adds, the same total in any order);
//     kmeans_tile_sum, kmeans_scan, kmeans_tile_apply
//                    one exclusive prefix over counts read centroid-major,
//                    which makes counts[c][b] the place in the bucketed
//                    order of chunk b's first row of bucket c;
//     kmeans_scatter each row's place: its chunk's offset plus the rows of
//                    its chunk and bucket before it;
//     kmeans_sum     one block a centroid adds its bucket in row order.
//   Dead rows (assigned -1) add nothing: the reference adds them with
//   weight 0, and the bank's dead rows are zeros, so the sums are the same.
//   Bound: the points' bytes, read once.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "knn_tile.cuh"

namespace {

using namespace rtpu_tile;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDimSlots = 4;  // kmeans_update: W <= 4 * 256

// (d, i) before (bd, bi): the smaller distance, then the lower index
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

constexpr int TQT = 16, MQ = 4, MC = 8;

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ pts, const float* __restrict__ w,
                     const float* __restrict__ cent, int64_t N, int W, int L,
                     int32_t* __restrict__ assign) {
  using S = Shape<TQT, MQ, MC>;
  __shared__ Smem<TQT, MQ, MC> sm;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * S::BQ;
  const int tq = threadIdx.x / S::TCT, tc = threadIdx.x % S::TCT;
  float bd[MQ];
  int bi[MQ];
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    bd[i] = INFINITY;
    bi[i] = INT_MAX;
  }
  for (int64_t c0 = 0; c0 < L; c0 += S::BC) {
    float acc[MQ][MC];
    tile_dots<TQT, MQ, MC, kF32>(sm, cent, nullptr, L, W, pts, N, c0, q0, acc);
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const float psq = sm.nrm[S::BC + tq + TQT * i];
#pragma unroll
      for (int j = 0; j < MC; ++j) {  // ascending centroid index within a thread
        const int c = static_cast<int>(c0) + tc + S::TCT * j;
        if (c >= L) continue;
        const float d = l2_of(acc[i][j], psq, sm.nrm[tc + S::TCT * j]);
        if (before(d, c, bd[i], bi[i])) {
          bd[i] = d;
          bi[i] = c;
        }
      }
    }
  }
  // the TCT = 16 threads of a point are one half-warp
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    float d = bd[i];
    int c = bi[i];
#pragma unroll
    for (int off = S::TCT / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, d, off);
      const int oc = __shfl_xor_sync(kFull, c, off);
      if (before(od, oc, d, c)) {
        d = od;
        c = oc;
      }
    }
    const int64_t p = q0 + tq + TQT * i;
    if (tc == 0 && p < N) assign[p] = w[p] > 0.0f ? (c == INT_MAX ? 0 : c) : -1;
  }
}


// counts[c * chunks + b] += 1 for each row of chunk b assigned to c
__global__ void __launch_bounds__(kThreads)
kmeans_count_kernel(const int32_t* __restrict__ assign, int64_t N, int64_t chunks, int32_t* __restrict__ counts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= N) return;
  const int a = assign[i];
  if (a >= 0) atomicAdd(&counts[a * chunks + blockIdx.x], 1);
}

constexpr int kScanThreads = 1024;

// v[0, M) becomes its exclusive prefix sum and v[M] the total, in one
// block (for the tiles' sums, a few thousand at most): each thread sums a
// run of M / 1024 entries, a scan over the threads' sums, then each thread
// rewrites its run.
__global__ void __launch_bounds__(kScanThreads) kmeans_scan_kernel(int32_t* __restrict__ v, int64_t M) {
  __shared__ int32_t part[kScanThreads];
  const int64_t per = (M + kScanThreads - 1) / kScanThreads;
  const int64_t lo = min(M, threadIdx.x * per), hi = min(M, lo + per);
  int32_t own = 0;
  for (int64_t j = lo; j < hi; ++j) own += v[j];
  part[threadIdx.x] = own;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int32_t add = static_cast<int>(threadIdx.x) >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  int32_t run = part[threadIdx.x] - own;
  for (int64_t j = lo; j < hi; ++j) {
    const int32_t c = v[j];
    v[j] = run;
    run += c;
  }
  if (threadIdx.x == kScanThreads - 1) v[M] = part[kScanThreads - 1];
}

// The prefix over counts (L * chunks entries) in three steps: each tile of
// 2,048 entries sums itself, kmeans_scan scans the tiles' sums, and each
// tile rewrites its entries from its offset.
constexpr int kScanPer = 8;
constexpr int kScanTile = kThreads * kScanPer;

// the exclusive prefix of x over the block's threads, and their total
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x, int32_t* total) {
  __shared__ int32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int32_t before = 0, all = 0;
#pragma unroll
  for (int v = 0; v < kThreads / 32; ++v) {
    if (v < warp) before += warp_sums[v];
    all += warp_sums[v];
  }
  *total = all;
  return before + inc - x;
}

__global__ void __launch_bounds__(kThreads)
kmeans_tile_sum_kernel(const int32_t* __restrict__ v, int64_t M, int32_t* __restrict__ tiles) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x;
  int32_t s = 0;
#pragma unroll
  for (int r = 0; r < kScanPer; ++r) {
    const int64_t j = base + kThreads * r;
    if (j < M) s += v[j];
  }
  int32_t total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
kmeans_tile_apply_kernel(int32_t* __restrict__ v, int64_t M, const int32_t* __restrict__ tiles) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile + static_cast<int64_t>(threadIdx.x) * kScanPer;
  int32_t x[kScanPer];
  int32_t s = 0;
#pragma unroll
  for (int r = 0; r < kScanPer; ++r) {
    x[r] = base + r < M ? v[base + r] : 0;
    s += x[r];
  }
  int32_t total;
  int32_t run = tiles[blockIdx.x] + block_exclusive_scan(s, &total);
#pragma unroll
  for (int r = 0; r < kScanPer; ++r) {
    if (base + r < M) v[base + r] = run;
    run += x[r];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) v[M] = tiles[gridDim.x];
}

// order[offs[a][b] + (rows of chunk b before i assigned to a)] = i
__global__ void __launch_bounds__(kThreads)
kmeans_scatter_kernel(const int32_t* __restrict__ assign, int64_t N, int64_t chunks,
                      const int32_t* __restrict__ offs, int32_t* __restrict__ order) {
  __shared__ int32_t chunk[kThreads];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int a = i < N ? assign[i] : -1;
  chunk[threadIdx.x] = a;
  __syncthreads();
  if (a < 0) return;
  int rank = 0;
  for (int j = 0; j < static_cast<int>(threadIdx.x); ++j) rank += chunk[j] == a;
  order[offs[a * chunks + blockIdx.x] + rank] = static_cast<int32_t>(i);
}

__global__ void __launch_bounds__(kThreads)
kmeans_sum_kernel(const float* __restrict__ pts, const float* __restrict__ w,
                  const float* __restrict__ cent, const int32_t* __restrict__ offs, int64_t chunks,
                  const int32_t* __restrict__ order, int W, float* __restrict__ out) {
  const int c = blockIdx.x;
  // bucket c is order[offs[c][0], offs[c + 1][0]); offs[L][0] is the total
  const int32_t lo = offs[c * chunks], hi = offs[(c + 1) * chunks];
  float acc[kMaxDimSlots];
#pragma unroll
  for (int r = 0; r < kMaxDimSlots; ++r) acc[r] = 0.0f;
  float count = 0.0f;  // every thread keeps the same count, in the same order
  for (int32_t t = lo; t < hi; ++t) {
    const int64_t row = order[t];
    const float wr = w[row];
#pragma unroll
    for (int r = 0; r < kMaxDimSlots; ++r) {
      const int d = threadIdx.x + kThreads * r;
      if (d < W) acc[r] = __fadd_rn(acc[r], __fmul_rn(pts[row * W + d], wr));
    }
    count = __fadd_rn(count, wr);
  }
  const float denom = count > 1.0f ? count : 1.0f;
#pragma unroll
  for (int r = 0; r < kMaxDimSlots; ++r) {
    const int d = threadIdx.x + kThreads * r;
    if (d < W) {
      const int64_t at = static_cast<int64_t>(c) * W + d;
      out[at] = count > 0.0f ? __fdiv_rn(acc[r], denom) : cent[at];
    }
  }
}

}  // namespace

// assign (N,) int32: the nearest centroid of cent (L, W) float32 to each
// point of pts (N, W) float32, -1 where w (N,) is not > 0.
extern "C" int rtpu_kmeans_assign(const void* pts, const void* w, const void* cent, int64_t N, int W, int L,
                                  void* assign, void* stream) {
  if (N < 1 || W < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  using S = Shape<TQT, MQ, MC>;
  kmeans_assign_kernel<<<static_cast<unsigned>((N + S::BQ - 1) / S::BQ), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(w), static_cast<const float*>(cent), N, W, L,
      static_cast<int32_t*>(assign));
  return static_cast<int>(cudaGetLastError());
}

// new_cent (L, W) float32: the weighted means of the cells that assign
// (N,) int32 gives, in row order (an empty cell keeps its centroid of
// cent).  scratch holds M + 1 + N + ceil(M / 2048) + 1 int32, M = L *
// ceil(N / 256).  W <= 1024.
extern "C" int rtpu_kmeans_update(const void* pts, const void* w, const void* cent, const void* assign,
                                  int64_t N, int W, int L, void* scratch, void* new_cent, void* stream) {
  if (N < 1 || N >= INT_MAX || W < 1 || W > kThreads * kMaxDimSlots || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const int32_t*>(assign);
  const int64_t chunks = (N + kThreads - 1) / kThreads;
  const int64_t M = static_cast<int64_t>(L) * chunks;
  const auto offs = static_cast<int32_t*>(scratch);
  int32_t* order = offs + M + 1;
  const cudaError_t err = cudaMemsetAsync(offs, 0, M * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kmeans_count_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, s>>>(a, N, chunks, offs);
  const int64_t n_tiles = (M + kScanTile - 1) / kScanTile;
  int32_t* tiles = order + N;
  kmeans_tile_sum_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(offs, M, tiles);
  kmeans_scan_kernel<<<1, kScanThreads, 0, s>>>(tiles, n_tiles);
  kmeans_tile_apply_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(offs, M, tiles);
  kmeans_scatter_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, s>>>(a, N, chunks, offs, order);
  kmeans_sum_kernel<<<static_cast<unsigned>(L), kThreads, 0, s>>>(
      static_cast<const float*>(pts), static_cast<const float*>(w), static_cast<const float*>(cent), offs, chunks,
      order, W, static_cast<float*>(new_cent));
  return static_cast<int>(cudaGetLastError());
}
