// k-means kernels: one Lloyd iteration of the IVF coarse quantizer.
//
// Replaces kmeans_step of redisson_tpu/core/kernels.py (:861), which the
// IVF training runs KMEANS_ITERS times over the bank's host mirror
// (redisson_tpu/services/vector.py:984-1026).  Two entry points:
//
//   kmeans_assign: each point's nearest centroid by the squared L2
//   distance (|p|^2 - 2 p.c) + |c|^2, the first minimum winning; -1 where
//   the point's weight is not > 0 (a dead row).  One launch a call, by one
//   of two routes (kernels.kmeans_assign_route picks one):
//     * the tensor-core route (kmeans_mma_kernel, W <= 256): the product
//       (N x W) x (W x L) in 3xTF32 on mma.sync.m16n8k8.  Each operand x is
//       split as it is loaded into a fragment, hi = tf32(x) and lo =
//       tf32(x - hi), and each dot is the float32 sum of lo*hi + hi*lo +
//       hi*hi (lo*lo dropped): within a few float32 ulps of the product
//       of the terms, where one TF32 product keeps ~3 digits.  A block of
//       256 threads keeps 128 points resident in shared memory as float32
//       (the depth zero-padded to a multiple of 32) and streams the
//       centroids, 64 rows by 32 deep at a time, through a three-stage
//       cp.async ring (16-byte copies when the rows and bases allow,
//       4-byte ones otherwise); each warp owns 32 points x 32 centroids of
//       a tile.  The epilogue forms each distance as l2_of does, keeps
//       every point's best (distance, centroid) in registers (centroids
//       past L never compete), and the threads and the two warps that share
//       a point reduce their bests by (distance, index).  Bound on an H100:
//       the three TF32 products at 495 TFLOP/s (the float32 FMAs at 67
//       TFLOP/s bound the tile route).  It runs at about a quarter of that
//       bound.  What holds it is inferred, not profiled (ncu does not run
//       on the card), from one-edit builds timed against it by
//       tools/variant_ab.py on an H100 80GB HBM3 at 700 W (PERF.md): 0.458 ms
//       at 50,000 x 128 x 1,536; the same three mma.sync products of the
//       high parts, with no split, 0.349; one product, 0.242.  So the
//       splits take about a quarter of the time, two of the three
//       products about another quarter, and one product with the rest
//       (the shared-memory fragment loads, the ring's waits, the epilogue)
//       the other half;
//     * the tile route (kmeans_assign_kernel, any W): one block takes 64
//       points and walks every tile of 128 centroids with the tiled float32
//       product of knn_tile.cuh on the CUDA cores.
//   No distance matrix is written and no float atomics are used: two runs
//   give the same bits, and the first minimum wins whatever the thread
//   order.
//
//   kmeans_update: each centroid becomes the weighted mean of its points,
//   sums of (point * weight) and of weights taken in row order, one
//   rounding a term (no FMA contraction), and an empty cell keeps its
//   centroid.  No float atomics: they add in an order that changes from run
//   to run, and the centroids are host state that every later IVF reply
//   depends on, so two trainings must give the same bits.  Two launches
//   and no memset:
//     kmeans_bucket_kernel  one block a tile of R >= 512 rows (at most 128
//                    tiles): the tile's cells counted in shared memory,
//                    their prefix written as the tile's run places (L + 1
//                    int32), and one warp walks the tile's rows in order,
//                    ranking equal cells by __match_any_sync, so each run
//                    keeps row order;
//     kmeans_mean_kernel  one block a cell: its runs' places from every
//                    tile, a block prefix laying them end to end (tile
//                    order is row order), the bucket's row ids and weights
//                    staged 1,024 at a time in shared memory, then each
//                    thread adds its dimensions over them in order with
//                    eight rows' loads in flight.
//   No global prefix and no memset: each launch would cost about the
//   timing's floor (a counting sort in seven launches took 0.0579 ms, 0.0253
//   of it bucketing).  At 50,000 x 128 x 1,536 the two take 0.0267 ms
//   against a bound of 0.0082 (the bytes of points, weights, cells and
//   centroids once) on an H100 80GB HBM3 at 700 W (tools/kernel_ab.py).
//   Dead rows (assigned -1) add nothing: the reference adds them with
//   weight 0, and the bank's dead rows are zeros, so the sums are the same.
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

#include "cp_async.cuh"
#include "knn_tile.cuh"

namespace {

using namespace rtpu_cp;
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


// -- the tensor-core route --------------------------------------------------

constexpr int kBM = 128, kBN = 64, kBK = 32, kStages = 3;
constexpr int kSB = kBK + 4;  // a staged centroid row, in floats
constexpr int kMmaMaxW = 256;

// rows r0 .. r0 + rows of a (R, W) float32 matrix, columns k0 .. k0 + cols,
// into shared rows of `stride` floats; past R or W reads 0.  VEC: 16-byte
// copies (W % 4 == 0 and a 16-byte aligned base), else one float a copy.
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* src, int64_t R, int W,
                                           int64_t r0, int rows, int k0, int cols) {
  constexpr int kPer = VEC ? 4 : 1;
  const int per_row = cols / kPer;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, k = (e - r * per_row) * kPer;
    const int64_t gr = r0 + r;
    const int gk = k0 + k;
    const bool ok = gr < R && gk < W;
    if (VEC) {
      cp_async16(dst + r * stride + k, ok ? src + gr * W + gk : src, ok ? 16 : 0);
    } else {
      cp_async4(dst + r * stride + k, ok ? src + gr * W + gk : src, ok ? 4 : 0);
    }
  }
}

// x = hi + lo + (what neither keeps): hi the nearest TF32 value to x, lo
// the nearest to x - hi (exact in float32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(__fsub_rn(x, __uint_as_float(hi))));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__host__ __device__ constexpr int mma_depth(int W) { return (W + kBK - 1) / kBK * kBK; }

// shared floats: the points (kBM rows of depth + 4), the ring (kStages x
// kBN rows of kSB), the points' and the tile's norms, and the two warps'
// bests of each point (distances, then indexes as int32)
__host__ __device__ constexpr size_t mma_smem(int W) {
  return sizeof(float) * (static_cast<size_t>(kBM) * (mma_depth(W) + 4) + kStages * kBN * kSB + kBM + kBN + 4 * kBM);
}

// Warps are 4 (points) x 2 (centroids); warp (wm, wn) owns points wm * 32
// .. + 32 and centroids wn * 32 .. + 32 of each tile: 2 x 4 m16n8 tiles.
// In a fragment, lane (g = lane / 4, t = lane % 4) holds A rows g and g + 8
// at columns t and t + 4, B column g at rows t and t + 4, and the sums of
// rows g and g + 8 at columns 2t and 2t + 1.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
kmeans_mma_kernel(const float* __restrict__ pts, const float* __restrict__ w, const float* __restrict__ cent,
                  int64_t N, int W, int L, int32_t* __restrict__ assign) {
  extern __shared__ __align__(16) float smem[];
  const int depth = mma_depth(W), sa = depth + 4;  // sa % 32 == 4: fragment loads hit 32 banks
  float* as = smem;
  float* ring = as + kBM * sa;
  float* pn = ring + kStages * kBN * kSB;
  float* cn = pn + kBM;
  float* best_d = cn + kBN;
  int* best_i = reinterpret_cast<int*>(best_d + 2 * kBM);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int nk = depth / kBK, tiles = (L + kBN - 1) / kBN, total = tiles * nk;

  stage_rows<VEC>(as, sa, pts, N, W, q0, kBM, 0, depth);
  cp_async_commit();
  int next_tile = 0, next_k = 0;  // the chunk to copy next
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) {
      stage_rows<VEC>(ring + s * kBN * kSB, kSB, cent, L, W, static_cast<int64_t>(next_tile) * kBN, kBN,
                      next_k * kBK, kBK);
      if (++next_k == nk) next_k = 0, ++next_tile;
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the points have landed
  __syncthreads();
  {  // |p|^2: two threads a point, half the depth each
    const int r = tid >> 1, k0 = (tid & 1) * (depth / 2);
    float s = 0.0f;
    for (int k = 0; k < depth / 2; ++k) s = fmaf(as[r * sa + k0 + k], as[r * sa + k0 + k], s);
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 1));
    if ((tid & 1) == 0) pn[r] = s;
  }
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  float bd[4];
  int bi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bd[i] = INFINITY;
    bi[i] = INT_MAX;
  }
  // |c|^2 of centroid tid / 4 of a tile: four threads, each the depth
  // columns tid % 4 + 4j of every chunk
  const int nrow = tid >> 2, npart = tid & 3;
  float cpart = 0.0f;
  int slot = 0, kc = 0, tile = 0;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();  // chunk s has landed (this thread's copies)
    __syncthreads();               // everyone's copies; the slot chunk s - 1 used is free
    if (s + kStages - 1 < total) {
      const int fill = slot == 0 ? kStages - 1 : slot - 1;
      stage_rows<VEC>(ring + fill * kBN * kSB, kSB, cent, L, W, static_cast<int64_t>(next_tile) * kBN, kBN,
                      next_k * kBK, kBK);
      if (++next_k == nk) next_k = 0, ++next_tile;
    }
    cp_async_commit();
    const float* st = ring + slot * kBN * kSB;
    const float* at = as + kc * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = at + (wm * 32 + i * 16 + g) * sa + kk + t;
        split_tf32(a[0], ah[i][0], al[i][0]);
        split_tf32(a[8 * sa], ah[i][1], al[i][1]);
        split_tf32(a[4], ah[i][2], al[i][2]);
        split_tf32(a[8 * sa + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* b = st + (wn * 32 + j * 8 + g) * kSB + kk + t;
        split_tf32(b[0], bh[j][0], bl[j][0]);
        split_tf32(b[4], bh[j][1], bl[j][1]);
      }
      // the small products first, then the large one, into one float32 sum
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], al[i], bh[j]);
          mma_tf32(acc[i][j], ah[i], bl[j]);
          mma_tf32(acc[i][j], ah[i], bh[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float v = st[nrow * kSB + npart + 4 * j];
      cpart = fmaf(v, v, cpart);
    }
    if (++slot == kStages) slot = 0;
    if (++kc < nk) continue;
    // the tile's last chunk: its norms, then every point's best
    kc = 0;
    float cs = __fadd_rn(cpart, __shfl_xor_sync(kFull, cpart, 1));
    cs = __fadd_rn(cs, __shfl_xor_sync(kFull, cs, 2));
    if (npart == 0) cn[nrow] = cs;
    cpart = 0.0f;
    __syncthreads();
    const int c0 = tile * kBN;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float psq = pn[wm * 32 + i * 16 + h * 8 + g];
#pragma unroll
        for (int j = 0; j < 4; ++j)  // ascending centroid index within a thread
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = wn * 32 + j * 8 + 2 * t + e;
            const float d = l2_of(acc[i][j][2 * h + e], psq, cn[cl]);
            if (c0 + cl < L && before(d, c0 + cl, bd[2 * i + h], bi[2 * i + h])) {
              bd[2 * i + h] = d;
              bi[2 * i + h] = c0 + cl;
            }
            acc[i][j][2 * h + e] = 0.0f;
          }
      }
    ++tile;
  }
  cp_async_wait<0>();
  // a point's bests: the four lanes of its quad, then the two warps
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float od = __shfl_xor_sync(kFull, bd[r], off);
      const int oc = __shfl_xor_sync(kFull, bi[r], off);
      if (before(od, oc, bd[r], bi[r])) {
        bd[r] = od;
        bi[r] = oc;
      }
    }
    if (t == 0) {
      const int rl = wm * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
      best_d[wn * kBM + rl] = bd[r];
      best_i[wn * kBM + rl] = bi[r];
    }
  }
  __syncthreads();
  if (tid < kBM && q0 + tid < N) {
    float d = best_d[tid];
    int c = best_i[tid];
    if (before(best_d[kBM + tid], best_i[kBM + tid], d, c)) c = best_i[kBM + tid];
    const int64_t p = q0 + tid;
    assign[p] = w[p] > 0.0f ? (c == INT_MAX ? 0 : c) : -1;
  }
}

// Raise the kernel's shared-memory limit to the widest rows it takes, once
// per device.
template <bool VEC>
cudaError_t mma_prepare() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && ready[dev].load(std::memory_order_relaxed))) return err;
  err = cudaFuncSetAttribute(kmeans_mma_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(mma_smem(kMmaMaxW)));
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <bool VEC>
cudaError_t mma_launch(const float* pts, const float* w, const float* cent, int64_t N, int W, int L,
                       int32_t* assign, cudaStream_t s) {
  const cudaError_t err = mma_prepare<VEC>();
  if (err != cudaSuccess) return err;
  kmeans_mma_kernel<VEC><<<static_cast<unsigned>((N + kBM - 1) / kBM), kThreads, mma_smem(W), s>>>(
      pts, w, cent, N, W, L, assign);
  return cudaGetLastError();
}

// -- kmeans_update ------------------------------------------------------------

constexpr int kTileRows = 512;    // a tile's rows, at least
constexpr int kMaxTiles = 128;    // tiles a call, at most (one a thread of the mean kernel)
constexpr int kHistCells = 8192;  // cells counted a pass of the bucket kernel
constexpr int kWindow = 1024;     // rows a mean block stages at once

// The tiling of N rows: R rows a tile (a multiple of 32), B = ceil(N / R)
// <= kMaxTiles tiles.
__host__ __device__ __forceinline__ int64_t tile_rows(int64_t N) {
  const int64_t need = (N + kMaxTiles - 1) / kMaxTiles;
  const int64_t r = (need + 31) / 32 * 32;
  return r > kTileRows ? r : kTileRows;
}

// The exclusive prefix of x over the block's threads (blockDim.x a multiple
// of 32, at most 1,024), and their total.  Starts with a barrier, so calls
// may follow each other.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x, int32_t* total) {
  __shared__ int32_t warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int32_t inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  __syncthreads();
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int32_t before = 0, all = 0;
  for (int v = 0; v < warps; ++v) {
    const int32_t s = warp_sums[v];
    if (v < warp) before += s;
    all += s;
  }
  *total = all;
  return before + inc - x;
}

// One block a tile of R rows: the tile's live rows (0 <= assign < L)
// bucketed by cell in row order into order[b * R, b * R + live), and
// lst[b][c] (L + 1 a tile) the place in it of cell c's first row
// (lst[b][L] = live).  Cells are counted kHistCells a pass in shared memory
// (integer adds: the same counts in any order); one warp then walks the
// tile's rows in order, 32 at a time, giving equal cells ranks by
// __match_any_sync, so a bucket keeps row order.
__global__ void __launch_bounds__(kThreads)
kmeans_bucket_kernel(const int32_t* __restrict__ assign, int64_t N, int L, int64_t R, int32_t* __restrict__ lst,
                     int32_t* __restrict__ order) {
  __shared__ int32_t hist[kHistCells];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int rows = static_cast<int>(min(R, N - row0));
  const int32_t* a_t = assign + row0;
  int32_t* lst_t = lst + static_cast<int64_t>(blockIdx.x) * (L + 1);
  int32_t* ord_t = order + row0;
  int32_t base = 0;  // the tile's live rows in cells before this pass
  for (int c0 = 0; c0 < L; c0 += kHistCells) {
    const int cells = min(kHistCells, L - c0);
    for (int i = threadIdx.x; i < cells; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      const int a = a_t[i] - c0;
      if (a >= 0 && a < cells) atomicAdd(&hist[a], 1);
    }
    __syncthreads();
    for (int i0 = 0; i0 < cells; i0 += kThreads) {  // exclusive prefix, kThreads cells at a time
      const int i = i0 + threadIdx.x;
      const int32_t x = i < cells ? hist[i] : 0;
      int32_t total;
      const int32_t at = base + block_exclusive_scan(x, &total);
      if (i < cells) {
        hist[i] = at;
        lst_t[c0 + i] = at;
      }
      base += total;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const unsigned lower = (1u << threadIdx.x) - 1u;
      for (int i0 = 0; i0 < rows; i0 += 32) {
        const int i = i0 + threadIdx.x;
        int a = i < rows ? a_t[i] - c0 : -1;
        if (a >= cells) a = -1;
        const unsigned same = __match_any_sync(kFull, a);
        const int at = a >= 0 ? hist[a] : 0;
        __syncwarp();
        if (a >= 0) {
          ord_t[at + __popc(same & lower)] = static_cast<int32_t>(row0 + i);
          if (threadIdx.x == 31 - __clz(same)) hist[a] = at + __popc(same);
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) lst_t[L] = base;
}

// One block a cell c: thread t < B reads tile t's run of c (lst), a block
// prefix places the runs one after another (tile order, so row order), and
// the block stages the bucket's row ids and weights kWindow at a time in
// shared memory (each slot finds its tile by a binary search of the runs'
// places) and adds them in that order: DIMS dimensions a thread, eight rows'
// loads in flight before their adds, one rounding a term.
template <int DIMS>
__global__ void __launch_bounds__(kThreads)
kmeans_mean_kernel(const float* __restrict__ pts, const float* __restrict__ w, const float* __restrict__ cent,
                   const int32_t* __restrict__ lst, const int32_t* __restrict__ order, int B, int64_t R, int L, int W,
                   float* __restrict__ out) {
  __shared__ int32_t run_at[kMaxTiles + 1], run_lo[kMaxTiles];
  __shared__ int32_t rows_s[kWindow];
  __shared__ float w_s[kWindow];
  const int c = blockIdx.x;
  int32_t lo = 0, n = 0;
  if (static_cast<int>(threadIdx.x) < B) {
    const int32_t* l = lst + static_cast<int64_t>(threadIdx.x) * (L + 1) + c;
    lo = l[0];
    n = l[1] - lo;
  }
  int32_t total;
  const int32_t at = block_exclusive_scan(n, &total);
  if (static_cast<int>(threadIdx.x) < B) {
    run_at[threadIdx.x] = at;
    run_lo[threadIdx.x] = lo;
  }
  if (threadIdx.x == 0) run_at[B] = total;
  float acc[DIMS];
#pragma unroll
  for (int r = 0; r < DIMS; ++r) acc[r] = 0.0f;
  float count = 0.0f;  // every thread keeps the same count, in the same order
  for (int32_t w0 = 0; w0 < total; w0 += kWindow) {
    const int m = min(kWindow, total - w0);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      const int32_t p = w0 + k;
      int lo_t = 0, hi_t = B - 1;  // the last tile whose run starts at or before p
      while (lo_t < hi_t) {
        const int mid = (lo_t + hi_t + 1) >> 1;
        if (run_at[mid] <= p) lo_t = mid;
        else hi_t = mid - 1;
      }
      const int32_t row = order[lo_t * R + run_lo[lo_t] + (p - run_at[lo_t])];
      rows_s[k] = row;
      w_s[k] = w[row];
    }
    __syncthreads();
    int k = 0;
    for (; k + 8 <= m; k += 8) {
      float v[8][DIMS];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* p = pts + static_cast<int64_t>(rows_s[k + u]) * W;
#pragma unroll
        for (int r = 0; r < DIMS; ++r) {
          const int d = threadIdx.x + blockDim.x * r;
          v[u][r] = d < W ? p[d] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float wr = w_s[k + u];
#pragma unroll
        for (int r = 0; r < DIMS; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(v[u][r], wr));
        count = __fadd_rn(count, wr);
      }
    }
    for (; k < m; ++k) {
      const float* p = pts + static_cast<int64_t>(rows_s[k]) * W;
      const float wr = w_s[k];
#pragma unroll
      for (int r = 0; r < DIMS; ++r) {
        const int d = threadIdx.x + blockDim.x * r;
        acc[r] = __fadd_rn(acc[r], __fmul_rn(d < W ? p[d] : 0.0f, wr));
      }
      count = __fadd_rn(count, wr);
    }
  }
  const float denom = count > 1.0f ? count : 1.0f;
#pragma unroll
  for (int r = 0; r < DIMS; ++r) {
    const int d = threadIdx.x + blockDim.x * r;
    if (d < W) {
      const int64_t o = static_cast<int64_t>(c) * W + d;
      out[o] = count > 0.0f ? __fdiv_rn(acc[r], denom) : cent[o];
    }
  }
}

}  // namespace

// assign (N,) int32: the nearest centroid of cent (L, W) float32 to each
// point of pts (N, W) float32, -1 where w (N,) is not > 0.  route 0: the
// tile route (any W); 1: the tensor-core route (W <= 256), with 16-byte
// copies when W % 4 == 0 and both matrices are 16-byte aligned.
extern "C" int rtpu_kmeans_assign(const void* pts, const void* w, const void* cent, int64_t N, int W, int L,
                                  int route, void* assign, void* stream) {
  if (N < 1 || W < 1 || L < 1 || route < 0 || route > 1 || (route == 1 && W > kMmaMaxW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float*>(pts), c = static_cast<const float*>(cent);
  const auto wt = static_cast<const float*>(w);
  const auto a = static_cast<int32_t*>(assign);
  if (route == 1) {
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(c) % 16 == 0;
    return static_cast<int>(vec ? mma_launch<true>(p, wt, c, N, W, L, a, s)
                                : mma_launch<false>(p, wt, c, N, W, L, a, s));
  }
  using S = Shape<TQT, MQ, MC>;
  kmeans_assign_kernel<<<static_cast<unsigned>((N + S::BQ - 1) / S::BQ), kThreads, 0, s>>>(p, wt, c, N, W, L, a);
  return static_cast<int>(cudaGetLastError());
}

// int32 of scratch rtpu_kmeans_update takes for N rows and L cells: B x
// (L + 1) run places and N bucketed row ids.
extern "C" int64_t rtpu_kmeans_update_scratch(int64_t N, int L) {
  const int64_t R = tile_rows(N);
  return (N + R - 1) / R * (static_cast<int64_t>(L) + 1) + N;
}

// new_cent (L, W) float32: the weighted means of the cells that assign
// (N,) int32 gives, in row order (an empty cell keeps its centroid of
// cent; an assignment outside [0, L) adds nothing).  scratch holds
// rtpu_kmeans_update_scratch(N, L) int32.  Two launches: the bucket
// kernel, then the mean kernel.  W <= 1024.
extern "C" int rtpu_kmeans_update(const void* pts, const void* w, const void* cent, const void* assign,
                                  int64_t N, int W, int L, void* scratch, void* new_cent, void* stream) {
  if (N < 1 || N >= INT_MAX || W < 1 || W > kThreads * kMaxDimSlots || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t R = tile_rows(N);
  const int B = static_cast<int>((N + R - 1) / R);
  const auto lst = static_cast<int32_t*>(scratch);
  int32_t* order = lst + static_cast<int64_t>(B) * (L + 1);
  kmeans_bucket_kernel<<<B, kThreads, 0, s>>>(static_cast<const int32_t*>(assign), N, L, R, lst, order);
  const auto p = static_cast<const float*>(pts), wt = static_cast<const float*>(w);
  const auto c = static_cast<const float*>(cent);
  const auto o = static_cast<float*>(new_cent);
  // a thread a dimension up to W 128 (blocks of 128), else blocks of 256
  // with up to four dimensions a thread
  const int threads = W <= 128 ? 128 : kThreads;
  switch ((W + threads - 1) / threads) {
    case 1: kmeans_mean_kernel<1><<<L, threads, 0, s>>>(p, wt, c, lst, order, B, R, L, W, o); break;
    case 2: kmeans_mean_kernel<2><<<L, threads, 0, s>>>(p, wt, c, lst, order, B, R, L, W, o); break;
    case 3: kmeans_mean_kernel<3><<<L, threads, 0, s>>>(p, wt, c, lst, order, B, R, L, W, o); break;
    default: kmeans_mean_kernel<4><<<L, threads, 0, s>>>(p, wt, c, lst, order, B, R, L, W, o); break;
  }
  return static_cast<int>(cudaGetLastError());
}
