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
// (2 R C W operations at 67 TFLOP/s), the bank's and the output's bytes
// close behind; for 8 queries or fewer, the bank's bytes.  Products are
// float32 FMAs summed in depth order, never TF32, so two runs give the same
// bits.  Two designs; kernels.knn_score_route picks one a call:
//   * the streamed route (knn_stream_kernel, below): persistent blocks, two
//     a SM, each holding 64 queries (8 for R <= 8) and their norms in shared
//     memory and streaming the bank through a ring of cp.async copies, so
//     loads overlap the products; 16 x 4 products a thread from 16-byte
//     shared loads, the bank-row norms from the staged chunk, 16-byte
//     stores.  What holds it at ~40% of the FMA peak at 1M x 128 is the
//     shared-memory loads (20 of 16 bytes a thread per 256 FMAs, the
//     queries' broadcast to a whole warp) with only 16 warps a SM to hide
//     their latency: a 16 x 8 tile (one block a SM) and an 8 x 8 one (INT8
//     and FLOAT16 much slower) were no faster (PERF.md);
//   * the tile route (tile_dots, knn_tile.cuh; knn_score_kernel): one block
//     an output tile, both operands staged a depth step at a time, with no
//     overlap of loads and products.  It stays for more than 8 queries
//     against a bank of at most 16,384 rows (the IVF route's 1,536
//     centroids: 6 streamed tiles leave most SMs idle, and its 48 tiles of
//     32 rows take half the streamed time) and for W > 256, which the
//     streamed route's resident query block does not hold.
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

#include <atomic>
#include <cmath>
#include <cstdint>

#include "knn_tile.cuh"

namespace {

using namespace rtpu_tile;

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- knn_score

// The tile route: tile_dots (knn_tile.cuh), one block an output tile.
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

// The streamed route.  A persistent block keeps a block of BQ = 4 MQ query
// rows (zero-padded to the staged depth) and their norms in shared memory
// and walks the bank in tiles of kSRows rows, the tiles of its stride in
// turn, two blocks a SM.  A tile's depth is staged in chunks of 128 bytes a
// row (32 FLOAT32, 64 FLOAT16 or 128 INT8 elements, left as raw bytes, so
// INT8 moves a quarter of FLOAT32's bytes) through a ring of kSStages
// buffers, each filled by 16-byte cp.async copies (by element loads when a
// row's bytes or the bank's base are not 16-byte aligned), so the next
// chunk streams in while this one is multiplied.  Thread (tq, tc) of warp w
// (tq = w / 2, tc = 32 (w % 2) + lane) adds the MQ x 4 products of query
// rows tq MQ + i and bank rows 4 tc + m: per 4 depth steps, four 16-byte
// loads of bank pieces (widened to float32 here, INT8 times its row's
// scale) and MQ broadcast loads of query float4s for 16 MQ FMAs.  Thread t
// also sums the squares of bank row nrow(t) from the same chunk.  Pieces of
// a staged row are XOR swizzled by the row's group of 4, so the copies, the
// product loads and the norm loads all meet eight different 16-byte bank
// groups in each phase of eight lanes.  The epilogue is knn_score_kernel's,
// with 16-byte stores where the output row allows them.  Chunk indices step
// without divisions (64-bit divisions are software routines on the card).

constexpr int kChunk = 128;             // bytes a staged row holds: 8 pieces
constexpr int kMaxDepth = 256;          // staged depth the query block holds
constexpr int kSStages = 2;             // a ring of two stages

template <int BT>
struct Elem {
  static constexpr int kBytes = BT == kF32 ? 4 : (BT == kF16 ? 2 : 1);
  static constexpr int kPerChunk = kChunk / kBytes;   // depth a chunk holds
  static constexpr int kSteps = 4 / kBytes;           // 4-deep steps a 16-byte piece holds
};

constexpr int kSRows = 256;  // bank rows a tile: 64 groups of 4
constexpr int kStageBytes = kSRows * kChunk;

// Shared memory of a block of bq query rows at a staged depth: the stages,
// the query rows (depth + 4 floats each: the padding keeps the norms' loads
// free of bank conflicts), their norms and the tile's bank-row norms.
constexpr size_t stream_smem(int bq, int depth) {
  return static_cast<size_t>(kSStages) * kStageBytes +
         sizeof(float) * (static_cast<size_t>(bq) * (depth + 4) + bq + kSRows);
}

// Byte offset of 16-byte piece p of staged row r.
__device__ __forceinline__ int piece_at(int r, int p) { return r * kChunk + ((p ^ ((r >> 2) & 7)) << 4); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Chunk kc (depth kc * kPerChunk on) of bank rows c0 .. c0 + kSRows into a
// stage; bytes past a row's end and rows past C read as 0.
template <int BT, bool VEC>
__device__ __forceinline__ void stage_chunk(uint8_t* st, const void* bank, int64_t C, int W, int64_t c0,
                                            int kc) {
  using E = Elem<BT>;
  const auto b = static_cast<const uint8_t*>(bank);
  const int64_t row_bytes = static_cast<int64_t>(W) * E::kBytes;
  if (VEC) {
    // lanes 8j .. 8j + 7 copy one row's 128 bytes
#pragma unroll 4
    for (int e = threadIdx.x; e < kSRows * 8; e += kThreads) {
      const int r = e >> 3, p = e & 7;
      const int64_t gr = c0 + r, off = static_cast<int64_t>(kc) * kChunk + 16 * p;
      const bool ok = gr < C && off < row_bytes;
      cp_async16(st + piece_at(r, p), ok ? b + gr * row_bytes + off : b, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kSRows * E::kPerChunk; e += kThreads) {
      const int r = e / E::kPerChunk, k = e % E::kPerChunk;
      const int64_t gr = c0 + r;
      const int gk = kc * E::kPerChunk + k;
      const bool ok = gr < C && gk < W;
      uint8_t* dst = st + piece_at(r, (k * E::kBytes) >> 4) + ((k * E::kBytes) & 15);
      if (BT == kF32) {
        *reinterpret_cast<float*>(dst) = ok ? static_cast<const float*>(bank)[gr * W + gk] : 0.0f;
      } else if (BT == kF16) {
        *reinterpret_cast<uint16_t*>(dst) = ok ? static_cast<const uint16_t*>(bank)[gr * W + gk] : 0;
      } else {
        *dst = ok ? b[gr * W + gk] : 0;
      }
    }
  }
}

// Depth step s (4 elements) of a raw 16-byte piece, widened to float32:
// FLOAT16 as it is, INT8 times its row's scale sc (1 without a scale).
template <int BT>
__device__ __forceinline__ void widen4(const uint4& raw, int s, float sc, float (&v)[4]) {
  if (BT == kF32) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  } else if (BT == kF16) {
    const uint32_t lo = s == 0 ? raw.x : raw.z, hi = s == 0 ? raw.y : raw.w;
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&lo));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&hi));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
    const uint32_t w = s == 0 ? raw.x : (s == 1 ? raw.y : (s == 2 ? raw.z : raw.w));
#pragma unroll
    for (int t = 0; t < 4; ++t)
      v[t] = __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> (8 * t))), sc);
  }
}

// The products of one staged chunk, added in depth order.
template <int MQ, int BT>
__device__ __forceinline__ void chunk_dots(const uint8_t* st, const float* qs, int qstride, int kc, int tq,
                                           int tc, const float (&sc)[4], float (&acc)[MQ][4]) {
  using E = Elem<BT>;
#pragma unroll 2
  for (int p = 0; p < 8; ++p) {
    uint4 raw[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      raw[m] = *reinterpret_cast<const uint4*>(st + (4 * tc + m) * kChunk + ((p ^ (tc & 7)) << 4));
#pragma unroll
    for (int s = 0; s < E::kSteps; ++s) {
      float b[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) widen4<BT>(raw[m], s, sc[m], b[m]);
      const float* qk = qs + kc * E::kPerChunk + p * (16 / E::kBytes) + 4 * s;
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qk + (tq * MQ + i) * qstride);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[i][m] = fmaf(a.x, b[m][0], acc[i][m]);
          acc[i][m] = fmaf(a.y, b[m][1], acc[i][m]);
          acc[i][m] = fmaf(a.z, b[m][2], acc[i][m]);
          acc[i][m] = fmaf(a.w, b[m][3], acc[i][m]);
        }
      }
    }
  }
}

// bn plus the squares of staged row r's chunk, in depth order.
template <int BT>
__device__ __forceinline__ float chunk_norm(const uint8_t* st, int r, float sc, float bn) {
#pragma unroll 2
  for (int p = 0; p < 8; ++p) {
    const uint4 raw = *reinterpret_cast<const uint4*>(st + piece_at(r, p));
#pragma unroll
    for (int s = 0; s < Elem<BT>::kSteps; ++s) {
      float v[4];
      widen4<BT>(raw, s, sc, v);
#pragma unroll
      for (int t = 0; t < 4; ++t) bn = fmaf(v[t], v[t], bn);
    }
  }
  return bn;
}

// Query rows q0 .. q0 + BQ, zero-padded to depth `depth`, and their sums of
// squares (in depth order), into shared memory.
template <int BQ>
__device__ __forceinline__ void load_queries(float* qs, float* qsq, const float* q, int64_t R, int W,
                                             int64_t q0, int depth) {
  if ((W & 3) == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    const int d4 = depth >> 2;  // float4s a padded row
#pragma unroll 4
    for (int e = threadIdx.x; e < BQ * d4; e += kThreads) {
      const int r = e / d4, k = 4 * (e % d4);
      const float4 v = (q0 + r < R && k < W) ? *reinterpret_cast<const float4*>(q + (q0 + r) * W + k)
                                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(qs + r * (depth + 4) + k) = v;
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < BQ * depth; e += kThreads) {
      const int r = e / depth, k = e % depth;
      qs[r * (depth + 4) + k] = (q0 + r < R && k < W) ? q[(q0 + r) * W + k] : 0.0f;
    }
  }
  __syncthreads();
  if (threadIdx.x < BQ) {
    const float* row = qs + threadIdx.x * (depth + 4);
    float a = 0.0f;
    for (int k = 0; k < depth; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + k);
      a = fmaf(x.x, x.x, a);
      a = fmaf(x.y, x.y, a);
      a = fmaf(x.z, x.z, a);
      a = fmaf(x.w, x.w, a);
    }
    qsq[threadIdx.x] = a;
  }
}

// The metric, bias, the n_rows mask and qbias of a thread's MQ x 4 outputs,
// stored (16 bytes a query row where the output row allows it); acc reset.
template <int MQ>
__device__ __forceinline__ void stream_epilogue(float (&acc)[MQ][4], const float* qsq, const float* bsq,
                                                const float* bias, const float* qbias, int64_t C, int64_t R,
                                                int64_t n_rows, int metric, int64_t q0, int64_t c0, int tq,
                                                int tc, float* out) {
  const int64_t gc = c0 + 4 * tc;
  const float4 nb = *reinterpret_cast<const float4*>(bsq + 4 * tc);
  const float bb[4] = {nb.x, nb.y, nb.z, nb.w};
  float bi[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) bi[m] = (bias != nullptr && gc + m < C) ? bias[gc + m] : 0.0f;
  const bool vec = (C & 3) == 0 && gc + 3 < C;
  const bool qvec = vec && (reinterpret_cast<uintptr_t>(qbias) & 15) == 0;
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    const int64_t gq = q0 + tq * MQ + i;
    if (gq < R) {
      const float qq = qsq[tq * MQ + i];
      float d[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float x = metric_of(metric, acc[i][m], qq, bb[m]);
        if (bias != nullptr) x = __fadd_rn(x, bi[m]);
        if (gc + m >= n_rows) x = INFINITY;
        d[m] = x;
      }
      float* o = out + gq * C + gc;
      if (qbias != nullptr) {
        const float* qb = qbias + gq * C + gc;
        if (qvec) {
          const float4 v = *reinterpret_cast<const float4*>(qb);
          d[0] = __fadd_rn(d[0], v.x);
          d[1] = __fadd_rn(d[1], v.y);
          d[2] = __fadd_rn(d[2], v.z);
          d[3] = __fadd_rn(d[3], v.w);
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (gc + m < C) d[m] = __fadd_rn(d[m], qb[m]);
        }
      }
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(d[0], d[1], d[2], d[3]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (gc + m < C) o[m] = d[m];
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[i][m] = 0.0f;
  }
}

template <int MQ, int BT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
knn_stream_kernel(const void* __restrict__ bank, const float* __restrict__ scale,
                  const float* __restrict__ bias, const float* __restrict__ qbias,
                  const float* __restrict__ q, int64_t C, int W, int64_t R, int64_t n_rows, int metric,
                  float* __restrict__ out) {
  using E = Elem<BT>;
  constexpr int BQ = 4 * MQ;
  extern __shared__ __align__(128) uint8_t smem[];
  const int nk = (W * E::kBytes + kChunk - 1) / kChunk;  // chunks a tile
  const int depth = nk * E::kPerChunk, qstride = depth + 4;
  uint8_t* stages = smem;
  float* qs = reinterpret_cast<float*>(smem + kSStages * kStageBytes);
  float* qsq = qs + BQ * qstride;
  float* bsq = qsq + BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = warp >> 1, tc = ((warp & 1) << 5) | lane;
  // the bank row whose norm this thread sums: a phase's eight lanes take
  // rows 4 apart, so their pieces sit in eight different bank groups
  const int nrow = (warp << 5) | ((lane & 7) << 2) | (lane >> 3);
  const int64_t ctiles = (C + kSRows - 1) / kSRows;
  const int64_t items = ctiles * ((R + BQ - 1) / BQ);  // (query block, bank tile), query block major
  if (static_cast<int64_t>(blockIdx.x) >= items) return;
  const int64_t total = ((items - 1 - blockIdx.x) / gridDim.x + 1) * nk;  // this block's chunks
  // the chunk being copied: its item's first bank row, its depth chunk and
  // stage, stepped without divisions
  int64_t item_n = blockIdx.x, c0_n = (item_n % ctiles) * kSRows;
  int kc_n = 0, slot_n = 0;
  auto next_chunk = [&]() {
    if (++kc_n == nk) {
      kc_n = 0;
      item_n += gridDim.x;
      c0_n += static_cast<int64_t>(gridDim.x) * kSRows;
      while (c0_n >= ctiles * kSRows) c0_n -= ctiles * kSRows;
    }
    if (++slot_n == kSStages) slot_n = 0;
  };
#pragma unroll
  for (int s = 0; s < kSStages - 1; ++s) {
    if (s < total) {
      stage_chunk<BT, VEC>(stages + slot_n * kStageBytes, bank, C, W, c0_n, kc_n);
      next_chunk();
    }
    cp_async_commit();
  }
  float acc[MQ][4], sc[4] = {1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[i][m] = 0.0f;
  float nsc = 1.0f, bn = 0.0f;
  int64_t loaded = -1, item = blockIdx.x, q0 = 0, c0 = 0;
  int kc = 0, slot = 0;
  for (int64_t j = 0; j < total; ++j) {
    if (kc == 0) {
      const int64_t qb = item / ctiles;
      c0 = (item - qb * ctiles) * kSRows;
      if (qb != loaded) {
        __syncthreads();  // the previous query block's last reads are done
        q0 = qb * BQ;
        load_queries<BQ>(qs, qsq, q, R, W, q0, depth);
        loaded = qb;
      }
      if (BT == kI8 && scale != nullptr) {
#pragma unroll
        for (int m = 0; m < 4; ++m) sc[m] = c0 + 4 * tc + m < C ? scale[c0 + 4 * tc + m] : 1.0f;
        nsc = c0 + nrow < C ? scale[c0 + nrow] : 1.0f;
      }
    }
    cp_async_wait<kSStages - 2>();  // chunk j has landed (this thread's copies)
    __syncthreads();                // everyone's copies, and the stage chunk j - 1 used is free
    if (j + kSStages - 1 < total) {
      stage_chunk<BT, VEC>(stages + slot_n * kStageBytes, bank, C, W, c0_n, kc_n);
      next_chunk();
    }
    cp_async_commit();
    const uint8_t* st = stages + slot * kStageBytes;
    chunk_dots<MQ, BT>(st, qs, qstride, kc, tq, tc, sc, acc);
    bn = chunk_norm<BT>(st, nrow, nsc, bn);
    if (++slot == kSStages) slot = 0;
    if (++kc == nk) {
      bsq[nrow] = bn;
      bn = 0.0f;
      __syncthreads();
      stream_epilogue<MQ>(acc, qsq, bsq, bias, qbias, C, R, n_rows, metric, q0, c0, tq, tc, out);
      kc = 0;
      item += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

// Blocks the card keeps resident for an instantiation at each staged depth
// (32 floats a step), asked once per device (after raising its shared-memory
// limit to what the deepest query block needs); 0 until asked.
template <int MQ, int BT, bool VEC>
cudaError_t stream_resident(int depth, int64_t& blocks) {
  constexpr int kMaxDevices = 64, kDepths = kMaxDepth / 32;
  static std::atomic<int64_t> known[kMaxDevices][kDepths];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int at = depth / 32 - 1;
  if (dev < kMaxDevices && (blocks = known[dev][at].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  const auto kernel = knn_stream_kernel<MQ, BT, VEC>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(stream_smem(4 * MQ, kMaxDepth)));
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, stream_smem(4 * MQ, depth));
  if (err != cudaSuccess) return err;
  blocks = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) known[dev][at].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int MQ, int BT, bool VEC>
cudaError_t stream_launch(const void* bank, const float* scale, const float* bias, const float* qbias,
                          const float* q, int64_t C, int W, int64_t R, int64_t n_rows, int metric, float* out,
                          cudaStream_t s) {
  const int depth = (W * Elem<BT>::kBytes + kChunk - 1) / kChunk * Elem<BT>::kPerChunk;
  int64_t resident = 0;
  const cudaError_t err = stream_resident<MQ, BT, VEC>(depth, resident);
  if (err != cudaSuccess) return err;
  const int64_t items = (C + kSRows - 1) / kSRows * ((R + 4 * MQ - 1) / (4 * MQ));
  const auto grid = static_cast<unsigned>(items < resident ? items : resident);
  knn_stream_kernel<MQ, BT, VEC><<<grid, kThreads, stream_smem(4 * MQ, depth), s>>>(
      bank, scale, bias, qbias, q, C, W, R, n_rows, metric, out);
  return cudaGetLastError();
}

template <int MQ>
cudaError_t stream_dispatch(int bt, bool vec, const void* bank, const float* scale, const float* bias,
                            const float* qbias, const float* q, int64_t C, int W, int64_t R, int64_t n_rows,
                            int metric, float* out, cudaStream_t s) {
#define RTPU_STREAM(BT, VEC) \
  return stream_launch<MQ, BT, VEC>(bank, scale, bias, qbias, q, C, W, R, n_rows, metric, out, s)
  if (bt == kF32) {
    if (vec) RTPU_STREAM(kF32, true);
    RTPU_STREAM(kF32, false);
  }
  if (bt == kF16) {
    if (vec) RTPU_STREAM(kF16, true);
    RTPU_STREAM(kF16, false);
  }
  if (vec) RTPU_STREAM(kI8, true);
  RTPU_STREAM(kI8, false);
#undef RTPU_STREAM
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
// route 0: the tile route (tile_dots); 1: the streamed route with element
// loads; 2: the streamed route with 16-byte copies (rows of a multiple of 16
// bytes, a 16-byte aligned bank).  The streamed route takes W <= 256.
extern "C" int rtpu_knn_score(const void* bank, int bank_type, const void* scale, const void* bias,
                              const void* qbias, const void* q, int64_t C, int W, int64_t R,
                              int64_t n_rows, int metric, int route, void* out, void* stream) {
  if (bank_type < kF32 || bank_type > kI8 || metric < 0 || metric > 2 || W < 1 || C < 1 || R < 1 ||
      route < 0 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const float*>(scale);
  const auto b = static_cast<const float*>(bias);
  const auto qb = static_cast<const float*>(qbias);
  const auto qq = static_cast<const float*>(q);
  const auto o = static_cast<float*>(out);
  if (route == 0) {
    if (R <= 8)
      return static_cast<int>(score_launch<1, 8, 1>(bank_type, bank, sc, b, qb, qq, C, W, R, n_rows, metric, o, s));
    // a narrow bank (the IVF route's centroids) in tiles of 32 rows, so its
    // few tiles still spread over the SMs
    if (C <= kNarrowRows)
      return static_cast<int>(score_launch<16, 4, 2>(bank_type, bank, sc, b, qb, qq, C, W, R, n_rows, metric, o, s));
    return static_cast<int>(score_launch<16, 4, 8>(bank_type, bank, sc, b, qb, qq, C, W, R, n_rows, metric, o, s));
  }
  const int es = bank_type == kF32 ? 4 : (bank_type == kF16 ? 2 : 1);
  const bool vec = route == 2;
  if (W > kMaxDepth ||
      (vec && ((static_cast<int64_t>(W) * es) % 16 != 0 || reinterpret_cast<uintptr_t>(bank) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 8) return static_cast<int>(stream_dispatch<2>(bank_type, vec, bank, sc, b, qb, qq, C, W, R, n_rows, metric, o, s));
  return static_cast<int>(stream_dispatch<16>(bank_type, vec, bank, sc, b, qb, qq, C, W, R, n_rows, metric, o, s));
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
