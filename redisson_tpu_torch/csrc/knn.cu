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
// Bound on an H100: the bytes of the matrix, read once.  One launch a round
// of up to kRound = 256 keys (a larger k takes a round per 256, each
// skipping the keys the rounds before it took).  Each warp keeps a sorted
// list of its best keys across its lanes (WarpSel) and reads its columns
// with 16-byte loads, 4 a lane a step and the next step's in flight; a key is
// kept only at or below a bound that the warp's list, its block (shared
// memory) and its row (a 64-bit atomicMin in global memory) share, so after
// the first step most keys cost one 32-bit compare of their order bits (a
// float compare was slower on the H100).  Kept keys wait in a
// buffer and join the list a whole list at a time through one bitonic
// network.  Rows of at most kernels.SELECT_SMALL columns (the IVF route and
// candidates) take one warp a row; longer rows split into a few segments
// (about kernels.SELECT_BLOCKS_PER_SM blocks a call on each SM, each of at
// least SELECT_SEG_MIN columns: more, shorter segments were slower), one
// block each, whose lists the row's last block (an atomic ticket) merges by
// rank in the same launch.
//
// ivf_score replaces the candidate scoring of _knn_ivf_body (:782,
// _ivf_candidate_dists :739): for query r and probe p (cell probe[r][p]),
// slot j of the cell's row list cells[cell][j] scores against q_r with the
// same metrics and widening, plus bias and the optional (C,) mask qmask; a
// slot whose row id is negative or >= n_rows (the sentinel 0x3FFFFFFF pads
// ragged cells) scores +inf.  out (R, nprobe * cap) float32 and ids (R,
// nprobe * cap) int32 (the slot's row id), in probe order, then cell order,
// which is the reference's candidate order.  Bound on an H100: the gathered
// rows' bytes.  One block a (query, probe) pair compacts the cell's valid
// slots by ballot and gathers only those, 16 bytes a load where the rows
// allow, 32 or 64 rows a block in flight (ivf_score_kernel below).
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "cp_async.cuh"
#include "knn_tile.cuh"

namespace {

using namespace rtpu_cp;
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

using u64 = unsigned long long;

constexpr int kWarps = kThreads / 32;
constexpr int kRound = 256;        // keys a round selects at most
constexpr int kPool = 4096;        // keys a block merges at most: max(kWarps, segs) x kr
constexpr int kSmallCols = 2048;   // the longest row one warp takes (kernels.SELECT_SMALL)
constexpr u64 kNone = ~0ull;       // above every real key (a column < 2**31)

// What the calls share of a row: its bound (kNone between calls) and the
// ticket its blocks take when done (0 between calls).
struct RowState {
  u64 bound;
  unsigned ticket, pad;
};

// The float's bits mapped to an unsigned order: negative floats flipped,
// the others with the top bit set.
__device__ __forceinline__ uint32_t order_of(float d) {
  const uint32_t b = __float_as_uint(d);
  return b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) | 0x80000000u);
}

__device__ __forceinline__ u64 key_of(float d, int64_t col) {
  return (static_cast<u64>(order_of(d)) << 32) | static_cast<uint32_t>(col);
}

__device__ __forceinline__ float dist_of(u64 key) {
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a < b ? b : a; }

__host__ __device__ constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x / 2); }

// One compare-exchange step of a bitonic network over the 32 KPL keys of a
// warp held lane-major (place p = lane * KPL + j): places p and p ^ stride
// meet, the smaller to the lower place where bit `size` of p is 0 (an
// ascending run), to the higher where it is 1.
template <int KPL>
__device__ __forceinline__ void bitonic_step(u64 (&v)[KPL], int lane, int size, int stride) {
  if (stride >= KPL) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int p = lane * KPL + j;
      const u64 o = __shfl_xor_sync(kFull, v[j], stride / KPL);
      v[j] = (((p & stride) == 0) == ((p & size) == 0)) ? umin(v[j], o) : umax(v[j], o);
    }
  } else {
    u64 w[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int p = lane * KPL + j;
      u64 o = v[0];
#pragma unroll
      for (int i = 1; i < KPL; ++i)
        if (i == (j ^ stride)) o = v[i];  // folds to one register once the network is unrolled
      w[j] = (((p & stride) == 0) == ((p & size) == 0)) ? umin(v[j], o) : umax(v[j], o);
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j) v[j] = w[j];
  }
}

template <int KPL>
__device__ __forceinline__ void bitonic_sort(u64 (&v)[KPL], int lane) {
  constexpr int kLog = log2_of(32 * KPL);
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls)
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) bitonic_step<KPL>(v, lane, 1 << ls, 1 << lt);
}

// A warp's selection: its k smallest keys so far in a sorted list of 32 KPL
// places (lane l holds places l KPL .. l KPL + KPL - 1; only the first k
// count), and a buffer of keys waiting to be merged in.  A key is buffered
// only if it is at or below the warp's bound: the least of the list's k-th
// key, its block's and its row's bound.  Any k keys of a row bound its k-th
// key from above, so a key above a bound is not among the row's k smallest,
// and the bound only decides what is read past, never which k are returned.
// A full buffer is sorted across the lanes and merged into the list by one
// bitonic network (reverse, min, clean) instead of a key at a time.
template <int KPL>
struct WarpSel {
  static constexpr int N = 32 * KPL;     // places of the list
  static constexpr int kBuf = N + 128;   // a list's worth, and one push of 4 keys a lane
  u64 v[KPL];
  u64 kth;            // place k - 1 (kNone while the list holds fewer keys)
  int k_lane, k_slot;
  u64* buf;           // the warp's kBuf keys of shared memory
  int cnt;            // keys in buf (the same in every lane)
  int lane;
  bool has_lo;        // a round after the first: only keys above lo count
  u64 lo;
  u64 ext;            // the block's and the row's bound, as last read (kNone without)
  u64* sbound;        // where the k-th key is published (null: nowhere)
  u64* gbound;
  u64 pub;            // the last key published

  __device__ __forceinline__ void init(int kr, int lane_, u64* buf_, const u64* lower, int64_t row, u64* sb,
                                       u64* gb) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) v[j] = kNone;
    kth = kNone;
    k_lane = (kr - 1) / KPL;
    k_slot = (kr - 1) % KPL;
    buf = buf_;
    cnt = 0;
    lane = lane_;
    has_lo = lower != nullptr;
    lo = has_lo ? lower[row] : 0;
    ext = kNone;
    sbound = sb;
    gbound = gb;
    pub = kNone;
  }

  __device__ __forceinline__ u64 thr() const { return umin(kth, ext); }
  __device__ __forceinline__ bool above_lo(u64 x) const { return !has_lo || x > lo; }

  // b (any order, kNone where empty; only its first `filled` places hold
  // keys) into the list: the list becomes the N smallest of both, ascending.
  // A short batch sorts only the first power of two of places it fills: the
  // places after them hold kNone, in order already.
  __device__ __forceinline__ void merge(u64 (&b)[KPL], int filled = N) {
    if (filled >= N) {
      bitonic_sort<KPL>(b, lane);
    } else {
      const int top = filled > 1 ? 32 - __clz(filled - 1) : 1;  // 2**top >= filled
      for (int ls = 1; ls <= top; ++ls)
        for (int lt = ls - 1; lt >= 0; --lt) bitonic_step<KPL>(b, lane, 1 << ls, 1 << lt);
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j) v[j] = umin(v[j], __shfl_xor_sync(kFull, b[KPL - 1 - j], 31));
    constexpr int kLog = log2_of(N);
#pragma unroll
    for (int lt = kLog - 1; lt >= 0; --lt) bitonic_step<KPL>(v, lane, N, 1 << lt);
    set_kth();
  }

  // kth from place k - 1, published to the block and the row when it fell
  __device__ __forceinline__ void set_kth() {
    u64 mine = v[0];
#pragma unroll
    for (int j = 1; j < KPL; ++j)
      if (j == k_slot) mine = v[j];
    kth = __shfl_sync(kFull, mine, k_lane);
    if (kth < pub) {
      pub = kth;
      if (lane == 0 && sbound != nullptr) {
        atomicMin(sbound, kth);
        atomicMin(gbound, kth);
      }
    }
  }

  // each lane's key x (when ok) appended to the buffer
  __device__ __forceinline__ void push(u64 x, bool ok) {
    const unsigned m = __ballot_sync(kFull, ok);
    if (ok) buf[cnt + __popc(m & ((1u << lane) - 1))] = x;
    cnt += __popc(m);
  }

  // Merge the buffer a list's worth at a time while it holds one (with all,
  // to the last key); after each merge the keys left that are still at or
  // below the bound move to the front.
  __device__ __forceinline__ void drain(bool all) {
    while (cnt >= N || (all && cnt > 0)) {
      const int take = cnt < N ? cnt : N;
      u64 b[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int p = lane * KPL + j;
        b[j] = p < take ? buf[p] : kNone;
      }
      merge(b, take);
      const u64 t = thr();
      const int rest = cnt - take;
      cnt = 0;
      for (int i0 = 0; i0 < rest; i0 += 32) {
        const bool in = i0 + lane < rest;
        const u64 x = in ? buf[take + i0 + lane] : kNone;
        push(x, in && x <= t);  // below take + i0 (take = N when rest > 0): nothing unread is overwritten
      }
      __syncwarp();
    }
  }

  // One step's keys: the first nv of NG groups hold values (4 each, the last
  // last_m), group u at columns col + u * stride ..  The order bits alone
  // reject most keys; a group no lane keeps a key of costs one vote.
  template <int NG>
  __device__ __forceinline__ void step(const float4 (&v4)[NG], int64_t col, int64_t stride, int nv, int last_m) {
    const uint32_t thi = static_cast<uint32_t>(thr() >> 32);
    const uint32_t lhi = has_lo ? static_cast<uint32_t>(lo >> 32) : 0u;
    bool any = false;
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const float e4[4] = {v4[u].x, v4[u].y, v4[u].z, v4[u].w};
      const int m = u < nv ? (u == nv - 1 ? last_m : 4) : 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t o = order_of(e4[e]);
        any |= e < m && o <= thi && o >= lhi;
      }
    }
    if (!__any_sync(kFull, any)) return;
    int seeded = -1;  // the key of this step the seed took
    if (kth == kNone) {
      // seed: each lane's smallest key joins the list at once, so one merge
      // gives a bound from 32 keys spread over the warp
      u64 mn = kNone;
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const float e4[4] = {v4[u].x, v4[u].y, v4[u].z, v4[u].w};
        const int m = u < nv ? (u == nv - 1 ? last_m : 4) : 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const u64 x = key_of(e4[e], col + u * stride + e);
          if (e < m && above_lo(x) && x < mn) {
            mn = x;
            seeded = 4 * u + e;
          }
        }
      }
      u64 b[KPL];
      b[0] = mn;
#pragma unroll
      for (int j = 1; j < KPL; ++j) b[j] = kNone;
      if (__shfl_sync(kFull, v[0], 0) == kNone) {
        // an empty list: the sorted batch is the list
        bitonic_sort<KPL>(b, lane);
#pragma unroll
        for (int j = 0; j < KPL; ++j) v[j] = b[j];
        set_kth();
      } else {
        merge(b);
      }
    }
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const u64 t = thr();
      const float e4[4] = {v4[u].x, v4[u].y, v4[u].z, v4[u].w};
      const int m = u < nv ? (u == nv - 1 ? last_m : 4) : 0;
      u64 x[4];
      bool ok[4], some = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = key_of(e4[e], col + u * stride + e);
        ok[e] = e < m && 4 * u + e != seeded && above_lo(x[e]) && x[e] <= t;
        some |= ok[e];
      }
      if (!__any_sync(kFull, some)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) push(x[e], ok[e]);
      __syncwarp();
      if (cnt >= N) drain(false);
    }
  }
};

// Columns [a, b) of the row at rp through s: the 16-byte aligned interior
// in steps of 4 float4s a thread (thread t of NT takes float4 t + NT u of
// each step's 4 NT), the next step's loads issued before this step's keys
// are filtered; then the unaligned ends (at most 3 + 3 columns), by one warp
// (`ends`).  With gb, the row's bound is read each step (from L2).
template <int KPL, int NT>
__device__ __forceinline__ void scan_columns(WarpSel<KPL>& s, const float* rp, int64_t a, int64_t b, int t,
                                             bool ends, const u64* gb) {
  constexpr int kPer = 4 * NT;  // float4s a step
  const uintptr_t addr = reinterpret_cast<uintptr_t>(rp + a);
  int64_t a4 = a + static_cast<int64_t>(((16 - (addr & 15)) & 15) >> 2);
  if (a4 > b) a4 = b;
  const int nf = static_cast<int>((b - a4) >> 2);  // n < 2**31: a row holds fewer than 2**29 float4s
  const int64_t b4 = a4 + 4 * static_cast<int64_t>(nf);
  const float4* p4 = reinterpret_cast<const float4*>(rp + a4);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 cur[4], nxt[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int f = u * NT + t;
    cur[u] = f < nf ? __ldg(p4 + f) : zero;
    nxt[u] = zero;
  }
  u64 g = gb != nullptr ? __ldcg(gb) : kNone;
  for (int f0 = t; f0 - t < nf; f0 += kPer) {
    if (f0 - t + kPer < nf) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = f0 + kPer + u * NT;
        nxt[u] = f < nf ? __ldg(p4 + f) : zero;
      }
    }
    const u64 gn = gb != nullptr ? __ldcg(gb) : kNone;
    if (s.sbound != nullptr) s.ext = umin(s.ext, umin(*reinterpret_cast<volatile u64*>(s.sbound), g));
    const int left = nf > f0 ? (nf - f0 + NT - 1) / NT : 0;  // groups holding values
    s.template step<4>(cur, a4 + 4 * static_cast<int64_t>(f0), 4 * NT, left < 4 ? left : 4, 4);
    g = gn;
#pragma unroll
    for (int u = 0; u < 4; ++u) cur[u] = nxt[u];
  }
  if (ends) {
    // the head a .. a4 on lanes 0-2, the tail b4 .. b on lanes 3-5
    int64_t col = -1;
    if (s.lane < 3 && a + s.lane < a4) col = a + s.lane;
    if (s.lane >= 3 && s.lane < 6 && b4 + s.lane - 3 < b) col = b4 + s.lane - 3;
    float4 v4[1] = {zero};
    if (col >= 0) v4[0].x = rp[col];
    s.template step<1>(v4, col, 0, col >= 0 ? 1 : 0, 1);
  }
}

// The kr smallest keys of `runs` sorted runs of kr keys each (pool, kNone
// where a run is short), ascending, into out (kNone beforehand), skipping
// keys above `bound`.  Keys are unique, so a key's rank is its place in its
// own run plus the keys below it in the others (a binary search each).
__device__ __forceinline__ void rank_merge(const u64* pool, int runs, int kr, u64 bound, u64* out) {
  for (int i = threadIdx.x; i < runs * kr; i += kThreads) {
    const u64 x = pool[i];
    if (x == kNone || x > bound) continue;
    const int own = i / kr;
    int rank = i - own * kr;
    for (int r = 0; r < runs && rank < kr; ++r) {
      if (r == own) continue;
      const u64* run = pool + r * kr;
      int lo = 0, len = kr;
      while (len > 0) {
        const int half = len >> 1;
        if (run[lo + half] < x) {
          lo += half + 1;
          len -= half + 1;
        } else {
          len = half;
        }
      }
      rank += lo;
    }
    if (rank < kr) out[rank] = x;
  }
}

// Place g of the round (places base .. base + kr of the row's k outputs).
__device__ __forceinline__ void put_key(u64 key, int64_t row, int g, int kr, int k, int base,
                                        const int32_t* ids, int64_t n, float* vals, int32_t* idx, u64* last) {
  const uint32_t col = static_cast<uint32_t>(key);
  vals[row * k + base + g] = dist_of(key);
  idx[row * k + base + g] = ids != nullptr ? ids[row * n + col] : static_cast<int32_t>(col);
  if (g == kr - 1) last[row] = key;
}

// Rows of at most kSmallCols columns: one warp a row, alone in its block
// (each row's work is a chain of latencies: a warp of its own keeps an SM
// scheduler to itself).
template <int KPL>
__global__ void __launch_bounds__(32)
select_rows_kernel(const float* __restrict__ dist, int64_t n, int kr, int k, int base,
                   const u64* __restrict__ lower, const int32_t* __restrict__ ids, float* __restrict__ vals,
                   int32_t* __restrict__ idx, u64* __restrict__ last) {
  extern __shared__ __align__(16) u64 bufs[];
  const int lane = threadIdx.x;
  const int64_t row = blockIdx.x;
  WarpSel<KPL> s;
  s.init(kr, lane, bufs, lower, row, nullptr, nullptr);
  scan_columns<KPL, 32>(s, dist + row * n, 0, n, lane, true, nullptr);
  s.drain(true);
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int g = lane * KPL + j;
    if (g < kr) put_key(s.v[j], row, g, kr, k, base, ids, n, vals, idx, last);
  }
}

// Longer rows: segs blocks a row (blockIdx.x = row * segs + segment), each
// taking seg_len columns with 8 warps.  The warps share a bound in shared
// memory and the row's blocks one in its RowState (64-bit atomicMin); a block
// merges its warps' lists by rank, writes its list to runs, and the last
// block of the row to finish (a ticket: __threadfence, then atomicAdd) merges
// the row's lists, writes the answer and resets the row's ticket and bound
// for the next call.
template <int KPL>
__global__ void __launch_bounds__(kThreads)
select_segs_kernel(const float* __restrict__ dist, int64_t n, int segs, int64_t seg_len, int kr, int k, int base,
                   const u64* __restrict__ lower, const int32_t* __restrict__ ids, u64* __restrict__ runs,
                   RowState* __restrict__ state, float* __restrict__ vals, int32_t* __restrict__ idx,
                   u64* __restrict__ last) {
  extern __shared__ __align__(16) u64 pool[];  // the warps' buffers, then the lists merged
  __shared__ u64 best[kRound];
  __shared__ u64 sbound;
  __shared__ int last_block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x / segs;
  const int seg = static_cast<int>(blockIdx.x - row * segs);
  const int64_t a = seg * seg_len, b = a + seg_len < n ? a + seg_len : n;
  u64* gbound = &state[row].bound;
  if (threadIdx.x == 0) sbound = kNone;
  for (int i = threadIdx.x; i < kr; i += kThreads) best[i] = kNone;
  __syncthreads();
  WarpSel<KPL> s;
  s.init(kr, lane, pool + warp * WarpSel<KPL>::kBuf, lower, row, &sbound, gbound);
  scan_columns<KPL, kThreads>(s, dist + row * n, a, b, threadIdx.x, warp == 0, gbound);
  s.drain(true);
  __syncthreads();  // every buffer is read: the pool takes the lists
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int g = lane * KPL + j;
    if (g < kr) pool[warp * kr + g] = s.v[j];
  }
  __syncthreads();
  rank_merge(pool, kWarps, kr, umin(sbound, __ldcg(gbound)), best);
  __syncthreads();
  if (segs > 1) {
    u64* run = runs + (row * segs + seg) * kr;
    for (int i = threadIdx.x; i < kr; i += kThreads) run[i] = best[i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last_block = atomicAdd(&state[row].ticket, 1u) == static_cast<unsigned>(segs - 1);
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    const u64* rr = runs + row * segs * kr;
    for (int i = threadIdx.x; i < segs * kr; i += kThreads) pool[i] = __ldcg(rr + i);
    for (int i = threadIdx.x; i < kr; i += kThreads) best[i] = kNone;
    __syncthreads();
    rank_merge(pool, segs, kr, __ldcg(gbound), best);
    __syncthreads();
  }
  for (int g = threadIdx.x; g < kr; g += kThreads) put_key(best[g], row, g, kr, k, base, ids, n, vals, idx, last);
  if (threadIdx.x == 0) {
    if (segs > 1) state[row].ticket = 0;
    *gbound = kNone;
  }
}

template <int KPL>
cudaError_t select_round(cudaStream_t s, const float* dist, int64_t n, int64_t R, int segs, int64_t seg_len, int kr,
                         int k, int base, const u64* lower, const int32_t* ids, u64* runs, RowState* state,
                         float* vals, int32_t* idx, u64* last) {
  if (segs == 0) {
    select_rows_kernel<KPL><<<static_cast<unsigned>(R), 32, sizeof(u64) * WarpSel<KPL>::kBuf, s>>>(
        dist, n, kr, k, base, lower, ids, vals, idx, last);
  } else {
    const auto grid = static_cast<unsigned>(R * segs);
    const int keys = kWarps * WarpSel<KPL>::kBuf > kPool ? kWarps * WarpSel<KPL>::kBuf : kPool;
    select_segs_kernel<KPL><<<grid, kThreads, sizeof(u64) * keys, s>>>(dist, n, segs, seg_len, kr, k, base, lower,
                                                                       ids, runs, state, vals, idx, last);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- ivf_score

// One block a (query, probe) pair.  Its threads load the probe's cell id,
// then one slot id each (coalesced; cells of more than TH slots in
// batches), write every slot's id and the +inf of the invalid ones, and
// compact the valid slots into shared memory (a ballot a warp, the warps'
// counts summed by every thread), so sentinels cost nothing wherever they
// stand.  The 32 groups of kGroup lanes then score the valid rows densely,
// kIvfRows rows a group at a time: a lane issues every load of its rows
// (16-byte pieces where the rows and the bank allow, else element loads)
// before the FMAs, so a block of TH threads has TH / 4 rows in flight (32 KB
// at W 128 float32 with 256 threads) and a full cell of config 7 (112
// slots) takes two rounds.  Blocks of 128 threads when the pairs outnumber
// two blocks of 256 a SM, so that every pair's block is resident at once.  A lane
// keeps its 16 query elements of a 128-element chunk in registers (the
// later chunks of a wider row are read again, from L1) and its group sums
// the query's norm by shuffles: no shared query, no barrier around it.
constexpr int kIvfRows = 2;     // rows a group gathers at once
constexpr int kGroup = 8;       // lanes a row

// The element at place s (< 16) of the share of lane `sub` of its group in
// 128-element chunk c: with 16-byte pieces, of piece sub + 8 (s / per) of the
// chunk (per elements a piece), else every 8th element.
template <int BT, bool VEC>
__device__ __forceinline__ int ivf_elem(int c, int sub, int s) {
  constexpr int per = 16 / Elem<BT>::kBytes;
  if (!VEC) return 128 * c + sub + 8 * s;
  return 128 * c + per * (sub + 8 * (s / per)) + s % per;
}

// The places of chunk c of rows row[t] (-1: none) widened to float32 (INT8
// times sc[t]); every load of every row is issued before any widening.
template <int BT, bool VEC>
__device__ __forceinline__ void ivf_rows(const void* bank, const int64_t (&row)[kIvfRows], int W, int c, int sub,
                                         const float (&sc)[kIvfRows], float (&x)[kIvfRows][16]) {
  constexpr int es = Elem<BT>::kBytes, per = 16 / es;
  if (VEC) {
    const int64_t pieces = static_cast<int64_t>(W) * es / 16;  // a row's 16-byte pieces
    uint4 raw[kIvfRows][es];
    bool in[kIvfRows][es];
#pragma unroll
    for (int t = 0; t < kIvfRows; ++t)
#pragma unroll
      for (int u = 0; u < es; ++u) {
        const int64_t pi = static_cast<int64_t>(8 * es) * c + sub + 8 * u;
        in[t][u] = row[t] >= 0 && pi < pieces;
        raw[t][u] = in[t][u] ? __ldg(reinterpret_cast<const uint4*>(bank) + row[t] * pieces + pi)
                             : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
    for (int t = 0; t < kIvfRows; ++t)
#pragma unroll
      for (int u = 0; u < es; ++u) {
        const uint32_t w4[4] = {raw[t][u].x, raw[t][u].y, raw[t][u].z, raw[t][u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (BT == kF32) {
            x[t][4 * u + i] = in[t][u] ? __uint_as_float(w4[i]) : 0.0f;
          } else if (BT == kF16) {
            const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w4[i]));
            x[t][per * u + 2 * i] = in[t][u] ? f.x : 0.0f;
            x[t][per * u + 2 * i + 1] = in[t][u] ? f.y : 0.0f;
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const float v = static_cast<float>(static_cast<int8_t>(w4[i] >> (8 * b)));
              x[t][4 * i + b] = in[t][u] ? __fmul_rn(v, sc[t]) : 0.0f;
            }
          }
        }
      }
  } else {
    float raw[kIvfRows][16];
#pragma unroll
    for (int t = 0; t < kIvfRows; ++t)
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        const int d = ivf_elem<BT, VEC>(c, sub, s);
        const int64_t at = row[t] * W + d;
        float v = 0.0f;
        if (row[t] >= 0 && d < W) {
          if (BT == kF32) v = __ldg(static_cast<const float*>(bank) + at);
          else if (BT == kF16) v = __half2float(static_cast<const __half*>(bank)[at]);
          else v = static_cast<float>(static_cast<const int8_t*>(bank)[at]);
        }
        raw[t][s] = v;
      }
#pragma unroll
    for (int t = 0; t < kIvfRows; ++t)
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        const bool in = row[t] >= 0 && ivf_elem<BT, VEC>(c, sub, s) < W;
        x[t][s] = BT == kI8 ? (in ? __fmul_rn(raw[t][s], sc[t]) : 0.0f) : raw[t][s];
      }
  }
}

template <int BT, bool VEC, int TH>
__global__ void __launch_bounds__(TH)
ivf_score_kernel(const void* __restrict__ bank, const float* __restrict__ scale, const float* __restrict__ bias,
                 const float* __restrict__ qmask, const float* __restrict__ q, const int32_t* __restrict__ cells,
                 const int32_t* __restrict__ probe, int W, int nlist, int nprobe, int cap, int64_t n_rows,
                 int metric, float* __restrict__ out, int32_t* __restrict__ ids) {
  constexpr int kIvfWarps = TH / 32, kIvfGroups = TH / kGroup;
  __shared__ int2 valid_slots[TH];
  __shared__ int warp_valid[kIvfWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % kGroup, grp = threadIdx.x / kGroup;
  const int64_t pair = blockIdx.x;
  // the index loads first: the cell, then the first batch of its slot ids
  const int cell = __ldg(probe + pair);
  const bool cell_ok = cell >= 0 && cell < nlist;
  const int32_t* crow = cells + static_cast<int64_t>(cell_ok ? cell : 0) * cap;
  int32_t cand = (cell_ok && static_cast<int>(threadIdx.x) < cap) ? __ldg(crow + threadIdx.x) : -1;
  // this lane's query elements of chunk 0, and the query's norm
  const float* qr = q + (pair / nprobe) * W;
  const int chunks = (W + 127) / 128;
  float qv[16], qsq = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const int d = ivf_elem<BT, VEC>(0, sub, s);
    qv[s] = d < W ? __ldg(qr + d) : 0.0f;
    qsq = fmaf(qv[s], qv[s], qsq);
  }
  for (int c = 1; c < chunks; ++c)
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int d = ivf_elem<BT, VEC>(c, sub, s);
      const float v = d < W ? __ldg(qr + d) : 0.0f;
      qsq = fmaf(v, v, qsq);
    }
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) qsq += __shfl_xor_sync(kFull, qsq, off);
  float* orow = out + pair * cap;
  int32_t* irow = ids + pair * cap;
  for (int b0 = 0; b0 < cap; b0 += TH) {
    const int j = b0 + static_cast<int>(threadIdx.x);
    if (b0 > 0) cand = (cell_ok && j < cap) ? __ldg(crow + j) : -1;
    const bool in = j < cap;
    const bool ok = in && cand >= 0 && cand < n_rows;
    if (in) {
      irow[j] = cand;
      if (!ok) orow[j] = INFINITY;
    }
    const unsigned m = __ballot_sync(kFull, ok);
    if (lane == 0) warp_valid[warp] = __popc(m);
    __syncthreads();
    int at = 0, nv = 0;
#pragma unroll
    for (int w = 0; w < kIvfWarps; ++w) {
      at += w < warp ? warp_valid[w] : 0;
      nv += warp_valid[w];
    }
    if (ok) valid_slots[at + __popc(m & ((1u << lane) - 1))] = make_int2(j, cand);
    __syncthreads();
    for (int i0 = 0; i0 < nv; i0 += kIvfRows * kIvfGroups) {
      int slot[kIvfRows];
      int64_t row[kIvfRows];
      float sc[kIvfRows], bv[kIvfRows], mv[kIvfRows], dot[kIvfRows], rsq[kIvfRows];
#pragma unroll
      for (int t = 0; t < kIvfRows; ++t) {
        const int i = i0 + t * kIvfGroups + grp;
        const int2 e = i < nv ? valid_slots[i] : make_int2(-1, -1);
        slot[t] = e.x;
        row[t] = e.y;
        const bool mine = row[t] >= 0 && sub == t;  // the lane that writes row t's distance
        sc[t] = (BT == kI8 && scale != nullptr && row[t] >= 0) ? __ldg(scale + row[t]) : 1.0f;
        bv[t] = (mine && bias != nullptr) ? __ldg(bias + row[t]) : 0.0f;
        mv[t] = (mine && qmask != nullptr) ? __ldg(qmask + row[t]) : 0.0f;
        dot[t] = 0.0f;
        rsq[t] = 0.0f;
      }
      for (int c = 0; c < chunks; ++c) {
        float x[kIvfRows][16];
        ivf_rows<BT, VEC>(bank, row, W, c, sub, sc, x);
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          float qs = qv[s];
          if (c > 0) {
            const int d = ivf_elem<BT, VEC>(c, sub, s);
            qs = d < W ? __ldg(qr + d) : 0.0f;
          }
#pragma unroll
          for (int t = 0; t < kIvfRows; ++t) {
            dot[t] = fmaf(x[t][s], qs, dot[t]);
            rsq[t] = fmaf(x[t][s], x[t][s], rsq[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kIvfRows; ++t)
#pragma unroll
        for (int off = kGroup / 2; off > 0; off >>= 1) {
          dot[t] += __shfl_xor_sync(kFull, dot[t], off);
          rsq[t] += __shfl_xor_sync(kFull, rsq[t], off);
        }
#pragma unroll
      for (int t = 0; t < kIvfRows; ++t) {
        if (row[t] < 0 || sub != t) continue;
        float dd = metric_of(metric, dot[t], qsq, rsq[t]);
        if (bias != nullptr) dd = __fadd_rn(dd, bv[t]);
        if (qmask != nullptr) dd = __fadd_rn(dd, mv[t]);
        orow[slot[t]] = dd;
      }
    }
    __syncthreads();  // the list and the counts are read before the next batch
  }
}

template <int BT, bool VEC>
cudaError_t ivf_launch(const void* bank, const float* scale, const float* bias, const float* qmask, const float* q,
                       const int32_t* cells, const int32_t* probe, int W, int nlist, int nprobe, int cap,
                       int64_t pairs, int64_t n_rows, int metric, float* out, int32_t* ids, cudaStream_t s) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sm_counts[kMaxDevices];
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || (sms = sm_counts[dev].load(std::memory_order_relaxed)) == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) sm_counts[dev].store(sms, std::memory_order_relaxed);
  }
  const auto grid = static_cast<unsigned>(pairs);
  if (pairs > 2 * static_cast<int64_t>(sms)) {
    ivf_score_kernel<BT, VEC, 128><<<grid, 128, 0, s>>>(bank, scale, bias, qmask, q, cells, probe, W, nlist, nprobe,
                                                        cap, n_rows, metric, out, ids);
  } else {
    ivf_score_kernel<BT, VEC, 256><<<grid, 256, 0, s>>>(bank, scale, bias, qmask, q, cells, probe, W, nlist, nprobe,
                                                        cap, n_rows, metric, out, ids);
  }
  return cudaGetLastError();
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
// ids[row][column] when ids (R, n) is not null).  1 <= k <= n < 2**31.  The
// plan (kernels.knn_select_plan): segs 0 takes one warp a row (n <= 2048);
// segs > 0
// splits each row into segs segments of seg_len columns, one block each,
// with segs * min(k, 256) <= 4096.  scratch: R * segs * min(k, 256) + R
// uint64 (the segments' lists, then each row's last key of a round).
// state: R or more RowStates of 16 bytes (bound ~0, ticket 0), which every
// call leaves as it found them.  One launch a round of 256 keys.
extern "C" int rtpu_knn_select(const void* dist, int64_t n, int64_t R, int k, const void* ids, void* vals,
                               void* idx, int segs, int64_t seg_len, void* scratch, void* state, void* stream) {
  const int kmax = k < kRound ? k : kRound;
  const int64_t kMaxGrid = 0x7fffffff;
  if (n < 1 || n >= (int64_t{1} << 31) || R < 1 || k < 1 || k > n || segs < 0 ||
      (segs == 0 && (R > kMaxGrid || n > kSmallCols)) ||
      (segs > 0 && (seg_len < 1 || segs * seg_len < n || (segs - 1) * seg_len >= n ||
                    static_cast<int64_t>(segs) * kmax > kPool || R > kMaxGrid / segs)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto d = static_cast<const float*>(dist);
  const auto id = static_cast<const int32_t*>(ids);
  const auto v = static_cast<float*>(vals);
  const auto ix = static_cast<int32_t*>(idx);
  auto runs = static_cast<u64*>(scratch);
  u64* last = runs + R * segs * kmax;
  auto st = static_cast<RowState*>(state);
  for (int base = 0; base < k; base += kRound) {
    const int kr = k - base < kRound ? k - base : kRound;
    const u64* lower = base > 0 ? last : nullptr;
#define RTPU_ROUND(KPL) \
  select_round<KPL>(s, d, n, R, segs, seg_len, kr, k, base, lower, id, runs, st, v, ix, last)
    const cudaError_t err = kr <= 32 ? RTPU_ROUND(1) : kr <= 64 ? RTPU_ROUND(2) : kr <= 128 ? RTPU_ROUND(4)
                                                                                         : RTPU_ROUND(8);
#undef RTPU_ROUND
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// out (R, nprobe * cap) float32 and ids (same shape) int32: slot j of cell
// probe[r][p] (cells (nlist, cap) int32) scored against q row r, the bank
// as in rtpu_knn_score, plus bias (C,) and qmask (C,) when not null; a slot
// whose row id is negative or >= n_rows scores +inf.  16-byte loads when a
// row is a multiple of 16 bytes on a 16-byte aligned bank, element loads
// otherwise.
extern "C" int rtpu_ivf_score(const void* bank, int bank_type, const void* scale, const void* bias,
                              const void* qmask, const void* q, const void* cells, const void* probe,
                              int64_t C, int W, int64_t R, int nlist, int nprobe, int cap, int64_t n_rows,
                              int metric, void* out, void* ids, void* stream) {
  const int64_t pairs = R * nprobe;
  if (bank_type < kF32 || bank_type > kI8 || metric < 0 || metric > 2 || W < 1 || R < 1 || nprobe < 1 ||
      cap < 1 || nlist < 1 || pairs > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const float*>(scale);
  const auto b = static_cast<const float*>(bias);
  const auto qm = static_cast<const float*>(qmask);
  const auto qq = static_cast<const float*>(q);
  const auto cl = static_cast<const int32_t*>(cells);
  const auto pr = static_cast<const int32_t*>(probe);
  const auto o = static_cast<float*>(out);
  const auto id = static_cast<int32_t*>(ids);
  const int64_t lim = n_rows < C ? n_rows : C;
  const int es = bank_type == kF32 ? 4 : (bank_type == kF16 ? 2 : 1);
  const bool vec = (static_cast<int64_t>(W) * es) % 16 == 0 && reinterpret_cast<uintptr_t>(bank) % 16 == 0;
#define RTPU_IVF(BT, VEC) \
  ivf_launch<BT, VEC>(bank, sc, b, qm, qq, cl, pr, W, nlist, nprobe, cap, pairs, lim, metric, o, id, s)
  cudaError_t err;
  if (bank_type == kF32) err = vec ? RTPU_IVF(kF32, true) : RTPU_IVF(kF32, false);
  else if (bank_type == kF16) err = vec ? RTPU_IVF(kF16, true) : RTPU_IVF(kF16, false);
  else err = vec ? RTPU_IVF(kI8, true) : RTPU_IVF(kI8, false);
#undef RTPU_IVF
  return static_cast<int>(err);
}
