// The tiled float32 product of knn_score's tile route (csrc/knn.cu: more
// than 8 queries against a bank of at most 16,384 rows, the IVF route's
// centroids, and rows wider than 256) and of kmeans_assign (csrc/kmeans.cu):
// the dot products of a tile of BQ query (or point) rows against a tile of
// BC bank (or centroid) rows, with each row's sum of squares taken in the
// same pass.  It replaces the scoring of redisson_tpu/core/kernels.py
// (_knn_distances :646, _bank_f32 :666) on those routes.  Bound on an H100:
// the float32 FMAs; this simple design reaches ~30% of their peak, because
// a block loads both operands a depth step at a time with 4-byte loads and
// no overlap of loads and FMAs (about 3 FMAs a shared load).  knn_score's
// wide banks take the streamed route of csrc/knn.cu instead.
//
// Every product is a float32 FMA on the CUDA cores, never TF32 or bf16 on
// the tensor cores: those keep about three decimal digits and change which
// rows win against the reference, which computes an exact float32 product.
// A block of 256 threads walks the depth W in steps of kBK = 32: it stages a
// (BQ x 32) query tile and a (BC x 32) bank tile in shared memory, widening
// FLOAT16 rows and INT8 rows times their per-row scale to float32 as it
// loads them (the dequantized plane never exists in device memory), and
// each thread adds MQ x MC products a step.  Lanes past W and rows past the
// operands load 0, which adds exactly 0 to every dot product and norm.
// Each sum is taken in the order of the depth, one FMA a term.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rtpu_tile {

constexpr int kThreads = 256;
constexpr int kBK = 32;

enum BankType { kF32 = 0, kF16 = 1, kI8 = 2 };

// Element (row, col) of a (rows, W) bank widened to float32: FLOAT16 as it
// is, INT8 times its row's scale (when there is one), as the reference's
// _bank_f32 does (redisson_tpu/core/kernels.py:666).
template <int BT>
__device__ __forceinline__ float bank_at(const void* bank, const float* scale, int64_t row, int W,
                                         int col) {
  const int64_t at = row * W + col;
  if (BT == kF32) return static_cast<const float*>(bank)[at];
  if (BT == kF16) return __half2float(static_cast<const __half*>(bank)[at]);
  const float v = static_cast<float>(static_cast<const int8_t*>(bank)[at]);
  return scale != nullptr ? __fmul_rn(v, scale[row]) : v;
}

// TQT x (kThreads / TQT) threads; each owns MQ query rows (tq + TQT * i) and
// MC bank rows (tc + TCT * j) of the tile, strided so that a warp's shared
// loads are broadcasts or consecutive words.
template <int TQT, int MQ, int MC>
struct Shape {
  static constexpr int TCT = kThreads / TQT;
  static constexpr int BQ = TQT * MQ;
  static constexpr int BC = TCT * MC;
};

template <int TQT, int MQ, int MC>
struct Smem {
  using S = Shape<TQT, MQ, MC>;
  float qs[kBK][S::BQ + 1];
  float bs[kBK][S::BC + 1];
  float nrm[S::BC + S::BQ];  // bank rows' sums of squares, then the queries'
};

// acc[i][j] = q row (q0 + tq + TQT i) . bank row (c0 + tc + TCT j), and
// sm.nrm the tile's sums of squares, when the call returns (behind a
// __syncthreads, so every thread may read sm.nrm).  It starts with a
// __syncthreads too, so a caller may read sm.nrm between two calls.
template <int TQT, int MQ, int MC, int BT>
__device__ __forceinline__ void tile_dots(Smem<TQT, MQ, MC>& sm, const void* bank, const float* scale,
                                          int64_t C, int W, const float* q, int64_t R, int64_t c0,
                                          int64_t q0, float (&acc)[MQ][MC]) {
  using S = Shape<TQT, MQ, MC>;
  const int tid = threadIdx.x;
  const int tq = tid / S::TCT, tc = tid % S::TCT;
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int j = 0; j < MC; ++j) acc[i][j] = 0.0f;
  __syncthreads();
  for (int r = tid; r < S::BC + S::BQ; r += kThreads) sm.nrm[r] = 0.0f;
  for (int k0 = 0; k0 < W; k0 += kBK) {
    // a warp loads kBK consecutive lanes of one row: coalesced
    for (int e = tid; e < S::BC * kBK; e += kThreads) {
      const int row = e / kBK, col = e % kBK;
      const int64_t gr = c0 + row;
      const int gc = k0 + col;
      sm.bs[col][row] = (gr < C && gc < W) ? bank_at<BT>(bank, scale, gr, W, gc) : 0.0f;
    }
    for (int e = tid; e < S::BQ * kBK; e += kThreads) {
      const int row = e / kBK, col = e % kBK;
      const int64_t gq = q0 + row;
      const int gc = k0 + col;
      sm.qs[col][row] = (gq < R && gc < W) ? q[gq * W + gc] : 0.0f;
    }
    __syncthreads();
    // each norm has one owner thread for the whole call: no race
    for (int r = tid; r < S::BC + S::BQ; r += kThreads) {
      float a = sm.nrm[r];
      if (r < S::BC) {
#pragma unroll 8
        for (int k = 0; k < kBK; ++k) a = fmaf(sm.bs[k][r], sm.bs[k][r], a);
      } else {
#pragma unroll 8
        for (int k = 0; k < kBK; ++k) a = fmaf(sm.qs[k][r - S::BC], sm.qs[k][r - S::BC], a);
      }
      sm.nrm[r] = a;
    }
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[MQ], b[MC];
#pragma unroll
      for (int i = 0; i < MQ; ++i) a[i] = sm.qs[k][tq + TQT * i];
#pragma unroll
      for (int j = 0; j < MC; ++j) b[j] = sm.bs[k][tc + S::TCT * j];
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The squared L2 distance as the reference writes it,
// (|q|^2 - 2 q.b) + |b|^2, in that order and without contraction.
__device__ __forceinline__ float l2_of(float dot, float qsq, float bsq) {
  return __fadd_rn(__fsub_rn(qsq, __fmul_rn(2.0f, dot)), bsq);
}

// The metrics of _knn_distances (redisson_tpu/core/kernels.py:646):
// 0 L2, 1 COSINE (1 - cos, and 1 where a norm is 0), 2 IP (1 - q.b).
__device__ __forceinline__ float metric_of(int metric, float dot, float qsq, float bsq) {
  if (metric == 0) return l2_of(dot, qsq, bsq);
  if (metric == 1) {
    const float den = __fmul_rn(__fsqrt_rn(qsq), __fsqrt_rn(bsq));
    return __fsub_rn(1.0f, den > 0.0f ? __fdiv_rn(dot, den) : 0.0f);
  }
  return __fsub_rn(1.0f, dot);
}

}  // namespace rtpu_tile
