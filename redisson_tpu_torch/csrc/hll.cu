// HyperLogLog kernels for the sketch data plane.
//
// hll_add replaces the jitted HLL adds of redisson_tpu/core/kernels.py:
// _hll_bank_add_body (:446, reached by hll_bank_add_packed and
// hll_bank_add_u64), _hll_add_body (:439, hll_add_packed, hll_add_u64) and
// hll_add_bytes (:496).  One thread per valid op: hash, register index
// h1 & (2**p - 1), rank clz32(h2) + 1 (redisson_tpu/ops/hll.py:51-56), then a
// scatter-max into the uint8 register at tenant*width + idx.  CUDA has no
// 8-bit atomicMax, so the max is an atomicCAS loop on the aligned 32-bit word
// that holds the byte; it exits at once when the register is already at
// least the rank, which is most adds once a counter has filled.
// Bound on an H100: one random 32-byte sector read and written per op.  At
// config 3 (1M ops over a 164 MB bank) that is about 64 MB plus 12 MB of key
// words, ~23 us at 3.35 TB/s; warp-aggregated CAS is later work.
//
// hll_rows replaces the row programs: hll_bank_merge_map (:462),
// hll_bank_merge_map_from (:475), hll_merge (:503), hll_estimate (:504),
// hll_estimate_union (:505) and hll_bank_estimate_union_pairs (:509), with
// the estimator of redisson_tpu/ops/hll.py:74-94.  One block per output row:
// row = max(x[a_i], y[b_i]) read as 32-bit words (__vmaxu4), written to
// `out` if given, and histogrammed into 256 shared-memory bins if an estimate
// is asked for.  The write is out of place: a merge round reads rows of the
// bank while other rows are written, so writing into the input would race.
// The histogram makes the estimate exact and independent of summation order:
// sum 2**-r in float64 (exact for real registers), one rounding to float32,
// then the float32 estimator with each log taken in float64 and rounded once;
// ops/hll.py's plain version computes the same thing.
// Bound on an H100: streaming reads.  estimate_all over 10,000 x 16,384
// registers reads 164 MB, ~49 us at 3.35 TB/s; a merge reads and writes the
// bank, ~98 us.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;

__global__ void hll_add_kernel(uint8_t* __restrict__ regs, int64_t size, uint32_t width,
                               int p, rtpu::KeyBatch kb, int n_valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_valid) return;
  uint32_t h1, h2;
  rtpu::hash_key(kb, i, h1, h2);
  const uint32_t idx = h1 & ((1u << p) - 1u);
  const uint32_t rho = (uint32_t)__clz((int)h2) + 1u;
  const int64_t g = rtpu::flat_index(kb.tenant, i, width, idx, size);
  if (g < 0) return;  // outside is dropped
  unsigned int* word = reinterpret_cast<unsigned int*>(regs + (g & ~(int64_t)3));
  const int shift = (int)(g & 3) * 8;
  unsigned int old = *word;
  while (((old >> shift) & 0xFFu) < rho) {
    const unsigned int next = (old & ~(0xFFu << shift)) | (rho << shift);
    const unsigned int seen = atomicCAS(word, old, next);
    if (seen == old) break;
    old = seen;
  }
}

// JAX's gather rule for x[rows]: a negative row counts from the end once,
// then rows are clamped into [0, count).
__device__ __forceinline__ int64_t row_of(const int32_t* map, int i, int64_t count) {
  if (map == nullptr) return i;
  int64_t r = map[i];
  if (r < 0) r += count;
  return r < 0 ? 0 : (r >= count ? count - 1 : r);
}

__device__ float estimate_from_histogram(const unsigned int* hist, int64_t m,
                                         float alpha_mm) {
  double inv = 0.0;
  for (int r = 0; r < kBins; ++r) inv += ldexp((double)hist[r], -r);
  float e = __fdiv_rn(alpha_mm, (float)inv);
  const float zeros = (float)hist[0];
  const float lm = (float)log((double)m);
  const float lz = (float)log((double)fmaxf(zeros, 1.0f));
  const float lin = __fmul_rn((float)m, __fsub_rn(lm, lz));
  if (e <= (float)(2.5 * (double)m) && zeros > 0.0f) e = lin;
  const float two32 = 4294967296.0f;
  if (e > (float)(4294967296.0 / 30.0))
    e = __fmul_rn(-two32, (float)log1p((double)__fdiv_rn(-e, two32)));
  return e;
}

__global__ void hll_rows_kernel(const uint8_t* __restrict__ x, int64_t x_rows,
                                const uint8_t* __restrict__ y, int64_t y_rows,
                                const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int64_t m, uint8_t* __restrict__ out, float* __restrict__ est,
                                float alpha_mm) {
  __shared__ unsigned int hist[kBins];
  const int row = blockIdx.x;
  const uint32_t* xr = reinterpret_cast<const uint32_t*>(x + row_of(a, row, x_rows) * m);
  const uint32_t* yr =
      y ? reinterpret_cast<const uint32_t*>(y + row_of(b, row, y_rows) * m) : nullptr;
  uint32_t* orow = out ? reinterpret_cast<uint32_t*>(out + (int64_t)row * m) : nullptr;
  if (est) {
    for (int t = threadIdx.x; t < kBins; t += blockDim.x) hist[t] = 0u;
    __syncthreads();
  }
  const int64_t words = m / 4;
  for (int64_t w = threadIdx.x; w < words; w += blockDim.x) {
    uint32_t v = xr[w];
    if (yr) v = __vmaxu4(v, yr[w]);
    if (orow) orow[w] = v;
    if (est) {
      atomicAdd(&hist[v & 0xFFu], 1u);
      atomicAdd(&hist[(v >> 8) & 0xFFu], 1u);
      atomicAdd(&hist[(v >> 16) & 0xFFu], 1u);
      atomicAdd(&hist[v >> 24], 1u);
    }
  }
  if (!est) return;
  __syncthreads();
  if (threadIdx.x == 0) est[row] = estimate_from_histogram(hist, m, alpha_mm);
}

rtpu::KeyBatch key_batch(const void* tenant, const void* lo, const void* hi,
                         const void* words, const void* nbytes, int n_words, int n) {
  return rtpu::KeyBatch{static_cast<const uint32_t*>(tenant),
                        static_cast<const uint32_t*>(lo),
                        static_cast<const uint32_t*>(hi),
                        static_cast<const uint32_t*>(words),
                        static_cast<const uint32_t*>(nbytes), n_words, n};
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.
extern "C" int rtpu_hll_add(void* regs, int64_t size, int64_t width, int p,
                            const void* tenant, const void* lo, const void* hi,
                            const void* words, const void* nbytes, int n_words, int n,
                            int n_valid, void* stream) {
  const int blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  hll_add_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(regs), size, (uint32_t)width, p,
      key_batch(tenant, lo, hi, words, nbytes, n_words, n), n_valid);
  return (int)cudaGetLastError();
}

extern "C" int rtpu_hll_rows(const void* x, int64_t x_rows, const void* y, int64_t y_rows,
                             const void* a, const void* b, int64_t rows, int64_t m,
                             void* out, void* est, float alpha_mm, void* stream) {
  if (rows > 0) {
    hll_rows_kernel<<<(unsigned)rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), x_rows, static_cast<const uint8_t*>(y), y_rows,
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), m,
        static_cast<uint8_t*>(out), static_cast<float*>(est), alpha_mm);
  }
  return (int)cudaGetLastError();
}
