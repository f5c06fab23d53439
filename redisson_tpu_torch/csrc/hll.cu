// HyperLogLog kernels for the sketch data plane.
//
// hll_add replaces the jitted HLL adds of redisson_tpu/core/kernels.py:
// _hll_bank_add_body (:446, reached by hll_bank_add_packed and
// hll_bank_add_u64), _hll_add_body (:439, hll_add_packed, hll_add_u64) and
// hll_add_bytes (:496).  One thread per valid op: hash, register index
// h1 & (2**p - 1), rank clz32(h2) + 1 (redisson_tpu/ops/hll.py:51-56), then a
// scatter-max into the uint8 register at tenant*width + idx.  CUDA has no
// 8-bit atomicMax, so the max is an atomicCAS loop on the aligned 32-bit word
// that holds the byte: the thread loads the word, leaves at once when the
// register already holds at least the rank (most ops once a counter has
// filled), else CASes; a failed CAS returns the word as it stands.
// Bound on an H100: random sectors, not bytes.  On a bank larger than the
// 50 MB L2 every op's first request misses (tools/bloom_diag.py `hll`: 1M
// random register ops into config 3's 164 MB bank take ~0.034 ms as loads,
// ~0.072 as CASes alone, ~0.075 as a load then a CAS).  A first CAS that
// guesses four empty registers, with no load, saves the load on a zeroed
// bank but pays an atomic for every op once the registers fill, where the
// load ends most of them: the kernel keeps the load (PERF.md section 6).
//
// hll_rows replaces the row programs: hll_bank_merge_map (:462),
// hll_bank_merge_map_from (:475), hll_merge (:503), hll_estimate (:504),
// hll_estimate_union (:505) and hll_bank_estimate_union_pairs (:509), with
// the estimator of redisson_tpu/ops/hll.py:74-94.  Row i = max(x[a_i],
// y[b_i]) (__vmaxu4 on 32-bit words), written to `out` if given, and its
// float32 estimate if asked for.  The write is out of place: a merge round
// reads rows of the bank while other rows are written, so writing into the
// input would race.
// Bound on an H100: streaming reads.  estimate_all over 10,000 x 16,384
// registers reads 164 MB, ~49 us at 3.35 TB/s (a plain streaming read of it
// takes ~57 us on the card); a merge reads two banks and writes one, ~147 us.
// Design: one warp per row, 16-byte loads (4-byte ones for a bank that is
// only 4-byte aligned), four in flight per lane, warps independent of each
// other so that loads and counting overlap across warps.  The estimate needs
// the sum of 2**-r and the count of zeros.  Registers 0-7 (all but ~0.5% of
// the registers of a counter of up to 10**4 keys at p = 14) are counted in
// registers: a byte permute maps each byte to its term 2**(7 - r) and
// __dp4a adds them; only registers >= 8 go to the warp's own 256-bin
// histogram in shared memory (a shared atomic each).  The design before fed one block-wide histogram with
// four shared atomics per word and was bound by their rate.
// The estimate is exact and independent of summation order: the sum of
// 2**-r in float64 (exact for real registers), one rounding to float32, then
// the float32 estimator with each log taken in float64 and rounded once;
// ops/hll.py's plain version computes the same thing.
#include <cuda_runtime.h>

#include <atomic>

#include "hash.cuh"

namespace {

constexpr int kAddThreads = 256;
constexpr int kRowThreads = 256;  // a row block: 8 warps, each on its own row
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kBins = 256;

__global__ void __launch_bounds__(kAddThreads)
hll_add_kernel(uint8_t* __restrict__ regs, int64_t size, uint32_t width, int p,
               rtpu::KeyBatch kb, int n_valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_valid) return;
  uint32_t h1, h2;
  rtpu::hash_key(kb, i, h1, h2);
  const uint32_t rho = (uint32_t)__clz((int)h2) + 1u;
  const int64_t g = rtpu::flat_index(kb.tenant, i, width, h1 & ((1u << p) - 1u), size);
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
__device__ __forceinline__ int64_t row_of(const int32_t* map, int64_t i, int64_t count) {
  if (map == nullptr) return i;
  int64_t r = map[i];
  if (r < 0) r += count;
  return r < 0 ? 0 : (r >= count ? count - 1 : r);
}

// The float32 estimate from the row's sum of 2**-r, its count of zeros and
// lm = (float)log(m); the log of the zeros only where linear counting takes it.
__device__ float estimate(double inv, uint32_t zeros_n, int64_t m, float lm, float alpha_mm) {
  float e = __fdiv_rn(alpha_mm, (float)inv);
  const float zeros = (float)zeros_n;
  if (e <= (float)(2.5 * (double)m) && zeros > 0.0f) {
    e = __fmul_rn((float)m, __fsub_rn(lm, (float)log((double)zeros)));
  }
  const float two32 = 4294967296.0f;
  if (e > (float)(4294967296.0 / 30.0))
    e = __fmul_rn(-two32, (float)log1p((double)__fdiv_rn(-e, two32)));
  return e;
}

// Counts one word of four registers into a thread's sums: s of 2**(7 - r)
// over its registers r <= 7 and z of its zeros.  A byte permute turns each
// byte's low 3 bits into its term (and a zero flag), and __dp4a adds the
// bytes whose register is <= 7.  A register >= 8 goes to the warp's
// histogram `wh` (a shared atomic).
__device__ __forceinline__ void count_word(uint32_t v, uint32_t& s, uint32_t& z, uint32_t* wh) {
  // bit 7 of a byte: the byte is >= 8 (bits 3-6 carry into it, bit 7 is itself)
  const uint32_t big = (((v & 0x78787878u) + 0x78787878u) | v) & 0x80808080u;
  const uint32_t small = (big >> 7) ^ 0x01010101u;  // byte j: 1 when register j <= 7
  // nibble j of sel: register j & 7
  const uint32_t sel = __byte_perm((v & 0x07070707u) | ((v >> 4) & 0x00700070u), 0u, 0x0020u);
  s = __dp4a(__byte_perm(0x10204080u, 0x01020408u, sel), small, s);  // 2**(7 - r) per byte
  z = __dp4a(__byte_perm(1u, 0u, sel), small, z);                     // 1 per byte r == 0
  if (big) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (big & (0x80u << (8 * b))) atomicAdd(&wh[(v >> (8 * b)) & 0xFFu], 1u);
    }
  }
}

// W 32-bit words per load: 4 (16-byte loads and stores) or 1.
template <int W>
__device__ __forceinline__ void load_vec(const uint8_t* p, uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

template <int W>
__device__ __forceinline__ void store_vec(uint8_t* p, const uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// One warp per row at a time: warp g of the grid takes rows g, g + warps,
// ... (`warps` is the grid's warp count), each row in steps of four
// vectors a lane (two of x and two of y when there is a y), all loads of a
// step in flight together.  The warps are independent (no block barrier),
// so while some count, others' loads are in flight.  Per row a lane keeps
// s and z (count_word) and the warp its own 256-bin histogram of the
// registers >= 8 in shared memory; at the end of the row the warp adds s
// and z over its lanes, each lane takes 8 bins of the histogram (and
// clears them), and lane 0 writes the estimate.
template <int W, bool kY, bool kEst>
__global__ void __launch_bounds__(kRowThreads)
hll_rows_kernel(const uint8_t* __restrict__ x, int64_t x_rows, const uint8_t* __restrict__ y,
                int64_t y_rows, const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int64_t rows, int64_t m, uint8_t* __restrict__ out, float* __restrict__ est,
                float alpha_mm, int64_t warps) {
  constexpr int U = kY ? 2 : 4;
  __shared__ uint32_t hist[kRowWarps][kBins];
  const int lane = threadIdx.x & 31;
  uint32_t* wh = hist[threadIdx.x >> 5];
  if (kEst) {
    for (int t = lane; t < kBins; t += 32) wh[t] = 0u;
    __syncwarp();
  }
  const float lm = kEst ? (float)log((double)m) : 0.0f;
  const int nvec = (int)(m / (4 * W));
  for (int64_t row = (int64_t)blockIdx.x * kRowWarps + (threadIdx.x >> 5); row < rows; row += warps) {
    const uint8_t* xr = x + row_of(a, row, x_rows) * m;
    const uint8_t* yr = kY ? y + row_of(b, row, y_rows) * m : nullptr;
    uint8_t* orow = out ? out + row * m : nullptr;
    uint32_t s = 0u, z = 0u;
    for (int base = 0; base < nvec; base += U * 32) {
      uint32_t w[U][W], o[U][W];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = base + u * 32 + lane;
        if (v < nvec) {
          load_vec<W>(xr + (int64_t)v * 4 * W, w[u]);
          if (kY) load_vec<W>(yr + (int64_t)v * 4 * W, o[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = base + u * 32 + lane;
        if (v >= nvec) continue;
        if (kY) {
#pragma unroll
          for (int j = 0; j < W; ++j) w[u][j] = __vmaxu4(w[u][j], o[u][j]);
        }
        if (orow) store_vec<W>(orow + (int64_t)v * 4 * W, w[u]);
        if (kEst) {
#pragma unroll
          for (int j = 0; j < W; ++j) count_word(w[u][j], s, z, wh);
        }
      }
    }
    if (!kEst) continue;
    s = __reduce_add_sync(0xffffffffu, s);
    z = __reduce_add_sync(0xffffffffu, z);
    __syncwarp();  // the warp's histogram is complete
    double inv = 0.0;
    for (int r = lane; r < kBins; r += 32) {
      const uint32_t n = wh[r];
      if (n) {
        inv += ldexp((double)n, -r);
        wh[r] = 0u;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) inv += __shfl_xor_sync(0xffffffffu, inv, d);
    if (lane == 0) {
      est[row] = estimate(ldexp((double)s, -7) + inv, z, m, lm, alpha_mm);
    }
    __syncwarp();  // cleared before the next row counts
  }
}

// As many warps as the card keeps resident for this instantiation, asked
// once per device and kept.
template <int W, bool kY, bool kEst>
cudaError_t resident_warps(int64_t& warps) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int64_t> known[kMaxDevices];  // 0: not asked yet
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (warps = known[dev].load(std::memory_order_relaxed)) > 0) {
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hll_rows_kernel<W, kY, kEst>, kRowThreads, 0);
  }
  if (err != cudaSuccess) return err;
  warps = (int64_t)sms * (per_sm > 0 ? per_sm : 1) * kRowWarps;
  if (dev < kMaxDevices) known[dev].store(warps, std::memory_order_relaxed);
  return cudaSuccess;
}

// Grid of a row launch: as many warps as the card keeps resident, cut to
// spread the rows evenly (every warp gets the same number of rows, give or
// take one).
template <int W, bool kY, bool kEst>
cudaError_t launch_rows(const uint8_t* x, int64_t x_rows, const uint8_t* y, int64_t y_rows,
                        const int32_t* a, const int32_t* b, int64_t rows, int64_t m, uint8_t* out,
                        float* est, float alpha_mm, cudaStream_t s) {
  int64_t resident = 0;
  const cudaError_t err = resident_warps<W, kY, kEst>(resident);
  if (err != cudaSuccess) return err;
  const int64_t rounds = (rows + resident - 1) / resident;
  const int64_t blocks = ((rows + rounds - 1) / rounds + kRowWarps - 1) / kRowWarps;
  hll_rows_kernel<W, kY, kEst><<<(unsigned)blocks, kRowThreads, 0, s>>>(
      x, x_rows, y, y_rows, a, b, rows, m, out, est, alpha_mm, blocks * kRowWarps);
  return cudaSuccess;
}

template <int W>
cudaError_t launch_rows_w(const uint8_t* x, int64_t x_rows, const uint8_t* y, int64_t y_rows,
                          const int32_t* a, const int32_t* b, int64_t rows, int64_t m,
                          uint8_t* out, float* est, float alpha_mm, cudaStream_t s) {
  if (y) {
    return est ? launch_rows<W, true, true>(x, x_rows, y, y_rows, a, b, rows, m, out, est, alpha_mm, s)
               : launch_rows<W, true, false>(x, x_rows, y, y_rows, a, b, rows, m, out, est, alpha_mm, s);
  }
  return est ? launch_rows<W, false, true>(x, x_rows, y, y_rows, a, b, rows, m, out, est, alpha_mm, s)
             : launch_rows<W, false, false>(x, x_rows, y, y_rows, a, b, rows, m, out, est, alpha_mm, s);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.
extern "C" int rtpu_hll_add(void* regs, int64_t size, int64_t width, int p,
                            const void* tenant, const void* lo, const void* hi,
                            const void* words, const void* nbytes, int n_words, int n,
                            int n_valid, void* stream) {
  const int blocks = n > 0 ? (n + kAddThreads - 1) / kAddThreads : 1;
  hll_add_kernel<<<blocks, kAddThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(regs), size, (uint32_t)width, p,
      rtpu::key_batch(tenant, lo, hi, words, nbytes, n_words, n), n_valid);
  return (int)cudaGetLastError();
}

// Banks are 4-byte aligned with m % 4 == 0 (the wrapper checks); 16-byte
// aligned banks with m % 16 == 0 take the 16-byte loads.
extern "C" int rtpu_hll_rows(const void* x, int64_t x_rows, const void* y, int64_t y_rows,
                             const void* a, const void* b, int64_t rows, int64_t m,
                             void* out, void* est, float alpha_mm, void* stream) {
  if (rows > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto xp = static_cast<const uint8_t*>(x), yp = static_cast<const uint8_t*>(y);
    const auto ap = static_cast<const int32_t*>(a), bp = static_cast<const int32_t*>(b);
    const auto op = static_cast<uint8_t*>(out);
    const auto ep = static_cast<float*>(est);
    const cudaError_t err =
        m % 16 == 0 && aligned16(x) && aligned16(y) && aligned16(out)
            ? launch_rows_w<4>(xp, x_rows, yp, y_rows, ap, bp, rows, m, op, ep, alpha_mm, s)
            : launch_rows_w<1>(xp, x_rows, yp, y_rows, ap, bp, rows, m, op, ep, alpha_mm, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
