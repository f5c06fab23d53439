// Bloom probe and set kernels for the sketch data plane.
//
// bloom_probe replaces the probe half of the jitted bloom programs in
// redisson_tpu/core/kernels.py: _bloom_bank_contains_body (:184, reached by
// bloom_bank_contains_packed[_bits] and bloom_bank_contains_u64),
// _bloom_contains_body (:129) and bloom_contains_bytes_masked (:150), and the
// "newly" read of _bloom_bank_add_body (:167), _bloom_add_body (:118) and
// bloom_add_bytes_masked (:140).  One thread per op: hash, read the k bytes
// at tenant*width + (h1 + i*h2) % m, AND them, mask ops >= n_valid.  The
// result is a flag per op, a uint32 bitmap (warp ballot: bit i of word j is
// op 32j+i, the layout of _pack_bool_u32), or a count (one atomicAdd per
// block).
//
// bloom_set replaces the scatter half of the add programs: one thread per
// valid op stores 1 at its k positions.  Plain byte stores of one constant
// need no atomics.  Launched after bloom_probe on the same stream, it gives
// the add contract of kernels.py:178-181: "newly" is read from the plane as
// it stood before the batch, so two equal keys in one batch both report it.
//
// Bound on an H100: random 32-byte sector reads (probe) and writes (set).  A
// config-2 contains flush (100k ops in a 114,688 batch, k = 7, a 96 MB plane
// larger than the 50 MB L2) touches at most 700k sectors = 22.4 MB plus
// 1.4 MB of key words and 14 KB of bitmap, about 7 us at 3.35 TB/s; the hash
// is ~150 integer operations per key, under 0.3 us of issue.  This simple
// design reads each probe with its own byte load and keeps every op in
// flight at once (one thread each) to hide the latency; vectorised probes
// and a single fused add pass are later work.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

enum OutMode { OUT_FLAGS = 0, OUT_BITS = 1, OUT_COUNT = 2 };
constexpr int kThreads = 256;

__global__ void bloom_probe_kernel(const uint8_t* __restrict__ plane, int64_t size,
                                   uint32_t width, rtpu::KeyBatch kb, int n_valid,
                                   int k, uint32_t m, int newly, int out_mode,
                                   void* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool flag = false;
  if (i < n_valid) {
    uint32_t h1, h2;
    rtpu::hash_key(kb, i, h1, h2);
    bool found = true;
    uint32_t pos = h1;  // h1 + j*h2, mod 2**32
    for (int j = 0; j < k; ++j) {
      const int64_t g = rtpu::flat_index(kb.tenant, i, width, pos % m, size);
      if (g >= 0 && plane[g] == 0) found = false;  // outside reads as 1
      pos += h2;
    }
    flag = newly ? !found : found;
  }
  if (out_mode == OUT_FLAGS) {
    if (i < kb.n) static_cast<uint8_t*>(out)[i] = flag;
  } else if (out_mode == OUT_BITS) {
    const unsigned word = __ballot_sync(0xffffffffu, flag);
    if ((threadIdx.x & 31) == 0 && i < kb.n) static_cast<uint32_t*>(out)[i >> 5] = word;
  } else {
    const int c = __syncthreads_count(flag);
    if (threadIdx.x == 0 && c) atomicAdd(static_cast<int*>(out), c);
  }
}

__global__ void bloom_set_kernel(uint8_t* __restrict__ plane, int64_t size,
                                 uint32_t width, rtpu::KeyBatch kb, int n_valid,
                                 int k, uint32_t m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_valid) return;
  uint32_t h1, h2;
  rtpu::hash_key(kb, i, h1, h2);
  uint32_t pos = h1;
  for (int j = 0; j < k; ++j) {
    const int64_t g = rtpu::flat_index(kb.tenant, i, width, pos % m, size);
    if (g >= 0) plane[g] = 1;  // outside is dropped
    pos += h2;
  }
}

rtpu::KeyBatch key_batch(const void* tenant, const void* lo, const void* hi,
                         const void* words, const void* nbytes, int n_words, int n) {
  return rtpu::KeyBatch{static_cast<const uint32_t*>(tenant),
                        static_cast<const uint32_t*>(lo),
                        static_cast<const uint32_t*>(hi),
                        static_cast<const uint32_t*>(words),
                        static_cast<const uint32_t*>(nbytes), n_words, n};
}

int blocks_for(int n) { return n > 0 ? (n + kThreads - 1) / kThreads : 1; }

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.
extern "C" int rtpu_bloom_probe(const void* plane, int64_t size, int64_t width,
                                const void* tenant, const void* lo, const void* hi,
                                const void* words, const void* nbytes, int n_words,
                                int n, int n_valid, int k, int64_t m, int newly,
                                int out_mode, void* out, void* stream) {
  bloom_probe_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), size, (uint32_t)width,
      key_batch(tenant, lo, hi, words, nbytes, n_words, n), n_valid, k, (uint32_t)m,
      newly, out_mode, out);
  return (int)cudaGetLastError();
}

extern "C" int rtpu_bloom_set(void* plane, int64_t size, int64_t width, const void* tenant,
                              const void* lo, const void* hi, const void* words,
                              const void* nbytes, int n_words, int n, int n_valid, int k,
                              int64_t m, void* stream) {
  bloom_set_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(plane), size, (uint32_t)width,
      key_batch(tenant, lo, hi, words, nbytes, n_words, n), n_valid, k, (uint32_t)m);
  return (int)cudaGetLastError();
}

extern "C" const char* rtpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
