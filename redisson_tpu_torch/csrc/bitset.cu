// BitSet kernels: SETBIT and GETBIT batches over an expanded bit plane (one
// uint8 lane per bit, redisson_tpu/ops/bittensor.py:10-14).
//
// bitset_get replaces the jitted bitset_get of redisson_tpu/core/kernels.py
// (:526, over ops/bittensor.py get_bits :46): out[i] = bits[idx[i]], an index
// in [-size, -1] counting from the end once (JAX's .at[].get normalises
// negative indexes), any other index outside [0, size) reading 0.
//
// bitset_set replaces bitset_set (:518): every op i < n_valid reports its old
// bit and stores `value` (0 or 1, one value for the batch) at its index;
// masked ops and indexes outside the plane read 0 and write nothing.  Every
// old bit is read from the plane as it stood before the batch, so two equal
// indexes both report the pre-batch bit and a fresh index reports 0 even when
// another op of the batch sets it.  One pass in which some threads store
// while others load would break that, so the entry point launches two kernels
// in stream order: the read pass gathers every old bit, then the write pass
// stores `value` where the old bit differs from it (a lane that already holds
// the value is left alone, so its sector is not dirtied).
//
// Bound on an H100: random 32-byte sectors, not bytes.  An op reads one byte
// of a sector of its own (a write dirties it once more), so a batch moves
// 32 bytes per distinct sector it touches plus 5 bytes per op of index and
// reply.  The design is the simple one: one thread per op, the index load
// and the reply store coalesced, the plane access a scattered byte.  A plane
// that fits in the 50 MB L2 (config 5's 1 MiB default) is served from L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// The plane position of an index, or -1 when it reads 0 / writes nothing.
__device__ __forceinline__ int64_t lane_of(int32_t idx, int64_t size) {
  int64_t i = idx;
  if (i < 0) i += size;
  return (i >= 0 && i < size) ? i : -1;
}

__global__ void __launch_bounds__(kThreads)
bitset_read_kernel(const uint8_t* __restrict__ bits, int64_t size,
                   const int32_t* __restrict__ idx, int n, int n_valid,
                   uint8_t* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int64_t j = i < n_valid ? lane_of(idx[i], size) : -1;
    out[i] = j >= 0 ? __ldg(bits + j) : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
bitset_write_kernel(uint8_t* __restrict__ bits, int64_t size,
                    const int32_t* __restrict__ idx, int n_valid,
                    const uint8_t* __restrict__ old, uint8_t value) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_valid; i += gridDim.x * blockDim.x) {
    const int64_t j = lane_of(idx[i], size);
    if (j >= 0 && old[i] != value) bits[j] = value;
  }
}

int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > 65535 ? 65535 : b);
}

}  // namespace

// out[i] = bits[idx[i]] for i < n (every op valid).
extern "C" int rtpu_bitset_get(const void* bits, int64_t size, const void* idx, int n,
                               void* out, void* stream) {
  if (n > 0) {
    bitset_read_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bits), size, static_cast<const int32_t*>(idx), n, n,
        static_cast<uint8_t*>(out));
  }
  return (int)cudaGetLastError();
}

// old[i] = the pre-batch bit of op i (0 for i >= n_valid), then `value` at
// the index of every op i < n_valid.  0 <= n_valid <= n (the wrapper clamps).
extern "C" int rtpu_bitset_set(void* bits, int64_t size, const void* idx, int n, int n_valid,
                               int value, void* old, void* stream) {
  if (n > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto ip = static_cast<const int32_t*>(idx);
    const auto op = static_cast<uint8_t*>(old);
    bitset_read_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(bits), size, ip, n, n_valid, op);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n_valid > 0) {
      bitset_write_kernel<<<blocks_for(n_valid), kThreads, 0, s>>>(
          static_cast<uint8_t*>(bits), size, ip, n_valid, op, (uint8_t)value);
    }
  }
  return (int)cudaGetLastError();
}
