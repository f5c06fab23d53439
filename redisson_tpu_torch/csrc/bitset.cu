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
// while others load would break that, so every read comes before any write,
// in one launch a call:
//   * up to kBlockOps ops (config 5's SETBITSB of 500): one block loads every
//     op's old bit into registers (kBlockOps / 256 a thread), passes a
//     __syncthreads, then stores the replies and writes `value`;
//   * more ops: a cooperative launch of at most the blocks the card keeps
//     resident (asked once per device), grid-stride: phase 1 writes every
//     old bit to the reply, coalesced; after this_grid().sync(), phase 2
//     re-reads the index and the reply and writes.
// A lane that already holds the value is left alone, so its sector is not
// dirtied.  The grid kernel alone would take every batch, but at config 5's
// 500 ops it takes 0.0072 ms against the block's 0.0058 (the cooperative
// launch and its barrier; tools/variant_ab.py on an H100 80GB HBM3 at
// 700 W), so both forms stay.  On 1M ops into 2**28 lanes the grid ties
// with the two launches it replaced.
//
// Bound on an H100: random 32-byte sectors, not bytes.  An op reads one byte
// of a sector of its own (a write dirties it once more), so a batch moves
// 32 bytes per distinct sector it touches plus 5 bytes per op of index and
// reply.  The design is the simple one: one thread per op, the index load
// and the reply store coalesced, the plane access a scattered byte.  A plane
// that fits in the 50 MB L2 (config 5's 1 MiB default) is served from L2;
// config 5's batches are bound by one launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
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

constexpr int kBlockPer = 8, kBlockOps = kThreads * kBlockPer;

// n <= kBlockOps, one block: every read, a barrier, then every write
__global__ void __launch_bounds__(kThreads)
bitset_set_block_kernel(uint8_t* bits, int64_t size, const int32_t* __restrict__ idx, int n, int n_valid,
                        uint8_t value, uint8_t* __restrict__ old) {
  int64_t lane[kBlockPer];
  uint8_t was[kBlockPer];
#pragma unroll
  for (int r = 0; r < kBlockPer; ++r) {
    const int i = threadIdx.x + kThreads * r;
    lane[r] = i < n_valid ? lane_of(idx[i], size) : -1;
    was[r] = lane[r] >= 0 ? bits[lane[r]] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kBlockPer; ++r) {
    const int i = threadIdx.x + kThreads * r;
    if (i < n) old[i] = was[r];
    if (lane[r] >= 0 && was[r] != value) bits[lane[r]] = value;
  }
}

// any n, a cooperative grid: every old bit, a grid barrier, then the writes
__global__ void __launch_bounds__(kThreads)
bitset_set_grid_kernel(uint8_t* bits, int64_t size, const int32_t* __restrict__ idx, int n, int n_valid,
                       uint8_t value, uint8_t* old) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t j = i < n_valid ? lane_of(idx[i], size) : -1;
    old[i] = j >= 0 ? bits[j] : 0;
  }
  cooperative_groups::this_grid().sync();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_valid; i += stride) {
    const int64_t j = lane_of(idx[i], size);
    if (j >= 0 && old[i] != value) bits[j] = value;
  }
}

// The grid kernel's co-resident blocks on the current device, asked once
// per device.
cudaError_t grid_resident(int& blocks) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> known[kMaxDevices];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (blocks = known[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bitset_set_grid_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  blocks = sms * per_sm;
  if (dev < kMaxDevices) known[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
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
// the index of every op i < n_valid; one launch.  0 <= n_valid <= n (the
// wrapper clamps).
extern "C" int rtpu_bitset_set(void* bits, int64_t size, const void* idx, int n, int n_valid,
                               int value, void* old, void* stream) {
  if (n < 1) return (int)cudaGetLastError();
  const auto s = static_cast<cudaStream_t>(stream);
  auto bp = static_cast<uint8_t*>(bits);
  auto ip = static_cast<const int32_t*>(idx);
  auto op = static_cast<uint8_t*>(old);
  auto v = static_cast<uint8_t>(value);
  if (n <= kBlockOps) {
    bitset_set_block_kernel<<<1, kThreads, 0, s>>>(bp, size, ip, n, n_valid, v, op);
    return (int)cudaGetLastError();
  }
  int resident = 0;
  const cudaError_t err = grid_resident(resident);
  if (err != cudaSuccess) return (int)err;
  const int need = (n + kThreads - 1) / kThreads;
  void* args[] = {&bp, &size, &ip, &n, &n_valid, &v, &op};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bitset_set_grid_kernel),
                                          dim3(need < resident ? need : resident), dim3(kThreads), args, 0, s);
}
