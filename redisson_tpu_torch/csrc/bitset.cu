// BitSet kernels: SETBIT and GETBIT batches over expanded bit planes (one
// uint8 lane per bit, redisson_tpu/ops/bittensor.py:10-14).
//
// bitset_get replaces the jitted bitset_get of redisson_tpu/core/kernels.py
// (:526, over ops/bittensor.py get_bits :46): out[i] = bits[idx[i]], an index
// in [-size, -1] counting from the end once (JAX's .at[].get normalises
// negative indexes), any other index outside [0, size) reading 0.
//
// bitset_set replaces bitset_set (:518): every op i < n_valid reports its old
// bit and stores `value` (0 or 1) at its index; masked ops and indexes
// outside the plane read 0 and write nothing.  Every old bit is read from
// the plane as it stood before the batch, so two equal indexes both report
// the pre-batch bit and a fresh index reports 0 even when another op of the
// batch sets it.
//
// One launch serves the ops of many planes: a table of groups (Group, 32
// bytes each: the plane, its size, the group's first op, its op count, its
// live ops and the set's value), which the host copies to the card in the
// same transfer as the indexes.  An RBatch level (core/batch.py: groups on
// distinct records) is one bitset_get launch for its gets and one
// bitset_set launch for its sets: a config 5 batch's body is at the launch
// floor (~0.005 ms), so its cost is the launch count, and its fanout (128
// bit sets, each set and then read) is 2 launches, 0.0071-0.0075 ms each
// (tools/kernel_ab.py on an H100 80GB HBM3 at 700 W).  A one-plane call
// passes its one group by value (no table, no upload).  An op of the table finds its group by the group
// id the host uploads beside its index (4 bytes an op): a binary search of
// the groups' first ops in shared memory instead timed the same at
// fanout's level (0.0064 against 0.0062-0.0072 ms, tools/variant_ab.py on
// an H100 80GB HBM3 at 700 W), and the id is one load and no group limit.
//
// Planes are distinct, so within a set launch the only conflicts are equal
// indexes of one group, and every read comes before any write in one launch:
//   * every group up to kBlockOps ops (config 5's SETBITSB of 500): one
//     block a group loads each op's old bit into registers (kBlockOps / 256
//     a thread), passes a __syncthreads, then stores the replies and writes
//     `value`;
//   * a group of more ops: a cooperative launch of at most the blocks the
//     card keeps resident (asked once per device), grid-stride over every
//     op: phase 1 writes every old bit to the reply, coalesced; after
//     this_grid().sync(), phase 2 re-reads the index and the reply and
//     writes.
// A lane that already holds the value is left alone, so its sector is not
// dirtied.  The grid form alone takes 0.0072 ms at config 5's 500 ops
// against the block's 0.0058 (tools/variant_ab.py on an H100 80GB HBM3 at
// 700 W), so both forms stay.
//
// Bound on an H100: random 32-byte sectors, not bytes.  An op reads one byte
// of a sector of its own (a write dirties it once more), so a batch moves
// 32 bytes per distinct sector it touches plus 5 bytes per op of index and
// reply.  The design is the simple one: one thread per op, the index load
// and the reply store coalesced, the plane access a scattered byte.  A
// config 5 plane (1 MiB) and its batch are served from L2; such a batch is
// bound by one launch, so the gain is in the launches a batch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockPer = 8, kBlockOps = kThreads * kBlockPer;

// ops [first, first + count) of the launch act on `bits`; ops [first,
// first + valid) are live (valid < count only for a one-plane call's masked
// tail); value is a set's (0 or 1), unused by a get
struct Group {
  uint8_t* bits;
  int64_t size;
  int32_t first, count, valid, value;
};
static_assert(sizeof(Group) == 32, "core/kernels.py packs 32-byte groups");

// The plane position of an index, or -1 when it reads 0 / writes nothing.
// lo >= 0: the plane is a shard's bits [lo, lo + size) of one logical bit
// set (parallel/sharded.py), and an index another shard holds reads 0 and
// writes nothing.  lo < 0: the whole plane, a negative index counting from
// its end once.
__device__ __forceinline__ int64_t lane_of(int32_t idx, int64_t size, int64_t lo) {
  int64_t i = idx;
  if (lo >= 0) {
    i -= lo;
  } else if (i < 0) {
    i += size;
  }
  return (i >= 0 && i < size) ? i : -1;
}

// The group of op i: the only one without a table, else its uploaded id.
__device__ __forceinline__ Group group_of(int i, const Group* table, const Group& one, const int32_t* gid) {
  return table == nullptr ? one : table[gid[i]];
}

__global__ void __launch_bounds__(kThreads)
bitset_read_kernel(const Group* __restrict__ table, Group one, const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ gid, int n, int64_t lo, uint8_t* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const Group g = group_of(i, table, one, gid);
    const int64_t j = i - g.first < g.valid ? lane_of(idx[i], g.size, lo) : -1;
    out[i] = j >= 0 ? __ldg(g.bits + j) : 0;
  }
}

// one block a group of at most kBlockOps ops: every read, a barrier, then
// every write
__global__ void __launch_bounds__(kThreads)
bitset_set_block_kernel(const Group* __restrict__ table, Group one, const int32_t* __restrict__ idx,
                        int64_t lo, uint8_t* __restrict__ old) {
  const Group g = table == nullptr ? one : table[blockIdx.x];
  const auto value = static_cast<uint8_t>(g.value);
  int64_t lane[kBlockPer];
  uint8_t was[kBlockPer];
#pragma unroll
  for (int r = 0; r < kBlockPer; ++r) {
    const int t = threadIdx.x + kThreads * r;
    lane[r] = t < g.valid ? lane_of(idx[g.first + t], g.size, lo) : -1;
    was[r] = lane[r] >= 0 ? g.bits[lane[r]] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kBlockPer; ++r) {
    const int t = threadIdx.x + kThreads * r;
    if (t < g.count) old[g.first + t] = was[r];
    if (lane[r] >= 0 && was[r] != value) g.bits[lane[r]] = value;
  }
}

// any group size, a cooperative grid: every old bit, a grid barrier, then
// the writes
__global__ void __launch_bounds__(kThreads)
bitset_set_grid_kernel(const Group* __restrict__ table, Group one, const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ gid, int n, int64_t lo, uint8_t* old) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const Group g = group_of(i, table, one, gid);
    const int64_t j = i - g.first < g.valid ? lane_of(idx[i], g.size, lo) : -1;
    old[i] = j >= 0 ? g.bits[j] : 0;
  }
  cooperative_groups::this_grid().sync();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const Group g = group_of(i, table, one, gid);
    const int64_t j = i - g.first < g.valid ? lane_of(idx[i], g.size, lo) : -1;
    if (j >= 0 && old[i] != g.value) g.bits[j] = static_cast<uint8_t>(g.value);
  }
}

// The grid kernel's blocks on the current device, asked once per device:
// half of what one card holds resident.  Every position's lane launches on
// a stream of its own, so other streams' kernels may hold some of the SMs
// when a cooperative grid launches; a grid of the whole residency would
// wait for them to end (behind a stalled lane: for as long as it stalls),
// where half of it finds room beside them.  The grid-stride loops take any
// grid size.
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
  blocks = sms * (per_sm > 1 ? per_sm / 2 : 1);
  if (dev < kMaxDevices) known[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > 65535 ? 65535 : b);
}

cudaError_t read_launch(const Group* table, const Group& one, const int32_t* idx, const int32_t* gid, int n,
                        int64_t lo, uint8_t* out, cudaStream_t s) {
  if (n > 0) bitset_read_kernel<<<blocks_for(n), kThreads, 0, s>>>(table, one, idx, gid, n, lo, out);
  return cudaGetLastError();
}

// The set of n ops in one launch: one block a group when no group has more
// than kBlockOps ops, else the cooperative grid.
cudaError_t set_launch(const Group* table, Group one, int n_groups, int max_count, const int32_t* idx,
                       const int32_t* gid, int n, int64_t lo, uint8_t* old, cudaStream_t s) {
  if (n < 1) return cudaGetLastError();
  if (max_count <= kBlockOps) {
    bitset_set_block_kernel<<<n_groups, kThreads, 0, s>>>(table, one, idx, lo, old);
    return cudaGetLastError();
  }
  int resident = 0;
  const cudaError_t err = grid_resident(resident);
  if (err != cudaSuccess) return err;
  const int need = (n + kThreads - 1) / kThreads;
  void* args[] = {&table, &one, &idx, &gid, &n, &lo, &old};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bitset_set_grid_kernel),
                                     dim3(need < resident ? need : resident), dim3(kThreads), args, 0, s);
}

bool table_ok(int n_groups, int n) { return n_groups >= 1 && n >= 0; }

}  // namespace

// out[i] = bits[idx[i]] for i < n (every op valid); lo >= 0 is a shard's
// window (lane_of).
extern "C" int rtpu_bitset_get(const void* bits, int64_t size, const void* idx, int n, int64_t lo, void* out,
                               void* stream) {
  const Group one{static_cast<uint8_t*>(const_cast<void*>(bits)), size, 0, n, n, 0};
  return (int)read_launch(nullptr, one, static_cast<const int32_t*>(idx), nullptr, n, lo,
                          static_cast<uint8_t*>(out), static_cast<cudaStream_t>(stream));
}

// old[i] = the pre-batch bit of op i (0 for i >= n_valid), then `value` at
// the index of every op i < n_valid; one launch.  0 <= n_valid <= n (the
// wrapper clamps); lo >= 0 is a shard's window (lane_of).
extern "C" int rtpu_bitset_set(void* bits, int64_t size, const void* idx, int n, int n_valid, int value, int64_t lo,
                               void* old, void* stream) {
  const Group one{static_cast<uint8_t*>(bits), size, 0, n, n_valid, value};
  return (int)set_launch(nullptr, one, 1, n, static_cast<const int32_t*>(idx), nullptr, n, lo,
                         static_cast<uint8_t*>(old), static_cast<cudaStream_t>(stream));
}

// A table of n_groups groups (at least 1) whose ops cover [0, n) in
// order; gid[i] the group of op i.  out[i] = the bit op i reads.
extern "C" int rtpu_bitset_get_groups(const void* table, int n_groups, const void* idx, const void* gid, int n,
                                      void* out, void* stream) {
  if (!table_ok(n_groups, n)) return (int)cudaErrorInvalidValue;
  return (int)read_launch(static_cast<const Group*>(table), Group{}, static_cast<const int32_t*>(idx),
                          static_cast<const int32_t*>(gid), n, -1, static_cast<uint8_t*>(out),
                          static_cast<cudaStream_t>(stream));
}

// The same table form for sets: old[i] = op i's pre-batch bit, then each
// group's value at its ops' indexes; max_count = the largest group's ops.
extern "C" int rtpu_bitset_set_groups(const void* table, int n_groups, int max_count, const void* idx,
                                      const void* gid, int n, void* old, void* stream) {
  if (!table_ok(n_groups, n)) return (int)cudaErrorInvalidValue;
  return (int)set_launch(static_cast<const Group*>(table), Group{}, n_groups, max_count,
                         static_cast<const int32_t*>(idx), static_cast<const int32_t*>(gid), n, -1,
                         static_cast<uint8_t*>(old), static_cast<cudaStream_t>(stream));
}
