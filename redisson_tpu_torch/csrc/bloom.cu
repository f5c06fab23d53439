// Bloom probe, set and fused add kernels for the sketch data plane.
//
// bloom_probe replaces the probe half of the jitted bloom programs in
// redisson_tpu/core/kernels.py: _bloom_bank_contains_body (:184, reached by
// bloom_bank_contains_packed[_bits] and bloom_bank_contains_u64),
// _bloom_contains_body (:129) and bloom_contains_bytes_masked (:150), and the
// "newly" read of a small add.  One thread per op: hash, read the bytes at
// tenant*width + (h1 + i*h2) % m, AND them, mask ops >= n_valid.  The result
// is a flag per op, a uint32 bitmap (warp ballot: bit i of word j is op
// 32j+i, the layout of _pack_bool_u32), or a count (one atomicAdd per block).
// Bound on an H100: random 32-byte sector reads, at about 42 G sectors/s on a
// plane larger than the 50 MB L2 (tools/bloom_diag.py).  A config-2 contains
// flush (100k ops, k = 7, a 96 MB bank) is one wave of threads whose time is
// set by how many sectors it reads, so the kernel reads fewer: the probes go
// in stages of 1, 2 and 4 (k = 7 is a template argument), each stage's loads
// in flight together, and a stage only if every probe before it was set.  An
// absent key at 50% fill stops after 2.5 reads on average instead of 7.  The
// modulo by m is Lemire's multiply-high (hash.cuh FastMod) and the tenant
// row is read once per op; neither changed the time (the reads set it).
//
// bloom_set stores 1 at the k positions of every valid op (plain byte
// stores of one constant need no atomics).  Launched after
// bloom_probe(newly) on the same stream, the pair keeps the add contract of
// kernels.py:178-181: "newly" is read from the plane as it stood before the
// batch, so two equal keys in one batch both report it.  Each 1-byte store
// dirties a 32-byte sector; on a plane larger than L2 that costs a read and
// a write-back of DRAM (16 G stores/s on a 96 MB plane, 62 G/s on an 8 MB
// one), so the pair serves only batches too small for the fused add.
//
// bloom_add is the fused add of a large batch (the add programs
// _bloom_bank_add_body :167, _bloom_add_body :118, bloom_add_bytes_masked
// :140): the probes are binned by chunk of the plane (a 64 KB tile), then
// each touched chunk is read and written once.  Five launches on one stream:
//   1. count: each block hashes its ops, computes their k flat positions
//      (hash.cuh flat_at: the int32 wrap and "outside is dropped" rules) and
//      counts them per chunk in a shared-memory histogram, then adds each
//      nonzero bin into the global counts with one atomic;
//   2. scan: one block turns the counts into chunk starts and cursors;
//   3. scatter: each block counts again, reserves one run of slots per chunk
//      it touches (one global atomic each), hashes its ops a second time
//      (re-reading an 8-byte key costs less than storing 4k bytes of
//      positions per op) and stages (offset in chunk, op id) entries in
//      shared memory in chunk order, then copies each run out with
//      consecutive stores;
//   4. apply: one block per chunk loads the tile with 16-byte loads, stores
//      1 into the op's newly byte where the pre-batch byte is 0 (idempotent
//      byte stores, no atomics), marks the entry's byte in a bitmap, then
//      writes back with 16-byte stores the vectors whose bytes changed.  A
//      chunk with no more entries than threads reads and writes its bytes in
//      place instead.  Chunks are disjoint, each is read and written by one
//      block, and every read of the pre-batch bytes precedes every write
//      (the tile is not modified; in place, a barrier), so "newly" sees the
//      plane as it stood before the batch by construction, duplicates
//      included;
//   5. finish: newly bytes to a bitmap (ballot) or a count; flags are the
//      newly bytes themselves.
// The apply's newly stores are partial writes that L2 takes at about 62 G/s
// (one per probe whose byte was 0, all of them on a zeroed plane); reading
// the flag first to skip most of them made the apply slower, a dependent
// load per entry (tools/bloom_diag.py).
// Bound on an H100: the touched sectors read once and the changed sectors
// written once, plus keys and the result.  Beyond that the pipeline moves 8
// bytes of entry twice per probe and whole tiles, so it pays off only when
// the batch touches a good share of a plane larger than L2 (the wrapper's
// size dispatch, kernels.use_fused_add).  Scratch (counts, starts, entries)
// is allocated by the wrapper: 8 bytes per probe, 587 MB for config 2's
// 10.5M-op populate window at k = 7.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

enum OutMode { OUT_FLAGS = 0, OUT_BITS = 1, OUT_COUNT = 2 };
constexpr int kThreads = 256;
constexpr int kBlock = 1024;  // threads of the fused add's passes 1-4
// Shared memory the scatter pass stages a block's entries in (8 bytes per
// chunk beside 10 bytes per probe): 2048 ops at k = 7, one block per SM.
constexpr int kStageBytes = 160 * 1024;

// The op's result: a flag byte, a bitmap word per warp, or a block count
// added into one int.  Every thread of the block must call it.
__device__ __forceinline__ void write_result(bool flag, int i, int n, int out_mode,
                                             void* __restrict__ out) {
  if (out_mode == OUT_FLAGS) {
    if (i < n) static_cast<uint8_t*>(out)[i] = flag;
  } else if (out_mode == OUT_BITS) {
    const unsigned word = __ballot_sync(0xffffffffu, flag);
    if ((threadIdx.x & 31) == 0 && i < n) static_cast<uint32_t*>(out)[i >> 5] = word;
  } else {
    const int c = __syncthreads_count(flag);
    if (threadIdx.x == 0 && c) atomicAdd(static_cast<int*>(out), c);
  }
}

// True when probes [Lo, K) are all set, taken in doubling stages: Len
// probes from Lo, whose loads are all issued before any is tested, then the
// next stage of 2 * Len only if every one of them was set.
template <int K, int Lo, int Len, typename F>
__device__ __forceinline__ bool stages_set(F&& probe) {
  if constexpr (Lo >= K) {
    return true;
  } else {
    constexpr int Hi = Lo + Len < K ? Lo + Len : K;
    uint8_t v[Hi - Lo];
#pragma unroll
    for (int j = 0; j < Hi - Lo; ++j) v[j] = probe(Lo + j);
    bool all = true;
#pragma unroll
    for (int j = 0; j < Hi - Lo; ++j) all &= v[j] != 0;
    return all && stages_set<K, Hi, 2 * Len>(probe);
  }
}

// K > 0: the probes go in stages of 1, 2, 4, ... (stages_set).  K == 0 (any
// other k): one probe at a time, stopping at the first 0.
template <int K>
__global__ void __launch_bounds__(kThreads)
bloom_probe_kernel(const uint8_t* __restrict__ plane, int64_t size, uint32_t width,
                   rtpu::KeyBatch kb, int n_valid, int k, rtpu::FastMod mod, int newly,
                   int out_mode, void* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool flag = false;
  if (i < n_valid) {
    uint32_t h1, h2;
    rtpu::hash_key(kb, i, h1, h2);
    const bool bank = kb.tenant != nullptr;
    const uint32_t row = rtpu::row_base(kb, i, width);
    auto probe = [&](int j) -> uint8_t {
      const int64_t g = rtpu::flat_at(bank, row, mod(h1 + (uint32_t)j * h2), size);
      return g >= 0 ? __ldg(plane + g) : (uint8_t)1;  // outside reads as 1
    };
    bool found = true;
    if constexpr (K > 0) {
      found = stages_set<K, 0, 1>(probe);
    } else {
      for (int j = 0; j < k && found; ++j) found = probe(j) != 0;
    }
    flag = newly ? !found : found;
  }
  write_result(flag, i, kb.n, out_mode, out);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
bloom_set_kernel(uint8_t* __restrict__ plane, int64_t size, uint32_t width,
                 rtpu::KeyBatch kb, int n_valid, int k, rtpu::FastMod mod) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_valid) return;
  uint32_t h1, h2;
  rtpu::hash_key(kb, i, h1, h2);
  const bool bank = kb.tenant != nullptr;
  const uint32_t row = rtpu::row_base(kb, i, width);
  const int kk = K > 0 ? K : k;
#pragma unroll
  for (int j = 0; j < kk; ++j) {
    const int64_t g = rtpu::flat_at(bank, row, mod(h1 + (uint32_t)j * h2), size);
    if (g >= 0) plane[g] = 1;  // outside is dropped
  }
}

// The in-plane probes of ops [begin, end), the ops strided over the block:
// fn(op, chunk, offset in chunk) for each.
template <int K, typename F>
__device__ __forceinline__ void block_probes(int64_t size, uint32_t width,
                                             const rtpu::KeyBatch& kb, int begin, int end,
                                             int k, const rtpu::FastMod& mod, int chunk_log2,
                                             F&& fn) {
  const bool bank = kb.tenant != nullptr;
  const uint32_t in_chunk = (1u << chunk_log2) - 1u;
  const int kk = K > 0 ? K : k;
  for (int i = begin + threadIdx.x; i < end; i += kBlock) {
    uint32_t h1, h2;
    rtpu::hash_key(kb, i, h1, h2);
    const uint32_t row = rtpu::row_base(kb, i, width);
#pragma unroll
    for (int j = 0; j < kk; ++j) {
      const int64_t g = rtpu::flat_at(bank, row, mod(h1 + (uint32_t)j * h2), size);
      if (g >= 0) fn(i, (uint32_t)(g >> chunk_log2), (uint32_t)g & in_chunk);
    }
  }
}

// a[i] = in[0] + ... + in[i-1] for i < n into out (which may be in), by all
// kBlock threads of a block; returns the total.  Thread t owns a run of
// ceil(n / kBlock) consecutive elements.
__device__ uint32_t block_exclusive_scan(const uint32_t* in, uint32_t* out, int n) {
  __shared__ uint32_t warp_sums[kBlock / 32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int per = (n + kBlock - 1) / kBlock;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  uint32_t sum = 0;
  for (int c = lo; c < hi; ++c) sum += in[c];
  uint32_t x = sum;  // inclusive scan across the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    uint32_t v = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  uint32_t run = x - sum + (w ? warp_sums[w - 1] : 0u);
  const uint32_t total = warp_sums[kBlock / 32 - 1];
  for (int c = lo; c < hi; ++c) {
    const uint32_t v = in[c];
    out[c] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// Pass 1: each block counts its ops' probes per chunk in a shared-memory
// histogram (nc bins), then adds each nonzero bin into counts with one global
// atomic: one global atomic per chunk a block touched, not one per probe, so
// a plane of few chunks does not serialise on a few counters.
template <int K>
__global__ void __launch_bounds__(kBlock)
bloom_count_kernel(int64_t size, uint32_t width, rtpu::KeyBatch kb, int n_valid, int k,
                   rtpu::FastMod mod, int chunk_log2, int nc, int ops_per_block,
                   uint32_t* __restrict__ counts) {
  extern __shared__ uint32_t hist[];
  for (int c = threadIdx.x; c < nc; c += kBlock) hist[c] = 0;
  __syncthreads();
  const int begin = blockIdx.x * ops_per_block;
  const int end = min(n_valid, begin + ops_per_block);
  block_probes<K>(size, width, kb, begin, end, k, mod, chunk_log2,
                  [&](int, uint32_t chunk, uint32_t) { atomicAdd(&hist[chunk], 1u); });
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += kBlock) {
    if (hist[c]) atomicAdd(&counts[c], hist[c]);
  }
}

// Pass 2: start[c] = counts[0] + ... + counts[c-1] (start[nc] = the total),
// and each chunk's cursor, which takes the place of its count, set to its
// start.  One block.
__global__ void __launch_bounds__(kBlock)
bloom_scan_kernel(uint32_t* counts, int nc, uint32_t* __restrict__ start) {
  const uint32_t total = block_exclusive_scan(counts, start, nc);
  for (int c = threadIdx.x; c < nc; c += kBlock) counts[c] = start[c];
  if (threadIdx.x == 0) start[nc] = total;
}

// Bytes of shared memory of a scatter block: run and delta (nc each, padded
// to 16 bytes), then the staged entries and their chunks.
int scatter_smem(int nc, int probes) {
  return 8 * ((nc + 3) & ~3) + 10 * probes;
}

// Pass 3: the block counts its probes per chunk again, reserves one run of
// each chunk's entries with one global atomic per nonzero bin, then hashes
// its ops a second time and places each probe's (offset in chunk, op id) in
// shared memory in chunk order.  Last it copies the staged entries out, each
// chunk's run to its reserved slots: consecutive threads store consecutive
// slots, so a warp's stores fill a few whole sectors instead of 32 partial
// ones (random 8-byte stores run at the rate of L2's partial writes).
template <int K>
__global__ void __launch_bounds__(kBlock)
bloom_scatter_kernel(int64_t size, uint32_t width, rtpu::KeyBatch kb, int n_valid, int k,
                     rtpu::FastMod mod, int chunk_log2, int nc, int ops_per_block,
                     uint32_t* __restrict__ cursor, uint2* __restrict__ entries) {
  extern __shared__ uint4 stage[];
  const int nc_pad = (nc + 3) & ~3;
  uint32_t* run = reinterpret_cast<uint32_t*>(stage);  // counts, local starts, cursors
  uint32_t* delta = run + nc_pad;                      // entry slot minus staged index
  uint2* staged = reinterpret_cast<uint2*>(delta + nc_pad);
  uint16_t* chunk_of = reinterpret_cast<uint16_t*>(staged + ops_per_block * (K > 0 ? K : k));
  for (int c = threadIdx.x; c < nc; c += kBlock) run[c] = 0;
  __syncthreads();
  const int begin = blockIdx.x * ops_per_block;
  const int end = min(n_valid, begin + ops_per_block);
  block_probes<K>(size, width, kb, begin, end, k, mod, chunk_log2,
                  [&](int, uint32_t chunk, uint32_t) { atomicAdd(&run[chunk], 1u); });
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += kBlock) {
    const uint32_t count = run[c];
    delta[c] = count ? atomicAdd(&cursor[c], count) : 0u;
  }
  const uint32_t total = block_exclusive_scan(run, run, nc);
  for (int c = threadIdx.x; c < nc; c += kBlock) delta[c] -= run[c];
  __syncthreads();
  block_probes<K>(size, width, kb, begin, end, k, mod, chunk_log2,
                  [&](int i, uint32_t chunk, uint32_t off) {
                    const uint32_t at = atomicAdd(&run[chunk], 1u);
                    staged[at] = make_uint2(off, (uint32_t)i);
                    chunk_of[at] = (uint16_t)chunk;
                  });
  __syncthreads();
  for (uint32_t at = threadIdx.x; at < total; at += kBlock) {
    entries[at + delta[chunk_of[at]]] = staged[at];
  }
}

// The 4 bytes of `old` whose bits are set in the low 4 bits of `marks`
// become 1; the others keep their value.
__device__ __forceinline__ uint32_t merge4(uint32_t old, uint32_t marks) {
  const uint32_t ones = ((marks & 0xFu) * 0x00204081u) & 0x01010101u;
  return (old & ~(ones * 0xFFu)) | ones;
}

// Pass 4: one block per chunk, with 2**chunk_log2 + 2**chunk_log2 / 8 bytes
// of dynamic shared memory (the pre-batch tile and a bit per byte marking
// the bytes the batch sets).  kSparse: a chunk of at most kBlock entries
// takes the in-place route (tools/bloom_diag.py times the kernel without it).
template <bool kSparse>
__global__ void __launch_bounds__(kBlock)
bloom_apply_kernel(uint8_t* __restrict__ plane, int64_t size, int chunk_log2,
                   const uint32_t* __restrict__ start, const uint2* __restrict__ entries,
                   uint8_t* __restrict__ newly) {
  extern __shared__ uint4 smem[];
  const int c = blockIdx.x;
  const uint32_t e0 = start[c], ne = start[c + 1] - e0;
  const int64_t base = (int64_t)c << chunk_log2;
  if (kSparse && ne <= kBlock) {
    // A sparse chunk (no more probes than threads: at most one per 64 bytes
    // of a 64 KB tile): reading and writing its probed bytes in place moves
    // less than the tile.  Every pre-batch read precedes every write (the
    // barrier).
    uint2 en = make_uint2(0u, 0u);
    bool set = false;
    if (threadIdx.x < ne) {
      en = entries[e0 + threadIdx.x];
      const uint8_t was = plane[base + en.x];
      if (was == 0) newly[en.y] = 1;
      set = was != 1;
    }
    __syncthreads();
    if (set) plane[base + en.x] = 1;
    return;
  }
  const uint32_t e1 = e0 + ne;
  uint4* tile4 = smem;
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem);
  uint32_t* mark = reinterpret_cast<uint32_t*>(tile + (1 << chunk_log2));
  const int64_t rest = size - base;
  const int len = rest < (1 << chunk_log2) ? (int)rest : 1 << chunk_log2;
  const int nvec = len >> 4;
  const uint4* src = reinterpret_cast<const uint4*>(plane + base);
#pragma unroll 4
  for (int v = threadIdx.x; v < nvec; v += kBlock) tile4[v] = src[v];
  for (int b = (nvec << 4) + threadIdx.x; b < len; b += kBlock) tile[b] = plane[base + b];
  for (int w = threadIdx.x; w < (1 << (chunk_log2 - 5)); w += kBlock) mark[w] = 0u;
  __syncthreads();
#pragma unroll 4
  for (uint32_t e = e0 + threadIdx.x; e < e1; e += kBlock) {
    const uint2 en = entries[e];
    if (tile[en.x] == 0) newly[en.y] = 1;
    atomicOr(&mark[en.x >> 5], 1u << (en.x & 31u));
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(plane + base);
  for (int v = threadIdx.x; v < nvec; v += kBlock) {
    const uint32_t bits = (mark[v >> 1] >> ((v & 1) * 16)) & 0xFFFFu;
    if (bits == 0u) continue;
    const uint4 o = tile4[v];
    const uint4 r = make_uint4(merge4(o.x, bits), merge4(o.y, bits >> 4), merge4(o.z, bits >> 8),
                               merge4(o.w, bits >> 12));
    if (r.x != o.x || r.y != o.y || r.z != o.z || r.w != o.w) dst[v] = r;
  }
  for (int b = (nvec << 4) + threadIdx.x; b < len; b += kBlock) {
    if (((mark[b >> 5] >> (b & 31)) & 1u) && tile[b] != 1) plane[base + b] = 1;
  }
}

// Dynamic shared memory of an apply block: the tile and its marks.
int apply_smem(int chunk_log2) { return (1 << chunk_log2) + (1 << (chunk_log2 - 3)); }

// Pass 5: newly bytes (0 for ops >= n_valid) to a bitmap or a count.
__global__ void __launch_bounds__(kThreads)
bloom_finish_kernel(const uint8_t* __restrict__ newly, int n, int out_mode,
                    void* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  write_result(i < n && newly[i] != 0, i, n, out_mode, out);
}

int blocks_for(int n) { return n > 0 ? (n + kThreads - 1) / kThreads : 1; }

// The main path's k gets the unrolled kernel; any other k the generic loop.
constexpr int kPathK = 7;

// Ops per block of passes 1 and 3: two per thread at most, and no more than
// the scatter pass can stage (kStageBytes); 0 when not even one fits
// (kernels.add_ops_per_block computes the same and refuses such a k first).
int ops_per_block(int nc, int k) {
  const int fit = (kStageBytes - scatter_smem(nc, 0)) / (10 * k);
  return fit < 2 * kBlock ? (fit > 0 ? fit : 0) : 2 * kBlock;
}

template <int K>
cudaError_t launch_binning(int64_t size, uint32_t width, const rtpu::KeyBatch& kb,
                           int n_valid, int k, const rtpu::FastMod& mod, int chunk_log2,
                           int nc, uint32_t* counts, uint32_t* start, uint2* entries,
                           cudaStream_t s) {
  const int per = ops_per_block(nc, k);
  if (per == 0) return cudaErrorInvalidValue;
  const int blocks = (n_valid + per - 1) / per;
  const int stage_bytes = scatter_smem(nc, per * k);
  cudaError_t err = cudaFuncSetAttribute(bloom_scatter_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, stage_bytes);
  if (err != cudaSuccess) return err;
  bloom_count_kernel<K><<<blocks, kBlock, nc * (int)sizeof(uint32_t), s>>>(
      size, width, kb, n_valid, k, mod, chunk_log2, nc, per, counts);
  bloom_scan_kernel<<<1, kBlock, 0, s>>>(counts, nc, start);
  bloom_scatter_kernel<K><<<blocks, kBlock, stage_bytes, s>>>(size, width, kb, n_valid, k, mod,
                                                             chunk_log2, nc, per, counts, entries);
  return cudaSuccess;
}

}  // namespace

// Each entry point launches on `stream` and returns the first CUDA error
// (cudaGetLastError() after its launches); the Python wrapper raises when it
// is not 0.  `magic` is fastmod_magic(m) from core/kernels.py.
extern "C" int rtpu_bloom_probe(const void* plane, int64_t size, int64_t width,
                                const void* tenant, const void* lo, const void* hi,
                                const void* words, const void* nbytes, int n_words,
                                int n, int n_valid, int k, int64_t m, uint64_t magic,
                                int newly, int out_mode, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto kb = rtpu::key_batch(tenant, lo, hi, words, nbytes, n_words, n);
  const rtpu::FastMod mod{magic, (uint32_t)m};
  const auto p = static_cast<const uint8_t*>(plane);
  if (k == kPathK) {
    bloom_probe_kernel<kPathK><<<blocks_for(n), kThreads, 0, s>>>(
        p, size, (uint32_t)width, kb, n_valid, k, mod, newly, out_mode, out);
  } else {
    bloom_probe_kernel<0><<<blocks_for(n), kThreads, 0, s>>>(
        p, size, (uint32_t)width, kb, n_valid, k, mod, newly, out_mode, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int rtpu_bloom_set(void* plane, int64_t size, int64_t width, const void* tenant,
                              const void* lo, const void* hi, const void* words,
                              const void* nbytes, int n_words, int n, int n_valid, int k,
                              int64_t m, uint64_t magic, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto kb = rtpu::key_batch(tenant, lo, hi, words, nbytes, n_words, n);
  const rtpu::FastMod mod{magic, (uint32_t)m};
  const auto p = static_cast<uint8_t*>(plane);
  if (k == kPathK) {
    bloom_set_kernel<kPathK><<<blocks_for(n), kThreads, 0, s>>>(p, size, (uint32_t)width,
                                                                kb, n_valid, k, mod);
  } else {
    bloom_set_kernel<0><<<blocks_for(n), kThreads, 0, s>>>(p, size, (uint32_t)width, kb,
                                                           n_valid, k, mod);
  }
  return (int)cudaGetLastError();
}

// scratch: 2 * nc + 1 uint32 (counts, later cursors; then starts), with
// nc = ceil(size / 2**chunk_log2) small enough for ops_per_block (at most
// 8192 chunks at k = 7); entries: k * n_valid uint2; newly: n bytes (the
// result itself for OUT_FLAGS); out: zeroed by the caller for OUT_COUNT.
// The plane must be 16-byte aligned.
extern "C" int rtpu_bloom_add(void* plane, int64_t size, int64_t width, const void* tenant,
                              const void* lo, const void* hi, const void* words,
                              const void* nbytes, int n_words, int n, int n_valid, int k,
                              int64_t m, uint64_t magic, int chunk_log2, int out_mode,
                              void* out, void* newly, void* scratch, void* entries,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto kb = rtpu::key_batch(tenant, lo, hi, words, nbytes, n_words, n);
  const rtpu::FastMod mod{magic, (uint32_t)m};
  const int nc = (int)((size + (1LL << chunk_log2) - 1) >> chunk_log2);
  auto* counts = static_cast<uint32_t*>(scratch);
  auto* start = counts + nc;
  auto* nw = static_cast<uint8_t*>(newly);
  cudaError_t err = cudaMemsetAsync(nw, 0, (size_t)n, s);
  if (err == cudaSuccess && n_valid > 0) {
    err = cudaMemsetAsync(counts, 0, sizeof(uint32_t) * (size_t)nc, s);
    if (err == cudaSuccess) {
      err = k == kPathK
                ? launch_binning<kPathK>(size, (uint32_t)width, kb, n_valid, k, mod, chunk_log2,
                                         nc, counts, start, static_cast<uint2*>(entries), s)
                : launch_binning<0>(size, (uint32_t)width, kb, n_valid, k, mod, chunk_log2, nc,
                                    counts, start, static_cast<uint2*>(entries), s);
    }
    const int smem = apply_smem(chunk_log2);
    if (err == cudaSuccess && smem > 48 * 1024) {
      err = cudaFuncSetAttribute(bloom_apply_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    // the apply reads the starts and entries the binning wrote: after a
    // failed step they are not there, and it must not run
    if (err == cudaSuccess) {
      bloom_apply_kernel<true><<<nc, kBlock, smem, s>>>(static_cast<uint8_t*>(plane), size,
                                                        chunk_log2, start,
                                                        static_cast<const uint2*>(entries), nw);
    }
  }
  if (err == cudaSuccess && out_mode != OUT_FLAGS) {
    bloom_finish_kernel<<<blocks_for(n), kThreads, 0, s>>>(nw, n, out_mode, out);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

extern "C" const char* rtpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
