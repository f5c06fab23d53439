// Design variants of the sketch kernels for redisson_tpu_torch/tools/
// bloom_diag.py, which times them on the card (the profilers do not run on
// the machine with the card).  Not used by the package.  It includes
// csrc/bloom.cu and csrc/hll.cu, so the passes and kernels it launches are
// the package's own:
//   diag_add_passes       the fused bloom add with an event between passes;
//   diag_rmw              random register ops at given positions: the floor
//                         of a scatter-max (loads, stores, CAS from a guess
//                         of four empty registers, load + CAS);
//   diag_read             a streaming read of a bank: the card's floor for
//                         the estimate's bytes.
#include "../csrc/bloom.cu"
#include "../csrc/hll.cu"

// rtpu_bloom_add for k = 7 and u64 keys, with the device ms of each pass
// (count with the memsets, scan, scatter, apply, finish) written to ms[5].
// `ops` ops per block of the binning passes (0: csrc/bloom.cu's
// ops_per_block); `sparse` 0 runs the apply without its in-place route for
// chunks of at most kBlock entries.  Synchronises the stream.
extern "C" int diag_add_passes(void* plane, int64_t size, int64_t width, const void* tenant,
                               const void* lo, const void* hi, int n, int n_valid, int64_t m,
                               uint64_t magic, int chunk_log2, int ops, int sparse, int out_mode,
                               void* out, void* newly, void* scratch, void* entries,
                               float* ms, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const rtpu::KeyBatch kb{static_cast<const uint32_t*>(tenant),
                          static_cast<const uint32_t*>(lo),
                          static_cast<const uint32_t*>(hi), nullptr, nullptr, 0, n};
  const rtpu::FastMod mod{magic, (uint32_t)m};
  const int nc = (int)((size + (1LL << chunk_log2) - 1) >> chunk_log2);
  auto* counts = static_cast<uint32_t*>(scratch);
  auto* start = counts + nc;
  auto* ent = static_cast<uint2*>(entries);
  auto* nw = static_cast<uint8_t*>(newly);
  const uint32_t w = (uint32_t)width;
  const int per = ops > 0 ? ops : ops_per_block(nc, 7);
  if (per == 0 || n_valid <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n_valid + per - 1) / per;
  const int stage_bytes = scatter_smem(nc, per * 7);
  const int smem = apply_smem(chunk_log2);
  cudaError_t err = cudaFuncSetAttribute(bloom_scatter_kernel<7>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, stage_bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bloom_apply_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bloom_apply_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err != cudaSuccess) return (int)err;
  cudaEvent_t ev[6];
  for (auto& e : ev) cudaEventCreate(&e);
  cudaEventRecord(ev[0], s);
  cudaMemsetAsync(nw, 0, (size_t)n, s);
  cudaMemsetAsync(counts, 0, sizeof(uint32_t) * (size_t)nc, s);
  bloom_count_kernel<7><<<blocks, kBlock, nc * (int)sizeof(uint32_t), s>>>(size, w, kb, n_valid, 7,
                                                                            mod, chunk_log2, nc, per,
                                                                            counts);
  cudaEventRecord(ev[1], s);
  bloom_scan_kernel<<<1, kBlock, 0, s>>>(counts, nc, start);
  cudaEventRecord(ev[2], s);
  bloom_scatter_kernel<7><<<blocks, kBlock, stage_bytes, s>>>(size, w, kb, n_valid, 7, mod, chunk_log2,
                                                              nc, per, counts, ent);
  cudaEventRecord(ev[3], s);
  auto* p = static_cast<uint8_t*>(plane);
  if (sparse) {
    bloom_apply_kernel<true><<<nc, kBlock, smem, s>>>(p, size, chunk_log2, start, ent, nw);
  } else {
    bloom_apply_kernel<false><<<nc, kBlock, smem, s>>>(p, size, chunk_log2, start, ent, nw);
  }
  cudaEventRecord(ev[4], s);
  if (out_mode != OUT_FLAGS) bloom_finish_kernel<<<blocks_for(n), kThreads, 0, s>>>(nw, n, out_mode, out);
  cudaEventRecord(ev[5], s);
  err = cudaEventSynchronize(ev[5]);
  for (int i = 0; i < 5; ++i) cudaEventElapsedTime(ms + i, ev[i], ev[i + 1]);
  for (auto& e : ev) cudaEventDestroy(e);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

namespace {

// mode 0 loads each op's byte, 1 stores its rank, 2 takes the max by CAS
// from a guess of four empty registers, 3 loads the word then CASes.
__global__ void __launch_bounds__(256)
diag_rmw_kernel(uint8_t* __restrict__ regs, const uint32_t* __restrict__ pos,
                const uint8_t* __restrict__ rank, int n, int mode, unsigned* sink) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t g = pos[i], rho = rank[i];
  if (mode == 0) {
    if (regs[g] == 0xFFu) atomicAdd(sink, 1u);  // keeps the load; no rank is 255
    return;
  }
  if (mode == 1) {
    regs[g] = (uint8_t)rho;
    return;
  }
  unsigned* word = reinterpret_cast<unsigned*>(regs + (g & ~3u));
  const int shift = (int)(g & 3u) * 8;
  unsigned old = mode == 3 ? *word : 0u;
  while (((old >> shift) & 0xFFu) < rho) {
    const unsigned seen = atomicCAS(word, old, (old & ~(0xFFu << shift)) | (rho << shift));
    if (seen == old) break;
    old = seen;
  }
}

// Reads `bytes` (a multiple of 16) with 16-byte loads, four in flight per
// thread, and xors them; the floor of a streaming read on this card.
__global__ void __launch_bounds__(256)
diag_read_kernel(const uint4* __restrict__ p, int64_t n, unsigned* sink) {
  uint32_t acc = 0u;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = i + u * stride < n ? __ldg(p + i + u * stride) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  if (acc == 0x9E3779B9u) atomicAdd(sink, 1u);  // keeps the loads
}

}  // namespace

extern "C" int diag_rmw(void* regs, const void* pos, const void* rank, int n, int mode,
                        void* sink, void* stream) {
  diag_rmw_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(regs), static_cast<const uint32_t*>(pos),
      static_cast<const uint8_t*>(rank), n, mode, static_cast<unsigned*>(sink));
  return (int)cudaGetLastError();
}

extern "C" int diag_read(const void* p, int64_t bytes, void* sink, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  diag_read_kernel<<<sms * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), bytes / 16, static_cast<unsigned*>(sink));
  return (int)cudaGetLastError();
}
