// The fused add of csrc/bloom.cu with an event between its passes, for
// redisson_tpu_torch/tools/bloom_diag.py, which times them on the card (the
// profilers do not run on the machine with the card).  Not used by the
// package.  It includes csrc/bloom.cu, so the passes are the package's own
// kernels.
#include "../csrc/bloom.cu"

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
