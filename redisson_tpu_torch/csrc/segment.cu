// segment_reduce: the shuffle and reduce of KernelMapReduce.
//
// Replaces the segment reduction of KernelMapReduce.pipeline
// (redisson_tpu/services/mapreduce.py:386-396): out = (n_keys,) filled with
// the reduction's identity (sum 0; max the type's least value or -inf; min
// its greatest or +inf), then out[key[i]] = op(out[key[i]], val[i]) for every
// i.  Keys follow JAX's .at[] rule: a key in [-n_keys, 0) counts from the end
// once, every other key outside [0, n_keys) is dropped.  int32 sums wrap as
// JAX's do.  A float32 sum by atomics adds in an order that changes from run
// to run, so it agrees with a sequential sum only to rounding; int32 results
// and float32 max and min are exact.
//
// Bound on an H100: bytes (each key and value read once, the result written
// once).  Many values land on few keys, and atomics on one address
// serialise in L2, so a block first reduces into a private copy of the
// result in shared memory (when n_keys * 4 bytes fit in 48 KB) and then adds
// each slot it changed to the result with one global atomic; larger key
// spaces take global atomics directly.
#include <cuda_runtime.h>

#include <cmath>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 16;
constexpr int kMaxBlocks = 132 * 4;
constexpr int64_t kSharedKeys = (48 * 1024) / 4;

enum Op { kSum = 0, kMax = 1, kMin = 2 };

template <typename V, int O> __device__ __forceinline__ V identity();
template <> __device__ __forceinline__ int32_t identity<int32_t, kSum>() { return 0; }
template <> __device__ __forceinline__ int32_t identity<int32_t, kMax>() { return INT_MIN; }
template <> __device__ __forceinline__ int32_t identity<int32_t, kMin>() { return INT_MAX; }
template <> __device__ __forceinline__ float identity<float, kSum>() { return 0.0f; }
template <> __device__ __forceinline__ float identity<float, kMax>() { return -INFINITY; }
template <> __device__ __forceinline__ float identity<float, kMin>() { return INFINITY; }

// max/min that keep a NaN, as XLA's do
template <int O> __device__ __forceinline__ float pick(float old, float v) {
  if (isnan(old)) return old;
  if (isnan(v)) return v;
  return O == kMax ? (v > old ? v : old) : (v < old ? v : old);
}

template <int O> __device__ __forceinline__ void combine(int32_t* p, int32_t v) {
  if (O == kSum) atomicAdd(p, v);
  else if (O == kMax) atomicMax(p, v);
  else atomicMin(p, v);
}

template <int O> __device__ __forceinline__ void combine(float* p, float v) {
  if (O == kSum) {
    atomicAdd(p, v);
    return;
  }
  unsigned int* a = reinterpret_cast<unsigned int*>(p);
  unsigned int old = *reinterpret_cast<volatile unsigned int*>(a);
  while (true) {
    const unsigned int want = __float_as_uint(pick<O>(__uint_as_float(old), v));
    if (want == old) return;
    const unsigned int seen = atomicCAS(a, old, want);
    if (seen == old) return;
    old = seen;
  }
}

// a slot still at the identity (same bits) adds nothing to the result
__device__ __forceinline__ bool changed(int32_t a, int32_t id) { return a != id; }
__device__ __forceinline__ bool changed(float a, float id) { return __float_as_uint(a) != __float_as_uint(id); }

template <typename V, int O>
__global__ void __launch_bounds__(kThreads) fill_kernel(V* __restrict__ out, int64_t n_keys) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n_keys;
       j += (int64_t)gridDim.x * blockDim.x) {
    out[j] = identity<V, O>();
  }
}

template <typename K, typename V, int O, bool kShared>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const K* __restrict__ keys, const V* __restrict__ vals, int64_t n, int64_t n_keys,
              V* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  V* acc = reinterpret_cast<V*>(smem);
  if (kShared) {
    for (int64_t j = threadIdx.x; j < n_keys; j += blockDim.x) acc[j] = identity<V, O>();
    __syncthreads();
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t k = keys[i];
    if (k < 0) k += n_keys;
    if (k < 0 || k >= n_keys) continue;
    combine<O>((kShared ? acc : out) + k, vals[i]);
  }
  if (kShared) {
    __syncthreads();
    const V id = identity<V, O>();
    for (int64_t j = threadIdx.x; j < n_keys; j += blockDim.x) {
      const V a = acc[j];
      if (changed(a, id)) combine<O>(out + j, a);
    }
  }
}

template <typename K, typename V, int O>
cudaError_t run(const void* keys, const void* vals, int64_t n, int64_t n_keys, void* out,
                cudaStream_t s) {
  auto o = static_cast<V*>(out);
  const int64_t fb = (n_keys + kThreads - 1) / kThreads;
  fill_kernel<V, O><<<(unsigned)(fb < kMaxBlocks ? fb : kMaxBlocks), kThreads, 0, s>>>(o, n_keys);
  if (n == 0) return cudaGetLastError();
  const int64_t want = (n + kThreads * kItemsPerThread - 1) / (kThreads * kItemsPerThread);
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  const auto k = static_cast<const K*>(keys);
  const auto v = static_cast<const V*>(vals);
  if (n_keys <= kSharedKeys) {
    reduce_kernel<K, V, O, true><<<blocks, kThreads, n_keys * sizeof(V), s>>>(k, v, n, n_keys, o);
  } else {
    reduce_kernel<K, V, O, false><<<blocks, kThreads, 0, s>>>(k, v, n, n_keys, o);
  }
  return cudaGetLastError();
}

template <typename K, typename V>
cudaError_t run_op(int op, const void* keys, const void* vals, int64_t n, int64_t n_keys,
                   void* out, cudaStream_t s) {
  if (op == kSum) return run<K, V, kSum>(keys, vals, n, n_keys, out, s);
  if (op == kMax) return run<K, V, kMax>(keys, vals, n, n_keys, out, s);
  return run<K, V, kMin>(keys, vals, n, n_keys, out, s);
}

template <typename K>
cudaError_t run_key(int op, int is_float, const void* keys, const void* vals, int64_t n,
                    int64_t n_keys, void* out, cudaStream_t s) {
  return is_float ? run_op<K, float>(op, keys, vals, n, n_keys, out, s)
                  : run_op<K, int32_t>(op, keys, vals, n, n_keys, out, s);
}

}  // namespace

// out (n_keys >= 1) = the reduction `op` (0 sum, 1 max, 2 min) of the n
// values by key.  keys: int32 (key_bytes 4) or int64 (8); values: int32
// (is_float 0) or float32 (1).  Two launches: the fill, then the reduce.
extern "C" int rtpu_segment_reduce(const void* keys, int key_bytes, const void* vals, int is_float,
                                   int op, int64_t n, int64_t n_keys, void* out, void* stream) {
  if (op < kSum || op > kMin || (key_bytes != 4 && key_bytes != 8)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = key_bytes == 4
      ? run_key<int32_t>(op, is_float, keys, vals, n, n_keys, out, s)
      : run_key<int64_t>(op, is_float, keys, vals, n, n_keys, out, s);
  return (int)err;
}
