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
// and float32 max and min are exact, and a NaN in a float32 max or min wins
// its slot, as XLA's max and min keep it.
//
// Bound on an H100: bytes (each key and value read once, the result written
// once).  Many values land on few keys, and atomics on one address
// serialise in L2, so each block reduces into a private copy of the result
// in shared memory.  While n_keys slots fit a block's shared memory (227
// KB: 58,108 four-byte slots on an H100, rtpu_segment_shared_keys) it is
// one launch, reduce_shared_kernel: a persistent grid of thread-block
// clusters (kCluster blocks, as many clusters as the card keeps resident);
// each thread loads kGroups groups of four keys and four values with
// 16-byte loads (64 bytes or more) before its first shared atomic; then each
// cluster merges its blocks' copies over distributed shared memory (a slice
// of the keys a block), the cluster that draws ticket 0 stores its merged
// copy into out and publishes the call's tag, and every other cluster,
// once it sees the tag, adds its merged copy into out with one global
// atomic a changed slot (a cluster's copy is one of ~30 on an H100: a
// handful of atomics a slot).  No fill.  Larger key spaces take two launches:
// a fill of out, then global atomics straight into it.  float32 max and min
// are integer atomics on the value's bits (max or min as signed integers
// for a value with its sign bit clear, min or max as unsigned for one with
// it set; a NaN becomes 0x7FFFFFFF for max and 0xFFFFFFFF for min, which
// every later value leaves in place), so no CAS loop.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kGroups = 2;   // groups of four values a thread loads before its first atomic
constexpr int kCluster = 4;  // blocks whose shared copies merge over distributed shared memory
constexpr int kStaticSmem = 16;  // the shared kernel's static shared memory (ticket_s), at most
constexpr int kMaxDevices = 64;

enum Op { kSum = 0, kMax = 1, kMin = 2 };

template <typename V, int O> __device__ __forceinline__ V identity();
template <> __device__ __forceinline__ int32_t identity<int32_t, kSum>() { return 0; }
template <> __device__ __forceinline__ int32_t identity<int32_t, kMax>() { return INT_MIN; }
template <> __device__ __forceinline__ int32_t identity<int32_t, kMin>() { return INT_MAX; }
template <> __device__ __forceinline__ float identity<float, kSum>() { return 0.0f; }
template <> __device__ __forceinline__ float identity<float, kMax>() { return -INFINITY; }
template <> __device__ __forceinline__ float identity<float, kMin>() { return INFINITY; }

// float32 order as a signed integer: -0 below +0, a NaN with its sign bit
// clear above +inf (the atomics below follow the same order)
__device__ __forceinline__ int32_t ordered(float x) {
  const int32_t i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

// one value into a slot (shared or device memory)
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
  int32_t* si = reinterpret_cast<int32_t*>(p);
  unsigned int* su = reinterpret_cast<unsigned int*>(p);
  if (isnan(v)) {
    if (O == kMax) atomicMax(si, INT_MAX);
    else atomicMax(su, 0xFFFFFFFFu);
  } else if (!signbit(v)) {
    if (O == kMax) atomicMax(si, __float_as_int(v));
    else atomicMin(si, __float_as_int(v));
  } else {
    if (O == kMax) atomicMin(su, __float_as_uint(v));
    else atomicMax(su, __float_as_uint(v));
  }
}

// two slots' values, in the atomics' order
template <int O> __device__ __forceinline__ int32_t merge(int32_t a, int32_t b) {
  if (O == kSum) return (int32_t)((uint32_t)a + (uint32_t)b);
  return O == kMax ? (a > b ? a : b) : (a < b ? a : b);
}

template <int O> __device__ __forceinline__ float merge(float a, float b) {
  if (O == kSum) return a + b;
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return (O == kMax) == (ordered(b) > ordered(a)) ? b : a;
}

template <typename V> __device__ __forceinline__ V from_bits(uint32_t u);
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(uint32_t u) { return (int32_t)u; }
template <> __device__ __forceinline__ float from_bits<float>(uint32_t u) { return __uint_as_float(u); }

// keys g*4 .. g*4+3 of a 16-byte aligned array
__device__ __forceinline__ void load_keys(const int32_t* keys, int64_t g, int32_t (&k)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(keys) + g);
  k[0] = v.x, k[1] = v.y, k[2] = v.z, k[3] = v.w;
}
__device__ __forceinline__ void load_keys(const int64_t* keys, int64_t g, int64_t (&k)[4]) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(keys) + 2 * g);
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(keys) + 2 * g + 1);
  k[0] = a.x, k[1] = a.y, k[2] = b.x, k[3] = b.y;
}

template <typename V, int O>
__device__ __forceinline__ void take(V* acc, int64_t n_keys, int64_t k, V v) {
  if (k < 0) k += n_keys;
  if (k >= 0 && k < n_keys) combine<O>(acc + k, v);
}

// Every value of this block's share into acc: groups of four from `head`
// on (keys + head and vals + head 16-byte aligned), an equal contiguous
// share of them a block, kGroups a thread in flight before the first
// atomic; the elements before head and after the last group one a thread,
// grid-stride.
template <typename K, typename V, int O>
__device__ __forceinline__ void reduce_into(V* acc, const K* __restrict__ keys, const V* __restrict__ vals,
                                            int64_t n, int64_t head, int64_t groups, int64_t n_keys) {
  const K* gk = keys + head;
  const uint4* gv = reinterpret_cast<const uint4*>(vals + head);
  const int64_t share = (groups + gridDim.x - 1) / gridDim.x;
  const int64_t g_begin = (int64_t)blockIdx.x * share < groups ? (int64_t)blockIdx.x * share : groups;
  const int64_t g_end = g_begin + share < groups ? g_begin + share : groups;
  for (int64_t g0 = g_begin + threadIdx.x; g0 < g_end; g0 += (int64_t)kThreads * kGroups) {
    K k[kGroups][4];
    uint4 v[kGroups];
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      if (g0 + (int64_t)q * kThreads < g_end) {
        load_keys(gk, g0 + (int64_t)q * kThreads, k[q]);
        v[q] = __ldg(gv + g0 + (int64_t)q * kThreads);
      }
    }
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      if (g0 + (int64_t)q * kThreads >= g_end) break;
      take<V, O>(acc, n_keys, k[q][0], from_bits<V>(v[q].x));
      take<V, O>(acc, n_keys, k[q][1], from_bits<V>(v[q].y));
      take<V, O>(acc, n_keys, k[q][2], from_bits<V>(v[q].z));
      take<V, O>(acc, n_keys, k[q][3], from_bits<V>(v[q].w));
    }
  }
  const int64_t tail = head + 4 * groups, loose = head + (n - tail);
  for (int64_t x = (int64_t)blockIdx.x * kThreads + threadIdx.x; x < loose; x += (int64_t)gridDim.x * kThreads) {
    const int64_t i = x < head ? x : tail + (x - head);
    take<V, O>(acc, n_keys, (int64_t)keys[i], vals[i]);
  }
}

// a slot still at the identity (same bits) adds nothing to the result
__device__ __forceinline__ bool changed(int32_t a, int32_t id) { return a != id; }
__device__ __forceinline__ bool changed(float a, float id) { return __float_as_uint(a) != __float_as_uint(id); }

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The shared path: one launch of clusters of kCluster blocks (gridDim.x a
// multiple of it).  state[0]: the clusters' ticket, 0 before the launch and
// after it; state[1]: the tag of the last call whose first cluster wrote
// out.  tag: in [1, 2**31), a new one each call since state was zeroed.
// Each cluster merges its blocks' copies over distributed shared memory (a
// slice of the keys a block, into that block's own copy); the cluster that
// drew ticket 0 stores its merged copy into out and then publishes the
// tag; every other cluster waits for the tag (the first cluster is
// resident: it drew its ticket), then adds its merged copy into out with
// global atomics, one a slot it changed.
template <typename K, typename V, int O>
__global__ void __launch_bounds__(kThreads, 2)
reduce_shared_kernel(const K* __restrict__ keys, const V* __restrict__ vals, int64_t n, int64_t head,
                     int64_t groups, int n_keys, unsigned* __restrict__ state, unsigned tag, V* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned ticket_s;
  V* acc = reinterpret_cast<V*>(smem);
  const V id = identity<V, O>();
  for (int j = threadIdx.x; j < n_keys; j += kThreads) acc[j] = id;
  __syncthreads();
  reduce_into<K, V, O>(acc, keys, vals, n, head, groups, n_keys);

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), size = cluster.num_blocks();
  if (rank == 0 && threadIdx.x == 0) {
    const unsigned t = atomicAdd(&state[0], 1u);
    if (t == gridDim.x / size - 1) state[0] = 0;  // every cluster has drawn its ticket
    ticket_s = t;
  }
  cluster.sync();  // every copy of the cluster complete, its ticket drawn
  const bool first = *cluster.map_shared_rank(&ticket_s, 0) == 0;
  const int slice = (n_keys + (int)size - 1) / (int)size;
  const int j0 = (int)rank * slice, j1 = j0 + slice < n_keys ? j0 + slice : n_keys;
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
    V x[kCluster];  // every copy's slot in flight at once
#pragma unroll
    for (int q = 0; q < kCluster; ++q) x[q] = q < (int)size ? cluster.map_shared_rank(acc, q)[j] : id;
    V a = id;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) a = merge<O>(a, x[q]);
    acc[j] = a;  // this block's slice: no other block reads it
  }
  if (!first) {
    if (threadIdx.x == 0) {
      while (load_acquire(&state[1]) != tag) {
      }
    }
    __syncthreads();
    for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
      const V a = acc[j];
      if (changed(a, id)) combine<O>(out + j, a);
    }
  } else {
    for (int j = j0 + threadIdx.x; j < j1; j += kThreads) out[j] = acc[j];
    __threadfence();
  }
  cluster.sync();  // no block reads another's copy past here
  if (first && rank == 0 && threadIdx.x == 0) {
    __threadfence();
    store_release(&state[1], tag);
  }
}

template <typename V, int O>
__global__ void __launch_bounds__(kThreads) fill_kernel(V* __restrict__ out, int64_t n_keys) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n_keys;
       j += (int64_t)gridDim.x * blockDim.x) {
    out[j] = identity<V, O>();
  }
}

// Past the shared limit: global atomics into out, which fill_kernel set.
template <typename K, typename V, int O>
__global__ void __launch_bounds__(kThreads, 2)
reduce_global_kernel(const K* __restrict__ keys, const V* __restrict__ vals, int64_t n, int64_t head,
                     int64_t groups, int64_t n_keys, V* __restrict__ out) {
  reduce_into<K, V, O>(out, keys, vals, n, head, groups, n_keys);
}

// The 16-byte aligned groups of four: the first element whose key and value
// both start a 16-byte vector (head < 4), and the groups from there; none
// when no such element exists.
void plan_groups(const void* keys, int key_bytes, const void* vals, int64_t n, int64_t& head, int64_t& groups) {
  const auto k = reinterpret_cast<uintptr_t>(keys), v = reinterpret_cast<uintptr_t>(vals);
  head = 0;
  groups = 0;
  for (int64_t h = 0; h < 4 && h < n; ++h) {
    if ((k + h * key_bytes) % 16 == 0 && (v + h * 4) % 16 == 0) {
      head = h;
      groups = (n - h) / 4;
      return;
    }
  }
}

struct DeviceLimits {
  int sms = 0, smem_optin = 0;
};

cudaError_t device_limits(DeviceLimits& out) {
  static DeviceLimits cache[kMaxDevices];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  DeviceLimits& c = cache[dev < kMaxDevices ? dev : 0];
  if (dev >= kMaxDevices || c.sms == 0) {
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&c.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) {
      c.sms = 0;
      return err;
    }
  }
  out = c;
  return cudaSuccess;
}

// slots of V the shared path holds: the block's opt-in shared memory less
// the kernel's static shared memory
int64_t shared_keys(const DeviceLimits& d, int value_bytes) {
  return (d.smem_optin - kStaticSmem) / value_bytes;
}

// Clusters the shared path launches for n values into n_keys slots: as
// many as the card keeps resident (cudaOccupancyMaxActiveClusters, once a
// device and shared size), at most one a kCluster blocks' share of groups;
// 0 when none fits.
template <typename K, typename V, int O>
cudaError_t shared_clusters(int64_t n, int64_t n_keys, int& clusters) {
  static std::mutex mu;
  static int cached_smem[kMaxDevices], cached_clusters[kMaxDevices];
  static bool ready[kMaxDevices];
  clusters = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return err == cudaSuccess ? cudaErrorInvalidDevice : err;
  DeviceLimits d;
  err = device_limits(d);
  if (err != cudaSuccess) return err;
  const int smem = (int)(n_keys * (int64_t)sizeof(V));
  int resident = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (ready[dev] && cached_smem[dev] == smem) {
      resident = cached_clusters[dev];
    } else {
      auto kernel = reduce_shared_kernel<K, V, O>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = kCluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(kCluster);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = (size_t)smem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
      if (err != cudaSuccess) return err;
      cached_smem[dev] = smem;
      cached_clusters[dev] = resident;
      ready[dev] = true;
    }
  }
  const int64_t per_cluster = (int64_t)kThreads * kGroups * 4 * kCluster;  // values a cluster takes a sweep
  const int64_t want = (n + per_cluster - 1) / per_cluster;
  clusters = (int)(want < 1 ? 1 : (want < resident ? want : resident));
  if (resident == 0) clusters = 0;
  return cudaSuccess;
}

template <typename K, typename V, int O>
cudaError_t run(const void* keys, const void* vals, int64_t n, int64_t n_keys, void* state, unsigned tag, void* out,
                cudaStream_t s) {
  auto o = static_cast<V*>(out);
  const auto k = static_cast<const K*>(keys);
  const auto v = static_cast<const V*>(vals);
  int64_t head = 0, groups = 0;
  plan_groups(keys, (int)sizeof(K), vals, n, head, groups);
  DeviceLimits d;
  cudaError_t err = device_limits(d);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  if (n_keys <= shared_keys(d, (int)sizeof(V))) {
    err = shared_clusters<K, V, O>(n, n_keys, clusters);
    if (err != cudaSuccess) return err;
  }
  if (clusters > 0) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)(clusters * kCluster));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)(n_keys * (int64_t)sizeof(V));
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, reduce_shared_kernel<K, V, O>, k, v, n, head, groups, (int)n_keys,
                              static_cast<unsigned*>(state), tag, o);
  }
  const int64_t fb = (n_keys + kThreads - 1) / kThreads;
  const int64_t cap = 4 * (int64_t)d.sms;
  fill_kernel<V, O><<<(unsigned)(fb < cap ? fb : cap), kThreads, 0, s>>>(o, n_keys);
  if (n == 0) return cudaGetLastError();
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reduce_global_kernel<K, V, O>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t want = (n + (int64_t)kThreads * kGroups * 4 - 1) / ((int64_t)kThreads * kGroups * 4);
  const int64_t most = (int64_t)(per_sm < 1 ? 1 : per_sm) * d.sms;
  reduce_global_kernel<K, V, O><<<(unsigned)(want < most ? want : most), kThreads, 0, s>>>(
      k, v, n, head, groups, n_keys, o);
  return cudaGetLastError();
}

template <typename K, typename V>
cudaError_t run_op(int op, const void* keys, const void* vals, int64_t n, int64_t n_keys, void* state, unsigned tag,
                   void* out, cudaStream_t s) {
  if (op == kSum) return run<K, V, kSum>(keys, vals, n, n_keys, state, tag, out, s);
  if (op == kMax) return run<K, V, kMax>(keys, vals, n, n_keys, state, tag, out, s);
  return run<K, V, kMin>(keys, vals, n, n_keys, state, tag, out, s);
}

template <typename K>
cudaError_t run_key(int op, int is_float, const void* keys, const void* vals, int64_t n, int64_t n_keys, void* state,
                    unsigned tag, void* out, cudaStream_t s) {
  return is_float ? run_op<K, float>(op, keys, vals, n, n_keys, state, tag, out, s)
                  : run_op<K, int32_t>(op, keys, vals, n, n_keys, state, tag, out, s);
}

bool valid(int key_bytes, int op) { return op >= kSum && op <= kMin && (key_bytes == 4 || key_bytes == 8); }

}  // namespace

// Slots of 4-byte values the shared path takes on the current device.
extern "C" int64_t rtpu_segment_shared_keys() {
  DeviceLimits d;
  return device_limits(d) == cudaSuccess ? shared_keys(d, 4) : -1;
}

// out (n_keys >= 1) = the reduction `op` (0 sum, 1 max, 2 min) of the n
// values by key.  keys: int32 (key_bytes 4) or int64 (8); values: int32
// (is_float 0) or float32 (1).  state: two unsigned, zero when first used,
// which the calls of one stream share; tag: in [1, 2**31), a different one
// each call since state was zeroed.  One launch while n_keys fits
// (rtpu_segment_shared_keys), else a fill and the reduce through global
// atomics.
extern "C" int rtpu_segment_reduce(const void* keys, int key_bytes, const void* vals, int is_float, int op,
                                   int64_t n, int64_t n_keys, void* state, int64_t tag, void* out, void* stream) {
  if (!valid(key_bytes, op) || n_keys < 1 || tag < 1 || tag >= (int64_t{1} << 31)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(key_bytes == 4 ? run_key<int32_t>(op, is_float, keys, vals, n, n_keys, state, (unsigned)tag, out, s)
                              : run_key<int64_t>(op, is_float, keys, vals, n, n_keys, state, (unsigned)tag, out, s));
}
