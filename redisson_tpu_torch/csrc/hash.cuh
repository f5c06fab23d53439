// Murmur3 double-hash chain ("rtpu-mur32x2/1", HASH_VERSION 1) as a device
// function, fused into every sketch kernel; never launched on its own.
//
// Replaces redisson_tpu/utils/hashing.py (fmix32, hash_words, hash_u64_pair,
// hash_packed_bytes, bloom_indexes), which XLA fused into each jitted
// program.  It is a persisted format: bloom planes and HLL registers mean
// something only under this exact chain, so it matches the JAX package bit
// for bit (tests/test_torch_*.py hold the plain PyTorch copy to JAX; the card
// holds these kernels to the plain copy).
#pragma once

#include <stdint.h>

namespace rtpu {

constexpr uint32_t SEED1 = 0x9747B28Cu;
constexpr uint32_t SEED2 = 0x3C6EF372u;
constexpr uint32_t C1 = 0xCC9E2D51u;
constexpr uint32_t C2 = 0x1B873593u;
constexpr uint32_t FM1 = 0x85EBCA6Bu;
constexpr uint32_t FM2 = 0xC2B2AE35u;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= FM1;
  x ^= x >> 13;
  x *= FM2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t mur_round(uint32_t h, uint32_t k) {
  k *= C1;
  k = rotl32(k, 15);
  k *= C2;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

// One batch of keys.  u64 keys: lo/hi word arrays (nbytes == nullptr).
// Byte keys: nbytes and n_words word columns of stride n (n_words may be 0).
// tenant, when not null, is each op's row in a (T, width) plane.  All arrays
// hold n entries.
struct KeyBatch {
  const uint32_t* tenant;
  const uint32_t* lo;
  const uint32_t* hi;
  const uint32_t* words;
  const uint32_t* nbytes;
  int n_words;
  int n;
};

// The KeyBatch of an entry point's untyped key pointers.
inline KeyBatch key_batch(const void* tenant, const void* lo, const void* hi, const void* words,
                          const void* nbytes, int n_words, int n) {
  return KeyBatch{static_cast<const uint32_t*>(tenant), static_cast<const uint32_t*>(lo),
                  static_cast<const uint32_t*>(hi),     static_cast<const uint32_t*>(words),
                  static_cast<const uint32_t*>(nbytes), n_words, n};
}

__device__ __forceinline__ void hash_key(const KeyBatch& kb, int i, uint32_t& h1,
                                         uint32_t& h2) {
  if (kb.nbytes == nullptr) {
    const uint32_t lo = kb.lo[i], hi = kb.hi[i];
    h1 = fmix32(mur_round(mur_round(SEED1, lo), hi) ^ 8u);
    h2 = fmix32(mur_round(mur_round(SEED2, lo), hi) ^ 8u) | 1u;
    return;
  }
  if (kb.n_words == 0) {  // zero-width packing hashes to 0 (h2 not forced odd)
    h1 = h2 = 0u;
    return;
  }
  const uint32_t nb = kb.nbytes[i];
  const uint32_t nw = (nb + 3u) >> 2;  // words past ceil(len/4) are masked out
  uint32_t a = SEED1, b = SEED2;
  for (int j = 0; j < kb.n_words; ++j) {
    if ((uint32_t)j < nw) {
      const uint32_t w = kb.words[(int64_t)j * kb.n + i];
      a = mur_round(a, w);
      b = mur_round(b, w);
    }
  }
  h1 = fmix32(a ^ nb);
  h2 = fmix32(b ^ nb) | 1u;
}

// Flat plane position of a probe at column idx of a row that starts at
// `row` (tenant*width, mod 2**32), or -1 when outside.  Kept bit for bit
// from the JAX programs: with a tenant, tenant*width + idx is int32
// arithmetic (it wraps), a negative position counts from the end once
// (+size), and whatever is still outside [0, size) reads as 1 / is dropped.
// Without a tenant the position is idx itself.
__device__ __forceinline__ int64_t flat_at(bool has_tenant, uint32_t row, uint32_t idx,
                                           int64_t size) {
  int64_t g = idx;
  if (has_tenant) {
    const int32_t w = (int32_t)(row + idx);
    g = w < 0 ? (int64_t)w + size : (int64_t)w;
  }
  return (g >= 0 && g < size) ? g : -1;
}

// tenant[i]*width mod 2**32: op i's row start, read once per op.
__device__ __forceinline__ uint32_t row_base(const KeyBatch& kb, int i, uint32_t width) {
  return kb.tenant != nullptr ? kb.tenant[i] * width : 0u;
}

// Op i's flat position at column idx (one probe per op, as in hll_add).
__device__ __forceinline__ int64_t flat_index(const uint32_t* tenant, int i,
                                              uint32_t width, uint32_t idx,
                                              int64_t size) {
  return flat_at(tenant != nullptr, tenant != nullptr ? tenant[i] * width : 0u, idx, size);
}

// x % d for every uint32 x and 1 <= d < 2**32 without a division (Lemire,
// Kaser and Kurz, "Faster remainder by direct computation", 2019):
// magic = ceil(2**64 / d) mod 2**64, computed on the host
// (core/kernels.py fastmod_magic), and x % d = hi64((magic * x mod 2**64) * d).
// d = 1 gives magic = 0 and so 0, as it should.
struct FastMod {
  uint64_t magic;
  uint32_t d;
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
    return (uint32_t)__umul64hi(magic * (uint64_t)x, (uint64_t)d);
  }
};

}  // namespace rtpu
