// Word-count kernels of the MapReduce device path (BASELINE config 4).
//
// wc_words replaces the jitted wc_extract_words (redisson_tpu/core/kernels.py
// :584-636) and wc_extract_words_auto (:994-1010, with _wc_hash_prelude :967
// and _wc_gather_words :980).  For each output row r < n_words it takes an
// end position e and gives the word ending there:
//   ha = sum over the bytes of (lw, g] of (b+1) * A^min(j,63), XOR len*2654435761
//   hb = the same sum with B, plus len*0x9E3779B9, start = lw + 1 + base,
// all mod 2**32, where g is e as JAX's gather reads it (a negative e counts
// from the end once, then clamps into [0, n)), lw the last whitespace at or
// before g (-1 for none), j a byte's place in its word and len = e - lw.
// Rows at or past n_words hold 0xFFFFFFFF in all three.  The JAX program
// keeps four per-byte arrays (a cummax and two prefix sums) only to
// difference them at the ends; the sum of one word's own bytes is the same
// u32, so here one thread per row walks back from g to the previous
// whitespace and sums forward: no per-byte array at all.  The auto form
// finds the ends on the card: every non-whitespace byte followed by
// whitespace (the last byte counts as followed by it), in ascending order,
// the first `rows` of them; a row past the ends found reads n - 1, as JAX's
// sort sentinel does after its min(., n - 1).  The delta form takes its ends
// as cumsum(deltas) - 1 in int32, then min(., n - 1).
//
// wc_sort_runs replaces wc_sort_runs (:1013-1034): a stable sort of rows by
// the unsigned 64-bit key (ha:hb), carrying start; then each run of equal
// keys is flagged at its first row, and a stable partition writes the run
// starts' (index, start) in index order, then the other rows as
// (0x7FFFFFFF, start) in sorted order.  That is what JAX's second stable
// sort by the flag yields.  The first min(n, d_out) rows of both are the
// (2, d_out) int32 result.  The sort is an LSD radix sort, 8 passes of 8
// bits; a pass counts each tile's digits, scans the counts digit-major, and
// scatters each tile stably: a warp ranks its own contiguous run of keys in
// order with __match_any_sync.
//
// Bound on an H100: bytes.  The auto form reads the chunk three times with
// byte loads (the end count, the end write, the words' walk back and
// forward sum, the last two within a word served from L1/L2) and writes 12
// bytes a row.  The sort moves ~32 bytes a row a pass (the digit count
// reads the key; the scatter reads key and start and writes them) over 8
// passes, plus the pack (24 a row) and the runs (28 a row, 8 an output
// row).  A word longer than a few hundred bytes is walked by one thread:
// correct, and slow only for such words.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // kernels.WC_TILE
constexpr int kBins = 256;                // radix digits of 8 bits
constexpr int kPasses = 8;
constexpr int kPowCap = 63;
constexpr uint32_t kPowA = 0x01000193u;  // FNV-32 prime
constexpr uint32_t kPowB = 40503u;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int32_t kBig = 0x7FFFFFFF;
constexpr uint8_t kSpace = 32;

static_assert(kThreads == kBins, "a pass's per-digit steps take one thread a digit");

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// Exclusive prefix (mod 2**32) of x over the block's threads in thread
// order; `total` gets the block's sum.  Every thread of the block calls it.
__device__ uint32_t block_exclusive(uint32_t x, uint32_t& total) {
  __shared__ uint32_t sums[kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t inc = warp_inclusive(x);
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < kWarps ? sums[lane] : 0u;
    const uint32_t wi = warp_inclusive(w);
    if (lane < kWarps) sums[lane] = wi - w;
    if (lane == 31) sums[kWarps] = wi;
  }
  __syncthreads();
  const uint32_t out = sums[warp] + inc - x;
  total = sums[kWarps];
  __syncthreads();  // the next call may rewrite sums
  return out;
}

// ---------------------------------------------------------------------------
// Exclusive scan of n uint32 words, out[n] the total, in three launches: each
// tile's sum, one block scanning the tile sums in place, each tile's scan
// plus its offset.  In place (in == out) is allowed.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
scan_reduce_kernel(const uint32_t* __restrict__ in, int64_t n, uint32_t* __restrict__ tile_sums) {
  const int64_t base = (int64_t)blockIdx.x * kTile;
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    if (i < n) s += in[i];
  }
  uint32_t total;
  block_exclusive(s, total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: sums[0..n) becomes its exclusive scan, sums[n] (and *also, when
// given) the total.
__global__ void __launch_bounds__(kThreads)
scan_single_kernel(uint32_t* sums, int64_t n, uint32_t* also) {
  uint32_t carry = 0;
  for (int64_t base = 0; base < n; base += kTile) {
    uint32_t v[kItems];
    uint32_t s = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + (int64_t)threadIdx.x * kItems + k;
      v[k] = i < n ? sums[i] : 0u;
      s += v[k];
    }
    uint32_t total;
    uint32_t pre = block_exclusive(s, total) + carry;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + (int64_t)threadIdx.x * kItems + k;
      if (i < n) sums[i] = pre;
      pre += v[k];
    }
    carry += total;
  }
  if (threadIdx.x == 0) {
    sums[n] = carry;
    if (also != nullptr) *also = carry;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_down_kernel(const uint32_t* in, int64_t n, const uint32_t* __restrict__ tile_off, uint32_t* out) {
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  uint32_t v[kItems];
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = base + k < n ? in[base + k] : 0u;
    s += v[k];
  }
  uint32_t total;
  uint32_t pre = block_exclusive(s, total) + tile_off[blockIdx.x];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n) out[base + k] = pre;
    pre += v[k];
  }
}

// scratch: tiles_of(n) + 1 words.
cudaError_t scan_exclusive(const uint32_t* in, uint32_t* out, int64_t n, uint32_t* scratch,
                           cudaStream_t s) {
  const int64_t t = tiles_of(n);
  if (t > 0) scan_reduce_kernel<<<(unsigned)t, kThreads, 0, s>>>(in, n, scratch);
  scan_single_kernel<<<1, kThreads, 0, s>>>(scratch, t, out + n);
  if (t > 0) scan_down_kernel<<<(unsigned)t, kThreads, 0, s>>>(in, n, scratch, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wc_words
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool is_end(const uint8_t* __restrict__ buf, int64_t n, int64_t i) {
  return buf[i] != kSpace && (i + 1 == n || buf[i + 1] == kSpace);
}

// Bit k set where byte base + k of the thread's run ends a word.
__device__ __forceinline__ uint32_t end_mask(const uint8_t* __restrict__ buf, int64_t n, int64_t base) {
  uint32_t mask = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n && is_end(buf, n, base + k)) mask |= 1u << k;
  }
  return mask;
}

__global__ void __launch_bounds__(kThreads)
end_count_kernel(const uint8_t* __restrict__ buf, int64_t n, uint32_t* __restrict__ tile_counts) {
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  uint32_t total;
  block_exclusive(__popc(end_mask(buf, n, base)), total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// The ends in ascending order: the end of rank r goes to ends[r], r < rows.
__global__ void __launch_bounds__(kThreads)
end_write_kernel(const uint8_t* __restrict__ buf, int64_t n, const uint32_t* __restrict__ tile_off,
                 int32_t* __restrict__ ends, int rows) {
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  uint32_t mask = end_mask(buf, n, base);
  uint32_t total;
  uint32_t r = block_exclusive(__popc(mask), total) + tile_off[blockIdx.x];
  while (mask) {
    const int k = __ffs(mask) - 1;
    mask &= mask - 1;
    if (r < (uint32_t)rows) ends[r] = (int32_t)(base + k);
    ++r;
  }
}

// Row r's end: the auto form's rank-r end (n - 1 past the ends found), or
// the delta form's inclusive sum minus 1 (int32), both capped at n - 1.
__global__ void __launch_bounds__(kThreads)
words_kernel(const uint8_t* __restrict__ buf, int64_t n, const int32_t* __restrict__ ends,
             const uint32_t* __restrict__ n_found, int rows, int n_words, uint32_t base,
             uint32_t* __restrict__ ha, uint32_t* __restrict__ hb, uint32_t* __restrict__ st) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += gridDim.x * blockDim.x) {
    if (r >= n_words) {
      ha[r] = hb[r] = st[r] = kSentinel;
      continue;
    }
    int32_t e;
    if (n_found != nullptr) {
      e = (uint32_t)r < *n_found ? ends[r] : (int32_t)(n - 1);
    } else {
      e = (int32_t)((uint32_t)ends[r] - 1u);
      if ((int64_t)e > n - 1) e = (int32_t)(n - 1);
    }
    int64_t g = e;
    if (g < 0) g += n;
    g = g < 0 ? 0 : (g > n - 1 ? n - 1 : g);
    int64_t lw = g;
    while (lw >= 0 && buf[lw] != kSpace) --lw;
    uint32_t a = 0, b = 0, pa = 1, pb = 1;
    int j = 0;
    for (int64_t i = lw + 1; i <= g; ++i) {
      const uint32_t c = (uint32_t)buf[i] + 1u;
      a += c * pa;
      b += c * pb;
      if (j < kPowCap) {
        pa *= kPowA;
        pb *= kPowB;
        ++j;
      }
    }
    const uint32_t len = (uint32_t)e - (uint32_t)lw;
    ha[r] = a ^ (len * 2654435761u);
    hb[r] = b + len * 0x9E3779B9u;
    st[r] = (uint32_t)lw + 1u + base;
  }
}

int row_blocks(int rows) {
  const int b = (rows + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > 65535 * 8 ? 65535 * 8 : b);
}

// ---------------------------------------------------------------------------
// wc_sort_runs
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ ha, const uint32_t* __restrict__ hb,
            const uint32_t* __restrict__ st, int64_t n, uint64_t* __restrict__ keys,
            uint32_t* __restrict__ vals) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    keys[i] = ((uint64_t)ha[i] << 32) | hb[i];
    vals[i] = st[i];
  }
}

// Each tile's digit counts, digit-major: hist[d * tiles + t].
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const uint64_t* __restrict__ keys, int64_t n, int shift, int64_t tiles,
                  uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[kBins];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&h[(keys[i] >> shift) & (kBins - 1)], 1u);
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * tiles + blockIdx.x] = h[threadIdx.x];
}

// Stable scatter of one tile by digit.  Warp w ranks keys [w*32*kItems,
// (w+1)*32*kItems) of the tile in order, 32 at a time; a key's place is its
// digit's offset for the tile (the scanned histogram), plus the keys of that
// digit in earlier warps of the tile, plus its rank in its warp.
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const uint64_t* __restrict__ keys, const uint32_t* __restrict__ vals,
                     int64_t n, int shift, int64_t tiles, const uint32_t* __restrict__ offsets,
                     uint64_t* __restrict__ keys_out, uint32_t* __restrict__ vals_out) {
  __shared__ uint32_t counts[kWarps][kBins];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = 0; w < kWarps; ++w) counts[w][threadIdx.x] = 0;
  __syncthreads();
  const int64_t wbase = (int64_t)blockIdx.x * kTile + (int64_t)warp * 32 * kItems;
  const uint32_t lower = (1u << lane) - 1u;
  uint32_t rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = wbase + k * 32 + lane;
    const bool live = i < n;
    const uint32_t d = live ? (uint32_t)((keys[i] >> shift) & (kBins - 1)) : (uint32_t)kBins;
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    const uint32_t before = live ? counts[warp][d] : 0u;
    rank[k] = before + __popc(peers & lower);
    __syncwarp();
    if (live && lane == __ffs(peers) - 1) counts[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  {
    const int d = threadIdx.x;
    uint32_t s = offsets[(int64_t)d * tiles + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = counts[w][d];
      counts[w][d] = s;
      s += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = wbase + k * 32 + lane;
    if (i < n) {
      const uint64_t key = keys[i];
      const uint32_t dst = counts[warp][(key >> shift) & (kBins - 1)] + rank[k];
      keys_out[dst] = key;
      vals_out[dst] = vals[i];
    }
  }
}

__device__ __forceinline__ uint32_t run_mask(const uint64_t* __restrict__ keys, int64_t n, int64_t base) {
  uint32_t mask = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < n && (i == 0 || keys[i] != keys[i - 1])) mask |= 1u << k;
  }
  return mask;
}

__global__ void __launch_bounds__(kThreads)
runs_count_kernel(const uint64_t* __restrict__ keys, int64_t n, uint32_t* __restrict__ tile_counts) {
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  uint32_t total;
  block_exclusive(__popc(run_mask(keys, n, base)), total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// tile_off[t]: run starts before tile t; tile_off[tiles]: all of them (D).
// A run start i of rank r goes to row r as (i, start); a row i with r run
// starts before it goes to row D + i - r as (0x7FFFFFFF, start).
__global__ void __launch_bounds__(kThreads)
runs_write_kernel(const uint64_t* __restrict__ keys, const uint32_t* __restrict__ vals, int64_t n,
                  const uint32_t* __restrict__ tile_off, int64_t tiles, int64_t d_out,
                  int32_t* __restrict__ fp, int32_t* __restrict__ off) {
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  const uint32_t mask = run_mask(keys, n, base);
  uint32_t total;
  int64_t r = block_exclusive(__popc(mask), total) + tile_off[blockIdx.x];
  const int64_t runs = tile_off[tiles];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i >= n) break;
    const bool first = (mask >> k) & 1u;
    const int64_t row = first ? r : runs + i - r;
    if (row < d_out) {
      fp[row] = first ? (int32_t)i : kBig;
      off[row] = (int32_t)vals[i];
    }
    r += first;
  }
}

}  // namespace

// wc_extract_words (deltas given) or wc_extract_words_auto (deltas null):
// rows output rows of ha, hb, start (uint32 bits).  1 <= n < 2**31.
//   auto:  scratch tiles_of(n) + 1 words, ends `rows` int32;
//   delta: scratch tiles_of(rows) + 1 words, ends rows + 1 int32 (the scan).
extern "C" int rtpu_wc_words(const void* buf, int64_t n, const void* deltas, int rows, int n_words,
                             int64_t base, void* scratch, void* ends, void* ha, void* hb, void* st,
                             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const uint8_t*>(buf);
  const auto sc = static_cast<uint32_t*>(scratch);
  auto e = static_cast<int32_t*>(ends);
  const uint32_t* found = nullptr;
  if (deltas == nullptr) {
    const int64_t t = tiles_of(n);
    end_count_kernel<<<(unsigned)t, kThreads, 0, s>>>(b, n, sc);
    scan_single_kernel<<<1, kThreads, 0, s>>>(sc, t, nullptr);
    end_write_kernel<<<(unsigned)t, kThreads, 0, s>>>(b, n, sc, e, rows);
    found = sc + t;
  } else {
    const cudaError_t err = scan_exclusive(static_cast<const uint32_t*>(deltas),
                                           reinterpret_cast<uint32_t*>(e), rows, sc, s);
    if (err != cudaSuccess) return (int)err;
    e += 1;  // inclusive sums
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    words_kernel<<<row_blocks(rows), kThreads, 0, s>>>(
        b, n, e, found, rows, n_words, (uint32_t)base, static_cast<uint32_t*>(ha),
        static_cast<uint32_t*>(hb), static_cast<uint32_t*>(st));
  }
  return (int)cudaGetLastError();
}

// wc_sort_runs over n >= 1 rows into out = (2, d_out) int32, d_out <= n.
// Scratch: keys0/keys1 n uint64, vals0/vals1 n uint32, hist kBins*tiles + 1
// words, scan tiles + 1 words, tiles = tiles_of(n).
extern "C" int rtpu_wc_sort_runs(const void* ha, const void* hb, const void* st, int64_t n,
                                 int64_t d_out, void* keys0, void* vals0, void* keys1, void* vals1,
                                 void* hist, void* scan, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(n);
  uint64_t* k[2] = {static_cast<uint64_t*>(keys0), static_cast<uint64_t*>(keys1)};
  uint32_t* v[2] = {static_cast<uint32_t*>(vals0), static_cast<uint32_t*>(vals1)};
  const auto h = static_cast<uint32_t*>(hist);
  const auto sc = static_cast<uint32_t*>(scan);
  const int64_t pb = (n + kThreads - 1) / kThreads;
  pack_kernel<<<(unsigned)(pb < 65535 * 8 ? pb : 65535 * 8), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(ha), static_cast<const uint32_t*>(hb),
      static_cast<const uint32_t*>(st), n, k[0], v[0]);
  for (int p = 0; p < kPasses; ++p) {
    const int shift = 8 * p, src = p & 1, dst = src ^ 1;
    radix_hist_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(k[src], n, shift, tiles, h);
    const cudaError_t err = scan_exclusive(h, h, kBins * tiles, sc, s);
    if (err != cudaSuccess) return (int)err;
    radix_scatter_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(k[src], v[src], n, shift, tiles, h,
                                                               k[dst], v[dst]);
  }
  static_assert(kPasses % 2 == 0, "the sorted rows end in keys0/vals0");
  runs_count_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(k[0], n, sc);
  scan_single_kernel<<<1, kThreads, 0, s>>>(sc, tiles, nullptr);
  auto o = static_cast<int32_t*>(out);
  runs_write_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(k[0], v[0], n, sc, tiles, d_out, o,
                                                         o + d_out);
  return (int)cudaGetLastError();
}
