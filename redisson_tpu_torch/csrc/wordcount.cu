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
// u32, so here each word is summed from its own bytes: no per-byte array at
// all.  The auto form finds the ends on the card: every non-whitespace byte
// followed by whitespace (the last byte counts as followed by it), in
// ascending order, the first `rows` of them; a row past the ends found
// reads n - 1, as JAX's sort sentinel does after its min(., n - 1).  It is
// one launch (words_auto_kernel): tiles of 8 KB taken by ticket, read once
// with 16-byte loads into shared memory with a 256-byte halo before them,
// the ends ranked by a block scan and decoupled look-back over the tiles
// before (status words tagged with the call, so the region they live in is
// never cleared), each word hashed by one lane from shared memory, and a
// round's rows (a vector a thread) staged and written by the whole block
// with 16-byte stores.  The delta form takes its ends as
// cumsum(deltas) - 1 in int32, then min(., n - 1): a three-launch scan of
// the deltas, then one thread a row walks back from its end to the previous
// whitespace and sums forward.
//
// wc_sort_runs replaces wc_sort_runs (:1013-1034): a stable sort of rows by
// the unsigned 64-bit key (ha:hb), carrying start; then each run of equal
// keys is flagged at its first row, and a stable partition writes the run
// starts' (index, start) in index order, then the other rows as
// (0x7FFFFFFF, start) in sorted order.  That is what JAX's second stable
// sort by the flag yields.  The first min(n, d_out) rows of both are the
// (2, d_out) int32 result.  The sort is a one-sweep LSD radix sort (after
// Adinets and Merrill's Onesweep): one kernel counts every pass's digits
// from one read of the keys; each of 8 passes of 8-bit digits takes its
// tile of 4,096 rows by an atomic ticket (so tiles are taken in order),
// ranks it stably (each warp its 512 keys with __match_any_sync, then a scan
// over the warps and the digits), publishes its digit counts, finds each
// digit's global start by decoupled look-back over the tiles before it (16
// status words a round trip), and writes the tile from shared memory in
// digit order, consecutive threads to consecutive places of one digit's
// run.  The first pass reads ha, hb and st directly.  11-bit digits (6
// passes, 2,048 bins) were slower on the H100 and are not kept: a tile
// spreads over 2,048 runs of about 2 keys, and the look-back walks 8
// digits a thread (PERF.md).
//
// Bound on an H100: bytes.  The auto form reads the chunk once (and a
// 256-byte halo an 8 KB tile) and writes 12 bytes a row; what it moves is
// mostly its output.  The sort's design moves 220 bytes a row: the histogram (8),
// 8 passes that read a key and a start and write them (24 each), the run
// count (8) and the partition (12, and 8 an output row).  Its passes run
// at about 2 TB/s; what holds them below the HBM rate is each tile's
// latency (ticket, loads, ranking, look-back, write) with two tiles a SM
// in flight.  A word longer than a few hundred bytes is walked by one
// thread: correct, and slow only for such words.
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // kernels.WC_TILE
constexpr int kPowCap = 63;
constexpr uint32_t kPowA = 0x01000193u;  // FNV-32 prime
constexpr uint32_t kPowB = 40503u;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int32_t kBig = 0x7FFFFFFF;
constexpr uint8_t kSpace = 32;

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

// The word of end g (bytes (lw, g]): ha, hb and start of one output row.
struct Word {
  uint32_t a = 0, b = 0, pa = 1, pb = 1;
  int j = 0;

  __device__ __forceinline__ void add(uint32_t c) {
    a += (c + 1u) * pa;
    b += (c + 1u) * pb;
    if (j < kPowCap) {
      pa *= kPowA;
      pb *= kPowB;
      ++j;
    }
  }
};

__device__ __forceinline__ void word_row(const Word& w, uint32_t len, uint32_t start, uint32_t& ha,
                                         uint32_t& hb, uint32_t& st) {
  ha = w.a ^ (len * 2654435761u);
  hb = w.b + len * 0x9E3779B9u;
  st = start;
}

// The delta form: row r's end is the inclusive sum of the deltas minus 1
// (int32), capped at n - 1; one thread a row walks back from it to the
// previous whitespace and sums forward.
__global__ void __launch_bounds__(kThreads)
words_kernel(const uint8_t* __restrict__ buf, int64_t n, const int32_t* __restrict__ ends, int rows,
             int n_words, uint32_t base, uint32_t* __restrict__ ha, uint32_t* __restrict__ hb,
             uint32_t* __restrict__ st) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += gridDim.x * blockDim.x) {
    if (r >= n_words) {
      ha[r] = hb[r] = st[r] = kSentinel;
      continue;
    }
    int32_t e = (int32_t)((uint32_t)ends[r] - 1u);
    if ((int64_t)e > n - 1) e = (int32_t)(n - 1);
    int64_t g = e;
    if (g < 0) g += n;
    g = g < 0 ? 0 : (g > n - 1 ? n - 1 : g);
    int64_t lw = g;
    while (lw >= 0 && buf[lw] != kSpace) --lw;
    Word w;
    for (int64_t i = lw + 1; i <= g; ++i) w.add(buf[i]);
    word_row(w, (uint32_t)e - (uint32_t)lw, (uint32_t)lw + 1u + base, ha[r], hb[r], st[r]);
  }
}

int row_blocks(int rows) {
  const int b = (rows + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > 65535 * 8 ? 65535 * 8 : b);
}

// The auto form, one launch.  Bytes are addressed by their place u in the
// 16-byte aligned span that holds the buffer: u = i + off, off = buf & 15,
// so every 16-byte vector a thread takes is aligned in device memory and in
// shared memory.  Bytes outside [0, n) read as whitespace: position -1
// ends a walk back as the JAX program's -1 does, and position n makes the
// last byte an end.  A block takes tile t (kWordTile bytes of u) by an
// atomic ticket, loads it with the kHalo bytes before it and the vector
// after it into shared memory (16-byte loads, all in flight at once; a
// vector wholly outside the buffer is not read), finds each vector's ends
// and whitespace as 16-bit masks, ranks them within the tile by one block
// scan of 16-bit counts packed in 64 bits, publishes the tile's count and
// finds its first end's rank by decoupled look-back over the tiles before
// it.  Then, a round at a time (one vector a thread): each warp stages its
// words as (first byte, last byte) (a word that began before the warp's
// bytes is walked back to its start by lane 0: through shared memory,
// then, past the halo, device memory), one lane a word hashes it from
// shared memory (up to 8 bytes from one unaligned 8-byte read, each byte's
// power a constant), and the block writes the round's rows with 16-byte
// stores where the outputs are 16-byte aligned.
constexpr int kWordThreads = 256;
constexpr int kWordWarps = kWordThreads / 32;
constexpr int kWordVecs = 2;  // 16-byte vectors a thread takes of its tile
constexpr int kWordTile = kWordThreads * kWordVecs * 16;  // bytes a tile
constexpr int kHalo = 256;  // bytes before the tile held in shared memory
constexpr int kHaloVecs = kHalo / 16;
constexpr int kSmemVecs = kHaloVecs + kWordThreads * kWordVecs + 1;  // and the vector after the tile
constexpr int kRoundEnds = kWordThreads * 16 / 2;  // the most ends a round (a vector a thread) holds
static_assert(kWordVecs <= 4, "four 16-bit counts a thread travel in one 64-bit scan");

int64_t word_tiles(int64_t n, int off) { return (n + off + kWordTile - 1) / kWordTile; }

__device__ __forceinline__ uint4 spaces4() { return make_uint4(0x20202020u, 0x20202020u, 0x20202020u, 0x20202020u); }

// The aligned vector at u0 of the span, bytes outside [lo, hi) as
// whitespace; one wholly outside is not read.
__device__ __forceinline__ uint4 load_vec(const uint8_t* span, int64_t u0, int64_t lo, int64_t hi) {
  if (u0 + 16 <= lo || u0 >= hi) return spaces4();
  uint4 v = __ldg(reinterpret_cast<const uint4*>(span + u0));
  if (u0 < lo || u0 + 16 > hi) {
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int64_t u = u0 + k;
      if (u < lo || u >= hi) w[k >> 2] = (w[k >> 2] & ~(0xFFu << (8 * (k & 3)))) | (0x20u << (8 * (k & 3)));
    }
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return v;
}

// Bit k set where byte k of w is whitespace (k < 4).
__device__ __forceinline__ uint32_t space_bits(uint32_t w) {
  return ((__vcmpeq4(w, 0x20202020u) & 0x80808080u) * 0x00204081u) >> 28;
}

__device__ __forceinline__ uint32_t space_mask(uint4 v) {
  return space_bits(v.x) | space_bits(v.y) << 4 | space_bits(v.z) << 8 | space_bits(v.w) << 12;
}

// bytes p .. p + 7 of shared memory (any p; 16-byte aligned base; 12
// bytes readable from p & ~3) as a uint64, byte p lowest
__device__ __forceinline__ uint64_t bytes8(const uint8_t* sb, int p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(sb + (p & ~3));
  const uint32_t a = w[0], b = w[1], c = w[2];
  const uint32_t sh = 8u * (uint32_t)(p & 3);
  return (uint64_t)__funnelshift_r(a, b, sh) | (uint64_t)__funnelshift_r(b, c, sh) << 32;
}

// x**k mod 2**32 (a constant where k is)
__host__ __device__ constexpr uint32_t pow_u32(uint32_t x, int k) { return k == 0 ? 1u : x * pow_u32(x, k - 1); }

// The look-back status word of a tile: its count in the low 32 bits, above
// it the call's tag times 2, plus 1 once the count is the inclusive prefix.
// A word of another tag (an earlier call's, or 0 when the region is new) is
// not yet written, so the region needs no clearing between calls.
__device__ __forceinline__ void status_store(uint64_t* at, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(at), "l"(v) : "memory");
}
__device__ __forceinline__ uint64_t status_load(const uint64_t* at) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(at) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// Ends of tiles before `tile` (tag's status words), by one warp: 32
// predecessors a round trip, nearest first; aggregates add up until an
// inclusive prefix ends the walk.  A word not yet written stops the sum
// there (the words nearer than it are added) and is read again.
__device__ uint32_t look_back(const uint64_t* status, int64_t tile, uint32_t tag) {
  const int lane = threadIdx.x & 31;
  uint32_t excl = 0;
  for (int64_t p = tile - 1;;) {
    const int64_t q = p - lane;
    uint64_t v = 0;
    bool ready = true;
    if (q >= 0) {
      v = status_load(&status[q]);
      ready = (uint32_t)(v >> 33) == tag;
    }
    const uint32_t waiting = __ballot_sync(0xffffffffu, !ready);
    const uint32_t incl = __ballot_sync(0xffffffffu, ready && (q < 0 || ((v >> 32) & 1u)));
    const uint32_t count = ready && q >= 0 ? (uint32_t)v : 0u;
    const uint32_t needed = incl != 0 ? ((incl & (~incl + 1u)) << 1) - 1u : 0xffffffffu;  // up to the first inclusive
    if (waiting & needed) {
      const int k = __ffs(waiting & needed) - 1;  // the nearest word not yet written
      excl += warp_sum(lane < k ? count : 0u);
      p -= k;
      continue;
    }
    if (incl != 0) {
      const int first = __ffs(incl) - 1;
      return excl + warp_sum(lane <= first ? count : 0u);
    }
    excl += warp_sum(count);
    p -= 32;
  }
}

__global__ void __launch_bounds__(kWordThreads)
words_auto_kernel(const uint8_t* __restrict__ buf, int64_t n, int rows, int n_words, uint32_t base, int64_t tiles,
                  uint32_t tag, uint32_t* __restrict__ ticket, uint64_t* __restrict__ status,
                  uint32_t* __restrict__ ha, uint32_t* __restrict__ hb, uint32_t* __restrict__ st, bool vec_rows) {
  __shared__ uint4 sv[kSmemVecs];
  __shared__ __align__(16) uint32_t stage[3][kRoundEnds + 4];
  __shared__ uint64_t warp_counts[kWordWarps];
  __shared__ uint32_t tile_s, first_s, last_row[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int off = (int)(reinterpret_cast<uintptr_t>(buf) & 15);
  const uint8_t* span = buf - off;
  const int64_t lo = off, hi = n + off;
  if (threadIdx.x == 0) {
    const uint32_t t = atomicAdd(ticket, 1u);
    if ((int64_t)t == tiles - 1) *ticket = 0;  // every block has taken its ticket: ready for the next call
    tile_s = t;
    // rows past the ends found read e = n - 1: its word if the last byte
    // ends one (set below by the thread that hashes it), else none
    last_row[0] = last_row[1] = 0;
    last_row[2] = (uint32_t)n + base;
  }
  __syncthreads();
  const int64_t tile = tile_s;
  const int64_t u_tile = tile * kWordTile, u_smem = u_tile - kHalo;
  uint4 x[kWordVecs];
#pragma unroll
  for (int v = 0; v < kWordVecs; ++v) {
    x[v] = load_vec(span, u_tile + (int64_t)(v * kWordThreads + threadIdx.x) * 16, lo, hi);
  }
  uint4 extra = spaces4();
  if (threadIdx.x < kHaloVecs) extra = load_vec(span, u_smem + threadIdx.x * 16, lo, hi);
  else if (threadIdx.x == kHaloVecs) extra = load_vec(span, u_tile + kWordTile, lo, hi);
  // rows at or past n_words: the sentinel, grid-stride, while the loads fly
  const int64_t nw = n_words < 0 ? 0 : (n_words < rows ? n_words : rows);
  for (int64_t r = nw + (int64_t)blockIdx.x * kWordThreads + threadIdx.x; r < rows;
       r += (int64_t)gridDim.x * kWordThreads) {
    ha[r] = hb[r] = st[r] = kSentinel;
  }
#pragma unroll
  for (int v = 0; v < kWordVecs; ++v) sv[kHaloVecs + v * kWordThreads + threadIdx.x] = x[v];
  if (threadIdx.x < kHaloVecs) sv[threadIdx.x] = extra;
  else if (threadIdx.x == kHaloVecs) sv[kSmemVecs - 1] = extra;
  __syncthreads();

  // each vector's whitespace and ends (a non-whitespace byte followed by
  // whitespace; byte 16 is the next vector's first)
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(sv);
  uint32_t sp[kWordVecs], ends[kWordVecs];
  uint64_t packed = 0;
#pragma unroll
  for (int v = 0; v < kWordVecs; ++v) {
    sp[v] = space_mask(x[v]);
    uint32_t next_sp = __shfl_down_sync(0xffffffffu, sp[v] & 1u, 1);
    if (lane == 31) next_sp = sb[(kHaloVecs + v * kWordThreads + threadIdx.x + 1) * 16] == kSpace;
    ends[v] = ~sp[v] & ((sp[v] >> 1) | (next_sp << 15)) & 0xFFFFu;
    packed |= (uint64_t)__popc(ends[v]) << (16 * v);
  }
  // ranks within the tile: vector v * kWordThreads + t comes after every
  // vector of rounds before v and the vectors of round v of threads before t
  uint64_t inc = packed;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t y = __shfl_up_sync(0xffffffffu, (unsigned long long)inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_counts[warp] = inc;
  __syncthreads();
  uint64_t before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWordWarps; ++w) {
    const uint64_t c = warp_counts[w];
    if (w < warp) before += c;
    total += c;
  }
  uint32_t count = 0, round_base[kWordVecs];
#pragma unroll
  for (int v = 0; v < kWordVecs; ++v) {
    round_base[v] = count;
    count += (uint32_t)(total >> (16 * v)) & 0xFFFFu;
  }
  if (warp == 0) {
    uint32_t first = 0;
    if (tile == 0) {
      if (lane == 0) status_store(&status[0], (uint64_t)(2 * tag + 1) << 32 | count);
    } else {
      if (lane == 0) status_store(&status[tile], (uint64_t)(2 * tag) << 32 | count);
      first = look_back(status, tile, tag);
      if (lane == 0) status_store(&status[tile], (uint64_t)(2 * tag + 1) << 32 | (first + count));
    }
    if (lane == 0) first_s = first;
  }
  __syncthreads();
  const int64_t first = first_s;

  uint32_t* sa = stage[0];
  uint32_t* sbh = stage[1];
  uint32_t* ss = stage[2];
#pragma unroll
  for (int v = 0; v < kWordVecs; ++v) {
    // the round's rows: [round_first, round_first + round_count), staged
    // at (row - base_row), base_row 4-row aligned for 16-byte stores
    const int64_t round_first = first + round_base[v];
    const uint32_t round_count = (uint32_t)(total >> (16 * v)) & 0xFFFFu;
    if (round_first >= nw) break;  // block-uniform: no row of the tile is left
    const int64_t base_row = vec_rows ? round_first & ~int64_t{3} : round_first;
    const uint32_t woff = (uint32_t)(round_first - base_row) + ((uint32_t)(before >> (16 * v)) & 0xFFFFu);
    const uint32_t warp_count = (uint32_t)(warp_counts[warp] >> (16 * v)) & 0xFFFFu;
    const int64_t warp_first = (int64_t)base_row + woff;
    if (warp_first < nw) {  // warp-uniform
      // each of the warp's words as (first byte, last byte) in shared-memory
      // index (negative: before the window), then one lane a word hashes it
      const int q = v * kWordThreads + threadIdx.x;
      const int rel0 = kHalo + q * 16;  // the vector's first byte
      int carry = 0;  // lane 0: the last whitespace before the warp's bytes
      if (lane == 0) {
        int r = rel0 - 1;
        while (r >= 0 && sb[r] != kSpace) --r;
        if (r < 0) {  // a word longer than the halo: walk on in device memory
          int64_t i = u_smem - off - 1;
          while (i >= 0 && buf[i] != kSpace) --i;
          r = (int)(i + off - u_smem);
        }
        carry = r;
      }
      // the last whitespace before each lane's vector: a running max over
      // the lanes before it, and lane 0's walk
      int last = sp[v] ? rel0 + 31 - __clz(sp[v]) : INT_MIN;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, last, d);
        if (lane >= d) last = max(last, y);
      }
      const int before_lane = __shfl_up_sync(0xffffffffu, last, 1);
      carry = __shfl_sync(0xffffffffu, carry, 0);
      const int prev = lane == 0 ? carry : max(before_lane, carry);
      uint32_t slot = woff + ((uint32_t)((inc - packed) >> (16 * v)) & 0xFFFFu);
      for (uint32_t rest = ends[v]; rest != 0; rest &= rest - 1) {
        const int k = __ffs(rest) - 1;
        const uint32_t below = sp[v] & ((1u << k) - 1u);
        sa[slot] = (uint32_t)(below ? rel0 + 32 - __clz(below) : prev + 1);
        sbh[slot] = (uint32_t)(rel0 + k);
        ++slot;
      }
      __syncwarp();
      for (uint32_t j = woff + lane; j < woff + warp_count && base_row + j < nw; j += 32) {
        const int start = (int)sa[j], end = (int)sbh[j];
        const uint32_t len = (uint32_t)(end - start + 1);
        Word w;
        if (start >= 0 && len <= 8) {
          // up to 8 bytes from three 4-byte loads, each byte's power a
          // constant: no chain of loads
          const uint64_t x8 = bytes8(sb, start);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (k < (int)len) {
              const uint32_t c = (uint32_t)(x8 >> (8 * k)) & 0xFFu;
              w.a += (c + 1u) * pow_u32(kPowA, k);
              w.b += (c + 1u) * pow_u32(kPowB, k);
            }
          }
        } else if (start >= 0 && len <= kPowCap) {  // powers below the cap: no count kept
          for (int p = start; p <= end; ++p) {
            const uint32_t c = sb[p] + 1u;
            w.a += c * w.pa;
            w.b += c * w.pb;
            w.pa *= kPowA;
            w.pb *= kPowB;
          }
        } else {
          for (int p = start; p <= end; ++p) w.add(p >= 0 ? sb[p] : buf[(int64_t)p + u_smem - off]);
        }
        const uint32_t at = (uint32_t)((int64_t)start + u_smem - off) + base;  // the first byte's position + base
        word_row(w, len, at, sa[j], sbh[j], ss[j]);
        if ((int64_t)end + u_smem - off == n - 1) word_row(w, len, at, last_row[0], last_row[1], last_row[2]);
      }
    }
    __syncthreads();
    // the round's rows below n_words, the whole block at once: 16-byte
    // stores of 4 rows where the outputs allow, the round's ends one a row
    const int64_t row_end = round_first + round_count < nw ? round_first + round_count : nw;
    for (int64_t r = base_row + 4 * (int64_t)threadIdx.x; r < row_end; r += 4 * (int64_t)kWordThreads) {
      const uint32_t i = (uint32_t)(r - base_row);
      if (vec_rows && r >= round_first && r + 4 <= row_end) {
        *reinterpret_cast<uint4*>(ha + r) = *reinterpret_cast<const uint4*>(sa + i);
        *reinterpret_cast<uint4*>(hb + r) = *reinterpret_cast<const uint4*>(sbh + i);
        *reinterpret_cast<uint4*>(st + r) = *reinterpret_cast<const uint4*>(ss + i);
      } else {
        for (int u = 0; u < 4; ++u) {
          if (r + u >= round_first && r + u < row_end) {
            ha[r + u] = sa[i + u];
            hb[r + u] = sbh[i + u];
            st[r + u] = ss[i + u];
          }
        }
      }
    }
    __syncthreads();
  }
  if (tile == tiles - 1) {
    // rows [ends found, n_words) read e = n - 1 (the rounds ended in a
    // block-wide barrier)
    for (int64_t r = first + count + threadIdx.x; r < nw; r += kWordThreads) {
      ha[r] = last_row[0];
      hb[r] = last_row[1];
      st[r] = last_row[2];
    }
  }
}

// ---------------------------------------------------------------------------
// wc_sort_runs
// ---------------------------------------------------------------------------

// One-sweep LSD radix sort (Adinets and Merrill, "Onesweep", 2022) of the
// key ha:hb, carrying start, in 8 passes of 8-bit digits: in a pass, each
// thread of a block owns one digit.

constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kPasses = 64 / kDigitBits;  // even: the sorted rows end in keys1/vals1
static_assert(kBins == kThreads, "a thread owns one digit");
// shared memory of a pass: the tile's keys and values in digit order, the
// warps' digit counts, the tile's local starts and global shifts
constexpr size_t kPassSmem = (size_t)kTile * 12 + sizeof(uint32_t) * (kWarps + 2) * kBins;
constexpr int kLook = 16;  // status words a look-back step reads at once

__device__ __forceinline__ uint32_t digit_of(uint64_t key, int shift) {
  return (uint32_t)(key >> shift) & (uint32_t)(kBins - 1);
}

// Every pass's digit counts from one read of the keys: block-private shared
// counts over kHistTiles tiles (each thread's kItems loads in flight at
// once), then one global atomic a nonzero bin.
constexpr int kHistTiles = 4;

__global__ void __launch_bounds__(kThreads)
sort_hist_kernel(const uint32_t* __restrict__ ha, const uint32_t* __restrict__ hb, int64_t n,
                 uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[kPasses * kBins];
  for (int i = threadIdx.x; i < kPasses * kBins; i += kThreads) h[i] = 0;
  __syncthreads();
  for (int t = 0; t < kHistTiles; ++t) {
    const int64_t base = ((int64_t)blockIdx.x * kHistTiles + t) * kTile + threadIdx.x;
    uint64_t key[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + k * kThreads;
      key[k] = i < n ? ((uint64_t)ha[i] << 32) | hb[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k * kThreads >= n) break;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) atomicAdd(&h[p * kBins + digit_of(key[k], p * kDigitBits)], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kBins; i += kThreads)
    if (h[i] != 0) atomicAdd(&hist[i], h[i]);
}

// A pass's look-back status word (status_store, status_load): the count in
// the low 32 bits, above it the pass's tag, 2 (pass + 1) for the tile's own
// count (an aggregate) and one more for its inclusive prefix; any other tag
// (0 after the memset, or an earlier pass's) is not yet written.

// One pass: the tile of the next ticket, ranked by digit stably (each warp
// ranks its 512 keys in order, then a scan over the warps and the digits),
// its digit counts published, each digit's global start found by decoupled
// look-back over the tiles before it, then the tile written from shared
// memory in digit order, so consecutive threads write consecutive places of
// one digit's run.  Pass 0 reads ha, hb and st (keys_in null).
__global__ void __launch_bounds__(kThreads, 2)
sort_pass_kernel(const uint32_t* __restrict__ ha, const uint32_t* __restrict__ hb,
                 const uint32_t* __restrict__ st, const uint64_t* __restrict__ keys_in,
                 const uint32_t* __restrict__ vals_in, int64_t n, int pass,
                 const uint32_t* __restrict__ hist, uint64_t* __restrict__ status,
                 uint32_t* __restrict__ ticket, uint64_t* __restrict__ keys_out,
                 uint32_t* __restrict__ vals_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* skeys = reinterpret_cast<uint64_t*>(smem);
  uint32_t* svals = reinterpret_cast<uint32_t*>(skeys + kTile);
  uint32_t* wcount = svals + kTile;  // [kWarps][kBins]: counts, then each warp's exclusive start
  uint32_t* lstart = wcount + kWarps * kBins;
  uint32_t* shift_s = lstart + kBins;  // global start minus local start, mod 2**32
  __shared__ uint32_t tile_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1u);
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) wcount[i] = 0;
  __syncthreads();
  const int64_t tile = tile_s;
  const int shift = pass * kDigitBits;
  const uint64_t tag = (uint64_t)(2 * pass + 2) << 32;

  const int64_t wbase = tile * kTile + (int64_t)warp * 32 * kItems;
  const uint32_t lower = (1u << lane) - 1u;
  uint64_t key[kItems];
  uint32_t val[kItems], rank[kItems];
  // every load in flight before the first is used
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = wbase + k * 32 + lane;
    key[k] = 0;
    val[k] = 0;
    if (i < n) {
      if (keys_in != nullptr) {
        key[k] = keys_in[i];
        val[k] = vals_in[i];
      } else {
        key[k] = ((uint64_t)ha[i] << 32) | hb[i];
        val[k] = st[i];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool live = wbase + k * 32 + lane < n;
    const uint32_t d = live ? digit_of(key[k], shift) : (uint32_t)kBins;
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    const uint32_t before = live ? wcount[warp * kBins + d] : 0u;
    rank[k] = before + __popc(peers & lower);
    __syncwarp();
    if (live && lane == __ffs(peers) - 1) wcount[warp * kBins + d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const int d = threadIdx.x;  // this thread's digit, up to the write
  uint32_t count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = wcount[w * kBins + d];
    wcount[w * kBins + d] = count;
    count += c;
  }
  if (tile > 0) status_store(&status[tile * kBins + d], tag | count);
  uint32_t total;
  const uint32_t local = block_exclusive(count, total);
  lstart[d] = local;
  // tile 0 takes the digits' global starts from the histogram
  uint32_t excl = tile == 0 ? block_exclusive(hist[pass * kBins + d], total) : 0u;
  __syncthreads();
  // the tile into shared memory in digit order before the look-back, so its
  // registers are free for the status words in flight
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (wbase + k * 32 + lane < n) {
      const uint32_t kd = digit_of(key[k], shift);
      const uint32_t at = lstart[kd] + wcount[warp * kBins + kd] + rank[k];
      skeys[at] = key[k];
      svals[at] = val[k];
    }
  }
  if (tile > 0) {
    // kLook predecessors a round trip, nearest first: aggregates add up
    // until an inclusive prefix ends the walk; one not written yet is read
    // again
    for (int64_t p = tile - 1;;) {
      uint64_t v[kLook];
#pragma unroll
      for (int j = 0; j < kLook; ++j) v[j] = p >= j ? status_load(&status[(p - j) * kBins + d]) : 0;
      int j = 0;
      bool done = false;
      for (; j < kLook && p >= j; ++j) {
        const uint64_t t = v[j] >> 32;
        if ((t >> 1) != (uint64_t)pass + 1) break;
        excl += (uint32_t)v[j];
        if (t & 1) {
          done = true;
          break;
        }
      }
      if (done) break;
      p -= j;
    }
  }
  status_store(&status[tile * kBins + d], tag | (1ull << 32) | (uint32_t)(excl + count));
  shift_s[d] = excl - local;
  __syncthreads();
  const int64_t rows = n - tile * kTile < kTile ? n - tile * kTile : kTile;
  for (int j = threadIdx.x; j < rows; j += kThreads) {
    const uint64_t k = skeys[j];
    const uint32_t at = shift_s[digit_of(k, shift)] + (uint32_t)j;
    keys_out[at] = k;
    vals_out[at] = svals[j];
  }
}

// The status words, digit counts and tickets of a sort of n rows: one
// zeroed region, status first.
size_t sort_region_bytes(int64_t n) {
  return (size_t)tiles_of(n) * kBins * 8 + (size_t)kPasses * (kBins + 1) * 4;
}

// Raise the pass kernel's dynamic shared-memory limit once per device.
cudaError_t allow_pass_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed))) return err;
  err = cudaFuncSetAttribute(sort_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kPassSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_relaxed);
  return err;
}

// Run starts of one tile, read coalesced: element base + k * kThreads + t
// of thread t, so a tile's rows go in the order (k, warp, lane).
__device__ __forceinline__ bool run_start(const uint64_t* __restrict__ keys, int64_t n, int64_t i) {
  return i < n && (i == 0 || keys[i] != keys[i - 1]);
}

__global__ void __launch_bounds__(kThreads)
runs_count_kernel(const uint64_t* __restrict__ keys, int64_t n, uint32_t* __restrict__ tile_counts) {
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) c += run_start(keys, n, base + k * kThreads);
  uint32_t total;
  block_exclusive(c, total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// tile_off[t]: run starts before tile t; tile_off[tiles]: all of them (D).
// A run start i of rank r goes to row r as (i, start); a row i with r run
// starts before it goes to row D + i - r as (0x7FFFFFFF, start).
__global__ void __launch_bounds__(kThreads)
runs_write_kernel(const uint64_t* __restrict__ keys, const uint32_t* __restrict__ vals, int64_t n,
                  const uint32_t* __restrict__ tile_off, int64_t tiles, int64_t d_out,
                  int32_t* __restrict__ fp, int32_t* __restrict__ off) {
  static_assert(kItems * kWarps == 4 * 32, "one warp scans the counts, 4 a lane");
  __shared__ uint32_t before[kItems * kWarps];  // run starts before each (round, warp), in the tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  uint32_t mask[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    mask[k] = __ballot_sync(0xffffffffu, run_start(keys, n, base + k * kThreads));
    if (lane == 0) before[k * kWarps + warp] = __popc(mask[k]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the kItems * kWarps counts, 4 a lane
    uint32_t v[4], s = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) s += v[j] = before[lane * 4 + j];
    uint32_t pre = warp_inclusive(s) - s;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      before[lane * 4 + j] = pre;
      pre += v[j];
    }
  }
  __syncthreads();
  const int64_t runs = tile_off[tiles];
  const uint32_t lower = (1u << lane) - 1u, t0 = tile_off[blockIdx.x];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * kThreads;
    if (i >= n) break;
    const bool first = (mask[k] >> lane) & 1u;
    const int64_t r = t0 + before[k * kWarps + warp] + __popc(mask[k] & lower);
    const int64_t row = first ? r : runs + i - r;
    if (row < d_out) {
      fp[row] = first ? (int32_t)i : kBig;
      off[row] = (int32_t)vals[i];
    }
  }
}

}  // namespace

// 64-bit words of the region rtpu_wc_words_auto takes for n bytes at any
// alignment: the ticket, then a look-back status word a tile.
extern "C" int64_t rtpu_wc_words_region_words(int64_t n) { return 1 + word_tiles(n, 15); }

// wc_extract_words_auto: `rows` output rows of ha, hb, start (uint32 bits),
// one launch.  1 <= n < 2**31, 0 <= rows <= n.  region: at least
// rtpu_wc_words_region_words(n) words, zero when first used, which the calls
// of one stream share; tag: in [1, 2**31), a different one each call since
// the region was zeroed (every call leaves the ticket at 0).
extern "C" int rtpu_wc_words_auto(const void* buf, int64_t n, int rows, int n_words, int64_t base, void* region,
                                  int64_t tag, void* ha, void* hb, void* st, void* stream) {
  if (n < 1 || n >= (int64_t{1} << 31) || rows < 0 || rows > n || tag < 1 || tag >= (int64_t{1} << 31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  const int64_t tiles = word_tiles(n, (int)(reinterpret_cast<uintptr_t>(buf) & 15));
  auto words = static_cast<uint64_t*>(region);
  const uint32_t call_tag = static_cast<uint32_t>(tag);
  auto ha_ = static_cast<uint32_t*>(ha), hb_ = static_cast<uint32_t*>(hb), st_ = static_cast<uint32_t*>(st);
  const bool vec_rows = ((reinterpret_cast<uintptr_t>(ha) | reinterpret_cast<uintptr_t>(hb) |
                          reinterpret_cast<uintptr_t>(st)) & 15) == 0;
  words_auto_kernel<<<(unsigned)tiles, kWordThreads, 0, s>>>(b, n, rows, n_words, (uint32_t)base, tiles, call_tag,
                                                              reinterpret_cast<uint32_t*>(words), words + 1, ha_,
                                                              hb_, st_, vec_rows);
  return (int)cudaGetLastError();
}

// wc_extract_words: the ends are the inclusive sums of the deltas, minus 1.
// Scratch tiles_of(rows) + 1 words, ends rows + 1 int32 (the scan's output).
// 1 <= n < 2**31.  Four launches: a three-launch scan, then the words.
extern "C" int rtpu_wc_words_deltas(const void* buf, int64_t n, const void* deltas, int rows, int n_words,
                                    int64_t base, void* scratch, void* ends, void* ha, void* hb, void* st,
                                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto e = static_cast<int32_t*>(ends);
  cudaError_t err = scan_exclusive(static_cast<const uint32_t*>(deltas), reinterpret_cast<uint32_t*>(e), rows,
                                   static_cast<uint32_t*>(scratch), s);
  if (err != cudaSuccess || rows == 0) return (int)err;
  words_kernel<<<row_blocks(rows), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(buf), n, e + 1, rows, n_words, (uint32_t)base, static_cast<uint32_t*>(ha),
      static_cast<uint32_t*>(hb), static_cast<uint32_t*>(st));
  return (int)cudaGetLastError();
}

// Bytes of rtpu_wc_sort_runs' zeroed region for n rows.
extern "C" int64_t rtpu_wc_sort_region_bytes(int64_t n) { return (int64_t)sort_region_bytes(n); }

// wc_sort_runs over 1 <= n < 2**31 rows into out = (2, d_out) int32, d_out
// <= n.  Scratch: keys0 and keys1 n uint64, vals0 and vals1 n uint32,
// region rtpu_wc_sort_region_bytes(n) bytes (8-byte aligned), scan
// tiles_of(n) + 1 words.  A memset of the region, the histogram, kPasses
// passes, then the run count, scan and partition.
extern "C" int rtpu_wc_sort_runs(const void* ha, const void* hb, const void* st, int64_t n, int64_t d_out,
                                 void* keys0, void* vals0, void* keys1, void* vals1, void* region,
                                 void* scan, void* out, void* stream) {
  if (n < 1 || n >= (int64_t{1} << 31) || d_out < 0 || d_out > n) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(n);
  uint64_t* k[2] = {static_cast<uint64_t*>(keys0), static_cast<uint64_t*>(keys1)};
  uint32_t* v[2] = {static_cast<uint32_t*>(vals0), static_cast<uint32_t*>(vals1)};
  auto status = static_cast<uint64_t*>(region);
  auto hist = reinterpret_cast<uint32_t*>(status + tiles * kBins);
  uint32_t* tickets = hist + kPasses * kBins;
  cudaError_t err = cudaMemsetAsync(region, 0, sort_region_bytes(n), s);
  if (err == cudaSuccess) err = allow_pass_smem();
  if (err != cudaSuccess) return (int)err;
  const auto a = static_cast<const uint32_t*>(ha);
  const auto b = static_cast<const uint32_t*>(hb);
  const auto t = static_cast<const uint32_t*>(st);
  sort_hist_kernel<<<(unsigned)((tiles + kHistTiles - 1) / kHistTiles), kThreads, 0, s>>>(a, b, n, hist);
  for (int p = 0; p < kPasses; ++p) {
    const uint64_t* kin = p == 0 ? nullptr : k[(p - 1) & 1];
    const uint32_t* vin = p == 0 ? nullptr : v[(p - 1) & 1];
    sort_pass_kernel<<<(unsigned)tiles, kThreads, kPassSmem, s>>>(a, b, t, kin, vin, n, p, hist, status,
                                                                  tickets + p, k[p & 1], v[p & 1]);
  }
  const auto sc = static_cast<uint32_t*>(scan);
  runs_count_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(k[1], n, sc);
  scan_single_kernel<<<1, kThreads, 0, s>>>(sc, tiles, nullptr);
  auto o = static_cast<int32_t*>(out);
  runs_write_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(k[1], v[1], n, sc, tiles, d_out, o, o + d_out);
  return (int)cudaGetLastError();
}
