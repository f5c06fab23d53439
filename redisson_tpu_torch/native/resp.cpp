// rtpu native runtime: the full wire plane — RESP2/RESP3 frame tokenizer,
// reply/command encoder, LZ4 block codec, CRC16 slot hashing.
//
// Role parity: the reference's hot wire path is Netty's CommandEncoder /
// CommandDecoder (client/handler/CommandDecoder.java:58-270 — a
// ReplayingDecoder over RESP2+RESP3 markers `_ , + - : $ = % * > ~ # |`),
// LZ4 via lz4-java JNI (codec/LZ4Codec.java), and connection/CRC16.java for
// cluster slot routing.  Here the same roles are native C++ behind a C ABI
// consumed via ctypes (no pybind11 in the image):
//
//   * rtpu_resp_scan: zero-copy tokenizer — scans a byte buffer and emits a
//     flat token stream (type, int payload, byte offset/length into the
//     caller's buffer) for as many COMPLETE top-level values as present.
//     Incomplete trailing values are left unconsumed (the ReplayingDecoder
//     checkpoint discipline), so callers just retain the tail.
//   * rtpu_encode_reply: iterative RESP emitter — consumes a flat op stream
//     (parallel ops/vals/offs arrays + one byte pool, built by
//     net/resp.py's flattener) and writes the whole frame into one caller
//     arena: no per-value allocation, no %-formatting, no join.
//   * rtpu_lz4_compress / rtpu_lz4_decompress: LZ4 *block* codec
//     byte-compatible with utils/lz4block.py (token nibbles, 255-run
//     extended lengths, LE16 match offsets, 12/5-byte end rules) — either
//     side's output decodes on the other.
//   * rtpu_crc16 / rtpu_calc_slots: CCITT CRC16 with {hashtag} extraction,
//     batched over N keys per call.
//
// Python reconstructs nested values from the token stream (net/resp.py); the
// byte scanning and emission — the actual per-command overhead — stay native.

#include <cstdint>
#include <cstring>

extern "C" {

struct RtpuToken {
  int32_t type;   // token kind, see constants below
  int32_t flags;  // reserved
  int64_t val;    // int payload (INT/BOOL) or element count / byte length
  uint64_t off;   // payload byte offset into the scanned buffer
};

enum {
  RTPU_SIMPLE = 1,   // +line         -> off/val = text
  RTPU_ERROR = 2,    // -line         -> off/val = text
  RTPU_INT = 3,      // :n  (n        -> val
  RTPU_BULK = 4,     // $n / =n       -> off/val = payload
  RTPU_NULL = 5,     // _  / $-1 / *-1
  RTPU_ARRAY = 6,    // *n            -> val = n
  RTPU_MAP = 7,      // %n            -> val = n pairs
  RTPU_SET = 8,      // ~n            -> val = n
  RTPU_DOUBLE = 9,   // ,text         -> off/val = text
  RTPU_BOOL = 10,    // #t/#f         -> val
  RTPU_PUSH = 11,    // >n            -> val = n
  RTPU_ATTR = 12,    // |n            -> val = n pairs (precedes a value)
  RTPU_BIGNUM = 13,  // :n / (n beyond int64 -> off/val = decimal text
};

namespace {

struct Scanner {
  const uint8_t* buf;
  uint64_t len;
  uint64_t pos;
  RtpuToken* toks;
  uint64_t ntok;
  uint64_t max_toks;
  bool overflow;  // token buffer exhausted mid-value
  bool bad;       // protocol violation
};

inline bool emit(Scanner& s, int32_t type, int64_t val, uint64_t off) {
  if (s.ntok >= s.max_toks) {
    s.overflow = true;
    return false;
  }
  RtpuToken& t = s.toks[s.ntok++];
  t.type = type;
  t.flags = 0;
  t.val = val;
  t.off = off;
  return true;
}

// find index just past "\r\n" starting at from; 0 if not found
inline uint64_t find_crlf(const Scanner& s, uint64_t from, uint64_t* text_end) {
  const uint8_t* p =
      (const uint8_t*)memchr(s.buf + from, '\r', s.len - from);
  while (p) {
    uint64_t i = (uint64_t)(p - s.buf);
    if (i + 1 >= s.len) return 0;
    if (s.buf[i + 1] == '\n') {
      *text_end = i;
      return i + 2;
    }
    p = (const uint8_t*)memchr(s.buf + i + 1, '\r', s.len - i - 1);
  }
  return 0;
}

// 0 = ok, 1 = malformed, 2 = valid digits but outside int64 (big number)
inline int parse_i64s(const uint8_t* p, uint64_t n, int64_t* out) {
  if (n == 0) return 1;
  bool neg = false;
  uint64_t i = 0;
  if (p[0] == '-') { neg = true; i = 1; if (n == 1) return 1; }
  else if (p[0] == '+') { i = 1; if (n == 1) return 1; }
  uint64_t v = 0;
  for (; i < n; i++) {
    if (p[i] < '0' || p[i] > '9') return 1;
    uint64_t d = (uint64_t)(p[i] - '0');
    if (v > (0xFFFFFFFFFFFFFFFFull - d) / 10) return 2;
    v = v * 10 + d;
  }
  if (neg) {
    if (v > (uint64_t)1 << 63) return 2;
    *out = (int64_t)(0 - v);
  } else {
    if (v > 0x7FFFFFFFFFFFFFFFull) return 2;
    *out = (int64_t)v;
  }
  return 0;
}

inline bool parse_i64(const uint8_t* p, uint64_t n, int64_t* out) {
  return parse_i64s(p, n, out) == 0;
}

bool parse_value(Scanner& s) {
  if (s.pos >= s.len) return false;
  uint8_t t = s.buf[s.pos];
  uint64_t text_end;
  uint64_t next = find_crlf(s, s.pos + 1, &text_end);
  if (next == 0) return false;
  uint64_t loff = s.pos + 1;
  uint64_t llen = text_end - loff;
  switch (t) {
    case '+':
      if (!emit(s, RTPU_SIMPLE, (int64_t)llen, loff)) return false;
      s.pos = next;
      return true;
    case '-':
      if (!emit(s, RTPU_ERROR, (int64_t)llen, loff)) return false;
      s.pos = next;
      return true;
    case ':':
    case '(': {  // big number (`(`): int64 fast path, text token beyond it
      int64_t v;
      int st = parse_i64s(s.buf + loff, llen, &v);
      if (st == 1) { s.bad = true; return false; }
      if (st == 2) {
        // outside int64: hand the decimal text to Python (arbitrary
        // precision there) instead of silently wrapping
        if (!emit(s, RTPU_BIGNUM, (int64_t)llen, loff)) return false;
      } else {
        if (!emit(s, RTPU_INT, v, loff)) return false;
      }
      s.pos = next;
      return true;
    }
    case '#':
      if (llen != 1 || (s.buf[loff] != 't' && s.buf[loff] != 'f')) {
        s.bad = true;
        return false;
      }
      if (!emit(s, RTPU_BOOL, s.buf[loff] == 't' ? 1 : 0, loff)) return false;
      s.pos = next;
      return true;
    case ',':
      if (!emit(s, RTPU_DOUBLE, (int64_t)llen, loff)) return false;
      s.pos = next;
      return true;
    case '_':
      if (!emit(s, RTPU_NULL, 0, loff)) return false;
      s.pos = next;
      return true;
    case '$':
    case '=': {
      int64_t n;
      if (!parse_i64(s.buf + loff, llen, &n)) { s.bad = true; return false; }
      if (n == -1) {
        if (!emit(s, RTPU_NULL, 0, loff)) return false;
        s.pos = next;
        return true;
      }
      if (n < 0) { s.bad = true; return false; }
      if (next + (uint64_t)n + 2 > s.len) return false;  // incomplete
      if (s.buf[next + n] != '\r' || s.buf[next + n + 1] != '\n') {
        s.bad = true;
        return false;
      }
      if (!emit(s, RTPU_BULK, n, next)) return false;
      s.pos = next + n + 2;
      return true;
    }
    case '*':
    case '~':
    case '>':
    case '%': {
      int64_t n;
      if (!parse_i64(s.buf + loff, llen, &n)) { s.bad = true; return false; }
      if (n == -1) {
        if (!emit(s, RTPU_NULL, 0, loff)) return false;
        s.pos = next;
        return true;
      }
      if (n < 0) { s.bad = true; return false; }
      int32_t type = t == '*' ? RTPU_ARRAY
                   : t == '~' ? RTPU_SET
                   : t == '>' ? RTPU_PUSH
                              : RTPU_MAP;
      if (!emit(s, type, n, loff)) return false;
      s.pos = next;
      int64_t count = (t == '%') ? 2 * n : n;
      for (int64_t i = 0; i < count; i++) {
        if (!parse_value(s)) return false;
      }
      return true;
    }
    case '|': {  // RESP3 attribute: n pairs, then the value they decorate
      int64_t n;
      if (parse_i64s(s.buf + loff, llen, &n) != 0 || n < 0) {
        s.bad = true;
        return false;
      }
      if (!emit(s, RTPU_ATTR, n, loff)) return false;
      s.pos = next;
      for (int64_t i = 0; i < 2 * n; i++) {
        if (!parse_value(s)) return false;
      }
      return parse_value(s);
    }
    default:
      s.bad = true;
      return false;
  }
}

}  // namespace

// Scan as many complete top-level RESP values as present in buf[0:len).
// Returns: number of complete values (>=0), -1 on protocol error, or -2 when
// the token buffer overflowed before ANY value committed (caller must grow
// max_toks and rescan — a single value can hold arbitrarily many elements).
// *ntok_out = tokens written, *consumed_out = bytes consumed (always a
// complete-value boundary).
int64_t rtpu_resp_scan(const uint8_t* buf, uint64_t len, RtpuToken* toks,
                       uint64_t max_toks, uint64_t* ntok_out,
                       uint64_t* consumed_out) {
  Scanner s{buf, len, 0, toks, 0, max_toks, false, false};
  int64_t values = 0;
  uint64_t committed_pos = 0, committed_tok = 0;
  while (s.pos < s.len) {
    if (!parse_value(s)) {
      if (s.bad) return -1;
      break;  // incomplete or token overflow: roll back to last commit
    }
    values++;
    committed_pos = s.pos;
    committed_tok = s.ntok;
  }
  *ntok_out = committed_tok;
  *consumed_out = committed_pos;
  if (values == 0 && s.overflow) return -2;
  return values;
}

// ---------------------------------------------------------------------------
// Reply/command encoder — CommandEncoder.java parity (the write half of the
// wire).  net/resp.py flattens a Python value tree into three parallel
// arrays (op|marker<<8, int payload, pool offset) plus one contiguous byte
// pool; this emitter walks them once and writes the finished RESP frame
// into the caller's arena.  All proto-2/proto-3 projection decisions are
// made by the flattener, so the emitter is protocol-agnostic.
// ---------------------------------------------------------------------------

enum {
  RTPU_E_BULK = 1,     // $<val>\r\n<pool[off:off+val]>\r\n
  RTPU_E_LINE = 2,     // <marker><pool[off:off+val]>\r\n   (+ - , : text)
  RTPU_E_NUM = 3,      // <marker><val as decimal>\r\n      (: * % ~ >)
  RTPU_E_LIT = 4,      // static literal #val (see kLits)
  RTPU_E_NUMBULK = 5,  // $<ndigits>\r\n<val as decimal>\r\n (int command arg)
  // homogeneous-run ops: one token covers a whole array body, so Python
  // pays O(1) description work for the two dominant reply shapes
  RTPU_E_INTRUN = 6,   // val ints, native-endian i64 at pool[off:] -> :n\r\n each
  RTPU_E_BULKRUN = 7,  // val bulks: i64 lens at pool[off:], payloads after
};

namespace {

inline uint64_t write_u64(uint8_t* p, uint64_t v) {
  char tmp[20];
  int i = 0;
  do {
    tmp[i++] = (char)('0' + v % 10);
    v /= 10;
  } while (v);
  for (int j = 0; j < i; j++) p[j] = (uint8_t)tmp[i - 1 - j];
  return (uint64_t)i;
}

inline uint64_t write_i64(uint8_t* p, int64_t v) {
  uint64_t n = 0;
  uint64_t u;
  if (v < 0) {
    p[0] = '-';
    n = 1;
    u = (uint64_t)(-(v + 1)) + 1;  // avoids UB at INT64_MIN
  } else {
    u = (uint64_t)v;
  }
  return n + write_u64(p + n, u);
}

const char* kLits[] = {"_\r\n", "$-1\r\n", "#t\r\n", "#f\r\n"};
const uint64_t kLitLens[] = {3, 5, 4, 4};

}  // namespace

// Emit `n` flattened tokens into out[0:out_cap).  Returns bytes written,
// -1 when the arena is too small (caller grows and retries), -2 on an
// unknown op (flattener bug).
int64_t rtpu_encode_reply(const int32_t* ops, const int64_t* vals,
                          const int64_t* offs, uint64_t n,
                          const uint8_t* pool, uint8_t* out,
                          uint64_t out_cap) {
  uint8_t* p = out;
  uint8_t* end = out + out_cap;
  for (uint64_t i = 0; i < n; i++) {
    int32_t op = ops[i] & 0xFF;
    uint8_t marker = (uint8_t)((ops[i] >> 8) & 0xFF);
    int64_t val = vals[i];
    int64_t off = offs[i];
    switch (op) {
      case RTPU_E_BULK: {
        if (p + 25 + val > end) return -1;
        *p++ = '$';
        p += write_u64(p, (uint64_t)val);
        *p++ = '\r';
        *p++ = '\n';
        memcpy(p, pool + off, (size_t)val);
        p += val;
        *p++ = '\r';
        *p++ = '\n';
        break;
      }
      case RTPU_E_LINE: {
        if (p + 3 + val > end) return -1;
        *p++ = marker;
        memcpy(p, pool + off, (size_t)val);
        p += val;
        *p++ = '\r';
        *p++ = '\n';
        break;
      }
      case RTPU_E_NUM: {
        if (p + 24 > end) return -1;
        *p++ = marker;
        p += write_i64(p, val);
        *p++ = '\r';
        *p++ = '\n';
        break;
      }
      case RTPU_E_LIT: {
        if (val < 0 || val > 3) return -2;  // flattener bug, not arena size
        if (p + 5 > end) return -1;
        memcpy(p, kLits[val], (size_t)kLitLens[val]);
        p += kLitLens[val];
        break;
      }
      case RTPU_E_NUMBULK: {
        uint8_t digits[21];
        uint64_t dl = write_i64(digits, val);
        if (p + 27 > end) return -1;
        *p++ = '$';
        p += write_u64(p, dl);
        *p++ = '\r';
        *p++ = '\n';
        memcpy(p, digits, (size_t)dl);
        p += dl;
        *p++ = '\r';
        *p++ = '\n';
        break;
      }
      case RTPU_E_INTRUN: {
        const uint8_t* q = pool + off;
        for (int64_t k = 0; k < val; k++) {
          if (p + 24 > end) return -1;
          int64_t v;
          memcpy(&v, q + 8 * k, 8);
          *p++ = ':';
          p += write_i64(p, v);
          *p++ = '\r';
          *p++ = '\n';
        }
        break;
      }
      case RTPU_E_BULKRUN: {
        const uint8_t* lens = pool + off;
        const uint8_t* q = lens + 8 * val;
        for (int64_t k = 0; k < val; k++) {
          int64_t len;
          memcpy(&len, lens + 8 * k, 8);
          if (p + 25 + len > end) return -1;
          *p++ = '$';
          p += write_u64(p, (uint64_t)len);
          *p++ = '\r';
          *p++ = '\n';
          memcpy(p, q, (size_t)len);
          p += len;
          q += len;
          *p++ = '\r';
          *p++ = '\n';
        }
        break;
      }
      default:
        return -2;
    }
  }
  return (int64_t)(p - out);
}

// ---------------------------------------------------------------------------
// LZ4 block codec — codec/LZ4Codec.java parity (lz4-java JNI in the
// reference).  Byte-compatible with utils/lz4block.py: greedy match search,
// token nibbles, 255-run extended lengths, little-endian 2-byte offsets,
// literals-only final sequence, the 12/5-byte end-of-block match rules.
// Either implementation's output decodes on the other (the hash strategies
// differ — a 16-bit multiplicative table here vs an exact dict in Python —
// so compressed bytes may differ; decompressed bytes never do).
// ---------------------------------------------------------------------------

namespace {

inline uint32_t lz4_hash(uint32_t seq) { return (seq * 2654435761u) >> 16; }

}  // namespace

// Returns compressed size, -1 when out_cap is too small (callers size the
// arena to the n + n/255 + 16 worst case so this never fires in practice),
// -3 for inputs beyond 2GB (Python fallback handles those).
int64_t rtpu_lz4_compress(const uint8_t* src, uint64_t n, uint8_t* out,
                          uint64_t out_cap) {
  if (n == 0) {
    if (out_cap < 1) return -1;
    out[0] = 0;  // one empty-literal token: a valid empty block
    return 1;
  }
  if (n > 0x7FFFFFFFull) return -3;
  static thread_local int32_t table[1 << 16];
  memset(table, 0xFF, sizeof(table));  // every entry -1
  uint8_t* p = out;
  uint8_t* oend = out + out_cap;
  uint64_t anchor = 0, i = 0;
  int64_t limit = (int64_t)n - 12;  // no match starts in the last 12 bytes
  while ((int64_t)i < limit) {
    uint32_t seq;
    memcpy(&seq, src + i, 4);
    uint32_t h = lz4_hash(seq);
    int64_t cand = table[h];
    table[h] = (int32_t)i;
    uint32_t cseq = 0;
    if (cand >= 0) memcpy(&cseq, src + cand, 4);
    if (cand < 0 || i - (uint64_t)cand > 0xFFFF || cseq != seq) {
      i++;
      continue;
    }
    uint64_t m = i + 4, c = (uint64_t)cand + 4;
    uint64_t mend = n - 5;  // last 5 bytes are always literals
    while (m < mend && src[m] == src[c]) {
      m++;
      c++;
    }
    uint64_t ll = i - anchor;
    uint64_t ml = (m - i) - 4;
    if (p + 1 + ll / 255 + 1 + ll + 2 + ml / 255 + 1 > oend) return -1;
    *p++ = (uint8_t)(((ll < 15 ? ll : 15) << 4) | (ml < 15 ? ml : 15));
    if (ll >= 15) {
      uint64_t v = ll - 15;
      while (v >= 255) {
        *p++ = 255;
        v -= 255;
      }
      *p++ = (uint8_t)v;
    }
    memcpy(p, src + anchor, (size_t)ll);
    p += ll;
    uint64_t offset = i - (uint64_t)cand;
    *p++ = (uint8_t)(offset & 0xFF);
    *p++ = (uint8_t)(offset >> 8);
    if (ml >= 15) {
      uint64_t v = ml - 15;
      while (v >= 255) {
        *p++ = 255;
        v -= 255;
      }
      *p++ = (uint8_t)v;
    }
    anchor = i = m;
  }
  uint64_t ll = n - anchor;
  if (p + 1 + ll / 255 + 1 + ll > oend) return -1;
  if (ll >= 15) {
    *p++ = 0xF0;
    uint64_t v = ll - 15;
    while (v >= 255) {
      *p++ = 255;
      v -= 255;
    }
    *p++ = (uint8_t)v;
  } else {
    *p++ = (uint8_t)(ll << 4);
  }
  memcpy(p, src + anchor, (size_t)ll);
  p += ll;
  return (int64_t)(p - out);
}

// Returns 0 on success (*produced == expected), -1 on malformed input,
// -2 on a size mismatch against the frame's declared uncompressed length.
int64_t rtpu_lz4_decompress(const uint8_t* src, uint64_t n, uint8_t* out,
                            uint64_t expected, uint64_t* produced) {
  uint64_t i = 0, o = 0;
  *produced = 0;
  while (i < n) {
    uint8_t token = src[i++];
    uint64_t ll = token >> 4;
    if (ll == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = src[i++];
        ll += b;
      } while (b == 255);
    }
    if (i + ll > n) return -1;       // truncated literals
    if (o + ll > expected) return -2;
    memcpy(out + o, src + i, (size_t)ll);
    o += ll;
    i += ll;
    if (i >= n) break;  // final sequence has no match part
    if (i + 2 > n) return -1;
    uint64_t offset = (uint64_t)src[i] | ((uint64_t)src[i + 1] << 8);
    i += 2;
    if (offset == 0 || offset > o) return -1;  // bad match offset
    uint64_t ml = token & 0xF;
    if (ml == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = src[i++];
        ml += b;
      } while (b == 255);
    }
    ml += 4;
    if (o + ml > expected) return -2;
    uint64_t start = o - offset;
    if (offset >= ml) {
      memcpy(out + o, out + start, (size_t)ml);
    } else {
      // overlapping copy (RLE-style): byte-at-a-time semantics
      for (uint64_t k = 0; k < ml; k++) out[o + k] = out[start + k];
    }
    o += ml;
  }
  *produced = o;
  return o == expected ? 0 : -2;
}

// ---------------------------------------------------------------------------
// CRC16 (CCITT/XModem), table-driven — connection/CRC16.java parity.
// ---------------------------------------------------------------------------

static uint16_t g_crc_table[256];
static bool g_crc_init = false;

static void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i << 8;
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x8000) ? ((crc << 1) ^ 0x1021) : (crc << 1);
    g_crc_table[i] = (uint16_t)(crc & 0xFFFF);
  }
  g_crc_init = true;
}

uint16_t rtpu_crc16(const uint8_t* data, uint64_t len) {
  if (!g_crc_init) crc_init();
  uint16_t crc = 0;
  for (uint64_t i = 0; i < len; i++)
    crc = (uint16_t)(((crc << 8) & 0xFFFF) ^
                     g_crc_table[((crc >> 8) ^ data[i]) & 0xFF]);
  return crc;
}

// Batched slot calc with {hashtag} extraction (Redis cluster rules):
// slot = crc16(hashtag(key)) % 16384.
void rtpu_calc_slots(const uint8_t* buf, const uint64_t* offs,
                     const uint64_t* lens, uint64_t n, uint16_t* out) {
  if (!g_crc_init) crc_init();
  for (uint64_t i = 0; i < n; i++) {
    const uint8_t* key = buf + offs[i];
    uint64_t len = lens[i];
    const uint8_t* h = (const uint8_t*)memchr(key, '{', len);
    if (h) {
      uint64_t start = (uint64_t)(h - key) + 1;
      const uint8_t* e = (const uint8_t*)memchr(key + start, '}', len - start);
      if (e && (uint64_t)(e - key) > start) {
        key = key + start;
        len = (uint64_t)(e - (key));
      }
    }
    out[i] = rtpu_crc16(key, len) % 16384;
  }
}

}  // extern "C"
