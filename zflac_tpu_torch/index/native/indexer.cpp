// Native host frame indexer: the serial phase-1 bitstream scan of the
// two-phase TPU decode (SURVEY.md §7).
//
// Walks a FLAC (RFC 9639) stream once and emits the dense decode plan
// (same schema as plan.StreamPlan): warmup-seeded residual rows,
// predictor descriptors, frame geometry. Semantics mirror the reference
// decoder (the reference's src/zflac.zig:217-666) (see py_indexer.py for
// the executable spec this is differential-tested against), with CRC-8/
// CRC-16 verification as an extension (the reference reads but never
// checks them, zflac.zig:407-410, 548-551).
//
// Build: g++ -O3 -shared -fPIC -o libzflac_index.so indexer.cpp
// C ABI, consumed from Python via ctypes (native_indexer.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <cstdio>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Worker-count override for experiments / constrained hosts
// (ZFI_THREADS), and an env-gated stage profiler (ZFI_PROF=1 prints
// per-phase wall times of the parallel engine to stderr).
static unsigned engine_threads() {
  unsigned T = std::thread::hardware_concurrency();
  if (const char* e = std::getenv("ZFI_THREADS")) {
    int v = std::atoi(e);
    if (v > 0) T = (unsigned)v;
  }
  return T;
}

static bool prof_enabled() {
  static int on = [] {
    const char* e = std::getenv("ZFI_PROF");
    return (e && e[0] && e[0] != '0') ? 1 : 0;
  }();
  return on != 0;
}

using ProfClock = std::chrono::steady_clock;
static double prof_ms(ProfClock::time_point a, ProfClock::time_point b) {
  return std::chrono::duration<double, std::milli>(b - a).count();
}
static int64_t elapsed_ns(ProfClock::time_point a, ProfClock::time_point b) {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(b - a).count();
}

// ---- error codes (must match native_indexer.py ERROR_MAP) ----
enum ErrCode : int {
  OK = 0,
  E_INVALID_SIGNATURE = 1,
  E_INVALID_METADATA_HEADER = 2,
  E_MISSING_STREAMINFO = 3,
  E_INVALID_FRAME_HEADER = 4,
  E_INCONSISTENT_PARAMETERS = 5,
  E_INVALID_SUBFRAME_HEADER = 6,
  E_INVALID_RESIDUAL_CODING_METHOD = 7,
  E_INVALID_CODED_NUMBER = 8,
  E_INVALID_CHECKSUM = 9,
  E_END_OF_STREAM = 10,
  E_UNIMPLEMENTED = 11,
  // Pack2 fast path declined (caller falls back to the general engine).
  E_PACK2_FALLBACK = 101,
};

struct Thrown { int code; };
static void fail(int code) { throw Thrown{code}; }

// ---- scoped trace logging ----
// Mirrors utils/log.py and the reference's four std.log scopes
// (the reference's src/zflac.zig:5-8): ZFLAC_TPU_LOG=stream,frame,
// subframe,residual (or "all") enables the corresponding per-stream /
// per-frame / per-subframe / per-partition lines on stderr. One
// predictable branch per site when disabled.
struct TraceCfg {
  bool stream = false, frame = false, subframe = false, residual = false;
  TraceCfg() {
    const char* e = std::getenv("ZFLAC_TPU_LOG");
    if (!e) return;
    std::string s(e);
    size_t pos = 0;
    while (pos <= s.size()) {
      size_t c = s.find(',', pos);
      if (c == std::string::npos) c = s.size();
      std::string tok = s.substr(pos, c - pos);
      if (tok == "all") stream = frame = subframe = residual = true;
      else if (tok == "stream") stream = true;
      else if (tok == "frame") frame = true;
      else if (tok == "subframe") subframe = true;
      else if (tok == "residual") residual = true;
      pos = c + 1;
    }
  }
};
static const TraceCfg g_trace;
#define ZTRACE(scope, ...)                                       \
  do {                                                           \
    if (g_trace.scope) {                                         \
      std::fprintf(stderr, "zflac_tpu.%s: ", #scope);            \
      std::fprintf(stderr, __VA_ARGS__);                         \
      std::fputc('\n', stderr);                                  \
    }                                                            \
  } while (0)

// ---- MSB-first bit reader over an in-memory buffer ----
// Same semantics as the reference's BitReader
// (the reference's src/bit_reader.zig) addressed by absolute bit
// position; 64-bit refill windows.
struct BitReader {
  const uint8_t* buf;
  size_t len;            // bytes
  uint64_t pos;          // absolute bit position (bits consumed)
  uint64_t cache = 0;    // next bits, MSB-aligned
  unsigned cache_bits = 0;

  uint64_t nbits() const { return (uint64_t)len * 8; }

  inline uint64_t peek_word(uint64_t bit) const {
    // 64-bit big-endian window starting at `bit`; bits past the buffer
    // read as zero (EOF is enforced by the pos checks, not the loads).
    size_t byte = (size_t)(bit >> 3);
    uint64_t w = 0;
    if (byte + 8 <= len) {
      std::memcpy(&w, buf + byte, 8);
      w = __builtin_bswap64(w);
    } else {
      for (size_t i = 0; i < 8; i++) {
        w = (w << 8) | (byte + i < len ? buf[byte + i] : 0);
      }
    }
    return w << (bit & 7);
  }

  inline void refill() {
    // Top up the cache (bits past EOF read as zero; EOF is enforced by
    // the pos checks). peek_word only yields 64-(at&7) valid top bits.
    uint64_t at = pos + cache_bits;
    unsigned valid = 64 - (unsigned)(at & 7);
    cache |= peek_word(at) >> cache_bits;
    unsigned nb = cache_bits + valid;
    cache_bits = nb > 64 ? 64 : nb;
  }

  inline void seek(uint64_t p) {
    pos = p;
    cache = 0;
    cache_bits = 0;
  }

  inline uint64_t read_bits(unsigned n) {  // n <= 57
    if (pos + n > nbits()) fail(E_END_OF_STREAM);
    if (cache_bits < n) refill();
    uint64_t v = n ? (cache >> (64 - n)) : 0;
    cache <<= n;
    cache_bits -= n;
    pos += n;
    return v;
  }

  inline int64_t read_signed(unsigned n) {
    uint64_t v = read_bits(n);
    uint64_t sign = 1ull << (n - 1);
    return (int64_t)((v ^ sign)) - (int64_t)sign;
  }

  inline uint32_t read_unary() {
    uint64_t count = 0;
    for (;;) {
      if (cache_bits == 0) {
        if (pos >= nbits()) fail(E_END_OF_STREAM);
        refill();
      }
      unsigned z = cache ? (unsigned)__builtin_clzll(cache) : 64;
      if (z >= cache_bits) {
        // All valid cached bits are zeros; consume and continue.
        count += cache_bits;
        pos += cache_bits;
        cache = 0;
        cache_bits = 0;
        if (pos >= nbits()) fail(E_END_OF_STREAM);
        continue;
      }
      if (pos + z + 1 > nbits()) fail(E_END_OF_STREAM);
      count += z;
      pos += z + 1;
      // z+1 == 64 would be UB for <<; cache is empty in that case.
      cache = (z + 1 >= 64) ? 0 : (cache << (z + 1));
      cache_bits -= z + 1;
      return (uint32_t)count;
    }
  }

  // Fused unary-quotient + k-bit-remainder + zigzag read: one refill
  // and one bounds check serve the whole Rice code in the common case
  // (the hottest loop of the stream, zflac.zig:655-664). Falls back to
  // the checked readers for long quotients / cache-straddling codes.
  inline int64_t read_rice(unsigned k) {
    // Serve from the cache when the whole code fits (cache low bits
    // are zero, so a run reaching past cache_bits shows up as
    // total > cache_bits); refill at most once, else fall back to the
    // checked readers (long quotients, EOF).
    uint64_t c = cache;
    unsigned z = c ? (unsigned)__builtin_clzll(c) : 64;
    unsigned total = z + 1 + k;
    if (total > cache_bits) {
      refill();
      c = cache;
      z = c ? (unsigned)__builtin_clzll(c) : 64;
      total = z + 1 + k;
    }
    if (total <= cache_bits && pos + total <= nbits()) {
      uint64_t rem = k ? (c << (z + 1)) >> (64 - k) : 0;
      cache = total >= 64 ? 0 : c << total;
      cache_bits -= total;
      pos += total;
      uint64_t zz = ((uint64_t)z << k) | rem;
      return (int64_t)(zz >> 1) ^ -(int64_t)(zz & 1);
    }
    uint64_t q = read_unary();
    uint64_t rem = read_bits(k);
    uint64_t zz = (q << k) + rem;
    return (int64_t)(zz >> 1) ^ -(int64_t)(zz & 1);
  }

  // read_rice that also reports the unary quotient (the measure-only
  // scans need q for their window-envelope checks).
  inline int64_t read_rice_q(unsigned k, uint64_t* q_out) {
    uint64_t c = cache;
    unsigned z = c ? (unsigned)__builtin_clzll(c) : 64;
    unsigned total = z + 1 + k;
    if (total > cache_bits) {
      refill();
      c = cache;
      z = c ? (unsigned)__builtin_clzll(c) : 64;
      total = z + 1 + k;
    }
    if (total <= cache_bits && pos + total <= nbits()) {
      uint64_t rem = k ? (c << (z + 1)) >> (64 - k) : 0;
      cache = total >= 64 ? 0 : c << total;
      cache_bits -= total;
      pos += total;
      *q_out = z;
      uint64_t zz = ((uint64_t)z << k) | rem;
      return (int64_t)(zz >> 1) ^ -(int64_t)(zz & 1);
    }
    uint64_t q = read_unary();
    uint64_t rem = read_bits(k);
    *q_out = q;
    uint64_t zz = (q << k) + rem;
    return (int64_t)(zz >> 1) ^ -(int64_t)(zz & 1);
  }

  inline void align_byte() { seek((pos + 7) & ~7ull); }
  inline size_t byte_pos() const { return (size_t)(pos >> 3); }
  inline uint32_t read_u8() { return (uint32_t)read_bits(8); }
  inline uint32_t read_u16() { return (uint32_t)read_bits(16); }
  inline uint32_t read_u24() { return (uint32_t)read_bits(24); }
  inline uint64_t read_u32() { return read_bits(32); }
  inline void skip_bytes(uint64_t n) {
    if (pos + n * 8 > nbits()) fail(E_END_OF_STREAM);
    seek(pos + n * 8);
  }
};

// ---- CRC tables (poly 0x07 / 0x8005, init 0, MSB-first) ----
struct CrcTables {
  uint8_t crc8[256];
  uint16_t crc16[256];
  CrcTables() {
    for (int b = 0; b < 256; b++) {
      uint32_t c8 = (uint32_t)b;
      for (int i = 0; i < 8; i++)
        c8 = (c8 & 0x80) ? ((c8 << 1) ^ 0x07) : (c8 << 1);
      crc8[b] = (uint8_t)c8;
      uint32_t c16 = (uint32_t)b << 8;
      for (int i = 0; i < 8; i++)
        c16 = (c16 & 0x8000) ? ((c16 << 1) ^ 0x8005) : (c16 << 1);
      crc16[b] = (uint16_t)c16;
    }
  }
};
static const CrcTables kCrc;

static uint8_t crc8_range(const uint8_t* p, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; i++) c = kCrc.crc8[c ^ p[i]];
  return c;
}
static uint16_t crc16_range(const uint8_t* p, size_t n) {
  uint16_t c = 0;
  for (size_t i = 0; i < n; i++)
    c = (uint16_t)(kCrc.crc16[((c >> 8) ^ p[i]) & 0xFF] ^ (c << 8));
  return c;
}

// ---- format tables (format.py mirrors) ----
// ---- MD5 (RFC 1321) ----
// The reference verifies the STREAMINFO MD5 over the raw little-endian
// sample bytes as the only enforced integrity check
// (zflac.zig:267-280). Computing it here lets the parallel decoder
// hash finished chunks in stream order while later chunks still
// decode, hiding the hash behind the decode instead of serializing a
// full extra pass over the PCM.
struct MD5 {
  uint32_t h[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu, 0x10325476u};
  uint64_t total = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  static inline uint32_t rotl(uint32_t x, int c) {
    return (x << c) | (x >> (32 - c));
  }

  void block(const uint8_t* p) {
    uint32_t m[16];
    std::memcpy(m, p, 64);
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
// Fully unrolled rounds (constants from RFC 1321 §3.4); the
// (x&y)|(~x&z) forms are written as z^(x&(y^z)) to save an op.
#define MD5_STEP(f, w, x, y, z, g, k, s) \
  w += (f) + k + m[g];                   \
  w = rotl(w, s) + x;
#define F1(x, y, z) ((z) ^ ((x) & ((y) ^ (z))))
#define F2(x, y, z) ((y) ^ ((z) & ((x) ^ (y))))
#define F3(x, y, z) ((x) ^ (y) ^ (z))
#define F4(x, y, z) ((y) ^ ((x) | ~(z)))
    MD5_STEP(F1(b, c, d), a, b, c, d, 0, 0xd76aa478u, 7)
    MD5_STEP(F1(a, b, c), d, a, b, c, 1, 0xe8c7b756u, 12)
    MD5_STEP(F1(d, a, b), c, d, a, b, 2, 0x242070dbu, 17)
    MD5_STEP(F1(c, d, a), b, c, d, a, 3, 0xc1bdceeeu, 22)
    MD5_STEP(F1(b, c, d), a, b, c, d, 4, 0xf57c0fafu, 7)
    MD5_STEP(F1(a, b, c), d, a, b, c, 5, 0x4787c62au, 12)
    MD5_STEP(F1(d, a, b), c, d, a, b, 6, 0xa8304613u, 17)
    MD5_STEP(F1(c, d, a), b, c, d, a, 7, 0xfd469501u, 22)
    MD5_STEP(F1(b, c, d), a, b, c, d, 8, 0x698098d8u, 7)
    MD5_STEP(F1(a, b, c), d, a, b, c, 9, 0x8b44f7afu, 12)
    MD5_STEP(F1(d, a, b), c, d, a, b, 10, 0xffff5bb1u, 17)
    MD5_STEP(F1(c, d, a), b, c, d, a, 11, 0x895cd7beu, 22)
    MD5_STEP(F1(b, c, d), a, b, c, d, 12, 0x6b901122u, 7)
    MD5_STEP(F1(a, b, c), d, a, b, c, 13, 0xfd987193u, 12)
    MD5_STEP(F1(d, a, b), c, d, a, b, 14, 0xa679438eu, 17)
    MD5_STEP(F1(c, d, a), b, c, d, a, 15, 0x49b40821u, 22)
    MD5_STEP(F2(b, c, d), a, b, c, d, 1, 0xf61e2562u, 5)
    MD5_STEP(F2(a, b, c), d, a, b, c, 6, 0xc040b340u, 9)
    MD5_STEP(F2(d, a, b), c, d, a, b, 11, 0x265e5a51u, 14)
    MD5_STEP(F2(c, d, a), b, c, d, a, 0, 0xe9b6c7aau, 20)
    MD5_STEP(F2(b, c, d), a, b, c, d, 5, 0xd62f105du, 5)
    MD5_STEP(F2(a, b, c), d, a, b, c, 10, 0x02441453u, 9)
    MD5_STEP(F2(d, a, b), c, d, a, b, 15, 0xd8a1e681u, 14)
    MD5_STEP(F2(c, d, a), b, c, d, a, 4, 0xe7d3fbc8u, 20)
    MD5_STEP(F2(b, c, d), a, b, c, d, 9, 0x21e1cde6u, 5)
    MD5_STEP(F2(a, b, c), d, a, b, c, 14, 0xc33707d6u, 9)
    MD5_STEP(F2(d, a, b), c, d, a, b, 3, 0xf4d50d87u, 14)
    MD5_STEP(F2(c, d, a), b, c, d, a, 8, 0x455a14edu, 20)
    MD5_STEP(F2(b, c, d), a, b, c, d, 13, 0xa9e3e905u, 5)
    MD5_STEP(F2(a, b, c), d, a, b, c, 2, 0xfcefa3f8u, 9)
    MD5_STEP(F2(d, a, b), c, d, a, b, 7, 0x676f02d9u, 14)
    MD5_STEP(F2(c, d, a), b, c, d, a, 12, 0x8d2a4c8au, 20)
    MD5_STEP(F3(b, c, d), a, b, c, d, 5, 0xfffa3942u, 4)
    MD5_STEP(F3(a, b, c), d, a, b, c, 8, 0x8771f681u, 11)
    MD5_STEP(F3(d, a, b), c, d, a, b, 11, 0x6d9d6122u, 16)
    MD5_STEP(F3(c, d, a), b, c, d, a, 14, 0xfde5380cu, 23)
    MD5_STEP(F3(b, c, d), a, b, c, d, 1, 0xa4beea44u, 4)
    MD5_STEP(F3(a, b, c), d, a, b, c, 4, 0x4bdecfa9u, 11)
    MD5_STEP(F3(d, a, b), c, d, a, b, 7, 0xf6bb4b60u, 16)
    MD5_STEP(F3(c, d, a), b, c, d, a, 10, 0xbebfbc70u, 23)
    MD5_STEP(F3(b, c, d), a, b, c, d, 13, 0x289b7ec6u, 4)
    MD5_STEP(F3(a, b, c), d, a, b, c, 0, 0xeaa127fau, 11)
    MD5_STEP(F3(d, a, b), c, d, a, b, 3, 0xd4ef3085u, 16)
    MD5_STEP(F3(c, d, a), b, c, d, a, 6, 0x04881d05u, 23)
    MD5_STEP(F3(b, c, d), a, b, c, d, 9, 0xd9d4d039u, 4)
    MD5_STEP(F3(a, b, c), d, a, b, c, 12, 0xe6db99e5u, 11)
    MD5_STEP(F3(d, a, b), c, d, a, b, 15, 0x1fa27cf8u, 16)
    MD5_STEP(F3(c, d, a), b, c, d, a, 2, 0xc4ac5665u, 23)
    MD5_STEP(F4(b, c, d), a, b, c, d, 0, 0xf4292244u, 6)
    MD5_STEP(F4(a, b, c), d, a, b, c, 7, 0x432aff97u, 10)
    MD5_STEP(F4(d, a, b), c, d, a, b, 14, 0xab9423a7u, 15)
    MD5_STEP(F4(c, d, a), b, c, d, a, 5, 0xfc93a039u, 21)
    MD5_STEP(F4(b, c, d), a, b, c, d, 12, 0x655b59c3u, 6)
    MD5_STEP(F4(a, b, c), d, a, b, c, 3, 0x8f0ccc92u, 10)
    MD5_STEP(F4(d, a, b), c, d, a, b, 10, 0xffeff47du, 15)
    MD5_STEP(F4(c, d, a), b, c, d, a, 1, 0x85845dd1u, 21)
    MD5_STEP(F4(b, c, d), a, b, c, d, 8, 0x6fa87e4fu, 6)
    MD5_STEP(F4(a, b, c), d, a, b, c, 15, 0xfe2ce6e0u, 10)
    MD5_STEP(F4(d, a, b), c, d, a, b, 6, 0xa3014314u, 15)
    MD5_STEP(F4(c, d, a), b, c, d, a, 13, 0x4e0811a1u, 21)
    MD5_STEP(F4(b, c, d), a, b, c, d, 4, 0xf7537e82u, 6)
    MD5_STEP(F4(a, b, c), d, a, b, c, 11, 0xbd3af235u, 10)
    MD5_STEP(F4(d, a, b), c, d, a, b, 2, 0x2ad7d2bbu, 15)
    MD5_STEP(F4(c, d, a), b, c, d, a, 9, 0xeb86d391u, 21)
#undef MD5_STEP
#undef F1
#undef F2
#undef F3
#undef F4
    h[0] += a;
    h[1] += b;
    h[2] += c;
    h[3] += d;
  }

  void update(const void* data, size_t n) {
    const uint8_t* p = (const uint8_t*)data;
    total += n;
    if (buflen) {
      size_t take = std::min(n, (size_t)64 - buflen);
      std::memcpy(buf + buflen, p, take);
      buflen += take;
      p += take;
      n -= take;
      if (buflen < 64) return;
      block(buf);
      buflen = 0;
    }
    while (n >= 64) {
      block(p);
      p += 64;
      n -= 64;
    }
    if (n) {
      std::memcpy(buf, p, n);
      buflen = n;
    }
  }

  void final(uint8_t out[16]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (buflen != 56) update(&z, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (8 * i));
    update(lenb, 8);
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++)
        out[4 * i + j] = (uint8_t)(h[i] >> (8 * j));
  }
};

// Hash `n` container samples the way the reference does
// (zflac.zig:267-277): the smallest whole number of little-endian
// bytes per sample. nbytes == sizeof(C) feeds the raw buffer; the only
// mismatch in practice is 17-24-bit audio in an int32 container
// (3 of every 4 bytes).
template <typename C>
static void md5_update_samples(MD5& md5, const C* p, size_t n,
                               unsigned nbytes) {
  if (nbytes == sizeof(C)) {
    md5.update(p, n * sizeof(C));
    return;
  }
  uint8_t tmp[3 * 1024];
  size_t i = 0;
  while (i < n) {
    size_t take = std::min(n - i, (size_t)1024);
    const uint8_t* src = (const uint8_t*)(p + i);
    for (size_t j = 0; j < take; j++) {
      tmp[3 * j] = src[sizeof(C) * j];
      tmp[3 * j + 1] = src[sizeof(C) * j + 1];
      tmp[3 * j + 2] = src[sizeof(C) * j + 2];
    }
    md5.update(tmp, 3 * take);
    i += take;
  }
}

static const int32_t kSampleRateHz[16] = {
    0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
    32000, 44100, 48000, 96000, -1, -2, -3, -4};

static int channel_count(unsigned code) {
  if (code <= 7) return (int)code + 1;
  if (code <= 10) return 2;  // left-side / side-right / mid-side
  return 0;
}
static int side_channel(unsigned code) {
  if (code == 8 || code == 10) return 1;
  if (code == 9) return 0;
  return -1;
}
static int block_size_value(unsigned code) {
  if (code == 1) return 192;
  if (code >= 2 && code <= 5) return 144 << code;
  if (code >= 8) return 1 << code;
  return -1;  // reserved/uncommon
}
static const int kBitDepth[8] = {0, 8, 12, -1, 16, 20, 24, 32};

struct SubMeta {
  int32_t kind, order, wasted, shift;
  int32_t coeffs[32];
  int64_t seeds[4];
  uint8_t wide;
  uint64_t val_off;  // offset into value buffer
  uint32_t count;    // == block_size
  uint32_t grp_start = 0, grp_n = 0;  // Rice-group table span (Range)
};

// Rice-group geometry shared with ops/rice.py.
enum : uint32_t { kGroupG = 8, kGroupWindowWords = 12 };
// A group is kernel-eligible only if every residual's code fits the
// fixed bit window and int32 zigzag math (host invalidates otherwise).
enum : uint32_t { kMaxGroupSpanBits = 32 * (kGroupWindowWords - 2),
                  kMaxQuotient = 40 };

struct GroupRec {
  // Per-subframe recording of group boundaries during the residual
  // scan: output position, absolute bit offset, rice param / escape.
  std::vector<uint32_t> at;
  std::vector<int64_t> off;
  std::vector<uint8_t> k;
  std::vector<uint8_t> depth;
  std::vector<uint8_t> bad;   // group invalidated (huge quotient etc.)
  int64_t end_pos = -1;
  void clear() {
    at.clear(); off.clear(); k.clear(); depth.clear(); bad.clear();
    end_pos = -1;
  }
};

// Skim-mode side outputs: warm-up/constant values per subframe and the
// sparse patch list for positions the unpack kernel cannot produce
// (invalid groups, misaligned partition layouts, verbatim subframes,
// short tails). Values are int32 (skim serves int32 streams only).
struct SkimExtra {
  std::vector<int32_t> warm;            // [num_subs * 32]
  std::vector<int32_t> p_sub, p_pos, p_val;
};

// Extended-UTF-8 coded number (zflac.zig:203-214).
static uint64_t read_coded_number(BitReader& br) {
  uint32_t first = br.read_u8();
  unsigned byte_count = first == 0 ? 0 : (unsigned)__builtin_clz(
      (uint32_t)((first ^ 0xFFu) << 24) | 1u);
  if (first == 0xFF || byte_count == 1) fail(E_INVALID_CODED_NUMBER);
  if (byte_count == 0) return first;
  uint64_t v = first & (0x7Fu >> byte_count);
  for (unsigned i = 0; i + 1 < byte_count; i++)
    v = (v << 6) | (br.read_u8() & 0x3F);
  return v;
}

template <typename V>
static void decode_residuals(BitReader& br, std::vector<V>& vals,
                             uint32_t block_size, uint32_t order,
                             GroupRec* rec = nullptr) {
  uint32_t coding = (uint32_t)br.read_bits(2);
  if (coding >= 2) fail(E_INVALID_RESIDUAL_CODING_METHOD);
  uint32_t po = (uint32_t)br.read_bits(4);
  unsigned pbits = coding == 0 ? 4 : 5;
  uint32_t escape = coding == 0 ? 0xF : 0x1F;

  // Group recording needs partition boundaries aligned to G so that a
  // group's Rice parameter is single-valued (ops/rice.py).
  if (rec && !(po == 0 || ((block_size >> po) % kGroupG) == 0)) rec = nullptr;

  auto record = [&](uint32_t out_pos, uint8_t kk, uint8_t dd) {
    if (rec && (out_pos == order || (out_pos % kGroupG) == 0)) {
      rec->at.push_back(out_pos);
      rec->off.push_back((int64_t)br.pos);
      rec->k.push_back(kk);
      rec->depth.push_back(dd);
      rec->bad.push_back(0);
    }
  };

  uint32_t out_pos = order;
  uint32_t parts = 1u << po;
  for (uint32_t p = 0; p < parts; p++) {
    uint32_t count = block_size >> po;
    if (p == 0) {
      if (count < order) fail(E_INVALID_FRAME_HEADER);
      count -= order;
    }
    uint32_t k = (uint32_t)br.read_bits(pbits);
    ZTRACE(residual, "partition %u/%u k=%u n=%u", p, parts, k, count);
    if (k == escape) {
      uint32_t depth = (uint32_t)br.read_bits(5);
      if (depth == 0) {
        for (uint32_t i = 0; i < count; i++)
          record(out_pos + i, 0xFE, 0);
        vals.insert(vals.end(), count, (V)0);
        out_pos += count;
      } else {
        for (uint32_t i = 0; i < count; i++) {
          record(out_pos, 0xFE, (uint8_t)depth);
          vals.push_back((V)br.read_signed(depth));
          out_pos++;
        }
      }
    } else {
      for (uint32_t i = 0; i < count; i++) {
        record(out_pos, (uint8_t)k, 0);
        uint64_t q = br.read_unary();
        uint64_t rem = br.read_bits(k);
        uint64_t zz = (q << k) + rem;
        if (rec && (q > kMaxQuotient || (zz >> 31) != 0) &&
            !rec->bad.empty())
          rec->bad.back() = 1;  // exceeds the kernel's envelope
        vals.push_back((V)((int64_t)(zz >> 1) ^ -(int64_t)(zz & 1)));
        out_pos++;
      }
    }
  }
  if (rec) rec->end_pos = (int64_t)br.pos;
}

// Engine fast path: identical bitstream walk and values as
// decode_residuals, but writes straight into the caller's work buffer
// (no vector growth checks, no group recording) via the fused
// BitReader::read_rice. The reference-structured decode_residuals
// stays as-is for the measured CPU baseline (BASELINE.md protocol).
template <typename V>
static void decode_residuals_into(BitReader& br, V* out,
                                  uint32_t block_size, uint32_t order) {
  uint32_t coding = (uint32_t)br.read_bits(2);
  if (coding >= 2) fail(E_INVALID_RESIDUAL_CODING_METHOD);
  uint32_t po = (uint32_t)br.read_bits(4);
  unsigned pbits = coding == 0 ? 4 : 5;
  uint32_t escape = coding == 0 ? 0xF : 0x1F;

  uint32_t parts = 1u << po;
  for (uint32_t p = 0; p < parts; p++) {
    uint32_t count = block_size >> po;
    if (p == 0) {
      if (count < order) fail(E_INVALID_FRAME_HEADER);
      count -= order;
    }
    uint32_t k = (uint32_t)br.read_bits(pbits);
    ZTRACE(residual, "partition %u/%u k=%u n=%u", p, parts, k, count);
    if (k == escape) {
      uint32_t depth = (uint32_t)br.read_bits(5);
      if (depth == 0) {
        std::memset(out, 0, count * sizeof(V));
        out += count;
      } else {
        for (uint32_t i = 0; i < count; i++)
          *out++ = (V)br.read_signed(depth);
      }
    } else {
      for (uint32_t i = 0; i < count; i++) *out++ = (V)br.read_rice(k);
    }
  }
}

// ---- measure-only residual scan (skim) ----
// Walks the exact bits decode_residuals does but materializes no rows:
// the residual VALUES are recomputed on the accelerator by the Rice
// bit-unpack kernel (ops/rice.py) from the group table recorded here.
// Values the kernel cannot produce are emitted as sparse patches. The
// badness rules must agree exactly with append_groups(): a group this
// function does not patch must never be invalidated downstream.
static void skim_residuals(BitReader& br, uint32_t block_size,
                           uint32_t order, uint32_t sub_rel,
                           GroupRec& rec, SkimExtra& ex) {
  uint32_t coding = (uint32_t)br.read_bits(2);
  if (coding >= 2) fail(E_INVALID_RESIDUAL_CODING_METHOD);
  uint32_t po = (uint32_t)br.read_bits(4);
  unsigned pbits = coding == 0 ? 4 : 5;
  uint32_t escape = coding == 0 ? 0xF : 0x1F;
  bool aligned = po == 0 || ((block_size >> po) % kGroupG) == 0;

  uint32_t out_pos = order;
  uint32_t parts = 1u << po;

  auto patch = [&](uint32_t pos, int32_t v) {
    ex.p_sub.push_back((int32_t)sub_rel);
    ex.p_pos.push_back((int32_t)pos);
    ex.p_val.push_back(v);
  };

  if (!aligned) {
    // Partition boundaries misaligned with the group grid: the whole
    // residual span goes to the patch list (rare layouts).
    for (uint32_t p = 0; p < parts; p++) {
      uint32_t count = block_size >> po;
      if (p == 0) {
        if (count < order) fail(E_INVALID_FRAME_HEADER);
        count -= order;
      }
      uint32_t k = (uint32_t)br.read_bits(pbits);
      if (k == escape) {
        uint32_t depth = (uint32_t)br.read_bits(5);
        for (uint32_t i = 0; i < count; i++)
          patch(out_pos++, depth ? (int32_t)br.read_signed(depth) : 0);
      } else {
        for (uint32_t i = 0; i < count; i++) {
          uint64_t q = br.read_unary();
          uint64_t rem = br.read_bits(k);
          uint64_t zz = (q << k) + rem;
          patch(out_pos++,
                (int32_t)((int64_t)(zz >> 1) ^ -(int64_t)(zz & 1)));
        }
      }
    }
    for (; out_pos < block_size; out_pos++) patch(out_pos, 0);
    rec.end_pos = (int64_t)br.pos;
    return;
  }

  // Aligned path: groups open at out_pos==order and at every multiple
  // of G. The current group's values ride in a ring so an
  // out-of-envelope group can be patched exactly.
  int32_t gbuf[kGroupG];
  uint32_t gstart = 0;
  bool gopen = false, gbad = false;

  auto close_group = [&](uint64_t now_pos) {
    if (!gopen) return;
    if (!gbad &&
        (uint64_t)((int64_t)now_pos - rec.off.back()) > kMaxGroupSpanBits)
      gbad = true;
    if (gbad) {
      rec.bad.back() = 1;
      for (uint32_t pos = gstart; pos < out_pos; pos++)
        patch(pos, gbuf[pos & (kGroupG - 1)]);
    }
    gopen = false;
    gbad = false;
  };
  auto open_group = [&](uint8_t kk, uint8_t dd, bool track) {
    close_group(br.pos);
    rec.at.push_back(out_pos);
    rec.off.push_back((int64_t)br.pos);
    rec.k.push_back(kk);
    rec.depth.push_back(dd);
    rec.bad.push_back(0);
    gopen = track;  // escape groups never exceed the envelope
    gbad = false;
    gstart = out_pos;
  };

  for (uint32_t p = 0; p < parts; p++) {
    uint32_t count = block_size >> po;
    if (p == 0) {
      if (count < order) fail(E_INVALID_FRAME_HEADER);
      count -= order;
    }
    uint32_t k = (uint32_t)br.read_bits(pbits);
    if (k == escape) {
      uint32_t depth = (uint32_t)br.read_bits(5);
      if (depth == 0) {
        for (uint32_t i = 0; i < count; i++) {
          if (out_pos == order || (out_pos & (kGroupG - 1)) == 0)
            open_group(0xFE, 0, false);
          out_pos++;
        }
      } else {
        for (uint32_t i = 0; i < count; i++) {
          if (out_pos == order || (out_pos & (kGroupG - 1)) == 0)
            open_group(0xFE, (uint8_t)depth, false);
          br.read_bits(depth);
          out_pos++;
        }
      }
    } else {
      for (uint32_t i = 0; i < count; i++) {
        if (out_pos == order || (out_pos & (kGroupG - 1)) == 0)
          open_group((uint8_t)k, 0, true);
        uint64_t q;
        int64_t v = br.read_rice_q(k, &q);
        uint64_t zz = (uint64_t)((v << 1) ^ (v >> 63));
        if (q > kMaxQuotient || (zz >> 31) != 0) gbad = true;
        gbuf[out_pos & (kGroupG - 1)] = (int32_t)v;
        out_pos++;
      }
    }
  }
  close_group(br.pos);
  for (; out_pos < block_size; out_pos++) patch(out_pos, 0);
  rec.end_pos = (int64_t)br.pos;
}

// ---- result plan (C ABI struct; field order matters for ctypes) ----
struct Plan {
  uint32_t min_block_size, max_block_size;
  uint32_t min_frame_size, max_frame_size;
  uint32_t si_sample_rate, si_channels, si_bits_per_sample;
  uint64_t si_total_samples;
  uint8_t md5[16];
  uint32_t sample_rate, channels, bits_per_sample;
  uint64_t num_frames, num_subframes, max_block, total_samples;
  int32_t value_width;  // 4 or 8 bytes per rows/seeds element
  int32_t _pad;
  int32_t* f_block_size;
  int32_t* f_channel_code;
  int64_t* f_pcm_start;
  int64_t* f_byte_offset;
  void* rows;
  int32_t* kind;
  int32_t* order;
  int32_t* wasted;
  int32_t* shift;
  int32_t* coeffs_rev;
  void* seeds;
  uint8_t* wide;
  // Optional Rice-group offset table for the TPU bit-unpack kernel
  // (ops/rice.py): per (subframe, group of G=8 output positions):
  // absolute bit offset of the group's first coded residual, the Rice
  // parameter (0xFE = escaped partition, 0xFF = invalid -> host path),
  // and the escape depth. Layout [S, groups_per_row] with
  // groups_per_row = ceil(max_block / 8). Null unless requested.
  int64_t* grp_off;
  uint8_t* grp_k;
  uint8_t* grp_depth;
  int32_t grp_per_row;
  int32_t _pad2;
  int64_t* f_coded_number;   // [F]
  int32_t variable_blocking;  // blocking strategy of frame 0
  int32_t _pad3;
  // Skim-mode outputs (zfi_index_skim): warm-up/constant values and the
  // sparse patch list; rows stays null. int32 streams only.
  int32_t* sk_warm;        // [S, 32]
  int32_t* sk_patch_sub;   // [P]
  int32_t* sk_patch_pos;   // [P]
  int32_t* sk_patch_val;   // [P]
  int64_t sk_patch_n;
  int32_t skim;
  int32_t _pad4;
  // MD5 of the decoded stream, computed inline by the full-decode
  // entry points when requested (md5_state: 0 = not computed,
  // 1 = computed -> computed_md5 is valid).
  uint8_t computed_md5[16];
  int32_t md5_state;
  int32_t _pad5;
  // Whole-stream index (zfi_index_ex, zfi_index_skim): its two phases
  // on the steady clock, the frame parse (the parallel anchors,
  // segments and re-validation, or the sequential scan) and the pack
  // into the arrays above; the segments packed, one thread each (1 for
  // one sequential scan); 1 when the parallel parse fell back to the
  // sequential scan.
  int64_t parse_ns, pack_ns;
  int32_t pack_segments;
  int32_t index_fallback;
};


template <typename T>
static T* alloc_copy(const std::vector<T>& v) {
  T* p = (T*)std::malloc(v.size() * sizeof(T) + 1);
  if (!p) fail(E_UNIMPLEMENTED);
  if (!v.empty()) std::memcpy(p, v.data(), v.size() * sizeof(T));
  return p;
}

// An uninitialised array of n T (at least one byte, so that an empty
// array is a pointer the caller frees like any other).
template <typename T>
static T* alloc_n(uint64_t n) {
  T* p = (T*)std::malloc(n ? n * sizeof(T) : 1);
  if (!p) fail(E_UNIMPLEMENTED);
  return p;
}

// fn(i) for each i in [0, n): on the calling thread when n is 1, else
// on n - 1 new threads and the calling thread. fn must not throw.
template <typename Fn>
static void run_each(size_t n, Fn&& fn) {
  std::vector<std::thread> th;
  for (size_t i = 1; i < n; i++) th.emplace_back([&fn, i] { fn(i); });
  if (n) fn(0);
  for (auto& t : th) t.join();
}


// Order-specialized LPC restore: a compile-time order lets the inner
// dot unroll (the hot loop of the reference's comptime dispatch,
// zflac.zig:525-533). ACC is the accumulator type: int32 when the
// width predicate guarantees no overflow (identical results, but the
// dot vectorizes), int64 otherwise.
template <typename V, typename ACC, int ORD>
static inline void lpc_restore_n(V* work, uint32_t bs,
                                 const int64_t* coef, uint32_t shift) {
  ACC c[ORD];
  for (int j = 0; j < ORD; j++) c[j] = (ACC)coef[j];
  for (uint32_t i = ORD; i < bs; i++) {
    ACC pred = 0;
    for (int j = 0; j < ORD; j++)
      pred += c[j] * (ACC)work[i - 1 - j];
    work[i] += (V)(pred >> shift);
  }
}

template <typename V, typename ACC>
static inline void lpc_restore_acc(V* work, uint32_t bs, uint32_t order,
                                   const int64_t* coef, uint32_t shift) {
  switch (order) {
    case 1: return lpc_restore_n<V, ACC, 1>(work, bs, coef, shift);
    case 2: return lpc_restore_n<V, ACC, 2>(work, bs, coef, shift);
    case 3: return lpc_restore_n<V, ACC, 3>(work, bs, coef, shift);
    case 4: return lpc_restore_n<V, ACC, 4>(work, bs, coef, shift);
    case 5: return lpc_restore_n<V, ACC, 5>(work, bs, coef, shift);
    case 6: return lpc_restore_n<V, ACC, 6>(work, bs, coef, shift);
    case 7: return lpc_restore_n<V, ACC, 7>(work, bs, coef, shift);
    case 8: return lpc_restore_n<V, ACC, 8>(work, bs, coef, shift);
    case 9: return lpc_restore_n<V, ACC, 9>(work, bs, coef, shift);
    case 10: return lpc_restore_n<V, ACC, 10>(work, bs, coef, shift);
    case 11: return lpc_restore_n<V, ACC, 11>(work, bs, coef, shift);
    case 12: return lpc_restore_n<V, ACC, 12>(work, bs, coef, shift);
    default:
      for (uint32_t i = order; i < bs; i++) {
        ACC pred = 0;
        for (uint32_t j = 0; j < order; j++)
          pred += (ACC)coef[j] * (ACC)work[i - 1 - j];
        work[i] += (V)(pred >> shift);
      }
  }
}

// Transposed-form LPC restore (engine fast path): instead of gathering
// an order-wide dot per sample, each new sample scatters its
// contributions into a sliding accumulator window. The per-sample
// serial critical path shrinks to one multiply + two adds + the shift
// (the other order-1 multiply-adds are independent and pipeline), and
// the summands are identical int64 terms in a different association —
// bit-exact vs the gather form under two's-complement wraparound.
template <typename V, int ORD>
static inline void lpc_restore_tr_n(V* w, uint32_t bs,
                                    const int64_t* coef,
                                    uint32_t shift) {
  int64_t c[ORD], acc[ORD];
  for (int j = 0; j < ORD; j++) c[j] = coef[j];
  for (int j = 0; j < ORD; j++) {
    int64_t a = 0;
    for (int t = 0; t < ORD; t++) {
      int idx = ORD + j - 1 - t;
      if (idx < ORD) a += c[t] * (int64_t)w[idx];
    }
    acc[j] = a;
  }
  for (uint32_t i = ORD; i < bs; i++) {
    V s = w[i] + (V)(acc[0] >> shift);
    w[i] = s;
    for (int j = 0; j < ORD - 1; j++)
      acc[j] = acc[j + 1] + c[j] * (int64_t)s;
    acc[ORD - 1] = c[ORD - 1] * (int64_t)s;
  }
}

template <typename V>
static inline void lpc_restore_tr(V* w, uint32_t bs, uint32_t order,
                                  const int64_t* coef, uint32_t shift) {
  switch (order) {
    case 1: return lpc_restore_tr_n<V, 1>(w, bs, coef, shift);
    case 2: return lpc_restore_tr_n<V, 2>(w, bs, coef, shift);
    case 3: return lpc_restore_tr_n<V, 3>(w, bs, coef, shift);
    case 4: return lpc_restore_tr_n<V, 4>(w, bs, coef, shift);
    case 5: return lpc_restore_tr_n<V, 5>(w, bs, coef, shift);
    case 6: return lpc_restore_tr_n<V, 6>(w, bs, coef, shift);
    case 7: return lpc_restore_tr_n<V, 7>(w, bs, coef, shift);
    case 8: return lpc_restore_tr_n<V, 8>(w, bs, coef, shift);
    case 9: return lpc_restore_tr_n<V, 9>(w, bs, coef, shift);
    case 10: return lpc_restore_tr_n<V, 10>(w, bs, coef, shift);
    case 11: return lpc_restore_tr_n<V, 11>(w, bs, coef, shift);
    case 12: return lpc_restore_tr_n<V, 12>(w, bs, coef, shift);
    default: {
      int64_t c[32], acc[32];
      for (uint32_t j = 0; j < order; j++) c[j] = coef[j];
      for (uint32_t j = 0; j < order; j++) {
        int64_t a = 0;
        for (uint32_t t = 0; t < order; t++) {
          int64_t idx = (int64_t)order + j - 1 - t;
          if (idx < (int64_t)order) a += c[t] * (int64_t)w[idx];
        }
        acc[j] = a;
      }
      for (uint32_t i = order; i < bs; i++) {
        V s = w[i] + (V)(acc[0] >> shift);
        w[i] = s;
        for (uint32_t j = 0; j + 1 < order; j++)
          acc[j] = acc[j + 1] + c[j] * (int64_t)s;
        acc[order - 1] = c[order - 1] * (int64_t)s;
      }
    }
  }
}

// log2 ceil for the libflac-style accumulator-width predicate.
static inline unsigned ilog2_ceil(uint32_t v) {
  unsigned r = 0;
  while ((1u << r) < v) r++;
  return r;
}

template <typename V>
static inline void lpc_restore(V* work, uint32_t bs, uint32_t order,
                               const int64_t* coef, uint32_t shift,
                               uint32_t sample_depth, uint32_t precision) {
  if (sizeof(V) == 4 &&
      sample_depth + precision + ilog2_ceil(order ? order : 1) <= 31) {
    return lpc_restore_acc<V, int32_t>(work, bs, order, coef, shift);
  }
  lpc_restore_acc<V, int64_t>(work, bs, order, coef, shift);
}

// Engine variant: transposed form for the int64-accumulator case (the
// narrow-int32 case keeps the gather dot, which vectorizes well).
template <typename V>
static inline void lpc_restore_fast(V* work, uint32_t bs, uint32_t order,
                                    const int64_t* coef, uint32_t shift,
                                    uint32_t sample_depth,
                                    uint32_t precision) {
  if (sizeof(V) == 4 &&
      sample_depth + precision + ilog2_ceil(order ? order : 1) <= 31) {
    return lpc_restore_acc<V, int32_t>(work, bs, order, coef, shift);
  }
  lpc_restore_tr<V>(work, bs, order, coef, shift);
}

// ---- shared one-frame parser ----
// Parses one complete frame (header + subframes + padding + CRC16) at
// the reader position, appending to a Range. Stream-level checks
// (consistency, bs==1 rule, growth/cut) belong to the drivers: the
// sequential driver interleaves them via SeqCtx at the exact points the
// reference does (zflac.zig:376-405); the parallel driver passes
// ctx=null and re-validates after the merge.

struct FrameInfo {
  uint32_t block_size;
  uint32_t frame_sr;
  uint32_t ch_code;
  uint32_t bd_code;
  int64_t start_byte;
  int64_t coded_number;  // frame index (fixed) / first sample (variable)
  uint32_t variable_blocking;
};

template <typename V>
struct Range {
  std::vector<FrameInfo> frames;
  std::vector<SubMeta> subs;
  std::vector<V> vals;
  // Flattened per-subframe Rice-group tables (SubMeta.grp_start/grp_n).
  std::vector<uint32_t> g_at;
  std::vector<int64_t> g_off;
  std::vector<uint8_t> g_k;
  std::vector<uint8_t> g_depth;
  // Skim-mode outputs (measure-only index; vals stays empty).
  SkimExtra ex;
  bool skim = false;
};

struct SeqCtx {
  bool first = true;
  bool valid_total = false;
  uint64_t offset = 0, total_count = 0;
  uint32_t expected_channels = 0;
  uint32_t sample_rate = 0, locked_count = 0, bits_per_sample = 0;
  int bd_code = -1;
};

// Append a subframe's recorded Rice groups into the Range tables,
// invalidating groups whose bit span exceeds the kernel window.
template <typename V>
static void append_groups(GroupRec& grec, SubMeta& sm, Range<V>& out) {
  sm.grp_start = (uint32_t)out.g_at.size();
  sm.grp_n = (uint32_t)grec.at.size();
  for (size_t i = 0; i < grec.at.size(); i++) {
    int64_t end = i + 1 < grec.off.size() ? grec.off[i + 1]
                                          : grec.end_pos;
    uint8_t kk = grec.k[i];
    if (grec.bad[i] || end < 0 ||
        (uint64_t)(end - grec.off[i]) > kMaxGroupSpanBits)
      kk = 0xFF;
    out.g_at.push_back(grec.at[i]);
    out.g_off.push_back(grec.off[i]);
    out.g_k.push_back(kk);
    out.g_depth.push_back(grec.depth[i]);
  }
}


template <typename V>
static void parse_frame(BitReader& br, const uint8_t* data,
                        uint32_t si_sample_rate, uint32_t si_bps,
                        int check_crc8, int check_crc16, SeqCtx* ctx,
                        Range<V>& out, bool emit_groups = false) {
  size_t frame_start = br.byte_pos();
  uint64_t hdr = br.read_u32();
  if ((hdr >> 17) != (0xFFF8u >> 1)) fail(E_INVALID_FRAME_HEADER);
  unsigned variable_blocking = (unsigned)((hdr >> 16) & 1);
  unsigned bs_code = (hdr >> 12) & 0xF;
  unsigned sr_code = (hdr >> 8) & 0xF;
  unsigned ch_code = (hdr >> 4) & 0xF;
  unsigned bd_code = (hdr >> 1) & 0x7;

  uint64_t coded_number = read_coded_number(br);

  uint32_t block_size;
  if (bs_code == 0) {
    fail(E_INVALID_FRAME_HEADER);
    return;
  } else if (bs_code == 6) {
    block_size = br.read_u8() + 1;
  } else if (bs_code == 7) {
    uint32_t raw = br.read_u16();
    if (raw == 0xFFFF) fail(E_INVALID_FRAME_HEADER);
    block_size = raw + 1;
  } else {
    int v = block_size_value(bs_code);
    if (v < 0) fail(E_INVALID_FRAME_HEADER);
    block_size = (uint32_t)v;
  }

  uint32_t frame_sr;
  int sr_entry = kSampleRateHz[sr_code];
  if (sr_code == 0) frame_sr = si_sample_rate;
  else if (sr_entry == -1) frame_sr = br.read_u8() * 1000;     // kHz
  else if (sr_entry == -2) frame_sr = br.read_u16();           // Hz
  else if (sr_entry == -3) frame_sr = br.read_u16() * 10;      // Hz/10
  else if (sr_entry == -4) { fail(E_INVALID_FRAME_HEADER); return; }
  else frame_sr = (uint32_t)sr_entry;

  uint32_t nch = (uint32_t)channel_count(ch_code);
  uint32_t bits_per_sample;
  if (bd_code == 0) bits_per_sample = si_bps;
  else if (kBitDepth[bd_code] < 0) {
    // Reserved bit-depth code: sequential raises it only when locking
    // the first frame (later frames compare codes first).
    if (!ctx || ctx->first) fail(E_INVALID_FRAME_HEADER);
    bits_per_sample = 0;
  } else {
    bits_per_sample = (uint32_t)kBitDepth[bd_code];
  }

  if (ctx) {
    // Stream-consistency state machine (zflac.zig:376-405) at the
    // exact sequential checkpoints.
    if (ctx->first) {
      ctx->sample_rate = frame_sr;
      ctx->locked_count = nch;
      ctx->bd_code = (int)bd_code;
      ctx->bits_per_sample = bits_per_sample;
      if (nch != ctx->expected_channels) fail(E_INCONSISTENT_PARAMETERS);
      ctx->first = false;
    } else {
      if (ctx->sample_rate != frame_sr || ctx->locked_count != nch ||
          ctx->bd_code != (int)bd_code)
        fail(E_INCONSISTENT_PARAMETERS);
    }
    uint64_t expected_end =
        ctx->offset + (uint64_t)block_size * ctx->locked_count;
    if (ctx->valid_total && expected_end > ctx->total_count)
      ctx->valid_total = false;
    if (block_size == 1 && ctx->valid_total &&
        expected_end < ctx->total_count)
      fail(E_INVALID_FRAME_HEADER);
    ctx->offset = expected_end;
    bits_per_sample = ctx->bits_per_sample;
    nch = ctx->locked_count;
  }

  uint32_t header_crc = br.read_u8();
  if (check_crc8) {
    if (crc8_range(data + frame_start, br.byte_pos() - 1 - frame_start)
        != header_crc)
      fail(E_INVALID_CHECKSUM);
  }

  int side = side_channel(ch_code);
  for (uint32_t ch = 0; ch < nch; ch++) {
    if (br.read_bits(1) != 0) fail(E_INVALID_SUBFRAME_HEADER);
    unsigned type_bits = (unsigned)br.read_bits(6);
    unsigned wasted_flag = (unsigned)br.read_bits(1);
    uint32_t wasted = wasted_flag ? br.read_unary() + 1 : 0;
    uint32_t sub_bps = bits_per_sample + ((int)ch == side ? 1 : 0);

    int kind, order;
    if (type_bits == 0) { kind = 0; order = 0; }
    else if (type_bits == 1) { kind = 1; order = 0; }
    else if (type_bits >= 8 && type_bits <= 12) {
      kind = 2; order = (int)type_bits - 8;
    } else if (type_bits >= 32) {
      kind = 3; order = (int)type_bits - 31;
    } else {
      fail(E_INVALID_SUBFRAME_HEADER);
      return;
    }
    if (wasted >= sub_bps) fail(E_INVALID_SUBFRAME_HEADER);
    uint32_t read_depth = sub_bps - wasted;

    SubMeta sm{};
    sm.kind = kind;
    sm.order = order;
    sm.wasted = (int32_t)wasted;
    sm.shift = 0;
    sm.wide = 0;
    sm.val_off = out.vals.size();
    sm.count = block_size;
    std::vector<V>& vals = out.vals;

    const bool skim = out.skim;
    uint32_t sub_rel = (uint32_t)out.subs.size();
    int32_t* w = nullptr;
    if (skim) {
      out.ex.warm.resize(out.ex.warm.size() + 32, 0);
      w = out.ex.warm.data() + out.ex.warm.size() - 32;
    }

    if (kind == 0) {  // constant
      V v = (V)br.read_signed(read_depth);
      if (skim) w[0] = (int32_t)v;
      else {
        vals.push_back(v);
        vals.insert(vals.end(), block_size - 1, (V)0);
      }
    } else if (kind == 1) {  // verbatim
      if (skim) {
        for (uint32_t i = 0; i < block_size; i++) {
          out.ex.p_sub.push_back((int32_t)sub_rel);
          out.ex.p_pos.push_back((int32_t)i);
          out.ex.p_val.push_back((int32_t)br.read_signed(read_depth));
        }
      } else {
        for (uint32_t i = 0; i < block_size; i++)
          vals.push_back((V)br.read_signed(read_depth));
      }
    } else if (kind == 2) {  // fixed
      if ((uint32_t)order > block_size) fail(E_INVALID_SUBFRAME_HEADER);
      int64_t warm[4] = {0, 0, 0, 0};
      for (int i = 0; i < order; i++) {
        warm[i] = br.read_signed(read_depth);
        if (skim) w[i] = (int32_t)warm[i];
        else vals.push_back((V)warm[i]);
      }
      GroupRec grec;
      if (skim) {
        skim_residuals(br, block_size, (uint32_t)order, sub_rel, grec,
                       out.ex);
        append_groups(grec, sm, out);
      } else {
        decode_residuals<V>(br, vals, block_size, (uint32_t)order,
                            emit_groups ? &grec : nullptr);
        if (emit_groups) append_groups(grec, sm, out);
      }
      // Warm-up finite-difference seeds Delta^j s[j] (plan.py
      // SEED_TRIANGLE).
      static const int tri[4][4] = {
          {1, 0, 0, 0}, {-1, 1, 0, 0}, {1, -2, 1, 0}, {-1, 3, -3, 1}};
      for (int j = 0; j < order; j++) {
        int64_t acc = 0;
        for (int i = 0; i <= j; i++) acc += tri[j][i] * warm[i];
        sm.seeds[j] = acc;
      }
    } else {  // LPC
      if ((uint32_t)order > block_size) fail(E_INVALID_SUBFRAME_HEADER);
      for (int i = 0; i < order; i++) {
        V v = (V)br.read_signed(read_depth);
        if (skim) w[i] = (int32_t)v;
        else vals.push_back(v);
      }
      uint32_t precision = (uint32_t)br.read_bits(4) + 1;
      sm.shift = (int32_t)br.read_bits(5);
      for (int j = 0; j < order; j++)
        sm.coeffs[31 - j] = (int32_t)br.read_signed(precision);
      GroupRec grec;
      if (skim) {
        skim_residuals(br, block_size, (uint32_t)order, sub_rel, grec,
                       out.ex);
        append_groups(grec, sm, out);
      } else {
        decode_residuals<V>(br, vals, block_size, (uint32_t)order,
                            emit_groups ? &grec : nullptr);
        if (emit_groups) append_groups(grec, sm, out);
      }
      // Mirror the reference: i32 accumulation for <=16-bit streams
      // (InterType, zflac.zig:314-319); safe_lpc re-routes Python-side.
      sm.wide = 0;
      (void)precision;
    }
    // Zero-pad short rows (non-divisible partition layouts leave a
    // tail; see oracle._decode_residuals). Skim handles tails as
    // patches inside skim_residuals.
    if (!skim) {
      uint64_t added = vals.size() - sm.val_off;
      if (added < block_size)
        vals.insert(vals.end(), block_size - added, (V)0);
    }
    out.subs.push_back(sm);
  }

  br.align_byte();
  uint32_t frame_crc = br.read_u16();
  if (check_crc16) {
    if (crc16_range(data + frame_start, br.byte_pos() - 2 - frame_start)
        != frame_crc)
      fail(E_INVALID_CHECKSUM);
  }

  out.frames.push_back(FrameInfo{block_size, frame_sr, ch_code, bd_code,
                                 (int64_t)frame_start,
                                 (int64_t)coded_number,
                                 variable_blocking});
}

// ---- sequential driver (exact reference semantics) ----

template <typename V>
static void seq_index(const uint8_t* data, size_t len, int check_crc,
                      uint32_t si_bps, BitReader br, const Plan* si,
                      Range<V>& out, SeqCtx& ctx,
                      bool emit_groups = false) {
  ctx = SeqCtx{};
  ctx.valid_total = si->si_total_samples > 0;
  ctx.expected_channels = si->si_channels;
  ctx.total_count = ctx.expected_channels *
      (ctx.valid_total ? si->si_total_samples : 4096);
  if (!out.skim) out.vals.reserve(len);

  for (;;) {
    if (ctx.valid_total && ctx.offset >= ctx.total_count) break;
    if (br.pos + 32 > br.nbits()) {
      if (ctx.valid_total) fail(E_END_OF_STREAM);
      break;
    }
    parse_frame<V>(br, data, si->si_sample_rate, si_bps, check_crc,
                   check_crc, &ctx, out, emit_groups);
  }
}

// ---- parallel driver: sync-scan anchors + range parse + fix-up ----
// The frame-resync capability the reference lists as a TODO
// (Readme.md:54): a frame start can be located mid-stream by scanning
// for the 15-bit sync pattern and validating with a full frame parse
// including the CRC-16. Used here to shard the serial phase-1 scan
// across host threads; the same anchor search powers multi-host
// byte-range sharding (parallel/longstream.py) and error recovery.

template <typename V>
static int64_t find_anchor(const uint8_t* data, size_t len, size_t from,
                           size_t limit, uint32_t si_sample_rate,
                           uint32_t si_bps) {
  Range<V> scratch;
  for (size_t i = from; i + 4 < limit; i++) {
    if (data[i] != 0xFF || (data[i + 1] & 0xFE) != 0xF8) continue;
    BitReader br{data, len, (uint64_t)i * 8};
    scratch.frames.clear();
    scratch.subs.clear();
    scratch.vals.clear();
    try {
      // Full structural parse + CRC-16: definitive validation.
      parse_frame<V>(br, data, si_sample_rate, si_bps, /*crc8=*/1,
                     /*crc16=*/1, nullptr, scratch);
    } catch (const Thrown&) {
      continue;
    }
    return (int64_t)i;
  }
  return -1;
}

// Light anchor: header structural checks + header CRC-8 only (~30
// bytes instead of the whole frame's Rice walk). Used for the internal
// segment boundaries of the parallel decoder, where a false positive
// is caught deterministically by the landing chain-verify (each
// segment must end exactly on the next anchor) and merely costs the
// sequential fallback. The exported resync API (zfi_find_anchor) keeps
// the definitive full-parse validation — error recovery scans inside
// corrupt regions where strength matters.
static int64_t find_anchor_light(const uint8_t* data, size_t len,
                                 size_t from, size_t limit,
                                 uint32_t si_sample_rate) {
  for (size_t i = from; i + 4 < limit; i++) {
    if (data[i] != 0xFF || (data[i + 1] & 0xFE) != 0xF8) continue;
    BitReader br{data, len, (uint64_t)i * 8};
    try {
      uint64_t hdr = br.read_u32();
      unsigned bs_code = (hdr >> 12) & 0xF;
      unsigned sr_code = (hdr >> 8) & 0xF;
      unsigned ch_code = (hdr >> 4) & 0xF;
      unsigned bd_code = (hdr >> 1) & 0x7;
      if ((hdr & 1) != 0) continue;  // reserved bit
      if (bs_code == 0 || channel_count(ch_code) == 0 ||
          kBitDepth[bd_code] < 0)
        continue;
      read_coded_number(br);
      if (bs_code == 6) br.read_u8();
      else if (bs_code == 7) {
        if (br.read_u16() == 0xFFFF) continue;
      } else if (block_size_value(bs_code) < 0) {
        continue;
      }
      int sr_entry = kSampleRateHz[sr_code];
      if (sr_entry == -1) br.read_u8();
      else if (sr_entry == -2 || sr_entry == -3) br.read_u16();
      else if (sr_entry == -4) continue;
      uint32_t header_crc = br.read_u8();
      if (crc8_range(data + i, br.byte_pos() - 1 - i) != header_crc)
        continue;
      (void)si_sample_rate;
      return (int64_t)i;
    } catch (const Thrown&) {
      continue;
    }
  }
  return -1;
}

// Blocking-strategy bit + coded number of a (pre-validated) frame
// header at byte `at` — enough to place the frame's output in the
// stream: fixed blocking encodes the frame index (x nominal block
// size = first sample), variable blocking encodes the first sample
// directly (reference read_coded_number, zflac.zig:203-214).
static bool peek_frame_position(const uint8_t* data, size_t len,
                                int64_t at, int* variable,
                                uint64_t* coded) {
  BitReader br{data, len, (uint64_t)at * 8};
  try {
    uint64_t hdr = br.read_u32();
    if ((hdr >> 17) != (0xFFF8u >> 1)) return false;
    *variable = (int)((hdr >> 16) & 1);
    *coded = read_coded_number(br);
    return true;
  } catch (const Thrown&) {
    return false;
  }
}

template <typename V>
struct SegResult {
  Range<V> range;
  int64_t landed = -1;   // byte position after the last parsed frame
  int err = OK;          // first error hit inside the segment
};

// What parallel_index did: not tried (one core, or a stream under
// 1 MiB), fell back (the sequential scan must run), or done.
enum class ParallelIndex { kNotTried, kFellBack, kDone };

// Parse the frames in byte segments, one thread each, into `segs` (in
// stream order), and set *keep to the number of frames the sequential
// scan keeps (it stops at the STREAMINFO total). With kDone, *seq_err
// holds the stream error the sequential scan would raise, or OK.
template <typename V>
static ParallelIndex parallel_index(const uint8_t* data, size_t len,
                                    int check_crc, uint32_t si_bps,
                                    size_t first_frame_byte, const Plan* si,
                                    bool skim, std::vector<Range<V>>& segs,
                                    size_t* keep, int* seq_err,
                                    bool emit_groups = false) {
  size_t span = len - first_frame_byte;
  unsigned T = engine_threads();
  if (T < 2 || span < (1u << 20)) return ParallelIndex::kNotTried;
  if (T > 16) T = 16;

  // Phase 1: anchors (parallel).
  std::vector<int64_t> anchors(T, -1);
  anchors[0] = (int64_t)first_frame_byte;
  {
    std::vector<std::thread> th;
    for (unsigned t = 1; t < T; t++) {
      size_t lo = first_frame_byte + span * t / T;
      size_t hi = first_frame_byte + span * (t + 1) / T;
      th.emplace_back([&, t, lo, hi] {
        anchors[t] = find_anchor<V>(data, len, lo, hi, si->si_sample_rate,
                                    si_bps);
      });
    }
    for (auto& x : th) x.join();
  }
  std::vector<int64_t> starts;
  for (unsigned t = 0; t < T; t++)
    if (anchors[t] >= 0 && (starts.empty() || anchors[t] > starts.back()))
      starts.push_back(anchors[t]);

  // Phase 2: parse each segment (parallel).
  std::vector<SegResult<V>> res(starts.size());
  {
    std::vector<std::thread> th;
    for (size_t s = 0; s < starts.size(); s++) {
      int64_t lo = starts[s];
      int64_t hi = s + 1 < starts.size() ? starts[s + 1] : (int64_t)len;
      th.emplace_back([&, s, lo, hi] {
        SegResult<V>& r = res[s];
        r.range.skim = skim;
        if (!r.range.skim) r.range.vals.reserve((size_t)(hi - lo));
        BitReader br{data, len, (uint64_t)lo * 8};
        try {
          for (;;) {
            if ((int64_t)br.byte_pos() >= hi) break;
            if (br.pos + 32 > br.nbits()) break;
            parse_frame<V>(br, data, si->si_sample_rate, si_bps,
                           check_crc, check_crc, nullptr, r.range,
                           emit_groups);
          }
          r.landed = (int64_t)br.byte_pos();
        } catch (const Thrown& e) {
          r.err = e.code;
          r.landed = -1;
        }
      });
    }
    for (auto& x : th) x.join();
  }

  // Fix-up: each segment must land exactly on the next anchor. A
  // mismatch (false anchor / mid-frame error) falls back to the exact
  // sequential scan.
  int trailing_err = OK;
  for (size_t s = 0; s < res.size(); s++) {
    bool last = s + 1 == res.size();
    if (res[s].err != OK) {
      if (!last) return ParallelIndex::kFellBack;
      trailing_err = res[s].err;  // may be legal: resolved below
    } else if (!last && res[s].landed != starts[s + 1]) {
      return ParallelIndex::kFellBack;
    }
  }

  // Re-validate with exact sequential semantics over the segments'
  // frames in order (consistency, bs==1, cut/truncation, EOF rules).
  SeqCtx ctx{};
  ctx.valid_total = si->si_total_samples > 0;
  ctx.expected_channels = si->si_channels;
  ctx.total_count = ctx.expected_channels *
      (ctx.valid_total ? si->si_total_samples : 4096);
  size_t n_frames = 0;
  bool stopped = false;
  for (size_t s = 0; s < res.size() && !stopped; s++) {
    for (const FrameInfo& f : res[s].range.frames) {
      if (ctx.valid_total && ctx.offset >= ctx.total_count) {
        stopped = true;  // sequential stops here; later bytes are ignored
        trailing_err = OK;
        break;
      }
      uint32_t nch = (uint32_t)channel_count(f.ch_code);
      if (ctx.first) {
        ctx.sample_rate = f.frame_sr;
        ctx.locked_count = nch;
        ctx.bd_code = (int)f.bd_code;
        if (nch != ctx.expected_channels) {
          *seq_err = E_INCONSISTENT_PARAMETERS;
          return ParallelIndex::kDone;
        }
        ctx.first = false;
      } else if (ctx.sample_rate != f.frame_sr ||
                 ctx.locked_count != nch ||
                 ctx.bd_code != (int)f.bd_code) {
        *seq_err = E_INCONSISTENT_PARAMETERS;
        return ParallelIndex::kDone;
      }
      uint64_t expected_end =
          ctx.offset + (uint64_t)f.block_size * ctx.locked_count;
      if (ctx.valid_total && expected_end > ctx.total_count)
        ctx.valid_total = false;
      if (f.block_size == 1 && ctx.valid_total &&
          expected_end < ctx.total_count) {
        *seq_err = E_INVALID_FRAME_HEADER;
        return ParallelIndex::kDone;
      }
      ctx.offset = expected_end;
      n_frames++;
    }
  }
  if (trailing_err != OK) {
    // An in-segment error the sequential scan would also reach.
    return ParallelIndex::kFellBack;
  }
  if (!stopped && ctx.valid_total && ctx.offset < ctx.total_count) {
    *seq_err = E_END_OF_STREAM;
    return ParallelIndex::kDone;
  }
  *keep = n_frames;
  segs.clear();
  for (auto& r : res) segs.push_back(std::move(r.range));
  *seq_err = OK;
  return ParallelIndex::kDone;
}

// ---- pack + entry ----

// Pack parsed segments (in stream order) into the dense C-ABI plan, of
// which the first `keep` frames are kept. Every array is allocated once
// and each segment's thread writes its own slice of it: its frames,
// its subframes' rows (the values, then zeros to the largest block)
// and metadata, and their Rice-group table; then it frees its values.
// Locked parameters come from the first frame kept. out->pack_ns is the
// pack's time on the steady clock, out->pack_segments the segments.
template <typename V>
static void pack_segments(std::vector<Range<V>>& segs, size_t keep,
                          uint32_t si_bps, Plan* out) {
  const ProfClock::time_point t_pack = ProfClock::now();
  const size_t n = segs.size();
  // Each segment's kept frames and subframes, and its first frame,
  // subframe and PCM sample in the plan.
  std::vector<uint64_t> nf(n), ns(n), f0(n + 1), s0(n + 1), p0(n + 1);
  uint32_t max_block = 0;
  bool groups = false, skim = false;
  const FrameInfo* first = nullptr;
  for (size_t s = 0; s < n; s++) {
    const Range<V>& r = segs[s];
    nf[s] = std::min<uint64_t>(r.frames.size(), keep - f0[s]);
    uint64_t subs = 0, pcm = 0;
    for (uint64_t i = 0; i < nf[s]; i++) {
      const FrameInfo& f = r.frames[i];
      subs += (uint64_t)channel_count(f.ch_code);
      pcm += f.block_size;
      if (f.block_size > max_block) max_block = f.block_size;
    }
    ns[s] = subs;
    f0[s + 1] = f0[s] + nf[s];
    s0[s + 1] = s0[s] + ns[s];
    p0[s + 1] = p0[s] + pcm;
    if (!first && nf[s]) first = &r.frames[0];
    groups |= !r.g_at.empty();
    skim |= r.skim;
  }
  const uint64_t F = f0[n], S = s0[n], B = max_block;

  out->sample_rate = first ? first->frame_sr : 0;
  out->channels = first ? (uint32_t)channel_count(first->ch_code) : 0;
  out->bits_per_sample =
      !first ? 0
      : (first->bd_code == 0 || kBitDepth[first->bd_code] < 0)
          ? si_bps : (uint32_t)kBitDepth[first->bd_code];
  out->variable_blocking = first ? (int32_t)first->variable_blocking : 0;
  out->num_frames = F;
  out->num_subframes = S;
  out->max_block = B;
  out->total_samples = p0[n];
  out->value_width = (int32_t)sizeof(V);

  // Each array goes into `out` as soon as it is allocated, so that
  // zfi_free releases what a failed allocation leaves behind.
  int32_t* f_bs = out->f_block_size = alloc_n<int32_t>(F);
  int32_t* f_ch = out->f_channel_code = alloc_n<int32_t>(F);
  int64_t* f_pcm = out->f_pcm_start = alloc_n<int64_t>(F);
  int64_t* f_byte = out->f_byte_offset = alloc_n<int64_t>(F);
  int64_t* f_coded = out->f_coded_number = alloc_n<int64_t>(F);
  V* rows = nullptr;
  if (!skim) {
    rows = alloc_n<V>(S * B);
    out->rows = rows;
  }
  int32_t* kind = out->kind = alloc_n<int32_t>(S);
  int32_t* order = out->order = alloc_n<int32_t>(S);
  int32_t* wasted = out->wasted = alloc_n<int32_t>(S);
  int32_t* shift = out->shift = alloc_n<int32_t>(S);
  int32_t* coeffs = out->coeffs_rev = alloc_n<int32_t>(S * 32);
  V* seeds = alloc_n<V>(S * 4);
  out->seeds = seeds;
  uint8_t* wide = out->wide = alloc_n<uint8_t>(S);
  // Rice-group offset table for the TPU unpack kernel (if recorded).
  const uint32_t gpb = groups ? (uint32_t)((B + kGroupG - 1) / kGroupG) : 0;
  int64_t* goff = nullptr;
  uint8_t *gk = nullptr, *gd = nullptr;
  if (groups) {
    out->grp_per_row = (int32_t)gpb;
    goff = out->grp_off = alloc_n<int64_t>(S * gpb);
    gk = out->grp_k = alloc_n<uint8_t>(S * gpb);
    gd = out->grp_depth = alloc_n<uint8_t>(S * gpb);
  }

  run_each(n, [&](size_t s) {
    Range<V>& r = segs[s];
    uint64_t pcm = p0[s];
    for (uint64_t i = 0; i < nf[s]; i++) {
      const FrameInfo& f = r.frames[i];
      const uint64_t g = f0[s] + i;
      f_bs[g] = (int32_t)f.block_size;
      f_ch[g] = (int32_t)f.ch_code;
      f_pcm[g] = (int64_t)pcm;
      f_byte[g] = f.start_byte;
      f_coded[g] = f.coded_number;
      pcm += f.block_size;
    }
    for (uint64_t j = 0; j < ns[s]; j++) {
      const SubMeta& sm = r.subs[j];
      const uint64_t g = s0[s] + j;
      if (rows) {
        V* row = rows + g * B;
        std::memcpy(row, r.vals.data() + sm.val_off, sm.count * sizeof(V));
        std::memset(row + sm.count, 0, (B - sm.count) * sizeof(V));
      }
      kind[g] = sm.kind;
      order[g] = sm.order;
      wasted[g] = sm.wasted;
      shift[g] = sm.shift;
      std::memcpy(coeffs + g * 32, sm.coeffs, 32 * sizeof(int32_t));
      for (int k = 0; k < 4; k++) seeds[g * 4 + k] = (V)sm.seeds[k];
      wide[g] = sm.wide;
      if (groups) {
        int64_t* go = goff + g * gpb;
        uint8_t* gkr = gk + g * gpb;
        uint8_t* gdr = gd + g * gpb;
        for (uint32_t i = 0; i < gpb; i++) go[i] = -1;
        std::memset(gkr, 0xFF, gpb);
        std::memset(gdr, 0, gpb);
        for (uint32_t i = 0; i < sm.grp_n; i++) {
          uint32_t gi = r.g_at[sm.grp_start + i] / kGroupG;
          if (gi >= gpb) continue;
          go[gi] = r.g_off[sm.grp_start + i];
          gkr[gi] = r.g_k[sm.grp_start + i];
          gdr[gi] = r.g_depth[sm.grp_start + i];
        }
      }
    }
    std::vector<V>().swap(r.vals);
  });

  if (skim) {
    // Warm-ups and patches of the kept subframes, patches renumbered
    // from their segment's subframes to the plan's.
    std::vector<int32_t> warm, p_sub, p_pos, p_val;
    for (size_t s = 0; s < n; s++) {
      const SkimExtra& ex = segs[s].ex;
      warm.insert(warm.end(), ex.warm.begin(), ex.warm.begin() + ns[s] * 32);
      for (size_t i = 0; i < ex.p_sub.size(); i++) {
        if ((uint64_t)ex.p_sub[i] >= ns[s]) continue;
        p_sub.push_back(ex.p_sub[i] + (int32_t)s0[s]);
        p_pos.push_back(ex.p_pos[i]);
        p_val.push_back(ex.p_val[i]);
      }
    }
    out->skim = 1;
    out->sk_warm = alloc_copy(warm);
    out->sk_patch_sub = alloc_copy(p_sub);
    out->sk_patch_pos = alloc_copy(p_pos);
    out->sk_patch_val = alloc_copy(p_val);
    out->sk_patch_n = (int64_t)p_sub.size();
  }
  out->pack_segments = (int32_t)n;
  out->pack_ns = elapsed_ns(t_pack, ProfClock::now());
}

// Index the whole stream: the parallel parse where it can run, else (or
// after its fallback) one sequential scan, which packs as one segment.
// ZFLAC_TPU_SEQ_INDEX=1 forces the sequential scan.
template <typename V>
static int index_stream_t(const uint8_t* data, size_t len, int check_crc,
                          uint32_t si_bps, BitReader br, Plan* out,
                          bool emit_groups = false, bool skim = false) {
  const ProfClock::time_point t_parse = ProfClock::now();
  std::vector<Range<V>> segs;
  size_t keep = 0;
  ParallelIndex par = ParallelIndex::kNotTried;
  const char* force_seq = std::getenv("ZFLAC_TPU_SEQ_INDEX");
  if (!(force_seq && force_seq[0] == '1')) {
    int seq_err = OK;
    par = parallel_index<V>(data, len, check_crc, si_bps, br.byte_pos(),
                            out, skim, segs, &keep, &seq_err,
                            emit_groups || skim);
    if (par == ParallelIndex::kDone && seq_err != OK) fail(seq_err);
  }
  if (par != ParallelIndex::kDone) {
    segs.assign(1, Range<V>{});
    segs[0].skim = skim;
    SeqCtx ctx;
    seq_index<V>(data, len, check_crc, si_bps, br, out, segs[0], ctx,
                 emit_groups || skim);
    keep = segs[0].frames.size();
  }
  out->index_fallback = par == ParallelIndex::kFellBack ? 1 : 0;
  out->parse_ns = elapsed_ns(t_parse, ProfClock::now());
  pack_segments<V>(segs, keep, si_bps, out);
  return OK;
}

// ---- full scalar CPU decoder ----
// Single-threaded native decode (index + reconstruct + decorrelate in
// one pass), structurally equivalent to the reference's decode_frames
// (zflac.zig:312-602). Used as the measured CPU baseline for bench.py
// (the reference's Zig toolchain is unavailable; BASELINE.md protocol)
// and as a host fallback decode path.

// One frame: header + subframes + reconstruction + decorrelation,
// appended to `out` (frames are contiguous, interleaved). `ctx` carries
// the sequential stream-consistency state machine; ctx=null gives the
// structural-only parse used by parallel segments (re-validated after
// the merge). Scratch vectors are caller-owned to avoid per-frame
// allocation. Returns the FrameInfo for post-validation.
template <typename V, typename C, bool FAST = false>
static FrameInfo decode_one_frame(BitReader& br, const uint8_t* data,
                                  int check_crc, uint32_t si_sample_rate,
                                  uint32_t si_bps, SeqCtx* ctx,
                                  std::vector<V>& work,
                                  std::vector<V>& res,
                                  std::vector<V>& side_buf,
                                  std::vector<C>& out) {
  size_t frame_start = br.byte_pos();
  uint64_t hdr = br.read_u32();
  if ((hdr >> 17) != (0xFFF8u >> 1)) fail(E_INVALID_FRAME_HEADER);
  unsigned bs_code = (hdr >> 12) & 0xF;
  unsigned sr_code = (hdr >> 8) & 0xF;
  unsigned ch_code = (hdr >> 4) & 0xF;
  unsigned bd_code = (hdr >> 1) & 0x7;
  read_coded_number(br);

  uint32_t block_size = 0;
  if (bs_code == 0) fail(E_INVALID_FRAME_HEADER);
  if (bs_code == 6) block_size = br.read_u8() + 1;
  else if (bs_code == 7) {
    uint32_t raw = br.read_u16();
    if (raw == 0xFFFF) fail(E_INVALID_FRAME_HEADER);
    block_size = raw + 1;
  } else {
    int v = block_size_value(bs_code);
    if (v < 0) fail(E_INVALID_FRAME_HEADER);
    block_size = (uint32_t)v;
  }

  uint32_t frame_sr = 0;
  int sr_entry = kSampleRateHz[sr_code];
  if (sr_code == 0) frame_sr = si_sample_rate;
  else if (sr_entry == -1) frame_sr = br.read_u8() * 1000;
  else if (sr_entry == -2) frame_sr = br.read_u16();
  else if (sr_entry == -3) frame_sr = br.read_u16() * 10;
  else if (sr_entry == -4) fail(E_INVALID_FRAME_HEADER);
  else frame_sr = (uint32_t)sr_entry;

  uint32_t nch = (uint32_t)channel_count(ch_code);
  uint32_t bits_per_sample;
  if (bd_code == 0) bits_per_sample = si_bps;
  else if (kBitDepth[bd_code] < 0) {
    if (!ctx || ctx->first) fail(E_INVALID_FRAME_HEADER);
    bits_per_sample = 0;
  } else {
    bits_per_sample = (uint32_t)kBitDepth[bd_code];
  }

  if (ctx) {
    if (ctx->first) {
      ctx->sample_rate = frame_sr;
      ctx->locked_count = nch;
      ctx->bd_code = (int)bd_code;
      ctx->bits_per_sample = bits_per_sample;
      if (nch != ctx->expected_channels) fail(E_INCONSISTENT_PARAMETERS);
      ctx->first = false;
    } else {
      if (ctx->sample_rate != frame_sr || ctx->locked_count != nch ||
          ctx->bd_code != (int)bd_code)
        fail(E_INCONSISTENT_PARAMETERS);
    }
    uint64_t expected_end =
        ctx->offset + (uint64_t)block_size * ctx->locked_count;
    if (ctx->valid_total && expected_end > ctx->total_count)
      ctx->valid_total = false;
    if (block_size == 1 && ctx->valid_total &&
        expected_end < ctx->total_count)
      fail(E_INVALID_FRAME_HEADER);
    ctx->offset = expected_end;
    bits_per_sample = ctx->bits_per_sample;
    nch = ctx->locked_count;
  }

  ZTRACE(frame, "frame @%zu bs=%u sr=%u ch_code=%u bps=%u",
         frame_start, block_size, frame_sr, ch_code, bits_per_sample);
  uint32_t header_crc = br.read_u8();
  if (check_crc) {
    if (crc8_range(data + frame_start, br.byte_pos() - 1 - frame_start)
        != header_crc)
      fail(E_INVALID_CHECKSUM);
  }

  size_t out_base = out.size();
  out.resize(out_base + (size_t)block_size * nch);
  C* fr = out.data() + out_base;

  int side = side_channel(ch_code);
  work.resize(block_size);
  for (uint32_t ch = 0; ch < nch; ch++) {
    if (br.read_bits(1) != 0) fail(E_INVALID_SUBFRAME_HEADER);
    unsigned type_bits = (unsigned)br.read_bits(6);
    unsigned wasted_flag = (unsigned)br.read_bits(1);
    uint32_t wasted = wasted_flag ? br.read_unary() + 1 : 0;
    uint32_t sub_bps = bits_per_sample + ((int)ch == side ? 1 : 0);
    if (wasted >= sub_bps) fail(E_INVALID_SUBFRAME_HEADER);
    uint32_t depth = sub_bps - wasted;
    ZTRACE(subframe, "ch=%u type=%u wasted=%u depth=%u", ch, type_bits,
           wasted, depth);

    if (type_bits == 0) {  // constant
      V v = (V)br.read_signed(depth);
      for (uint32_t i = 0; i < block_size; i++) work[i] = v;
    } else if (type_bits == 1) {  // verbatim
      for (uint32_t i = 0; i < block_size; i++)
        work[i] = (V)br.read_signed(depth);
    } else if (type_bits >= 8 && type_bits <= 12) {  // fixed
      uint32_t order = type_bits - 8;
      if (order > block_size) fail(E_INVALID_SUBFRAME_HEADER);
      for (uint32_t i = 0; i < order; i++)
        work[i] = (V)br.read_signed(depth);
      if (FAST) {
        decode_residuals_into<V>(br, work.data() + order, block_size,
                                 order);
      } else {
        res.clear();
        decode_residuals<V>(br, res, block_size, order);
        res.resize(block_size - order);
        std::memcpy(work.data() + order, res.data(),
                    res.size() * sizeof(V));
      }
      switch (order) {
        case 0: break;
        case 1:
          for (uint32_t i = 1; i < block_size; i++) work[i] += work[i - 1];
          break;
        case 2:
          for (uint32_t i = 2; i < block_size; i++)
            work[i] += 2 * work[i - 1] - work[i - 2];
          break;
        case 3:
          for (uint32_t i = 3; i < block_size; i++)
            work[i] += 3 * work[i - 1] - 3 * work[i - 2] + work[i - 3];
          break;
        case 4:
          for (uint32_t i = 4; i < block_size; i++)
            work[i] += 4 * work[i - 1] - 6 * work[i - 2] +
                4 * work[i - 3] - work[i - 4];
          break;
        default: fail(E_INVALID_SUBFRAME_HEADER);
      }
    } else if (type_bits >= 32) {  // LPC
      uint32_t order = type_bits - 31;
      if (order > block_size) fail(E_INVALID_SUBFRAME_HEADER);
      for (uint32_t i = 0; i < order; i++)
        work[i] = (V)br.read_signed(depth);
      uint32_t precision = (uint32_t)br.read_bits(4) + 1;
      uint32_t shift = (uint32_t)br.read_bits(5);
      int64_t coef[32];
      for (uint32_t j = 0; j < order; j++)
        coef[j] = br.read_signed(precision);
      if (FAST) {
        decode_residuals_into<V>(br, work.data() + order, block_size,
                                 order);
        lpc_restore_fast<V>(work.data(), block_size, order, coef, shift,
                            depth, precision);
      } else {
        res.clear();
        decode_residuals<V>(br, res, block_size, order);
        res.resize(block_size - order);
        std::memcpy(work.data() + order, res.data(),
                    res.size() * sizeof(V));
        lpc_restore<V>(work.data(), block_size, order, coef, shift,
                       depth, precision);
      }
    } else {
      fail(E_INVALID_SUBFRAME_HEADER);
    }

    // Interleave with wasted shift (zflac.zig:493-497); the side
    // channel stays at full width through decorrelation (see oracle.py
    // note on the reference's premature container cast).
    if ((int)ch == side && nch == 2) {
      side_buf.resize(block_size);
      for (uint32_t i = 0; i < block_size; i++)
        side_buf[i] = (V)(work[i] << wasted);
    } else {
      C* dst = fr + ch;
      for (uint32_t i = 0; i < block_size; i++)
        dst[nch * i] = (C)(work[i] << wasted);
    }
  }
  br.align_byte();
  uint32_t frame_crc16 = br.read_u16();
  if (check_crc) {
    if (crc16_range(data + frame_start, br.byte_pos() - 2 - frame_start)
        != frame_crc16)
      fail(E_INVALID_CHECKSUM);
  }

  // Stereo decorrelation (zflac.zig:553-578).
  if (ch_code == 8) {  // left-side: R = L - S
    for (uint32_t i = 0; i < block_size; i++)
      fr[2 * i + 1] = (C)((V)fr[2 * i] - side_buf[i]);
  } else if (ch_code == 9) {  // side-right: L = S + R
    for (uint32_t i = 0; i < block_size; i++)
      fr[2 * i] = (C)(side_buf[i] + (V)fr[2 * i + 1]);
  } else if (ch_code == 10) {  // mid-side
    for (uint32_t i = 0; i < block_size; i++) {
      V mid = ((V)fr[2 * i] << 1) | (side_buf[i] & 1);
      V s = side_buf[i];
      fr[2 * i] = (C)((mid + s) >> 1);
      fr[2 * i + 1] = (C)((mid - s) >> 1);
    }
  }

  return FrameInfo{block_size, frame_sr, ch_code, bd_code,
                   (int64_t)frame_start};
}

template <typename V, typename C>
static int decode_cpu_t(const uint8_t* data, size_t len, BitReader br,
                        Plan* out, void** out_samples,
                        int check_crc = 0, int compute_md5 = 0,
                        bool fast = false) {
  uint32_t si_bps = out->si_bits_per_sample;
  SeqCtx ctx{};
  ctx.valid_total = out->si_total_samples > 0;
  ctx.expected_channels = out->si_channels;
  ctx.total_count = ctx.expected_channels *
      (ctx.valid_total ? out->si_total_samples : 4096);

  std::vector<C> samples;
  samples.reserve((size_t)ctx.total_count);
  std::vector<V> work, res, side_buf;
  uint64_t pcm_start = 0, nframes = 0;

  for (;;) {
    if (ctx.valid_total && ctx.offset >= ctx.total_count) break;
    if (br.pos + 32 > br.nbits()) {
      if (ctx.valid_total) fail(E_END_OF_STREAM);
      break;
    }
    FrameInfo f =
        fast ? decode_one_frame<V, C, true>(br, data, check_crc,
                                            out->si_sample_rate, si_bps,
                                            &ctx, work, res, side_buf,
                                            samples)
             : decode_one_frame<V, C>(br, data, check_crc,
                                      out->si_sample_rate, si_bps,
                                      &ctx, work, res, side_buf,
                                      samples);
    pcm_start += f.block_size;
    nframes++;
  }

  out->sample_rate = ctx.sample_rate;
  out->channels = ctx.locked_count;
  out->bits_per_sample = ctx.bits_per_sample;
  out->num_frames = nframes;
  out->total_samples = pcm_start;
  out->value_width = (int32_t)sizeof(C);

  C* result = (C*)std::malloc(samples.size() * sizeof(C) + 1);
  if (!result) fail(E_UNIMPLEMENTED);
  std::memcpy(result, samples.data(), samples.size() * sizeof(C));
  if (compute_md5) {
    MD5 md5;
    md5_update_samples<C>(md5, samples.data(), samples.size(),
                          (si_bps + 7) / 8);
    md5.final(out->computed_md5);
    out->md5_state = 1;
  }
  *out_samples = result;
  return OK;
}

#include "simd512.inc"
#include "interleave.inc"

// Parallel full decode: sync-scan anchors (find_anchor) + per-segment
// fused parse+reconstruct + merge, with sequential fallback on any
// fix-up mismatch. The host production engine for host-destined PCM.
// Each worker thread decodes up to THREE segments interleaved at
// Rice-run granularity (interleave.inc) to overlap the bit-serial
// dependency chains.
template <typename V, typename C>
static bool decode_parallel_t(const uint8_t* data, size_t len,
                              size_t first_frame_byte, Plan* out,
                              void** out_samples, int check_crc,
                              int compute_md5) {
  size_t span = len - first_frame_byte;
  unsigned T = engine_threads();
  // Threshold low enough that typical single tracks (a few hundred KB
  // and up) get the threaded engine; tiny streams stay on the
  // sequential path whose per-frame error ordering the faulty-stream
  // tests pin exactly.
  if (T < 2 || span < (1u << 18)) return false;
  auto prof_t0 = ProfClock::now();
  if (T > 16) T = 16;
  uint32_t si_bps = out->si_bits_per_sample;
  unsigned nbytes = (si_bps + 7) / 8;

  // More chunks than threads: workers pull chunk triples off an atomic
  // counter, and whichever worker finishes a chunk advances the
  // in-order MD5 frontier — the hash hides behind the decode instead
  // of running as a serial pass afterwards.
  size_t M = span >> 19;
  if (M < 3 * (size_t)T) M = 3 * (size_t)T;
  if (M > 24 * (size_t)T) M = 24 * (size_t)T;
  if (M > 96) M = 96;

  std::vector<int64_t> anchors(M, -1);
  anchors[0] = (int64_t)first_frame_byte;
  {
    std::atomic<size_t> next{1};
    std::vector<std::thread> th;
    for (unsigned t = 0; t < T; t++) {
      th.emplace_back([&] {
        for (;;) {
          size_t m = next.fetch_add(1);
          if (m >= M) break;
          size_t lo = first_frame_byte + span * m / M;
          size_t hi = first_frame_byte + span * (m + 1) / M;
          anchors[m] = find_anchor_light(data, len, lo, hi,
                                         out->si_sample_rate);
        }
      });
    }
    for (auto& x : th) x.join();
  }
  std::vector<int64_t> starts;
  for (size_t m = 0; m < M; m++)
    if (anchors[m] >= 0 && (starts.empty() || anchors[m] > starts.back()))
      starts.push_back(anchors[m]);
  auto prof_t1 = ProfClock::now();
  // Per-worker busy/drain accumulators (indexed by worker id).
  std::vector<double> prof_busy(T, 0.0), prof_drain(T, 0.0);

  struct Seg {
    std::vector<C> pcm;
    std::vector<FrameInfo> frames;
    int64_t landed = -1;
    int err = OK;
    uint64_t out_lo = 0;  // direct mode: slice start in output values
    size_t out_n = 0;     // direct mode: values written
    std::atomic<int> done{0};
  };
  std::vector<Seg> segs(starts.size());
  MD5 md5;
  size_t hash_frontier = 0;
  bool hash_ok = true;  // guarded by hash_mu
  std::mutex hash_mu;
  // Pre-allocated output (STREAMINFO total known): the drain copies
  // finished chunks into place while later chunks still decode, so the
  // end-of-decode merge memcpy disappears in the common case. Any
  // error/size surprise falls back to the end merge.
  uint64_t precap = out->si_total_samples * (uint64_t)out->si_channels;
  C* pre = nullptr;
  if (out->si_total_samples > 0)
    pre = (C*)std::malloc(precap * sizeof(C) + 1);
  bool copy_ok = pre != nullptr;  // guarded by hash_mu
  uint64_t copy_off = 0;          // guarded by hash_mu
  struct FreeGuard {
    void** p;
    ~FreeGuard() { std::free(*p); }
  } pre_guard{(void**)&pre};

  // Direct-write mode: each segment's global output offset follows
  // from its first frame's coded number, so cursors decode straight
  // into their slice of `pre` — no per-segment PCM vectors and no
  // merge memcpy. Any anomaly (parse surprise, non-monotone offsets,
  // slice overflow, chain break) abandons the parallel path and the
  // sequential engine redoes the stream with exact semantics.
  bool direct = pre != nullptr;
  {
    const char* e = std::getenv("ZFI_DIRECT");  // A/B escape hatch
    if (e && e[0] == '0') direct = false;
  }
  std::vector<uint64_t> seg_lo(starts.size(), 0);
  {
    uint64_t nominal_bs = out->min_block_size == out->max_block_size
                              ? out->min_block_size : 0;
    int var_mode = -1;
    for (size_t s = 0; s < starts.size() && direct; s++) {
      int vb = 0;
      uint64_t coded = 0;
      if (!peek_frame_position(data, len, starts[s], &vb, &coded)) {
        direct = false;
        break;
      }
      if (var_mode < 0) var_mode = vb;
      if (var_mode != vb || (!vb && nominal_bs == 0)) {
        direct = false;
        break;
      }
      uint64_t start_sample = vb ? coded : coded * nominal_bs;
      seg_lo[s] = start_sample * (uint64_t)out->si_channels;
      if (seg_lo[s] > precap || (s == 0 && seg_lo[s] != 0) ||
          (s > 0 && seg_lo[s] <= seg_lo[s - 1]))
        direct = false;
    }
  }
  auto drain_one = [&](Seg& h) {
    // One contiguous completed chunk, in stream order: hash it and
    // land it in the pre-allocated output. An errored chunk's pcm
    // may hold a partially-written frame, so any error invalidates
    // both the pipelined digest and the pipelined copy (the caller
    // redoes them from the merged output in that rare case). Direct
    // mode: the cursor already wrote in place; just verify the slice
    // is the next contiguous piece and hash it where it lies.
    if (direct) {
      bool contiguous = h.err == OK && h.out_lo == copy_off &&
                        h.out_lo + h.out_n <= precap;
      if (contiguous && hash_ok) {
        if (compute_md5)
          md5_update_samples<C>(md5, pre + h.out_lo, h.out_n, nbytes);
      } else {
        hash_ok = false;
      }
      if (contiguous && copy_ok)
        copy_off += h.out_n;
      else
        copy_ok = false;
      return;
    }
    if (h.err == OK && hash_ok) {
      if (compute_md5)
        md5_update_samples<C>(md5, h.pcm.data(), h.pcm.size(), nbytes);
    } else {
      hash_ok = false;
    }
    if (copy_ok && h.err == OK &&
        copy_off + h.pcm.size() <= precap) {
      std::memcpy(pre + copy_off, h.pcm.data(),
                  h.pcm.size() * sizeof(C));
      copy_off += h.pcm.size();
    } else {
      copy_ok = false;
    }
  };
  auto drain_hash = [&](size_t max_segs) {
    // try_lock: if another worker is already draining, it will pick up
    // this chunk; the post-join drain catches the race where no one
    // holds the lock. Bounded bites (max_segs) keep the drainer from
    // hashing a long backlog while the other worker decodes alone —
    // the 2-core schedule stays packed when both alternate decode and
    // hash in small pieces.
    if (!compute_md5 && !pre) return;
    std::unique_lock<std::mutex> lk(hash_mu, std::try_to_lock);
    if (!lk.owns_lock()) return;
    // Adaptive bite: hash half the contiguous done backlog (at least
    // max_segs) — keeps the frontier close without one worker hashing
    // the whole backlog while the other decodes alone, and shrinks
    // the serial post-join tail.
    size_t avail = 0;
    while (hash_frontier + avail < segs.size() &&
           segs[hash_frontier + avail].done.load(
               std::memory_order_acquire))
      avail++;
    size_t bite = std::max(max_segs, (avail + 1) / 2);
    static const size_t env_bite = [] {  // A/B escape hatch
      const char* e = std::getenv("ZFI_BITE");
      return e ? (size_t)std::atoll(e) : (size_t)0;
    }();
    if (env_bite) bite = env_bite;
    for (size_t i = 0; i < bite && i < avail; i++) {
      drain_one(segs[hash_frontier]);
      hash_frontier++;
    }
  };
  {
    std::atomic<size_t> next{0};
    std::vector<std::thread> th;
    unsigned W = std::min<size_t>(T, segs.size());
    for (unsigned t = 0; t < W; t++) {
      th.emplace_back([&, t] {
        for (;;) {
          size_t grab[3];
          int ng = 0;
          // Near the end of the queue, grab singly: a triple's ILP win
          // is smaller than the tail imbalance of one worker decoding
          // the last 3 segments while the others idle.
          size_t taken = next.load(std::memory_order_relaxed);
          size_t rem = segs.size() > taken ? segs.size() - taken : 0;
          int want = rem >= 3 * (size_t)W ? 3 : 1;
          for (int i = 0; i < want; i++) {
            size_t s = next.fetch_add(1);
            if (s < segs.size()) grab[ng++] = s;
          }
          if (ng == 0) break;
          DecodeCursor<V, C> cs[3];
          for (int i = 0; i < ng; i++) {
            size_t s = grab[i];
            Seg& r = segs[s];
            int64_t lo = starts[s];
            int64_t hi =
                s + 1 < starts.size() ? starts[s + 1] : (int64_t)len;
            OutSink<C> snk;
            if (direct) {
              uint64_t slice_hi = s + 1 < starts.size()
                                      ? seg_lo[s + 1] : precap;
              r.out_lo = seg_lo[s];
              snk.base = pre + seg_lo[s];
              snk.cap = (size_t)(slice_hi - seg_lo[s]);
            } else {
              r.pcm.reserve((size_t)(hi - lo) * 2);
              snk.vec = &r.pcm;
            }
            cs[i].init(data, len, lo, hi, out->si_sample_rate, si_bps,
                       check_crc, snk, &r.frames);
          }
          auto pb0 = ProfClock::now();
          run_cursors<V, C>(cs, ng);
          auto pb1 = ProfClock::now();
          for (int i = 0; i < ng; i++) {
            Seg& r = segs[grab[i]];
            r.err = cs[i].err;
            r.landed = cs[i].landed;
            r.out_n = cs[i].pcm.used;
            r.done.store(1, std::memory_order_release);
          }
          // Unbounded drain measured best on the 2-core host (the
          // adaptive/bounded bites trade a shorter tail for worse
          // decode overlap; ZFI_BITE re-exposes them for tuning).
          drain_hash(segs.size());
          auto pb2 = ProfClock::now();
          prof_busy[t] += prof_ms(pb0, pb1);
          prof_drain[t] += prof_ms(pb1, pb2);
          if (ng < want) break;
        }
      });
    }
    for (auto& x : th) x.join();
  }
  auto prof_t2 = ProfClock::now();
  if (compute_md5 || pre) {
    std::lock_guard<std::mutex> lk(hash_mu);
    while (hash_frontier < segs.size() &&
           segs[hash_frontier].done.load(std::memory_order_acquire)) {
      drain_one(segs[hash_frontier]);
      hash_frontier++;
    }
  }

  int trailing_err = OK;
  for (size_t s = 0; s < segs.size(); s++) {
    bool last = s + 1 == segs.size();
    if (segs[s].err != OK) {
      if (!last) return false;
      trailing_err = segs[s].err;
    } else if (!last && segs[s].landed != starts[s + 1]) {
      return false;
    }
  }

  // Sequential-semantics re-validation over the merged frame list.
  std::vector<FrameInfo> frames;
  for (auto& s : segs)
    frames.insert(frames.end(), s.frames.begin(), s.frames.end());
  SeqCtx ctx{};
  ctx.valid_total = out->si_total_samples > 0;
  ctx.expected_channels = out->si_channels;
  ctx.total_count = ctx.expected_channels *
      (ctx.valid_total ? out->si_total_samples : 4096);
  size_t cut = frames.size();
  bool cut_hit = false;
  for (size_t i = 0; i < frames.size(); i++) {
    const FrameInfo& f = frames[i];
    if (ctx.valid_total && ctx.offset >= ctx.total_count) {
      cut = i;
      cut_hit = true;
      break;
    }
    uint32_t nch = (uint32_t)channel_count(f.ch_code);
    if (ctx.first) {
      ctx.sample_rate = f.frame_sr;
      ctx.locked_count = nch;
      ctx.bd_code = (int)f.bd_code;
      ctx.bits_per_sample = f.bd_code == 0
          ? si_bps : (uint32_t)kBitDepth[f.bd_code];
      if (nch != ctx.expected_channels) {
        fail(E_INCONSISTENT_PARAMETERS);
      }
      ctx.first = false;
    } else if (ctx.sample_rate != f.frame_sr ||
               ctx.locked_count != nch || ctx.bd_code != (int)f.bd_code) {
      fail(E_INCONSISTENT_PARAMETERS);
    }
    uint64_t expected_end =
        ctx.offset + (uint64_t)f.block_size * ctx.locked_count;
    if (ctx.valid_total && expected_end > ctx.total_count)
      ctx.valid_total = false;
    if (f.block_size == 1 && ctx.valid_total &&
        expected_end < ctx.total_count)
      fail(E_INVALID_FRAME_HEADER);
    ctx.offset = expected_end;
  }
  if (!cut_hit && trailing_err != OK) return false;
  if (cut == frames.size() && ctx.valid_total &&
      ctx.offset < ctx.total_count)
    fail(E_END_OF_STREAM);

  // Merge PCM (trim at the sequential stop point). Common case: the
  // drain already copied every chunk into `pre` in stream order — hand
  // it off directly.
  uint64_t pcm_start = 0;
  for (size_t i = 0; i < cut; i++) pcm_start += frames[i].block_size;
  uint64_t n_out = pcm_start * ctx.locked_count;
  C* result;
  if (copy_ok && cut == frames.size() && trailing_err == OK &&
      copy_off == n_out) {
    result = pre;
    pre = nullptr;
  } else if (direct) {
    // Direct mode has no per-segment vectors to merge from; any
    // trim/ordering surprise falls back to the sequential engine.
    return false;
  } else {
    result = (C*)std::malloc(n_out * sizeof(C) + 1);
    if (!result) fail(E_UNIMPLEMENTED);
    uint64_t written = 0, fidx = 0;
    for (auto& s : segs) {
      if (fidx >= cut) break;
      size_t take_frames = std::min(s.frames.size(), cut - fidx);
      uint64_t take = 0;
      for (size_t i = 0; i < take_frames; i++)
        take += (uint64_t)s.frames[i].block_size * ctx.locked_count;
      std::memcpy(result + written, s.pcm.data(), take * sizeof(C));
      written += take;
      fidx += take_frames;
    }
  }

  if (compute_md5) {
    if (hash_ok && !cut_hit && trailing_err == OK &&
        cut == frames.size()) {
      md5.final(out->computed_md5);
    } else {
      // Rare path (trailing error kept / total-samples cut): the
      // pipelined digest covered bytes that were trimmed; re-hash the
      // merged output.
      MD5 fresh;
      md5_update_samples<C>(fresh, result, (size_t)n_out, nbytes);
      fresh.final(out->computed_md5);
    }
    out->md5_state = 1;
  }

  out->sample_rate = ctx.sample_rate;
  out->channels = ctx.locked_count;
  out->bits_per_sample = ctx.bits_per_sample;
  out->num_frames = cut;
  out->total_samples = pcm_start;
  out->value_width = (int32_t)sizeof(C);
  *out_samples = result;
  if (prof_enabled()) {
    auto prof_t3 = ProfClock::now();
    std::fprintf(stderr,
                 "[zfi] segs=%zu T=%u anchors=%.2fms decode=%.2fms "
                 "tail=%.2fms total=%.2fms\n",
                 segs.size(), T, prof_ms(prof_t0, prof_t1),
                 prof_ms(prof_t1, prof_t2), prof_ms(prof_t2, prof_t3),
                 prof_ms(prof_t0, prof_t3));
    for (unsigned t = 0; t < T; t++)
      std::fprintf(stderr, "[zfi]   w%u busy=%.2fms drain=%.2fms\n", t,
                   prof_busy[t], prof_drain[t]);
  }
  return true;
}

template <typename V, typename C>
static int decode_auto_t(const uint8_t* data, size_t len, BitReader br,
                         Plan* out, void** out_samples,
                         int check_crc = 0, int compute_md5 = 0) {
  const char* force_seq = std::getenv("ZFLAC_TPU_SEQ_INDEX");
  if (!(force_seq && force_seq[0] == '1')) {
    if (decode_parallel_t<V, C>(data, len, br.byte_pos(), out,
                                out_samples, check_crc, compute_md5))
      return OK;
    ZTRACE(stream, "parallel engine declined; sequential fallback");
  }
  return decode_cpu_t<V, C>(data, len, br, out, out_samples, check_crc,
                            compute_md5, /*fast=*/true);
}

// ---- native phase-2: plan -> PCM (threaded over frames) ----
// Host-side counterpart of runtime/reconstruct.py for host-destined
// output: reconstruction is embarrassingly parallel across frames, and
// decoding on the host avoids the device round-trip entirely when the
// consumer is host RAM (the PCIe/tunnel transfer exceeds the compute).

template <typename V, typename C>
static void reconstruct_frames_range(const Plan* p, size_t f_lo,
                                     size_t f_hi, C* out) {
  const V* rows = (const V*)p->rows;
  const V* seeds = (const V*)p->seeds;
  uint64_t B = p->max_block;
  uint32_t nch = p->channels;
  std::vector<V> work;
  for (size_t f = f_lo; f < f_hi; f++) {
    uint32_t bs = (uint32_t)p->f_block_size[f];
    uint32_t ch_code = (uint32_t)p->f_channel_code[f];
    int side = nch == 2 ? side_channel(ch_code) : -1;
    C* dst = out + (uint64_t)p->f_pcm_start[f] * nch;
    std::vector<V> side_buf;
    for (uint32_t ch = 0; ch < nch; ch++) {
      size_t s = f * nch + ch;
      const V* row = rows + s * B;
      int kind = p->kind[s];
      int order = p->order[s];
      int wasted = p->wasted[s];
      int shift = p->shift[s];
      work.assign(row, row + bs);
      if (kind == 0) {  // constant
        std::fill(work.begin(), work.end(), row[0]);
      } else if (kind == 2) {  // fixed: seeded integration
        switch (order) {
          case 0: break;
          case 1:
            for (uint32_t i = 1; i < bs; i++) work[i] += work[i - 1];
            break;
          case 2:
            for (uint32_t i = 2; i < bs; i++)
              work[i] += 2 * work[i - 1] - work[i - 2];
            break;
          case 3:
            for (uint32_t i = 3; i < bs; i++)
              work[i] += 3 * work[i - 1] - 3 * work[i - 2] + work[i - 3];
            break;
          case 4:
            for (uint32_t i = 4; i < bs; i++)
              work[i] += 4 * work[i - 1] - 6 * work[i - 2] +
                  4 * work[i - 3] - work[i - 4];
            break;
        }
        (void)seeds;
      } else if (kind == 3) {  // LPC
        int64_t coef[32];
        const int32_t* cr = p->coeffs_rev + s * 32;
        for (int j = 0; j < order; j++) coef[j] = cr[31 - j];
        lpc_restore_fast<V>(work.data(), bs, (uint32_t)order, coef,
                            (uint32_t)shift, 33, 16);  // i64 acc
      }  // kind==1 verbatim: row already holds the samples
      if ((int)ch == side) {
        side_buf.resize(bs);
        for (uint32_t i = 0; i < bs; i++)
          side_buf[i] = (V)(work[i] << wasted);
      } else {
        for (uint32_t i = 0; i < bs; i++)
          dst[nch * i + ch] = (C)(work[i] << wasted);
      }
    }
    if (nch == 2) {
      if (ch_code == 8) {
        for (uint32_t i = 0; i < bs; i++)
          dst[2 * i + 1] = (C)((V)dst[2 * i] - side_buf[i]);
      } else if (ch_code == 9) {
        for (uint32_t i = 0; i < bs; i++)
          dst[2 * i] = (C)(side_buf[i] + (V)dst[2 * i + 1]);
      } else if (ch_code == 10) {
        for (uint32_t i = 0; i < bs; i++) {
          V mid = ((V)dst[2 * i] << 1) | (side_buf[i] & 1);
          V sv = side_buf[i];
          dst[2 * i] = (C)((mid + sv) >> 1);
          dst[2 * i + 1] = (C)((mid - sv) >> 1);
        }
      }
    }
  }
}

template <typename V, typename C>
static int reconstruct_t(const Plan* p, void** out_samples) {
  uint64_t n = p->total_samples * p->channels;
  C* out = (C*)std::malloc(n * sizeof(C) + 1);
  if (!out) return E_UNIMPLEMENTED;
  size_t F = p->num_frames;
  unsigned T = engine_threads();
  if (T < 2 || F < 8) {
    reconstruct_frames_range<V, C>(p, 0, F, out);
  } else {
    if (T > 16) T = 16;
    std::vector<std::thread> th;
    for (unsigned t = 0; t < T; t++) {
      size_t lo = F * t / T, hi = F * (t + 1) / T;
      th.emplace_back([=] {
        reconstruct_frames_range<V, C>(p, lo, hi, out);
      });
    }
    for (auto& x : th) x.join();
  }
  *out_samples = out;
  return OK;
}

// ---- stream signature + metadata walk (zflac.zig:218-253) ----
static void parse_stream_meta(BitReader& br, Plan* out) {
  if (br.read_u32() != 0x664C6143ull) fail(E_INVALID_SIGNATURE);
  bool have_si = false;
  for (;;) {
    uint32_t hb = br.read_u8();
    bool last = (hb & 0x80) != 0;
    uint32_t btype = hb & 0x7F;
    uint32_t blen = br.read_u24();
    if (btype == 0) {
      out->min_block_size = br.read_u16();
      out->max_block_size = br.read_u16();
      out->min_frame_size = br.read_u24();
      out->max_frame_size = br.read_u24();
      out->si_sample_rate = (uint32_t)br.read_bits(20);
      out->si_channels = (uint32_t)br.read_bits(3) + 1;
      out->si_bits_per_sample = (uint32_t)br.read_bits(5) + 1;
      out->si_total_samples = br.read_bits(36);
      for (int i = 0; i < 16; i++) out->md5[i] = (uint8_t)br.read_u8();
      have_si = true;
    } else if (btype <= 6) {
      br.skip_bytes(blen);
    } else {
      fail(E_INVALID_METADATA_HEADER);
    }
    if (last) break;
  }
  if (!have_si) fail(E_MISSING_STREAMINFO);
}

}  // namespace

#include "pack2_helpers.inc"

extern "C" {

// Pack2 range scan: parse whole frames in [start_byte, stop_byte) (at
// most max_frames) and emit the packed device buffer (pack2_helpers.inc).
// start_byte must be a frame boundary; *out.landed is the byte offset
// after the last parsed frame (the next chunk's start). force_Fp /
// force_Bp / force_W pin the padded geometry (0 = choose
// automatically); `layout` (kLayoutJax or kLayoutCard,
// pack2_helpers.inc) picks the padding rules of what is not forced.
// out->parse_ns and out->emit_ns hold the two phases' steady-clock
// times (parse_ns also on a decline).
// Returns OK, or an error code with no buffer allocated.
int zfi_pack2_range(const uint8_t* data, size_t len, uint64_t start_byte,
                    uint64_t stop_byte, int32_t max_frames,
                    uint32_t si_sample_rate, uint32_t si_bps,
                    uint32_t si_channels, int check_crc, int32_t force_Fp,
                    int32_t force_Bp, int32_t force_W,
                    const int32_t* force_class_np, int32_t force_patch_np,
                    int32_t force_wide, int32_t layout, Pack2* out) {
  std::memset(out, 0, sizeof(Pack2));
  out->landed = -1;
  if (layout != kLayoutJax && layout != kLayoutCard) return E_UNIMPLEMENTED;
  if (si_bps > 32) return E_PACK2_FALLBACK;
  try {
    const ProfClock::time_point t_parse = ProfClock::now();
    Pack2Range r;
    BitReader br{data, len, start_byte * 8};
    int err = OK;
    for (;;) {
      if (br.byte_pos() >= stop_byte) break;
      if (max_frames > 0 && (int32_t)r.frames.size() >= max_frames) break;
      if (br.pos + 32 > br.nbits()) break;
      size_t subs_cp = r.subs.size();
      size_t grp_cp = r.groups.size();
      size_t p_cp = r.p_sub.size();
      size_t d_cp = r.d_grp.size();
      size_t dv_cp = r.d_val.size();
      uint64_t pos_cp = br.pos;
      try {
        parse_frame_pack2(br, data, si_sample_rate, si_bps, si_channels,
                          check_crc, r);
      } catch (const Thrown& t) {
        r.subs.resize(subs_cp);
        r.groups.resize(grp_cp);
        r.p_sub.resize(p_cp); r.p_pos.resize(p_cp); r.p_val.resize(p_cp);
        r.p_val_hi.resize(p_cp);
        r.d_grp.resize(d_cp);
        r.d_sub.resize(d_cp); r.d_at.resize(d_cp); r.d_n.resize(d_cp);
        r.d_val.resize(dv_cp);
        br.seek(pos_cp);
        err = t.code;
        break;
      }
    }
    const ProfClock::time_point t_emit = ProfClock::now();
    out->parse_ns = elapsed_ns(t_parse, t_emit);
    if (err == E_PACK2_FALLBACK) return err;  // decline: no buffer
    out->landed = (int64_t)br.byte_pos();
    out->bits_per_sample = (int32_t)si_bps;
    emit_pack2(data, len, r, force_Fp, force_Bp, force_W,
               force_class_np, force_patch_np, force_wide, layout, out);
    out->emit_ns = elapsed_ns(t_emit, ProfClock::now());
    return err;
  } catch (const Thrown& t) {
    return t.code;
  } catch (...) {
    return E_UNIMPLEMENTED;
  }
}

void zfi_pack2_free(Pack2* p) {
  std::free(p->buf);
  std::memset(p, 0, sizeof(Pack2));
}

// One-call native decode: parallel index + threaded reconstruction.
// Fills the plan (caller frees with zfi_free) and a malloc'd PCM buffer
// (caller frees with zfi_free_samples). Container width is chosen from
// STREAMINFO bps like the reference (zflac.zig:256-264).
int zfi_decode_parallel(const uint8_t* data, size_t len, int check_crc,
                        int compute_md5, Plan* out,
                        void** out_samples) {
  std::memset(out, 0, sizeof(Plan));
  *out_samples = nullptr;
  try {
    BitReader br{data, len, 0};
    parse_stream_meta(br, out);
    ZTRACE(stream,
           "decode_parallel: %zu bytes sr=%u ch=%u bps=%u total=%llu "
           "crc=%d md5=%d",
           len, out->si_sample_rate, out->si_channels,
           out->si_bits_per_sample,
           (unsigned long long)out->si_total_samples, check_crc,
           compute_md5);
    uint32_t aligned = (out->si_bits_per_sample + 7) & ~7u;
    if (aligned == 8)
      return decode_auto_t<int32_t, int8_t>(
          data, len, br, out, out_samples, check_crc, compute_md5);
    if (aligned == 16)
      return decode_auto_t<int32_t, int16_t>(
          data, len, br, out, out_samples, check_crc, compute_md5);
    return decode_auto_t<int64_t, int32_t>(
        data, len, br, out, out_samples, check_crc, compute_md5);
  } catch (const Thrown& t) {
    return t.code;
  } catch (...) {
    return E_UNIMPLEMENTED;
  }
}

// Frame-resync anchor search over a byte window: returns the byte
// offset of the first position in [from, limit) that parses as a
// complete valid frame (header + subframes + CRC-16), or -1. Powers
// multi-host byte-range sharding (parallel/longstream.py) and
// error recovery; the reference lists resync as a TODO (Readme.md:54).
int64_t zfi_find_anchor(const uint8_t* data, size_t len, uint64_t from,
                        uint64_t limit, uint32_t si_sample_rate,
                        uint32_t si_bits_per_sample) {
  try {
    uint32_t aligned = (si_bits_per_sample + 7) & ~7u;
    if (aligned <= 16)
      return find_anchor<int32_t>(data, len, (size_t)from, (size_t)limit,
                                  si_sample_rate, si_bits_per_sample);
    return find_anchor<int64_t>(data, len, (size_t)from, (size_t)limit,
                                si_sample_rate, si_bits_per_sample);
  } catch (...) {
    return -1;
  }
}

// Index a byte range [start_byte, stop_byte): structural parse of whole
// frames until the cursor reaches stop_byte (the landed byte offset is
// returned via *landed; -1 with an error code on a malformed frame).
// Stream-level consistency/cut rules are the caller's job (the shards'
// frame tables are merged and validated across hosts). STREAMINFO
// fields must be pre-filled in `out` by the caller (from host 0).
int zfi_index_range(const uint8_t* data, size_t len, uint64_t start_byte,
                    uint64_t stop_byte, Plan* out, int check_crc,
                    int64_t* landed) {
  *landed = -1;
  // NOTE: the caller pre-fills the STREAMINFO fields of `out` (shards
  // receive them via the broadcast); only the output pointers must be
  // clean, which the caller's zero-initialized struct guarantees.
  uint32_t bps = out->si_bits_per_sample;
  uint32_t aligned = (bps + 7) & ~7u;
  // On a malformed frame the frames parsed so far are still packed and
  // the error byte offset is reported via *landed (tolerant decode
  // resynchronizes from there with zfi_find_anchor).
  auto run = [&](auto tag) -> int {
    using V = decltype(tag);
    std::vector<Range<V>> segs(1);
    Range<V>& range = segs[0];
    range.vals.reserve((size_t)(stop_byte - start_byte));
    BitReader br{data, len, start_byte * 8};
    int err = OK;
    for (;;) {
      if (br.byte_pos() >= stop_byte) break;
      if (br.pos + 32 > br.nbits()) break;
      size_t subs_cp = range.subs.size();
      size_t vals_cp = range.vals.size();
      size_t g_cp = range.g_at.size();
      uint64_t pos_cp = br.pos;
      try {
        parse_frame<V>(br, data, out->si_sample_rate, bps, check_crc,
                       check_crc, nullptr, range);
      } catch (const Thrown& t) {
        range.subs.resize(subs_cp);
        range.vals.resize(vals_cp);
        range.g_at.resize(g_cp);
        range.g_off.resize(g_cp);
        range.g_k.resize(g_cp);
        range.g_depth.resize(g_cp);
        br.seek(pos_cp);
        err = t.code;
        break;
      }
    }
    *landed = (int64_t)br.byte_pos();
    pack_segments<V>(segs, range.frames.size(), bps, out);
    return err;
  };
  try {
    if (aligned <= 16) return run((int32_t)0);
    return run((int64_t)0);
  } catch (const Thrown& t) {
    return t.code;
  } catch (...) {
    return E_UNIMPLEMENTED;
  }
}

// Native phase-2 reconstruction from an indexed plan: fills a malloc'd
// interleaved container-width PCM buffer (pre-normalization). Caller
// frees with zfi_free_samples. container_width: 1, 2, or 4 bytes.
int zfi_reconstruct(const Plan* plan, int container_width,
                    void** out_samples) {
  *out_samples = nullptr;
  try {
    if (plan->value_width == 4) {
      if (container_width == 1)
        return reconstruct_t<int32_t, int8_t>(plan, out_samples);
      if (container_width == 2)
        return reconstruct_t<int32_t, int16_t>(plan, out_samples);
      return reconstruct_t<int32_t, int32_t>(plan, out_samples);
    }
    if (container_width == 4)
      return reconstruct_t<int64_t, int32_t>(plan, out_samples);
    return E_UNIMPLEMENTED;
  } catch (...) {
    return E_UNIMPLEMENTED;
  }
}

// Full scalar decode. out_samples receives a malloc'd interleaved
// container-width buffer (int8/int16/int32 by value_width); caller
// frees with zfi_free_samples. Pre-normalization values (MD5 domain).
int zfi_decode_cpu(const uint8_t* data, size_t len, Plan* out,
                   void** out_samples) {
  std::memset(out, 0, sizeof(Plan));
  *out_samples = nullptr;
  try {
    BitReader br{data, len, 0};
    parse_stream_meta(br, out);
    uint32_t aligned = (out->si_bits_per_sample + 7) & ~7u;
    if (aligned == 8)
      return decode_cpu_t<int32_t, int8_t>(data, len, br, out,
                                           out_samples);
    if (aligned == 16)
      return decode_cpu_t<int32_t, int16_t>(data, len, br, out,
                                            out_samples);
    return decode_cpu_t<int64_t, int32_t>(data, len, br, out,
                                          out_samples);
  } catch (const Thrown& t) {
    return t.code;
  } catch (...) {
    return E_UNIMPLEMENTED;
  }
}

void zfi_free_samples(void* p) { std::free(p); }


int zfi_index_ex(const uint8_t* data, size_t len, int check_crc,
                 int emit_groups, Plan* out, int64_t* err_pos) {
  std::memset(out, 0, sizeof(Plan));
  try {
    BitReader br{data, len, 0};
    parse_stream_meta(br, out);
    uint32_t bps = out->si_bits_per_sample;
    uint32_t aligned = (bps + 7) & ~7u;
    if (aligned <= 16)
      return index_stream_t<int32_t>(data, len, check_crc, bps, br, out,
                                     emit_groups != 0);
    return index_stream_t<int64_t>(data, len, check_crc, bps, br, out,
                                   emit_groups != 0);
  } catch (const Thrown& t) {
    if (err_pos) *err_pos = 0;
    return t.code;
  } catch (...) {
    return E_UNIMPLEMENTED;
  }
}

int zfi_index(const uint8_t* data, size_t len, int check_crc, Plan* out,
              int64_t* err_pos) {
  return zfi_index_ex(data, len, check_crc, 0, out, err_pos);
}

// Measure-only index for the fully device-side decode: walks the same
// bits as zfi_index but materializes no residual rows — the plan
// carries the Rice-group offset table, warm-ups, and sparse patches
// instead, and the accelerator's bit-unpack kernel recomputes the
// residual values from the bitstream (ops/rice.py). int32 streams only
// (returns E_SKIM_UNSUPPORTED=100 otherwise; caller falls back).
int zfi_index_skim(const uint8_t* data, size_t len, int check_crc,
                   Plan* out, int64_t* err_pos) {
  std::memset(out, 0, sizeof(Plan));
  try {
    BitReader br{data, len, 0};
    parse_stream_meta(br, out);
    uint32_t bps = out->si_bits_per_sample;
    uint32_t aligned = (bps + 7) & ~7u;
    if (aligned > 16) return 100;
    return index_stream_t<int32_t>(data, len, check_crc, bps, br, out,
                                   true, true);
  } catch (const Thrown& t) {
    if (err_pos) *err_pos = 0;
    return t.code;
  } catch (...) {
    return E_UNIMPLEMENTED;
  }
}

// Skim a byte range [start_byte, stop_byte): whole frames, structural
// parse only (stream-level rules are the caller's job, as in
// zfi_index_range). Single-threaded; the chunked pipeline threads
// around it. STREAMINFO fields must be pre-filled in `out`.
int zfi_skim_range(const uint8_t* data, size_t len, uint64_t start_byte,
                   uint64_t stop_byte, Plan* out, int check_crc,
                   int64_t* landed) {
  *landed = -1;
  uint32_t bps = out->si_bits_per_sample;
  uint32_t aligned = (bps + 7) & ~7u;
  if (aligned > 16) return 100;
  try {
    std::vector<Range<int32_t>> segs(1);
    Range<int32_t>& range = segs[0];
    range.skim = true;
    BitReader br{data, len, start_byte * 8};
    int err = OK;
    for (;;) {
      if (br.byte_pos() >= stop_byte) break;
      if (br.pos + 32 > br.nbits()) break;
      size_t subs_cp = range.subs.size();
      size_t g_cp = range.g_at.size();
      size_t w_cp = range.ex.warm.size();
      size_t p_cp = range.ex.p_sub.size();
      uint64_t pos_cp = br.pos;
      try {
        parse_frame<int32_t>(br, data, out->si_sample_rate, bps,
                             check_crc, check_crc, nullptr, range);
      } catch (const Thrown& t) {
        range.subs.resize(subs_cp);
        range.g_at.resize(g_cp);
        range.g_off.resize(g_cp);
        range.g_k.resize(g_cp);
        range.g_depth.resize(g_cp);
        range.ex.warm.resize(w_cp);
        range.ex.p_sub.resize(p_cp);
        range.ex.p_pos.resize(p_cp);
        range.ex.p_val.resize(p_cp);
        br.seek(pos_cp);
        err = t.code;
        break;
      }
    }
    *landed = (int64_t)br.byte_pos();
    pack_segments<int32_t>(segs, range.frames.size(), bps, out);
    return err;
  } catch (const Thrown& t) {
    return t.code;
  } catch (...) {
    return E_UNIMPLEMENTED;
  }
}

void zfi_free(Plan* p) {
  std::free(p->f_coded_number);
  std::free(p->grp_off);
  std::free(p->grp_k);
  std::free(p->grp_depth);
  std::free(p->f_block_size);
  std::free(p->f_channel_code);
  std::free(p->f_pcm_start);
  std::free(p->f_byte_offset);
  std::free(p->rows);
  std::free(p->kind);
  std::free(p->order);
  std::free(p->wasted);
  std::free(p->shift);
  std::free(p->coeffs_rev);
  std::free(p->seeds);
  std::free(p->wide);
  std::free(p->sk_warm);
  std::free(p->sk_patch_sub);
  std::free(p->sk_patch_pos);
  std::free(p->sk_patch_val);
  std::memset(p, 0, sizeof(Plan));
}

}  // extern "C"
