// rice16: Rice and escaped residuals out of the scan's per-group bit
// windows, written as time-major rows.
//
// Replaces the Pallas kernel zflac_tpu/ops/rice16.py
// rice16_unpack_rows_inline (bodies _rice16_kernel4 and _rice16_kernel,
// math _unpack16_list). Both TPU call sites (the 4-D sublane view for
// Ssort % 1024 == 0 and the 2-D row form) are tiling choices of one
// function; this one kernel serves both.
//
// Input: win [W, NGp] window words (uint32 bits in an int32 tensor),
// meta [NGp] (pos0:5 | k:6 | depth:5 | skip:5; k 62 = escape, 63 =
// invalid group), group slot g = p * Ssort + s. Output: out
// [(NGp / Ssort) * 8, Ssort] int32, residual j of slot g at row p*8 + j,
// lane s. With Ssort = NGp this is the flat [8, NG] layout of
// rice16_unpack_inline (zflac_tpu/ops/rice16.py:160), which the port
// launches as rice16_flat (ops/rice16.py rice16_unpack).
//
// What bounds it on the H100: bytes. Each slot reads W + 1 words and
// writes 8 (68 B at W = 8), about 70 MB on the bench stream, so
// ~21 us at the card's 3.35 TB/s. The instructions come close: on the
// bench stream's 8.4 M residuals, every 10 instructions a residual
// issue in ~3 us on the card's 132 SMs. The first kernel kept each
// thread's W words in registers and found the word under the read
// position with an unrolled compare-select over up to W - 2 words: 73
// instructions a residual at W 8, 87 at W 16; this one's Rice path
// issues 35 (python3 -m zflac_tpu_torch.tools.kernel_sass).
//
// Design: a block of kSlots threads decodes tiles of kSlots consecutive
// slots, one slot a thread. The tile's [W, kSlots] window words and its
// meta words are copied into shared memory with cp.async (16 bytes a
// copy when win, meta and NGp allow it, else 4), and the grid is sized
// from the SM count and the kernel's occupancy, so a block walks
// several tiles of a large chunk and copies tile i + 1 while it decodes
// tile i (two buffers and three zero rows: 21 KB at W 8, 37 KB at
// W 16). A thread reads the
// word under its read position directly, win_s[pos >> 5][slot]: the
// bank is slot mod 32, so a warp's reads never conflict, whatever word
// each thread is at. The TPU kernel's bound stays: residual j starts at
// most (31 + 64 j) >> 5 words in, capped at W - 3, and words past that
// bound read as 0 (the reads then go to three zero rows of shared
// memory, so one select of an address replaces three of values). The
// shifts are funnel shifts, whose clamped forms give XLA's 0 for an
// amount of 32 without a select; invalid, escaped and Rice groups run
// separate loops. Writes out[(p*8 + j)*Ssort + s] coalesce across s;
// they are plain stores, since the stages after this kernel read the
// rows back while L2 may still hold them. All bit arithmetic is
// uint32, and the shifts the JAX math may take by 32 or more give 0 as
// XLA's do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kG2 = 8;        // residuals per group (kG2 in pack2_helpers.inc)
constexpr int kEscape = 62;
constexpr int kInvalid = 63;
constexpr int kSlots = 256;   // group slots a tile, one a thread

template <int BYTES>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until the newest committed group alone may still be pending.
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy tile `tile` into `sm` [W + 1][kSlots]: row c < W from win's row
// c, row W from meta. Slots past NGp are not copied (no thread decodes
// them). With vec, NGp % 4 == 0, so a tile's slots come in whole
// 16-byte pieces.
template <int W>
__device__ __forceinline__ void stage(uint32_t (*sm)[kSlots],
                                      const uint32_t* win,
                                      const uint32_t* meta, int ngp, int tile,
                                      bool vec) {
  const int g0 = tile * kSlots;
  const int n = min(kSlots, ngp - g0);
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(&sm[0][0]);
  if (vec) {
    constexpr int kPieces = kSlots / 4;  // 16-byte pieces a row
    for (int i = threadIdx.x; i < (W + 1) * kPieces; i += kSlots) {
      const int c = i / kPieces;
      const int q = (i % kPieces) * 4;
      if (q < n) {
        const uint32_t* src = (c < W ? win + (size_t)c * ngp : meta) + g0 + q;
        copy_async<16>(base + (uint32_t)(c * kSlots + q) * 4u, src);
      }
    }
  } else {
    for (int i = threadIdx.x; i < (W + 1) * kSlots; i += kSlots) {
      const int c = i / kSlots;
      const int q = i % kSlots;
      if (q < n) {
        const uint32_t* src = (c < W ? win + (size_t)c * ngp : meta) + g0 + q;
        copy_async<4>(base + (uint32_t)i * 4u, src);
      }
    }
  }
}

// Slot s of the staged tile ws (global slot g): its 8 residuals. An
// invalid group stores zeros, an escaped one depth-bit values, a Rice
// one its quotients and remainders; the three run as separate loops,
// a branch that is uniform over a warp unless its slots mix kinds. The
// three words at the read position come from ws, or from zs (three
// zero rows) when residual j starts past its bound.
template <int W>
__device__ __forceinline__ void decode_slot(uint32_t (*ws)[kSlots],
                                            uint32_t (*zs)[kSlots], int s,
                                            int g, int32_t* __restrict__ out,
                                            int ssort) {
  const int32_t m = (int32_t)ws[W][s];
  int pos = m & 31;
  const int k6 = (m >> 5) & 63;
  const int depth = (m >> 11) & 31;
  const int skip = (m >> 16) & 31;
  const int p = g / ssort;
  int32_t* o = out + (size_t)p * kG2 * ssort + (g - p * ssort);
  // The words at pos for residual j: (w0, w1, w2) from rows wi..wi+2,
  // or zeros past the last word index residual j can start in
  // ((31 + 64 j) >> 5, capped at W - 3; static after unrolling).
  auto words = [&](int j, uint32_t& w0, uint32_t& w1, uint32_t& w2) {
    const int hi = min((31 + 64 * j) >> 5, W - 3);
    const int wi = pos >> 5;
    const uint32_t* row = wi <= hi ? &ws[wi][s] : &zs[0][s];
    w0 = row[0];
    w1 = row[kSlots];
    w2 = row[2 * kSlots];
  };
  if (k6 == kInvalid) {
#pragma unroll
    for (int j = 0; j < kG2; ++j) o[(size_t)j * ssort] = 0;
  } else if (k6 == kEscape) {
    // A depth-bit signed value (arithmetic shift), 0 at depth 0.
    const int du = min(32 - depth, 31);
#pragma unroll
    for (int j = 0; j < kG2; ++j) {
      const bool active = j >= skip;
      uint32_t w0, w1, w2;
      words(j, w0, w1, w2);
      const int32_t chunk = (int32_t)__funnelshift_l(w1, w0, pos);
      const int32_t v = depth > 0 ? chunk >> du : 0;
      o[(size_t)j * ssort] = active ? v : 0;
      if (active) pos += depth;
    }
  } else {
    const uint32_t kk = (uint32_t)k6;
    // The remainder's right shift, 32 - kk, and 32 (which gives 0)
    // where XLA's shift gives 0: kk 0, and kk > 32, where 32 - kk wraps.
    const uint32_t rs = (kk >= 1u && kk <= 32u) ? 32u - kk : 32u;
#pragma unroll
    for (int j = 0; j < kG2; ++j) {
      const bool active = j >= skip;
      uint32_t w0, w1, w2;
      words(j, w0, w1, w2);
      // The 64 bits at pos: the high words of (w0:w1) and (w1:w2)
      // shifted left by pos & 31.
      const uint32_t chunk = __funnelshift_l(w1, w0, pos);
      const uint32_t chunk2 = __funnelshift_l(w2, w1, pos);
      // Unary quotient; __clz(0) == 32.
      const int zeros =
          chunk != 0u ? __clz((int)chunk) : 32 + __clz((int)chunk2);
      const uint32_t sh = (uint32_t)min(zeros + 1, 41);
      // The 32 bits after the stop bit, (chunk:chunk2) << sh: the
      // clamped funnel shift takes sh up to 32, the shift after it the
      // rest (sh <= 41).
      const uint32_t fhi = __funnelshift_lc(chunk2, chunk, sh)
                           << (uint32_t)max((int)sh - 32, 0);
      const uint32_t rem = __funnelshift_rc(fhi, 0u, rs);
      // zeros << kk, and 0 for kk >= 32 (the clamped shift by 32).
      const uint32_t zz = __funnelshift_lc(0u, (uint32_t)zeros, kk) | rem;
      const int32_t v = (int32_t)((zz >> 1) ^ (0u - (zz & 1u)));
      o[(size_t)j * ssort] = active ? v : 0;
      if (active) pos += zeros + 1 + (int)kk;
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kSlots)
    rice16_rows_kernel(const uint32_t* __restrict__ win,
                       const uint32_t* __restrict__ meta,
                       int32_t* __restrict__ out, int ngp, int ssort,
                       int vec) {
  __shared__ __align__(16) uint32_t sm[2][W + 1][kSlots];
  __shared__ uint32_t zs[3][kSlots];
  for (int i = threadIdx.x; i < 3 * kSlots; i += kSlots) (&zs[0][0])[i] = 0u;
  const int tiles = (ngp + kSlots - 1) / kSlots;
  int tile = blockIdx.x;
  if (tile < tiles) stage<W>(sm[0], win, meta, ngp, tile, vec);
  commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles) stage<W>(sm[buf ^ 1], win, meta, ngp, next, vec);
    commit();
    wait_all_but_newest();  // this thread's copies of `tile` landed
    __syncthreads();        // and every other thread's
    const int g = tile * kSlots + threadIdx.x;
    if (g < ngp) decode_slot<W>(sm[buf], zs, threadIdx.x, g, out, ssort);
    __syncthreads();  // the buffer is refilled in the next iteration
  }
}

template <int W>
int launch(const uint32_t* win, const uint32_t* meta, int32_t* out, int ngp,
           int ssort, int device, cudaStream_t st) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // Blocks an SM holds at once (registers and shared memory), asked
  // once an instantiation.
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rice16_rows_kernel<W>,
                                                  kSlots, 0);
    return n > 0 ? n : 1;
  }();
  const int tiles = (ngp + kSlots - 1) / kSlots;
  const int most = sms * per_sm;
  const int vec = ((uintptr_t)win % 16 == 0) && ((uintptr_t)meta % 16 == 0) &&
                  ngp % 4 == 0;
  rice16_rows_kernel<W><<<tiles < most ? tiles : most, kSlots, 0, st>>>(
      win, meta, out, ngp, ssort, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zft_rice16_rows(const void* win, const void* meta, void* out,
                               int w, int ngp, int ssort, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ngp <= 0 || ssort <= 0 || ngp % ssort != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* wp = (const uint32_t*)win;
  const uint32_t* mp = (const uint32_t*)meta;
  int32_t* op = (int32_t*)out;
  if (w == 8) return launch<8>(wp, mp, op, ngp, ssort, device, st);
  if (w == 16) return launch<16>(wp, mp, op, ngp, ssort, device, st);
  return (int)cudaErrorInvalidValue;
}

// Shared by every launcher's caller: the text of a returned status.
extern "C" const char* zft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
