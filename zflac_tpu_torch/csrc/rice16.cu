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
// ~20 us at the card's 3.35 TB/s; the arithmetic (a clz and a few
// shifts per residual) is far below the ALU rate.
//
// Design: one thread per group slot. The thread loads its W window
// words at stride NGp (consecutive threads read consecutive addresses,
// so every load is coalesced) into registers, then decodes its 8
// residuals. The word under the read position is picked by an unrolled
// select over static register indices, bounded as the TPU kernel bounds
// it (residual j starts at most 64*j + 31 bits in), so the window never
// spills to local memory. Writes out[(p*8 + j)*Ssort + s] coalesce
// across s. All bit arithmetic is uint32; every shift amount is kept in
// [0, 31] ((x >> 1) >> (31 - b) for x >> (32 - b)), and the shifts the
// JAX math may take by 32 or more are written to give 0 as XLA does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kG2 = 8;        // residuals per group (kG2 in pack2_helpers.inc)
constexpr int kEscape = 62;
constexpr int kInvalid = 63;

template <int W>
__global__ void rice16_rows_kernel(const uint32_t* __restrict__ win,
                                   const int32_t* __restrict__ meta,
                                   int32_t* __restrict__ out, int ngp,
                                   int ssort) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ngp) return;
  uint32_t w[W];
#pragma unroll
  for (int c = 0; c < W; ++c) w[c] = __ldg(win + (size_t)c * ngp + g);
  const int32_t m = __ldg(meta + g);
  int pos = m & 31;
  const int k6 = (m >> 5) & 63;
  const int depth = (m >> 11) & 31;
  const int skip = (m >> 16) & 31;
  const bool valid = k6 != kInvalid;
  const bool escape = k6 == kEscape;
  const uint32_t kk = (escape || !valid) ? 0u : (uint32_t)k6;
  const int du = min(32 - depth, 31);
  const int p = g / ssort;
  const int s = g - p * ssort;
  int32_t* o = out + (size_t)p * kG2 * ssort + s;

#pragma unroll
  for (int j = 0; j < kG2; ++j) {
    const bool active = valid && j >= skip;
    const int wi = pos >> 5;
    const uint32_t b = (uint32_t)(pos & 31);
    // Static after unrolling: the last word index residual j can start in.
    const int hi = min((31 + 64 * j) >> 5, W - 3);
    uint32_t w0, w1, w2;
    if (hi == 0) {
      w0 = w[0];
      w1 = w[1];
      w2 = w[2];
    } else {
      w0 = w1 = w2 = 0u;  // past the bound: reads as 0, as on the TPU
#pragma unroll
      for (int c = 0; c < W - 2; ++c) {
        if (c <= hi && wi == c) {
          w0 = w[c];
          w1 = w[c + 1];
          w2 = w[c + 2];
        }
      }
    }
    const uint32_t chunk = (w0 << b) | ((w1 >> 1) >> (31u - b));
    const uint32_t chunk2 = (w1 << b) | ((w2 >> 1) >> (31u - b));

    // Unary quotient from the 64 bits at pos; __clz(0) == 32.
    const int zeros =
        chunk != 0u ? __clz((int)chunk) : 32 + __clz((int)chunk2);
    const uint32_t sh = (uint32_t)min(zeros + 1, 41);
    const uint32_t fhi =
        sh < 32u ? (chunk << sh) | ((chunk2 >> 1) >> (31u - sh))
                 : chunk2 << (sh & 31u);
    const uint32_t rs = 32u - kk;  // wraps for kk > 32: the shift gives 0
    const uint32_t rem = (kk > 0u && rs < 32u) ? fhi >> rs : 0u;
    const uint32_t zz = (kk < 32u ? (uint32_t)zeros << kk : 0u) | rem;
    const int32_t rice_val = (int32_t)((zz >> 1) ^ (0u - (zz & 1u)));
    const int rice_adv = zeros + 1 + (int)kk;

    // Escaped partition: depth-bit signed value (arithmetic shift).
    const int32_t esc_val = depth > 0 ? ((int32_t)chunk) >> du : 0;

    const int32_t value = escape ? esc_val : rice_val;
    const int adv = escape ? depth : rice_adv;
    o[(size_t)j * ssort] = active ? value : 0;
    if (active) pos += adv;
  }
}

}  // namespace

extern "C" int zft_rice16_rows(const void* win, const void* meta, void* out,
                               int w, int ngp, int ssort, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ngp <= 0 || ssort <= 0 || ngp % ssort != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (ngp + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* wp = (const uint32_t*)win;
  const int32_t* mp = (const int32_t*)meta;
  int32_t* op = (int32_t*)out;
  if (w == 8) {
    rice16_rows_kernel<8><<<blocks, threads, 0, st>>>(wp, mp, op, ngp, ssort);
  } else if (w == 16) {
    rice16_rows_kernel<16><<<blocks, threads, 0, st>>>(wp, mp, op, ngp, ssort);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Shared by every launcher's caller: the text of a returned status.
extern "C" const char* zft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
