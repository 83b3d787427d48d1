// The LPC recurrence steps that lpc_ring::drive runs, one lane per
// thread, shared by lpc2.cu, lpc2w.cu and lpc.cu.
//
// Every step is the transposed direct form: a pipeline P[HIST] where
// P[r] holds the partial prediction for time t+1+r from every sample
// produced so far, and c[r] multiplies the sample r+1 steps back. Per
// step pred = P[0] >> shift, out = res + pred (t >= order; warm-ups
// pass through), then P = shift_up(P) + c * out. Sums and products run
// unsigned, so they wrap as the reference's do (defined in C++), and a
// wrapping sum in another order is the same sum bit for bit.
//
// Each step has HIST (kHist) as a template argument, so P and c are
// registers, and init(c, shift, order) with the lane's coefficients in
// c[0..HIST) and its shift amount as stored (read unsigned); lanes
// whose coefficients past HIST are not all zero must not take it.
// run<WARM>(res, t) returns the output at time t; WARM is true only in
// a stage in which some lane of the warp is still inside its warm-up.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lpc_steps {

// The int32 step (lpc2, K6 lpc): sums wrap at 32 bits; the arithmetic
// right shift takes its amount read unsigned and clamped to 31, which
// is XLA's sign fill for any amount >= 32.
//
// P[0]' = P[1] + c0 * (res + pred) is computed as
// (P[1] + c0 * res) + c0 * pred (equal mod 2^32), whose first sum is
// ready before pred is: the chain is one shift and one multiply-add.
template <int HIST>
struct Lpc2Step {
  static constexpr int kHist = HIST;
  uint32_t c[HIST];
  uint32_t P[HIST];
  int sh;
  int ord;

  __device__ __forceinline__ void init(const int32_t* cf, uint32_t sh_u,
                                       int order) {
#pragma unroll
    for (int r = 0; r < HIST; ++r) {
      c[r] = (uint32_t)cf[r];
      P[r] = 0u;
    }
    sh = sh_u < 32u ? (int)sh_u : 31;
    ord = order;
  }

  template <bool WARM>
  __device__ __forceinline__ int32_t run(int32_t res, int t) {
    const uint32_t x0 = P[1] + (uint32_t)res * c[0];
    uint32_t pred = (uint32_t)(((int32_t)P[0]) >> sh);
    if (WARM && t < ord) pred = 0u;
    const uint32_t v = (uint32_t)res + pred;
    P[0] = x0 + pred * c[0];
#pragma unroll
    for (int r = 1; r < HIST - 1; ++r) P[r] = P[r + 1] + v * c[r];
    P[HIST - 1] = v * c[HIST - 1];
    return (int32_t)v;
  }
};

// A 64-bit value v as s + h * 2^32 with s its low word read as signed
// (h = high word + the low word's top bit): then c * v (c int32) is the
// signed 32x32->64 product c * s plus c * h in the high word, two
// instructions (IMAD.WIDE, IMAD) where the product of two sign-extended
// int64 takes three.
struct Split {
  int32_t s;
  int32_t h;
};

__device__ __forceinline__ Split split(uint64_t v) {
  const uint32_t lo = (uint32_t)v;
  return {(int32_t)lo, (int32_t)((uint32_t)(v >> 32) + (lo >> 31))};
}

// a + c * v (mod 2^64).
__device__ __forceinline__ uint64_t mad64(int32_t c, Split v, uint64_t a) {
  uint64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(c), "r"(v.s), "l"(a));
  const uint32_t hi = (uint32_t)(d >> 32) + (uint32_t)c * (uint32_t)v.h;
  return ((uint64_t)hi << 32) | (uint32_t)d;
}

// How an int64 step shifts the prediction.
enum class Shift {
  // Every amount of the warp lies in 0..31: a 64-bit arithmetic shift
  // as two funnel shifts (SHF.R.W.U32, SHF.R.S32.HI), no mask.
  kPlain,
  // lpc2w33 (the JAX pair math's uint32 shifts): an amount >= 32 gives
  // the sign fill of the high word and a zero low word: the two shifts
  // by 63 and a mask (a LOP3 more on the chain).
  kHighSign,
  // lpc64 (XLA's int64 right shift): an amount >= 64, read unsigned,
  // gives the sign fill; 32..63 shift the whole 64 bits. The amount is
  // clamped to 63 once, and the shift is two instructions, as kPlain's
  // (SHF.R.S64, SHF.R.S32.HI), so lpc64 needs no form of its own for
  // amounts in 0..31.
  kClamp63,
};

// The int64 step (lpc2w33, lpc64): int64 samples, int32 coefficients,
// sums wrapping at 64 bits. lpc2's chain cut, P[0]' = (P[1] + c0 * res)
// + c0 * pred, holds here too (res + pred is not truncated before it
// multiplies), but it adds a product and two splits to a step that a
// lone warp issues instruction by instruction; built and timed against
// this step on the H100 it was slower at hist 8 and no faster at hist
// 32, so the step multiplies v as it is.
//
// In the SASS (sm_90a; python3 -m zflac_tpu_torch.tools.kernel_sass) a
// step at hist 8 issues about 40 instructions (a LOP3 more in the
// kHighSign form): per tap an IMAD.WIDE with a zero addend, the 64-bit
// add of P[r+1] as IADD3 and IADD3.X (or IMAD.X), and the IMAD into the
// high word. ptxas splits the add off mad.wide.s32 as it does in
// lpc2w's int64 step, so a tap is four instructions, not the two the
// PTX asks for; then the two funnel shifts, the LEA.HI of split, the
// 64-bit add of v, the select, the LDS and the STG.
template <int HIST, Shift RULE>
struct Int64Step {
  static constexpr int kHist = HIST;
  int32_t c[HIST];
  uint64_t P[HIST];
  int sh;
  uint64_t keep;  // kHighSign: the bits of the shifted sum kept
  int ord;

  __device__ __forceinline__ void init(const int32_t* cf, uint32_t sh_u,
                                       int order) {
#pragma unroll
    for (int r = 0; r < HIST; ++r) {
      c[r] = cf[r];
      P[r] = 0ull;
    }
    const bool big = sh_u >= 32u;
    if (RULE == Shift::kClamp63)
      sh = sh_u < 64u ? (int)sh_u : 63;
    else
      sh = big ? 63 : (int)sh_u;  // kPlain: every lane has sh_u < 32
    keep = big ? 0xFFFFFFFF00000000ull : ~0ull;
    ord = order;
  }

  __device__ __forceinline__ uint64_t predict(uint64_t p) const {
    if (RULE == Shift::kPlain) {
      const uint32_t lo = (uint32_t)p, hi = (uint32_t)(p >> 32);
      return ((uint64_t)(uint32_t)((int32_t)hi >> sh) << 32) |
             __funnelshift_r(lo, hi, sh);
    }
    const uint64_t q = (uint64_t)((int64_t)p >> sh);
    return RULE == Shift::kHighSign ? q & keep : q;
  }

  template <bool WARM>
  __device__ __forceinline__ int64_t run(int64_t res, int t) {
    uint64_t pred = predict(P[0]);
    if (WARM && t < ord) pred = 0ull;
    const uint64_t v = (uint64_t)res + pred;
    const Split vs = split(v);
#pragma unroll
    for (int r = 0; r < HIST - 1; ++r) P[r] = mad64(c[r], vs, P[r + 1]);
    P[HIST - 1] = mad64(c[HIST - 1], vs, 0ull);
    return (int64_t)v;
  }
};

}  // namespace lpc_steps
