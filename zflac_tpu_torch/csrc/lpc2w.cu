// lpc2w and lpc2w33: the LPC recurrence of one order class with the
// reference's 64-bit accumulator (zflac.zig InterType i64 for 17-32
// bps), time-major.
//
// Replaces the Pallas kernels zflac_tpu/ops/lpc2w.py
// lpc2w_reconstruct_inline (K4, body _lpc2w_kernel, step _wide_step)
// and lpc2w33_reconstruct_inline (K5, body _lpc2w33_kernel, step
// _wide_step33). K4 serves the lpc8/16/32 classes of streams in the
// 32-bit container; K5 the classes of wide chunks, whose side channels
// carry 33-bit samples (32-bit stereo with decorrelation).
//
// Input: rows [B, n] (warm-up samples at t < order, residuals after;
// any row stride), int32 for K4 and int64 for K5; cfwd [hist, n] int32
// with row r = c_{r+1} (zero for r >= order; any row stride); shift
// [n]; order [n]. Output: out [B, n], int32 (K4) or int64 (K5).
//
// The transposed direct form of csrc/lpc2.cu: a pipeline P[hist] where
// P[r] holds the partial prediction for time t+1+r. Per step
// pred = P[0] >> shift, out = res + pred (t >= order), then
// P = shift_up(P) + c * out. The TPU kernels carry P as (hi, lo) int32
// pairs and emulate each 64-bit add and product, because Mosaic has no
// int64; here P is uint64 in registers (wrapping, defined in C++), the
// K4 product is one 32x32->64 multiply, and the K5 product one such
// multiply and a 32-bit one into the high word. The pair math equals this int64 math exactly over the
// domain the host scan admits: coefficients of at most 16 bits
// (precision field + 1), so every partial product of the TPU split is
// exact in int32, and K5's c * hi term wraps only in the high word.
//
// Shift semantics follow the JAX step math for every uint32 amount
// (the scan writes a 5-bit field, 0..31, so larger amounts come only
// from a corrupt buffer): K4's pred is the low word of acc >> shift,
// built there from uint32 shifts, so 0 for amounts >= 32; K5's low
// word is 0 likewise and its high word is an int32 arithmetic shift,
// the sign fill for amounts >= 32.
//
// What bounds it on the H100: the serial chain, as for lpc2. Each lane
// is one thread that walks all B time steps; a 24-bit stereo stream at
// block 4096 has some 1024 lanes in its lpc8 class, and each of
// decode_to_device's parallel-scan chunks a few hundred, so each SM
// runs one warp. Reading each input byte and writing each output byte
// once takes 0.010 ms at 3.35 TB/s on bench24's class.
//
// K4 (lpc2w) is redesigned on lpc2's ring (lpc_ring.cuh): residuals
// copied into 3 shared-memory stages of 128 steps by cp.async, 256
// steps ahead of the chain, read back 32 steps ahead into registers;
// the select for warm-ups only in a stage that holds some lane's
// warm-up; outputs stored as they are made. The earlier kernel, with loads
// 8 steps ahead, took 92-103 ns a step on bench24's class (PERF.md §6).
//
// The step itself has two forms, picked per warp at the start:
// - float64, when every coefficient of the warp's lanes lies in
//   [-2^15, 2^15], which holds for every buffer the host scan writes
//   (its coefficients have at most 16 bits). Products then have at
//   most 46 bits and sums of 32 at most 51, so the doubles hold exact
//   integers, each tap is one DFMA, and the prediction's low word is
//   the low word of fma_rd(P[0], 2^-shift, 1.5 * 2^52). In the SASS
//   (sm_90a; python3 -m zflac_tpu_torch.tools.kernel_sass) the chain
//   is DFMA.RM (the
//   rounded-down shift) -> IMAD.IADD (v = res + pred) -> I2F.F64 (v
//   back to a double) -> DFMA (P[0]' = c0 * v + P[1]), and a step at
//   hist 8 issues about 19 instructions (7 DFMA, a DMUL, the DFMA.RM,
//   the I2F, the add, the LDS, the STG and the output pointer).
// - int64, for any other coefficients: the low word of acc >> shift
//   is one funnel shift, the product one signed 32x32->64 multiply
//   (mad.wide.s32; the product of two sign-extended int64, as the
//   earlier kernel wrote it, compiles to IMAD.WIDE.U32 and two IMADs). Its chain is
//   five instructions: SHF.R.W.U32 -> IMAD.IADD -> IMAD.WIDE (ptxas
//   splits the multiply-add and gives the multiply a zero addend) ->
//   IADD3 and IMAD.X (+ P[1] with the carry) -> the next SHF, and a
//   step at hist 8 issues about 26 instructions (9 IMAD.WIDE, the
//   IADD3 / IADD3.X of the 64-bit sums).
//   No stream reaches this form: the 4-bit precision field (plus one)
//   caps a coefficient at 16 bits, even in a corrupt stream, so every
//   buffer the host scan writes takes the float64 step. It is kept because the op's contract, which its
//   plain version (ops/lpc2w.py) and lpc2w33 share, is the wrapping
//   int64 recurrence for any int32 coefficient: a direct call with a
//   wider coefficient still gets that, not a silently wrong float64
//   sum. chip_smoke.py's synthetic cases plant 21-bit coefficients in
//   one lane to hold it bit for bit. Its price is registers: with both
//   forms the kernel takes 128 / 168 / 254 registers at hist 8 / 16 /
//   32 (ptxas, no spills), 254 of the 255 a thread may have.
// lpc2's rewrite (P[1] + c0 * res) + c0 * pred does not hold in either:
// v wraps to 32 bits before it multiplies. An amount >= 32 zeroes the
// lane's coefficients instead of masking each prediction, so no AND
// sits on either chain.
//
// K5 (lpc2w33) runs on the same ring with the int64 step of
// lpc_steps.cuh (Int64Step), which lpc64 (csrc/lpc.cu) shares. Its
// earlier kernel, P and c in registers with residual loads issued 8
// steps ahead, took 101.8-110.8 ns a step on bench32ms's class: at that
// pace 8 steps cover less than one HBM round trip. Its outputs are
// int64 and a 33-bit side channel's sums pass 2^51, so lpc2w's float64
// step is not exact here. The int64 step instead splits each sample v
// into its low word read as signed and a high word h
// (lpc_steps::split), so that a tap c * v is one signed 32x32->64
// product and one 32-bit product into the high word, and it picks its
// shift form per warp, as lpc2w picks its step form: a warp whose
// amounts all lie in 0..31 shifts with two funnel shifts and no mask;
// any other warp runs the JAX rule (sign fill of the high word, zero
// low word for amounts >= 32). Its ring is 96 KB of dynamic shared
// memory a block (two blocks fit an SM), read 32 steps ahead at hist
// 8, 16 at hist 16 and 8 at hist 32 (lpc_ring.cuh). In the SASS a step
// issues about 40 / 72 / 137 instructions at hist 8 / 16 / 32 (a LOP3
// more in the JAX-rule form); ptxas gives 216 / 168 / 254 registers,
// no spills. Measured on an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py, CUDA events): 53.1 ns a step on bench32ms's class
// ([4096, 512], hist 8), 53.0-55.3 on the 8 chunks decode_to_device
// reconstructs ([4096, 128]), 171.8 at hist 32; the earlier kernel's
// 101.8-110.8 were on the same card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lpc_ring.cuh"
#include "lpc_steps.cuh"

namespace {

// (u)int64 = (int32) a * (int32) b + c: one signed 32x32->64 multiply
// (the product of two sign-extended int64 compiles to IMAD.WIDE.U32
// and two more IMADs).
__device__ __forceinline__ uint64_t mad_wide(int32_t a, int32_t b,
                                             uint64_t c) {
  uint64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

template <int HIST>
struct Lpc2wStep {
  static constexpr int kHist = HIST;
  int32_t c[HIST];
  uint64_t P[HIST];
  int sh;
  int ord;

  // One step: the output at time t from its residual (or warm-up).
  template <bool WARM>
  __device__ __forceinline__ int32_t run(int32_t res, int t) {
    // The low word of acc >> sh (sh <= 31) is one funnel shift.
    const uint32_t pred =
        __funnelshift_r((uint32_t)P[0], (uint32_t)(P[0] >> 32), sh);
    uint32_t v = (uint32_t)res + pred;
    if (WARM && t < ord) v = (uint32_t)res;
#pragma unroll
    for (int r = 0; r < HIST - 1; ++r)
      P[r] = mad_wide(c[r], (int32_t)v, P[r + 1]);
    P[HIST - 1] = mad_wide(c[HIST - 1], (int32_t)v, 0ull);
    return (int32_t)v;
  }
};

// The same step in float64, exact while every |c| <= 2^15: each
// product then has at most 46 bits and a sum of 32 at most 51, so P
// holds exact integers and every fma is exact. P[0] * 2^-sh +
// 1.5 * 2^52, rounded down, has floor(P[0] / 2^sh) in its low mantissa
// bits (|quotient| < 2^51), so the low word of that double is the low
// word of acc >> sh, the int64 step's prediction.
template <int HIST>
struct Lpc2wF64Step {
  static constexpr int kHist = HIST;
  double c[HIST];
  double P[HIST];
  double scale;  // 2^-sh
  int ord;

  template <bool WARM>
  __device__ __forceinline__ int32_t run(int32_t res, int t) {
    const double f = __fma_rd(P[0], scale, 6755399441055744.0);
    uint32_t pred = (uint32_t)__double2loint(f);
    if (WARM && t < ord) pred = 0u;
    const uint32_t v = (uint32_t)res + pred;
    const double vd = (double)(int32_t)v;
#pragma unroll
    for (int r = 0; r < HIST - 1; ++r) P[r] = fma(c[r], vd, P[r + 1]);
    P[HIST - 1] = c[HIST - 1] * vd;
    return (int32_t)v;
  }
};

template <int HIST>
__global__ void __launch_bounds__(lpc_ring::kLanes)
    lpc2w_kernel(const int32_t* __restrict__ rows, int ld_rows,
                 const int32_t* __restrict__ cfwd, int ld_cf,
                 const int32_t* __restrict__ shift,
                 const int32_t* __restrict__ order,
                 int32_t* __restrict__ out, int b, int n) {
  extern __shared__ __align__(16) int32_t ring[];
  const int s = blockIdx.x * lpc_ring::kLanes + threadIdx.x;
  const int sc = min(s, n - 1);
  // An amount >= 32 (only a corrupt buffer holds one) makes every
  // prediction 0: zero coefficients keep P at 0, and the funnel shift
  // of 0 by 0 is that 0, with no mask on the chain.
  const uint32_t sh_u = (uint32_t)__ldg(shift + sc);
  const bool sh_ok = sh_u < 32u;
  int32_t c[HIST];
  bool small = true;
#pragma unroll
  for (int r = 0; r < HIST; ++r) {
    c[r] = sh_ok ? __ldg(cfwd + (size_t)r * ld_cf + sc) : 0;
    small = small && c[r] >= -32768 && c[r] <= 32768;
  }
  const int ord = __ldg(order + sc);
  if (__all_sync(0xFFFFFFFFu, small)) {
    Lpc2wF64Step<HIST> step;
#pragma unroll
    for (int r = 0; r < HIST; ++r) {
      step.c[r] = (double)c[r];
      step.P[r] = 0.0;
    }
    step.scale = ldexp(1.0, sh_ok ? -(int)sh_u : 0);
    step.ord = ord;
    lpc_ring::drive(rows, ld_rows, out, b, n, ring, ord, step);
  } else {
    Lpc2wStep<HIST> step;
#pragma unroll
    for (int r = 0; r < HIST; ++r) {
      step.c[r] = c[r];
      step.P[r] = 0u;
    }
    step.sh = sh_ok ? (int)sh_u : 0;
    step.ord = ord;
    lpc_ring::drive(rows, ld_rows, out, b, n, ring, ord, step);
  }
}

template <int HIST>
__global__ void __launch_bounds__(lpc_ring::kLanes, 1)
    lpc2w33_kernel(const int64_t* __restrict__ rows, int ld_rows,
                   const int32_t* __restrict__ cfwd, int ld_cf,
                   const int32_t* __restrict__ shift,
                   const int32_t* __restrict__ order,
                   int64_t* __restrict__ out, int b, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* ring = reinterpret_cast<int64_t*>(smem);
  const int sc = min((int)(blockIdx.x * lpc_ring::kLanes + threadIdx.x),
                     n - 1);
  int32_t c[HIST];
#pragma unroll
  for (int r = 0; r < HIST; ++r) c[r] = __ldg(cfwd + (size_t)r * ld_cf + sc);
  const uint32_t sh_u = (uint32_t)__ldg(shift + sc);
  const int ord = __ldg(order + sc);
  using lpc_steps::Int64Step;
  using lpc_steps::Shift;
  if (__all_sync(0xFFFFFFFFu, sh_u < 32u))
    lpc_ring::run<Int64Step<HIST, Shift::kPlain>>(c, sh_u, ord, rows,
                                                  ld_rows, out, b, n, ring);
  else
    lpc_ring::run<Int64Step<HIST, Shift::kHighSign>>(c, sh_u, ord, rows,
                                                     ld_rows, out, b, n,
                                                     ring);
}

}  // namespace

extern "C" int zft_lpc2w(const void* rows, int ld_rows, const void* cfwd,
                         int ld_cf, const void* shift, const void* order,
                         void* out, int b, int n, int hist, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hist) {
    case 8:
      return lpc_ring::launch<int32_t>(lpc2w_kernel<8>, b, n, st, rows,
                                       ld_rows, cfwd, ld_cf, shift, order,
                                       out);
    case 16:
      return lpc_ring::launch<int32_t>(lpc2w_kernel<16>, b, n, st, rows,
                                       ld_rows, cfwd, ld_cf, shift, order,
                                       out);
    case 32:
      return lpc_ring::launch<int32_t>(lpc2w_kernel<32>, b, n, st, rows,
                                       ld_rows, cfwd, ld_cf, shift, order,
                                       out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int zft_lpc2w33(const void* rows, int ld_rows, const void* cfwd,
                           int ld_cf, const void* shift, const void* order,
                           void* out, int b, int n, int hist, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hist) {
    case 8:
      return lpc_ring::launch<int64_t>(lpc2w33_kernel<8>, b, n, st, rows,
                                       ld_rows, cfwd, ld_cf, shift, order,
                                       out);
    case 16:
      return lpc_ring::launch<int64_t>(lpc2w33_kernel<16>, b, n, st, rows,
                                       ld_rows, cfwd, ld_cf, shift, order,
                                       out);
    case 32:
      return lpc_ring::launch<int64_t>(lpc2w33_kernel<32>, b, n, st, rows,
                                       ld_rows, cfwd, ld_cf, shift, order,
                                       out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
