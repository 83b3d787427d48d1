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
// K4 product is one 32x32->64 multiply, and the K5 product a 64-bit
// multiply. The pair math equals this int64 math exactly over the
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
// block 4096 has some 1024 lanes per chunk. The chain per step is one
// 64-bit shift (a funnel shift of two words), a 32-bit (K4) or 64-bit
// (K5) add, and the multiply-add into P[0], a 64-bit add of two
// instructions where lpc2 has one. Predicted before the first card
// run: K4 about 1.5x lpc2's 84 ns per step at hist 8 (~125 ns), K5
// about 2x (~170 ns); measured on an H100 80GB HBM3 at 700 W at the
// bench streams' shapes, 92.5 and 114.2 ns (PERF.md §6). The
// compiler builds the signed 32x32->64 product from IMAD.WIDE.U32
// and two IMADs, which sit on the chain too. The design is lpc2's:
// P and c in registers (HIST is a template argument, so every index
// is static; at hist 32 P takes 64 registers: 62/100/164 registers in
// all for K4 at hist 8/16/32, 76/126/186 for K5, no spills), residual
// loads issued a group of 8 ahead so they sit off the chain, loads and
// stores coalesced across lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;

template <int HIST>
__global__ void lpc2w_kernel(const int32_t* __restrict__ rows, int ld_rows,
                             const int32_t* __restrict__ cfwd, int ld_cf,
                             const int32_t* __restrict__ shift,
                             const int32_t* __restrict__ order,
                             int32_t* __restrict__ out, int b, int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  int32_t c[HIST];
  uint64_t P[HIST];
#pragma unroll
  for (int r = 0; r < HIST; ++r) {
    c[r] = __ldg(cfwd + (size_t)r * ld_cf + s);
    P[r] = 0u;
  }
  const uint32_t sh_u = (uint32_t)__ldg(shift + s);
  const int sh = sh_u < 32u ? (int)sh_u : 0;
  const uint32_t keep = sh_u < 32u ? 0xFFFFFFFFu : 0u;
  const int ord = __ldg(order + s);
  const int32_t* in = rows + s;
  int32_t* o = out + s;

  int32_t cur[kUnroll], nxt[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) cur[u] = __ldg(in + (size_t)u * ld_rows);
  for (int t0 = 0; t0 < b; t0 += kUnroll) {
    if (t0 + kUnroll < b) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        nxt[u] = __ldg(in + (size_t)(t0 + kUnroll + u) * ld_rows);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const uint32_t pred = (uint32_t)((int64_t)P[0] >> sh) & keep;
      const uint32_t v =
          t >= ord ? (uint32_t)cur[u] + pred : (uint32_t)cur[u];
      o[(size_t)t * n] = (int32_t)v;
      const int64_t vi = (int32_t)v;
#pragma unroll
      for (int r = 0; r < HIST - 1; ++r)
        P[r] = P[r + 1] + (uint64_t)((int64_t)c[r] * vi);
      P[HIST - 1] = (uint64_t)((int64_t)c[HIST - 1] * vi);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
}

template <int HIST>
__global__ void lpc2w33_kernel(const int64_t* __restrict__ rows,
                               int ld_rows,
                               const int32_t* __restrict__ cfwd, int ld_cf,
                               const int32_t* __restrict__ shift,
                               const int32_t* __restrict__ order,
                               int64_t* __restrict__ out, int b, int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  int32_t c[HIST];
  uint64_t P[HIST];
#pragma unroll
  for (int r = 0; r < HIST; ++r) {
    c[r] = __ldg(cfwd + (size_t)r * ld_cf + s);
    P[r] = 0u;
  }
  const uint32_t sh_u = (uint32_t)__ldg(shift + s);
  const int sh = sh_u < 32u ? (int)sh_u : 63;
  const uint64_t keep = sh_u < 32u ? ~0ull : 0xFFFFFFFF00000000ull;
  const int ord = __ldg(order + s);
  const int64_t* in = rows + s;
  int64_t* o = out + s;

  int64_t cur[kUnroll], nxt[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) cur[u] = __ldg(in + (size_t)u * ld_rows);
  for (int t0 = 0; t0 < b; t0 += kUnroll) {
    if (t0 + kUnroll < b) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        nxt[u] = __ldg(in + (size_t)(t0 + kUnroll + u) * ld_rows);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const uint64_t pred = (uint64_t)((int64_t)P[0] >> sh) & keep;
      const uint64_t v =
          t >= ord ? (uint64_t)cur[u] + pred : (uint64_t)cur[u];
      o[(size_t)t * n] = (int64_t)v;
#pragma unroll
      for (int r = 0; r < HIST - 1; ++r)
        P[r] = P[r + 1] + (uint64_t)(int64_t)c[r] * v;
      P[HIST - 1] = (uint64_t)(int64_t)c[HIST - 1] * v;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
}

template <typename T>
using Kernel = void (*)(const T*, int, const int32_t*, int, const int32_t*,
                        const int32_t*, T*, int, int);

// One warp per block, as lpc2: the few lanes spread over as many SMs
// as possible.
template <typename T>
int launch(Kernel<T> kern, const void* rows, int ld_rows, const void* cfwd,
           int ld_cf, const void* shift, const void* order, void* out, int b,
           int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kern == nullptr || b <= 0 || b % kUnroll != 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const int blocks = (n + threads - 1) / threads;
  kern<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)rows, ld_rows, (const int32_t*)cfwd, ld_cf,
      (const int32_t*)shift, (const int32_t*)order, (T*)out, b, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zft_lpc2w(const void* rows, int ld_rows, const void* cfwd,
                         int ld_cf, const void* shift, const void* order,
                         void* out, int b, int n, int hist, int device,
                         void* stream) {
  const Kernel<int32_t> kern = hist == 8    ? lpc2w_kernel<8>
                               : hist == 16 ? lpc2w_kernel<16>
                               : hist == 32 ? lpc2w_kernel<32>
                                            : nullptr;
  return launch<int32_t>(kern, rows, ld_rows, cfwd, ld_cf, shift, order, out,
                         b, n, device, stream);
}

extern "C" int zft_lpc2w33(const void* rows, int ld_rows, const void* cfwd,
                           int ld_cf, const void* shift, const void* order,
                           void* out, int b, int n, int hist, int device,
                           void* stream) {
  const Kernel<int64_t> kern = hist == 8    ? lpc2w33_kernel<8>
                               : hist == 16 ? lpc2w33_kernel<16>
                               : hist == 32 ? lpc2w33_kernel<32>
                                            : nullptr;
  return launch<int64_t>(kern, rows, ld_rows, cfwd, ld_cf, shift, order, out,
                         b, n, device, stream);
}
