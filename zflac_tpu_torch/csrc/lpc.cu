// lpc and lpc64: the rows engine's LPC recurrence over a 32-sample
// history, time-major, at int32 and at int64.
//
// lpc replaces the Pallas kernel zflac_tpu/ops/lpc.py
// lpc_reconstruct_inline (K6, body _lpc_kernel), which the rows engine
// runs on the int32 `lpc` class (zflac_tpu/runtime/reconstruct.py
// _lpc_pallas). lpc64 is the same source instantiated at int64: it
// serves what the JAX rows engine computes with the XLA scan _lpc_scan
// in int64 (every LPC class of a 17-32-bit stream, and the `lpc_wide`
// class of a 16-bit one). That scan is not a Pallas kernel; the
// instantiation exists because a plain loop of B steps would cost
// thousands of launches per call.
//
// Input: rows [B, n] (warm-up samples at t < order, residuals after;
// any row stride), int32 (lpc) or int64 (lpc64); coeffs [32, n] int32
// where row j multiplies s[t-32+j] (the tail columns of the plan's
// coeffs_rev, transposed; any row stride); shift [n]; order [n].
// Output: out [B, n] of the rows' type,
//   out[t] = rows[t] + ((sum_j X[t+j] * coeffs[j]) >> shift)  (t >= order)
//   out[t] = rows[t]                                          (t < order)
// where X is the output preceded by 32 zeros. Sums wrap in the type.
//
// The direct form above is computed in the transposed form of
// csrc/lpc2.cu: a pipeline P[32] where P[r] holds the partial
// prediction for time t+1+r from every sample produced so far, with
// c[r] = coeffs[31 - r] multiplying the sample r+1 steps back. Per step
// pred = P[0] >> shift, out = res + pred (t >= order), then
// P = shift_up(P) + c * out. Sums with wraparound are associative, so
// the reordered sum equals the direct form's index-order sum bit for
// bit. Sums and products run unsigned (wrapping, defined in C++); the
// right shift is arithmetic on the signed type, with the amount read as
// unsigned and kept below the width: any amount XLA would take as
// >= 32 (int32) or >= 64 (int64) gives the sign fill there, and the
// clamp to 31 or 63 gives it here. This is the rule of the scan's
// int64 right_shift, not lpc2w33's (whose amounts >= 32 follow the JAX
// pair math). The scan writes the 5-bit shift field, 0..31.
//
// What bounds it on the H100: the serial chain, not bytes. Each
// subframe is one thread that walks all B time steps; bench16's class
// has n = 2048 subframes (64 warps for 132 SMs) and B = 4096 dependent
// steps. The design is lpc2's: P and c live in registers (every index
// is static), residuals are loaded in unrolled groups of 8 with the
// next group issued before the current one is consumed, so the loads
// sit off the chain, and loads of rows[t, s] and stores of out[t, s]
// coalesce across s. The TPU kernel's lane constraints (n a multiple of
// the lane block, the VMEM budget behind B <= 4096) have no counterpart:
// any n, any B that is a multiple of 8.
//
// Predicted before the first card run: the chain per step is as long as
// lpc2's (a shift, an add, the multiply-add into P[0]); the 32
// multiply-adds a step are off the chain and, with one warp on an SM,
// about 32 issue cycles. So lpc at about lpc2's 85-88 ns per step
// (bench16's class, 2048 lanes, B 4096: ~0.36 ms), and lpc64, whose
// multiply-adds are three or four instructions each and whose chain
// adds a 64-bit add and shift, at ~110-130 ns per step (bench24's class,
// 1024 lanes: ~0.5 ms).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, over two runs: lpc
// 93.4-99.6 ns per step, lpc64 216.7-219.1 ns, twice the prediction;
// ptxas: 96 and 188 registers, no spills. With one warp per SM, lpc64's
// ~4 instructions per 64-bit multiply-add may bound it on issue rather
// than on the chain; not yet read from the SASS.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHist = 32;
constexpr int kUnroll = 8;

template <typename T>
struct Unsigned;
template <>
struct Unsigned<int32_t> {
  using type = uint32_t;
};
template <>
struct Unsigned<int64_t> {
  using type = uint64_t;
};

template <typename T>
__global__ void lpc_kernel(const T* __restrict__ rows, int ld_rows,
                           const int32_t* __restrict__ coeffs, int ld_cf,
                           const int32_t* __restrict__ shift,
                           const int32_t* __restrict__ order,
                           T* __restrict__ out, int b, int n) {
  using U = typename Unsigned<T>::type;
  constexpr uint32_t kBits = 8 * sizeof(T);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  int32_t c[kHist];
  U P[kHist];
#pragma unroll
  for (int r = 0; r < kHist; ++r) {
    c[r] = __ldg(coeffs + (size_t)(kHist - 1 - r) * ld_cf + s);
    P[r] = 0;
  }
  const uint32_t sh_u = (uint32_t)__ldg(shift + s);
  const int sh = sh_u < kBits ? (int)sh_u : (int)kBits - 1;
  const int ord = __ldg(order + s);
  const T* in = rows + s;
  T* o = out + s;

  T cur[kUnroll], nxt[kUnroll];
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
      const T pred = ((T)P[0]) >> sh;
      const U v = t >= ord ? (U)cur[u] + (U)pred : (U)cur[u];
      o[(size_t)t * n] = (T)v;
#pragma unroll
      for (int r = 0; r < kHist - 1; ++r) P[r] = P[r + 1] + (U)(T)c[r] * v;
      P[kHist - 1] = (U)(T)c[kHist - 1] * v;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
}

// One warp per block, as lpc2: the few subframes spread over as many SMs
// as possible.
template <typename T>
int launch(const void* rows, int ld_rows, const void* coeffs, int ld_cf,
           const void* shift, const void* order, void* out, int b, int n,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || b % kUnroll != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const int blocks = (n + threads - 1) / threads;
  lpc_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)rows, ld_rows, (const int32_t*)coeffs, ld_cf,
      (const int32_t*)shift, (const int32_t*)order, (T*)out, b, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zft_lpc(const void* rows, int ld_rows, const void* coeffs,
                       int ld_cf, const void* shift, const void* order,
                       void* out, int b, int n, int device, void* stream) {
  return launch<int32_t>(rows, ld_rows, coeffs, ld_cf, shift, order, out, b,
                         n, device, stream);
}

extern "C" int zft_lpc64(const void* rows, int ld_rows, const void* coeffs,
                         int ld_cf, const void* shift, const void* order,
                         void* out, int b, int n, int device, void* stream) {
  return launch<int64_t>(rows, ld_rows, coeffs, ld_cf, shift, order, out, b,
                         n, device, stream);
}
