// lpc2: the int32 LPC recurrence of one order class, time-major.
//
// Replaces the Pallas kernel zflac_tpu/ops/lpc2.py
// lpc2_reconstruct_inline (body _lpc2_kernel). It serves the lpc8,
// lpc16 and lpc32 classes of <= 16-bit streams (hist 8, 16, 32).
//
// Input: rows [B, n] (warm-up samples at t < order, residuals after;
// any row stride), cfwd [hist, n] with row r = c_{r+1} (zero for
// r >= order; any row stride), shift [n], order [n]. Output: out [B, n]
// int32, the reconstructed signal.
//
// The same transposed direct form as the TPU kernel: a pipeline P[hist]
// where P[r] holds the partial prediction for time t+1+r from every
// sample produced so far. Per step pred = P[0] >> shift,
// out = res + pred (t >= order), then P = shift_up(P) + out * c. The
// loop-carried chain is one shift, one add and one multiply-add; int32
// wraparound addition is associative, so the reordered sum equals the
// reference's index-order sum bit for bit. Sums and products run in
// uint32 (wrapping, defined in C++); the right shift is on int32 with
// its amount kept in [0, 31] (31 for any amount XLA would treat as
// >= 32, which gives the sign fill there too).
//
// What bounds it on the H100: the serial chain, not bytes. Each lane
// is one thread that walks all B time steps; the bench stream has only
// n = 2048 lanes (64 warps for 132 SMs) and B = 4096 dependent steps.
// Design against memory latency on that chain: the P and c vectors
// live in registers (HIST is a template argument, so every index is
// static), and residuals are loaded in unrolled groups of 8, the next
// group issued before the current one is consumed, so the loads sit
// off the dependency chain (the TPU kernel's unroll=8). Loads of
// rows[t, s] and stores of out[t, s] coalesce across s. Splitting
// lanes finer or keeping more work in flight is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;

template <int HIST>
__global__ void lpc2_kernel(const int32_t* __restrict__ rows, int ld_rows,
                            const int32_t* __restrict__ cfwd, int ld_cf,
                            const int32_t* __restrict__ shift,
                            const int32_t* __restrict__ order,
                            int32_t* __restrict__ out, int b, int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  uint32_t c[HIST];
  uint32_t P[HIST];
#pragma unroll
  for (int r = 0; r < HIST; ++r) {
    c[r] = (uint32_t)__ldg(cfwd + (size_t)r * ld_cf + s);
    P[r] = 0u;
  }
  const uint32_t sh_u = (uint32_t)__ldg(shift + s);
  const int sh = sh_u < 32u ? (int)sh_u : 31;
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
      const int32_t pred = ((int32_t)P[0]) >> sh;
      const uint32_t v =
          t >= ord ? (uint32_t)cur[u] + (uint32_t)pred : (uint32_t)cur[u];
      o[(size_t)t * n] = (int32_t)v;
#pragma unroll
      for (int r = 0; r < HIST - 1; ++r) P[r] = P[r + 1] + v * c[r];
      P[HIST - 1] = v * c[HIST - 1];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
}

}  // namespace

extern "C" int zft_lpc2(const void* rows, int ld_rows, const void* cfwd,
                        int ld_cf, const void* shift, const void* order,
                        void* out, int b, int n, int hist, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || b % kUnroll != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  // One warp per block spreads the few lanes over as many SMs as
  // possible.
  const int threads = 32;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* rp = (const int32_t*)rows;
  const int32_t* cp = (const int32_t*)cfwd;
  const int32_t* sp = (const int32_t*)shift;
  const int32_t* op = (const int32_t*)order;
  int32_t* outp = (int32_t*)out;
  switch (hist) {
    case 8:
      lpc2_kernel<8><<<blocks, threads, 0, st>>>(rp, ld_rows, cp, ld_cf, sp,
                                                 op, outp, b, n);
      break;
    case 16:
      lpc2_kernel<16><<<blocks, threads, 0, st>>>(rp, ld_rows, cp, ld_cf, sp,
                                                  op, outp, b, n);
      break;
    case 32:
      lpc2_kernel<32><<<blocks, threads, 0, st>>>(rp, ld_rows, cp, ld_cf, sp,
                                                  op, outp, b, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
