// lpc and lpc64: the rows engine's LPC recurrence over a 32-sample
// history, time-major, at int32 and at int64.
//
// lpc replaces the Pallas kernel zflac_tpu/ops/lpc.py
// lpc_reconstruct_inline (K6, body _lpc_kernel), which the rows engine
// runs on the int32 `lpc` class (zflac_tpu/runtime/reconstruct.py
// _lpc_pallas). lpc64 is the same kernel at int64: it serves what the
// JAX rows engine computes with the XLA scan _lpc_scan in int64 (every
// LPC class of a 17-32-bit stream, and the `lpc_wide` class of a 16-bit
// one). That scan is not a Pallas kernel; the kernel exists because a
// plain loop of B steps would cost thousands of launches per call.
//
// Input: rows [B, n] (warm-up samples at t < order, residuals after;
// any row stride), int32 (lpc) or int64 (lpc64); coeffs [32, n] int32
// where row j multiplies s[t-32+j] (the tail columns of the plan's
// coeffs_rev, transposed; any row stride); shift [n]; order [n].
// Output: out [B, n] of the rows' type,
//   out[t] = rows[t] + ((sum_j X[t+j] * coeffs[j]) >> shift)  (t >= order)
//   out[t] = rows[t]                                          (t < order)
// where X is the output preceded by 32 zeros. Sums wrap in the type.
// The right shift is arithmetic, with the amount read as unsigned and
// kept below the width: any amount XLA would take as >= 32 (int32) or
// >= 64 (int64) gives the sign fill there, and the clamp to 31 or 63
// gives it here. This is the rule of the scan's right_shift, not
// lpc2w33's (whose amounts >= 32 follow the JAX pair math). The scan
// writes the 5-bit shift field, 0..31.
//
// The direct form is computed in the transposed form of lpc_steps.cuh,
// with c[r] = coeffs[31 - r] multiplying the sample r+1 steps back;
// wrapping sums in another order are the same sums bit for bit.
//
// What bounds it on the H100: the serial chain of each subframe and
// the instructions one warp issues for it, not bytes. bench16's class
// has n = 2048 subframes (64 warps for 132 SMs), bench24's 1024 and
// bench32ms's 512, over B = 4096 dependent steps, so each SM runs one
// warp and nothing hides its stalls. Reading each input byte and
// writing each output byte once takes 0.020 ms at 3.35 TB/s on each.
//
// The design: lpc2's ring (lpc_ring.cuh), residuals copied into 3
// shared-memory stages of 128 steps by cp.async and read back ahead of
// the chain into registers; the warm-up select only in a stage that
// holds some lane's warm-up; outputs stored as they are made. The
// step is lpc2's at int32 (lpc_steps::Lpc2Step: the same wrap, the same
// clamp to 31, the same warm-up rule) and at int64 the step lpc2w33
// runs (lpc_steps::Int64Step) with XLA's clamp to 63, whose shift is
// as short as the plain one, so no warp needs another form.
// Each warp runs the smallest history of 8, 16 or 32 that covers the
// highest coefficient row any of its lanes has nonzero: one
// warp-uniform branch into three instances. Dropped rows are zero, so
// this is exact for any coefficients; the streams' order-8 classes run
// 8 taps a step instead of 32 (the earlier kernel ran 32 for every
// class, with loads issued only 8 steps ahead of the chain).
//
// In the SASS (sm_90a; python3 -m zflac_tpu_torch.tools.kernel_sass) a
// step issues about 15 / 23 / 39 instructions at hist 8 / 16 / 32 for
// lpc, as lpc2, and about 40 / 72 / 137 for lpc64 (lpc_steps.cuh says
// why a 64-bit tap is four). ptxas: 168 registers for lpc, 254 for
// lpc64 (its hist-32 instance sets the count), no spills. Measured on
// an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py, CUDA events):
// lpc 22.8 ns a step on bench16's rows class (hist 8), 48.7 at hist
// 32; lpc64 52.6 ns on bench24's class, 54.3 on bench32ms's and on
// bench16's safe_lpc class (all hist 8), 179.5 at hist 32. The earlier
// kernel took 88.2-92.4 ns (lpc) and 216.0-218.1 ns (lpc64) on the
// same card and classes.

#include "lpc_ring.cuh"
#include "lpc_steps.cuh"

namespace {

constexpr int kRows = 32;  // coefficient rows: a 32-sample history

template <int HIST>
using Int32Step = lpc_steps::Lpc2Step<HIST>;
template <int HIST>
using Int64Step = lpc_steps::Int64Step<HIST, lpc_steps::Shift::kClamp63>;

// The ring at history `hist` (8, 16 or 32, uniform across the warp)
// with the step Step<hist>.
template <template <int> class Step, typename T>
__device__ __forceinline__ void run_hist(int hist, const int32_t* c,
                                         uint32_t sh_u, int ord,
                                         const T* rows, int ld, T* out,
                                         int b, int n, T* ring) {
  if (hist == 8)
    lpc_ring::run<Step<8>>(c, sh_u, ord, rows, ld, out, b, n, ring);
  else if (hist == 16)
    lpc_ring::run<Step<16>>(c, sh_u, ord, rows, ld, out, b, n, ring);
  else
    lpc_ring::run<Step<32>>(c, sh_u, ord, rows, ld, out, b, n, ring);
}

template <typename T>
__global__ void __launch_bounds__(lpc_ring::kLanes, 1)
    lpc_kernel(const T* __restrict__ rows, int ld_rows,
               const int32_t* __restrict__ coeffs, int ld_cf,
               const int32_t* __restrict__ shift,
               const int32_t* __restrict__ order, T* __restrict__ out,
               int b, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int sc = min((int)(blockIdx.x * lpc_ring::kLanes + threadIdx.x),
                     n - 1);
  // The lane's coefficients, c[r] for the sample r+1 back, and whether
  // any is nonzero past row 8 or past row 16.
  int32_t c[kRows];
  bool past8 = false, past16 = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c[r] = __ldg(coeffs + (size_t)(kRows - 1 - r) * ld_cf + sc);
    if (r >= 16)
      past16 = past16 || c[r] != 0;
    else if (r >= 8)
      past8 = past8 || c[r] != 0;
  }
  const uint32_t sh_u = (uint32_t)__ldg(shift + sc);
  const int ord = __ldg(order + sc);
  const unsigned all = 0xFFFFFFFFu;
  const int hist = __any_sync(all, past16)  ? 32
                   : __any_sync(all, past8) ? 16
                                            : 8;
  if constexpr (sizeof(T) == 4)
    run_hist<Int32Step>(hist, c, sh_u, ord, rows, ld_rows, out, b, n, ring);
  else
    run_hist<Int64Step>(hist, c, sh_u, ord, rows, ld_rows, out, b, n, ring);
}

template <typename T>
int launch(const void* rows, int ld_rows, const void* coeffs, int ld_cf,
           const void* shift, const void* order, void* out, int b, int n,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return lpc_ring::launch<T>(lpc_kernel<T>, b, n, (cudaStream_t)stream, rows,
                             ld_rows, coeffs, ld_cf, shift, order, out);
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
