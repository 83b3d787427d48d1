// lpc2: the int32 LPC recurrence of one order class, time-major.
//
// Replaces the Pallas kernel zflac_tpu/ops/lpc2.py
// lpc2_reconstruct_inline (body _lpc2_kernel). It serves the lpc8,
// lpc16 and lpc32 classes of <= 16-bit streams (hist 8, 16, 32).
//
// Input: rows [B, n] (warm-up samples at t < order, residuals after;
// any row stride, any base address), cfwd [hist, n] with row r =
// c_{r+1} (zero for r >= order; any row stride), shift [n], order [n].
// Output: out [B, n] int32, the reconstructed signal. B is a multiple
// of 8, n anything.
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
// What bounds it on the H100: the serial chain of each lane and the
// instructions one warp issues for it, not bytes. The bench stream's
// lpc8 class has 2048 lanes (64 warps for 132 SMs) and B = 4096
// dependent steps, and each of decode_to_device's parallel-scan chunks
// a few hundred lanes over the same 4096 steps, so each SM runs one
// warp and nothing hides that warp's stalls. Reading each input byte
// and writing each output byte once takes 0.020 ms at 3.35 TB/s.
// The earlier kernel issued its loads only 8 steps ahead and spent 82-86 ns
// a step waiting for them.
//
// The design (lpc_ring.cuh): one warp per block and one lane per
// thread; the block copies its lanes' residuals into a ring of 3
// shared-memory stages of 128 steps with cp.async (16 bytes a copy
// where the block's base and row stride allow it, else 4), 256 steps
// ahead of the chain, and each thread reads its own back 32 steps
// ahead into registers and stores each output as it is made (posted,
// coalesced across the warp's 32 lanes). P and c live in registers
// (HIST is a template argument, so every index is static). The time
// loop is split at the warm-up: only a stage in which some lane of the
// warp is still below its order runs the select that passes warm-ups
// through. And the chain is cut to two instructions:
// P[0]' = P[1] + c0 * (res + pred) is computed as
// (P[1] + c0 * res) + c0 * pred (equal mod 2^32), whose first sum is
// ready before pred is. The step (Lpc2Step, lpc_steps.cuh) is K6 lpc's
// too (csrc/lpc.cu).
//
// In the SASS (sm_90a; python3 -m zflac_tpu_torch.tools.kernel_sass)
// one step of the
// bare chain is SHF.R.S32.HI (pred = P[0] >> sh) -> IMAD
// (P[0]' = c0 * pred + x0), a SEL between them in a warm-up stage.
// Around it a step at hist 8 issues about 19 instructions: 9 IMAD (the
// taps and x0), 2 IADD3, the LDS, the STG, an IMAD.WIDE that moves the
// output pointer, and its share of the copies. A lone warp issues
// these at well under one a cycle, so at hist 8 the instruction count,
// not the two-instruction chain, sets the time of a step; each further
// tap adds an IMAD (PERF.md §6 has the times).

#include "lpc_ring.cuh"
#include "lpc_steps.cuh"

namespace {

template <int HIST>
__global__ void __launch_bounds__(lpc_ring::kLanes)
    lpc2_kernel(const int32_t* __restrict__ rows, int ld_rows,
                const int32_t* __restrict__ cfwd, int ld_cf,
                const int32_t* __restrict__ shift,
                const int32_t* __restrict__ order,
                int32_t* __restrict__ out, int b, int n) {
  extern __shared__ __align__(16) int32_t ring[];
  const int s = blockIdx.x * lpc_ring::kLanes + threadIdx.x;
  const int sc = min(s, n - 1);
  int32_t c[HIST];
#pragma unroll
  for (int r = 0; r < HIST; ++r) c[r] = __ldg(cfwd + (size_t)r * ld_cf + sc);
  lpc_ring::run<lpc_steps::Lpc2Step<HIST>>(
      c, (uint32_t)__ldg(shift + sc), __ldg(order + sc), rows, ld_rows, out,
      b, n, ring);
}

}  // namespace

extern "C" int zft_lpc2(const void* rows, int ld_rows, const void* cfwd,
                        int ld_cf, const void* shift, const void* order,
                        void* out, int b, int n, int hist, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hist) {
    case 8:
      return lpc_ring::launch<int32_t>(lpc2_kernel<8>, b, n, st, rows,
                                       ld_rows, cfwd, ld_cf, shift, order,
                                       out);
    case 16:
      return lpc_ring::launch<int32_t>(lpc2_kernel<16>, b, n, st, rows,
                                       ld_rows, cfwd, ld_cf, shift, order,
                                       out);
    case 32:
      return lpc_ring::launch<int32_t>(lpc2_kernel<32>, b, n, st, rows,
                                       ld_rows, cfwd, ld_cf, shift, order,
                                       out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
