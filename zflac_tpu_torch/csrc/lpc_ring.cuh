// A ring of shared-memory stages, filled by asynchronous copies, that
// feeds one LPC recurrence per thread (lpc2.cu, lpc2w.cu, lpc.cu; the
// steps are in lpc_steps.cuh).
//
// The kernels on it replace the Pallas kernels K2 lpc2, K4 lpc2w, K5
// lpc2w33 and K6 lpc (zflac_tpu/ops/lpc2.py, lpc2w.py, lpc.py), and
// lpc64 the XLA scan _lpc_scan at int64 (zflac_tpu/runtime/
// reconstruct.py). What bounds each on the H100 is one lane's serial
// chain of B steps and the instructions its warp issues, alone on its
// SM (the bench classes have 4 to 64 warps for 132 SMs), not bytes:
// reading each input and writing each output once takes 0.010-0.040 ms
// a launch at 3.35 TB/s. SASS instructions a step at hist 8 (python3
// -m zflac_tpu_torch.tools.kernel_sass), and ns a step on the bench
// classes, NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py): lpc2
// and lpc, int32 step, about 15, 23.8 and 22.8 ns; lpc2w, float64
// step, about 15, 32.6 ns; lpc2w33 and lpc64, int64 step, about 40,
// 52.6-54.3 ns. So an integer step costs about 1.3-1.5 ns for each
// instruction it issues: what a step issues sets its time more than
// its chain does.
//
// Each block is one warp and owns kLanes consecutive lanes (subframes)
// of a time-major array rows [B, n] (any row stride, any base: lane
// slices of a class start at arbitrary columns). The warp copies its
// lanes' residuals into the ring, kT time steps a stage, kS stages in
// all, with cp.async copies issued (kS - 1) * kT steps ahead of the
// recurrence: at the 20-60 ns a step takes, several HBM round trips
// (~1 us) of loads are in flight, and the warp no longer waits on
// device memory. Each thread then reads its lane's residuals from
// shared memory a group of ahead<T, HIST>() steps ahead into registers,
// so the shared-memory latency sits off the chain too. Longer groups
// cost fewer loop instructions a step; 32 steps of hist 32 still fit
// the instruction cache. At int64 a group holds two registers a step
// twice over (this group and the next), beside 2 * HIST for P, so its
// groups are 32 steps at hist 8, 16 at hist 16 and 8 at hist 32, the
// most that fit the 255 registers a thread may have (timed on the
// H100: 32 steps beat 16 at hist 8, and 8 beat 16 at hist 32).
//
// Why cp.async and not TMA: a lane slice's base address and row stride
// need not be 16-byte aligned (the class slices of runtime/device.py
// start at any column, and the row stride is the chunk's Ssort), and a
// TMA tensor map needs both aligned. cp.async takes every case: 16
// bytes a copy where the block's base and stride allow it (the bench
// chunks' classes), one value a copy elsewhere. With 16-byte copies a
// thread copies values other threads read, so a __syncwarp after each
// wait and before each refill orders the copies and the reads.
//
// Lanes past n (the last block's tail) copy and compute lane n - 1's
// column and store the same values to the same outputs as lane n - 1's
// own thread, so every thread runs the same loop and no branch guards
// a store.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lpc_ring {

constexpr int kLanes = 32;  // one warp per block, one lane per thread
constexpr int kT = 128;     // time steps per stage
constexpr int kS = 3;       // stages in the ring
constexpr int kTail = 8;    // steps a group in a stage's rest (B % 8 == 0)

// Steps read ahead from shared memory, for elements of type T and a
// step of HIST taps.
template <typename T, int HIST>
__host__ __device__ constexpr int ahead() {
  return sizeof(T) == 4 || HIST <= 8 ? 32 : HIST <= 16 ? 16 : 8;
}

// 48 KB at int32 and 96 KB at int64: two int64 blocks still fit the
// 227 KB of shared memory an SM gives its blocks. The kernels with an
// int64 step declare __launch_bounds__(kLanes, 1): without the one
// block an SM, ptxas held their hist-32 instances to 168 registers and
// spilled, for an occupancy these launches of a few warps never reach.
template <typename T>
constexpr int ring_bytes() {
  return kS * kT * kLanes * (int)sizeof(T);
}

template <int BYTES>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kS - 1 committed groups are pending: the oldest
// stage has landed.
__device__ __forceinline__ void wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kS - 1) : "memory");
}

// Runs the recurrence `step` over the B time steps of this thread's
// lane: step.template run<WARM>(res, t) takes the residual (or warm-up
// sample) of time t and returns the output, which goes to out [B, n]
// (contiguous). WARM is true for a stage in which some lane of the
// warp is still inside its warm-up (t < order), so the select that
// passes warm-ups through stays off the chain elsewhere. rows [B, n]
// has row stride ld; `ring` is the block's dynamic shared memory.
template <typename T, typename Step>
__device__ __forceinline__ void drive(const T* rows, int ld, T* out, int b,
                                      int n, T* ring, int ord, Step& step) {
  constexpr int kU = ahead<T, Step::kHist>();
  const int lane = threadIdx.x;
  const int s0 = blockIdx.x * kLanes;
  const T* col = rows + min(s0 + lane, n - 1);
  T* o = out + min(s0 + lane, n - 1);  // the output of the next step
  const uint32_t ring_base = (uint32_t)__cvta_generic_to_shared(ring);
  constexpr int kVec = 16 / (int)sizeof(T);  // values in a 16-byte copy
  constexpr int kRowBytes = kLanes * (int)sizeof(T);
  // A block whose 32 lanes all exist, at a 16-byte-aligned base with a
  // row stride of whole 16-byte units, copies 16 bytes at a time: each
  // thread a kVec-lane piece of every (32 / kVec)-th row. Any other
  // block copies its lanes one value at a time.
  const bool vec = s0 + kLanes <= n && ld % kVec == 0 &&
                   ((uintptr_t)(rows + s0)) % 16 == 0;
  const int vrow = lane / (kLanes / kVec);
  const int vcol = lane % (kLanes / kVec) * kVec;
  const int stages = (b + kT - 1) / kT;
  auto issue = [&](int k) {
    if (k < stages) {
      const int t0 = k * kT;
      const int m = min(kT, b - t0);
      const uint32_t dst = ring_base + (uint32_t)((k % kS) * kT * kRowBytes);
      if (vec) {  // a warp's copy covers kVec rows
        const T* src = rows + s0 + vcol + (size_t)(t0 + vrow) * ld;
        const uint32_t d =
            dst + (uint32_t)(vrow * kRowBytes + vcol * (int)sizeof(T));
#pragma unroll 4
        for (int r = 0; r < m; r += kVec)
          copy_async<16>(d + (uint32_t)(r * kRowBytes),
                         src + (size_t)r * ld);
      } else {
        const T* src = col + (size_t)t0 * ld;
        const uint32_t d = dst + (uint32_t)(lane * sizeof(T));
#pragma unroll 8
        for (int u = 0; u < m; ++u)
          copy_async<sizeof(T)>(d + (uint32_t)(u * kRowBytes),
                                src + (size_t)u * ld);
      }
    }
    commit();  // an empty group past the end keeps the count uniform
  };
  // kN steps with residuals r, from time t: the select for warm-ups
  // only where `warm`. Each output is stored as it is made: one posted
  // store a step, which timed faster than staging a group's outputs in
  // a shared-memory tile and writing it out in 16-byte stores (PERF.md).
  auto steps = [&](auto n_, const T* r, int t, bool warm) {
    constexpr int kN = decltype(n_)::value;
    if (warm) {
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        *o = step.template run<true>(r[u], t + u);
        o += n;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        *o = step.template run<false>(r[u], t + u);
        o += n;
      }
    }
  };
#pragma unroll
  for (int k = 0; k < kS - 1; ++k) issue(k);
  for (int k = 0; k < stages; ++k) {
    // Every thread is done with the slot the next issue refills (read
    // in stage k - 1), and after the wait every thread's copies of
    // stage k are visible to the others.
    __syncwarp();
    issue(k + kS - 1);
    wait_oldest();
    __syncwarp();
    const T* st = ring + (k % kS) * kT * kLanes + lane;
    const int t0 = k * kT;
    const int m = min(kT, b - t0);
    const bool warm = __any_sync(0xFFFFFFFFu, t0 < ord);
    // Groups of kU steps, the next group's residuals read from shared
    // memory while this one runs; then groups of kTail (m % 8 == 0).
    int g = 0;
    if (m >= kU) {
      T cur[kU], nxt[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) cur[u] = st[u * kLanes];
      for (; g + kU <= m; g += kU) {
        if (g + 2 * kU <= m) {
#pragma unroll
          for (int u = 0; u < kU; ++u) nxt[u] = st[(g + kU + u) * kLanes];
        }
        steps(std::integral_constant<int, kU>{}, cur, t0 + g, warm);
#pragma unroll
        for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
      }
    }
    for (; g < m; g += kTail) {
      T r[kTail];
#pragma unroll
      for (int u = 0; u < kTail; ++u) r[u] = st[(g + u) * kLanes];
      steps(std::integral_constant<int, kTail>{}, r, t0 + g, warm);
    }
  }
}

// Runs a step of lpc_steps.cuh over this thread's lane, from the lane's
// coefficients c[0..Step::kHist), its shift amount as stored and its
// order.
template <typename Step, typename T>
__device__ __forceinline__ void run(const int32_t* c, uint32_t sh_u, int ord,
                                    const T* rows, int ld, T* out, int b,
                                    int n, T* ring) {
  Step step;
  step.init(c, sh_u, ord);
  drive(rows, ld, out, b, n, ring, ord, step);
}

// Grid and shared memory of a launch over n lanes; checks the shape
// (b > 0 and a multiple of kTail, n > 0). Returns a CUDA status.
template <typename T, typename Kernel>
int launch(Kernel kern, int b, int n, cudaStream_t st,
           const void* rows, int ld_rows, const void* cfwd, int ld_cf,
           const void* shift, const void* order, void* out) {
  if (b <= 0 || b % kTail != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (ring_bytes<T>() > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes<T>());
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kLanes - 1) / kLanes;
  kern<<<blocks, kLanes, ring_bytes<T>(), st>>>(
      (const T*)rows, ld_rows, (const int32_t*)cfwd, ld_cf,
      (const int32_t*)shift, (const int32_t*)order, (T*)out, b, n);
  return (int)cudaGetLastError();
}

}  // namespace lpc_ring
