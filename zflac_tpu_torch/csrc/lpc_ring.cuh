// A ring of shared-memory stages, filled by asynchronous copies, that
// feeds one LPC recurrence per thread (lpc2.cu, lpc2w.cu).
//
// Each block is one warp and owns kLanes consecutive lanes (subframes)
// of a time-major array rows [B, n] (any row stride, any base: lane
// slices of a class start at arbitrary columns). The warp copies its
// lanes' residuals into the ring, kT time steps a stage, kS stages in
// all, with cp.async copies issued (kS - 1) * kT steps ahead of the
// recurrence: at the 20-40 ns a step takes, several HBM round trips
// (~1 us) of loads are in flight, and the warp no longer waits on
// device memory. Each thread then reads its lane's residuals from
// shared memory a group of kU steps ahead into registers, so the
// shared-memory latency sits off the chain too. Longer groups cost
// fewer loop instructions a step; 32 steps of hist 32 still fit the
// instruction cache.
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
constexpr int kU = 32;      // steps read ahead from shared memory
constexpr int kTail = 8;    // steps a group in a stage's rest (B % 8 == 0)

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
