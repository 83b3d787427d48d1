// packtail: stereo stream-order gather + wasted-bits shift +
// decorrelation + channel pack, one pass.
//
// Replaces the Pallas kernel zflac_tpu/ops/packtail.py packtail_inline
// (body _packtail_kernel). Serves the stereo 8- and 16-bit containers.
//
// Input: stack [rows, Bp] int32 (the reconstructed class-sorted
// subframes plus the dead zero row), inv [2 * Fp] (stream slot ->
// stack row; padded slots point at the dead row), wasted [2 * Fp],
// chcode [Fp]. Output, per frame f and sample t, both channels in one
// word, channel 0 in the low half (little-endian, as the JAX bitcast):
//   container 16: int32 [Fp, Bp] = (c0 & 0xFFFF) | (c1 << 16)
//   container 8:  int16 [Fp, Bp] = (c0 & 0xFF) | ((c1 & 0xFF) << 8)
//
// What bounds it on the H100: bytes. Each sample pair reads 8 B and
// writes 4 (or 2); on the bench stream ~34 MB read and ~17 MB written,
// ~15 us at 3.35 TB/s. To run at that rate the card needs some 2 MB of
// reads in flight (3.35 TB/s times ~0.7 us of latency), ~18 KB an SM.
//
// Design: the work is cut into items of one frame and kPer * blockDim
// samples, and a grid sized from the SM count walks the items (a
// grid-stride loop), so every SM holds several blocks whether Fp is 1
// or 1024. A block reads its item's inv, wasted and chcode (this
// replaces the TPU kernel's scalar prefetch); the mode is uniform over
// the item, so its branch never diverges. Each thread takes kPer = 8
// samples, two runs of 4 one block width apart, so that the threads of
// a warp take adjacent runs and each load and store instruction covers
// whole 32-byte sectors (8 adjacent samples a thread wrote each sector
// in two halves and ran 20 % slower on the decode_to_device chunks,
// whose padded frames make the output most of their bytes). A run is
// a 16-byte load from each row, all four issued before any is used
// (64 B in flight a thread, ~128 KB an SM at full occupancy), and a
// 16-byte store of 4 uint32 (container 16) or an 8-byte store of 4
// uint16 (container 8). Every byte is touched once, so loads and
// stores carry the evict-first hint (ld.global.cs / st.global.cs). The
// vector path needs 16-byte-aligned row bases: the stack and output
// base 16-byte aligned and Bp % 4 == 0, checked at launch. Otherwise
// (a Bp tail, a stack view at an odd offset) the same kernel runs the
// same items with 4-byte loads, one sample at a time. TMA would buy
// nothing here: the copy is a two-row gather streamed once, with no
// reuse for shared memory to serve.
//
// Rules kept from the first kernel: shifts and sums are uint32
// (wrapping, defined), the mid-side halving an int32 arithmetic shift
// by 1; a wasted-bits amount outside [0, 31] gives 0 as XLA's shift
// does; row indices are clamped into the stack so a corrupt buffer
// cannot read outside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Channel assignment codes (zflac_tpu/format.py CH_*).
constexpr int kLeftSide = 8;
constexpr int kSideRight = 9;
constexpr int kMidSide = 10;

constexpr int kPer = 8;  // samples a thread takes of an item

__device__ __forceinline__ uint32_t shl(uint32_t x, int32_t w) {
  return (uint32_t)w < 32u ? x << w : 0u;
}

// One sample pair shifted, decorrelated and packed into the container.
template <int CB>
__device__ __forceinline__ uint32_t pack_pair(uint32_t a, uint32_t b,
                                              int32_t w0, int32_t w1,
                                              int mode) {
  const uint32_t c0 = shl(a, w0);
  const uint32_t c1 = shl(b, w1);
  uint32_t n0 = c0, n1 = c1;
  if (mode == kSideRight) {
    n0 = c0 + c1;
  } else if (mode == kMidSide) {
    const uint32_t mid = (c0 << 1) | (c1 & 1u);
    n0 = (uint32_t)(((int32_t)(mid + c1)) >> 1);
    n1 = (uint32_t)(((int32_t)(mid - c1)) >> 1);
  } else if (mode == kLeftSide) {
    n1 = c0 - c1;
  }
  return CB == 16 ? (n0 & 0xFFFFu) | (n1 << 16)
                  : (n0 & 0xFFu) | ((n1 & 0xFFu) << 8);
}

template <int CB>
__device__ __forceinline__ uint4 pack4(int4 a, int4 b, int32_t w0, int32_t w1,
                                       int mode) {
  return make_uint4(pack_pair<CB>(a.x, b.x, w0, w1, mode),
                    pack_pair<CB>(a.y, b.y, w0, w1, mode),
                    pack_pair<CB>(a.z, b.z, w0, w1, mode),
                    pack_pair<CB>(a.w, b.w, w0, w1, mode));
}

// Four packed samples of the container: four uint32, or four uint16
// in a uint2.
template <int CB>
__device__ __forceinline__ void store4(void* out, size_t at, uint4 p) {
  if (CB == 16) {
    __stcs((uint4*)((uint32_t*)out + at), p);
  } else {
    __stcs((uint2*)((uint16_t*)out + at),
           make_uint2(p.x | (p.y << 16), p.z | (p.w << 16)));
  }
}

template <int CB>
__global__ void __launch_bounds__(256)
    packtail_kernel(const int32_t* __restrict__ stack, int rows, int bp,
                    const int32_t* __restrict__ inv,
                    const int32_t* __restrict__ wasted,
                    const int32_t* __restrict__ chcode,
                    void* __restrict__ out, int fp, int tiles, int vec) {
  const long long items = (long long)fp * tiles;
  // A thread's two runs of 4 samples in its item, the second one block
  // width after the first: the 32 threads of a warp take 32 adjacent
  // runs, so each load and store instruction covers whole 32-byte
  // sectors.
  const int u0 = threadIdx.x * 4;
  const int u1 = (blockDim.x + threadIdx.x) * 4;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int f = (int)(it / tiles);
    const int t0 = (int)(it - (long long)f * tiles) * blockDim.x * kPer;
    if (t0 + u0 >= bp) continue;
    const int r0 = min(max(__ldg(inv + 2 * f), 0), rows - 1);
    const int r1 = min(max(__ldg(inv + 2 * f + 1), 0), rows - 1);
    const int32_t w0 = __ldg(wasted + 2 * f);
    const int32_t w1 = __ldg(wasted + 2 * f + 1);
    const int mode = __ldg(chcode + f);
    const int32_t* a = stack + (size_t)r0 * bp + t0;
    const int32_t* b = stack + (size_t)r1 * bp + t0;
    const size_t at = (size_t)f * bp + t0;
    if (vec) {
      // Bp % 4 == 0: a run of 4 lies in the row whole or not at all.
      const bool two = t0 + u1 < bp;
      const int4 a0 = __ldcs((const int4*)(a + u0));
      const int4 b0 = __ldcs((const int4*)(b + u0));
      int4 a1 = a0, b1 = b0;
      if (two) {
        a1 = __ldcs((const int4*)(a + u1));
        b1 = __ldcs((const int4*)(b + u1));
      }
      store4<CB>(out, at + u0, pack4<CB>(a0, b0, w0, w1, mode));
      if (two) store4<CB>(out, at + u1, pack4<CB>(a1, b1, w0, w1, mode));
    } else {
      for (int k = 0; k < kPer; ++k) {
        const int t = (k < 4 ? u0 : u1 - 4) + k;
        if (t0 + t >= bp) break;
        const uint32_t v = pack_pair<CB>(__ldcs(a + t), __ldcs(b + t), w0,
                                         w1, mode);
        if (CB == 16) {
          __stcs((uint32_t*)out + at + t, v);
        } else {
          __stcs((unsigned short*)out + at + t, (unsigned short)v);
        }
      }
    }
  }
}

template <int CB>
int launch(const int32_t* stack, int rows, int bp, const int32_t* inv,
           const int32_t* wasted, const int32_t* chcode, void* out, int fp,
           int device, cudaStream_t st) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // The widest block that still gives every SM four items; at least
  // one warp.
  int threads = 256;
  while (threads > 32 &&
         (long long)fp * ((bp + threads * kPer - 1) / (threads * kPer)) <
             4LL * sms)
    threads /= 2;
  const int tiles = (bp + threads * kPer - 1) / (threads * kPer);
  const long long items = (long long)fp * tiles;
  const long long most = (long long)sms * (2048 / threads);
  const int blocks = (int)(items < most ? items : most);
  const int vec = ((uintptr_t)stack % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                  bp % 4 == 0;
  packtail_kernel<CB><<<blocks, threads, 0, st>>>(stack, rows, bp, inv,
                                                  wasted, chcode, out, fp,
                                                  tiles, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zft_packtail(const void* stack, int rows, int bp,
                            const void* inv, const void* wasted,
                            const void* chcode, void* out, int fp,
                            int container_bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (fp <= 0 || bp <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* sp = (const int32_t*)stack;
  const int32_t* ip = (const int32_t*)inv;
  const int32_t* wp = (const int32_t*)wasted;
  const int32_t* cp = (const int32_t*)chcode;
  if (container_bits == 16)
    return launch<16>(sp, rows, bp, ip, wp, cp, out, fp, device, st);
  if (container_bits == 8)
    return launch<8>(sp, rows, bp, ip, wp, cp, out, fp, device, st);
  return (int)cudaErrorInvalidValue;
}
