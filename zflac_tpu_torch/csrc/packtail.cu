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
// ~15 us at 3.35 TB/s.
//
// Design: one block per frame. The block reads its own inv[2f],
// inv[2f+1], wasted and chcode[f] (this replaces the TPU kernel's
// scalar prefetch), and its threads stride over the frame's Bp
// samples, so both row reads and the packed write coalesce. The mode
// is uniform over the block, so the branch never diverges. Shifts and
// sums are uint32 (wrapping, defined), the mid-side halving an int32
// arithmetic shift by 1; a wasted-bits amount outside [0, 31] gives 0
// as XLA's shift does. Row indices are clamped into the stack so a
// corrupt buffer cannot read outside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Channel assignment codes (zflac_tpu/format.py CH_*).
constexpr int kLeftSide = 8;
constexpr int kSideRight = 9;
constexpr int kMidSide = 10;

__device__ __forceinline__ uint32_t shl(uint32_t x, int32_t w) {
  return (uint32_t)w < 32u ? x << w : 0u;
}

template <int CB>
__global__ void packtail_kernel(const int32_t* __restrict__ stack, int rows,
                                int bp, const int32_t* __restrict__ inv,
                                const int32_t* __restrict__ wasted,
                                const int32_t* __restrict__ chcode,
                                void* __restrict__ out) {
  const int f = blockIdx.x;
  const int r0 = min(max(__ldg(inv + 2 * f), 0), rows - 1);
  const int r1 = min(max(__ldg(inv + 2 * f + 1), 0), rows - 1);
  const int32_t w0 = __ldg(wasted + 2 * f);
  const int32_t w1 = __ldg(wasted + 2 * f + 1);
  const int mode = __ldg(chcode + f);
  const int32_t* a = stack + (size_t)r0 * bp;
  const int32_t* b = stack + (size_t)r1 * bp;
  for (int t = threadIdx.x; t < bp; t += blockDim.x) {
    const uint32_t c0 = shl((uint32_t)__ldg(a + t), w0);
    const uint32_t c1 = shl((uint32_t)__ldg(b + t), w1);
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
    const size_t at = (size_t)f * bp + t;
    if (CB == 16) {
      ((uint32_t*)out)[at] = (n0 & 0xFFFFu) | (n1 << 16);
    } else {
      ((uint16_t*)out)[at] = (uint16_t)((n0 & 0xFFu) | ((n1 & 0xFFu) << 8));
    }
  }
}

}  // namespace

extern "C" int zft_packtail(const void* stack, int rows, int bp,
                            const void* inv, const void* wasted,
                            const void* chcode, void* out, int fp,
                            int container_bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (fp <= 0 || bp <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* sp = (const int32_t*)stack;
  const int32_t* ip = (const int32_t*)inv;
  const int32_t* wp = (const int32_t*)wasted;
  const int32_t* cp = (const int32_t*)chcode;
  if (container_bits == 16) {
    packtail_kernel<16><<<fp, threads, 0, st>>>(sp, rows, bp, ip, wp, cp, out);
  } else if (container_bits == 8) {
    packtail_kernel<8><<<fp, threads, 0, st>>>(sp, rows, bp, ip, wp, cp, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
