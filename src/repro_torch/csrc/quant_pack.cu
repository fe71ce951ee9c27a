// Fused per-row min/max + quantize (nearest or counter-hash SR) + bit-pack.
//
// Replaces the TPU kernel src/repro/kernels/quant_pack.py:_quant_kernel.
//
// Bound on the H100: bytes. It reads R*d*4 bytes of fp32 and writes
// R*ceil(d*b/8) packed bytes plus 8 bytes of scale/zero per row; the
// arithmetic is a handful of fp32 operations per element.
//
// Design: one warp per row. Lanes stride over the row for the min/max
// (coalesced 128-byte loads), reduce with shuffles (min and max are exact,
// so the reduction order does not matter), then each lane builds whole
// packed bytes: byte j gathers codes j, dp+j, 2*dp+j, ... (the
// chunk-interleaved layout of DESIGN.md section 2), so neighbouring lanes
// read neighbouring columns and write neighbouring bytes. Pad codes past
// the true width d are never formed and pack as 0. The row's x is read
// twice; the second read hits L1/L2.
//
// Numerics follow the reference's fp32 order exactly, with no contraction:
// inv = bins / max(R, 1e-12); normed = (x - lo) * inv; scale = R * fl(1/bins)
// (XLA compiles the reference's R / bins, a division by a constant, into a
// multiply by the float32-rounded reciprocal; the port keeps that rounding).
// Nearest rounding is rintf (half to even, like jnp.round); SR compares a
// murmur3 uniform of the global element index row*d+col (uint32) with the
// fractional part.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hashrng.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void quant_pack_kernel(const float* __restrict__ x, int rows, int d,
                                  int bits, int stochastic, uint32_t seed,
                                  uint8_t* __restrict__ packed,
                                  float* __restrict__ scale,
                                  float* __restrict__ zero) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + static_cast<size_t>(row) * d;

  float lo = INFINITY, hi = -INFINITY;
  for (int c = lane; c < d; c += 32) {
    const float v = xr[c];
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }

  const float bins = static_cast<float>((1 << bits) - 1);
  const float rng = __fsub_rn(hi, lo);
  const float inv = __fdiv_rn(bins, fmaxf(rng, 1e-12f));
  const int cpb = 8 / bits;
  const int dp = (d + cpb - 1) / cpb;
  for (int j = lane; j < dp; j += 32) {
    unsigned byte = 0;
    for (int k = 0; k < cpb; ++k) {
      const int col = k * dp + j;
      if (col >= d) break;
      const float normed = __fmul_rn(__fsub_rn(xr[col], lo), inv);
      float code;
      if (stochastic) {
        const float fl = floorf(normed);
        const uint32_t gidx = static_cast<uint32_t>(row) *
                                  static_cast<uint32_t>(d) +
                              static_cast<uint32_t>(col);
        code = fl + (hash_uniform(gidx, seed) < __fsub_rn(normed, fl) ? 1.0f
                                                                      : 0.0f);
      } else {
        code = rintf(normed);
      }
      code = fminf(fmaxf(code, 0.0f), bins);
      byte |= static_cast<unsigned>(code) << (k * bits);
    }
    packed[static_cast<size_t>(row) * dp + j] = static_cast<uint8_t>(byte);
  }
  if (lane == 0) {
    scale[row] = __fmul_rn(rng, __fdiv_rn(1.0f, bins));
    zero[row] = lo;
  }
}

}  // namespace

// x (rows, d) fp32 contiguous -> packed (rows, ceil(d*bits/8)) uint8,
// scale and zero (rows,) fp32. Returns cudaGetLastError() after the launch.
extern "C" int quant_pack_launch(const void* x, int rows, int d, int bits,
                                 int stochastic, unsigned int seed,
                                 void* packed, void* scale, void* zero,
                                 void* stream) {
  if (rows > 0 && d > 0) {
    const int grid = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    quant_pack_kernel<<<grid, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), rows, d, bits, stochastic, seed,
        static_cast<uint8_t*>(packed), static_cast<float*>(scale),
        static_cast<float*>(zero));
  }
  return static_cast<int>(cudaGetLastError());
}
