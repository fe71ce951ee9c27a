// Unpack + dequantize a packed table: (rows, dp) uint8 -> (rows, d) fp32.
//
// Replaces the TPU kernel src/repro/kernels/quant_pack.py:_dequant_kernel
// (wrapper dequant_unpack).
//
// Bound on the H100: bytes. The packed table (rows*dp) and 8 bytes of
// scale/zero per row are read once and rows*d*4 bytes written once, against
// two flops an element; the fp32 output is most of the traffic.
//
// Design. An elementwise pass: one thread per output element (r, c), in a
// grid-stride loop so any size launches the same grid. Byte c % dp of row r
// holds code c in bits [(c / dp) * b, (c / dp + 1) * b) (the
// chunk-interleaved layout of core/quant.py); codes past d in a padded pack
// are never read, so the pad is sliced off. x = code * scale + zero rounds
// the product and the sum apart (__fmul_rn, __fadd_rn: no FMA contraction),
// as the plain core/quant.dequantize does, so the two agree bit for bit.
// Neighbouring threads write neighbouring floats, so the stores coalesce;
// the packed bytes and the per-row scale/zero are re-read from L1/L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 resident CTAs on each of 132 SMs

__global__ void dequant_unpack_kernel(const uint8_t* __restrict__ packed,
                                      int dp, int bits,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ zero,
                                      int rows, int dim,
                                      float* __restrict__ out) {
  const size_t n = static_cast<size_t>(rows) * dim;
  const unsigned mask = (1u << bits) - 1u;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = e / dim;
    const int c = static_cast<int>(e - r * dim);
    const unsigned byte = packed[r * dp + c % dp];
    const unsigned code = (byte >> ((c / dp) * bits)) & mask;
    out[e] = __fadd_rn(__fmul_rn(static_cast<float>(code), scale[r]),
                       zero[r]);
  }
}

}  // namespace

// packed (rows, dp) uint8 with bits in {1,2,4,8} and dp*(8/bits) >= dim;
// scale/zero (rows,) fp32 -> out (rows, dim) fp32. Returns
// cudaGetLastError() after the launch.
extern "C" int dequant_unpack_launch(const void* packed, int rows, int dp,
                                     int bits, int dim, const void* scale,
                                     const void* zero, void* out,
                                     void* stream) {
  const size_t n = static_cast<size_t>(rows) * dim;
  if (n > 0) {
    const size_t want = (n + kThreads - 1) / kThreads;
    const int blocks = want < kMaxBlocks ? static_cast<int>(want) : kMaxBlocks;
    dequant_unpack_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), dp, bits,
        static_cast<const float*>(scale), static_cast<const float*>(zero),
        rows, dim, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
