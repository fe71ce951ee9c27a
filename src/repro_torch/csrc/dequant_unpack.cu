// Unpack + dequantize rows of a packed table: (rows, dp) uint8 -> (m, d)
// fp32, either every row in order (m = rows) or the rows idx[0..m) of an
// index (the re-rank's candidate gather, fused: out[i] = dequant(packed
// [idx[i]])).
//
// Replaces the TPU kernel src/repro/kernels/quant_pack.py:_dequant_kernel
// (wrapper dequant_unpack); the fused gather is the counterpart of the
// reference re-rank's packed[cand], scale[cand], zero[cand] read inside one
// jit (src/repro/serving/scorer.py:_rerank), which XLA fuses.
//
// Bound on the H100: bytes. The packed rows (m*dp) and 8 bytes of
// scale/zero per row are read once and m*d*4 bytes written once, against
// two flops an element; the fp32 output is most of the traffic.
//
// Design. A group of L lanes (L a power of two, at most a warp) owns one
// output row at a time: it reads the row's index (if any), then scale and
// zero once, and walks the packed row. In the chunk-interleaved layout of
// core/quant.py byte j holds codes j, j+dp, j+2dp, ... at shifts 0, b, 2b,
// ...; so with dp and d multiples of 4 and an aligned base (VEC), one
// 4-byte load of bytes [j, j+4) gives four consecutive codes of every
// chunk, stored as one float4 a chunk: features k*dp + j .. k*dp + j + 3.
// The item table at INT8 (dp 256) gives 64 words a row: a warp a row, two
// float4 stores a lane; INT2 at d 64 (dp 16) 4 words: 8 rows a warp. Otherwise (dp 10 at d 37 INT2, an
// unaligned base) each lane takes single bytes and stores one float a chunk.
// Chunks stop at d: the codes of a padded pack's tail are never stored. No
// division or modulo by a runtime width. x = code * scale + zero rounds the
// product and the sum apart (__fmul_rn, __fadd_rn: no FMA contraction), as
// the plain core/quant.dequantize does, so the two agree bit for bit.
// Indices follow torch indexing, as the plain version's packed[idx] does:
// -rows <= idx < 0 counts from the end, and an index outside [-rows, rows)
// stops the kernel with a device-side assert, raised by the next
// synchronising call (torch's own indexing fails so on the card).
#include <cuda_runtime.h>

#include <cassert>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 resident CTAs on each of 132 SMs

__device__ __forceinline__ float dq(unsigned code, float s, float z) {
  return __fadd_rn(__fmul_rn(static_cast<float>(code), s), z);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_rows_kernel(const uint8_t* __restrict__ packed, int dp, int bits,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero, int rows, int dim,
                    const int32_t* __restrict__ idx32,
                    const int64_t* __restrict__ idx64, int m, int lpr_log2,
                    float* __restrict__ out) {
  const int lpr = 1 << lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);
  const int per_block = kThreads >> lpr_log2;
  const int cpb = 8 / bits;
  const unsigned mask = (1u << bits) - 1u;
  for (int i = blockIdx.x * per_block + (threadIdx.x >> lpr_log2); i < m;
       i += gridDim.x * per_block) {
    long long r = idx32 ? static_cast<long long>(idx32[i])
                  : idx64 ? static_cast<long long>(idx64[i])
                          : static_cast<long long>(i);
    if (r < 0) r += rows;
    assert(r >= 0 && r < rows);
    float* o = out + static_cast<size_t>(i) * dim;
    const float s = scale[r];
    const float z = zero[r];
    const uint8_t* p = packed + static_cast<size_t>(r) * dp;
    if (VEC) {
      const uint32_t* pw = reinterpret_cast<const uint32_t*>(p);
      for (int w = sub; w < dp / 4; w += lpr) {
        const uint32_t v = pw[w];
        for (int k = 0, f = 4 * w; k < cpb && f < dim; ++k, f += dp) {
          const int sh = k * bits;
          float4 x;
          x.x = dq((v >> sh) & mask, s, z);
          x.y = dq((v >> (8 + sh)) & mask, s, z);
          x.z = dq((v >> (16 + sh)) & mask, s, z);
          x.w = dq((v >> (24 + sh)) & mask, s, z);
          *reinterpret_cast<float4*>(o + f) = x;
        }
      }
    } else {
      for (int j = sub; j < dp; j += lpr) {
        const unsigned v = p[j];
        for (int k = 0, f = j; k < cpb && f < dim; ++k, f += dp)
          o[f] = dq((v >> (k * bits)) & mask, s, z);
      }
    }
  }
}

}  // namespace

// packed (rows, dp) uint8 with bits in {1,2,4,8} and dp*(8/bits) >= dim;
// scale/zero (rows,) fp32; idx (m,) int32 (idx_is64 0) or int64 (1), or
// null for every row in order (m = rows) -> out (m, dim) fp32. Returns
// cudaGetLastError() after the launch.
extern "C" int dequant_unpack_launch(const void* packed, int rows, int dp,
                                     int bits, int dim, const void* scale,
                                     const void* zero, const void* idx,
                                     int idx_is64, int m, void* out,
                                     void* stream) {
  if (m <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = dp % 4 == 0 && dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int units = vec ? dp / 4 : dp;
  int lpr_log2 = 0;
  while ((1 << lpr_log2) < units && lpr_log2 < 5) ++lpr_log2;
  const int per_block = kThreads >> lpr_log2;
  const int want = (m + per_block - 1) / per_block;
  const int blocks = want < kMaxBlocks ? want : kMaxBlocks;
  const int32_t* i32 =
      idx && !idx_is64 ? static_cast<const int32_t*>(idx) : nullptr;
  const int64_t* i64 =
      idx && idx_is64 ? static_cast<const int64_t*>(idx) : nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zero);
  float* o = static_cast<float*>(out);
  if (vec)
    dequant_rows_kernel<true><<<blocks, kThreads, 0, st>>>(
        p, dp, bits, s, z, rows, dim, i32, i64, m, lpr_log2, o);
  else
    dequant_rows_kernel<false><<<blocks, kThreads, 0, st>>>(
        p, dp, bits, s, z, rows, dim, i32, i64, m, lpr_log2, o);
  return static_cast<int>(cudaGetLastError());
}
