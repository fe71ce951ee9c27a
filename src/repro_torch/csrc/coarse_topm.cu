// Coarse top-m scan of two-stage retrieval, in the packed code domain.
//
// Replaces the TPU kernel src/repro/kernels/topk_score.py:_coarse_kernel.
//
// Score of item i for query b: dot * (qs_b * scale_i) + sq_b * zero_i, where
// dot = q8_b . codes_i is the integer-valued product of the symmetric INT8
// query codes (integer-valued fp32 in [-127, 127]) and the item's unsigned
// b-bit codes, and qmeta_b = [qs_b, sq_b] (scorer.quantize_query). Item rows
// are never dequantized and no fp32 item row is written to memory.
//
// Bound on the H100: the packed table (I*ceil(d*b/8) bytes), 8 bytes of
// scale/zero per item, q8 (B*d*4), qmeta (B*8) and the exclusion lists read
// once, (B, m) values and indices written once; against 2*B*I*d operations
// for the dot. Its operands are int8 query codes and unsigned codes, so the
// dot is exact at the card's int8 tensor-core rate, and the bytes bound it
// at every batch the path gives it. This kernel forms it with fp32 FMAs on
// the CUDA cores instead, far slower than that bound.
//
// Design. Pass 1 (a per-chunk top-m) and pass 2 (merge rounds over the
// chunk lists) are topk_select.cuh's, shared with the top-K kernel; this
// file holds the per-item step. The codes are staged as floats, never
// dequantized, so no fp32 item row is formed or written to memory. Every
// product and partial sum of the dot is an integer below 127*255*d < 2^24
// for d <= 512, so the dot is exact in any summation order. The affine step
// then rounds the three products and the sum apart (__fmul_rn/__fadd_rn, no
// contraction), in the plain version's order, so kernel and plain version
// agree bit for bit on any input. Both passes order by (value desc, index
// asc), for any 1 <= m <= n_items.
#include <cuda_runtime.h>

#include <cstdint>

#include "topk_select.cuh"

namespace {

struct IntegerDotThenAffine {
  static __device__ __forceinline__ float stage(
      const topk_select::ChunkArgs&, int, int, unsigned code) {
    return static_cast<float>(code);
  }
  static __device__ __forceinline__ float score(
      const topk_select::ChunkArgs& a, int b, int item, float dot) {
    const float qs = a.qmeta[static_cast<size_t>(b) * 2];
    const float sum_q = a.qmeta[static_cast<size_t>(b) * 2 + 1];
    return __fadd_rn(__fmul_rn(dot, __fmul_rn(qs, a.scale[item])),
                     __fmul_rn(sum_q, a.zero[item]));
  }
};

}  // namespace

// q8 (B, dim) fp32 integer-valued codes; qmeta (B, 2) fp32 [qs, sum q];
// packed (n_items, dp) uint8 with bits in {1,2,4,8}; scale/zero (n_items,)
// fp32; excl (B, P) int32, -1 pads; cand_v/cand_i and cand2_v/cand2_i scratch
// of B*ceil(n_items/128)*min(m, 128) each -> out_v (B, m) fp32, out_i (B, m)
// int32. Requires 1 <= m <= n_items. Returns cudaGetLastError() after the
// last launch.
extern "C" int coarse_topm_launch(const void* q8, const void* qmeta, int B,
                                  int dim, const void* packed, int dp,
                                  int bits, const void* scale,
                                  const void* zero, const void* excl, int P,
                                  int n_items, int m, void* cand_v,
                                  void* cand_i, void* cand2_v, void* cand2_i,
                                  void* out_v, void* out_i, void* stream) {
  const topk_select::ChunkArgs a{
      static_cast<const float*>(q8), static_cast<const float*>(qmeta), B,
      dim, static_cast<const uint8_t*>(packed), dp, bits, nullptr,
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<const int*>(excl), P, n_items};
  return static_cast<int>(topk_select::select_topm<IntegerDotThenAffine>(
      a, m, static_cast<float*>(cand_v), static_cast<int*>(cand_i),
      static_cast<float*>(cand2_v), static_cast<int*>(cand2_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<cudaStream_t>(stream)));
}
