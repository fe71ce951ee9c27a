// Fused dequantize * score * top-K retrieval over a packed item table.
//
// Replaces the TPU kernel src/repro/kernels/topk_score.py:_topk_kernel.
//
// Bound on the H100: the packed table (I*ceil(d*b/8) bytes), 8 bytes of
// scale/zero per item, the queries and the exclusion lists are read once,
// (B, k) values and indices are written once; against 2*B*I*d fp32 flops.
// Which of the two bounds depends on B: the script that measures it states
// it per shape.
//
// Design. The TPU kernel walks item chunks in order and carries a running
// top-k in its output block. Blocks on Hopper run in parallel, so the work
// is split into a per-chunk top-k (pass 1) and merge rounds over the chunk
// lists (pass 2), both in topk_select.cuh and shared with the coarse top-m
// kernel, so any k <= n_items works. This file holds the per-item step:
// each code is dequantized to x = code*scale + zero with the same two
// roundings as the plain version before it is staged, and the score is the
// fp32 dot itself. With a dense fp32 table (bits == 0) x is read directly.
// Both passes order by (value desc, index asc), which is lax.top_k's tie
// rule over the whole masked score row, so the merge loses nothing.
#include <cuda_runtime.h>

#include <cstdint>

#include "topk_select.cuh"

namespace {

struct DequantThenDot {
  static __device__ __forceinline__ float stage(
      const topk_select::ChunkArgs& a, int item, int col, unsigned code) {
    if (a.bits == 0) return a.items[static_cast<size_t>(item) * a.dim + col];
    return __fadd_rn(__fmul_rn(static_cast<float>(code), a.scale[item]),
                     a.zero[item]);
  }
  static __device__ __forceinline__ float score(
      const topk_select::ChunkArgs&, int, int, float dot) {
    return dot;
  }
};

}  // namespace

// q (B, dim) fp32; packed (n_items, dp) uint8 with bits in {1,2,4,8}, or
// items (n_items, dim) fp32 with bits == 0; scale/zero (n_items,) fp32 (unused
// when bits == 0); excl (B, P) int32, -1 pads; cand_v/cand_i and
// cand2_v/cand2_i scratch of B*ceil(n_items/128)*min(k, 128) each -> out_v
// (B, k) fp32, out_i (B, k) int32. Requires 1 <= k <= n_items. Returns
// cudaGetLastError() after the last launch.
extern "C" int topk_launch(const void* q, int B, int dim, const void* packed,
                           int dp, int bits, const void* items,
                           const void* scale, const void* zero,
                           const void* excl, int P, int n_items, int k,
                           void* cand_v, void* cand_i, void* cand2_v,
                           void* cand2_i, void* out_v, void* out_i,
                           void* stream) {
  const topk_select::ChunkArgs a{
      static_cast<const float*>(q), nullptr, B, dim,
      static_cast<const uint8_t*>(packed), dp, bits,
      static_cast<const float*>(items), static_cast<const float*>(scale),
      static_cast<const float*>(zero), static_cast<const int*>(excl), P,
      n_items};
  return static_cast<int>(topk_select::select_topm<DequantThenDot>(
      a, k, static_cast<float*>(cand_v), static_cast<int*>(cand_i),
      static_cast<float*>(cand2_v), static_cast<int*>(cand2_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<cudaStream_t>(stream)));
}
