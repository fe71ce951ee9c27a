// SDDMM over the blocked-CSR layout: dew[e] = <x_hat[src_e], g[dst_e]>, the
// gradient of the SPMM's edge weights, from an fp32 residual x or from the
// packed b-bit residual (x_hat unpacked in the kernel).
//
// Replaces the TPU kernels src/repro/kernels/spmm.py:_sddmm_kernel (fp32),
// :_dq_sddmm_kernel (packed, tables in VMEM) and :_dq_sddmm_dma_kernel
// (packed, rows streamed from HBM by double-buffered DMA). On Hopper every
// table is gathered from device memory, so one templated kernel covers all
// three; a pipelined gather is later work.
//
// Bound on the H100: bytes. The function must read the residual table once
// (fp32: 4*d bytes a row; packed: ceil(d*b/8) bytes plus 8 bytes of
// scale/zero), g once, a source and a destination index per edge, and write
// one float per edge; 2*E*d flops are far below the fp32 peak. This kernel
// gathers one residual row and one g row per edge, so it nears that bound
// only as far as the L2 keeps the rows between their reuses.
//
// Design. The TPU kernel accumulates a block's partial dot products across
// feature tiles on a sequential grid and scatters them to edge order
// through perm_blk afterwards. Here a group of L lanes owns one slot of the
// forward direction (src_blk, dstg_blk, perm_blk): its lanes split the
// features (lane k takes features k, k+L, ...), each sums its share in
// feature order, and a shuffle tree sums the group. L is the smallest power
// of two >= d/4 (at most 32), so a warp serves 32/L slots at once and a
// one-column table (the edge softmax's ones) wastes no lanes. Real slots map
// to edges one to one and the result goes straight to dew[perm[slot]]; pad
// slots (perm == n_edges) are skipped. No atomics: two runs give the same
// bits.
//
// Packed residual: feature j sits in byte j % dp at shift (j / dp) * bits
// (the chunk-interleaved pack of DESIGN.md section 2); features j >= dim are
// pack padding and count as 0, so the loop stops at dim. x_hat is
// code * scale + zero rounded twice (__fmul_rn, __fadd_rn), as the port's
// dequantize; nvcc may not contract it into one fma.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <int L, bool kPacked>
__global__ void sddmm_kernel(const float* __restrict__ x,
                             const uint8_t* __restrict__ packed, int dp,
                             int bits, const float* __restrict__ scale,
                             const float* __restrict__ zero, int d,
                             const float* __restrict__ g, int n_slots,
                             const int* __restrict__ src,
                             const int* __restrict__ dst,
                             const int* __restrict__ perm, int n_edges,
                             float* __restrict__ out) {
  constexpr int kGroups = 32 / L;  // slots a warp serves at once
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const int grp = lane / L;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  const unsigned mask = (1u << bits) - 1u;
  // base is the same for every lane of a warp, so the shuffles converge
  for (long long base = static_cast<long long>(warp) * kGroups;
       base < n_slots; base += static_cast<long long>(n_warps) * kGroups) {
    const long long s = base + grp;
    int e = n_edges;
    float acc = 0.0f;
    if (s < n_slots) e = perm[s];
    if (e < n_edges) {
      const int u = src[s];
      const float* gr = g + static_cast<size_t>(dst[s]) * d;
      if (kPacked) {
        const uint8_t* pr = packed + static_cast<size_t>(u) * dp;
        const float sc = scale[u];
        const float z = zero[u];
        for (int j = sub; j < d; j += L) {
          const unsigned code = (pr[j % dp] >> ((j / dp) * bits)) & mask;
          const float xh =
              __fadd_rn(__fmul_rn(static_cast<float>(code), sc), z);
          acc = __fmaf_rn(xh, gr[j], acc);
        }
      } else {
        const float* xr = x + static_cast<size_t>(u) * d;
        for (int j = sub; j < d; j += L) acc = __fmaf_rn(xr[j], gr[j], acc);
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sub == 0 && e < n_edges) out[e] = acc;
  }
}

template <bool kPacked>
int launch(const float* x, const uint8_t* packed, int dp, int bits,
           const float* scale, const float* zero, int d, const float* g,
           int n_slots, const int* src, const int* dst, const int* perm,
           int n_edges, float* out, cudaStream_t stream) {
  if (n_slots <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  int lanes = 1;
  while (lanes < 32 && lanes * 4 < d) lanes *= 2;
  const long long warps = (n_slots + (32 / lanes) - 1) / (32 / lanes);
  const long long want = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
#define SDDMM_CASE(L)                                                        \
  case L:                                                                    \
    sddmm_kernel<L, kPacked><<<grid, kThreads, 0, stream>>>(                 \
        x, packed, dp, bits, scale, zero, d, g, n_slots, src, dst, perm,     \
        n_edges, out);                                                       \
    break;
  switch (lanes) {
    SDDMM_CASE(1)
    SDDMM_CASE(2)
    SDDMM_CASE(4)
    SDDMM_CASE(8)
    SDDMM_CASE(16)
    SDDMM_CASE(32)
  }
#undef SDDMM_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n_src, d) fp32; g (n_dst, d) fp32; src/dst/perm (n_slots,) int32 of
// the layout's forward direction -> out (n_edges,) fp32, every edge written
// once. Returns cudaGetLastError() after the launch.
extern "C" int sddmm_launch(const void* x, int d, const void* g, int n_slots,
                            const void* src, const void* dst,
                            const void* perm, int n_edges, void* out,
                            void* stream) {
  return launch<false>(static_cast<const float*>(x), nullptr, 0, 8, nullptr,
                       nullptr, d, static_cast<const float*>(g), n_slots,
                       static_cast<const int*>(src),
                       static_cast<const int*>(dst),
                       static_cast<const int*>(perm), n_edges,
                       static_cast<float*>(out),
                       static_cast<cudaStream_t>(stream));
}

// packed (n_src, dp) uint8 chunk-interleaved codes of `bits` bits with
// dp * (8 / bits) >= dim; scale/zero (n_src,) fp32; g (n_dst, dim) fp32;
// src/dst/perm as above -> out (n_edges,) fp32.
extern "C" int dequant_sddmm_launch(const void* packed, int dp, int bits,
                                    int dim, const void* scale,
                                    const void* zero, const void* g,
                                    int n_slots, const void* src,
                                    const void* dst, const void* perm,
                                    int n_edges, void* out, void* stream) {
  return launch<true>(nullptr, static_cast<const uint8_t*>(packed), dp, bits,
                      static_cast<const float*>(scale),
                      static_cast<const float*>(zero), dim,
                      static_cast<const float*>(g), n_slots,
                      static_cast<const int*>(src),
                      static_cast<const int*>(dst),
                      static_cast<const int*>(perm), n_edges,
                      static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream));
}
