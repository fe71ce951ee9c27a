// SDDMM over the blocked-CSR layout: dew[e] = <x_hat[src_e], g[dst_e]>, the
// gradient of the SPMM's edge weights, from an fp32 residual x or from the
// packed b-bit residual (x_hat unpacked in the kernel).
//
// Replaces the TPU kernels src/repro/kernels/spmm.py:_sddmm_kernel (fp32),
// :_dq_sddmm_kernel (packed, tables in VMEM) and :_dq_sddmm_dma_kernel
// (packed, rows streamed from HBM by double-buffered DMA). On Hopper every
// table is gathered from device memory, so one kernel covers the fp32 form
// and one the two packed forms.
//
// Bound on the H100: bytes. The function must read the residual table once
// (fp32: 4*d bytes a row; packed: ceil(d*b/8) bytes plus 8 bytes of
// scale/zero), g once, a source and a destination index per edge, and write
// one float per edge; 2*E*d flops are far below the fp32 peak. Both kernels
// gather one residual row and one g row per edge, so they near that bound
// only as far as the L2 keeps the rows between their reuses.
//
// fp32 (sddmm_kernel). The TPU kernel accumulates a block's partial dot
// products across feature tiles on a sequential grid and scatters them to
// edge order through perm_blk afterwards. Here a group of L lanes owns one
// slot of the forward direction (src_blk, dstg_blk, perm_blk): its lanes
// split the features (lane k takes features k, k+L, ...), each sums its
// share in feature order, and a shuffle tree sums the group. L is the
// smallest power of two >= d/4 (at most 32), so a warp serves 32/L slots at
// once and a one-column table (the edge softmax's ones) wastes no lanes.
//
// Packed (dq_sddmm_kernel<BITS, DP>). A packed row is tiny (16 bytes at
// INT2, d 64), so one thread owns one slot and computes the whole dot: no
// shuffle tree. Feature j sits in byte j % dp at shift (j / dp) * bits (the
// chunk-interleaved pack of DESIGN.md section 2). The kernel walks it as two
// nested loops, chunk c (shift c * BITS, a compile-time constant) and then
// byte b (feature c * dp + b), stopping at dim: features in ascending
// order, no division. With DP > 0 the row width is a compile-time constant
// (d 64 at bits 8/4/2/1 gives dp 64/32/16/8), the row arrives in one to four
// 16-byte loads (one 8-byte load at dp 8) and g[dst] as float4; consecutive
// slots share a destination, so a warp's g loads are mostly broadcasts.
// DP == 0 takes any dp and alignment byte by byte (d 37). x_hat is code *
// scale + zero rounded twice (__fmul_rn, __fadd_rn), as the port's
// dequantize; nvcc may not contract it into one fma.
//
// Both write straight to dew[perm[slot]]: real slots map to edges one to
// one, pad slots (perm == n_edges) are skipped. No atomics: two runs give
// the same bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <int L>
__global__ void sddmm_kernel(const float* __restrict__ x, int d,
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
  // base is the same for every lane of a warp, so the shuffles converge
  for (long long base = static_cast<long long>(warp) * kGroups;
       base < n_slots; base += static_cast<long long>(n_warps) * kGroups) {
    const long long s = base + grp;
    int e = n_edges;
    float acc = 0.0f;
    if (s < n_slots) e = perm[s];
    if (e < n_edges) {
      const float* gr = g + static_cast<size_t>(dst[s]) * d;
      const float* xr = x + static_cast<size_t>(src[s]) * d;
      for (int j = sub; j < d; j += L) acc = __fmaf_rn(xr[j], gr[j], acc);
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sub == 0 && e < n_edges) out[e] = acc;
  }
}

int launch_fp32(const float* x, int d, const float* g, int n_slots,
                const int* src, const int* dst, const int* perm, int n_edges,
                float* out, cudaStream_t stream) {
  if (n_slots <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  int lanes = 1;
  while (lanes < 32 && lanes * 4 < d) lanes *= 2;
  const long long warps = (n_slots + (32 / lanes) - 1) / (32 / lanes);
  const long long want = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
#define SDDMM_CASE(L)                                                        \
  case L:                                                                    \
    sddmm_kernel<L><<<grid, kThreads, 0, stream>>>(                          \
        x, d, g, n_slots, src, dst, perm, n_edges, out);                     \
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

__device__ __forceinline__ float xhat(unsigned code, float sc, float z) {
  return __fadd_rn(__fmul_rn(static_cast<float>(code), sc), z);
}

// DP > 0: every row is DP bytes (DP a multiple of 8), 16-byte aligned (8 at
// DP 8), and dim == DP * 8 / BITS, so g rows are float4-aligned too.
// DP == 0: any dp >= ceil(dim * BITS / 8), any alignment.
template <int BITS, int DP>
__global__ void __launch_bounds__(kThreads)
    dq_sddmm_kernel(const uint8_t* __restrict__ packed, int dp,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero, int dim,
                    const float* __restrict__ g, int n_slots,
                    const int* __restrict__ src, const int* __restrict__ dst,
                    const int* __restrict__ perm, int n_edges,
                    float* __restrict__ out) {
  constexpr int kChunks = 8 / BITS;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_slots) return;
  const int e = __ldg(perm + s);
  if (e >= n_edges) return;                       // pad slot
  const int u = __ldg(src + s);
  const float sc = __ldg(scale + u);
  const float z = __ldg(zero + u);
  const float* gr = g + static_cast<size_t>(__ldg(dst + s)) * dim;
  float acc = 0.0f;
  if constexpr (DP > 0) {
    constexpr int kWords = DP / 4;
    uint32_t w[kWords];
    const uint8_t* pr = packed + static_cast<size_t>(u) * DP;
    if constexpr (DP % 16 == 0) {
#pragma unroll
      for (int i = 0; i < DP / 16; ++i) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(pr) + i);
        w[4 * i] = q.x;
        w[4 * i + 1] = q.y;
        w[4 * i + 2] = q.z;
        w[4 * i + 3] = q.w;
      }
    } else {
      static_assert(DP == 8, "DP is 8 or a multiple of 16");
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(pr));
      w[0] = q.x;
      w[1] = q.y;
    }
    const float4* g4 = reinterpret_cast<const float4*>(gr);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {       // bytes 4i .. 4i+3
        const float4 gv = __ldg(g4 + c * kWords + i);
        const uint32_t word = w[i] >> (c * BITS);
        acc = __fmaf_rn(xhat(word & kMask, sc, z), gv.x, acc);
        acc = __fmaf_rn(xhat((word >> 8) & kMask, sc, z), gv.y, acc);
        acc = __fmaf_rn(xhat((word >> 16) & kMask, sc, z), gv.z, acc);
        acc = __fmaf_rn(xhat((word >> 24) & kMask, sc, z), gv.w, acc);
      }
    }
  } else {
    const uint8_t* pr = packed + static_cast<size_t>(u) * dp;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j0 = c * dp;
      const int nb = min(dp, dim - j0);          // <= 0 past dim
      for (int b = 0; b < nb; ++b) {
        const unsigned code = (__ldg(pr + b) >> (c * BITS)) & kMask;
        acc = __fmaf_rn(xhat(code, sc, z), __ldg(gr + j0 + b), acc);
      }
    }
  }
  out[e] = acc;
}

template <int BITS>
void launch_packed(const uint8_t* packed, int dp, const float* scale,
                   const float* zero, int dim, const float* g, int n_slots,
                   const int* src, const int* dst, const int* perm,
                   int n_edges, float* out, cudaStream_t stream) {
  const int grid = (n_slots + kThreads - 1) / kThreads;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(packed);
  const bool vec = dim == dp * (8 / BITS) &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   pa % (dp % 16 == 0 ? 16 : 8) == 0;
#define DQ_CASE(DP)                                                          \
  dq_sddmm_kernel<BITS, DP><<<grid, kThreads, 0, stream>>>(                  \
      packed, dp, scale, zero, dim, g, n_slots, src, dst, perm, n_edges, out)
  if (vec && dp == 8)
    DQ_CASE(8);
  else if (vec && dp == 16)
    DQ_CASE(16);
  else if (vec && dp == 32)
    DQ_CASE(32);
  else if (vec && dp == 64)
    DQ_CASE(64);
  else
    DQ_CASE(0);
#undef DQ_CASE
}

}  // namespace

// x (n_src, d) fp32; g (n_dst, d) fp32; src/dst/perm (n_slots,) int32 of
// the layout's forward direction -> out (n_edges,) fp32, every edge written
// once. Returns cudaGetLastError() after the launch.
extern "C" int sddmm_launch(const void* x, int d, const void* g, int n_slots,
                            const void* src, const void* dst,
                            const void* perm, int n_edges, void* out,
                            void* stream) {
  return launch_fp32(static_cast<const float*>(x), d,
                     static_cast<const float*>(g), n_slots,
                     static_cast<const int*>(src),
                     static_cast<const int*>(dst),
                     static_cast<const int*>(perm), n_edges,
                     static_cast<float*>(out),
                     static_cast<cudaStream_t>(stream));
}

// packed (n_src, dp) uint8 chunk-interleaved codes of `bits` bits (1, 2, 4
// or 8) with dp * (8 / bits) >= dim; scale/zero (n_src,) fp32; g (n_dst,
// dim) fp32; src/dst/perm as above -> out (n_edges,) fp32.
extern "C" int dequant_sddmm_launch(const void* packed, int dp, int bits,
                                    int dim, const void* scale,
                                    const void* zero, const void* g,
                                    int n_slots, const void* src,
                                    const void* dst, const void* perm,
                                    int n_edges, void* out, void* stream) {
  if (n_slots <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* sc = static_cast<const float*>(scale);
  const auto* zr = static_cast<const float*>(zero);
  const auto* gf = static_cast<const float*>(g);
  const auto* si = static_cast<const int*>(src);
  const auto* di = static_cast<const int*>(dst);
  const auto* pi = static_cast<const int*>(perm);
  auto* of = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1:
      launch_packed<1>(pk, dp, sc, zr, dim, gf, n_slots, si, di, pi, n_edges,
                       of, st);
      break;
    case 2:
      launch_packed<2>(pk, dp, sc, zr, dim, gf, n_slots, si, di, pi, n_edges,
                       of, st);
      break;
    case 4:
      launch_packed<4>(pk, dp, sc, zr, dim, gf, n_slots, si, di, pi, n_edges,
                       of, st);
      break;
    case 8:
      launch_packed<8>(pk, dp, sc, zr, dim, gf, n_slots, si, di, pi, n_edges,
                       of, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
