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
// gather one residual row per edge (E*d*4 bytes at fp32, E/n_src times the
// table), so they near that bound only as far as the L2 keeps the rows
// between their reuses; the fp32 kernel reads g once per destination row,
// the packed one once per slot (mostly a broadcast).
//
// fp32 (sddmm_rows_kernel). The TPU kernel accumulates a block's partial dot
// products across feature tiles on a sequential grid and scatters them to
// edge order through perm_blk afterwards. Here the work is spread by
// destination row, as the SPMM's (spmm.cu): a group of L lanes owns one row
// r of the forward direction, whose slots are one contiguous run,
// row_start[r] .. row_end[r] (data/csr.py), all sharing g[r]. The group
// loads g[r] into registers once (VEC columns a lane: float4 where the rows
// allow; NC chunks of L * VEC columns), loads its run's source ids and perm
// in coalesced batches of P slots and hands them out by __shfl_sync, so no
// lane waits on a chain of dependent index loads, and keeps U x[src] row
// gathers in flight a lane; at most 40 registers a thread, so an SM holds
// 6 CTAs (48 warps) of loads in flight. d 64 gives 16 lanes x float4, one
// chunk, two rows a warp. Each slot's dot is a partial a lane (fp32 fmas
// over its columns in order: chunk, then x, y, z, w) summed over the group
// by an xor tree of log2(L) shuffles; every lane then holds the same sum,
// and one lane writes it. A row wider than 4 chunks (512 columns at
// float4, 128 scalar) is walked in column passes of 4 chunks (PASSES), each
// pass adding its partial to the edge's value written by the pass before
// (the same lane, in pass order). The kernel has no cross-slot sum, so the
// slot order is free; a run is walked by its group alone (the full-width
// graph's longest run is 198 slots). A one-column table (d 1, the edge
// softmax's ones) has no dot to split: sddmm_d1_kernel gives each thread
// one slot of the flat slot array (32 slots a warp), dew = x[src] * g[dst]
// rounded once.
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
// All write straight to dew[perm[slot]]: real slots map to edges one to
// one, pad slots (perm == n_edges) are skipped, and runs hold none. No
// atomics: two runs give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;  // CTAs an SM holds: at most 40 registers
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float dot(float acc, T a, T b) {
    return __fmaf_rn(a, b, acc);
  }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float dot(float acc, T a, T b) {
    acc = __fmaf_rn(a.x, b.x, acc);
    acc = __fmaf_rn(a.y, b.y, acc);
    acc = __fmaf_rn(a.z, b.z, acc);
    return __fmaf_rn(a.w, b.w, acc);
  }
};

template <int L, int VEC, int NC, bool PASSES>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sddmm_rows_kernel(const float* __restrict__ x, int d,
                      const float* __restrict__ g,
                      const int* __restrict__ src,
                      const int* __restrict__ perm,
                      const int* __restrict__ row_start,
                      const int* __restrict__ row_end, int n_out,
                      float* __restrict__ out) {
  using V = Vec<VEC>;
  constexpr int U = NC >= 4 ? 1 : 4 / NC;   // gathers a lane keeps in flight
  constexpr int P = L > U ? L : U;           // slots a group loads per batch
  constexpr int kPer = P / L;                // of which each lane holds kPer
  constexpr int kSpan = L * VEC;             // columns of one chunk
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const int leader = lane - sub;             // the group's first lane
  const unsigned mask =
      L == 32 ? kFull : ((1u << (L % 32)) - 1u) << leader;
  const int row =
      (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * (32 / L) +
      lane / L;
  if (row >= n_out) return;                  // the whole group leaves
  const int a = __ldg(row_start + row);
  const int b = __ldg(row_end + row);
  // column passes: one unless the row is wider than NC chunks (PASSES)
  for (int c0 = 0; c0 < (PASSES ? d : 1); c0 += NC * kSpan) {
    typename V::T gv[NC];                    // g[row], this lane's columns
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = c0 + k * kSpan + sub * VEC;
      gv[k] = c < d ? V::load(g + static_cast<size_t>(row) * d + c)
                    : V::zero();
    }
    for (int base = a; base < b; base += P) {   // the group's batch of P
      int si[kPer], ei[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {          // slot base + sub + i * L
        const int s = base + sub + i * L;
        si[i] = 0;
        ei[i] = 0;
        if (s < b) {
          si[i] = __ldg(src + s);
          ei[i] = __ldg(perm + s);
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < P; k0 += U) {
        if (base + k0 >= b) break;              // uniform in the group
        typename V::T v[U][NC];
        int e[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int o = k0 + u;                 // held by lane o % L
          const int s = __shfl_sync(mask, si[o / L], leader + o % L);
          e[u] = __shfl_sync(mask, ei[o / L], leader + o % L);
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const int c = c0 + k * kSpan + sub * VEC;
            v[u][k] = V::zero();
            if (base + o < b && c < d)
              v[u][k] = V::load(x + static_cast<size_t>(s) * d + c);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float p = 0.0f;
#pragma unroll
          for (int k = 0; k < NC; ++k) p = V::dot(p, v[u][k], gv[k]);
#pragma unroll
          for (int off = L / 2; off > 0; off >>= 1)
            p = __fadd_rn(p, __shfl_xor_sync(mask, p, off));
          if (base + k0 + u < b && sub == u % L) {
            if constexpr (PASSES)
              out[e[u]] = c0 == 0 ? p : __fadd_rn(out[e[u]], p);
            else
              out[e[u]] = p;
          }
        }
      }
    }
  }
}

// d == 1: one slot a thread over the flat slot array; pad slots skipped.
__global__ void __launch_bounds__(kThreads)
    sddmm_d1_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    int n_slots, const int* __restrict__ src,
                    const int* __restrict__ dst,
                    const int* __restrict__ perm, int n_edges,
                    float* __restrict__ out) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_slots) return;
  const int e = __ldg(perm + s);
  if (e >= n_edges) return;                       // pad slot
  out[e] = __fmul_rn(__ldg(x + __ldg(src + s)), __ldg(g + __ldg(dst + s)));
}

template <int VEC, int NC, bool PASSES>
void launch_rows(int lanes, const float* x, int d, const float* g,
                 const int* src, const int* perm, const int* row_start,
                 const int* row_end, int n_out, float* out,
                 cudaStream_t stream) {
  const long long rows_per_cta = (kThreads / 32) * (32 / lanes);
  const int grid = static_cast<int>((n_out + rows_per_cta - 1) / rows_per_cta);
#define SDDMM_CASE(L)                                                        \
  case L:                                                                    \
    sddmm_rows_kernel<L, VEC, NC, PASSES><<<grid, kThreads, 0, stream>>>(    \
        x, d, g, src, perm, row_start, row_end, n_out, out);                 \
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
}

template <int VEC>
void launch_fp32(int cols, const float* x, int d, const float* g,
                 const int* src, const int* perm, const int* row_start,
                 const int* row_end, int n_out, float* out,
                 cudaStream_t stream) {
  int lanes = 1;
  while (lanes < 32 && lanes < cols) lanes *= 2;
  const int chunks = (cols + lanes - 1) / lanes;   // lanes < 32: one
  if (chunks <= 1)
    launch_rows<VEC, 1, false>(lanes, x, d, g, src, perm, row_start, row_end,
                               n_out, out, stream);
  else if (chunks <= 2)
    launch_rows<VEC, 2, false>(lanes, x, d, g, src, perm, row_start, row_end,
                               n_out, out, stream);
  else if (chunks <= 4)
    launch_rows<VEC, 4, false>(lanes, x, d, g, src, perm, row_start, row_end,
                               n_out, out, stream);
  else
    launch_rows<VEC, 4, true>(lanes, x, d, g, src, perm, row_start, row_end,
                              n_out, out, stream);
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
// the layout's forward direction, row_start/row_end (n_dst,) int32 its slot
// run of each destination -> out (n_edges,) fp32, every edge written once.
// Returns cudaGetLastError() after the launch.
extern "C" int sddmm_launch(const void* x, int d, const void* g, int n_slots,
                            const void* src, const void* dst,
                            const void* perm, const void* row_start,
                            const void* row_end, int n_dst, int n_edges,
                            void* out, void* stream) {
  if (n_slots <= 0 || d <= 0 || n_dst <= 0)
    return static_cast<int>(cudaGetLastError());
  const auto* xf = static_cast<const float*>(x);
  const auto* gf = static_cast<const float*>(g);
  const auto* si = static_cast<const int*>(src);
  const auto* pi = static_cast<const int*>(perm);
  const auto* rs = static_cast<const int*>(row_start);
  const auto* re = static_cast<const int*>(row_end);
  auto* of = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (d == 1) {
    sddmm_d1_kernel<<<(n_slots + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        xf, gf, n_slots, si, static_cast<const int*>(dst), pi, n_edges, of);
  } else if (d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(g) % 16 == 0) {
    // float4 columns when every row of x and g starts on 16 bytes
    launch_fp32<4>(d / 4, xf, d, gf, si, pi, rs, re, n_dst, of, st);
  } else {
    launch_fp32<1>(d, xf, d, gf, si, pi, rs, re, n_dst, of, st);
  }
  return static_cast<int>(cudaGetLastError());
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
