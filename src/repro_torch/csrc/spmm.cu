// Weighted SPMM over the blocked-CSR layout: out[v] = sum_{e -> v} ew[e] * x[src_e].
//
// Replaces the TPU kernels src/repro/kernels/spmm.py:_spmm_kernel (table in
// VMEM) and :_spmm_dma_kernel (table in HBM, double-buffered row DMA). On
// Hopper every table is gathered from device memory, so one kernel covers
// both.
//
// Bound on the H100: bytes. The function must read the (n_src, d) fp32
// table once, a source index and a weight per edge and the row pointers,
// and write the (n_out, d) output once; 2*E*d flops are far below the fp32
// peak. This kernel gathers one d-wide row per edge (E*d*4 bytes, E/n_src
// times the table) and reads 12 bytes of layout per slot, so it nears that
// bound only as far as the L2 keeps the table's rows between their reuses.
//
// Design. The work is spread by output row, not by tile: a tile of 256
// destinations can hold 13x the edges of another, and a CTA per tile made
// the kernel last as long as its heaviest tile. Here a group of L lanes owns
// one output row, 32 / L rows a warp, and the block scheduler evens out
// rows of any degree. The layout gives each row's slots as one contiguous
// run, row_start[r] .. row_end[r] (data/csr.py), so no pass finds them. A
// lane covers VEC columns (float4 loads when the table allows), so L is the
// power of two that covers d (at most 32; a wider row walks its columns in
// chunks of 32 * VEC): d 64 gives 16 lanes x float4, two rows a warp. The
// group loads a batch of its row's source indices and weights ew[perm]
// together (one coalesced load each) and hands them out by __shfl_sync, so
// the row gathers do not wait on a chain of dependent index loads; each
// lane keeps U gathers in flight before it adds them. A one-column table
// (d 1, the edge softmax's denominators) would leave that one lane walking
// a whole row alone, so spmv_kernel gives each row S lanes instead: each
// lane forms the products of its own slots, and the group adds them in slot
// order by shuffles.
//
// Every output element is one sequential fp32 sum in slot order, each term
// rounded as a product and then added (__fmul_rn, __fadd_rn), whatever the
// lanes, batches and vector width: the bits of a plain loop over the row's
// slots. No atomics, so two runs give the same bits. Runs hold no pad slot;
// an empty row is written as 0. ew == nullptr means weight 1. The transpose
// direction of the layout (t_* arrays) runs through the kernel unchanged.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;  // CTAs an SM holds: at most 42 registers
constexpr int kSpmvLanes = 32;  // lanes per row at d 1
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
  static __device__ __forceinline__ T add_mul(T a, float w, T v) {
    return __fadd_rn(a, __fmul_rn(w, v));
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
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ T add_mul(T a, float w, T v) {
    return make_float4(__fadd_rn(a.x, __fmul_rn(w, v.x)),
                       __fadd_rn(a.y, __fmul_rn(w, v.y)),
                       __fadd_rn(a.z, __fmul_rn(w, v.z)),
                       __fadd_rn(a.w, __fmul_rn(w, v.w)));
  }
};

template <int L, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    spmm_kernel(const float* __restrict__ x, int d,
                const float* __restrict__ ew, const int* __restrict__ gat,
                const int* __restrict__ perm,
                const int* __restrict__ row_start,
                const int* __restrict__ row_end, int n_out,
                float* __restrict__ out) {
  using V = Vec<VEC>;
  constexpr int U = 4;                 // gathers a lane keeps in flight
  constexpr int P = L > U ? L : U;     // slots a group loads per batch
  constexpr int kPer = P / L;          // of which each lane holds kPer
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const int leader = lane - sub;       // the group's first lane
  const unsigned mask =
      L == 32 ? kFull : ((1u << (L % 32)) - 1u) << leader;
  const int row =
      (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * (32 / L) +
      lane / L;
  if (row >= n_out) return;            // the whole group leaves
  const int a = __ldg(row_start + row);
  const int b = __ldg(row_end + row);
  for (int c0 = 0; c0 < d; c0 += L * VEC) {
    const int c = c0 + sub * VEC;
    const bool col = c < d;
    typename V::T acc = V::zero();
    for (int base = a; base < b; base += P) {   // the group's batch of P
      int gi[kPer];
      float wi[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {          // slot base + sub + i * L
        const int s = base + sub + i * L;
        gi[i] = 0;
        wi[i] = 0.0f;
        if (s < b) {
          gi[i] = __ldg(gat + s);
          wi[i] = ew != nullptr ? __ldg(ew + __ldg(perm + s)) : 1.0f;
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < P; k0 += U) {
        if (base + k0 >= b) break;              // uniform in the group
        typename V::T v[U];
        float w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int o = k0 + u;                 // held by lane o % L
          const int s = __shfl_sync(mask, gi[o / L], leader + o % L);
          w[u] = __shfl_sync(mask, wi[o / L], leader + o % L);
          v[u] = V::zero();
          if (base + o < b && col)
            v[u] = V::load(x + static_cast<size_t>(s) * d + c);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (base + k0 + u < b) acc = V::add_mul(acc, w[u], v[u]);
      }
    }
    if (col) V::store(out + static_cast<size_t>(row) * d + c, acc);
  }
}

// d == 1: S lanes per row. Lane t holds slots base + t + i * S (i < U) of a
// batch of S * U; every lane of the group adds the batch's products in slot
// order, so all hold the same sum and the first lane writes it.
template <int S>
__global__ void __launch_bounds__(kThreads)
    spmv_kernel(const float* __restrict__ x, const float* __restrict__ ew,
                const int* __restrict__ gat, const int* __restrict__ perm,
                const int* __restrict__ row_start,
                const int* __restrict__ row_end, int n_out,
                float* __restrict__ out) {
  constexpr int U = 4;                 // slots a lane loads per batch
  constexpr int P = S * U;
  const int lane = threadIdx.x & 31;
  const int t = lane % S;
  const int leader = lane - t;
  const unsigned mask =
      S == 32 ? kFull : ((1u << (S % 32)) - 1u) << leader;
  const int row = (blockIdx.x * kThreads + threadIdx.x) / S;
  if (row >= n_out) return;            // the whole group leaves
  const int a = __ldg(row_start + row);
  const int b = __ldg(row_end + row);
  float acc = 0.0f;
  for (int base = a; base < b; base += P) {
    float p[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int s = base + t + i * S;
      p[i] = 0.0f;
      if (s < b) {
        const float w = ew != nullptr ? __ldg(ew + __ldg(perm + s)) : 1.0f;
        p[i] = __fmul_rn(w, __ldg(x + __ldg(gat + s)));
      }
    }
#pragma unroll
    for (int o = 0; o < P; ++o) {
      if (base + o >= b) break;        // uniform in the group
      acc = __fadd_rn(acc, __shfl_sync(mask, p[o / S], leader + o % S));
    }
  }
  if (t == 0) out[row] = acc;
}

template <int VEC>
void launch(int lanes, const float* x, int d, const float* ew, const int* gat,
            const int* perm, const int* row_start, const int* row_end,
            int n_out, float* out, cudaStream_t stream) {
  const long long rows_per_cta = (kThreads / 32) * (32 / lanes);
  const int grid = static_cast<int>((n_out + rows_per_cta - 1) / rows_per_cta);
#define SPMM_CASE(L)                                                       \
  case L:                                                                  \
    spmm_kernel<L, VEC><<<grid, kThreads, 0, stream>>>(                    \
        x, d, ew, gat, perm, row_start, row_end, n_out, out);              \
    break;
  switch (lanes) {
    SPMM_CASE(1)
    SPMM_CASE(2)
    SPMM_CASE(4)
    SPMM_CASE(8)
    SPMM_CASE(16)
    SPMM_CASE(32)
  }
#undef SPMM_CASE
}

}  // namespace

// x (n_src, d) fp32; ew (n_edges,) fp32 or null; gat/perm (n_slots,) int32;
// row_start/row_end (n_out,) int32, the slot run of each output row -> out
// (n_out, d) fp32, every row written. Returns cudaGetLastError() after the
// launch.
extern "C" int spmm_launch(const void* x, int d, const void* ew,
                           const void* gat, const void* perm,
                           const void* row_start, const void* row_end,
                           int n_out, void* out, void* stream) {
  if (n_out > 0 && d > 0) {
    // float4 columns when every row of x and out starts on 16 bytes
    const bool vec4 =
        d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int vec = vec4 ? 4 : 1;
    const int cols = (d + vec - 1) / vec;
    int lanes = 1;
    while (lanes < 32 && lanes < cols) lanes *= 2;
    const auto* xf = static_cast<const float*>(x);
    const auto* wf = static_cast<const float*>(ew);
    const auto* gi = static_cast<const int*>(gat);
    const auto* pi = static_cast<const int*>(perm);
    const auto* rs = static_cast<const int*>(row_start);
    const auto* re = static_cast<const int*>(row_end);
    auto* of = static_cast<float*>(out);
    auto* st = static_cast<cudaStream_t>(stream);
    if (d == 1)
      spmv_kernel<kSpmvLanes>
          <<<(n_out + kThreads / kSpmvLanes - 1) / (kThreads / kSpmvLanes),
             kThreads, 0, st>>>(xf, wf, gi, pi, rs, re, n_out, of);
    else if (vec4)
      launch<4>(lanes, xf, d, wf, gi, pi, rs, re, n_out, of, st);
    else
      launch<1>(lanes, xf, d, wf, gi, pi, rs, re, n_out, of, st);
  }
  return static_cast<int>(cudaGetLastError());
}
